"""One run of one cell: set-up, the measured window, the check, the result.

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Every kind-specific piece comes from the mix's decision kind
(``portbench/kinds/<kind>.py``, ``spec.Spec.kind``): the plain generator of
its ring, the program side and the plain reference. Set-up builds the
configuration's catalog (``gen.py``) and the cell's ring of batches from
the seed (the kind's ``ring``), the program's objects and one
``TorchSolver`` on the card (the kind's ``program``), and runs one
decision over every batch of the ring, which builds the kernels on a
checkout's first run and warms every shape the window will use.
``setup_s`` runs from the start of the process to the first timed
decision.

The window is a closed loop: one decision, then the next, cycling the
ring, until the decisions have taken ``--seconds`` and every batch has
been decided once. Before each decision the harness hands the batch
back as it was made (its ``reset``); that time is the harness's, and the
window's clock counts the decisions alone. With
``--trace 1``, ``profile_decisions`` more decisions follow the window
under the profiler (``devtrace.py``), and the per-layer metrics are read
(``metrics/``): the span medians from the window's decisions, the
device's from the profiled ones.

After the window the peak device memory is read, the program's state is
freed, and the kind's plain reference judges a sample of the window's
answers drawn from the seed: the first decision of every batch and
``sample`` - ``ring`` more. ``correct`` holds when the answers
break no guarantee: the one number compared, ``breaches``, beside its
limit 0, is the last line on standard error and the last key of the
result line (the count of each guarantee rides in ``run``).
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

from portbench import gen
from portbench.spec import Spec

# top-level module names the process that prints the result may not hold
BANNED = frozenset({"jax", "jaxlib", "flax", "karpenter_tpu"})


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--detail", default=None,
                    help="write each decision's record (ms, gc_ms, spans) "
                         "to this JSON file")
    return ap.parse_args(argv)


def banned_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & BANNED)


def card() -> dict:
    """The card's name, count and power limit (``nvidia-smi``; None where
    it cannot be read)."""
    import torch

    limit = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        limit = float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return {"kind": torch.cuda.get_device_name(0), "power_limit_w": limit}


def run_cell(spec: Spec, cell: dict, seed: int, seconds: float, trace: bool,
             device=None, t_start: float | None = None, side=None,
             detail: list | None = None) -> dict:
    """Set up, measure and check one run of ``cell``; returns the result
    line as a dict. ``device`` None is the card; the tests pass ``"cpu"``.
    ``side`` makes what decides, ``side(cfg, plain_catalog, traffic,
    device)``: the program (the kind's ``program``, the default) or a
    stand-in with its interface, such as the control
    (``reference/control.py``). ``detail``, where given, receives one
    record per decision: its milliseconds, the collector's, its spans."""
    t_start = time.perf_counter() if t_start is None else t_start
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    kind = spec.kind(traffic)
    side = kind.program if side is None else side
    plain_catalog = gen.catalog(cfg)
    # the collector sleeps while the inputs are made (hundreds of thousands
    # of young objects, none garbage) and runs as usual from the warm-up on
    gc.disable()
    try:
        ring = kind.ring(cfg, plain_catalog, traffic, seed)
        program = side(cfg, plain_catalog, traffic, device)
        batches = [program.batch(plain) for plain in ring]
    finally:
        gc.enable()
    cuda = program.cuda
    R = len(batches)
    warm_ms = []
    for b in batches:
        b.reset()
        t0 = time.perf_counter()
        program.decide(b)
        warm_ms.append((time.perf_counter() - t0) * 1e3)
    # the ring holds R batches where a provisioner holds the one it
    # decides: the set-up's objects go to the collector's permanent
    # generation, so that a full collection in the window walks what the
    # decisions made and not R batches of the harness's inputs
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    gc_clock = _GcClock()

    # the sample the reference judges: each batch's first decision, and
    # more drawn from the seed over the decisions the window should hold
    expect = max(R + 1, int(seconds * 1e3 / max(statistics.median(warm_ms), 1e-3)))
    extra = traffic["sample"] - R
    rng = gen.rng_for(seed, 0xC4EC)
    keep = set(range(R)) | set(
        (R + rng.choice(max(expect - R, extra), size=extra, replace=False)).tolist()
        if extra > 0 else ())
    records, kept = [], {}

    def decide(n, slice_=None):
        """Decision ``n`` of the run; returns its seconds."""
        b = batches[n % R]
        b.reset()
        gc0 = gc_clock.ms
        t0 = time.perf_counter()
        results, tr = program.decide(b)
        t1 = time.perf_counter()
        placed, failed = program.tally(results)
        rec = {"ms": (t1 - t0) * 1e3, "batch": n % R, "engine": program.engine,
               "pods": len(b.pods), "placed": placed, "failed": failed,
               "profiled": slice_ is not None, "gc_ms": gc_clock.ms - gc0}
        if (trace or detail is not None) and tr is not None:
            rec["spans"] = _span_ms(tr)
            rec["span_attrs"] = _span_attrs(tr)
            rec["top_ms"] = sum((c.dur or 0.0) for c in tr.root.children) * 1e3
        records.append(rec)
        if slice_ is not None:
            slice_.add(t0, t1, tr)
        if n in keep:
            kept[n] = program.answer(results)
        return t1 - t0

    window, n = 0.0, 0
    while window < seconds or n < R:
        window += decide(n)
        n += 1
    profile = None
    if trace:
        # the profiled slice follows the window: CUPTI, once on, slows
        # every later launch of the process, and the span medians come
        # from the window's decisions before it
        from portbench.devtrace import Slice

        with Slice(cuda, program) as slice_:
            for _ in range(traffic["profile_decisions"]):
                decide(n, slice_)
                n += 1
        profile = slice_.reduce()

    import torch

    peak = torch.cuda.max_memory_allocated() if cuda else 0
    gc_clock.stop()
    del program, batches
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the check: the kind's plain reference judges the sampled answers
    cat = kind.Catalog(cfg, plain_catalog)
    breaches = dict.fromkeys(kind.CHECKS, 0)
    for i, answer in kept.items():
        for k, v in kind.judge(cfg, cat, ring[i % R], answer).items():
            breaches[k] += v
    usd = sum(kind.cost(cat, ring[i], kept[i]) for i in range(R))
    placed_ring = sum(kind.placed(ring[i], kept[i]) for i in range(R))
    # one number is compared: the breaches of every guarantee together,
    # exact (limit 0); the bfloat16 controls' readings are in PERF.md
    checks = {"breaches": {"value": sum(breaches.values()), "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    if detail is not None:
        detail.extend(records)
    ms = [r["ms"] for r in records]
    e2e = {
        "pods_per_s": sum(r["placed"] for r in records) / window,
        "decide_p50_ms": statistics.median(ms),
        "decide_p90_ms": statistics.quantiles(ms, n=10)[8] if len(ms) >= 2 else ms[0],
        "usd_per_kpod_h": usd / (placed_ring / 1e3) if placed_ring else float("inf"),
        "setup_s": setup_s,
    }
    # a metric the harness does not take itself has a reader of its own
    ctx = SimpleNamespace(
        decisions=[r for r in records if not r["profiled"]],
        all_decisions=records, window_s=window, setup_s=setup_s,
        profile=profile, cell=cell, traffic=traffic)
    metrics = {}
    for m in spec.metrics(cell, "per_layer" if trace else "end_to_end"):
        value = e2e[m["name"]] if m["name"] in e2e else spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu", "kind": None, "count": 1,
           "memory_peak_bytes": peak}
    if cuda:
        info = card()
        dev["kind"] = info["kind"]
        dev["power_limit_w"] = info["power_limit_w"]
    if profile is not None:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
    out = {
        "correct": correct,
        "attempted": sum(r["pods"] for r in records),
        "failed": sum(r["failed"] for r in records),
        "metrics": metrics,
        "device": dev,
    }
    if profile is not None:
        out["breakdown"] = {"device_ops": profile["device_ops"],
                            "idle_gaps": profile["idle_gaps"]}
    out["run"] = {"workload": cell["name"], "seed": seed, "decisions": n,
                  "ms": [round(r["ms"], 1) for r in records], "gc_ms": gc_clock.ms,
                  "window_s": window, "judged": sorted(kept),
                  "engines": sorted({r["engine"] for r in records}),
                  "warm_ms": warm_ms, "breaches": breaches}
    out["checks"] = checks
    return out


class _GcClock:
    """Milliseconds the collector ran from now to ``stop``."""

    def __init__(self):
        self.ms, self._t0 = 0.0, None
        gc.callbacks.append(self._tick)

    def _tick(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms += (time.perf_counter() - self._t0) * 1e3

    def stop(self):
        gc.callbacks.remove(self._tick)


def _span_ms(trace) -> dict:
    """Milliseconds per span name over the decision's program spans."""
    out: dict = {}
    for sp in trace.spans():
        if sp is trace.root:
            continue
        out[sp.name] = out.get(sp.name, 0.0) + (sp.dur or 0.0) * 1e3
    return out


def _span_attrs(trace) -> list:
    """``[name, attributes]`` of every program span that has numbers or
    words as attributes, in the trace's order."""
    out = []
    for sp in trace.spans():
        if sp is trace.root or not sp.attrs:
            continue
        attrs = {k: v for k, v in sp.attrs.items()
                 if isinstance(v, (int, float, str, bool))}
        if attrs:
            out.append([sp.name, attrs])
    return out


def main(argv=None, t_start: float | None = None) -> int:
    args = parse(argv)
    spec = Spec()
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "present", file=sys.stderr)
        return 2
    detail = [] if args.detail else None
    out = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                   t_start=t_start, detail=detail)
    if detail is not None:
        with open(args.detail, "w") as f:
            json.dump(detail, f)
    found = banned_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print("breaches by guarantee " + json.dumps(out["run"]["breaches"]),
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
