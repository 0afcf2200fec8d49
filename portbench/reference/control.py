"""The control: a plain packer in the program's place, its arithmetic in
bfloat16.

The configuration states no floating-point precision: its guarantees are
stated in exact milli-cpu, bytes and pod slots. The control breaks that
one guarantee the way a later change to the pack loop might be tempted
to: it is a first-fit-decreasing packer whose loads, allocatable and fit
tests are bfloat16 (cores and GiB), where the program keeps float32 with
a tolerance of a millionth. It keeps one open claim per NodePool and
node selector (next fit) and lists as options the types on which its
bfloat16 load fits; it ignores pod (anti-)affinity and topology spread,
so in a topology mix it breaks those guarantees too: the precision
reading is its ``options`` (and ``unaccounted``) count, kept apart.
``python -m portbench.reference.control --workload <cell> --seeds ...``
puts it in the program's place in the harness's own ``run_cell`` (its
window, sample and check), on the card, and prints each seed's
``correct`` and breaches by guarantee; a test keeps it at a small size.

Plain PyTorch; imports nothing of the program.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench.reference import judge as ref

LOW = torch.bfloat16


def answer(cfg: dict, cat: ref.Catalog, plain: list, device="cpu") -> dict:
    """The control's answer for one batch, in the program's plain form."""
    alloc = torch.tensor(
        [[c / 1000.0, m / ref.GIB, s] for c, m, s in
         zip(cat.alloc_cpu.tolist(), cat.alloc_mem.tolist(), cat.slots.tolist())],
        dtype=LOW, device=device)
    pools = sorted(cfg["nodepools"], key=lambda p: (-p["weight"], p["name"]))
    order = sorted(range(len(plain)),
                   key=lambda i: (-plain[i]["cpu"], -plain[i]["mem"]))
    claims, open_by_class = [], {}
    for i in order:
        p = plain[i]
        sel = tuple(sorted(p["selector"].items()))
        d = torch.tensor([p["cpu"], p["mem"] / ref.GIB, 1.0], dtype=LOW,
                         device=device)
        c = open_by_class.get(sel)
        if c is not None:
            load = c["load"] + d
            fit = c["mask"] & (load <= alloc).all(-1)
            if bool(fit.any()):
                c.update(load=load, mask=fit)
                c["pods"].append(p["name"])
                continue
        for pool in pools:
            reqs = {ref.NODEPOOL: [False, [pool["name"]]],
                    **{k: [False, [v]] for k, v in sel}}
            mask = torch.as_tensor(cat.compatible(reqs), device=device)
            fit = mask & (d <= alloc).all(-1)
            if bool(fit.any()):
                c = {"pool": pool["name"], "reqs": reqs, "load": d, "mask": fit,
                     "pods": [p["name"]]}
                claims.append(c)
                open_by_class[sel] = c
                break
    return {"claims": [{
        "pool": c["pool"], "pods": c["pods"], "reqs": c["reqs"],
        "options": [cat.names[t] for t in
                    torch.nonzero(c["mask"]).flatten().tolist()]}
        for c in claims],
        "errors": sorted(set(p["name"] for p in plain)
                         - {n for c in claims for n in c["pods"]})}


class Batch:
    """A batch as the control takes it: the plain pods, which it never
    writes."""

    def __init__(self, plain: list):
        self.plain = self.pods = plain

    def reset(self) -> None:
        pass


class Program:
    """The control in the program's place: the interface of
    ``system.Program`` that ``run.run_cell`` drives, deciding each batch
    with ``answer`` on ``device`` (None is the card)."""

    engine = "control"

    def __init__(self, cfg: dict, plain_catalog: list, topology: bool, device=None):
        self.cfg = cfg
        self.cat = ref.Catalog(cfg, plain_catalog)
        self.device = torch.device(device or "cuda")
        self.cuda = self.device.type == "cuda"

    batch = staticmethod(Batch)

    def decide(self, batch: Batch):
        out = answer(self.cfg, self.cat, batch.plain, self.device)
        if self.cuda:
            torch.cuda.synchronize()
        return out, None

    @staticmethod
    def answer(results: dict) -> dict:
        return results

    @staticmethod
    def tally(results: dict) -> tuple:
        return ref.placed(results), len(results["errors"])


def program(cfg: dict, plain_catalog: list, traffic: dict, device=None) -> Program:
    """The control for the configuration, as ``run_cell`` makes a side."""
    return Program(cfg, plain_catalog, traffic["topology"], device)


def run(spec, cell: dict, seed: int, seconds: float, device=None) -> dict:
    """One run of ``cell`` with the control deciding, through the
    harness's own ``run_cell``: its window, its sample and its check."""
    from portbench.run import run_cell

    return run_cell(spec, cell, seed, seconds, False, device=device, side=program)


def main(argv=None) -> int:
    from portbench.spec import Spec

    ap = argparse.ArgumentParser(prog="python -m portbench.reference.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    spec = Spec()
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        out = run(spec, cell, seed, args.seconds, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "decisions": out["run"]["decisions"],
                          "judged": len(out["run"]["judged"]),
                          "breaches": out["run"]["breaches"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
