"""The live kind's control: a plain packer in the program's place that
fills the running nodes' free capacity in bfloat16.

The configuration states no floating-point precision: its guarantees are
stated in exact milli-cpu, bytes and pod slots. The control breaks that
the way a later change to the existing-node tensorize or to the pack
kernel's phase A might be tempted to: where the program keeps float32 with
a tolerance of a millionth, it reads each running node's allocatable and
every pod's requests, running and pending, in bfloat16, in cores and GiB,
and lets a pod onto a node while the node's load stays within one
bfloat16 epsilon of its allocatable (``consolidation_control.Packer``).
Largest first, each burst pod takes the first running node with room;
the rest go to new claims by the provisioning control
(``control.answer``). It ignores pod (anti-)affinity and topology spread.
Bfloat16's steps (0.4% to 0.8% of a node's allocatable) are wider than
the running nodes' free capacity and the smallest pods (100 milli-cpu,
100 MiB), so a node it fills to its limit in bfloat16 is overfilled in
exact numbers (``existing_capacity``).
``python -m portbench.reference.live_control --workload <cell> --seeds
...`` puts it in the program's place in the harness's own ``run_cell``
(its window, sample and check), on the card, and prints each seed's
``correct`` and breaches by guarantee; a test keeps it at a small size.

Plain PyTorch; imports nothing of the program.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from portbench.reference import control
from portbench.reference import live as ref
from portbench.reference.consolidation_control import Packer


def answer(cfg: dict, cat: ref.Catalog, plain: dict, device="cpu") -> dict:
    """The control's answer for one input, in the program's plain form."""
    nodes = plain["nodes"]
    packer = Packer(cat, plain)
    packer.pods.update((p["name"], p) for p in plain["burst"])
    open_ = np.ones(len(nodes), dtype=bool)
    existing: dict = {}
    rest = []
    for p in sorted(plain["burst"], key=lambda p: (-p["cpu"], -p["mem"], p["name"])):
        need = packer.request(p["name"])
        j = packer.first_fit(need, open_)
        if j is None:
            rest.append(p)
            continue
        packer.load[j] += need
        existing.setdefault(nodes[j]["name"], []).append(p["name"])
    out = control.answer(cfg, cat, rest, device)
    out["existing"] = existing
    return out


class Live:
    """An input as the control takes it: the plain input, which it never
    writes."""

    def __init__(self, plain: dict):
        self.plain = plain
        self.pods = plain["burst"]

    def reset(self) -> None:
        pass


class Program:
    """The control in the program's place: the interface that
    ``run.run_cell`` drives, deciding each input with ``answer`` on
    ``device`` (None is the card)."""

    engine = "control"

    def __init__(self, cfg: dict, plain_catalog: list, traffic: dict, device=None):
        self.cfg = cfg
        self.cat = ref.Catalog(cfg, plain_catalog)
        self.device = torch.device(device or "cuda")
        self.cuda = self.device.type == "cuda"

    batch = staticmethod(Live)

    def decide(self, live: Live):
        out = answer(self.cfg, self.cat, live.plain, self.device)
        if self.cuda:
            torch.cuda.synchronize()
        return out, None

    @staticmethod
    def answer(results: dict) -> dict:
        return results

    @staticmethod
    def tally(results: dict) -> tuple:
        return ref.placed(None, results), len(results["errors"])


def run(spec, cell: dict, seed: int, seconds: float, device=None) -> dict:
    """One run of ``cell`` with the control deciding, through the
    harness's own ``run_cell``: its window, its sample and its check."""
    from portbench.run import run_cell

    return run_cell(spec, cell, seed, seconds, False, device=device, side=Program)


def main(argv=None) -> int:
    from portbench.spec import Spec

    ap = argparse.ArgumentParser(prog="python -m portbench.reference.live_control")
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
