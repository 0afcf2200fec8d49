"""The consolidation kind's control: a plain consolidator in the program's
place, its fit in bfloat16.

The configuration states no floating-point precision: its guarantees are
stated in exact milli-cpu, bytes and pod slots. The control breaks that
the way a later change to the probe or the confirming solve might be
tempted to: where the program keeps float32 with a tolerance of a
millionth, it reads the catalog's allocatable and every pod's requests in
bfloat16, in cores and GiB, and lets a pod onto a node while the node's
load stays within one bfloat16 epsilon of its allocatable
(``Packer``). It decides as the program's plans on this fleet do: it
deletes nodes and replaces none. Within the NodePool's budget it takes
the nodes in the order the disruption methods weigh them (fewest pods
first, then by name) and retires each whose pods, largest first, all
find room by first fit on the nodes that stay; a node that has taken
pods stays. Bfloat16's steps (0.4% to 0.8% of a node's allocatable) are
wider than the smallest pods (100 milli-cpu, 100 MiB) on the fleet's
larger nodes, so a node it fills to its limit in bfloat16 is overfilled
in exact numbers (``capacity``).
``python -m portbench.reference.consolidation_control --workload <cell>
--seeds ...`` puts it in the program's place in the harness's own
``run_cell`` (its window, sample and check), on the card, and prints each
seed's ``correct`` and breaches by guarantee; a test keeps it at a small
size.

Plain PyTorch; imports nothing of the program.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from portbench.reference import consolidation as ref
from portbench.reference.judge import GIB

LOW = torch.bfloat16


def _low(values) -> np.ndarray:
    return torch.tensor(np.asarray(values, dtype=np.float64), dtype=LOW).double().numpy()


class Packer:
    """The fleet's room as the control sees it: allocatable and requests in
    cores, GiB and slots rounded to ``LOW``, a node's limit its
    allocatable times one ``LOW`` epsilon more."""

    def __init__(self, cat: ref.Catalog, plain: dict):
        types = np.array([cat.index[n["type"]] for n in plain["nodes"]])
        slack = 1 + torch.finfo(LOW).eps
        self.limit = np.stack([_low(cat.alloc_cpu[types] / 1000.0) * slack,
                               _low(cat.alloc_mem[types] / GIB) * slack,
                               cat.slots[types].astype(np.float64)], 1)
        self.load = np.zeros_like(self.limit)
        self.pods = {p["name"]: p for p in plain["pods"]}
        for i, n in enumerate(plain["nodes"]):
            for name in n["pods"]:
                self.load[i] += self.request(name)

    def request(self, name: str) -> np.ndarray:
        p = self.pods[name]
        return np.array([_low(p["cpu"])[()], _low(p["mem"] / GIB)[()], 1.0])

    def first_fit(self, need: np.ndarray, open_: np.ndarray) -> int | None:
        fits = np.flatnonzero(open_ & ((self.load + need) <= self.limit).all(1))
        return int(fits[0]) if fits.size else None


def answer(cfg: dict, cat: ref.Catalog, plain: dict) -> dict:
    """The control's answer for one fleet, in the program's plain form:
    the nodes it deletes and where each of their pods went."""
    nodes = plain["nodes"]
    budget = {p["name"]: p["disruption"]["budget"] for p in cfg["nodepools"]}
    total: dict = {}
    for n in nodes:
        total[n["pool"]] = total.get(n["pool"], 0) + 1
    left = {pool: ref.allowed(budget.get(pool, "0"), k) for pool, k in total.items()}
    packer = Packer(cat, plain)
    open_ = np.ones(len(nodes), dtype=bool)  # may still take pods
    took = np.zeros(len(nodes), dtype=bool)  # has taken pods: stays
    retired, placement = [], {}
    order = sorted(range(len(nodes)), key=lambda i: (len(nodes[i]["pods"]), nodes[i]["name"]))
    for i in order:
        n = nodes[i]
        if took[i] or left[n["pool"]] < 1:
            continue
        open_[i] = False
        load, moves = packer.load.copy(), []
        for name in sorted(n["pods"], key=lambda p: (-packer.pods[p]["cpu"],
                                                      -packer.pods[p]["mem"], p)):
            need = packer.request(name)
            j = packer.first_fit(need, open_)
            if j is None:
                break
            packer.load[j] += need
            moves.append((name, j))
        if len(moves) < len(n["pods"]):
            packer.load = load
            open_[i] = True
            continue
        left[n["pool"]] -= 1
        retired.append(n["name"])
        for name, j in moves:
            took[j] = True
            placement[name] = [nodes[j]["name"]]
    return {"retired": retired, "replacements": [], "placement": placement}


class Fleet:
    """A fleet as the control takes it: the plain fleet, which it never
    writes."""

    def __init__(self, plain: dict):
        self.plain = plain
        self.pods = plain["pods"]

    def reset(self) -> None:
        pass


class Program:
    """The control in the program's place: the interface that
    ``run.run_cell`` drives, deciding each fleet with ``answer``; ``device``
    None is the card, whose memory it never touches."""

    engine = "control"

    def __init__(self, cfg: dict, plain_catalog: list, traffic: dict, device=None):
        self.cfg = cfg
        self.cat = ref.Catalog(cfg, plain_catalog)
        self.device = torch.device(device or "cuda")
        self.cuda = self.device.type == "cuda"

    batch = staticmethod(Fleet)

    def decide(self, fleet: Fleet):
        out = answer(self.cfg, self.cat, fleet.plain)
        if self.cuda:
            torch.cuda.synchronize()
        return out, None

    @staticmethod
    def answer(results: dict) -> dict:
        return results

    @staticmethod
    def tally(results: dict) -> tuple:
        return len(results["placement"]), 0


def run(spec, cell: dict, seed: int, seconds: float, device=None) -> dict:
    """One run of ``cell`` with the control deciding, through the
    harness's own ``run_cell``: its window, its sample and its check."""
    from portbench.run import run_cell

    return run_cell(spec, cell, seed, seconds, False, device=device, side=Program)


def main(argv=None) -> int:
    from portbench.spec import Spec

    ap = argparse.ArgumentParser(prog="python -m portbench.reference.consolidation_control")
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
                          "checks": out["checks"],
                          "usd_per_kpod_h": out["metrics"]["usd_per_kpod_h"]["value"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
