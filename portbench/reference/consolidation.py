"""The plain reference of the consolidation kind: a disruption decision over
a fleet, judged node by node.

Plain Python and NumPy; it imports nothing of the program. It takes the
plain data the benchmark made (the configuration, its catalog worked out
again by ``judge.Catalog``, and a plain fleet of ``portbench/fleet.py``)
and reads the program's answer (the nodes the command retires, its
replacement claims with their pods, instance types and requirements, and
where each displaced pod went) only to judge it.

Each check counts the breaches of one guarantee that the configuration
states; a sound answer has none of any. The guarantees are those the
port's disruption methods keep (``controllers/disruption/methods.py``,
after upstream's ``consolidation.go``):

- ``retired``: retired names that are not nodes of the fleet, named twice,
  or more retired nodes of a NodePool than its budget allows (a
  percentage rounds up, ``nodepool.go`` GetAllowedDisruptions).
- ``placement``: a displaced pod (a pod of a retired node) placed other
  than exactly once, a placement of a pod that is not displaced, or onto
  what is neither a surviving node nor a replacement of the answer; a
  replacement whose pods are not exactly those placed on it.
- ``capacity``: a surviving node whose pods, its own and those placed on
  it, exceed its allocatable in exact milli-cpu, bytes and pod slots.
- ``selector``: a placed pod whose node selector the survivor's labels do
  not meet, or that its replacement's requirements do not pin.
- ``replacement``: a replacement of an unknown NodePool or whose
  requirements do not pin it, or whose instance types are not exactly
  those the port's rule leaves (``options``): of its NodePool's types
  compatible with its requirements, with a compatible offering, that fit
  its pods in exact milli-cpu, bytes and pod slots, the 60 cheapest
  (``MAX_INSTANCE_TYPES``, the simulation's truncation); of those, the
  ones priced strictly below the retired nodes (spot offerings alone when
  every retired node is spot, and then the 15 cheapest); and where a
  retired node's type is among them, only those strictly cheaper than it
  (``filter_out_same_type``).
- ``price``: a replacement listing a type whose price is not strictly
  below the retired nodes' (``compute_consolidation``'s price filter),
  replacements together not strictly cheaper than what they retire, or a
  single spot node replaced by a spot-to-spot command that lists fewer
  than 15 types (``SPOT_TO_SPOT_MIN_TYPES``, ``consolidation.go``).
- ``progress``: no node retired, though the budget allows one and some
  node's pods all fit the free capacity of the other nodes, exact and
  under their selectors (SingleNodeConsolidation tries every candidate,
  ``singlenodeconsolidation.go``; found here by first fit, so a fleet
  this misses is never counted against the answer).

``cost`` gives the fleet's hourly bill after the command: each surviving
node at its type's price, each replacement at its cheapest listed type
with an offering compatible with its requirements, as kwok launches it.
"""

from __future__ import annotations

import math

import numpy as np

from portbench.reference import judge as ref
from portbench.reference.judge import Catalog

CHECKS = ("retired", "placement", "capacity", "selector", "replacement",
          "price", "progress")
SPOT = "spot"
SPOT_TO_SPOT_MIN_TYPES = 15
MAX_INSTANCE_TYPES = 60


def allowed(budget: str, total: int) -> int:
    """Nodes a budget lets go at once: a percentage of ``total`` rounded
    up, or a count."""
    budget = str(budget).strip()
    if budget.endswith("%"):
        return int(math.ceil(total * float(budget[:-1]) / 100.0))
    return int(budget)


def node_labels(cat: Catalog, node: dict) -> dict:
    """The labels a fleet node carries: its type's, its offering's zone
    and capacity type, its NodePool and its hostname."""
    t = cat.index[node["type"]]
    return {**{k: next(iter(v)) for k, v in cat.labels[t].items()
               if k not in (ref.ZONE, ref.CAPACITY_TYPE)},
            ref.ZONE: node["zone"], ref.CAPACITY_TYPE: node["capacity_type"],
            ref.NODEPOOL: node["pool"], ref.HOSTNAME: node["name"]}


def _selected(selector: dict, labels: dict) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


def _load(pods) -> np.ndarray:
    """[milli-cpu, bytes, slots] of ``pods``, exact."""
    return np.array([sum(ref._milli(p["cpu"]) for p in pods),
                     sum(p["mem"] for p in pods), len(pods)], dtype=np.int64)


def _alloc(cat: Catalog, t: int) -> np.ndarray:
    return np.array([cat.alloc_cpu[t], cat.alloc_mem[t], cat.slots[t]],
                    dtype=np.int64)


def judge(cfg: dict, cat: Catalog, plain: dict, answer: dict) -> dict:
    """{check: breaches} of the program's ``answer`` for the fleet
    ``plain`` (see the module docstring)."""
    out = dict.fromkeys(CHECKS, 0)
    nodes = {n["name"]: n for n in plain["nodes"]}
    pods = {p["name"]: p for p in plain["pods"]}
    budgets = {p["name"]: p["disruption"]["budget"] for p in cfg["nodepools"]}

    # retired: distinct nodes of the fleet, within each NodePool's budget
    retired = [n for n in answer["retired"] if n in nodes]
    out["retired"] = (len(answer["retired"]) - len(retired)
                      + len(retired) - len(set(retired)))
    retired = set(retired)
    total: dict = {}
    for n in plain["nodes"]:
        total[n["pool"]] = total.get(n["pool"], 0) + 1
    gone: dict = {}
    for n in retired:
        gone[nodes[n]["pool"]] = gone.get(nodes[n]["pool"], 0) + 1
    out["retired"] += sum(max(0, k - allowed(budgets.get(pool, "0"), total[pool]))
                          for pool, k in gone.items())

    # placement: every displaced pod exactly once, on a survivor or a
    # replacement of the answer
    displaced = {p for n in retired for p in nodes[n]["pods"]}
    reps = answer["replacements"]
    on_node: dict = {}
    on_rep: dict = {}
    for name, targets in answer["placement"].items():
        if name not in displaced:
            out["placement"] += 1
            continue
        out["placement"] += len(targets) != 1
        for target in targets:
            if target in nodes and target not in retired:
                on_node.setdefault(target, []).append(pods[name])
            elif (target.startswith("+") and target[1:].isdigit()
                  and int(target[1:]) < len(reps)):
                on_rep.setdefault(int(target[1:]), []).append(pods[name])
            else:
                out["placement"] += 1
    out["placement"] += sum(1 for p in displaced if p not in answer["placement"])
    out["placement"] += sum(
        1 for i, r in enumerate(reps)
        if sorted(r["pods"]) != sorted(p["name"] for p in on_rep.get(i, [])))

    # survivors: capacity and selectors
    for name, moved in on_node.items():
        node = nodes[name]
        held = [pods[p] for p in node["pods"]] + moved
        out["capacity"] += bool((_load(held) > _alloc(cat, cat.index[node["type"]])).any())
        labels = node_labels(cat, node)
        out["selector"] += sum(not _selected(p["selector"], labels) for p in moved)

    # replacements: their types, their pods' selectors, their price
    pools = {p["name"] for p in cfg["nodepools"]}
    for i, r in enumerate(reps):
        moved, reqs = on_rep.get(i, []), r["reqs"]
        out["selector"] += sum(
            not all(reqs.get(k) == [False, [v]] for k, v in p["selector"].items())
            for p in moved)
        ok = (r["pool"] in pools and reqs.get(ref.NODEPOOL) == [False, [r["pool"]]]
              and bool(r["options"])
              and sorted(r["options"]) == sorted(
                  options(cat, reqs, moved, [nodes[n] for n in answer["retired"]
                                             if n in nodes])))
        out["replacement"] += not ok
    if reps:
        was = sum(cat.price[cat.index[nodes[n]["type"]]] for n in retired)
        listed = [cat.price[cat.index[t]] for r in reps for t in r["options"]
                  if t in cat.index]
        out["price"] += (sum(1 for p in listed if not p < was)
                         + (not cost_of_replacements(cat, answer) < was))
        spot = bool(retired) and all(nodes[n]["capacity_type"] == SPOT for n in retired)
        if spot and len(retired) == 1:
            out["price"] += sum(len(r["options"]) < SPOT_TO_SPOT_MIN_TYPES for r in reps)

    # progress: a no-op where a node could go
    if not retired and any(allowed(budgets.get(pool, "0"), k) > 0
                           for pool, k in total.items()):
        out["progress"] = int(_some_node_fits_elsewhere(cfg, cat, plain))
    return out


def options(cat: Catalog, reqs: dict, pods: list, retired: list) -> list:
    """The instance types a replacement with requirements ``reqs`` holding
    ``pods`` lists when it retires the nodes ``retired``, in exact
    arithmetic (the ``replacement`` guarantee of the module docstring)."""
    load = _load(pods)
    fit = ((cat.alloc_cpu >= load[0]) & (cat.alloc_mem >= load[1])
           & (cat.slots >= load[2]) & cat.compatible(reqs))
    ranked = sorted(np.flatnonzero(fit).tolist(),
                    key=lambda t: (cat.price[t], cat.names[t]))[:MAX_INSTANCE_TYPES]
    was = 0.0
    for n in retired:
        was += cat.price[cat.index[n["type"]]]
    spot = bool(retired) and all(n["capacity_type"] == SPOT for n in retired)
    if spot:
        ranked = [t for t in ranked if _spot_offering(cat, reqs, t)]
    priced = [t for t in ranked if cat.price[t] < was]
    if spot:
        priced = sorted(priced, key=lambda t: (cat.price[t], cat.names[t]))
        priced = priced[:SPOT_TO_SPOT_MIN_TYPES]
    own = [cat.price[cat.index[n["type"]]] for n in retired
           if cat.index[n["type"]] in priced]
    if own:
        priced = [t for t in priced if cat.price[t] < min(own)]
    return [cat.names[t] for t in priced]


def _spot_offering(cat: Catalog, reqs: dict, t: int) -> bool:
    return any(ct == SPOT and ref._allowed(reqs, ref.CAPACITY_TYPE, (ct,))
               and ref._allowed(reqs, ref.ZONE, (z,)) for ct, z in cat.offerings[t])


def _some_node_fits_elsewhere(cfg: dict, cat: Catalog, plain: dict) -> bool:
    """Whether first fit moves every pod of some node, within its
    NodePool's budget, onto the free capacity of the others."""
    budgets = {p["name"]: p["disruption"]["budget"] for p in cfg["nodepools"]}
    nodes = plain["nodes"]
    pods = {p["name"]: p for p in plain["pods"]}
    types = np.array([cat.index[n["type"]] for n in nodes])
    free = np.stack([cat.alloc_cpu[types], cat.alloc_mem[types], cat.slots[types]], 1)
    free = free - np.stack([_load([pods[p] for p in n["pods"]]) for n in nodes])
    labels = [node_labels(cat, n) for n in nodes]
    ok_for: dict = {}
    total: dict = {}
    for n in nodes:
        total[n["pool"]] = total.get(n["pool"], 0) + 1
    for i, n in enumerate(nodes):
        if allowed(budgets.get(n["pool"], "0"), total[n["pool"]]) < 1:
            continue
        room = free.copy()
        room[i] = -1
        moved = True
        for name in n["pods"]:
            p = pods[name]
            sel = tuple(sorted(p["selector"].items()))
            if sel not in ok_for:
                ok_for[sel] = np.array([_selected(p["selector"], lab) for lab in labels])
            need = _load([p])
            fit = np.flatnonzero(ok_for[sel] & (room >= need).all(1))
            if fit.size == 0:
                moved = False
                break
            room[fit[0]] -= need
        if moved:
            return True
    return False


def cost_of_replacements(cat: Catalog, answer: dict) -> float:
    """Each replacement at its cheapest listed type with an offering
    compatible with its requirements."""
    total = 0.0
    for r in answer["replacements"]:
        ok = cat.compatible(r["reqs"])
        prices = [cat.price[i] for i in (cat.index.get(t) for t in r["options"])
                  if i is not None and ok[i]]
        total += min(prices) if prices else float("inf")
    return total


def cost(cat: Catalog, plain: dict, answer: dict) -> float:
    """The fleet's hourly bill after the command."""
    retired = set(answer["retired"])
    kept = sum(cat.price[cat.index[n["type"]]] for n in plain["nodes"]
               if n["name"] not in retired)
    return kept + cost_of_replacements(cat, answer)


def placed(plain: dict, answer: dict) -> int:
    """The pods the fleet runs after the command: all of them (a
    displaced pod that found no home is a ``placement`` breach)."""
    return len(plain["pods"])
