"""The plain reference of the live kind: a provisioning decision onto a
running cluster, judged claim by claim and node by node.

Plain Python and NumPy; it imports nothing of the program. It takes the
plain data the benchmark made (the configuration, its catalog worked out
again by ``judge.Catalog``, and a plain input of ``portbench/live.py``:
the running nodes and pods, and the burst of pending pods) and reads the
program's answer (the new claims with their pods, instance types and
requirements, the burst pods placed on each existing node, and the pods
reported unschedulable) only to judge it.

Each check counts the breaches of one guarantee that the configuration
states; a sound answer has none of any:

- ``accounting``: burst pods placed nowhere and not reported, placed or
  reported more than once, names that are not burst pods (a running pod
  moved), and pods placed on a node the cluster does not have.
- ``bad_errors``, ``selector``: ``judge.py``'s checks of the same names,
  on the new claims.
- ``options``: new claims whose instance types are not exactly the
  ``MAX_INSTANCE_TYPES`` (60) cheapest, by price and then by name, of
  their NodePool's types that are compatible with the claim's
  requirements, fit its pods in exact milli-cpu, bytes and pod slots and
  have a compatible offering (all of them where fewer): the provisioner
  truncates each claim's list so (``Provisioner.schedule``, upstream's
  ``MaxInstanceTypes``); and claims no type can take.
- ``existing_capacity``: existing nodes whose running pods and placed
  pods together exceed the node's allocatable in exact milli-cpu, bytes
  and pod slots.
- ``existing_selector``: placed pods whose node selector the node's labels
  do not meet.
- ``anti``, ``affinity``, ``spread``: ``judge.py``'s rules over every
  domain the decision places into, the running pods counted in their
  nodes' domains. An existing node is its own hostname domain and lies in
  its zone. ``anti`` counts pairs in one domain where either pod's
  required anti-affinity selects the other; ``affinity`` needs a pod the
  term selects, running or placed, in the domain; ``spread`` bounds each
  domain's self-matching owners by the count Kubernetes admits them at,
  whatever the order: with ``r`` pods that match the selector already
  running in the domain and ``m`` owners placed there, at most
  ``max(0, skew + min - r)`` owners can have been admitted, the minimum
  being 0 for a hostname key (a new node) and the least final count over
  the eligible zones for any other key.

``cost`` gives the hourly price of the new claims (``judge.cost``): pods
fitted into the running nodes' free capacity cost nothing.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import judge as ref
from portbench.reference.consolidation import MAX_INSTANCE_TYPES, node_labels
from portbench.reference.judge import HOSTNAME, Catalog

CHECKS = ("accounting", "bad_errors", "selector", "options", "existing_capacity",
          "existing_selector", "anti", "affinity", "spread")
CLAIM_CHECKS = ("bad_errors", "selector")


def _signature(labels: dict) -> frozenset:
    return frozenset(labels.items())


class _Place:
    """Where the decision put pods: a new claim or an existing node; its
    zones (one for a node, those its requirements allow for a claim), its
    running pods and the burst pods placed there."""

    def __init__(self, name: str, zones: frozenset, running: list, placed: list,
                 labels: dict | None):
        self.name = name
        self.zones = zones
        self.running = running
        self.placed = placed
        self.labels = labels  # a node's labels; None for a claim

    @property
    def pods(self) -> list:
        return self.running + self.placed


def judge(cfg: dict, cat: Catalog, plain: dict, answer: dict) -> dict:
    """{check: breaches} of the program's ``answer`` for the input
    ``plain`` (see the module docstring)."""
    out = dict.fromkeys(CHECKS, 0)
    burst = {p["name"]: p for p in plain["burst"]}
    nodes = {n["name"]: n for n in plain["nodes"]}
    claims = answer["claims"]
    existing = answer.get("existing", {})

    # accounting: every burst pod exactly once, nothing else
    seen: dict = {}
    for names in [c["pods"] for c in claims] + list(existing.values()) + [answer["errors"]]:
        for n in names:
            seen[n] = seen.get(n, 0) + 1
    out["accounting"] = (sum(1 for n in burst if n not in seen)
                         + sum(v - 1 for v in seen.values() if v > 1)
                         + sum(1 for n in seen if n not in burst)
                         + sum(len(names) for node, names in existing.items()
                               if node not in nodes))

    # the new claims: judge.py's own checks of them
    base = ref.judge(cfg, cat, plain["burst"], {"claims": claims,
                                                "errors": answer["errors"]})
    for k in CLAIM_CHECKS:
        out[k] = base[k]
    out["options"] = sum(not _options_ok(cat, c, burst) for c in claims)

    # every place the decision put pods into, with the running pods
    on_node: dict = {}
    for p in plain["pods"]:
        on_node.setdefault(p["node"], []).append(p)
    places = [_Place(f"+{i}", frozenset(ref._allowed(c["reqs"], ref.ZONE, cat.zones)),
                     [], [burst[n] for n in c["pods"] if n in burst], None)
              for i, c in enumerate(claims)]
    for name, node in nodes.items():
        placed = [burst[n] for n in existing.get(name, ()) if n in burst]
        places.append(_Place(name, frozenset([node["zone"]]), on_node.get(name, []),
                             placed, node_labels(cat, node)))

    # existing nodes: capacity with the running pods, and selectors
    for pl in places:
        if pl.labels is None or not pl.placed:
            continue
        t = cat.index[nodes[pl.name]["type"]]
        pods = pl.pods
        load = (sum(ref._milli(p["cpu"]) for p in pods), sum(p["mem"] for p in pods),
                len(pods))
        out["existing_capacity"] += bool(load[0] > cat.alloc_cpu[t] or load[1] > cat.alloc_mem[t]
                                         or load[2] > cat.slots[t])
        out["existing_selector"] += sum(
            1 for p in pl.placed
            if not all(pl.labels.get(k) == v for k, v in p["selector"].items()))

    out["anti"] = _anti(places)
    out["affinity"] = _affinity(places)
    out["spread"] = _spread(cat, places)
    return out


def _options_ok(cat: Catalog, claim: dict, burst: dict) -> bool:
    """Whether the claim lists exactly its truncated options (the
    ``options`` guarantee of the module docstring)."""
    pods = [burst[n] for n in claim["pods"] if n in burst]
    fit = ((cat.alloc_cpu >= sum(ref._milli(p["cpu"]) for p in pods))
           & (cat.alloc_mem >= sum(p["mem"] for p in pods)) & (cat.slots >= len(pods))
           & cat.compatible(claim["reqs"]))
    want = sorted(np.flatnonzero(fit).tolist(),
                  key=lambda t: (cat.price[t], cat.names[t]))[:MAX_INSTANCE_TYPES]
    return bool(want) and sorted(claim["options"]) == sorted(cat.names[t] for t in want)


def _zone_index(places: list) -> dict:
    """{zone: places that may lie in it}."""
    out: dict = {}
    for pl in places:
        for z in pl.zones:
            out.setdefault(z, []).append(pl)
    return out


def _anti(places: list) -> int:
    """Pairs in one domain where either pod's required anti-affinity
    selects the other, each placed pod's terms counted against every pod of
    its domain and each running pod's terms against the placed pods of its
    domain (a running pair is the cluster's, not the decision's)."""
    in_zone = _zone_index(places)

    def near(pl, key):
        if key == HOSTNAME:
            return [pl]
        return list({id(q): q for z in pl.zones for q in in_zone.get(z, [])}.values())

    out = 0
    for pl in places:
        if not pl.placed:
            continue
        for p in pl.placed:
            for term in p["anti"]:
                out += sum(1 for q_pl in near(pl, term["key"]) for q in q_pl.pods
                           if q is not p and ref._selects(term["match"], q["labels"]))
        for r in pl.running:
            for term in r["anti"]:
                out += sum(1 for q_pl in near(pl, term["key"]) for q in q_pl.placed
                           if ref._selects(term["match"], q["labels"]))
    return out


def _affinity(places: list) -> int:
    """Placed pods with required pod affinity whose domain holds no other
    pod, running or placed, that the term selects, unless the pod selects
    itself (``judge.py``'s rule). A zone holds the pods of the existing
    nodes in it and of the claims pinned to it alone; a claim open to
    several zones must find a selected pod in each."""
    held: dict = {}  # zone -> {label signature: count}
    for pl in places:
        if len(pl.zones) != 1:
            continue
        sig = held.setdefault(next(iter(pl.zones)), {})
        for q in pl.pods:
            s = _signature(q["labels"])
            sig[s] = sig.get(s, 0) + 1

    def selected(match: dict, counts: dict) -> bool:
        want = _signature(match)
        return any(want <= s for s in counts)

    out = 0
    for pl in places:
        for p in pl.placed:
            for term in p["affinity"]:
                if ref._selects(term["match"], p["labels"]):
                    continue
                if term["key"] == HOSTNAME:
                    ok = any(q is not p and ref._selects(term["match"], q["labels"])
                             for q in pl.pods)
                else:
                    ok = all(selected(term["match"], held.get(z, {})) for z in pl.zones)
                out += not ok
    return out


def _spread(cat: Catalog, places: list) -> int:
    """Breaches of topology spread, per group of owners (the key, the
    selector, the skew and the owners' node selector), the running pods on
    nodes the owners' node selector allows counted in their domains (see
    the module docstring)."""
    groups: dict = {}
    for pl in places:
        for p in pl.placed:
            for s in p["spread"]:
                g = (s["key"], tuple(sorted(s["match"].items())), s["skew"],
                     tuple(sorted(p["selector"].items())))
                groups.setdefault(g, []).append((pl, p))
    out = 0
    for (key, match, skew, sel), owners in groups.items():
        match, sel = dict(match), dict(sel)

        def counted(pl) -> bool:
            return pl.labels is None or all(pl.labels.get(k) == v for k, v in sel.items())

        def matching(pods) -> int:
            return sum(1 for q in pods if ref._selects(match, q["labels"]))

        mine: dict = {}
        for pl, p in owners:
            if ref._selects(match, p["labels"]):
                mine[id(pl)] = mine.get(id(pl), 0) + 1
        if key == HOSTNAME:
            for pl in {id(pl): pl for pl, _ in owners}.values():
                m = mine.get(id(pl), 0)
                r = matching(pl.running) if counted(pl) else 0
                out += max(0, min(m, r + m - skew))
            continue
        universe = cat.domains(key)
        if key != ref.ZONE:
            # the reference places domains of the hostname and the zone, the
            # mix's two keys; an owner of any other key is not judged sound
            out += len(owners)
            continue
        out += sum(1 for pl, _ in owners if len(pl.zones) != 1)
        eligible = ref._allowed({key: [False, [sel[key]]]} if key in sel else {}, key,
                                universe)
        count = dict.fromkeys(eligible, 0)
        run_in = dict.fromkeys(eligible, 0)
        mine_in: dict = {}
        for pl in places:
            if len(pl.zones) != 1 or not counted(pl):
                continue
            z = next(iter(pl.zones))
            if z not in count:
                continue
            r = matching(pl.running)
            run_in[z] += r
            count[z] += r + matching(pl.placed)
            mine_in[z] = mine_in.get(z, 0) + mine.get(id(pl), 0)
        lo = min(count.values()) if count else 0
        for z, m in mine_in.items():
            out += max(0, min(m, run_in[z] + m - lo - skew))
    return out


def cost(cat: Catalog, plain: dict, answer: dict) -> float:
    """The hourly price of the answer's new claims (``judge.cost``)."""
    return ref.cost(cat, answer)


def placed(plain: dict, answer: dict) -> int:
    """The burst pods the answer places, on new claims or existing
    nodes."""
    return (sum(len(c["pods"]) for c in answer["claims"])
            + sum(len(v) for v in answer.get("existing", {}).values()))
