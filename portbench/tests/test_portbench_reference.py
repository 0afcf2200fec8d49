"""The plain reference against the port on the CPU, its control, and each
of its checks against an answer broken on purpose."""

from __future__ import annotations

import copy

import pytest

from portbench import gen
from portbench.reference import control
from portbench.reference import judge as ref
from portbench.spec import Spec

CELLS = ["burst-50k", "diverse-500", "generic-500"]


def _setup(small_root, name):
    spec = Spec(small_root)
    cell = spec.cell(name)
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    plain_catalog = gen.catalog(cfg)
    return spec, cell, cfg, traffic, plain_catalog, ref.Catalog(cfg, plain_catalog)


def _program_answers(cfg, traffic, plain_catalog, seed):
    from portbench import system

    program = system.Program(cfg, plain_catalog, traffic["topology"], "cpu")
    out = []
    for plain in gen.ring(traffic, seed):
        results, _ = program.decide(system.Batch(plain))
        out.append((plain, system.answer(results)))
    return program, out


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [3, 2**33 + 5])
def test_port_is_correct_by_the_reference(small_root, name, seed, engine):
    _, _, cfg, traffic, plain_catalog, cat = _setup(small_root, name)
    program, answers = _program_answers(cfg, traffic, plain_catalog, seed)
    assert program.engine == ("cpu" if engine == "device" else "native")
    for plain, answer in answers:
        assert ref.judge(cfg, cat, plain, answer) == dict.fromkeys(ref.CHECKS, 0)
        assert ref.placed(answer) + len(answer["errors"]) == len(plain)
        assert 0 < ref.cost(cat, answer) < float("inf")


def test_a_decision_leaves_its_batch_as_it_was_after_reset(small_root):
    """A solve memoises on the pods; ``Batch.reset`` gives the next
    decision the pods as they were made, nested objects included."""
    import pickle

    from portbench import system

    _, _, cfg, traffic, plain_catalog, _ = _setup(small_root, "diverse-500")
    program = system.Program(cfg, plain_catalog, True, "cpu")
    batch = system.Batch(gen.ring(traffic, 9)[0])
    made = pickle.dumps(batch.pods)
    first = system.answer(program.decide(batch)[0])
    assert pickle.dumps(batch.pods) != made  # the solve memoised on them
    batch.reset()
    assert pickle.dumps(batch.pods) == made
    second = system.answer(program.decide(batch)[0])
    strip = lambda a: [(c["pool"], c["pods"], c["options"]) for c in a["claims"]]  # noqa: E731
    assert strip(first) == strip(second)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(small_root, name):
    """The control in the program's place, through the harness's own
    ``run_cell``: ``correct`` false on every seed, from its precision
    alone (``options``), and the same packer in float64 breaks no
    capacity guarantee."""
    spec, cell, *_ = _setup(small_root, name)
    for seed in (1, 2, 3, 2**33 + 7):
        out = control.run(spec, cell, seed, 0.05, "cpu")
        assert out["correct"] is False, out["checks"]
        assert out["run"]["breaches"]["options"] > 0, out["run"]["breaches"]
        assert out["run"]["engines"] == ["control"]


@pytest.mark.parametrize("name", CELLS)
def test_control_in_float64_fits(small_root, name, monkeypatch):
    monkeypatch.setattr(control, "LOW", __import__("torch").float64)
    spec, cell, *_ = _setup(small_root, name)
    out = control.run(spec, cell, 5, 0.05, "cpu")
    assert out["run"]["breaches"]["options"] == 0, out["run"]["breaches"]
    assert out["run"]["breaches"]["unaccounted"] == 0, out["run"]["breaches"]


def _answer(small_root, name="diverse-500", seed=4):
    _, _, cfg, traffic, plain_catalog, cat = _setup(small_root, name)
    _, answers = _program_answers(cfg, traffic, plain_catalog, seed)
    return cfg, cat, answers[0]


def _breaks(cfg, cat, plain, answer, check):
    got = ref.judge(cfg, cat, plain, answer)
    assert got[check] > 0, got


def test_judge_finds_a_lost_pod(small_root):
    cfg, cat, (plain, answer) = _answer(small_root)
    bad = copy.deepcopy(answer)
    bad["claims"][0]["pods"].pop()
    _breaks(cfg, cat, plain, bad, "unaccounted")


def test_judge_finds_a_pod_moved_to_the_errors(small_root):
    cfg, cat, (plain, answer) = _answer(small_root)
    bad = copy.deepcopy(answer)
    name = next(n for c in bad["claims"] for n in c["pods"]
                if not next(p for p in plain if p["name"] == n)["affinity"])
    for c in bad["claims"]:
        if name in c["pods"]:
            c["pods"].remove(name)
    bad["errors"].append(name)
    _breaks(cfg, cat, plain, bad, "bad_errors")


def test_judge_finds_an_option_added_or_dropped(small_root):
    cfg, cat, (plain, answer) = _answer(small_root)
    bad = copy.deepcopy(answer)
    c = max(bad["claims"], key=lambda c: len(c["options"]))
    c["options"].pop()
    _breaks(cfg, cat, plain, bad, "options")
    bad = copy.deepcopy(answer)
    c = max(bad["claims"], key=lambda c: len(c["pods"]))
    c["options"].append(next(n for n in cat.names if n not in c["options"]))
    _breaks(cfg, cat, plain, bad, "options")


def test_judge_finds_a_selector_dropped(small_root):
    cfg, cat, (plain, answer) = _answer(small_root, "burst-50k")
    bad = copy.deepcopy(answer)
    c = next(c for c in bad["claims"] if "kubernetes.io/arch" in c["reqs"]
             and any(next(p for p in plain if p["name"] == n)["selector"]
                     for n in c["pods"]))
    del c["reqs"]["kubernetes.io/arch"]
    _breaks(cfg, cat, plain, bad, "selector")


def test_judge_finds_anti_affinity_broken(small_root):
    cfg, cat, (plain, answer) = _answer(small_root)
    bad = copy.deepcopy(answer)
    anti = [n for n in (p["name"] for p in plain if p["anti"])]
    a, b = anti[0], anti[1]
    for c in bad["claims"]:
        if b in c["pods"]:
            c["pods"].remove(b)
    next(c for c in bad["claims"] if a in c["pods"])["pods"].append(b)
    _breaks(cfg, cat, plain, bad, "anti")


def test_judge_finds_affinity_and_spread_broken(small_root):
    cfg, cat, (plain, answer) = _answer(small_root)
    by = {p["name"]: p for p in plain}
    bad = copy.deepcopy(answer)
    # every pod to a claim of its own, open to every zone
    bad["claims"] = [{**c, "pods": [n], "reqs": {k: v for k, v in c["reqs"].items()
                                                 if k != ref.ZONE}}
                     for c in bad["claims"] for n in c["pods"]]
    got = ref.judge(cfg, cat, plain, bad)
    if any(t["key"] == ref.HOSTNAME and not ref._selects(t["match"], by[n]["labels"])
           for n in by for t in by[n]["affinity"]):
        assert got["affinity"] > 0, got
    assert got["spread"] > 0, got


# topology spread, on answers made by hand: six pods that own a zone
# spread (skew 1) and match their own selector, and pods that only match


def _spread_setup(small_root):
    _, _, cfg, _, _, cat = _setup(small_root, "diverse-500")
    return cfg, cat


def _pod(name, label, key=None, match=None):
    spread = [{"key": key, "skew": 1, "match": {"my-label": match}}] if key else []
    return gen._plain(name, 0.1, 2**20, {"my-label": label}, spread=spread)


def _claims(cat, groups, key=ref.ZONE):
    """One claim per ``(zone or None, pods)``; a claim open to every zone
    where the zone is None."""
    out = []
    for zone, pods in groups:
        reqs = {ref.NODEPOOL: [False, ["default"]]}
        if zone is not None:
            reqs[ref.ZONE] = [False, [zone]]
        out.append({"pool": "default", "pods": [p["name"] for p in pods],
                    "reqs": reqs, "options": []})
    return {"claims": out, "errors": []}


def test_judge_counts_zone_skew(small_root):
    cfg, cat = _spread_setup(small_root)
    z1, z2, z3 = cat.zones
    owners = [_pod(f"o{i}", "a", ref.ZONE, "a") for i in range(6)]
    even = _claims(cat, [(z1, owners[:2]), (z2, owners[2:4]), (z3, owners[4:])])
    assert ref.judge(cfg, cat, owners, even)["spread"] == 0
    # every owner in one zone: 6 there against 0 in the others, skew 1
    one = _claims(cat, [(z1, owners[:3]), (z1, owners[3:])])
    assert ref.judge(cfg, cat, owners, one)["spread"] == 5
    # four in one zone, two in another, none in the third: over by three
    # and by one
    skewed = _claims(cat, [(z1, owners[:4]), (z2, owners[4:])])
    assert ref.judge(cfg, cat, owners, skewed)["spread"] == 4
    # an owner on a claim open to every zone
    open_ = _claims(cat, [(z1, owners[:2]), (z2, owners[2:4]), (z3, owners[4:5]),
                          (None, owners[5:])])
    assert ref.judge(cfg, cat, owners, open_)["spread"] == 1


def test_judge_counts_matching_pods_that_own_nothing(small_root):
    """Pods that match the selector without owning the spread count in
    every zone: they raise the least count, so three owners may share a
    zone where two matching pods sit in each other zone (an order exists
    in which Kubernetes admits it), and not where one sits in each."""
    cfg, cat = _spread_setup(small_root)
    z1, z2, z3 = cat.zones
    owners = [_pod(f"o{i}", "a", ref.ZONE, "a") for i in range(3)]
    others = [_pod(f"g{i}", "a") for i in range(4)]
    plain = owners + others
    legal = _claims(cat, [(z1, owners), (z2, others[:2]), (z3, others[2:])])
    assert ref.judge(cfg, cat, plain, legal)["spread"] == 0
    short = _claims(cat, [(z1, owners), (z2, others[:1]), (z3, others[1:2]),
                          (z1, others[2:])])
    assert ref.judge(cfg, cat, plain, short)["spread"] == 1
    # pods of another label count for nothing
    foreign = [_pod(f"b{i}", "b") for i in range(4)]
    plain = owners + foreign
    bad = _claims(cat, [(z1, owners), (z2, foreign[:2]), (z3, foreign[2:])])
    assert ref.judge(cfg, cat, plain, bad)["spread"] == 2


def test_judge_counts_hostname_spread(small_root):
    """A claim is a hostname domain with a least count of 0: two owners
    that match their own selector on one claim break a skew of 1. An owner
    that does not match its own selector adds nothing to the count, and
    the pods it selects may have joined the claim after it, so a claim of
    one such owner and many matching pods breaks nothing."""
    cfg, cat = _spread_setup(small_root)
    z1 = cat.zones[0]
    mine = [_pod(f"s{i}", "a", ref.HOSTNAME, "a") for i in range(3)]
    assert ref.judge(cfg, cat, mine, _claims(cat, [(z1, mine[:1]), (z1, mine[1:2]),
                                                   (z1, mine[2:])]))["spread"] == 0
    assert ref.judge(cfg, cat, mine, _claims(cat, [(z1, mine)]))["spread"] == 2
    other = _pod("n0", "b", ref.HOSTNAME, "a")
    matching = [_pod(f"g{i}", "a") for i in range(3)]
    plain = [other] + matching
    assert ref.judge(cfg, cat, plain, _claims(cat, [(None, plain)]))["spread"] == 0
    # owners of one selector that do not match it, side by side with two
    # that do: only the two count
    plain = [other, _pod("n1", "c", ref.HOSTNAME, "a")] + mine[:2]
    assert ref.judge(cfg, cat, plain, _claims(cat, [(None, plain)]))["spread"] == 1
