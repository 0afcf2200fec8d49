"""The solve's dispatch path in the port against the JAX package's: the
speculative doubled dispatch (``TorchSolver._invoke_spec`` against
``TPUSolver._invoke_spec``) and the profiler hook
(``KARPENTER_PROFILE_DIR``).

Inputs: ``tests/test_torch_solver.py``'s ``_one_per_node(600)``, built by
each package from its own objects: one pod per node, so the estimated bin
axis (512) runs dry once and the solve doubles it (1,024). ``TPUSolver``
runs its XLA rung and ``TorchSolver(device="cpu")`` its device rung (the
conftest pins ``KARPENTER_NATIVE_CUTOFF=0``).

Both packages speculate only when the doubled family is warm, and both
warm records are process-wide (the JAX package's jit-wrapper cache
``_PACKED_KERNELS``, the port's ``_WARM_FAMILIES``): another test file on
the same worker may have warmed either. Each test therefore sets the
doubled family cold in both itself (``cold_doubled_family``). The JAX
solver runs without its mesh: the conftest's 8 virtual devices give
``TPUSolver`` one, which turns its speculation off, while the port on the
CPU has one device.

Tolerance: exact — span trees, the device plane's counters, the compile
ledger, the decision records, claims and host dicts.
"""

from __future__ import annotations

import importlib
import json
import logging

import numpy as np
import pytest

from karpenter_tpu.models import solver as jsolver_mod
from karpenter_tpu.models.solver import TPUSolver
from karpenter_tpu_torch.models import TorchSolver
from karpenter_tpu_torch.models import solver as psolver_mod
from karpenter_tpu_torch.ops.cuda_kernels import KernelError
from karpenter_tpu_torch.ops.tensorize import kernel_args, tensorize
from tests.test_torch_obs_parity import both, capture
from tests.test_torch_operator import JAX, PORT
from tests.test_torch_solver import _claims, _one_per_node

N = 600
BP, BP2 = 512, 1024  # the estimated bin axis and its doubling


def cold_doubled_family():
    """Forget the doubled family (``BP2``) in both warm records."""
    for key in [k for k in jsolver_mod._PACKED_KERNELS
                if k[0] == BP2 and isinstance(k[1], bool)]:
        del jsolver_mod._PACKED_KERNELS[key]
    psolver_mod._WARM_FAMILIES.difference_update(
        {k for k in psolver_mod._WARM_FAMILIES if k[0] == BP2})


def make_solver(pkg):
    """The package's solver on one device."""
    if pkg == PORT:
        return TorchSolver(device="cpu")
    solver = TPUSolver()
    solver._mesh_checked, solver._mesh = True, None
    return solver


def growth_rounds(pkg, rounds=2):
    """``rounds`` solves of fresh ``_one_per_node(N)`` batches on one
    solver, each in its own traced round; returns each solve's claims and
    ``bin_growths``."""
    obs = importlib.import_module(f"{pkg}.obs")
    solver = make_solver(pkg)
    out = []
    for _ in range(rounds):
        with obs.round_trace("provision"):
            res = solver.solve(*_one_per_node(pkg, N))
        out.append((_claims(res), solver.last_device_stats["bin_growths"]))
    return out


def _spans(tree, name) -> int:
    return (tree[0] == name) + sum(_spans(c, name) for c in tree[1])


def cold_growth_rounds(pkg):
    """``growth_rounds`` after setting the doubled family cold."""
    cold_doubled_family()
    return growth_rounds(pkg)


def test_cold_then_warm_growth_matches_jax(tmp_path):
    """The cold solve defers in both packages; the warm one speculates
    once in each, with every plane equal (span trees, device-plane
    counters, compile ledger, decisions, timeline) and equal claims; the
    warm solve's second ``solve.kernel`` holds the readback alone."""
    got, got_res, want_res = both(cold_growth_rounds, tmp_path)
    assert got_res == want_res
    assert [g for _, g in got_res] == [1, 1]
    assert [len(c) for c, _ in got_res] == [N, N]
    assert [_spans(t, "solve.dispatch_spec") for t in got["trees"]] == [0, 1]
    assert got["stats"]["bin_growths"] == 2
    kernels = [c for c in _walk(got["trees"][1]) if c[0] == "solve.kernel"]
    assert [k[1] for k in kernels][-1] == ()


def _exact_fit(pkg: str, big: int = 480, small: int = 340):
    """``big`` pods of 5.2 cpu (one per node) and ``small`` of 0.1 cpu in
    the gaps, on ``_one_per_node``'s type: the demand bound is 320 nodes
    (2,530 cpu over 7.92 allocatable), so the axis is 480, every bin is
    used and no pod is left over; its doubling is the ``BP2`` family."""
    objects = importlib.import_module(f"{pkg}.api.objects")
    pods, templates, its = _one_per_node(pkg, 0)
    pods = [objects.Pod(metadata=objects.ObjectMeta(name=f"b{i}"),
                        requests={"cpu": 5.2, "memory": 2**30})
            for i in range(big)]
    pods += [objects.Pod(metadata=objects.ObjectMeta(name=f"s{i}"),
                         requests={"cpu": 0.1, "memory": 2**20})
             for i in range(small)]
    return pods, templates, its


def growth_then_fit_rounds(pkg):
    """A growth solve (it warms ``BP2``), then an exact fit on the same
    solver, each in its own traced round; returns each solve's claims and
    ``bin_growths``."""
    obs = importlib.import_module(f"{pkg}.obs")
    solver = make_solver(pkg)
    out = []
    for batch in (_one_per_node(pkg, N), _exact_fit(pkg)):
        with obs.round_trace("provision"):
            res = solver.solve(*batch)
        out.append((_claims(res),
                    solver.last_device_stats.get("bin_growths", 0)))
    return out


def test_unneeded_speculation_matches_jax(tmp_path):
    """An exact fit runs its axis dry with no pod left over: with the
    doubled family warm both packages speculate, throw the result away
    and grow nothing, with every plane equal and equal claims."""
    got, got_res, want_res = both(growth_then_fit_rounds, tmp_path)
    assert got_res == want_res
    assert [g for _, g in got_res] == [1, 0]
    assert len(got_res[1][0]) == 480
    assert [_spans(t, "solve.dispatch_spec") for t in got["trees"]] == [0, 1]
    assert got["stats"]["bin_growths"] == 1


def _walk(tree):
    yield tree
    for c in tree[1]:
        yield from _walk(c)


def _doubled_args():
    """The port's numpy kernel arguments of the ``_one_per_node`` batch,
    and its dispatch key at the doubled axis."""
    solver = TorchSolver(device="cpu")
    pods, templates, its = _one_per_node(PORT, N)
    snap = tensorize(pods, templates, its)
    p = solver.plan(snap)
    assert p["Bp"] == BP
    args_np = kernel_args(snap, Gp=p["Gp"], Tp=p["Tp"], Ep=p["Ep"])
    return solver, args_np, (BP2, p["level_bits"], p["max_minv"])


def test_speculated_dict_equals_ordinary_dispatch():
    solver, args_np, key = _doubled_args()
    upload: dict = {}
    solver._dispatch(args_np, (BP,) + key[1:], BP, upload)
    assert solver._route == ("device", "ok")
    psolver_mod._WARM_FAMILIES.add(key)
    pull = solver._invoke_spec(args_np, key, BP2, upload)
    spec = pull()
    plain = solver._dispatch(args_np, key, BP2, {})
    assert set(spec) == set(plain)
    for name in plain:
        assert spec[name].dtype == plain[name].dtype, name
        assert np.array_equal(spec[name], plain[name]), name


@pytest.mark.parametrize("gate", ["cold-family", "native-route"])
def test_deferral_gates(gate, monkeypatch):
    """A cold doubled family, or a last dispatch off the device rung,
    defers: nothing is launched until the pull, which is the ordinary
    dispatch."""
    solver, args_np, key = _doubled_args()
    upload: dict = {}
    solver._dispatch(args_np, (BP,) + key[1:], BP, upload)
    cold_doubled_family()
    if gate == "native-route":
        psolver_mod._WARM_FAMILIES.add(key)
        solver._route = ("native", "small-batch")
    calls = []
    real = psolver_mod.packed_solve
    monkeypatch.setattr(psolver_mod, "packed_solve",
                        lambda *a, **kw: calls.append(a) or real(*a, **kw))
    pull = solver._invoke_spec(args_np, key, BP2, upload)
    assert calls == []
    host = pull()
    assert len(calls) == 1 and host["used"].shape == (BP2,)


def test_failed_speculation_defers(monkeypatch, caplog):
    """A speculative launch that raises a device fault defers to the
    ordinary dispatch, which lands on the JAX package's claims."""
    want = make_solver(JAX).solve(*_one_per_node(JAX, N))
    solver = make_solver(PORT)
    solver.solve(*_one_per_node(PORT, N))  # warms both families
    real = psolver_mod.packed_solve
    raised = []

    def flaky(args, max_bins, *a, **kw):
        if max_bins == BP2 and not raised:
            raised.append(max_bins)
            raise KernelError("injected launch fault")
        return real(args, max_bins, *a, **kw)

    monkeypatch.setattr(psolver_mod, "packed_solve", flaky)
    with caplog.at_level(logging.WARNING, logger=psolver_mod.__name__):
        res = solver.solve(*_one_per_node(PORT, N))
    assert raised == [BP2]
    assert "speculative doubled dispatch failed" in caplog.text
    assert solver.last_device_stats["bin_growths"] == 1
    assert solver._route == ("device", "ok")
    assert _claims(res) == _claims(want)


def _traces(directory) -> list:
    return sorted(directory.glob("*.pt.trace.json"))


def test_profile_dir_writes_one_trace_per_dispatch(tmp_path, monkeypatch):
    """Under ``KARPENTER_PROFILE_DIR`` the port writes one Chrome trace per
    dispatch (``1 + bin_growths``), the JAX package at least one profiler
    session, neither speculates though an unprofiled solve on the same
    solver has just warmed the doubled family, and the claims equal that
    unprofiled solve's."""
    out = {}
    for pkg in (JAX, PORT):
        directory = tmp_path / pkg
        monkeypatch.setenv("KARPENTER_PROFILE_DIR", str(directory))

        def run(p):
            obs = importlib.import_module(f"{p}.obs")
            solver = make_solver(p)
            with monkeypatch.context() as m:
                m.delenv("KARPENTER_PROFILE_DIR")
                want = _claims(solver.solve(*_one_per_node(p, N)))
            with obs.round_trace("provision"):
                res = solver.solve(*_one_per_node(p, N))
            return (want, _claims(res),
                    solver.last_device_stats["bin_growths"])

        planes, out[pkg] = capture(pkg, run, tmp_path / f"{pkg}-dumps")
        monkeypatch.delenv("KARPENTER_PROFILE_DIR")
        assert sum(_spans(t, "solve.dispatch_spec")
                   for t in planes["trees"]) == 0
        assert out[pkg][1] == out[pkg][0]
    assert out[PORT] == out[JAX]
    growths = out[PORT][2]
    assert growths == 1
    traces = _traces(tmp_path / PORT)
    assert len(traces) == 1 + growths
    for path in traces:
        doc = json.loads(path.read_text())
        assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]
    sessions = list((tmp_path / JAX).glob("plugins/profile/*"))
    assert len(sessions) >= 1


def test_native_dispatch_writes_no_trace(tmp_path, monkeypatch):
    """A batch the gates send to the native engine leaves the directory
    empty: only dispatches that leave the native rung are profiled."""
    monkeypatch.delenv("KARPENTER_NATIVE_CUTOFF", raising=False)
    monkeypatch.setenv("KARPENTER_PROFILE_DIR", str(tmp_path / "prof"))
    solver = TorchSolver(device="cpu")
    res = solver.solve(*_one_per_node(PORT, 40))
    assert solver.last_device_stats["engine"] == "native"
    assert len(res.new_claims) == 40
    assert not (tmp_path / "prof").exists() or not any(
        (tmp_path / "prof").iterdir())
