"""The port's solver service (``karpenter_tpu_torch/service``) against the
JAX package's.

The cases of ``tests/test_solver_service.py`` and
``tests/test_multitenant_service.py`` on the port's server
(``serve(device="cpu")``: the plain PyTorch path of this CPU, with the
conftest's ``KARPENTER_NATIVE_CUTOFF=0`` keeping the device path under
test) and client (``RemoteSolver``, whose own device is the CPU): wire
solves equal to the in-process ``TorchSolver``, the full controller ring
over the wire, the fallback and its reason labels, the cross-boundary
trace and SLO surfaces, the streaming delta protocol and its resync
edges, the coalescer, admission budgets, the bleed hook, session sweeps,
compression and per-tenant SLOs. The slow acceptance row of
``test_multitenant_service.py`` runs here at a small size through the
port's ``workload.run_multitenant`` (a server process of its own); its
full-size counterpart is ``chip_smoke.py``'s service phase on the card.

Across the packages:

- the batched solve (``models/solver.py`` ``batched_invoke``): the port's
  rows bit-equal to the JAX package's ``jit(vmap(...))`` on the same
  stacked snapshots, for seeded families of ``tests/test_torch_kernels.py``
  and at the multiply-add tie shape (400 pods of 200 cpu sizes over
  ``benchmark_catalog(64)``, row 126 against bin 1, N = 3 padded to 4);
- over loopback gRPC, a JAX ``RemoteSolver`` against the port's server and
  a port ``RemoteSolver`` against the JAX package's server, each equal to
  the in-process solve, statelessly and in session mode;
- the journal's wire form, the session registry and the codec helpers
  give the JAX package's answers.

The wire tests ``pytest.importorskip("grpc")`` where the JAX files do.
Tolerance: exact.
"""

from __future__ import annotations

import random
import threading
import time

import numpy as np
import pytest

from karpenter_tpu_torch.api.nodepool import NodePool
from karpenter_tpu_torch.api.objects import ObjectMeta, Pod
from karpenter_tpu_torch.cloudprovider.catalog import (
    benchmark_catalog,
    make_instance_type,
)
from karpenter_tpu_torch.models import ClaimTemplate, TorchSolver
from karpenter_tpu_torch.operator import metrics as m
from karpenter_tpu_torch.operator.metrics import Registry
from karpenter_tpu_torch.service import session as sess_mod
from karpenter_tpu_torch.service import solver_service as svc
from tests.test_torch_operator import JAX, PORT, mod

GIB = 2**30


def pods(n, off=0, cpu_step=4, pkg=PORT):
    ob = mod(pkg, "api.objects")
    return [ob.Pod(metadata=ob.ObjectMeta(name=f"p{off + i}"),
                   requests={"cpu": 0.5 + (i % cpu_step) * 0.5,
                             "memory": 1 * GIB})
            for i in range(n)]


def seeded_pods(rng, n, off=0):
    """Spec-varied pods from a seeded rng (the parity/isolation suites)."""
    out = []
    for i in range(n):
        req = {"cpu": float(rng.choice([0.25, 0.5, 1.0, 2.0])),
               "memory": float(rng.choice([1, 2, 4])) * GIB}
        out.append(Pod(metadata=ObjectMeta(name=f"s{off + i}"),
                       requests=req))
    return out


def local():
    return TorchSolver(device="cpu")


def sizes_of(res) -> list:
    return sorted(len(c.pods) for c in res.new_claims)


def solve_once(solver, n_pods=20, n_types=20, off=0):
    pool = NodePool(metadata=ObjectMeta(name="default"))
    its = {pool.name: benchmark_catalog(n_types)}
    return solver.solve([p.clone() for p in pods(n_pods, off=off)],
                        [ClaimTemplate(pool)], its)


@pytest.fixture
def server():
    pytest.importorskip("grpc")
    reg = Registry()
    srv, port = svc.serve(port=0, registry=reg, device="cpu")
    yield srv, f"127.0.0.1:{port}", reg
    srv.stop(grace=None)


def RemoteSolver(*a, **kw):
    return svc.RemoteSolver(*a, **kw)


# ---------------------------------------------------------------------------
# tests/test_solver_service.py
# ---------------------------------------------------------------------------


class TestRemoteSolver:
    def test_wire_solve_matches_in_process(self, server):
        _, target, _ = server
        pool = NodePool(metadata=ObjectMeta(name="default"))
        its = {pool.name: benchmark_catalog(40)}
        want = local().solve(
            [p.clone() for p in pods(60)], [ClaimTemplate(pool)], its)
        remote_solver = RemoteSolver(target)
        got = remote_solver.solve(
            [p.clone() for p in pods(60)], [ClaimTemplate(pool)], its)
        assert remote_solver.last_device_stats["engine"] == "remote"
        assert got.node_count() == want.node_count()
        assert got.scheduled_pod_count() == want.scheduled_pod_count() == 60
        assert sizes_of(got) == sizes_of(want)

    def test_end_to_end_ring_over_the_wire(self, server):
        from karpenter_tpu_torch.operator import Environment

        _, target, _ = server
        env = Environment(
            instance_types=[make_instance_type("small", 4, 16)],
            solver=RemoteSolver(target))
        env.create("nodepools", NodePool(metadata=ObjectMeta(name="default")))
        env.provision(*pods(5))
        assert all(p.node_name for p in env.store.list("pods"))
        assert env.provisioner.solver.last_device_stats["engine"] == "remote"

    def test_minvalues_ride_the_wire(self, server):
        from karpenter_tpu_torch.api import labels as wk
        from karpenter_tpu_torch.api.objects import NodeSelectorRequirement

        _, target, _ = server
        pool = NodePool(metadata=ObjectMeta(name="default"))
        pool.spec.template.requirements = [NodeSelectorRequirement(
            wk.INSTANCE_TYPE_LABEL, "Exists", [], min_values=10)]
        its = {pool.name: benchmark_catalog(40)}
        s = RemoteSolver(target)
        res = s.solve([p.clone() for p in pods(30)], [ClaimTemplate(pool)],
                      its)
        assert res.scheduled_pod_count() == 30
        assert s.last_device_stats["retry_pods"] == 0
        for claim in res.new_claims:
            assert len({it.name for it in claim.instance_types}) >= 10

    def test_client_needs_no_card(self, server, monkeypatch):
        """The client constructs and solves on a machine without CUDA;
        it ships numpy and never uploads."""
        import torch

        from karpenter_tpu_torch.ops import kernels

        _, target, _ = server
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        uploads = []
        real = kernels.from_kernel_args
        monkeypatch.setattr(kernels, "from_kernel_args",
                            lambda *a, **kw: uploads.append(1) or real(*a, **kw))
        s = RemoteSolver(target)
        assert s.device.type == "cpu"
        res = solve_once(s, n_pods=20)
        assert res.scheduled_pod_count() == 20
        assert s.last_device_stats["engine"] == "remote"
        # the one upload of the solve happened in the server's solver,
        # on the server's thread — none for the client's dispatch
        assert len(uploads) <= 1


class TestRemoteFallback:
    def test_unreachable_service_falls_back_in_process(self):
        pytest.importorskip("grpc")
        pool = NodePool(metadata=ObjectMeta(name="default"))
        its = {pool.name: benchmark_catalog(20)}
        s = RemoteSolver("127.0.0.1:1")  # nothing listens there
        res = s.solve([p.clone() for p in pods(10)], [ClaimTemplate(pool)],
                      its)
        assert res.scheduled_pod_count() == 10
        assert s.last_device_stats["engine"] != "remote"
        assert s._route[1] == "remote-fallback"

    def test_unreachable_service_counts_retryable_transport_reason(
            self, monkeypatch):
        pytest.importorskip("grpc")
        monkeypatch.setenv("KARPENTER_SOLVER_RETRY_MS", "1")
        pool = NodePool(metadata=ObjectMeta(name="default"))
        its = {pool.name: benchmark_catalog(20)}
        reg = Registry()
        s = RemoteSolver("127.0.0.1:1", registry=reg)
        s.solve([p.clone() for p in pods(10)], [ClaimTemplate(pool)], its)
        assert reg.counter(m.SOLVER_REMOTE_FALLBACKS).value(
            code="StatusCode.UNAVAILABLE", reason="transport-retryable") >= 1
        assert reg.counter(m.SOLVER_REMOTE_RETRIES).value(
            code="StatusCode.UNAVAILABLE") >= 1
        assert s.session_stats["retries"] >= 1

    def test_retry_disabled_keeps_hard_transport_reason(self, monkeypatch):
        pytest.importorskip("grpc")
        monkeypatch.setenv("KARPENTER_SOLVER_RETRY", "0")
        pool = NodePool(metadata=ObjectMeta(name="default"))
        its = {pool.name: benchmark_catalog(20)}
        reg = Registry()
        s = RemoteSolver("127.0.0.1:1", registry=reg)
        s.solve([p.clone() for p in pods(10)], [ClaimTemplate(pool)], its)
        assert reg.counter(m.SOLVER_REMOTE_FALLBACKS).value(
            code="StatusCode.UNAVAILABLE", reason="transport-retryable") >= 1
        assert s.session_stats["retries"] == 0


class TestSloTracing:
    @pytest.fixture
    def rec(self, tmp_path):
        from karpenter_tpu_torch import obs

        obs.configure(enabled=True, dump_dir=str(tmp_path), capacity=8,
                      dump_all=False)
        obs.RECORDER.clear()
        obs.devplane.reset()
        yield tmp_path
        obs.devplane.reset()
        obs.reset()

    def test_loopback_round_trip_links_traces_and_ticks_slo(self, rec):
        pytest.importorskip("grpc")
        from karpenter_tpu_torch import obs

        reg = Registry()
        srv, port = svc.serve(port=0, registry=reg, device="cpu")
        try:
            pool = NodePool(metadata=ObjectMeta(name="default"))
            its = {pool.name: benchmark_catalog(20)}
            s = RemoteSolver(f"127.0.0.1:{port}", registry=reg)
            with obs.round_trace("provision", registry=reg) as tr:
                res = s.solve([p.clone() for p in pods(20)],
                              [ClaimTemplate(pool)], its)
            assert res.scheduled_pod_count() == 20
            assert s.last_device_stats["engine"] == "remote"
            server_tr = obs.RECORDER.last("solver-service")
            assert server_tr is not None
            assert server_tr.root.attrs["client_trace"] == tr.trace_id
            assert reg.histogram(m.SOLVER_REQUEST_SECONDS).count(
                outcome="ok") >= 1
            assert reg.gauge(m.SOLVER_REQUEST_QUANTILE).value(
                slo="solver_service", q="p50") > 0
            assert reg.counter(m.SLO_BUDGET_BURN).value(
                slo="solver_service") == 0
            # the solve's route verdict is the service rung
            from karpenter_tpu_torch.obs import decisions

            last = decisions.DECISIONS.site_summary()["solver.route"]["last"]
            assert (last["rung"], last["reason"]) == ("service", "ok")
        finally:
            srv.stop(grace=None)

    def test_forced_server_error_falls_back_with_reason_label(self, rec):
        pytest.importorskip("grpc")
        from karpenter_tpu_torch.operator.logging import Logger

        reg = Registry()
        srv, port = svc.serve(port=0, registry=reg, device="cpu")
        try:
            def boom(args, key, max_bins, upload=None):
                raise RuntimeError("seeded server failure")

            srv.solver_handler._solver._dispatch = boom
            pool = NodePool(metadata=ObjectMeta(name="default"))
            its = {pool.name: benchmark_catalog(20)}
            lines = []
            s = RemoteSolver(f"127.0.0.1:{port}", registry=reg,
                             log=Logger(sink=lines.append))
            res = s.solve([p.clone() for p in pods(10)],
                          [ClaimTemplate(pool)], its)
            assert res.scheduled_pod_count() == 10
            assert s.last_device_stats["engine"] != "remote"
            assert reg.counter(m.SOLVER_REMOTE_FALLBACKS).value(
                code="StatusCode.INTERNAL", reason="RuntimeError") == 1
            assert any("reason=RuntimeError" in ln for ln in lines)
            assert reg.histogram(m.SOLVER_REQUEST_SECONDS).count(
                outcome="error") == 1
            assert reg.counter(m.SLO_BUDGET_BURN).value(
                slo="solver_service") == 1
        finally:
            srv.stop(grace=None)


class _Context:
    """A gRPC servicer context stand-in: ``abort`` raises."""

    def abort(self, code, details):
        raise RuntimeError(f"{code}: {details}")


def test_rpc_bodies_run_in_process_without_grpc(monkeypatch):
    """The handler's RPC bodies serve bytes in and bytes out with grpc
    unimportable (they import it only on their abort paths): Register,
    a session full upload, a delta, and a stateless Solve."""
    import builtins

    real_import = builtins.__import__

    def no_grpc(name, *a, **kw):
        if name == "grpc" or name.startswith("grpc."):
            raise ImportError("grpc is not installed")
        return real_import(name, *a, **kw)

    h = svc._SolverHandler(device="cpu", registry=Registry())
    try:
        s = local()
        seen = []
        s._dispatch = lambda args, key, max_bins, upload=None: (
            seen.append((args, key, max_bins))
            or TorchSolver._dispatch(s, args, key, max_bins, upload))
        solve_once(s, n_pods=20)
        args, key, max_bins = seen[-1]
        monkeypatch.setattr(builtins, "__import__", no_grpc)
        meta = {"max_bins": max_bins, "level_bits": key[-2],
                "max_minv": key[-1]}
        out, _ = svc._unpack(h.solve(svc._pack(args, meta), _Context()))
        _, reg_meta = svc._unpack(h.register(
            svc._pack({}, {"tenant": "acme"}), _Context()))
        full = dict(meta, session=reg_meta["session"], seq=1, mode="full")
        out2, m2 = svc._unpack(h.session_solve(svc._pack(args, full),
                                               _Context()))
        delta = dict(meta, session=reg_meta["session"], seq=2,
                     mode="delta", base_seq=1, patch={}, journal=[])
        out3, m3 = svc._unpack(h.session_solve(svc._pack({}, delta),
                                               _Context()))
    finally:
        monkeypatch.setattr(builtins, "__import__", real_import)
        h.close()
    want = TorchSolver(device="cpu")._dispatch(args, key, max_bins)
    for got in (out, out2, out3):
        for k in ("assign", "assign_e", "used", "tmpl", "F"):
            assert np.array_equal(np.asarray(want[k]), got[k]), k
    assert (m2["full_uploads"], m3["delta_rounds"]) == (1, 1)


# ---------------------------------------------------------------------------
# tests/test_multitenant_service.py
# ---------------------------------------------------------------------------


class TestSessionDeltaProtocol:
    def test_full_then_deltas_with_parity(self, server):
        from karpenter_tpu_torch.obs import decisions

        decisions.reset()
        _, target, reg = server
        s = RemoteSolver(target, registry=reg, tenant="acme")
        ref_solver = local()
        for n in (40, 50, 50):
            got = solve_once(s, n_pods=n)
            want = solve_once(ref_solver, n_pods=n)
            assert s.last_device_stats["engine"] == "remote"
            assert got.scheduled_pod_count() == want.scheduled_pod_count() == n
            assert got.node_count() == want.node_count()
            assert sizes_of(got) == sizes_of(want)
        assert s.session_stats["full_uploads"] == 1
        assert s.session_stats["delta_rounds"] >= 2
        assert s.session_stats["resyncs"] == 0
        assert s.session_stats["bytes_delta"] < s.session_stats["bytes_full"]
        assert reg.counter(m.SOLVER_SESSION_CACHE_HITS).value(
            tenant="acme", kind="delta") >= 2
        assert reg.counter(m.SOLVER_SESSION_CACHE_STORES).value(
            tenant="acme") == 1
        # both ends record the session.sync verdicts (one process here)
        mix = decisions.DECISIONS.tenant_mix()["acme"]["session.sync"]
        assert mix == {"resync": 2, "delta": 4}

    @staticmethod
    def _clustered_solver(target, reg, tenant):
        """A session solver with a journal-bearing cluster bound — the
        wiring Environment.__init__ performs."""
        from karpenter_tpu_torch.kube import KubeStore
        from karpenter_tpu_torch.state.cluster import Cluster
        from karpenter_tpu_torch.utils.clock import FakeClock

        s = RemoteSolver(target, registry=reg, tenant=tenant)
        cluster = Cluster(KubeStore(FakeClock()))
        s.bind_cluster(cluster)
        return s, cluster

    def test_environment_binds_the_cluster(self, server):
        from karpenter_tpu_torch.operator import Environment

        _, target, reg = server
        s = RemoteSolver(target, registry=reg, tenant="bound")
        env = Environment(instance_types=[make_instance_type("small", 4, 16)],
                          solver=s)
        assert s._cluster is env.cluster

    def test_journal_gap_forces_full_resync(self, server):
        from karpenter_tpu_torch.state.cluster import DELTA_JOURNAL_CAP

        _, target, reg = server
        s, cluster = self._clustered_solver(target, reg, "gap")
        solve_once(s, n_pods=20)
        cluster.mark_unconsolidated(("node", "a"))
        solve_once(s, n_pods=20)
        assert s.session_stats["full_uploads"] == 1
        assert s.session_stats["resyncs"] == 0
        assert s.session_stats["delta_rounds"] >= 1
        for _ in range(DELTA_JOURNAL_CAP + 8):
            cluster.mark_unconsolidated(("node", "bogus"))
        res = solve_once(s, n_pods=20)
        assert res.scheduled_pod_count() == 20
        assert s.last_device_stats["engine"] == "remote"
        assert reg.counter(m.SOLVER_SESSION_RESYNCS).value(
            reason="journal-gap") >= 1
        assert s.session_stats["full_uploads"] == 2

    def test_opaque_delta_forces_full_resync(self, server):
        _, target, reg = server
        s, cluster = self._clustered_solver(target, reg, "opaque")
        solve_once(s, n_pods=20)
        cluster.mark_unconsolidated()
        res = solve_once(s, n_pods=20)
        assert res.scheduled_pod_count() == 20
        assert s.last_device_stats["engine"] == "remote"
        assert reg.counter(m.SOLVER_SESSION_RESYNCS).value(
            reason="opaque-delta") >= 1
        assert s.session_stats["full_uploads"] == 2
        solve_once(s, n_pods=20)
        assert s.session_stats["full_uploads"] == 2
        assert s.session_stats["delta_rounds"] >= 1

    def test_interleaved_shape_families_ride_separate_sessions(self, server):
        _, target, reg = server
        s = RemoteSolver(target, registry=reg, tenant="fam")
        for r in range(2):
            solve_once(s, n_pods=20, n_types=20, off=10 * r)
            solve_once(s, n_pods=24, n_types=70, off=10 * r)
        assert len(s._families) == 2
        assert s.session_stats["full_uploads"] == 2
        assert s.session_stats["resyncs"] == 0
        assert s.session_stats["delta_rounds"] == 2
        assert s.last_device_stats["engine"] == "remote"

    def test_family_lru_eviction_queues_server_release(self):
        s = svc.RemoteSolver.__new__(svc.RemoteSolver)
        s._families = svc.OrderedDict()
        s._released = []
        a = {"a": np.zeros((4, 2), dtype=np.float32)}
        st1 = s._family_state(a)
        st1.session_id = "s-one"
        assert s._family_state(a) is st1
        st2 = s._family_state({"a": np.zeros((8, 2), dtype=np.float32)})
        assert st2 is not st1
        for i in range(svc._FAMILY_CAP):
            s._family_state(
                {"a": np.zeros((16 + i, 2), dtype=np.float32)})
        assert len(s._families) == svc._FAMILY_CAP
        assert "s-one" in s._released

    def test_out_of_order_delta_rejected(self, server):
        grpc = pytest.importorskip("grpc")
        _, target, reg = server
        s = RemoteSolver(target, registry=reg, tenant="ooo")
        solve_once(s, n_pods=20)
        assert s._session_id is not None
        meta = {"max_bins": 8, "level_bits": 20, "max_minv": 0,
                "session": s._session_id, "seq": s._session_seq,
                "mode": "delta", "base_seq": s._session_seq,
                "patch": {}, "journal": []}
        with pytest.raises(grpc.RpcError) as ei:
            s._call_session(svc._pack({}, meta))
        assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        assert ei.value.details().startswith("OutOfOrderDelta")

    def test_session_expiry_reregisters_with_full_upload(self, server):
        srv, target, reg = server
        s = RemoteSolver(target, registry=reg, tenant="ttl")
        solve_once(s, n_pods=20)
        first_session = s._session_id
        h = srv.solver_handler
        h.sessions.ttl_s = 1.0
        with h.sessions._lock:
            for sess in h.sessions._sessions.values():
                sess.last_used -= 10_000.0
        solve_once(s, n_pods=20, off=50)
        assert s.last_device_stats["engine"] == "remote"
        assert s._session_id != first_session
        assert reg.counter(m.SOLVER_SESSION_RESYNCS).value(
            reason="SessionExpired") >= 1
        assert s.session_stats["full_uploads"] == 2

    def test_out_of_order_recovery_releases_orphaned_session(self, server):
        srv, target, reg = server
        h = srv.solver_handler
        s = RemoteSolver(target, registry=reg, tenant="orphan")
        solve_once(s, n_pods=20)
        first_session = s._session_id
        with h.sessions._lock:
            live_bytes = h.sessions._total_bytes
            h.sessions._sessions[first_session].last_seq += 5
        res = solve_once(s, n_pods=20, off=50)
        assert res.scheduled_pod_count() == 20
        assert s.last_device_stats["engine"] == "remote"
        assert s._session_id != first_session
        assert all(st.stale is None for st in s._families.values())
        assert s._released == []
        with h.sessions._lock:
            assert first_session not in h.sessions._sessions
            assert h.sessions._total_bytes <= live_bytes
        assert reg.counter(m.SOLVER_SESSION_RESYNCS).value(
            reason="OutOfOrderDelta") >= 1

    def test_lru_eviction_forces_victims_resync(self, server):
        srv, target, reg = server
        h = srv.solver_handler
        a = RemoteSolver(target, registry=reg, tenant="alpha")
        b = RemoteSolver(target, registry=reg, tenant="beta")
        solve_once(a, n_pods=20)
        h.sessions.byte_budget = 1
        solve_once(b, n_pods=20)
        assert reg.counter(m.SOLVER_SESSION_CACHE_EVICTIONS).value(
            tenant="alpha") >= 1
        solve_once(a, n_pods=24)
        assert a.last_device_stats["engine"] == "remote"
        assert reg.counter(m.SOLVER_SESSION_RESYNCS).value(
            reason="ResyncRequired") >= 1
        assert a.session_stats["full_uploads"] == 2

    def test_seeded_parity_delta_vs_full_vs_inprocess(self, server):
        _, target, reg = server
        pool = NodePool(metadata=ObjectMeta(name="default"))
        its = {pool.name: benchmark_catalog(24)}
        for seed in (7, 23):
            rng = random.Random(seed)
            delta_solver = RemoteSolver(target, registry=reg,
                                        tenant=f"par-{seed}")
            rounds = [seeded_pods(rng, 12 + 6 * r, off=100 * r)
                      for r in range(3)]
            for batch in rounds:
                d = delta_solver.solve([p.clone() for p in batch],
                                       [ClaimTemplate(pool)], its)
                full_solver = RemoteSolver(target, registry=reg,
                                           tenant=f"parf-{seed}")
                f = full_solver.solve([p.clone() for p in batch],
                                      [ClaimTemplate(pool)], its)
                ref = local().solve([p.clone() for p in batch],
                                    [ClaimTemplate(pool)], its)
                assert delta_solver.last_device_stats["engine"] == "remote"
                assert full_solver.session_stats["delta_rounds"] == 0
                for res in (d, f):
                    assert res.scheduled_pod_count() == \
                        ref.scheduled_pod_count()
                    assert res.node_count() == ref.node_count()
                    assert sizes_of(res) == sizes_of(ref)
            assert delta_solver.session_stats["full_uploads"] == 1
            assert delta_solver.session_stats["delta_rounds"] >= 2


class TestJournalWire:
    def test_delta_wire_roundtrip(self):
        from karpenter_tpu_torch.state.cluster import (
            delta_from_wire,
            delta_to_wire,
        )

        p = Pod(metadata=ObjectMeta(name="w"))
        assert delta_to_wire(None) is None
        assert delta_from_wire(None) is None
        assert delta_from_wire(delta_to_wire(("node", "pid-1"))) == (
            "node", "pid-1")
        k, uid, node, gone = delta_from_wire(
            delta_to_wire(("pod", p, "n1", True)))
        assert (k, uid, node, gone) == ("pod", p.uid, "n1", True)

    @pytest.mark.parametrize("pkg", [JAX, PORT])
    def test_export_deltas_window_and_gap(self, pkg):
        Cluster = mod(pkg, "state.cluster").Cluster
        KubeStore = mod(pkg, "kube").KubeStore
        FakeClock = mod(pkg, "utils.clock").FakeClock
        cluster = Cluster(KubeStore(FakeClock()))
        g0 = cluster.consolidation_state()
        cluster.mark_unconsolidated(("node", "a"))
        cluster.mark_unconsolidated()  # opaque
        entries, gen = cluster.export_deltas(g0)
        assert gen == cluster.consolidation_state()
        assert entries == [{"k": "node", "pid": "a"}, None]
        entries, _ = cluster.export_deltas(-10_000)
        assert entries is None


class TestCoalescer:
    def test_window_folds_concurrent_submits(self):
        from karpenter_tpu_torch.service.coalesce import Coalescer

        reg = Registry()
        calls = []

        def one(item):
            calls.append(("one", item))
            return item * 10

        def many(items):
            calls.append(("many", list(items)))
            return [i * 10 for i in items]

        c = Coalescer(one, many, window_s=0.2, registry=reg)
        results = {}

        def run(i):
            results[i] = c.submit("bucket", i)

        ts = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert results == {0: 0, 1: 10, 2: 20}
        assert len(calls) == 1 and calls[0][0] == "many"
        assert reg.counter(m.SOLVER_COALESCED).value() == 3
        assert reg.histogram(m.SOLVER_COALESCE_BATCH).count() == 1

    def test_lone_submit_uses_single_path(self):
        from karpenter_tpu_torch.service.coalesce import Coalescer

        c = Coalescer(lambda i: ("one", i), lambda items: 1 / 0,
                      window_s=0.0)
        assert c.submit("k", 5) == ("one", 5)

    def test_error_propagates_to_every_member(self):
        from karpenter_tpu_torch.service.coalesce import Coalescer

        def many(items):
            raise RuntimeError("batch died")

        c = Coalescer(lambda i: i, many, window_s=0.2)
        errors = []

        def run(i):
            try:
                c.submit("k", i)
            except RuntimeError as e:
                errors.append(str(e))

        ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert errors == ["batch died", "batch died"]

    def test_max_batch_closes_bucket(self):
        from karpenter_tpu_torch.service.coalesce import Coalescer

        batches = []

        def many(items):
            batches.append(len(items))
            return list(items)

        c = Coalescer(lambda i: [i], many, window_s=0.15, max_batch=2)
        ts = [threading.Thread(target=c.submit, args=("k", i))
              for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert all(n <= 2 for n in batches)

    def test_batched_invoke_matches_per_item_dispatch(self):
        """The batched solve demuxes to exactly what per-item dispatch
        produces (the coalescer's correctness contract)."""
        from karpenter_tpu_torch.models.solver import batched_invoke

        pool = NodePool(metadata=ObjectMeta(name="default"))
        its = {pool.name: benchmark_catalog(8)}
        captured = []

        class Spy(TorchSolver):
            def _dispatch(self, args, key, max_bins, upload=None):
                captured.append((dict(args), key, max_bins))
                return super()._dispatch(args, key, max_bins, upload)

        marks = []
        for off in (0, 40):
            marks.append(len(captured))
            Spy(device="cpu").solve([p.clone() for p in pods(16, off=off)],
                                    [ClaimTemplate(pool)], its)
        a, b = captured[marks[0]], captured[marks[1]]
        assert a[1] == b[1]
        batch = batched_invoke([a[0], b[0]], a[2], level_bits=a[1][-2],
                               max_minv=a[1][-1], device="cpu")
        for (args, key, max_bins), out in zip((a, b), batch):
            ref = local()._dispatch(args, key, max_bins)
            for name in ("assign", "assign_e", "used", "tmpl", "F"):
                assert np.array_equal(np.asarray(ref[name]),
                                      np.asarray(out[name])), name

    def test_batched_invoke_records_the_device_plane(self):
        from karpenter_tpu_torch.models.solver import batched_invoke
        from karpenter_tpu_torch.obs import devplane
        from tests.test_torch_kernels import make_args

        devplane.reset()
        try:
            rows = [make_args("plain", seed=s) for s in range(3)]
            batched_invoke(rows, 16, level_bits=8, device="cpu")
            assert devplane.STATS["pad_cells_actual"] == 3
            assert devplane.STATS["pad_cells_padded"] == 4
            assert "service.batch" in devplane.LEDGER.snapshot()[
                "families"]
        finally:
            devplane.reset()

    def test_batched_invoke_without_a_device_raises_without_cuda(
            self, monkeypatch):
        import torch

        from karpenter_tpu_torch.models.solver import batched_invoke
        from tests.test_torch_kernels import make_args

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            batched_invoke([make_args("plain", seed=0)], 16)

    def test_coalesced_dispatch_end_to_end(self, monkeypatch):
        """Concurrent same-shape tenant solves through a real server fold
        into one batched dispatch and still answer exactly like the
        in-process solver. ASSUME_ACCELERATOR pins the batched branch (on
        the CPU the fold routes members individually)."""
        pytest.importorskip("grpc")
        monkeypatch.setenv("KARPENTER_COALESCE_WINDOW_MS", "250")
        monkeypatch.setenv("KARPENTER_ASSUME_ACCELERATOR", "1")
        reg = Registry()
        srv, port = svc.serve(port=0, registry=reg, device="cpu")
        try:
            target = f"127.0.0.1:{port}"
            assert srv.solver_handler._coalescer is not None
            pool = NodePool(metadata=ObjectMeta(name="default"))
            its = {pool.name: benchmark_catalog(12)}
            results = {}

            def run(name):
                s = RemoteSolver(target, registry=reg, tenant=name)
                res = s.solve([p.clone() for p in pods(30)],
                              [ClaimTemplate(pool)], its)
                results[name] = (res.node_count(),
                                 res.scheduled_pod_count(),
                                 s.last_device_stats["engine"])

            ts = [threading.Thread(target=run, args=(f"t{i}",))
                  for i in range(3)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            ref = local().solve([p.clone() for p in pods(30)],
                                [ClaimTemplate(pool)], its)
            for name, (nodes, scheduled, engine) in results.items():
                assert engine == "remote", name
                assert nodes == ref.node_count()
                assert scheduled == 30
            assert reg.counter(m.SOLVER_COALESCED).value() >= 2
        finally:
            srv.stop(grace=None)

    @pytest.mark.parametrize("n_device", [1, 2])
    def test_fold_keeps_each_members_engine(self, monkeypatch, n_device):
        """A coalesced window on an accelerator applies the engine gates
        first: a member the gates send to the native engine runs there
        (as it would in process), and only device-routed members are
        folded into the batched solve — a lone device member is not."""
        from karpenter_tpu_torch.models.solver import batched_invoke

        monkeypatch.setenv("KARPENTER_ASSUME_ACCELERATOR", "1")
        monkeypatch.setenv("KARPENTER_NATIVE_CUTOFF", "40")
        monkeypatch.setenv("KARPENTER_DEVICE_MIN_WORK", "0")
        monkeypatch.setenv("KARPENTER_COALESCE_WINDOW_MS", "50")
        pool = NodePool(metadata=ObjectMeta(name="default"))
        its = {pool.name: benchmark_catalog(8)}
        captured = []

        class Spy(TorchSolver):
            def _dispatch(self, args, key, max_bins, upload=None):
                captured.append((dict(args), key, max_bins))
                return super()._dispatch(args, key, max_bins, upload)

        Spy(device="cpu").solve([p.clone() for p in pods(64)],
                                [ClaimTemplate(pool)], its)
        big, key, max_bins = captured[0]
        small = dict(big, g_count=np.minimum(np.asarray(big["g_count"]), 1))
        routed = TorchSolver(device="cpu")
        assert routed.native_reason(big) is None
        assert routed.native_reason(small) == "small-batch"
        rows = [big] * n_device + [small]
        items = [{"args": a, "key": key, "max_bins": max_bins} for a in rows]
        handler = svc._SolverHandler(device="cpu", registry=Registry())
        try:
            outs = handler._dispatch_many(items)
        finally:
            handler.close()
        assert [it["engine"] for it in items] == (["device"] * n_device
                                                  + ["native"])
        assert [bool(it.get("batched")) for it in items] == (
            [n_device > 1] * n_device + [False])
        want = [routed._dispatch(a, key, max_bins) for a in rows]
        if n_device > 1:
            want[:n_device] = batched_invoke(
                rows[:n_device], max_bins, level_bits=key[-2],
                max_minv=key[-1], device="cpu")
        for got, ref in zip(outs, want):
            for name in ("assign", "assign_e", "used", "tmpl", "F"):
                assert np.array_equal(np.asarray(got[name]),
                                      np.asarray(ref[name])), name


class TestAdmissionControl:
    def test_tenant_budget_rejects_with_backpressure(self, server):
        srv, target, reg = server
        h = srv.solver_handler
        h.sessions.inflight_budget = 1
        entered = threading.Event()
        orig = h._solver._dispatch

        def slow(args, key, max_bins, upload=None):
            entered.set()
            time.sleep(0.8)
            return orig(args, key, max_bins, upload)

        h._solver._dispatch = slow
        outcomes = {}

        def run(i):
            s = RemoteSolver(target, registry=reg, tenant="busy")
            res = solve_once(s, n_pods=20, off=40 * i)
            outcomes[i] = (res.scheduled_pod_count(),
                           s.last_device_stats["engine"])

        t0 = threading.Thread(target=run, args=(0,))
        t0.start()
        assert entered.wait(5.0)
        t1 = threading.Thread(target=run, args=(1,))
        t1.start()
        t0.join()
        t1.join()
        assert all(v[0] == 20 for v in outcomes.values())
        assert reg.counter(m.SOLVER_ADMISSION_REJECTS).value(
            tenant="busy") >= 1
        assert reg.counter(m.SOLVER_REMOTE_FALLBACKS).value(
            code="StatusCode.RESOURCE_EXHAUSTED",
            reason="TenantBudgetExceeded") >= 1


class TestBleedHook:
    def test_corrupted_bundle_tag_aborts_and_counts(self):
        reg = Registry()
        sessions = sess_mod.SessionRegistry()
        sess = sessions.register("good", registry=reg)
        sessions.apply(sess, {"g_count": np.ones(4, dtype=np.int32)},
                       {"seq": 1, "mode": "full"}, registry=reg)
        sess.bundle_tenant = "evil"
        with pytest.raises(sess_mod.CrossTenantBleed):
            sessions.apply(sess, {}, {"seq": 2, "mode": "delta",
                                      "base_seq": 1, "patch": {}},
                           registry=reg)
        assert reg.counter(m.SOLVER_BLEED_CHECKS).value(
            outcome="bleed") == 1
        assert sessions.verify_isolation(registry=reg) == [sess.id]

    def test_clean_registry_verifies_isolated(self):
        reg = Registry()
        sessions = sess_mod.SessionRegistry()
        for tenant in ("a", "b"):
            sess = sessions.register(tenant)
            sessions.apply(sess, {"x": np.zeros(2)},
                           {"seq": 1, "mode": "full"})
        assert sessions.verify_isolation(registry=reg) == []
        assert reg.counter(m.SOLVER_BLEED_CHECKS).value(outcome="ok") == 2


class TestSessionSweep:
    def test_sweep_reclaims_idle_expired_bytes(self):
        reg = Registry()
        clock = [0.0]
        sessions = sess_mod.SessionRegistry(ttl_s=10.0,
                                            now=lambda: clock[0])
        sess = sessions.register("idle", registry=reg)
        sessions.apply(sess, {"a": np.zeros((8, 4), dtype=np.float32)},
                       {"seq": 1, "mode": "full"}, registry=reg)
        assert sessions.stats()["bytes"] > 0
        clock[0] = 11.0
        assert sessions.sweep(registry=reg) == 1
        st = sessions.stats()
        assert st["sessions"] == 0 and st["bytes"] == 0
        assert reg.counter(m.SOLVER_SESSION_SWEEPS).value() == 1
        assert reg.gauge(m.SOLVER_SESSIONS).value() == 0
        assert reg.gauge(m.SOLVER_SESSION_CACHE_BYTES).value() == 0

    @staticmethod
    def _seed(sessions, tenant):
        sess = sessions.register(tenant)
        sessions.apply(sess, {"a": np.zeros((8, 4), dtype=np.float32)},
                       {"seq": 1, "mode": "full"})
        return sess

    def test_sweep_keeps_live_sessions(self):
        clock = [0.0]
        sessions = sess_mod.SessionRegistry(ttl_s=10.0,
                                            now=lambda: clock[0])
        self._seed(sessions, "fresh")
        clock[0] = 5.0
        assert sessions.sweep() == 0
        assert sessions.stats()["sessions"] == 1

    def test_sweeper_thread_reclaims_without_client_access(self):
        reg = Registry()
        sessions = sess_mod.SessionRegistry(ttl_s=0.05)
        self._seed(sessions, "idle")
        assert sessions.stats()["bytes"] > 0
        stop = sessions.start_sweeper(interval_s=0.02, registry=reg)
        try:
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                if sessions.stats()["bytes"] == 0:
                    break
                time.sleep(0.02)
            st = sessions.stats()
            assert st["bytes"] == 0 and st["sessions"] == 0
            assert reg.counter(m.SOLVER_SESSION_SWEEPS).value() >= 1
        finally:
            stop.set()

    def test_sweeper_disabled_by_knob(self, monkeypatch):
        monkeypatch.setenv("KARPENTER_SESSION_SWEEP_S", "0")
        sessions = sess_mod.SessionRegistry()
        assert sessions.start_sweeper() is None


class TestSessionRegistryUnits:
    @staticmethod
    def _with_bundle(sessions, tenant, rows=6):
        sess = sessions.register(tenant)
        sessions.apply(
            sess,
            {"a": np.arange(rows * 2, dtype=np.float32).reshape(rows, 2)},
            {"seq": 1, "mode": "full"})
        return sess

    def test_negative_row_patch_rejected_not_wrapped(self):
        sessions = sess_mod.SessionRegistry()
        sess = self._with_bundle(sessions, "t")
        before = sess.bundle["a"].copy()
        with pytest.raises(sess_mod.ResyncRequired):
            sessions.apply(
                sess,
                {"a" + sess_mod.ROWS_SUFFIX: np.array([-1], dtype=np.int64),
                 "a" + sess_mod.VALS_SUFFIX: np.full((1, 2), 99.0,
                                                     dtype=np.float32)},
                {"seq": 2, "mode": "delta", "base_seq": 1,
                 "patch": {"a": "rows"}})
        assert np.array_equal(sess.bundle["a"], before)

    def test_broadcast_row_patch_rejected_not_replicated(self):
        sessions = sess_mod.SessionRegistry()
        sess = self._with_bundle(sessions, "t")
        before = sess.bundle["a"].copy()
        with pytest.raises(sess_mod.ResyncRequired):
            sessions.apply(
                sess,
                {"a" + sess_mod.ROWS_SUFFIX: np.array([0, 2, 4],
                                                      dtype=np.int64),
                 "a" + sess_mod.VALS_SUFFIX: np.full((1, 2), 99.0,
                                                     dtype=np.float32)},
                {"seq": 2, "mode": "delta", "base_seq": 1,
                 "patch": {"a": "rows"}})
        assert np.array_equal(sess.bundle["a"], before)

    def test_full_upload_onto_dropped_session_rejected_no_byte_leak(self):
        sessions = sess_mod.SessionRegistry()
        sess = self._with_bundle(sessions, "t")
        assert sessions.release(sess.id, "t")
        with pytest.raises(sess_mod.SessionExpired):
            sessions.apply(sess, {"a": np.zeros((6, 2), dtype=np.float32)},
                           {"seq": 2, "mode": "full"})
        assert sessions.stats()["bytes"] == 0

    def test_eviction_accounting_survives_back_to_back_stores(self):
        reg = Registry()
        sessions = sess_mod.SessionRegistry(byte_budget=1)
        self._with_bundle(sessions, "a")
        self._with_bundle(sessions, "b")
        self._with_bundle(sessions, "c")
        sessions.drain_evictions(registry=reg)
        assert reg.counter(m.SOLVER_SESSION_CACHE_EVICTIONS).value(
            tenant="a") == 1
        assert reg.counter(m.SOLVER_SESSION_CACHE_EVICTIONS).value(
            tenant="b") == 1

    def test_delta_swaps_bundle_in_flight_reference_untouched(self):
        sessions = sess_mod.SessionRegistry()
        sess = self._with_bundle(sessions, "t")
        held = sess.bundle
        held_keys = set(held)
        held_a = held["a"].copy()
        sessions.apply(
            sess,
            {"a" + sess_mod.ROWS_SUFFIX: np.array([2], dtype=np.int64),
             "a" + sess_mod.VALS_SUFFIX: np.full((1, 2), 77.0,
                                                 dtype=np.float32)},
            {"seq": 2, "mode": "delta", "base_seq": 1,
             "patch": {"a": "rows"}})
        assert sess.bundle is not held
        assert set(held) == held_keys
        assert np.array_equal(held["a"], held_a)
        assert sess.bundle["a"][2, 0] == 77.0

    def test_session_cap_drops_lru_session(self):
        sessions = sess_mod.SessionRegistry()
        sessions.session_cap = 2
        a = self._with_bundle(sessions, "a")
        b = self._with_bundle(sessions, "b")
        held = sessions._total_bytes
        c = sessions.register("c")
        assert a.id not in sessions._sessions
        assert b.id in sessions._sessions and c.id in sessions._sessions
        assert sessions._total_bytes < held

    def test_env_bool_shared_semantics(self, monkeypatch):
        monkeypatch.delenv("X_FLAG", raising=False)
        assert sess_mod.env_bool("X_FLAG", True) is True
        assert sess_mod.env_bool("X_FLAG", False) is False
        for off in ("0", "false", "OFF", " no "):
            monkeypatch.setenv("X_FLAG", off)
            assert sess_mod.env_bool("X_FLAG", True) is False
        for on in ("1", "true", "zstd", "yes"):
            monkeypatch.setenv("X_FLAG", on)
            assert sess_mod.env_bool("X_FLAG", False) is True

    def test_release_frees_bundle_bytes_tenant_checked(self):
        sessions = sess_mod.SessionRegistry()
        sess = self._with_bundle(sessions, "t")
        bytes_held = sess.bundle_bytes
        assert bytes_held > 0
        assert sessions.release(sess.id, "OTHER") is False
        assert sess.id in sessions._sessions
        assert sessions._total_bytes == bytes_held
        assert sessions.release("s-nonexistent", "t") is False
        assert sessions.release(sess.id, "t") is True
        assert sess.id not in sessions._sessions
        assert sessions._total_bytes == 0

    def test_codec_negotiation_downgrades_to_deflate(self, monkeypatch):
        monkeypatch.setenv("KARPENTER_SOLVER_COMPRESS", "zstd")
        s = svc.RemoteSolver.__new__(svc.RemoteSolver)
        s._server_codecs = {"deflate"}
        assert s._upload_codec() == "deflate"
        s._server_codecs = {"deflate", "zstd"}
        assert s._upload_codec() in ("zstd", "deflate")


class TestCompression:
    def test_pack_deflate_roundtrip_and_shrinks(self):
        arrays = {"a": np.zeros((64, 64), dtype=np.float32),
                  "b": np.arange(128, dtype=np.int32)}
        raw = svc._pack(arrays, {"x": 1})
        packed = svc._pack(arrays, {"x": 1}, codec="deflate")
        assert len(packed) < len(raw)
        got, meta = svc._unpack(packed)
        assert meta == {"x": 1}
        assert np.array_equal(got["a"], arrays["a"])
        assert np.array_equal(got["b"], arrays["b"])

    def test_compressed_full_uploads_end_to_end(self, server, monkeypatch):
        monkeypatch.setenv("KARPENTER_SOLVER_COMPRESS", "1")
        _, target, reg = server
        s = RemoteSolver(target, registry=reg, tenant="zip")
        res = solve_once(s, n_pods=30)
        assert res.scheduled_pod_count() == 30
        assert s.last_device_stats["engine"] == "remote"
        assert reg.histogram(m.SOLVER_REQUEST_BYTES).count(
            kind="full", codec="deflate") >= 1

    def test_codec_resolution(self, monkeypatch):
        monkeypatch.delenv("KARPENTER_SOLVER_COMPRESS", raising=False)
        assert svc._env_codec() is None
        monkeypatch.setenv("KARPENTER_SOLVER_COMPRESS", "1")
        assert svc._env_codec() == "deflate"
        monkeypatch.setenv("KARPENTER_SOLVER_COMPRESS", "zstd")
        assert svc._env_codec() in ("zstd", "deflate")


class TestTenantSlo:
    def test_session_solves_carry_tenant_label(self, server):
        srv, target, reg = server
        s = RemoteSolver(target, registry=reg, tenant="slotest")
        solve_once(s, n_pods=20)
        solve_once(s, n_pods=20, off=50)
        assert reg.counter(m.SOLVER_TENANT_REQUESTS).value(
            slo="solver_service", tenant="slotest", outcome="ok") >= 2
        assert reg.gauge(m.SOLVER_REQUEST_QUANTILE).value(
            slo="solver_service", tenant="slotest", q="p99") > 0
        snap = srv.solver_handler._slo.snapshot()
        assert "slotest" in snap.get("tenants", {})
        assert snap["tenants"]["slotest"]["count"] >= 2
        assert snap["tenants"]["slotest"]["p99_ms"] > 0
        q = srv.solver_handler._slo.tenant_quantiles("slotest")
        assert q["p99"] > 0


class TestTenantIsolation:
    def test_interleaved_tenants_match_solo_oracles(self, server):
        from karpenter_tpu_torch.operator import Environment

        srv, target, reg = server

        def build_env(solver):
            env = Environment(
                instance_types=[make_instance_type("small", 16, 64)],
                solver=solver or local())
            env.create("nodepools",
                       NodePool(metadata=ObjectMeta(name="default")))
            return env

        def workload(seed):
            rng = random.Random(seed)
            return [seeded_pods(rng, 10 + 4 * r, off=100 * r)
                    for r in range(2)]

        seeds = [3, 11, 42]
        tenants = [
            (build_env(RemoteSolver(target, registry=reg,
                                    tenant=f"iso-{seed}")), seed)
            for seed in seeds
        ]
        for r in range(2):
            for env, seed in tenants:
                env.provision(*workload(seed)[r])

        def end_state(env):
            bound = sorted(
                (p.metadata.name, p.node_name is not None)
                for p in env.store.list("pods"))
            return (len(env.store.list("nodes")), bound)

        for env, seed in tenants:
            oracle = build_env(None)
            for batch in workload(seed):
                oracle.provision(*batch)
            assert end_state(env) == end_state(oracle), f"seed {seed}"
        assert srv.solver_handler.sessions.verify_isolation(
            registry=reg) == []


def test_multitenant_fleet_through_its_own_server_process():
    """``workload.run_multitenant`` at a small size on this CPU: tenants
    through one server process in session mode — deltas only in steady
    state, isolation against the solo oracles, no fallback, the billing
    plane reconciled."""
    pytest.importorskip("grpc")
    row = mod(PORT, "workload").run_multitenant(
        n_tenants=3, rounds=2, pods_per_round=24, think_ms=20.0,
        server_device="cpu",
        server_env={"KARPENTER_NATIVE_CUTOFF": "0"})
    assert "error" not in row, row
    assert row["isolation_ok"] is True
    assert row["deltas"]["full_uploads"] == 3
    assert row["deltas"]["resyncs"] == 0
    assert row["deltas"]["delta_rounds"] >= 3
    assert row["deltas_only_steady_state"] is True
    assert row["client_fallbacks"] == 0 and not row["degraded"]
    assert row["billing_sums_ok"] is True
    assert set(row["per_tenant"]) == {"tenant-0", "tenant-1", "tenant-2"}


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

BATCH_FAMILIES = ["plain", "existing", "classes", "limits", "mixed", "ties"]


@pytest.mark.parametrize("family", BATCH_FAMILIES)
def test_batched_invoke_bit_equal_to_jax(family):
    """Both packages' batched solves on the same stacked snapshots (three
    seeded draws of one family, padded to four)."""
    from karpenter_tpu.models.solver import batched_invoke as jbatched
    from karpenter_tpu_torch.models.solver import batched_invoke
    from tests.test_torch_kernels import make_args

    rows = [make_args(family, seed=31 + s) for s in range(3)]
    max_minv = int(max(r["m_minv"].max() for r in rows))
    for max_bins in (16, 32):  # the bin axis at and past the type axis
        want = jbatched(rows, max_bins, level_bits=8, max_minv=max_minv)
        got = batched_invoke(rows, max_bins, level_bits=8,
                             max_minv=max_minv, device="cpu")
        for w, g in zip(want, got):
            for k in ("assign", "assign_e", "used", "tmpl", "F"):
                assert np.array_equal(np.asarray(w[k]), g[k]), (max_bins, k)


def test_batched_invoke_tie_shape_bit_equal_to_jax(monkeypatch):
    """The multiply-add tie shape, N = 3 padded to 4: the batched program
    contracts the capacity formula here (Bp == Tp), so row 126's two
    0.83-cpu pods land on bin 5 in every row, as the JAX package's."""
    from karpenter_tpu.models.solver import batched_invoke as jbatched
    from karpenter_tpu_torch.models.solver import batched_invoke
    from tests.test_torch_kernels import _tie_args

    args, level_bits, max_bins = _tie_args(monkeypatch)
    assert (args["g_demand"].shape[0], args["t_alloc"].shape[0],
            max_bins) == (256, 64, 64)
    # three same-shape snapshots: the tie snapshot and two with the group
    # counts shifted
    rows = [args]
    for shift in (1, 2):
        a = dict(args)
        a["g_count"] = np.roll(args["g_count"], shift)
        rows.append(a)
    want = jbatched(rows, max_bins, level_bits=level_bits)
    got = batched_invoke(rows, max_bins, level_bits=level_bits, device="cpu")
    for w, g in zip(want, got):
        for k in ("assign", "assign_e", "used", "tmpl", "F"):
            assert np.array_equal(np.asarray(w[k]), g[k]), k
    assert got[0]["assign"][126, 1] == 0 and got[0]["assign"][126, 5] == 2


@pytest.mark.parametrize("pairing", ["jax-client/port-server",
                                     "port-client/jax-server"])
@pytest.mark.parametrize("tenant", [None, "acme"], ids=["stateless",
                                                        "session"])
def test_cross_package_wire(pairing, tenant):
    """One package's RemoteSolver against the other package's server:
    every round equals the client package's in-process solve, and the
    server's dispatch outputs equal the in-process dispatch bit for bit."""
    pytest.importorskip("grpc")
    client_pkg, server_pkg = ((JAX, PORT) if pairing.startswith("jax")
                              else (PORT, JAX))
    server_kw = {"device": "cpu"} if server_pkg == PORT else {}
    srv, port = mod(server_pkg, "service").serve(port=0, **server_kw)
    try:
        nodepool = mod(client_pkg, "api.nodepool")
        ob = mod(client_pkg, "api.objects")
        models = mod(client_pkg, "models")
        catalog = mod(client_pkg, "cloudprovider.catalog")
        pool = nodepool.NodePool(metadata=ob.ObjectMeta(name="default"))
        its = {pool.name: catalog.benchmark_catalog(30)}
        remote = mod(client_pkg, "service").RemoteSolver(
            f"127.0.0.1:{port}", tenant=tenant)
        inproc = (models.TPUSolver() if client_pkg == JAX
                  else models.TorchSolver(device="cpu"))
        for n in (40, 44, 44):
            batch = pods(n, pkg=client_pkg)
            got = remote.solve([p.clone() for p in batch],
                               [models.ClaimTemplate(pool)], its)
            want = inproc.solve([p.clone() for p in batch],
                                [models.ClaimTemplate(pool)], its)
            assert remote.last_device_stats["engine"] == "remote"
            assert got.scheduled_pod_count() == want.scheduled_pod_count()
            assert got.node_count() == want.node_count()
            assert sizes_of(got) == sizes_of(want)
        if tenant:
            assert remote.session_stats["full_uploads"] == 1
            assert remote.session_stats["delta_rounds"] == 2
    finally:
        srv.stop(grace=None)


def test_cross_package_wire_outputs_bit_equal():
    """The same shipped arguments answer bit-equal from either package's
    server and from the port's in-process dispatch."""
    pytest.importorskip("grpc")
    from karpenter_tpu.service import serve as jserve

    s = local()
    seen = []
    real = TorchSolver._dispatch
    s._dispatch = lambda args, key, max_bins, upload=None: (
        seen.append((args, key, max_bins)) or real(s, args, key, max_bins,
                                                   upload))
    solve_once(s, n_pods=36, n_types=24)
    args, key, max_bins = seen[-1]
    want = local()._dispatch(args, key, max_bins)
    meta = {"max_bins": max_bins, "level_bits": key[-2], "max_minv": key[-1]}
    import grpc

    for start in (jserve, lambda **kw: svc.serve(device="cpu", **kw)):
        srv, port = start(port=0)
        try:
            chan = grpc.insecure_channel(f"127.0.0.1:{port}",
                                         options=svc._GRPC_OPTS)
            call = chan.unary_unary(svc._METHOD, request_serializer=None,
                                    response_deserializer=None)
            got, _ = svc._unpack(call(svc._pack(args, meta)))
            chan.close()
        finally:
            srv.stop(grace=None)
        for k in ("assign", "assign_e", "used", "tmpl", "F"):
            assert np.array_equal(np.asarray(want[k]).astype(got[k].dtype),
                                  got[k]), k


def test_session_protocol_constants_match_jax():
    from karpenter_tpu.service import session as jsess
    from karpenter_tpu.service import solver_service as jsvc

    assert (svc._METHOD, svc._METHOD_REGISTER, svc._METHOD_SESSION) == (
        jsvc._METHOD, jsvc._METHOD_REGISTER, jsvc._METHOD_SESSION)
    assert (sess_mod.ROWS_SUFFIX, sess_mod.VALS_SUFFIX) == (
        jsess.ROWS_SUFFIX, jsess.VALS_SUFFIX)
    assert svc._FAMILY_CAP == jsvc._FAMILY_CAP
    # the same bytes either way
    arrays = {"a": np.arange(6, dtype=np.int32)}
    for blob in (svc._pack(arrays, {"k": 1}), jsvc._pack(arrays, {"k": 1})):
        for unpack in (svc._unpack, jsvc._unpack):
            got, meta = unpack(blob)
            assert meta == {"k": 1} and np.array_equal(got["a"], arrays["a"])
