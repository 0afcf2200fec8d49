"""The port's observability planes against the JAX package's.

The cases of ``tests/test_obs.py``, ``test_devplane.py``,
``test_decisions.py`` and ``test_timeline.py``, each parametrised over
both packages (``pkg``: ``jax`` and ``port``) wherever it drives a plane
directly, so every case runs against ``karpenter_tpu.obs`` and
``karpenter_tpu_torch.obs`` with each package's own metrics registry.
Cases that drive a producer (a solver, a disruption method, the snapshot
cache, an ``Environment``) run the package's own producer: ``TPUSolver``
for the JAX package, ``TorchSolver(device="cpu")`` for the port, whose
engine rung is named ``device`` where the JAX package's is ``xla``.

Left to their JAX files: the mesh cases (``mesh.partition`` and the
``mesh.shards`` pad site: the mesh is not ported) and the GL502 producer
census (the port's static analysis is not ported). The solver-service
cases (``session.sync``) are in ``tests/test_torch_service.py`` and the
replay cases in ``tests/test_torch_capsule.py``; pinned below, ``python
-m karpenter_tpu_torch.obs replay`` returns the JAX package's exit code
on a missing capsule. The two slow
acceptance cases stay slow here as in ``test_obs.py``; their card
counterparts are ``chip_smoke.py``'s obs phase.

Also pinned: no span, counter or ledger call inside the pack loop
(``ops/kernels.py``) or ``ops/cuda_kernels.py``, and the port's planes
read their knobs through ``utils/envknobs.py``.

Tolerance: exact (counts, names, enums); timings only as orderings.
"""

from __future__ import annotations

import ast
import importlib
import json
import os
import threading
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from tests.test_torch_operator import JAX, PORT, Kit, config4_env

ROOT = Path(__file__).resolve().parent.parent
GIB = 2**30
PKGS = {"jax": JAX, "port": PORT}


def _ns(pkg: str) -> SimpleNamespace:
    """One package's planes and the names the cases use."""
    root = PKGS[pkg]

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    metrics = mod("operator.metrics")
    return SimpleNamespace(
        pkg=pkg, root=root, mod=mod, obs=mod("obs"),
        trace=mod("obs.trace"), devplane=mod("obs.devplane"),
        decisions=mod("obs.decisions"), timeline=mod("obs.timeline"),
        cli=mod("obs.__main__"), m=metrics, Registry=metrics.Registry,
        DEV="xla" if pkg == "jax" else "device", kit=Kit(root))


@pytest.fixture(params=sorted(PKGS))
def P(request, tmp_path):
    """Isolated tracer/recorder/ledger state of one package, dumps at
    ``P.dir``."""
    ns = _ns(request.param)
    ns.obs.configure(enabled=True, dump_dir=str(tmp_path), capacity=8,
                     dump_all=False)
    ns.obs.RECORDER.clear()
    ns.obs.capsule.reset()
    ns.devplane.reset()
    ns.decisions.reset()
    ns.timeline.reset()
    ns.dir = tmp_path
    yield ns
    ns.devplane.reset()
    ns.timeline.reset()
    ns.decisions.reset()
    ns.obs.reset()


def dumps_in(path) -> list:
    return sorted(p for p in os.listdir(path) if p.endswith(".trace.json"))


def _solver(P):
    return P.kit.solver()


# ---------------------------------------------------------------------------
# the flight recorder (tests/test_obs.py)
# ---------------------------------------------------------------------------

class TestTraceStructure:
    def test_nesting_parent_links_and_self_time(self, P):
        obs = P.obs
        with obs.round_trace("r") as tr:
            with obs.span("a"):
                with obs.span("a.1", kind="device"):
                    pass
                with obs.span("a.2", kind="cache"):
                    pass
            with obs.span("b"):
                pass
        root = tr.root
        assert [c.name for c in root.children] == ["a", "b"]
        a = root.children[0]
        assert [c.name for c in a.children] == ["a.1", "a.2"]
        assert a.children[0].kind == "device"
        for sp in tr.spans():
            assert sp.dur is not None and sp.dur >= 0.0
        assert a.dur >= sum(c.dur for c in a.children)
        assert a.self_seconds() <= a.dur
        total_self = sum(v[0] for v in tr.self_times().values())
        assert total_self == pytest.approx(root.dur, rel=1e-6)

    def test_span_without_round_is_noop(self, P):
        with P.obs.span("orphan") as sp:
            assert sp is None
        assert P.obs.RECORDER.traces() == []

    def test_nested_round_degrades_to_span(self, P):
        with P.obs.round_trace("outer") as tr:
            with P.obs.round_trace("inner"):
                pass
        assert [c.name for c in tr.root.children] == ["inner"]
        assert [t.name for t in P.obs.RECORDER.traces()] == ["outer"]

    def test_disabled_tracer_is_inert(self, P):
        P.obs.configure(enabled=False)
        with P.obs.round_trace("r") as tr:
            assert tr is None
            with P.obs.span("x") as sp:
                assert sp is None
        assert P.obs.RECORDER.traces() == []

    def test_worker_thread_attaches(self, P):
        obs = P.obs
        with obs.round_trace("r") as tr:
            def work():
                with obs.attach(tr):
                    with obs.span("worker.step"):
                        pass

            t = threading.Thread(target=work)
            t.start()
            t.join()
        assert "worker.step" in {c.name for c in tr.root.children}

    def test_exception_closes_span_and_round(self, P):
        with pytest.raises(ValueError):
            with P.obs.round_trace("r"):
                with P.obs.span("boom"):
                    raise ValueError("x")
        tr = P.obs.RECORDER.last("r")
        assert tr is not None
        assert tr.root.children[0].dur is not None
        assert tr.root.children[0].attrs["error"] == "ValueError"

    def test_span_cap_degrades_not_grows(self, P, monkeypatch):
        monkeypatch.setattr(P.trace, "MAX_SPANS_PER_TRACE", 8)
        with P.obs.round_trace("r") as tr:
            for _ in range(20):
                with P.obs.span("s"):
                    pass
        assert len(tr.spans()) <= 8
        assert tr.dropped > 0


class TestChromeDump:
    def _trace(self, P):
        with P.obs.round_trace("r", registry=P.Registry()) as tr:
            with P.obs.span("stage", kind="cache", rows=3):
                with P.obs.span("kernel", kind="device"):
                    pass
            P.obs.anomaly("probe-fallback", method="multi")
        return tr

    def test_dump_is_valid_trace_event_json(self, P):
        tr = self._trace(P)
        assert tr.dump_path is not None
        with open(tr.dump_path, encoding="utf-8") as f:
            doc = json.load(f)
        assert doc["displayTimeUnit"] == "ms"
        events = doc["traceEvents"]
        names = [e["name"] for e in events]
        assert names[0] == "r"
        assert "anomaly:probe-fallback" in names
        for e in events:
            assert isinstance(e["ts"], (int, float)) and e["ts"] >= 0
            assert e["ph"] in ("X", "i")
            assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
            if e["ph"] == "X":
                assert e["dur"] >= 0
            else:
                assert e["s"] == "g"
        by_name = {e["name"]: e for e in events}
        assert by_name["kernel"]["cat"] == "device"
        assert by_name["stage"]["args"]["rows"] == 3
        assert doc["otherData"]["anomalies"] == ["probe-fallback"]
        assert doc["otherData"]["round"] == "r"

    def test_dump_is_idempotent_per_trace(self, P):
        tr = self._trace(P)
        assert P.obs.RECORDER.dump(tr) == tr.dump_path
        assert len(dumps_in(P.dir)) == 1

    def test_non_jsonable_attrs_are_stringified(self, P):
        with P.obs.round_trace("r") as tr:
            with P.obs.span("s", obj=object()):
                pass
            P.obs.anomaly("negative-avail")
        with open(tr.dump_path, encoding="utf-8") as f:
            doc = json.load(f)
        arg = [e for e in doc["traceEvents"]
               if e["name"] == "s"][0]["args"]["obj"]
        assert isinstance(arg, str)


class TestRingBuffer:
    def _round(self, P, name):
        with P.obs.round_trace(name):
            with P.obs.span("x"):
                pass

    def test_eviction_is_oldest_first(self, P):
        P.obs.configure(capacity=3)
        for i in range(5):
            self._round(P, f"r{i}")
        assert [t.name for t in P.obs.RECORDER.traces()] == ["r2", "r3",
                                                             "r4"]
        assert P.obs.RECORDER.last().name == "r4"
        assert P.obs.RECORDER.last("r3").name == "r3"

    def test_idle_rounds_do_not_churn_the_ring(self, P):
        P.obs.configure(capacity=2)
        self._round(P, "real")
        for _ in range(10):
            with P.obs.round_trace("idle"):
                pass
        assert "real" in [t.name for t in P.obs.RECORDER.traces()]

    def test_reconfigure_capacity_keeps_most_recent(self, P):
        for i in range(5):
            self._round(P, f"r{i}")
        P.obs.configure(capacity=2)
        assert [t.name for t in P.obs.RECORDER.traces()] == ["r3", "r4"]

    def test_discarded_round_skips_ring_and_histograms(self, P):
        registry = P.Registry()
        with P.obs.round_trace("disrupt", registry=registry):
            with P.obs.span("disrupt.candidates"):
                pass
            P.obs.discard_round()
        assert P.obs.RECORDER.traces() == []
        assert registry.histogram(P.m.TRACE_ROUND_SECONDS).count(
            round="disrupt") == 0

    def test_anomaly_overrides_discard(self, P):
        with P.obs.round_trace("disrupt"):
            with P.obs.span("x"):
                pass
            P.obs.discard_round()
            P.obs.anomaly("negative-avail")
        assert [t.name for t in P.obs.RECORDER.traces()] == ["disrupt"]
        assert len(dumps_in(P.dir)) == 1

    def test_candidate_free_disruption_ticks_are_discarded(self, P):
        env = P.kit.env([("small", 2, 8)], enable_disruption=True)
        env.run_until_idle()
        P.obs.RECORDER.clear()
        for _ in range(5):
            env.clock.step(20.0)
            env.disruption.poll()
        assert [t for t in P.obs.RECORDER.traces()
                if t.name == "disrupt"] == []


class TestAnomalyMatrix:
    def test_one_dump_per_anomalous_round(self, P):
        with P.obs.round_trace("r"):
            with P.obs.span("x"):
                pass
            P.obs.anomaly("host-routed", pods=2)
        assert len(dumps_in(P.dir)) == 1

    def test_multiple_anomalies_still_one_dump(self, P):
        with P.obs.round_trace("r"):
            with P.obs.span("x"):
                pass
            P.obs.anomaly("host-routed")
            P.obs.anomaly("negative-avail")
            P.obs.anomaly("snapshot-rebuild")
        assert len(dumps_in(P.dir)) == 1
        tr = P.obs.RECORDER.last()
        assert [k for k, _, _ in tr.anomalies] == [
            "host-routed", "negative-avail", "snapshot-rebuild"]

    def test_clean_round_produces_no_dump(self, P):
        with P.obs.round_trace("r"):
            with P.obs.span("x"):
                pass
        assert dumps_in(P.dir) == []

    def test_probe_fallback_trigger(self, P):
        _device_probe = P.mod("controllers.disruption.methods")._device_probe

        class Ctx:
            provisioner = type("P", (), {"solver": _solver(P)})()
            cluster = store = None
            registry = P.Registry()
            snapshot_cache = None

        def bad_probe(*a, **kw):
            raise KeyError("seeded disagreement")

        with P.obs.round_trace("disrupt", registry=Ctx.registry):
            out = _device_probe(Ctx, bad_probe, "multi", [], None)
        assert out is None
        assert len(dumps_in(P.dir)) == 1
        assert Ctx.registry.counter(P.m.TRACE_ANOMALIES).value(
            kind="probe-fallback") == 1

    def _multi(self, P, registry):
        cls = P.mod("controllers.disruption.methods").MultiNodeConsolidation
        return cls(type("Ctx", (), {"registry": registry})())

    def test_multi_host_confirms_trigger(self, P):
        registry = P.Registry()
        meth = self._multi(P, registry)

        def fake_compute(candidates, budgets):
            meth.last_host_confirms = 3
            meth.last_probe = "device"
            return None

        meth._compute = fake_compute
        with P.obs.round_trace("disrupt", registry=registry):
            with P.obs.span("ladder"):
                meth.compute_command([], {})
        assert len(dumps_in(P.dir)) == 1
        assert registry.counter(P.m.TRACE_ANOMALIES).value(
            kind="multi-host-confirms") == 1

    def test_single_confirm_is_not_anomalous(self, P):
        registry = P.Registry()
        meth = self._multi(P, registry)

        def fake_compute(candidates, budgets):
            meth.last_host_confirms = 1
            return None

        meth._compute = fake_compute
        with P.obs.round_trace("disrupt", registry=registry):
            with P.obs.span("ladder"):
                meth.compute_command([], {})
        assert dumps_in(P.dir) == []

    def test_stale_confirm_count_does_not_refire(self, P):
        registry = P.Registry()
        meth = self._multi(P, registry)
        meth.last_host_confirms = 3
        with P.obs.round_trace("disrupt", registry=registry):
            with P.obs.span("ladder"):
                meth.compute_command([], {})
        assert dumps_in(P.dir) == []
        assert meth.last_host_confirms == 0

    def test_snapshot_rebuild_trigger(self, P, monkeypatch):
        cons = P.mod("ops.consolidate")
        registry = P.Registry()
        built = []

        def fake_build(provisioner, cluster, store, candidates):
            built.append(1)
            return type("B", (), {
                "generation": cluster.consolidation_state(),
                "build_key": frozenset(c.provider_id for c in candidates),
            })()

        monkeypatch.setattr(cons, "build_disruption_snapshot", fake_build)

        class FakeCluster:
            def __init__(self):
                self.gen = 1

            def consolidation_state(self):
                return self.gen

            def deltas_since(self, g):
                return None

        cluster = FakeCluster()
        cand = type("C", (), {"provider_id": "p-1"})()
        cache = cons.SnapshotCache()
        with P.obs.round_trace("disrupt", registry=registry):
            with P.obs.span("probe"):
                cache.get(None, cluster, None, [cand], registry=registry)
        assert dumps_in(P.dir) == []
        cluster.gen = 2
        with P.obs.round_trace("disrupt", registry=registry):
            with P.obs.span("probe"):
                cache.get(None, cluster, None, [cand], registry=registry)
        assert len(built) == 2
        assert len(dumps_in(P.dir)) == 1
        assert registry.counter(P.m.TRACE_ANOMALIES).value(
            kind="snapshot-rebuild") == 1

    def test_negative_avail_trigger(self, P):
        k = P.kit
        tz = P.mod("ops.tensorize")
        registry = P.Registry()
        tpl = P.mod("models").ClaimTemplate(k.nodepool())
        its = {"default": [k.make_instance_type("small", 2, 8)]}
        snap = tz.tensorize([k.pod("p0", cpu=1.0)], [tpl], its)
        Requirements = P.mod("scheduling").Requirements

        class FakeState:
            provider_id = "pid-0"
            name = hostname = "n0"
            pods = {}

            def taints(self):
                return []

        class FakeNode:
            state_node = FakeState()
            cached_available = {"cpu": 1.0, "memory": GIB}
            requests = {"cpu": 2.0}
            requirements = Requirements()

        with P.obs.round_trace("disrupt", registry=registry):
            with P.obs.span("snapshot"):
                tz.tensorize_existing(snap, [FakeNode()], registry=registry)
        assert len(dumps_in(P.dir)) == 1
        assert registry.counter(P.m.TRACE_ANOMALIES).value(
            kind="negative-avail") == 1
        assert registry.counter(P.m.TENSORIZE_NEGATIVE_AVAIL).value() == 1

    def test_host_routed_trigger_end_to_end(self, P):
        k = P.kit
        env = k.env([("small", 2, 8)])
        env.store.create("nodepools", k.nodepool())
        env.store.create("pods", k.Pod(
            metadata=k.ObjectMeta(name="webserver"),
            requests={"cpu": 0.5, "memory": GIB},
            host_ports=[("0.0.0.0", 80, "TCP")],
        ))
        env.run_until_idle()
        files = [f for f in dumps_in(P.dir) if f.startswith("provision-")]
        assert len(files) == 1
        assert env.registry.counter(P.m.TRACE_ANOMALIES).value(
            kind="host-routed") == 1
        assert env.registry.counter(P.m.PROVISIONING_HOST_ROUTED).value(
            reason="ineligible-spec") == 1


class TestIntegration:
    def test_span_histograms_feed_registry(self, P):
        registry = P.Registry()
        with P.obs.round_trace("provision", registry=registry):
            with P.obs.span("solve.kernel", kind="device"):
                pass
            with P.obs.span("solve.decode"):
                pass
        h = registry.histogram(P.m.TRACE_SPAN_SECONDS)
        assert h.count(span="solve.kernel", kind="device") == 1
        assert h.count(span="solve.decode", kind="host") == 1
        assert registry.histogram(P.m.TRACE_ROUND_SECONDS).count(
            round="provision") == 1

    def test_dump_counter(self, P):
        registry = P.Registry()
        with P.obs.round_trace("disrupt", registry=registry):
            with P.obs.span("x"):
                pass
            P.obs.anomaly("probe-fallback")
        assert registry.counter(P.m.TRACE_DUMPS).value(round="disrupt") == 1

    def test_trace_id_threads_into_logging(self, P):
        Logger = P.mod("operator.logging").Logger
        lines = []
        log = Logger(sink=lines.append)
        with P.obs.round_trace("disrupt") as tr:
            log.info("inside")
        log.info("outside")
        assert f"trace={tr.trace_id}" in lines[0]
        assert "trace=" not in lines[1]

    def test_disrupt_round_traced_through_controller(self, P):
        env = config4_env(P.root, 4)
        env.disruption.poll_period = 0.0
        env.clock.step(20.0)
        env.disruption.poll()
        tr = P.obs.RECORDER.last("disrupt")
        assert tr is not None
        names = {sp.name for sp in tr.spans()}
        assert {"disrupt.candidates", "disrupt.budgets"} <= names
        assert any(n.startswith("method.") for n in names)


@pytest.mark.slow
class TestAcceptanceSlow:
    def test_300_node_round_leaf_attribution(self, P):
        env = config4_env(P.root, 300)
        env.disruption.poll_period = 0.0
        for _ in range(3):
            env.clock.step(20.0)
            env.run_until_idle(max_rounds=50)
        rounds = [t for t in P.obs.RECORDER.traces() if t.name == "disrupt"]
        assert rounds, "no disruption round was traced"
        longest = max(rounds, key=lambda t: t.root.dur or 0.0)
        assert longest.root.dur > 0.05
        assert longest.leaf_coverage() >= 0.95, longest.summary(top=8)

    def test_tracer_overhead_grid_1000(self, P):
        import time

        from perf import configs as C

        k = P.kit
        cat = P.mod("cloudprovider.catalog").benchmark_catalog(400)
        tpl = P.mod("models").ClaimTemplate(k.nodepool())
        pods = [k.pod(f"d{i}", cpu=0.25 + (i % 7) * 0.25,
                      mem_gib=0.5 + (i % 5) * 0.5) for i in range(1000)]
        if P.pkg == "jax":
            pods = C.diverse_pods(1000)
        solver = _solver(P)

        def timed():
            t0 = time.perf_counter()
            solver.solve([p.clone() for p in pods], [tpl],
                         {"default": cat})
            return (time.perf_counter() - t0) * 1000.0

        timed()

        def one(traced: bool) -> float:
            P.obs.configure(enabled=traced)
            if traced:
                with P.obs.round_trace("bench"):
                    return timed()
            return timed()

        off, on = [], []
        for _ in range(7):
            off.append(one(False))
            on.append(one(True))
        assert min(on) <= min(off) * 1.02 + 20.0, (on, off)


# ---------------------------------------------------------------------------
# the device plane (tests/test_devplane.py)
# ---------------------------------------------------------------------------

class TestCompileLedger:
    def test_warm_redispatch_records_zero_cold_compiles(self, P):
        dp, reg = P.devplane, P.Registry()
        assert dp.record_dispatch("solve.kernel", ("k", 64), 0.1,
                                  registry=reg) is True
        before = dp.STATS["cold_compiles"]
        for _ in range(3):
            assert dp.record_dispatch("solve.kernel", ("k", 64), 0.01,
                                      registry=reg) is False
        assert dp.STATS["cold_compiles"] == before
        assert reg.counter(P.m.COMPILE_EVENTS).value(
            family="solve.kernel") == 1
        assert reg.histogram(P.m.COMPILE_SECONDS).count(
            family="solve.kernel") == 1

    def test_new_shape_family_records_exactly_one(self, P):
        dp, reg = P.devplane, P.Registry()
        for i in range(3):
            dp.record_dispatch("probe.kernel", ("p", i), 0.1, registry=reg)
            dp.record_dispatch("probe.kernel", ("p", i), 0.01, registry=reg)
        assert reg.counter(P.m.COMPILE_EVENTS).value(
            family="probe.kernel") == 3
        assert reg.gauge(P.m.COMPILE_FAMILIES).value(
            family="probe.kernel") == 3
        assert dp.LEDGER.families()["probe.kernel"] == 3

    def test_steady_state_cold_compile_dumps_exactly_one_trace(self, P):
        dp, reg = P.devplane, P.Registry()
        dp.LEDGER.steady_after = 4
        dp.record_dispatch("solve.kernel", ("fam", 1), 0.2, registry=reg)
        for _ in range(6):
            dp.record_dispatch("solve.kernel", ("fam", 1), 0.001,
                               registry=reg)
        assert dumps_in(P.dir) == []
        with P.obs.round_trace("provision", registry=reg):
            with P.obs.span("solve.kernel", kind="device"):
                dp.record_dispatch("solve.kernel", ("fam", 2), 0.3,
                                   registry=reg)
        assert len(dumps_in(P.dir)) == 1
        assert reg.counter(P.m.TRACE_ANOMALIES).value(
            kind="cold-compile-in-steady-state") == 1
        with P.obs.round_trace("provision", registry=reg):
            with P.obs.span("solve.kernel", kind="device"):
                dp.record_dispatch("solve.kernel", ("fam", 2), 0.001,
                                   registry=reg)
        assert len(dumps_in(P.dir)) == 1

    def test_first_key_of_new_family_is_exempt_in_steady_state(self, P):
        dp, reg = P.devplane, P.Registry()
        dp.LEDGER.steady_after = 4
        dp.record_dispatch("solve.kernel", ("s", 1), 0.1, registry=reg)
        for _ in range(6):
            dp.record_dispatch("solve.kernel", ("s", 1), 0.001, registry=reg)
        with P.obs.round_trace("disrupt", registry=reg):
            with P.obs.span("probe.kernel", kind="device"):
                dp.record_dispatch("probe.kernel", ("p", 1), 0.2,
                                   registry=reg)
        assert dumps_in(P.dir) == []
        for _ in range(6):
            dp.record_dispatch("probe.kernel", ("p", 1), 0.001, registry=reg)
        with P.obs.round_trace("disrupt", registry=reg):
            with P.obs.span("probe.kernel", kind="device"):
                dp.record_dispatch("probe.kernel", ("p", 2), 0.2,
                                   registry=reg)
        assert len(dumps_in(P.dir)) == 1

    def test_early_cold_compiles_are_not_anomalous(self, P):
        dp, reg = P.devplane, P.Registry()
        dp.LEDGER.steady_after = 50
        with P.obs.round_trace("provision", registry=reg):
            with P.obs.span("x"):
                for i in range(5):
                    dp.record_dispatch("solve.kernel", ("g", i), 0.1,
                                       registry=reg)
        assert dumps_in(P.dir) == []
        assert reg.counter(P.m.COMPILE_EVENTS).value(
            family="solve.kernel") == 5


class TestPaddingWaste:
    def test_ratio_math_and_histogram_site_label(self, P):
        dp, reg = P.devplane, P.Registry()
        assert dp.record_padding("solve.bins", 30, 64, registry=reg) == \
            pytest.approx(1.0 - 30 / 64)
        assert dp.record_padding("probe.rows", 4, 4, registry=reg) == 0.0
        h = reg.histogram(P.m.PAD_WASTE_RATIO)
        assert h.count(site="solve.bins") == 1
        assert h.count(site="probe.rows") == 1
        assert dp.STATS["pad_dispatches"] == 2

    def test_degenerate_extents_clamp(self, P):
        dp, reg = P.devplane, P.Registry()
        assert dp.record_padding("solve.bins", 0, 0, registry=reg) == 0.0
        assert dp.record_padding("solve.bins", 100, 50, registry=reg) == 0.0


class TestSolverIntegration:
    def _inputs(self, P, n_pods=24, n_types=16):
        k = P.kit
        pods = [k.pod(f"p{i}", cpu=0.5 + (i % 3) * 0.25)
                for i in range(n_pods)]
        tpl = P.mod("models").ClaimTemplate(k.nodepool())
        cat = P.mod("cloudprovider.catalog").benchmark_catalog(n_types)
        return pods, [tpl], {"default": cat}

    def test_warm_repeat_solve_reports_zero_cold_compiles(self, P):
        pods, tpls, its = self._inputs(P)
        s = _solver(P)
        s.solve([p.clone() for p in pods], tpls, its)
        first = dict(s.last_device_stats)
        s.solve([p.clone() for p in pods], tpls, its)
        second = dict(s.last_device_stats)
        assert first["cold_compiles"] >= 1
        assert second["cold_compiles"] == 0
        assert 0.0 <= second["pad_waste_ratio"] <= 1.0

    def test_probe_dispatch_records_row_padding_and_family(self, P):
        env = config4_env(P.root, 4)
        env.disruption.poll_period = 0.0
        env.clock.step(20.0)
        env.disruption.poll()
        h = env.registry.histogram(P.m.PAD_WASTE_RATIO)
        assert h.count(site="probe.rows") >= 1
        assert env.registry.counter(P.m.COMPILE_EVENTS).value(
            family="probe.kernel") >= 1


class TestSloTracker:
    def test_quantiles_budget_and_snapshot(self, P):
        reg = P.Registry()
        t = P.devplane.slo_tracker("svc", latency_slo=0.2, objective=0.9)
        for ms in (10, 20, 30, 40, 50):
            t.observe(ms / 1000.0, registry=reg)
        t.observe(0.5, registry=reg)
        t.observe(0.01, outcome="error", registry=reg)
        snap = P.devplane.slo_snapshot()["slo"]["svc"]
        assert snap["count"] == 7 and snap["errors"] == 1
        assert snap["budget_burned"] == 2
        assert snap["p50_ms"] <= snap["p95_ms"] <= snap["p99_ms"]
        h = reg.histogram(P.m.SOLVER_REQUEST_SECONDS)
        assert h.count(outcome="ok") == 6 and h.count(outcome="error") == 1
        assert reg.counter(P.m.SLO_BUDGET_BURN).value(slo="svc") == 2
        assert reg.gauge(P.m.SOLVER_REQUEST_QUANTILE).value(
            slo="svc", q="p99") > 0

    def test_tenant_sub_window(self, P):
        reg = P.Registry()
        t = P.devplane.slo_tracker("svc")
        t.observe(0.01, registry=reg, tenant="acme")
        t.observe(0.03, registry=reg, tenant="acme")
        snap = P.devplane.slo_snapshot()["slo"]["svc"]
        assert snap["tenants"]["acme"]["count"] == 2
        assert reg.counter(P.m.SOLVER_TENANT_REQUESTS).value(
            slo="svc", tenant="acme", outcome="ok") == 2

    def test_slo_endpoint_serves_snapshot_json(self, P):
        serve_metrics = P.mod("__main__").serve_metrics
        P.devplane.slo_tracker("svc").observe(0.01)
        server = serve_metrics(P.Registry(), 0, host="127.0.0.1")
        try:
            port = server.server_address[1]
            doc = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/slo", timeout=5).read().decode())
            assert "svc" in doc["slo"] and "compile_ledger" in doc
            assert urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=5
            ).read().decode() == "ok"
        finally:
            server.shutdown()
            server.server_close()


# ---------------------------------------------------------------------------
# the decision plane (tests/test_decisions.py)
# ---------------------------------------------------------------------------

def test_site_registries_match_but_for_the_engine_rung():
    """The port's closed enums are the JAX package's, with ``device`` in
    ``xla``'s ladder position of ``solver.route``."""
    jsites = _ns("jax").decisions.SITES
    tsites = _ns("port").decisions.SITES
    assert set(jsites) == set(tsites)
    for site in jsites:
        j, t = jsites[site], tsites[site]
        want = tuple("device" if r == "xla" else r for r in j["rungs"])
        assert t["rungs"] == want, site
        assert t["reasons"] == j["reasons"], site
        assert t.get("benign") == j.get("benign"), site


class TestSiteMatrix:
    def test_every_site_rung_and_reason_is_recordable(self, P):
        d, reg = P.decisions, P.Registry()
        n = 0
        for site, spec in d.SITES.items():
            for rung in spec["rungs"]:
                for reason in sorted(spec["reasons"]):
                    assert d.record_decision(site, rung, reason,
                                             registry=reg) == reason
                    n += 1
        counts = d.counts()
        assert sum(counts.values()) == n
        for site, spec in d.SITES.items():
            for rung in spec["rungs"]:
                for reason in spec["reasons"]:
                    assert counts[(site, rung, reason)] == 1
                    assert reg.counter(P.m.DECISION_TOTAL).value(
                        site=site, rung=rung, reason=reason) == 1

    def test_unknown_reason_clamps_to_other(self, P):
        d, reg = P.decisions, P.Registry()
        assert d.record_decision("session.sync", "resync",
                                 "SomeNovelServerError",
                                 registry=reg) == "other"
        c = reg.counter(P.m.DECISION_TOTAL)
        assert c.value(site="session.sync", rung="resync",
                       reason="other") == 1
        assert c.value(site="session.sync", rung="resync",
                       reason="SomeNovelServerError") == 0

    def test_unknown_site_and_rung_raise(self, P):
        with pytest.raises(ValueError):
            P.decisions.record_decision("no.such.site", "x")
        with pytest.raises(ValueError):
            P.decisions.record_decision("mesh.partition", "no-such-rung")
        other = "device" if P.pkg == "jax" else "xla"
        with pytest.raises(ValueError):
            P.decisions.record_decision("solver.route", other)

    def test_canonical_reason_and_rank_helpers(self, P):
        d = P.decisions
        assert d.canonical_reason("mesh.partition", "") == "ok"
        assert d.canonical_reason("mesh.partition", None) == "ok"
        assert d.canonical_reason("mesh.partition", "min-values") == \
            "min-values"
        assert d.canonical_reason("mesh.partition", "???") == "other"
        assert d.rung_rank("mesh.partition", "partitioned") == 0
        assert d.rung_rank("mesh.partition", "bogus") == 3
        assert d.rung_rank("solver.route", P.DEV) == 3

    def test_rung_delta_between_snapshots(self, P):
        d = P.decisions
        c0 = d.counts()
        d.record_decision("solver.route", P.DEV)
        d.record_decision("solver.route", P.DEV)
        d.record_decision("decode.recheck", "skip")
        assert d.rung_delta(c0, d.counts()) == {
            "solver.route": {P.DEV: 2}, "decode.recheck": {"skip": 1}}

    def test_record_attaches_to_open_round_trace(self, P):
        with P.obs.round_trace("demo") as tr:
            P.decisions.record_decision("solver.route", "native",
                                        "small-batch")
            P.decisions.record_decision("solver.route", "native",
                                        "small-batch")
        assert tr.decisions == {("solver.route", "native", "small-batch"): 2}
        with open(P.obs.RECORDER.dump(tr)) as f:
            doc = json.load(f)
        assert doc["otherData"]["decisions"] == [
            {"site": "solver.route", "rung": "native",
             "reason": "small-batch", "n": 2}]

    def test_short_circuit_reasons_stay_registered_and_benign(self, P):
        sites = P.decisions.SITES
        assert "joint-seeded" in sites["probe.confirm"]["reasons"]
        assert "joint-noop-fenced" in sites["consolidate.global"]["reasons"]
        assert "joint-noop-fenced" in sites["consolidate.global"]["benign"]


class TestRungRegression:
    def _anoms(self, P, reg):
        return reg.counter(P.m.TRACE_ANOMALIES).value(kind="rung-regression")

    def test_steady_downgrade_fires_exactly_once(self, P):
        led, reg = P.decisions.DecisionLedger(steady_after=3), P.Registry()
        for _ in range(3):
            led.record("mesh.partition", "partitioned", registry=reg)
        led.record("mesh.partition", "replicated", "existing-nodes",
                   registry=reg)
        assert self._anoms(P, reg) == 1
        for _ in range(5):
            led.record("mesh.partition", "replicated", "existing-nodes",
                       registry=reg)
        assert self._anoms(P, reg) == 1

    def test_first_sight_exemption(self, P):
        led, reg = P.decisions.DecisionLedger(steady_after=1), P.Registry()
        led.record("mesh.partition", "unsharded", "degenerate-mesh",
                   registry=reg)
        assert self._anoms(P, reg) == 0

    def test_short_streak_does_not_fire(self, P):
        led, reg = P.decisions.DecisionLedger(steady_after=4), P.Registry()
        for _ in range(3):
            led.record("solver.route", P.DEV, registry=reg)
        led.record("solver.route", "host", "no-eligible", registry=reg)
        assert self._anoms(P, reg) == 0

    def test_refires_after_recovery_and_new_streak(self, P):
        led, reg = P.decisions.DecisionLedger(steady_after=2), P.Registry()
        for _ in range(2):
            led.record("session.sync", "delta", registry=reg)
        led.record("session.sync", "resync", "journal-gap", registry=reg)
        assert self._anoms(P, reg) == 1
        for _ in range(2):
            led.record("session.sync", "delta", registry=reg)
        led.record("session.sync", "resync", "opaque-delta", registry=reg)
        assert self._anoms(P, reg) == 2

    def test_benign_reason_neither_fires_nor_breaks_the_streak(self, P):
        led, reg = P.decisions.DecisionLedger(steady_after=3), P.Registry()
        for _ in range(3):
            led.record("session.sync", "delta", registry=reg)
        led.record("session.sync", "resync", "initial", registry=reg)
        assert self._anoms(P, reg) == 0
        led.record("session.sync", "delta", registry=reg)
        led.record("session.sync", "resync", "journal-gap", registry=reg)
        assert self._anoms(P, reg) == 1

    def test_calibrated_routing_flip_is_benign(self, P):
        led, reg = P.decisions.DecisionLedger(steady_after=2), P.Registry()
        for _ in range(4):
            led.record("solver.route", "native", "small-batch", registry=reg)
        led.record("solver.route", P.DEV, registry=reg)
        assert self._anoms(P, reg) == 0
        led.record("solver.route", "host", "no-eligible", registry=reg)
        assert self._anoms(P, reg) == 1

    def test_upgrade_never_fires(self, P):
        led, reg = P.decisions.DecisionLedger(steady_after=1), P.Registry()
        for _ in range(4):
            led.record("solver.route", "native", "small-batch", registry=reg)
        led.record("solver.route", "mesh", registry=reg)
        assert self._anoms(P, reg) == 0

    def test_forced_steady_state_downgrade_dumps_exactly_one_trace(
            self, P, monkeypatch):
        monkeypatch.setenv("KARPENTER_RUNG_STEADY_AFTER", "3")
        d = P.decisions
        d.reset()
        reg = P.Registry()
        for i in range(3):
            with P.obs.round_trace(f"disrupt-{i}", registry=reg):
                d.record_decision("snapshot.advance", "delta", registry=reg)
        assert dumps_in(P.dir) == []
        with P.obs.round_trace("disrupt-downgrade", registry=reg):
            d.record_decision("snapshot.advance", "rebuild", "opaque-entry",
                              registry=reg)
        newest = dumps_in(P.dir)
        assert len(newest) == 1 and "disrupt-downgrade" in newest[0]
        with open(os.path.join(P.dir, newest[0])) as f:
            assert "rung-regression" in json.load(f)["otherData"][
                "anomalies"]


class TestQualityAccount:
    def _drifts(self, P, reg):
        return reg.counter(P.m.TRACE_ANOMALIES).value(
            kind="solve-overhead-drift")

    def _led(self, P, steady=3, tol=0.1, min_floor=0):
        led = P.decisions.DecisionLedger()
        led.q_steady_after, led.q_tol, led.q_min_floor = steady, tol, \
            min_floor
        return led

    def test_gauge_and_series(self, P):
        reg = P.Registry()
        ratio = P.decisions.record_quality(12, 10, family="64x64",
                                           registry=reg)
        assert ratio == pytest.approx(1.2)
        assert reg.gauge(P.m.SOLVE_OVERHEAD_RATIO).value(
            family="64x64") == pytest.approx(1.2)
        q = P.decisions.DECISIONS.quality_summary()
        assert (q["series"][-1]["nodes"], q["series"][-1]["floor"]) == (12,
                                                                        10)

    def test_steady_state_drift_fires_exactly_once(self, P):
        led, reg = self._led(P), P.Registry()
        for _ in range(3):
            led.observe_quality(10, 10, family="f", registry=reg)
        led.observe_quality(14, 10, family="f", registry=reg)
        assert self._drifts(P, reg) == 1
        led.observe_quality(14, 10, family="f", registry=reg)
        assert self._drifts(P, reg) == 1
        for _ in range(3):
            led.observe_quality(10, 10, family="f", registry=reg)
        led.observe_quality(14, 10, family="f", registry=reg)
        assert self._drifts(P, reg) == 2

    def test_no_drift_without_steady_streak(self, P):
        led, reg = self._led(P, steady=4), P.Registry()
        led.observe_quality(10, 10, family="f", registry=reg)
        led.observe_quality(14, 10, family="f", registry=reg)
        assert self._drifts(P, reg) == 0

    def test_small_floors_never_arm_the_detector(self, P):
        led, reg = self._led(P, steady=1, min_floor=8), P.Registry()
        for _ in range(5):
            led.observe_quality(1, 1, family="toy", registry=reg)
        led.observe_quality(3, 1, family="toy", registry=reg)
        assert self._drifts(P, reg) == 0

    def test_families_isolated(self, P):
        led, reg = self._led(P, steady=2), P.Registry()
        for _ in range(2):
            led.observe_quality(10, 10, family="a", registry=reg)
        led.observe_quality(30, 10, family="b", registry=reg)
        assert self._drifts(P, reg) == 0


def _burst(P, n, cpu=None):
    k = P.kit
    return [k.pod(f"p{i}", cpu=cpu if cpu else 0.5 + (i % 4) * 0.5)
            for i in range(n)]


class TestSolverRouteInvocations:
    def _solve(self, P, pods, with_template=True, n_types=8):
        k = P.kit
        s = _solver(P)
        tpls = [P.mod("models").ClaimTemplate(k.nodepool())] \
            if with_template else []
        its = {"default": P.mod("cloudprovider.catalog").benchmark_catalog(
            n_types)} if with_template else {}
        res = s.solve([p.clone() for p in pods], tpls, its)
        return s, res

    def test_device_solve_records_exactly_one_route(self, P):
        d = P.decisions
        c0 = d.counts()
        self._solve(P, _burst(P, 6))
        assert d.rung_delta(c0, d.counts())["solver.route"] == {P.DEV: 1}

    def test_no_templates_records_host_rung(self, P):
        d = P.decisions
        c0 = d.counts()
        self._solve(P, _burst(P, 2), with_template=False)
        assert d.rung_delta(c0, d.counts())["solver.route"] == {"host": 1}
        assert d.counts()[("solver.route", "host", "no-templates")] >= 1

    def test_decode_recheck_records_per_compat_entry(self, P):
        d = P.decisions
        c0 = d.counts()
        _, res = self._solve(P, _burst(P, 6))
        assert res.all_pods_scheduled()
        assert set(d.rung_delta(c0, d.counts()).get("decode.recheck",
                                                     {})) == {"skip"}

    def test_retry_bearing_solve_records_no_quality(self, P):
        k = P.kit
        pods = _burst(P, 4) + [k.Pod(metadata=k.ObjectMeta(name="whale"),
                                     requests={"cpu": 100000.0,
                                               "memory": GIB})]
        q = P.decisions.DECISIONS.quality_summary
        series0 = len(q()["series"])
        s, res = self._solve(P, pods)
        assert s.last_device_stats["retry_pods"] >= 1 or res.pod_errors
        assert len(q()["series"]) == series0

    def test_quality_recorded_per_sized_solve(self, P):
        q = P.decisions.DECISIONS.quality_summary
        series0 = len(q()["series"])
        self._solve(P, _burst(P, 6))
        series = q()["series"]
        assert len(series) == series0 + 1
        assert series[-1]["family"] == "16x16"

    def test_last_device_stats_carry_the_device_plane_deltas(self, P):
        s, _ = self._solve(P, _burst(P, 6))
        st = s.last_device_stats
        assert st["cold_compiles"] == 1
        assert st["pad_waste_ratio"] == pytest.approx(1.0 - 6 * 8 * 64 / (
            16 * 16 * 64), abs=0.2)
        assert "route" not in st


class _FakeBundle:
    def __init__(self, generation, build_key, ok=True, refusal=None):
        self.generation = generation
        self.build_key = set(build_key)
        self._ok = ok
        self.advance_refusal = None
        self._refusal = refusal

    def advance(self, cluster, store, deltas, generation, registry=None):
        if self._ok:
            self.generation = generation
            return True
        self.advance_refusal = self._refusal
        return False


class _FakeCluster:
    def __init__(self, generation, deltas=()):
        self._generation = generation
        self._deltas = deltas

    def consolidation_state(self):
        return self._generation

    def deltas_since(self, g):
        return self._deltas


def _cand(pid):
    return SimpleNamespace(provider_id=pid)


class TestSnapshotAdvanceInvocations:
    def test_delta_advance_records_delta(self, P):
        d = P.decisions
        cache = P.mod("ops.consolidate").SnapshotCache()
        cache._bundle = _FakeBundle(1, {"a"}, ok=True)
        c0 = d.counts()
        assert cache.get(None, _FakeCluster(2), None,
                         [_cand("a")]) is cache._bundle
        assert d.rung_delta(c0, d.counts())["snapshot.advance"] == {
            "delta": 1}

    def test_refresh_advance_records_delta(self, P):
        d = P.decisions
        cache = P.mod("ops.consolidate").SnapshotCache()
        cache._bundle = _FakeBundle(1, {"a"}, ok=True)
        c0 = d.counts()
        assert cache.refresh(None, _FakeCluster(2), None) is cache._bundle
        assert d.rung_delta(c0, d.counts())["snapshot.advance"] == {
            "delta": 1}

    @pytest.mark.parametrize("case", ["churn", "journal-gap",
                                      "candidate-widened"])
    def test_rebuild_records_its_cause(self, P, monkeypatch, case):
        d = P.decisions
        cz = P.mod("ops.consolidate")
        cache = cz.SnapshotCache()
        cands = [_cand("a")]
        cluster = _FakeCluster(2)
        if case == "churn":
            cache._bundle = _FakeBundle(1, {"a"}, ok=False, refusal="churn")
        elif case == "journal-gap":
            cache._bundle = _FakeBundle(1, {"a"})
            cluster = _FakeCluster(2, deltas=None)
        else:
            cache._bundle = _FakeBundle(2, {"a"})
            cands = [_cand("a"), _cand("b")]
        rebuilt = _FakeBundle(2, {"a", "b"})
        monkeypatch.setattr(cz, "build_disruption_snapshot",
                            lambda *a, **k: rebuilt)
        c0 = d.counts()
        assert cache.get(None, cluster, None, cands) is rebuilt
        assert d.rung_delta(c0, d.counts())["snapshot.advance"] == {
            "rebuild": 1}
        assert d.counts()[("snapshot.advance", "rebuild", case)] == 1

    def test_first_build_and_hit_record_nothing(self, P, monkeypatch):
        d = P.decisions
        cz = P.mod("ops.consolidate")
        cache = cz.SnapshotCache()
        monkeypatch.setattr(cz, "build_disruption_snapshot",
                            lambda *a, **k: _FakeBundle(2, {"a"}))
        c0 = d.counts()
        cache.get(None, _FakeCluster(2), None, [_cand("a")])
        cache.get(None, _FakeCluster(2), None, [_cand("a")])
        assert d.rung_delta(c0, d.counts()) == {}


class TestProbeConfirmInvocations:
    def _ctx(self, P):
        return SimpleNamespace(
            clock=SimpleNamespace(now=lambda: 0.0), registry=P.Registry(),
            provisioner=SimpleNamespace(solver=_solver(P)),
            cluster=None, store=None, snapshot_cache=None)

    def _methods(self, P):
        return P.mod("controllers.disruption.methods")

    @pytest.mark.parametrize("case", ["no-device", "inexpressible",
                                      "probe-error"])
    def test_sequential_verdicts(self, P, case):
        d = P.decisions
        ctx = self._ctx(P)
        probe = lambda *a, **k: None  # noqa: E731
        if case == "no-device":
            ctx.provisioner = SimpleNamespace(solver=object())
        elif case == "probe-error":
            def probe(*a, **k):
                raise KeyError("probe died")
        c0 = d.counts()
        assert self._methods(P)._device_probe(ctx, probe, "multi", [],
                                              []) is None
        assert d.rung_delta(c0, d.counts())["probe.confirm"] == {
            "sequential": 1}
        assert d.counts()[("probe.confirm", "sequential", case)] == 1

    def _cands(self, P, n=4):
        np_mod = P.mod("api.nodepool")
        pool = SimpleNamespace(name="default", spec=SimpleNamespace(
            disruption=SimpleNamespace(
                consolidation_policy=np_mod.CONSOLIDATION_WHEN_UNDERUTILIZED)))
        return ([SimpleNamespace(node_pool=pool, disruption_cost=float(i),
                                 provider_id=f"n{i}") for i in range(n)],
                {"default": {np_mod.REASON_UNDERUTILIZED: n}})

    def _confirm(self, P):
        Command = P.mod("controllers.disruption.types").Command
        return lambda prefix: (Command(list(prefix), reason="Underutilized")
                               if len(prefix) >= 2 else None)

    @pytest.mark.parametrize("probed,want", [
        ((4, True), ("definitive", "ok")),
        ((2, False), ("gallop", "non-definitive"))])
    def test_ladder_verdicts(self, P, probed, want):
        d = P.decisions
        cands, budgets = self._cands(P)
        meth = self._methods(P).MultiNodeConsolidation(self._ctx(P))
        meth._probe = lambda cands, pool=None: probed
        meth._confirm = self._confirm(P)
        c0 = d.counts()
        meth.compute_command(cands, budgets)
        assert d.rung_delta(c0, d.counts())["probe.confirm"] == {want[0]: 1}
        assert d.counts()[("probe.confirm",) + want] == 1

    def _seeded_ctx(self, P, cands, single_mask):
        JointSeed = P.mod("ops.consolidate").JointSeed
        ctx = self._ctx(P)
        ctx.cluster = SimpleNamespace(consolidation_state=lambda: 42)
        ctx.joint_seed = JointSeed(
            42, [c.provider_id for c in cands],
            np.array([True] * len(cands)), True, np.array(single_mask))
        return ctx

    def test_multi_seeded_probe_records_joint_seeded(self, P):
        d = P.decisions
        cands, budgets = self._cands(P)
        meth = self._methods(P).MultiNodeConsolidation(
            self._seeded_ctx(P, cands, [True, False, False, False]))
        meth._confirm = self._confirm(P)
        cmd = meth.compute_command(cands, budgets)
        assert cmd is not None and len(cmd.candidates) == 4
        assert meth.last_probe == "seeded"
        assert d.counts()[("probe.confirm", "definitive",
                           "joint-seeded")] == 1

    def test_single_seeded_probe_records_joint_seeded(self, P):
        d = P.decisions
        Command = P.mod("controllers.disruption.types").Command
        cands, budgets = self._cands(P, 3)
        meth = self._methods(P).SingleNodeConsolidation(
            self._seeded_ctx(P, cands, [True, False, False]))
        meth._confirm_one = lambda c: Command([c], reason="Underutilized")
        cmd = meth.compute_command(cands, budgets)
        assert cmd is not None and len(cmd.candidates) == 1
        assert meth.last_probe == "seeded"
        assert d.counts()[("probe.confirm", "definitive",
                           "joint-seeded")] == 1

    def test_stale_seed_declines_and_device_probe_records_ok(self, P):
        d = P.decisions
        methods = self._methods(P)
        cands, budgets = self._cands(P)
        ctx = self._seeded_ctx(P, cands, [True, False, False, False])
        ctx.cluster = SimpleNamespace(consolidation_state=lambda: 43)
        assert methods._seed_answer(ctx, cands, "prefix") is None
        meth = methods.MultiNodeConsolidation(ctx)
        meth._probe = lambda cs, pool=None: (4, True)
        meth._confirm = self._confirm(P)
        meth.compute_command(cands, budgets)
        assert meth.last_probe == "device"
        assert d.counts()[("probe.confirm", "definitive", "ok")] == 1


class TestIntrospection:
    def _populate(self, P, reg):
        with P.obs.round_trace("provision", registry=reg):
            P.decisions.record_decision("solver.route", P.DEV, registry=reg)
            P.decisions.record_decision("decode.recheck", "skip",
                                        registry=reg)
        P.decisions.record_quality(12, 10, family="64x64", registry=reg)

    def test_round_ring_holds_rung_summaries(self, P):
        self._populate(P, P.Registry())
        rounds = P.decisions.DECISIONS.rounds()
        assert rounds[-1]["round"] == "provision"
        assert rounds[-1]["decisions"]["solver.route"][P.DEV]["ok"] == 1

    def test_introspect_snapshot_shape(self, P):
        self._populate(P, P.Registry())
        snap = P.decisions.introspect_snapshot()
        assert set(snap) == {"sites", "rounds", "quality", "tenants",
                             "anomalies", "capsules", "timeline"}
        assert snap["sites"]["solver.route"]["last"]["rung"] == P.DEV
        assert snap["quality"]["series"]
        json.dumps(snap)

    def test_introspect_endpoint(self, P):
        serve_metrics = P.mod("__main__").serve_metrics
        reg = P.Registry()
        self._populate(P, reg)
        server = serve_metrics(reg, 0, host="127.0.0.1")
        try:
            port = server.server_address[1]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/introspect", timeout=10) as r:
                doc = json.loads(r.read().decode())
            assert doc["sites"]["solver.route"]["rungs"][P.DEV]["ok"] == 1
            assert doc["rounds"][-1]["round"] == "provision"
        finally:
            server.shutdown()
            server.server_close()

    def test_report_cli_smoke(self, P, capsys):
        reg = P.Registry()
        self._populate(P, reg)
        P.decisions.record_decision("mesh.partition", "replicated",
                                    "existing-nodes", registry=reg,
                                    tenant="acme")
        snap = P.decisions.introspect_snapshot()
        text = P.cli.render_report(snap)
        assert "solver.route" in text and "mesh.partition" in text
        assert "existing-nodes" in text and "acme" in text
        path = P.dir / "introspect.json"
        path.write_text(json.dumps(snap))
        assert P.cli.main(["report", "--file", str(path)]) == 0
        out = capsys.readouterr().out
        assert "decision plane" in out and "solver.route" in out

    def test_report_cli_in_process_source(self, P, capsys):
        P.decisions.record_decision("solver.route", "native", "small-batch")
        assert P.cli.main(["report"]) == 0
        assert "solver.route" in capsys.readouterr().out

    def test_report_renders_alike(self, P):
        """The port's renderer is the JAX package's: the same snapshot
        renders to the same text in both."""
        self._populate(P, P.Registry())
        snap = P.decisions.introspect_snapshot()
        other = _ns("jax" if P.pkg == "port" else "port").cli
        for timeline in (False, True):
            assert P.cli.render_report(snap, timeline=timeline) == \
                other.render_report(snap, timeline=timeline)


def test_port_replay_is_refused(capsys):
    """Since replay capsules are ported the port's ``replay`` no longer
    refuses with exit 2: a capsule it cannot load exits 1, as the JAX
    package's CLI does (the replay cases: ``tests/test_torch_capsule.py``)."""
    from karpenter_tpu.obs.__main__ import main as jmain
    from karpenter_tpu_torch.obs.__main__ import main

    assert main(["replay", "x.capsule.npz", "--ab"]) == 1
    err = capsys.readouterr().err
    assert err.startswith("replay: ") and "x.capsule.npz" in err
    assert jmain(["replay", "x.capsule.npz", "--ab"]) == 1


# ---------------------------------------------------------------------------
# the fleet timeline (tests/test_timeline.py)
# ---------------------------------------------------------------------------

def _offering(price=1.0, risk=None):
    return SimpleNamespace(price=price, interruption_risk=risk)


class _Catalog:
    def __init__(self, prices):
        self.prices = prices

    def offering(self, labels):
        p = self.prices.get(labels.get("node.kubernetes.io/instance-type"))
        return _offering(p) if p is not None else None


def _node(name, itype="small", pool="default", zone="z1", ctype="on-demand"):
    return SimpleNamespace(name=name, labels={
        "node.kubernetes.io/instance-type": itype,
        "karpenter.sh/nodepool": pool,
        "topology.kubernetes.io/zone": zone,
        "karpenter.sh/capacity-type": ctype,
    })


class TestTimelineEvents:
    def test_event_kinds_match(self):
        assert _ns("port").timeline.EVENT_KINDS == \
            _ns("jax").timeline.EVENT_KINDS

    def test_every_kind_records_and_counts(self, P):
        tl, reg = P.timeline, P.Registry()
        for kind in tl.EVENT_KINDS:
            tl.record_event(kind, f"node-{kind}", registry=reg)
        snap = tl.timeline_snapshot()
        assert snap["ring"]["size"] == len(tl.EVENT_KINDS)
        assert snap["ring"]["kinds"] == {k: 1 for k in tl.EVENT_KINDS}
        for kind in tl.EVENT_KINDS:
            assert reg.counter(P.m.TIMELINE_EVENTS).value(kind=kind) == 1

    def test_unknown_kind_raises(self, P):
        with pytest.raises(ValueError):
            P.timeline.record_event("reboot", "node-1")

    def test_attrs_and_cause_ride_the_event(self, P):
        ev = P.timeline.record_event(
            "drain", "node-1", cause={"site": "consolidate.global",
                                      "rung": "joint", "reason": "ok",
                                      "command": "cmd-00001"},
            pods=7, registry=P.Registry())
        assert ev["pods"] == 7 and ev["cause"]["command"] == "cmd-00001"
        got = P.timeline.timeline_snapshot()["events"][-1]
        assert got["cause"]["site"] == "consolidate.global"

    def test_ring_is_bounded_and_counts_drops(self, P, monkeypatch):
        monkeypatch.setenv("KARPENTER_TIMELINE_RING", "16")
        P.timeline.reset()
        reg = P.Registry()
        for i in range(40):
            P.timeline.record_event("bind", f"node-{i}", registry=reg)
        snap = P.timeline.timeline_snapshot()
        assert (snap["ring"]["capacity"], snap["ring"]["size"],
                snap["ring"]["dropped"]) == (16, 16, 24)
        assert snap["ring"]["kinds"]["bind"] == 40
        assert snap["events"][0]["node"] == "node-24"

    def test_idle_discarded_round_commits_nothing(self, P):
        reg = P.Registry()
        with P.obs.round_trace("disrupt", registry=reg):
            P.timeline.record_event("drain", "node-1")
            P.obs.discard_round()
        assert P.timeline.timeline_snapshot()["ring"]["size"] == 0
        assert reg.counter(P.m.TIMELINE_EVENTS).value(kind="drain") == 0

    def test_kept_round_commits_with_trace_id(self, P):
        reg = P.Registry()
        with P.obs.round_trace("disrupt", registry=reg):
            tid = P.obs.current_trace_id()
            P.timeline.record_event("drain", "node-1")
            assert P.timeline.timeline_snapshot()["ring"]["size"] == 0
        snap = P.timeline.timeline_snapshot()
        assert snap["ring"]["size"] == 1
        assert snap["events"][0]["trace_id"] == tid

    def test_no_open_round_commits_directly(self, P):
        P.timeline.record_event("register", "node-1", registry=P.Registry())
        snap = P.timeline.timeline_snapshot()
        assert snap["ring"]["size"] == 1
        assert snap["events"][0]["trace_id"] is None


class TestCauseLinks:
    def test_launch_pops_staged_cause_and_reconciles(self, P):
        tl, reg = P.timeline, P.Registry()
        cmd_id = tl.begin_command(
            site="consolidate.global", rung="joint", reason="underutilized",
            predicted=3.0, retired_rate=5.0, claims=["claim-a"],
            nodes=["old-1"], registry=reg)
        cause = {"site": "consolidate.global", "rung": "joint",
                 "reason": "underutilized", "command": cmd_id}
        tl.pend_cause("claim-a", cause)
        ev = tl.note_launch("claim-a", node="new-1", price=2.0, registry=reg)
        assert ev["cause"]["command"] == cmd_id and ev["claim"] == "claim-a"
        assert tl.timeline_snapshot()["commands"]["pending"] == 1
        tl.record_event("retire", "old-1", registry=reg)
        snap = tl.timeline_snapshot()
        assert snap["commands"]["pending"] == 0
        rec = snap["commands"]["reconciled"][-1]
        assert rec["command"] == cmd_id and rec["ok"] is True
        assert rec["realized"] == pytest.approx(3.0)
        assert P.decisions.counts()[
            ("fleet.reconcile", "within", "consolidation")] == 1
        assert reg.counter(P.m.FLEET_SAVINGS_PREDICTED).value(
            site="consolidate.global") == pytest.approx(3.0)
        assert reg.counter(P.m.FLEET_SAVINGS_REALIZED).value(
            site="consolidate.global") == pytest.approx(3.0)

    def test_unpriced_command_records_without_verdict(self, P):
        tl, reg = P.timeline, P.Registry()
        tl.begin_command(site="consolidate.global", rung="ladder",
                         reason="underutilized", predicted=None,
                         retired_rate=2.0, nodes=["old-1"], registry=reg)
        tl.record_event("retire", "old-1", registry=reg)
        assert tl.timeline_snapshot()["commands"]["reconciled"][-1][
            "ok"] is None
        assert ("fleet.reconcile", "within", "consolidation") not in \
            P.decisions.counts()

    def test_interruption_site_maps_to_interruption_reason(self, P):
        tl, reg = P.timeline, P.Registry()
        tl.begin_command(site="disrupt.interruption", rung="proactive",
                         reason="interrupted", predicted=1.0,
                         retired_rate=1.0, nodes=["spot-1"], registry=reg)
        tl.record_event("retire", "spot-1", registry=reg)
        assert P.decisions.counts()[
            ("fleet.reconcile", "within", "interruption")] == 1

    def test_vanished_node_self_heals_reconciliation(self, P):
        tl, reg = P.timeline, P.Registry()
        cat = _Catalog({"small": 1.0})
        tl.observe_fleet([_node("old-1")], cat, 0.0, registry=reg)
        tl.begin_command(site="consolidate.global", rung="joint",
                         reason="underutilized", predicted=1.0,
                         retired_rate=1.0, nodes=["old-1"], registry=reg)
        tl.observe_fleet([], cat, 60.0, registry=reg)
        assert tl.timeline_snapshot()["commands"]["pending"] == 0


class TestSavingsDrift:
    def _reconcile(self, P, reg, predicted, realized, n=1):
        for _ in range(n):
            P.seq = getattr(P, "seq", 0) + 1
            node = f"n-{P.seq}"
            P.timeline.begin_command(
                site="consolidate.global", rung="joint",
                reason="underutilized", predicted=predicted,
                retired_rate=realized, nodes=[node], registry=reg)
            P.timeline.record_event("retire", node, registry=reg)

    def test_fires_exactly_once_per_streak_crossing(self, P, monkeypatch):
        monkeypatch.setenv("KARPENTER_SAVINGS_STEADY_AFTER", "3")
        P.timeline.reset()
        reg = P.Registry()

        def fired():
            return reg.counter(P.m.TRACE_ANOMALIES).value(
                kind="savings-drift")

        self._reconcile(P, reg, 5.0, 1.0)
        assert fired() == 0
        self._reconcile(P, reg, 1.0, 1.0, n=3)
        self._reconcile(P, reg, 5.0, 1.0, n=4)
        assert fired() == 1
        self._reconcile(P, reg, 1.0, 1.0, n=3)
        self._reconcile(P, reg, 5.0, 1.0)
        assert fired() == 2
        assert P.decisions.counts()[
            ("fleet.reconcile", "drift", "consolidation")] == 6

    def test_tolerance_is_relative(self, P, monkeypatch):
        monkeypatch.setenv("KARPENTER_SAVINGS_DRIFT_TOL", "0.5")
        P.timeline.reset()
        self._reconcile(P, P.Registry(), 2.0, 1.1)
        assert P.timeline.timeline_snapshot()["commands"]["reconciled"][
            -1]["ok"] is True


class TestRealizedCost:
    def test_integral_is_piecewise_constant_between_observations(self, P):
        tl, reg = P.timeline, P.Registry()
        cat = _Catalog({"small": 1.0, "big": 3.0})
        nodes = [_node("n1", "small"), _node("n2", "big", zone="z2")]
        out = tl.observe_fleet(nodes, cat, 0.0, registry=reg)
        assert out["live_nodes"] == 2
        assert out["live_rate"] == pytest.approx(4.0)
        assert out["realized_total"] == 0.0
        out = tl.observe_fleet(nodes, cat, 1800.0, registry=reg)
        assert out["realized_total"] == pytest.approx(2.0)
        c = reg.counter(P.m.FLEET_COST_REALIZED)
        assert c.value(nodepool="default", zone="z1",
                       capacity_type="on-demand") == pytest.approx(0.5)
        assert c.value(nodepool="default", zone="z2",
                       capacity_type="on-demand") == pytest.approx(1.5)

    def test_unpriced_nodes_are_skipped(self, P):
        out = P.timeline.observe_fleet([_node("n1", "delisted")],
                                       _Catalog({}), 0.0,
                                       registry=P.Registry())
        assert out["live_nodes"] == 0

    def test_interruption_rates_feed(self, P):
        tl, reg = P.timeline, P.Registry()
        cat = _Catalog({"small": 1.0})
        tl.observe_fleet([_node("spot-1")], cat, 0.0, registry=reg)
        tl.observe_fleet([_node("spot-1")], cat, 3600.0, registry=reg)
        tl.record_event("interrupt", "spot-1", instance_type="small",
                        zone="z1", deadline=3720.0, registry=reg)
        tl.record_event("retire", "spot-1", instance_type="small",
                        zone="z1", registry=reg)
        rates = tl.interruption_rates()["small/z1"]
        assert (rates["notices"], rates["reclaims"]) == (1, 1)
        assert rates["exposure_hours"] == pytest.approx(1.0)
        assert rates["reclaims_per_hour"] == pytest.approx(1.0)

    def test_retire_without_notice_is_not_a_reclaim(self, P):
        P.timeline.record_event("retire", "od-1", instance_type="small",
                                zone="z1", registry=P.Registry())
        assert P.timeline.interruption_rates() == {}


class TestBilling:
    def test_billed_seconds_sum_to_devplane_ledger(self, P):
        dp, reg = P.devplane, P.Registry()
        dp.record_dispatch("solver", ("k", 1), 0.25, registry=reg,
                           tenant="acme")
        dp.record_dispatch("solver", ("k", 1), 0.05, registry=reg,
                           tenant="acme")
        dp.record_dispatch("mesh", ("k", 2), 0.40, registry=reg,
                           tenant="globex")
        dp.record_dispatch("mesh", ("k", 3), 0.10, registry=reg)
        usage = P.timeline.usage_snapshot()
        assert usage["tenants"]["acme"]["device_seconds"] == \
            pytest.approx(0.30)
        assert usage["tenants"]["acme"]["dispatches"] == 2
        assert usage["tenants"]["globex"]["device_seconds"] == \
            pytest.approx(0.40)
        assert usage["tenants"]["untenanted"]["device_seconds"] == \
            pytest.approx(0.10)
        assert usage["total_device_seconds"] == pytest.approx(
            usage["devplane_dispatch_seconds"])
        assert reg.counter(P.m.TENANT_DEVICE_SECONDS).value(
            tenant="acme") == pytest.approx(0.30)
        assert reg.histogram(P.m.TENANT_DISPATCH_SECONDS).count(
            tenant="acme") == 2

    def test_open_round_tenant_attr_resolves(self, P):
        reg = P.Registry()
        with P.obs.round_trace("solver-service", registry=reg,
                               tenant="acme"):
            assert P.timeline.record_billing("solver", 0.5,
                                             registry=reg) == "acme"

    def test_drop_tenant_folds_into_dropped_and_retires_series(self, P):
        reg = P.Registry()
        P.timeline.record_billing("solver", 1.5, tenant="churn",
                                  registry=reg)
        h = reg.histogram(P.m.TENANT_DISPATCH_SECONDS)
        P.timeline.drop_tenant("churn", slo="solve", registry=reg)
        usage = P.timeline.usage_snapshot()
        assert "churn" not in usage["tenants"]
        assert usage["dropped_device_seconds"] == pytest.approx(1.5)
        assert usage["total_device_seconds"] == pytest.approx(1.5)
        assert h.count(tenant="churn") == 0

    def test_tenant_table_is_bounded(self, P):
        reg = P.Registry()
        for i in range(300):
            P.timeline.record_billing("solver", 0.01, tenant=f"t{i}",
                                      registry=reg)
        usage = P.timeline.usage_snapshot()
        assert len(usage["tenants"]) == 256
        assert usage["total_device_seconds"] == pytest.approx(3.0)

    def test_histogram_remove_parity_with_gauge(self, P):
        h = P.Registry().histogram("h_test", "help")
        h.observe(1.0, tenant="a")
        h.observe(2.0, tenant="b")
        h.remove(tenant="a")
        assert h.count(tenant="a") == 0 and h.sum(tenant="a") == 0.0
        assert h.count(tenant="b") == 1
        h.remove(tenant="missing")


class TestTimelineSurfaces:
    def test_usage_endpoint_serves_billing_json(self, P):
        serve_metrics = P.mod("__main__").serve_metrics
        P.timeline.record_billing("solver", 0.5, tenant="acme",
                                  registry=P.Registry())
        server = serve_metrics(P.Registry(), 0, host="127.0.0.1")
        try:
            port = server.server_address[1]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/usage", timeout=10) as resp:
                body = json.loads(resp.read())
        finally:
            server.shutdown()
            server.server_close()
        assert body["tenants"]["acme"]["device_seconds"] == 0.5
        assert set(body) == {"tenants", "total_device_seconds",
                             "dropped_device_seconds",
                             "devplane_dispatch_seconds"}

    def test_introspect_snapshot_carries_timeline_section(self, P):
        P.timeline.record_event("launch", "node-1", registry=P.Registry())
        snap = P.decisions.introspect_snapshot()
        assert snap["timeline"]["ring"]["size"] == 1
        json.dumps(snap)

    def test_report_timeline_rendering(self, P, capsys):
        tl, reg = P.timeline, P.Registry()
        cmd_id = tl.begin_command(
            site="consolidate.global", rung="joint", reason="underutilized",
            predicted=2.0, retired_rate=3.0, claims=["claim-a"],
            nodes=["old-1"], registry=reg)
        tl.pend_cause("claim-a", {"site": "consolidate.global",
                                  "rung": "joint", "reason": "ok",
                                  "command": cmd_id})
        tl.note_launch("claim-a", node="new-1", price=1.0, registry=reg)
        tl.record_event("retire", "old-1", registry=reg)
        tl.record_billing("solver", 0.5, tenant="acme", registry=reg)
        out = P.cli.render_timeline(P.decisions.introspect_snapshot()[
            "timeline"])
        assert "fleet ledger" in out and "launch" in out and "retire" in out
        assert f"[{cmd_id}]" in out and "within" in out and "acme" in out
        snap = P.decisions.introspect_snapshot()
        assert "fleet ledger" in P.cli.render_report(snap, timeline=True)
        assert "fleet ledger" not in P.cli.render_report(snap)
        assert P.cli.main(["report", "--timeline"]) == 0
        assert "fleet ledger" in capsys.readouterr().out

    def test_reset_clears_every_plane(self, P):
        tl, reg = P.timeline, P.Registry()
        tl.record_event("launch", "node-1", registry=reg)
        tl.record_billing("solver", 1.0, tenant="a", registry=reg)
        tl.begin_command(site="consolidate.global", nodes=["n"],
                         registry=reg)
        tl.reset()
        snap = tl.timeline_snapshot()
        assert snap["ring"]["size"] == 0
        assert snap["commands"]["pending"] == 0
        assert tl.usage_snapshot()["total_device_seconds"] == 0.0

    def test_independent_instances_do_not_share_state(self, P):
        a, b = P.timeline.FleetTimeline(), P.timeline.FleetTimeline()
        a.record_event("launch", "n1", registry=P.Registry())
        assert a.snapshot()["ring"]["size"] == 1
        assert b.snapshot()["ring"]["size"] == 0


# ---------------------------------------------------------------------------
# the port's own rules
# ---------------------------------------------------------------------------

OBS_NAMES = {"obs", "devplane", "decisions", "timeline", "span",
             "round_trace", "anomaly", "record_dispatch", "record_padding",
             "record_decision", "record_quality", "record_event"}


@pytest.mark.parametrize("rel", ["ops/kernels.py", "ops/cuda_kernels.py"])
def test_pack_loop_has_no_observability_calls(rel):
    """No span, counter or ledger call in the pack loop or the kernel
    wrappers: a call per pack step would add host work to a launch-bound
    loop (the JAX package forbids them in traced code)."""
    tree = ast.parse((ROOT / "karpenter_tpu_torch" / rel).read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] + [
                getattr(node, "module", "") or ""]
            assert not any("obs" in n.split(".") for n in names), rel
        if isinstance(node, ast.Attribute):
            assert node.attr not in OBS_NAMES - {"obs"}, (rel, node.attr)
        if isinstance(node, ast.Name):
            assert node.id not in OBS_NAMES, (rel, node.id)


def test_planes_read_knobs_through_envknobs():
    for path in sorted((ROOT / "karpenter_tpu_torch" / "obs").glob("*.py")):
        src = path.read_text()
        assert "os.environ" not in src and "getenv" not in src, path.name


@pytest.mark.parametrize("knob,attr,value", [
    ("KARPENTER_TRACE_RING", "capacity", "5"),
    ("KARPENTER_TRACE_DUMP", "dump_all", "1"),
    ("KARPENTER_TRACE_DIR", "dump_dir", "/x/y"),
])
def test_trace_knobs_resolve_like_jax(monkeypatch, knob, attr, value):
    monkeypatch.setenv(knob, value)
    for pkg in PKGS:
        tr = _ns(pkg).trace
        got = {"capacity": tr._env_capacity, "dump_all": tr._env_dump_all,
               "dump_dir": tr._env_dir}[attr]()
        want = {"capacity": 5, "dump_all": True, "dump_dir": "/x/y"}[attr]
        assert got == want, pkg
