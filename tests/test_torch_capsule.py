"""The port's replay capsules (``karpenter_tpu_torch/obs/capsule.py``)
against the JAX package's.

The cases of ``tests/test_capsule.py`` on the port's own producers
(``TorchSolver(device="cpu")``, the port's probe, server and CLI): every
anomalous round writes exactly one ``.capsule.npz`` next to its Chrome
dump, ``KARPENTER_CAPSULE`` forces or disables capture, the schema
round-trips and refuses a newer version, the byte budget refuses an
oversized capture, device / native / probe / service captures replay
``exact`` (the device rung with ``device="cpu"``), the A/B table lists
every rung, and the CLI returns the JAX package's exit codes. The
mesh cases wait for the mesh slice (ROADMAP.md Queue 1); here a JAX mesh
capsule replays on the port's device rung and the port's table names the
two mesh rungs ineligible.

Across the packages, at every seam the port captures (``solver.invoke``,
``probe.dispatch``, ``global.dispatch``, ``relax.dispatch``,
``interruption.dispatch``, ``preempt.dispatch``, ``service.solve``), on
one shared small shape built with each package's own objects:

- the port's capture equals the JAX package's: the same seam, the same
  input arrays bit for bit (names, dtypes, values), the same outputs and
  the same static fields (rung ``device`` where the JAX package says
  ``xla``). The relax seam's one difference is by design
  (``obs/capsule.py``): the port grades the decision ``k_sel`` and keeps
  the LP's ``y`` as the ``cf//rx_y`` sidecar, within 1e-4 of the JAX
  package's ``y`` (``tests/test_torch_relax.py``'s tolerance);
- a capsule the JAX package writes replays ``exact`` on the port
  (``device="cpu"``), and one the port writes replays ``exact`` on the
  JAX package.

Tolerance: exact, apart from ``rx_y`` as said.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from karpenter_tpu.obs import capsule as jcapsule
from karpenter_tpu_torch import obs
from karpenter_tpu_torch.obs import capsule, decisions
from tests.test_torch_operator import JAX, PORT, mod

GIB = 2**30
CAPS = {JAX: jcapsule, PORT: capsule}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def rec(tmp_path):
    """Isolated tracer/recorder/capsule state in a fresh dump dir."""
    obs.configure(enabled=True, dump_dir=str(tmp_path), capacity=8,
                  dump_all=False)
    obs.RECORDER.clear()
    capsule.reset()
    decisions.reset()
    obs.devplane.reset()
    yield tmp_path
    obs.reset()


def capsules_in(tmp_path) -> list:
    return sorted(p for p in os.listdir(tmp_path)
                  if p.endswith(".capsule.npz"))


def small_workload(pkg=PORT, n_pods=40, n_types=20):
    nodepool = mod(pkg, "api.nodepool")
    ob = mod(pkg, "api.objects")
    catalog = mod(pkg, "cloudprovider.catalog").benchmark_catalog(n_types)
    ClaimTemplate = mod(pkg, "models").ClaimTemplate
    pool = nodepool.NodePool(metadata=ob.ObjectMeta(name="default"))
    pods = [ob.Pod(metadata=ob.ObjectMeta(name=f"p{i}"),
                   requests={"cpu": 0.5, "memory": 1 * GIB})
            for i in range(n_pods)]
    return pods, [ClaimTemplate(pool)], {pool.name: catalog}


def solver_of(pkg):
    if pkg == JAX:
        return mod(JAX, "models").TPUSolver()
    return mod(PORT, "models").TorchSolver(device="cpu")


def solve_capturing(solver=None, pkg=PORT):
    """One small solve; returns (solver, results)."""
    solver = solver or solver_of(pkg)
    pods, templates, its = small_workload(pkg)
    res = solver.solve([p.clone() for p in pods], templates, its)
    return solver, res


# every recorder trigger (obs/trace.py docstring)
TRIGGERS = (
    "probe-fallback", "multi-host-confirms", "snapshot-rebuild",
    "host-routed", "negative-avail", "cold-compile-in-steady-state",
    "rung-regression", "solve-overhead-drift",
)


class TestCaptureLifecycle:
    def test_clean_round_writes_no_capsule(self, rec):
        with obs.round_trace("clean") as tr:
            solve_capturing()
            assert tr.capsule_pending is not None  # the cheap reference
        # a clean round releases its pending arrays at close
        assert tr.capsule_pending is None
        assert tr.capsule_path is None
        assert capsules_in(rec) == []
        assert capsule.last_capture() is not None

    def test_written_round_releases_pending(self, rec):
        with obs.round_trace("kept") as tr:
            solve_capturing()
            obs.anomaly("host-routed")
        assert tr.capsule_path is not None
        assert tr.capsule_pending is None  # on disk, not pinned in RAM

    @pytest.mark.parametrize("kind", TRIGGERS)
    def test_anomalous_round_writes_exactly_one(self, rec, kind):
        with obs.round_trace("anomalous") as tr:
            solve_capturing()
            obs.anomaly(kind)
        files = capsules_in(rec)
        assert len(files) == 1, files
        assert tr.capsule_path == os.path.join(str(rec), files[0])
        cap = capsule.load(tr.capsule_path)
        assert kind in (cap.meta.get("anomalies") or [])
        # idempotent: re-recording the trace must not mint a second file
        obs.RECORDER.record(tr)
        assert len(capsules_in(rec)) == 1

    def test_forced_rung_regression_yields_replayable_capsule(
            self, rec, monkeypatch):
        """A steady-state solver.route downgrade fires rung-regression
        through the ledger, and the round's capsule replays exactly."""
        monkeypatch.setenv("KARPENTER_RUNG_STEADY_AFTER", "4")
        decisions.reset()
        for _ in range(4):
            decisions.record_decision("solver.route", "device")
        with obs.round_trace("regressed") as tr:
            solve_capturing()  # holds the device rung (streak continues)
            decisions.record_decision("solver.route", "host", "no-templates")
        assert any(k == "rung-regression"
                   for k, _, _ in tr.anomalies), tr.anomalies
        assert tr.capsule_path is not None
        cap = capsule.load(tr.capsule_path)
        r = capsule.replay(cap, device="cpu")
        assert r["parity"] == "exact" and r["rung_match"]
        sites = {d["site"] for d in cap.meta["decisions"]}
        assert "solver.route" in sites

    def test_forced_solve_overhead_drift_yields_capsule(
            self, rec, monkeypatch):
        monkeypatch.setenv("KARPENTER_QUALITY_STEADY_AFTER", "2")
        decisions.reset()
        for _ in range(2):
            decisions.record_quality(10, 10, family="t")
        with obs.round_trace("drifting") as tr:
            solve_capturing()
            decisions.record_quality(20, 10, family="t")  # 2.0 vs 1.0
        assert any(k == "solve-overhead-drift" for k, _, _ in tr.anomalies)
        assert tr.capsule_path is not None
        assert capsule.replay(capsule.load(tr.capsule_path),
                              device="cpu")["parity"] == "exact"

    def test_forced_capture_writes_without_anomaly(self, rec, monkeypatch):
        monkeypatch.setenv("KARPENTER_CAPSULE", "1")
        with obs.round_trace("forced"):
            solve_capturing()
        files = capsules_in(rec)
        assert len(files) == 1
        cap = capsule.load(os.path.join(str(rec), files[0]))
        assert cap.meta["why"] == "forced"

    def test_capture_off_switch(self, rec, monkeypatch):
        monkeypatch.setenv("KARPENTER_CAPSULE", "0")
        with obs.round_trace("off") as tr:
            solve_capturing()
            obs.anomaly("host-routed")
        assert tr.capsule_pending is None
        assert capsules_in(rec) == []

    def test_index_and_introspect_surface(self, rec):
        with obs.round_trace("indexed"):
            solve_capturing()
            obs.anomaly("host-routed")
        idx = capsule.index()
        assert len(idx) == 1 and idx[0]["seam"] == "solver.invoke"
        assert idx[0]["engine"] == "device"
        snap = decisions.introspect_snapshot()
        assert snap["capsules"] and snap["capsules"][0]["path"].endswith(
            ".capsule.npz")
        assert snap["anomalies"][0]["capsule"] == idx[0]["path"]
        from karpenter_tpu_torch.obs.__main__ import render_report

        assert "replay capsules" in render_report(snap)

    def test_obs_reset_clears_the_index(self, rec):
        with obs.round_trace("indexed"):
            solve_capturing()
            obs.anomaly("host-routed")
        assert capsule.index()
        obs.reset()
        assert capsule.index() == [] and capsule.last_capture() is None


class TestSchema:
    def _roundtrip_rec(self):
        return capsule.record_capture(
            "solver.invoke",
            {"a": np.arange(12, dtype=np.int32).reshape(3, 4)},
            {"used": np.array([True, False])},
            engine="device", max_bins=2, level_bits=7, max_minv=0,
            family="4x4", pallas=False)

    def test_round_trip(self, rec, tmp_path):
        r = self._roundtrip_rec()
        path = capsule.write_capsule(
            r, path=str(tmp_path / "x.capsule.npz"), why="forced")
        cap = capsule.load(path)
        assert cap.meta["schema"] == capsule.SCHEMA_VERSION
        assert cap.seam == "solver.invoke" and cap.engine == "device"
        assert cap.static("max_bins") == 2 and cap.static("level_bits") == 7
        np.testing.assert_array_equal(cap.inputs["a"],
                                      np.arange(12).reshape(3, 4))
        np.testing.assert_array_equal(cap.outputs["used"], [True, False])
        # the env-knob snapshot rides along (conftest sets this one)
        assert "KARPENTER_NATIVE_CUTOFF" in cap.meta["env"]

    def test_one_format_for_both_packages(self, rec, tmp_path):
        """The port writes the JAX package's schema version and layout,
        and each package loads the other's file to the same record."""
        assert capsule.SCHEMA_VERSION == jcapsule.SCHEMA_VERSION
        assert (capsule.META_KEY, capsule.IN_PREFIX, capsule.OUT_PREFIX,
                capsule.CF_PREFIX) == (jcapsule.META_KEY, jcapsule.IN_PREFIX,
                                       jcapsule.OUT_PREFIX,
                                       jcapsule.CF_PREFIX)
        assert capsule.SEAMS == jcapsule.SEAMS
        path = capsule.write_capsule(
            self._roundtrip_rec(), path=str(tmp_path / "p.capsule.npz"),
            why="forced")
        mine, theirs = capsule.load(path), jcapsule.load(path)
        assert mine.meta == theirs.meta
        for a, b in ((mine.inputs, theirs.inputs),
                     (mine.outputs, theirs.outputs)):
            assert set(a) == set(b)
            assert all(np.array_equal(a[k], b[k]) for k in a)

    def test_forward_version_rejected(self, rec, tmp_path):
        r = self._roundtrip_rec()
        path = capsule.write_capsule(
            r, path=str(tmp_path / "fwd.capsule.npz"), why="forced")
        with np.load(path, allow_pickle=False) as z:
            payload = {k: z[k] for k in z.files}
        meta = json.loads(bytes(payload[capsule.META_KEY]).decode())
        meta["schema"] = capsule.SCHEMA_VERSION + 1
        payload[capsule.META_KEY] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)
        with open(path, "wb") as f:
            np.savez(f, **payload)
        with pytest.raises(ValueError, match="newer than this build"):
            capsule.load(path)
        from karpenter_tpu_torch.obs.__main__ import run_replay

        assert run_replay(path, device="cpu") == 1

    def test_not_a_capsule_rejected(self, tmp_path):
        path = str(tmp_path / "plain.npz")
        np.savez(path, a=np.zeros(3))
        with pytest.raises(ValueError, match="not a replay capsule"):
            capsule.load(path)

    def test_byte_budget_skips_and_counts(self, rec, tmp_path, monkeypatch):
        monkeypatch.setenv("KARPENTER_CAPSULE_BYTES", "16")
        r = self._roundtrip_rec()
        assert capsule.write_capsule(
            r, path=str(tmp_path / "big.capsule.npz"), why="forced") is None
        assert not os.path.exists(tmp_path / "big.capsule.npz")
        assert capsule.STATS["skipped_bytes"] == 1
        # the budgeted round still records the reference and stays silent
        with obs.round_trace("budgeted") as tr:
            solve_capturing()
            obs.anomaly("host-routed")
        assert tr.capsule_path is None
        assert capsules_in(rec) == []

    def test_unknown_seam_rejected(self):
        with pytest.raises(ValueError, match="unknown capture seam"):
            capsule.record_capture("solver.invok", {}, {})


class TestReplayParity:
    def test_device_capture_replays_bit_identically(self, rec, tmp_path):
        solve_capturing()
        r = capsule.last_capture()
        assert r is not None and r["seam"] == "solver.invoke"
        assert r["meta"]["engine"] == "device"  # conftest pins the device
        assert r["meta"]["rung"] == "device" and r["meta"]["pallas"] is False
        path = capsule.write_capsule(
            r, path=str(tmp_path / "dev.capsule.npz"), why="forced")
        rep = capsule.replay(capsule.load(path), device="cpu")
        assert rep["parity"] == "exact"
        assert rep["rung"] == "device" and rep["rung_match"]
        assert rep["nodes"] == rep["captured_nodes"]
        # xla names the same rung
        assert capsule.replay(capsule.load(path), rung="xla",
                              device="cpu")["rung"] == "device"

    def test_device_rung_without_a_device_raises_without_cuda(
            self, rec, tmp_path, monkeypatch):
        import torch

        solve_capturing()
        path = capsule.write_capsule(
            capsule.last_capture(), path=str(tmp_path / "d.capsule.npz"),
            why="forced")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            capsule.replay(capsule.load(path))

    def test_native_capture_replays_bit_identically(self, rec, tmp_path):
        from karpenter_tpu_torch import native

        assert native.available()
        from karpenter_tpu_torch.models import NativeSolver

        solve_capturing(NativeSolver(device="cpu"))
        r = capsule.last_capture()
        assert r["meta"]["engine"] == "native"
        path = capsule.write_capsule(
            r, path=str(tmp_path / "nat.capsule.npz"), why="forced")
        rep = capsule.replay(capsule.load(path))
        assert rep["parity"] == "exact" and rep["rung"] == "native"

    def test_probe_capture_replays_bit_identically(self, rec, tmp_path):
        """The disruption probe seam: batched_single_feasible's dispatch
        is captured with its counterfactual rows and replays through the
        same chunked code path (dispatch_counterfactual_rows)."""
        from karpenter_tpu_torch.ops.consolidate import (
            batched_single_feasible,
        )
        from karpenter_tpu_torch.workload import underutilized_fleet

        store, cluster, prov, cands = underutilized_fleet(4, device="cpu")
        assert cands
        out = batched_single_feasible(prov, cluster, store, list(cands))
        assert out is not None
        r = capsule.last_capture()
        assert r is not None and r["seam"] == "probe.dispatch"
        path = capsule.write_capsule(
            r, path=str(tmp_path / "probe.capsule.npz"), why="forced")
        cap = capsule.load(path)
        assert capsule.replay(cap, device="cpu")["parity"] == "exact"
        # probe A/B covers the device/native pair only
        rows = capsule.ab_compare(cap, device="cpu")
        assert [row["rung"] for row in rows] == ["device", "native"]
        assert all(row["parity"] == "exact" for row in rows)

    def test_service_capture_is_tenant_scoped(self, rec, monkeypatch):
        pytest.importorskip("grpc")
        from karpenter_tpu_torch.service import RemoteSolver, serve

        monkeypatch.setenv("KARPENTER_CAPSULE", "1")
        srv, port = serve(port=0, device="cpu")
        try:
            pods, templates, its = small_workload()
            solver = RemoteSolver(f"127.0.0.1:{port}", tenant="acme")
            res = solver.solve([p.clone() for p in pods], templates, its)
            assert solver.last_device_stats["engine"] == "remote"
            assert res.scheduled_pod_count() == len(pods)
        finally:
            srv.stop(grace=None)
        mine = [f for f in capsules_in(rec) if "-acme-" in f]
        assert mine, capsules_in(rec)
        cap = capsule.load(os.path.join(str(rec), mine[0]))
        assert cap.seam == "service.solve"
        assert cap.meta["tenant"] == "acme"
        assert capsule.replay(cap, device="cpu")["parity"] == "exact"
        # the client's own solver.invoke capture (this thread's last)
        # names the remote engine and replays on the device rung
        r = capsule.last_capture()
        assert r["seam"] == "solver.invoke"
        assert r["meta"]["engine"] == "remote"
        assert r["meta"]["rung"] == "service"
        path = capsule.write_capsule(
            r, path=str(rec / "client.capsule.npz"), why="forced")
        assert capsule.replay(capsule.load(path),
                              device="cpu")["parity"] == "exact"

    def test_host_ffd_rung_reports_in_ab(self, rec, tmp_path):
        """The A/B ladder's bottom rung: the pure-numpy FFD oracle is
        eligible on a plain snapshot, deterministic, and lands every pod
        the kernel landed; the mesh rungs report why they are not here."""
        solve_capturing()
        path = capsule.write_capsule(
            capsule.last_capture(),
            path=str(tmp_path / "h.capsule.npz"), why="forced")
        cap = capsule.load(path)
        rows = {r["rung"]: r for r in capsule.ab_compare(cap, device="cpu")}
        assert list(rows) == ["partitioned", "replicated", "device",
                              "native", "host"]
        for rung in ("partitioned", "replicated"):
            assert rows[rung]["eligible"] is False
            assert "mesh" in rows[rung]["why"]
        host = rows["host"]
        assert host.get("eligible") and host["nodes"] is not None
        a = capsule._run_host_ffd(cap)
        b = capsule._run_host_ffd(cap)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        placed = a["assign"].sum() + a["assign_e"].sum()
        assert placed == int(np.asarray(cap.inputs["g_count"]).sum())
        assert host["nodes"] == rows["device"]["nodes"]
        assert rows["native"]["parity"] == "exact"

    def test_jax_mesh_capsule_on_the_port(self, tmp_path, monkeypatch):
        """A JAX replicated-rung capture (the partition kill-switched)
        replays exactly on the port's device rung; its own rung and the
        partitioned one are ineligible here until the mesh slice."""
        import __graft_entry__ as graft
        from karpenter_tpu import obs as jobs
        from karpenter_tpu.parallel import make_mesh, sharded_solve_host
        from karpenter_tpu.parallel.mesh import LAST_RUN, estimate_bin_axis

        monkeypatch.setenv("KARPENTER_SHARD_PARTITION", "0")
        jobs.configure(enabled=True, dump_dir=str(tmp_path), capacity=8,
                       dump_all=False)
        try:
            snap = graft._wide_snapshot(n_groups=32, n_types=16)
            args = graft._snapshot_args(snap)
            with jobs.round_trace("mesh-repl") as tr:
                sharded_solve_host(make_mesh(), args,
                                   estimate_bin_axis(args))
                jobs.anomaly("rung-regression")
            assert LAST_RUN.get("engine") == "replicated"
            path = tr.capsule_path
        finally:
            jobs.reset()
        cap = capsule.load(path)
        assert cap.seam == "mesh.solve"
        with pytest.raises(capsule.ReplayError, match="mesh"):
            capsule.replay(cap, device="cpu")
        assert capsule.replay(cap, rung="device",
                              device="cpu")["parity"] == "exact"
        rows = {r["rung"]: r for r in capsule.ab_compare(cap, device="cpu")}
        assert rows["replicated"]["eligible"] is False
        assert rows["partitioned"]["eligible"] is False
        assert rows["device"]["parity"] == "exact"


class TestReplayCLI:
    def _capsule_path(self, tmp_path) -> str:
        solve_capturing()
        return capsule.write_capsule(
            capsule.last_capture(),
            path=str(tmp_path / "cli.capsule.npz"), why="forced")

    def test_replay_exit_codes_and_json(self, rec, tmp_path, capsys):
        from karpenter_tpu_torch.obs.__main__ import main

        path = self._capsule_path(tmp_path)
        assert main(["replay", path, "--json", "--device", "cpu"]) == 0
        reply = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert reply["replay"]["parity"] == "exact"
        assert reply["seam"] == "solver.invoke"
        # a missing file and a failing replay exit 1, as the JAX CLI does
        assert main(["replay", str(tmp_path / "none.capsule.npz")]) == 1

    def test_replay_ab_renders_table(self, rec, tmp_path, capsys):
        from karpenter_tpu_torch.obs.__main__ import main

        path = self._capsule_path(tmp_path)
        assert main(["replay", path, "--ab", "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        for rung in ("device", "native", "host", "partitioned"):
            assert rung in out
        assert "parity" in out and "ineligible" in out

    def test_render_ab_matches_jax(self, rec, tmp_path):
        from karpenter_tpu.obs.__main__ import render_ab as jrender
        from karpenter_tpu_torch.obs.__main__ import render_ab

        rows = capsule.ab_compare(capsule.load(self._capsule_path(tmp_path)),
                                  device="cpu")
        assert render_ab(rows) == jrender(rows)

    def test_tampered_outputs_fail_replay(self, rec, tmp_path):
        from karpenter_tpu_torch.obs.__main__ import run_replay

        path = self._capsule_path(tmp_path)
        cap = capsule.load(path)
        outputs = dict(cap.outputs)
        outputs["tmpl"] = np.asarray(outputs["tmpl"]) + 1
        tampered = capsule.write_capsule(
            {"seam": cap.seam, "tenant": None, "meta": cap.meta["meta"],
             "inputs": cap.inputs, "outputs": outputs, "at": 0.0},
            path=str(tmp_path / "bad.capsule.npz"), why="forced")
        assert run_replay(tampered, device="cpu") == 1

    def test_replay_runs_as_a_program(self, rec, tmp_path):
        path = self._capsule_path(tmp_path)
        proc = subprocess.run(
            [sys.executable, "-m", "karpenter_tpu_torch.obs", "replay", path,
             "--device", "cpu", "--json"],
            capture_output=True, text=True, timeout=300, cwd=REPO)
        assert proc.returncode == 0, proc.stderr[-2000:]
        reply = json.loads(proc.stdout.strip().splitlines()[-1])
        assert reply["replay"]["parity"] == "exact"


# ---------------------------------------------------------------------------
# across the packages: every seam, captured on one shape by both
# ---------------------------------------------------------------------------


@pytest.fixture
def captured(monkeypatch):
    """Every record each package's ``record_capture`` returns, by
    package."""
    out = {JAX: [], PORT: []}
    for pkg, cap in CAPS.items():
        real = cap.record_capture

        def spy(*a, _real=real, _out=out[pkg], **kw):
            r = _real(*a, **kw)
            if r is not None:
                _out.append(r)
            return r

        monkeypatch.setattr(cap, "record_capture", spy)
    return out


def _solver_seam(pkg):
    solve_capturing(pkg=pkg)


def _fleet(pkg, n_nodes=24):
    """The consolidation fleet of ``tests/test_torch_consolidate.py``,
    with the package's own objects: (prov, cluster, store, candidates)."""
    from tests.test_torch_consolidate import candidates, jax_fleet
    from karpenter_tpu_torch.workload import fleet_layout, underutilized_fleet

    if pkg == PORT:
        store, cluster, prov, _ = underutilized_fleet(n_nodes, device="cpu")
        cloud, clock = prov.cloud, prov.clock
    else:
        store, cluster, prov, cloud, clock = jax_fleet(fleet_layout(n_nodes))
    return prov, cluster, store, candidates(pkg, store, cluster, cloud, clock)


def _probe_seam(pkg):
    prov, cluster, store, cands = _fleet(pkg)
    mod(pkg, "ops.consolidate").batched_single_feasible(
        prov, cluster, store, cands)


def _joint_seam(pkg):
    prov, cluster, store, cands = _fleet(pkg)
    plan = mod(pkg, "ops.consolidate").joint_retirement_plan(
        prov, cluster, store, cands, want_singles=True)
    assert plan is not None and plan.viable


def _interruption_seam(pkg):
    from tests.test_torch_interruption import _absorb_spare_room

    _, _, answers = _absorb_spare_room(pkg)
    assert answers == [True]


def _preempt_seam(pkg):
    from tests.test_torch_admission import _preempt_fleet, _probe_inputs

    env = _preempt_fleet(pkg)
    P, pre, cands, tpl, its = _probe_inputs(pkg, env)
    kw = {"device": "cpu"} if pkg == PORT else {}
    assert P.probe_feasible_batch(pre, cands, tpl, its, **kw)
    assert P.probe_feasible(pre[0], cands[0], tpl, its, **kw) is not None


def _service_seam(pkg):
    svc = mod(pkg, "service")
    kw = {"device": "cpu"} if pkg == PORT else {}
    srv, port = svc.serve(port=0, **kw)
    try:
        pods, templates, its = small_workload(pkg)
        solver = svc.RemoteSolver(f"127.0.0.1:{port}", tenant="acme")
        for n in (40, 36):
            res = solver.solve([p.clone() for p in pods[:n]], templates, its)
            assert res.scheduled_pod_count() == n
    finally:
        srv.stop(grace=None)


# seam -> (scenario, env knobs)
SEAM_CASES = {
    "solver.invoke": (_solver_seam, {}),
    "probe.dispatch": (_probe_seam, {}),
    "global.dispatch": (_joint_seam, {"KARPENTER_RELAX": "0"}),
    "relax.dispatch": (_joint_seam, {"KARPENTER_RELAX": "1"}),
    "interruption.dispatch": (_interruption_seam, {}),
    "preempt.dispatch": (_preempt_seam, {}),
    "service.solve": (_service_seam, {}),
}


def _statics(rec) -> dict:
    meta = dict(rec["meta"])
    if meta.get("rung") == "xla":
        meta["rung"] = "device"
    return meta


def _same_capture(want, got):
    """The JAX record ``want`` and the port's ``got`` hold the same
    dispatch (module docstring)."""
    assert want["seam"] == got["seam"]
    assert want["tenant"] == got["tenant"]
    win, gin = want["inputs"], dict(got["inputs"])
    rx_y = gin.pop(capsule.CF_PREFIX + "rx_y", None)
    assert set(win) == set(gin)
    for k in win:
        a, b = np.asarray(win[k]), np.asarray(gin[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    wout, gout = want["outputs"], got["outputs"]
    if want["seam"] == "relax.dispatch":
        # the graded decision; y rides as the port's ungraded sidecar
        assert set(gout) == {"k_sel"}
        y = np.asarray(wout["y"])
        assert np.allclose(rx_y, y, rtol=1e-4, atol=1e-4)
    else:
        assert rx_y is None and set(wout) == set(gout)
    for k in gout:
        a, b = np.asarray(wout[k]), np.asarray(gout[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    # every static field the JAX package records, with the same value
    # (the port may add one: the rows' ``max_bins``)
    ws, gs = _statics(want), _statics(got)
    assert {k: gs.get(k) for k in ws} == ws


@pytest.mark.parametrize("seam", list(SEAM_CASES))
def test_seam_captures_match_and_cross_replay(seam, captured, rec, tmp_path,
                                              monkeypatch):
    if seam == "service.solve":
        pytest.importorskip("grpc")
    scenario, knobs = SEAM_CASES[seam]
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    scenario(JAX)
    scenario(PORT)
    want = [r for r in captured[JAX] if r["seam"] == seam]
    got = [r for r in captured[PORT] if r["seam"] == seam]
    assert want and len(got) == len(want), (len(got), len(want))
    for w, g in zip(want, got):
        _same_capture(w, g)
    # one capsule each way: the other package replays it exactly
    jpath = jcapsule.write_capsule(want[-1], path=str(tmp_path / "j.capsule.npz"),
                                   why="forced")
    tpath = capsule.write_capsule(got[-1], path=str(tmp_path / "t.capsule.npz"),
                                  why="forced")
    mine = capsule.replay(capsule.load(jpath), device="cpu")
    assert mine["parity"] == "exact" and mine["rung_match"], mine
    theirs = jcapsule.replay(jcapsule.load(tpath))
    assert theirs["parity"] == "exact" and theirs["rung_match"], theirs
    # and each replays its own exactly
    assert capsule.replay(capsule.load(tpath),
                          device="cpu")["parity"] == "exact"
