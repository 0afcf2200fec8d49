"""The port's entry point against the JAX package's.

- **Conversion** (``api/conversion.py``, the shapes of
  ``tests/test_conversion.py``): the same wire documents decoded by each
  package encode to the same documents in both API versions, survive the
  round trip, and give NodePools of the same static hash; durations
  parse and format alike;
  unknown versions and kinds are refused alike; the kubelet stash and the
  status fields cross the wire alike.
- **``python -m karpenter_tpu_torch``** (``__main__.py``, the shapes of
  ``tests/test_main_entrypoint.py``): ``main(["--device", "cpu", ...])``
  provisions a manifest of one v1 and one v1beta1 NodePool to the node
  count and bound pods of the JAX package's ``main`` on the same file,
  with routing off and on in both; ``/metrics`` and ``/healthz`` serve the
  registry, ``/slo``, ``/introspect`` and ``/usage`` serve the planes' JSON
  with the JAX package's top-level keys (the endpoint cases of
  ``test_devplane.py``, ``test_decisions.py`` and ``test_timeline.py``),
  ``KARPENTER_METRICS_BIND`` narrows the listener; an unknown kind is
  rejected;
  ``--solver`` and ``KARPENTER_SOLVER_TARGET`` are refused with exit code
  2; ``main()`` with no ``--device`` raises without CUDA; the module runs
  as a program.

Tolerance: exact.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from karpenter_tpu.api import conversion as jconv
from karpenter_tpu_torch.api import conversion as tconv

ROOT = Path(__file__).resolve().parent.parent

V1BETA1_NODEPOOL = {
    "apiVersion": tconv.V1BETA1,
    "kind": "NodePool",
    "metadata": {"name": "default"},
    "spec": {
        "weight": 5,
        "limits": {"cpu": "100"},
        "template": {
            "metadata": {"labels": {"team": "infra"}},
            "spec": {
                "taints": [{"key": "dedicated", "value": "gpu",
                            "effect": "NoSchedule"}],
                "requirements": [
                    {"key": "karpenter.sh/capacity-type", "operator": "In",
                     "values": ["spot"]},
                    {"key": "node.kubernetes.io/instance-type",
                     "operator": "Exists", "minValues": 50},
                ],
                "kubelet": {"maxPods": 42},
            },
        },
        "disruption": {
            "consolidationPolicy": "WhenUnderutilized",
            "consolidateAfter": "30s",
            "expireAfter": "720h",
            "budgets": [{"nodes": "10%"},
                        {"nodes": "0", "schedule": "0 9 * * 1-5",
                         "duration": "8h", "reasons": ["Underutilized"]}],
        },
    },
}
V1_NODEPOOL = {
    "apiVersion": tconv.V1, "kind": "NodePool",
    "metadata": {"name": "default"},
    "spec": {"template": {"spec": {"expireAfter": "720h"}},
             "disruption": {"consolidationPolicy": "WhenEmptyOrUnderutilized",
                            "budgets": [{"nodes": "10%"}]}},
}
V1_NODECLAIM = {
    "apiVersion": tconv.V1, "kind": "NodeClaim",
    "metadata": {"name": "claim-1"},
    "spec": {
        "requirements": [{"key": "topology.kubernetes.io/zone",
                          "operator": "In", "values": ["zone-1"]}],
        "resources": {"requests": {"cpu": "2"}},
        "expireAfter": "24h",
    },
    "status": {"providerID": "pid-1", "nodeName": "n1"},
}
V1BETA1_NODECLAIM = {
    "apiVersion": tconv.V1BETA1, "kind": "NodeClaim",
    "metadata": {"name": "c"},
    "spec": {"kubelet": {"maxPods": 42}},
}
DOCS = {"v1beta1-nodepool": V1BETA1_NODEPOOL, "v1-nodepool": V1_NODEPOOL,
        "v1-nodeclaim": V1_NODECLAIM, "v1beta1-nodeclaim": V1BETA1_NODECLAIM}


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("version", [tconv.V1, tconv.V1BETA1])
@pytest.mark.parametrize("doc", sorted(DOCS))
def test_round_trip_matches_jax(doc, version):
    wire = DOCS[doc]
    hub_t, hub_j = tconv.decode(wire), jconv.decode(wire)
    out_t, out_j = tconv.encode(hub_t, version), jconv.encode(hub_j, version)
    assert out_t == out_j
    back_t, back_j = tconv.decode(out_t), jconv.decode(out_j)
    for other in (tconv.V1, tconv.V1BETA1):
        # the hub survives the trip: it encodes as the first decode did
        assert tconv.encode(back_t, other) == tconv.encode(hub_t, other)
        assert tconv.encode(back_t, other) == jconv.encode(back_j, other)
    if doc.endswith("nodepool"):
        assert back_t.static_hash() == hub_t.static_hash()
        assert hub_t.static_hash() == hub_j.static_hash()


def test_durations_match_jax():
    import random

    rng = random.Random(0xC0FFEE)
    samples = [0.0, 0.0005, 1e-12, 59.999, 3599.999, -1.0, -1e9, 0.99975,
               3599.9996, 59.9999, -90.0]
    samples += [rng.uniform(-1e5, 1e6) for _ in range(200)]
    for x in samples:
        wire = tconv.format_duration(x)
        assert wire == jconv.format_duration(x)
        assert tconv.parse_duration(wire) == jconv.parse_duration(wire)
    for wire in ("720h", "30m", "1h30m", "45s", "Never", None):
        assert tconv.parse_duration(wire) == jconv.parse_duration(wire)


@pytest.mark.parametrize("bad", [
    "3 hours", {"apiVersion": "karpenter.sh/v2", "kind": "NodePool"},
    {"apiVersion": tconv.V1, "kind": "Widget"}])
def test_refusals_match_jax(bad):
    for conv in (tconv, jconv):
        with pytest.raises(conv.ConversionError):
            if isinstance(bad, str):
                conv.parse_duration(bad)
            else:
                conv.decode(bad)


def test_v1_encode_applies_the_migration():
    v1 = tconv.encode(tconv.decode(V1BETA1_NODEPOOL), tconv.V1)
    assert v1["spec"]["disruption"]["consolidationPolicy"] == (
        "WhenEmptyOrUnderutilized")
    assert v1["spec"]["template"]["spec"]["expireAfter"] == "720h"
    assert "kubelet" not in v1["spec"]["template"]["spec"]
    assert tconv.KUBELET_COMPAT_ANNOTATION in v1["metadata"]["annotations"]
    assert tconv.decode(v1).spec.template.kubelet == {"maxPods": 42}


def test_cleared_kubelet_does_not_resurrect():
    hubs = []
    for conv in (tconv, jconv):
        hub = conv.decode(conv.encode(conv.decode(V1BETA1_NODEPOOL), conv.V1))
        assert conv.KUBELET_COMPAT_ANNOTATION not in hub.metadata.annotations
        hub.spec.template.kubelet = {}
        again = conv.encode(hub, conv.V1)
        assert conv.KUBELET_COMPAT_ANNOTATION not in again["metadata"].get(
            "annotations", {})
        hubs.append(again)
    assert hubs[0] == hubs[1]


@pytest.mark.parametrize("pkg", ["nodeclaim", "nodepool"])
def test_status_round_trip_matches_jax(pkg):
    from karpenter_tpu.api import nodeclaim as jnc
    from karpenter_tpu.api.objects import ObjectMeta as JMeta
    from karpenter_tpu_torch.api import nodeclaim as tnc
    from karpenter_tpu_torch.api.objects import ObjectMeta as TMeta

    wires = []
    for conv, nc, meta in ((tconv, tnc, TMeta), (jconv, jnc, JMeta)):
        if pkg == "nodeclaim":
            obj = nc.NodeClaim(metadata=meta(name="c1"))
            obj.status.provider_id = "pid-1"
            obj.status.image_id = "ami-123"
            obj.set_condition(nc.COND_INITIALIZED, now=123.0)
        else:
            obj = conv.decode(V1BETA1_NODEPOOL)
            obj.status.resources = {"cpu": 42.0}
            obj.set_condition("Ready", now=5.0)
        wire = conv.encode(obj, conv.V1)
        back = conv.decode(wire)
        if pkg == "nodeclaim":
            assert back.is_true(nc.COND_INITIALIZED)
            assert back.status.image_id == "ami-123"
        else:
            assert back.status.resources == {"cpu": 42.0}
            assert back.is_true("Ready")
        wires.append(wire)
    assert wires[0] == wires[1]


# ---------------------------------------------------------------------------
# python -m karpenter_tpu_torch
# ---------------------------------------------------------------------------


def write_manifest(path, replicas: int) -> str:
    """One v1 and one v1beta1 NodePool and 64 ``Pod`` shorthand docs of
    distinct cpu/memory (8 cpu sizes × 8 memory sizes), ``replicas``
    each."""
    cpus = (0.25, 0.5, 1, 2, 3, 4, 6, 8)
    mems = (0.5, 1, 2, 4, 8, 12, 16, 32)
    legacy = {"apiVersion": tconv.V1BETA1, "kind": "NodePool",
              "metadata": {"name": "legacy"},
              "spec": {"weight": 10, "disruption": {
                  "consolidationPolicy": "WhenUnderutilized",
                  "expireAfter": "720h"}}}
    docs = [V1_NODEPOOL, legacy] + [
        {"kind": "Pod", "name": f"w{i}-{j}", "cpu": c, "memory": m,
         "replicas": replicas}
        for i, c in enumerate(cpus) for j, m in enumerate(mems)]
    path.write_text(json.dumps(docs))
    return str(path)


@pytest.fixture
def fast_batches(monkeypatch):
    # collapse the production batch window so a run finishes fast
    monkeypatch.setenv("KARPENTER_BATCH_IDLE_DURATION", "0")
    monkeypatch.setenv("KARPENTER_BATCH_MAX_DURATION", "0")
    return monkeypatch


def _ended(err: str) -> tuple:
    m = re.search(r"\((\d+) nodes, (\d+) bound pods\)", err.splitlines()[-1])
    return int(m.group(1)), int(m.group(2))


@pytest.mark.parametrize("cutoff", ["0", "192"])
def test_main_provisions_like_jax(cutoff, tmp_path, fast_batches, capsys):
    from karpenter_tpu.__main__ import main as jmain
    from karpenter_tpu_torch.__main__ import main as tmain

    fast_batches.setenv("KARPENTER_NATIVE_CUTOFF", cutoff)
    manifest = write_manifest(tmp_path / "m.json", replicas=2)
    argv = ["--manifest", manifest, "--tick", "0.01", "--max-ticks", "30"]
    assert tmain(["--device", "cpu", *argv]) == 0
    got = capsys.readouterr().err
    assert jmain(argv) == 0
    want = capsys.readouterr().err
    assert "130 manifest objects applied" in got
    assert _ended(got) == _ended(want)
    nodes, bound = _ended(got)
    assert nodes > 0 and bound == 128


def test_metrics_endpoint_serves_registry(tmp_path, fast_batches):
    from karpenter_tpu_torch.__main__ import load_manifest, serve_metrics
    from karpenter_tpu_torch.models import TorchSolver
    from karpenter_tpu_torch.operator import Environment
    from karpenter_tpu_torch.operator.options import Options
    from karpenter_tpu_torch.utils.clock import Clock

    env = Environment(clock=Clock(), sync=True, options=Options.from_env(),
                      solver=TorchSolver(device="cpu"))
    load_manifest(env, write_manifest(tmp_path / "m.json", replicas=1))
    env.run_until_idle()
    server = serve_metrics(env.registry, 0, host="127.0.0.1")
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        body = urllib.request.urlopen(f"{base}/metrics", timeout=5).read()
        assert "karpenter_" in body.decode()
        health = urllib.request.urlopen(f"{base}/healthz", timeout=5).read()
        assert health.decode() == "ok"
        from karpenter_tpu.obs import decisions as jdecisions
        from karpenter_tpu.obs import devplane as jdevplane
        from karpenter_tpu.obs import timeline as jtimeline

        want = {"/slo": jdevplane.slo_snapshot(),
                "/introspect": jdecisions.introspect_snapshot(),
                "/usage": jtimeline.usage_snapshot()}
        for path, jsnap in want.items():
            r = urllib.request.urlopen(f"{base}{path}", timeout=5)
            assert r.status == 200
            assert r.headers["Content-Type"] == "application/json"
            doc = json.loads(r.read().decode())
            assert set(doc) == set(jsnap), path
        # the round this environment ran is on the planes
        intro = json.loads(urllib.request.urlopen(
            f"{base}/introspect", timeout=5).read().decode())
        assert "solver.route" in intro["sites"]
        kinds = intro["timeline"]["ring"]["kinds"]
        assert kinds.get("launch", 0) > 0 and kinds.get("bind", 0) > 0
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nope", timeout=5)
        assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()


def test_metrics_bind_address_override(monkeypatch):
    from karpenter_tpu_torch.__main__ import serve_metrics
    from karpenter_tpu_torch.operator.metrics import Registry
    from karpenter_tpu_torch.operator.options import Options

    monkeypatch.setenv("KARPENTER_METRICS_BIND", "127.0.0.1")
    opts = Options.from_env()
    assert opts.metrics_bind_addr == "127.0.0.1"
    server = serve_metrics(Registry(), 0, host=opts.metrics_bind_addr)
    try:
        assert server.server_address[0] == "127.0.0.1"
        port = server.server_address[1]
        health = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=5).read().decode()
        assert health == "ok"
    finally:
        server.shutdown()
        server.server_close()


def test_unknown_kind_rejected(tmp_path):
    from karpenter_tpu_torch.__main__ import load_manifest
    from karpenter_tpu_torch.models import TorchSolver
    from karpenter_tpu_torch.operator import Environment

    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"kind": "Widget"}))
    with pytest.raises(SystemExit, match="unsupported manifest kind"):
        load_manifest(Environment(solver=TorchSolver(device="cpu")), str(p))


@pytest.mark.parametrize("how", ["flag", "env"])
def test_solver_service_is_refused(how, monkeypatch, capsys):
    from karpenter_tpu_torch.__main__ import main

    argv = ["--device", "cpu", "--max-ticks", "1"]
    if how == "flag":
        argv += ["--solver", "127.0.0.1:1"]
    else:
        monkeypatch.setenv("KARPENTER_SOLVER_TARGET", "127.0.0.1:1")
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    assert "solver service is not in the port" in capsys.readouterr().err


def test_main_without_device_raises_without_cuda(monkeypatch):
    from karpenter_tpu_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--max-ticks", "1"])


def test_module_runs_as_a_program(tmp_path):
    manifest = write_manifest(tmp_path / "m.json", replicas=1)
    env = dict(__import__("os").environ, KARPENTER_BATCH_IDLE_DURATION="0",
               KARPENTER_BATCH_MAX_DURATION="0")
    out = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch", "--device", "cpu",
         "--manifest", manifest, "--tick", "0.01", "--max-ticks", "20"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    nodes, bound = _ended(out.stderr)
    assert nodes > 0 and bound == 64


def test_program_serves_the_planes(tmp_path):
    """``--metrics`` on the program: ``/slo``, ``/introspect`` and
    ``/usage`` answer 200 with JSON while it runs, and ``/introspect``'s
    timeline counts a launch and a registration per node and a bind per
    pod of the run."""
    import os
    import socket
    import time

    manifest = write_manifest(tmp_path / "m.json", replicas=1)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, KARPENTER_BATCH_IDLE_DURATION="0",
               KARPENTER_BATCH_MAX_DURATION="0",
               KARPENTER_METRICS_PORT=str(port),
               KARPENTER_METRICS_BIND="127.0.0.1",
               KARPENTER_TRACE_DIR=str(tmp_path / "traces"))
    err_path = tmp_path / "err"
    planes: dict = {}
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "karpenter_tpu_torch", "--device", "cpu",
             "--manifest", manifest, "--tick", "0.1", "--max-ticks", "30",
             "--metrics"], cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
            stderr=err)
        try:
            while proc.poll() is None:
                try:
                    got = {}
                    for path in ("/slo", "/introspect", "/usage"):
                        with urllib.request.urlopen(
                                f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
                            assert r.status == 200
                            assert r.headers["Content-Type"] == \
                                "application/json"
                            got[path] = json.loads(r.read().decode())
                    planes = got
                except (OSError, ValueError):
                    pass
                time.sleep(0.1)
            proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert proc.returncode == 0, err_path.read_text()
    nodes, bound = _ended(err_path.read_text())
    assert nodes > 0 and bound == 64
    kinds = planes["/introspect"]["timeline"]["ring"]["kinds"]
    assert kinds.get("launch") == kinds.get("register") == nodes
    assert kinds.get("bind") == bound
    assert "solver.route" in planes["/introspect"]["sites"]
    assert "compile_ledger" in planes["/slo"]
    assert "total_device_seconds" in planes["/usage"]
