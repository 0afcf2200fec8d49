"""Dual API version support: karpenter.sh/v1beta1 ↔ v1 wire conversion.

Mirror of the reference's staged-version machinery (pkg/apis/apis.go:33-43:
v1beta1 active, v1 staged next; conversion via webhooks,
pkg/webhooks/webhooks.go:82-125). Our storage (hub) objects are the
dataclasses in api/nodepool.py / api/nodeclaim.py — v1beta1-flavored, like
the reference snapshot's storage version — and this module converts wire
documents of EITHER version to and from them, so a client speaking v1 and a
client speaking v1beta1 read/write the same stored object.

The modeled v1 changes (the real karpenter v1 migration):
- `consolidationPolicy: WhenUnderutilized` (v1beta1) is renamed
  `WhenEmptyOrUnderutilized` (v1)
- `spec.disruption.expireAfter` (v1beta1) moves to
  `spec.template.spec.expireAfter` (v1), per-NodeClaim
- `spec.template.spec.kubelet` (v1beta1) leaves the NodePool in v1 (it
  moved to the NodeClass); a v1 encode stashes it in the
  compatibility.karpenter.sh/v1beta1-kubelet-conversion annotation the way
  the real migration did, so nothing is lost crossing versions
- durations are wire strings ("720h", "1h30m", "Never") ↔ hub float seconds

The port's copy of ``karpenter_tpu/api/conversion.py`` (imports changed).
"""

from __future__ import annotations

import json
import re

from karpenter_tpu_torch.api.conditions import Condition
from karpenter_tpu_torch.api.nodeclaim import NodeClaim, NodeClaimSpec, NodeClaimStatus
from karpenter_tpu_torch.api.nodepool import (
    Budget,
    Disruption,
    NodeClaimTemplate,
    NodePool,
    NodePoolSpec,
)
from karpenter_tpu_torch.api.objects import NodeSelectorRequirement, ObjectMeta, Taint

GROUP = "karpenter.sh"
V1BETA1 = f"{GROUP}/v1beta1"
V1 = f"{GROUP}/v1"
VERSIONS = (V1BETA1, V1)

KUBELET_COMPAT_ANNOTATION = "compatibility.karpenter.sh/v1beta1-kubelet-conversion"

_POLICY_TO_V1 = {"WhenUnderutilized": "WhenEmptyOrUnderutilized"}
_POLICY_FROM_V1 = {v: k for k, v in _POLICY_TO_V1.items()}

# "ms" must precede "m" in the alternation or the regex engine commits to
# the minutes unit and strands the trailing "s" ("500ms" read as "500m"+"s")
_DUR = re.compile(r"(\d+(?:\.\d+)?)(ms|h|m|s)")
_UNIT_SECONDS = {"h": 3600.0, "m": 60.0, "s": 1.0, "ms": 0.001}


class ConversionError(Exception):
    pass


def parse_duration(s) -> float | None:
    """Go-style duration string → seconds; "Never"/None → None."""
    if s is None or s == "Never":
        return None
    if isinstance(s, (int, float)):
        return float(s)
    pos, total = 0, 0.0
    for m in _DUR.finditer(s):
        if m.start() != pos:
            raise ConversionError(f"invalid duration {s!r}")
        total += float(m.group(1)) * _UNIT_SECONDS[m.group(2)]
        pos = m.end()
    if pos != len(s) or pos == 0:
        raise ConversionError(f"invalid duration {s!r}")
    return total


def format_duration(seconds: float | None) -> str:
    """Seconds → canonical wire string; None → "Never". Negative inputs
    clamp to "0s": the grammar has no sign, so an unclamped encode would
    emit a wire string ("-1h58m30s") that parse_duration rejects — encode
    must never produce an unparseable document."""
    if seconds is None:
        return "Never"
    # round to the wire resolution FIRST so the residual carries into the
    # coarser units ("1000ms" must canonicalize to "1s", and a
    # sub-half-millisecond residual must vanish rather than render "0ms",
    # which the parse grammar rejects as "0m" + a dangling "s")
    total_ms = int(round(max(float(seconds), 0.0) * 1000))
    s, ms = divmod(total_ms, 1000)
    out = []
    for unit, width in (("h", 3600), ("m", 60), ("s", 1)):
        n, s = divmod(s, width)
        if n:
            out.append(f"{n}{unit}")
    if ms:
        out.append(f"{ms}ms")
    return "".join(out) or "0s"


# ---- shared fragments ---------------------------------------------------

def _conditions_from(items) -> list:
    return [Condition.from_wire(c) for c in items or ()]


def _conditions_to(conds) -> list:
    out = []
    for c in conds:
        if isinstance(c, dict):
            out.append(dict(c))
            continue
        d = {"type": c.type, "status": c.status}
        if c.reason:
            d["reason"] = c.reason
        if c.message:
            d["message"] = c.message
        if c.last_transition_time:
            d["lastTransitionTime"] = c.last_transition_time
        out.append(d)
    return out


def _meta_from(doc: dict) -> ObjectMeta:
    m = doc.get("metadata", {})
    return ObjectMeta(
        name=m.get("name", ""),
        namespace=m.get("namespace", "default"),
        labels=dict(m.get("labels", {})),
        annotations=dict(m.get("annotations", {})),
    )


def _meta_to(meta: ObjectMeta) -> dict:
    out = {"name": meta.name}
    if meta.labels:
        out["labels"] = dict(meta.labels)
    if meta.annotations:
        out["annotations"] = dict(meta.annotations)
    return out


def _taints_from(items) -> list:
    return [
        Taint(key=t["key"], value=t.get("value", ""),
              effect=t.get("effect", "NoSchedule"))
        for t in items or ()
    ]


def _taints_to(taints) -> list:
    return [
        {"key": t.key, **({"value": t.value} if t.value else {}),
         "effect": t.effect}
        for t in taints
    ]


def _reqs_from(items) -> list:
    return [
        NodeSelectorRequirement(
            key=r["key"], operator=r.get("operator", "In"),
            values=list(r.get("values", [])), min_values=r.get("minValues"),
        )
        for r in items or ()
    ]


def _reqs_to(reqs) -> list:
    out = []
    for r in reqs:
        d = {"key": r.key, "operator": r.operator}
        if r.values:
            d["values"] = list(r.values)
        if r.min_values is not None:
            d["minValues"] = r.min_values
        out.append(d)
    return out


# ---- NodePool -----------------------------------------------------------

def _nodepool_from(doc: dict, version: str) -> NodePool:
    spec = doc.get("spec", {})
    tpl = spec.get("template", {})
    tpl_meta = tpl.get("metadata", {})
    tpl_spec = tpl.get("spec", {})
    dis = spec.get("disruption", {})

    policy = dis.get("consolidationPolicy", "WhenUnderutilized")
    if version == V1:
        policy = _POLICY_FROM_V1.get(policy, policy)
        expire = parse_duration(tpl_spec.get("expireAfter"))
    else:
        expire = parse_duration(dis.get("expireAfter"))

    kubelet = dict(tpl_spec.get("kubelet", {}))
    meta = _meta_from(doc)
    if version == V1 and not kubelet:
        stash = meta.annotations.get(KUBELET_COMPAT_ANNOTATION)
        if stash:
            kubelet = json.loads(stash)
    # the stash is an encode-time artifact, not hub state: leaving it on the
    # hub object would resurrect a later-cleared kubelet on the next encode
    meta.annotations.pop(KUBELET_COMPAT_ANNOTATION, None)

    status = doc.get("status", {})
    np_ = NodePool(
        metadata=meta,
        spec=NodePoolSpec(
            template=NodeClaimTemplate(
                labels=dict(tpl_meta.get("labels", {})),
                annotations=dict(tpl_meta.get("annotations", {})),
                taints=_taints_from(tpl_spec.get("taints")),
                startup_taints=_taints_from(tpl_spec.get("startupTaints")),
                requirements=_reqs_from(tpl_spec.get("requirements")),
                kubelet=kubelet,
                node_class_ref=dict(tpl_spec.get("nodeClassRef", {})),
            ),
            disruption=Disruption(
                consolidation_policy=policy,
                consolidate_after=parse_duration(dis.get("consolidateAfter")),
                expire_after=expire,
                budgets=[
                    Budget(
                        nodes=b.get("nodes", "10%"),
                        schedule=b.get("schedule"),
                        duration=parse_duration(b.get("duration")),
                        reasons=b.get("reasons"),
                    )
                    for b in dis.get("budgets", [{"nodes": "10%"}])
                ],
            ),
            limits=dict(spec.get("limits", {})),
            weight=spec.get("weight", 0),
        ),
    )
    np_.status.resources = dict(status.get("resources", {}))
    np_.status.conditions = _conditions_from(status.get("conditions"))
    return np_


def _nodepool_to(np: NodePool, version: str) -> dict:
    t = np.spec.template
    d = np.spec.disruption
    meta = _meta_to(np.metadata)

    tpl_spec: dict = {}
    if t.taints:
        tpl_spec["taints"] = _taints_to(t.taints)
    if t.startup_taints:
        tpl_spec["startupTaints"] = _taints_to(t.startup_taints)
    if t.requirements:
        tpl_spec["requirements"] = _reqs_to(t.requirements)
    if t.node_class_ref:
        tpl_spec["nodeClassRef"] = dict(t.node_class_ref)

    policy = d.consolidation_policy
    dis: dict = {}
    if version == V1:
        dis["consolidationPolicy"] = _POLICY_TO_V1.get(policy, policy)
        tpl_spec["expireAfter"] = format_duration(d.expire_after)
        if t.kubelet:
            # the kubelet block left the NodePool in v1; the compatibility
            # annotation preserves it across the version boundary
            meta.setdefault("annotations", {})[KUBELET_COMPAT_ANNOTATION] = (
                json.dumps(t.kubelet, sort_keys=True)
            )
    else:
        dis["consolidationPolicy"] = policy
        dis["expireAfter"] = format_duration(d.expire_after)
        if t.kubelet:
            tpl_spec["kubelet"] = dict(t.kubelet)
    if d.consolidate_after is not None:
        dis["consolidateAfter"] = format_duration(d.consolidate_after)
    dis["budgets"] = [
        {
            "nodes": b.nodes,
            **({"schedule": b.schedule} if b.schedule else {}),
            **({"duration": format_duration(b.duration)}
               if b.duration is not None else {}),
            **({"reasons": list(b.reasons)} if b.reasons is not None else {}),
        }
        for b in d.budgets
    ]

    tpl: dict = {"spec": tpl_spec}
    if t.labels or t.annotations:
        tpl["metadata"] = {
            **({"labels": dict(t.labels)} if t.labels else {}),
            **({"annotations": dict(t.annotations)} if t.annotations else {}),
        }
    spec: dict = {"template": tpl, "disruption": dis}
    if np.spec.limits:
        spec["limits"] = dict(np.spec.limits)
    if np.spec.weight:
        spec["weight"] = np.spec.weight
    out = {
        "apiVersion": version,
        "kind": "NodePool",
        "metadata": meta,
        "spec": spec,
    }
    status: dict = {}
    if np.status.resources:
        status["resources"] = dict(np.status.resources)
    if np.status.conditions:
        status["conditions"] = _conditions_to(np.status.conditions)
    if status:
        out["status"] = status
    return out


# ---- NodeClaim ----------------------------------------------------------

def _nodeclaim_from(doc: dict, version: str) -> NodeClaim:
    spec = doc.get("spec", {})
    if version == V1:
        expire = parse_duration(spec.get("expireAfter"))
    else:
        expire = parse_duration(spec.get("terminateAfter") or spec.get("expireAfter"))
    status = doc.get("status", {})
    meta = _meta_from(doc)
    kubelet = dict(spec.get("kubelet", {}))
    if version == V1 and not kubelet:
        stash = meta.annotations.get(KUBELET_COMPAT_ANNOTATION)
        if stash:
            kubelet = json.loads(stash)
    meta.annotations.pop(KUBELET_COMPAT_ANNOTATION, None)
    return NodeClaim(
        metadata=meta,
        spec=NodeClaimSpec(
            taints=_taints_from(spec.get("taints")),
            startup_taints=_taints_from(spec.get("startupTaints")),
            requirements=_reqs_from(spec.get("requirements")),
            resource_requests=dict(spec.get("resources", {}).get("requests", {})),
            kubelet=kubelet,
            node_class_ref=dict(spec.get("nodeClassRef", {})),
            terminate_after=expire,
        ),
        status=NodeClaimStatus(
            provider_id=status.get("providerID", ""),
            image_id=status.get("imageID", ""),
            node_name=status.get("nodeName", ""),
            capacity=dict(status.get("capacity", {})),
            allocatable=dict(status.get("allocatable", {})),
            conditions=_conditions_from(status.get("conditions")),
        ),
    )


def _nodeclaim_to(nc: NodeClaim, version: str) -> dict:
    meta = _meta_to(nc.metadata)
    spec: dict = {}
    if nc.spec.taints:
        spec["taints"] = _taints_to(nc.spec.taints)
    if nc.spec.startup_taints:
        spec["startupTaints"] = _taints_to(nc.spec.startup_taints)
    if nc.spec.requirements:
        spec["requirements"] = _reqs_to(nc.spec.requirements)
    if nc.spec.resource_requests:
        spec["resources"] = {"requests": dict(nc.spec.resource_requests)}
    if nc.spec.node_class_ref:
        spec["nodeClassRef"] = dict(nc.spec.node_class_ref)
    if version == V1:
        spec["expireAfter"] = format_duration(nc.spec.terminate_after)
        if nc.spec.kubelet:
            # same compatibility stash as the NodePool path: kubelet left
            # the v1 NodeClaim spec but must survive the round trip
            meta.setdefault("annotations", {})[KUBELET_COMPAT_ANNOTATION] = (
                json.dumps(nc.spec.kubelet, sort_keys=True)
            )
    else:
        if nc.spec.kubelet:
            spec["kubelet"] = dict(nc.spec.kubelet)
        if nc.spec.terminate_after is not None:
            spec["terminateAfter"] = format_duration(nc.spec.terminate_after)
    status: dict = {}
    if nc.status.provider_id:
        status["providerID"] = nc.status.provider_id
    if nc.status.image_id:
        status["imageID"] = nc.status.image_id
    if nc.status.node_name:
        status["nodeName"] = nc.status.node_name
    if nc.status.capacity:
        status["capacity"] = dict(nc.status.capacity)
    if nc.status.allocatable:
        status["allocatable"] = dict(nc.status.allocatable)
    if nc.status.conditions:
        status["conditions"] = _conditions_to(nc.status.conditions)
    out = {
        "apiVersion": version,
        "kind": "NodeClaim",
        "metadata": meta,
        "spec": spec,
    }
    if status:
        out["status"] = status
    return out


# ---- public surface -----------------------------------------------------

_DECODERS = {"NodePool": _nodepool_from, "NodeClaim": _nodeclaim_from}
_ENCODERS = {NodePool: _nodepool_to, NodeClaim: _nodeclaim_to}


def decode(doc: dict):
    """Wire document (either version) → hub object. The conversion-webhook
    analog on the read/write path (webhooks.go:82-125)."""
    version = doc.get("apiVersion", "")
    if version not in VERSIONS:
        raise ConversionError(f"unsupported apiVersion {version!r}")
    kind = doc.get("kind", "")
    dec = _DECODERS.get(kind)
    if dec is None:
        raise ConversionError(f"unsupported kind {kind!r}")
    return dec(doc, version)


def encode(obj, version: str) -> dict:
    """Hub object → wire document of the requested version."""
    if version not in VERSIONS:
        raise ConversionError(f"unsupported apiVersion {version!r}")
    enc = _ENCODERS.get(type(obj))
    if enc is None:
        raise ConversionError(f"unsupported object {type(obj).__name__}")
    return enc(obj, version)
