"""Metrics decorator for any CloudProvider.

Mirror of the reference's pkg/cloudprovider/metrics/cloudprovider.go: wraps
an inner provider, timing every SPI method into a duration histogram and
counting errors by method — the decorator precedent the Solver interface
follows for wrapping device and host implementations behind one seam.

The port's copy of ``karpenter_tpu/cloudprovider/metrics.py`` (imports changed).
"""

from __future__ import annotations

import time

from karpenter_tpu_torch.cloudprovider.types import CloudProvider
from karpenter_tpu_torch.operator import metrics as m


class MetricsCloudProvider(CloudProvider):
    def __init__(self, inner: CloudProvider, registry=None):
        self.inner = inner
        self.registry = registry or m.REGISTRY
        # offering-risk gauge bookkeeping: instance-type name -> the
        # (type, zone, ct) label keys last exported for it, so a refresh
        # retires exactly the stale series of the types it re-saw
        self._risk_keys: dict = {}

    def _timed(self, method: str, fn, *args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        except Exception as e:
            self.registry.counter(m.CLOUDPROVIDER_ERRORS).inc(
                method=method, provider=self.inner.name(), error=type(e).__name__)
            raise
        finally:
            self.registry.histogram(m.CLOUDPROVIDER_DURATION).observe(
                time.perf_counter() - t0, method=method, provider=self.inner.name())

    def name(self) -> str:
        return self.inner.name()

    def create(self, node_claim):
        return self._timed("Create", self.inner.create, node_claim)

    def delete(self, node_claim):
        return self._timed("Delete", self.inner.delete, node_claim)

    def get(self, provider_id):
        return self._timed("Get", self.inner.get, provider_id)

    def list(self):
        return self._timed("List", self.inner.list)

    def get_instance_types(self, node_pool):
        its = self._timed(
            "GetInstanceTypes", self.inner.get_instance_types, node_pool)
        self._export_offering_risk(its)
        return its

    def _export_offering_risk(self, its):
        """Refresh the ``karpenter_offering_risk`` gauge from the catalog
        snapshot (offerings with a KNOWN nonzero risk only — on-demand's
        0.0 and unknown Nones would just multiply series). Catalog lists
        are memoized by the callers (get_candidates' catalog cache, the
        solver's type cache), so this runs per cache fill, not per poll.
        Reconciled PER TYPE, never a family-wide clear: providers may
        filter catalogs per nodepool, and one pool's refresh must retire
        only the stale series of the types it re-saw — not wipe every
        other pool's. (A type that vanishes from the catalog entirely
        keeps its last series until some call re-lists it; per-pool
        attribution isn't available at this seam.)"""
        g = self.registry.gauge(
            m.OFFERING_RISK,
            "per-offering interruption-risk signal (spot resilience)")
        for it in its:
            new = {}
            for o in it.offerings:
                if o.interruption_risk:
                    new[(it.name, o.zone, o.capacity_type)] = (
                        o.interruption_risk)
            for tn, z, ct in self._risk_keys.get(it.name, set()) - new.keys():
                g.remove(instance_type=tn, zone=z, capacity_type=ct)
            for (tn, z, ct), v in new.items():
                g.set(v, instance_type=tn, zone=z, capacity_type=ct)
            self._risk_keys[it.name] = set(new)

    def is_drifted(self, node_claim):
        return self._timed("IsDrifted", self.inner.is_drifted, node_claim)

    def interruption_notices(self):
        # explicit delegation: the CloudProvider base default ([]) would
        # otherwise shadow __getattr__ and swallow the inner provider's
        # (or an armed ChaosCloud's) notice feed
        return self._timed(
            "InterruptionNotices", self.inner.interruption_notices)

    def __getattr__(self, item):
        # pass through provider-specific surface (e.g. kwok's .created)
        return getattr(self.inner, item)
