"""Host-port conflict tracking per simulated node.

Semantics from the reference's pkg/scheduling/hostportusage.go:34-90: two
hostPort reservations conflict when protocols match and (ip overlap) and
port equality; 0.0.0.0 overlaps every ip.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HostPort:
    ip: str
    port: int
    protocol: str = "TCP"

    def conflicts(self, other: "HostPort") -> bool:
        if self.protocol != other.protocol or self.port != other.port:
            return False
        if self.ip == "0.0.0.0" or other.ip == "0.0.0.0" or self.ip == "" or other.ip == "":
            return True
        return self.ip == other.ip


def pod_host_ports(pod) -> list:
    out = []
    for hp in getattr(pod, "host_ports", None) or []:
        if isinstance(hp, HostPort):
            out.append(hp)
        elif isinstance(hp, (tuple, list)):
            ip, port, *rest = hp
            out.append(HostPort(ip=ip or "0.0.0.0", port=int(port), protocol=rest[0] if rest else "TCP"))
        else:
            out.append(HostPort(ip="0.0.0.0", port=int(hp)))
    for c in getattr(pod, "containers", None) or []:
        for p in c.get("ports", []) or []:
            if p.get("hostPort"):
                out.append(
                    HostPort(
                        ip=p.get("hostIP") or "0.0.0.0",
                        port=int(p["hostPort"]),
                        protocol=p.get("protocol", "TCP"),
                    )
                )
    return out


class HostPortUsage:
    """Per-node in-use host ports (hostportusage.go:34)."""

    def __init__(self):
        self._by_pod: dict = {}  # pod key -> [HostPort]

    def conflicts(self, pod, ports=None) -> str | None:
        ports = pod_host_ports(pod) if ports is None else ports
        for owner, used in self._by_pod.items():
            for u in used:
                for p in ports:
                    if p.conflicts(u):
                        return f"port {p.port}/{p.protocol} in use by pod {owner}"
        return None

    def add(self, pod):
        ports = pod_host_ports(pod)
        if not ports:
            # a port-less pod reserves nothing: storing its empty entry
            # only bloats every snapshot/fork copy to O(pods-on-node)
            self._by_pod.pop(pod.key(), None)
            return
        self._by_pod[pod.key()] = ports

    def remove(self, pod_key: str):
        self._by_pod.pop(pod_key, None)

    def copy(self) -> "HostPortUsage":
        out = HostPortUsage()
        out._by_pod = {k: list(v) for k, v in self._by_pod.items()}
        return out
