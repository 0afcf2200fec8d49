"""Kubernetes resource-quantity parsing and formatting.

Replaces the reference's dependence on k8s.io/apimachinery resource.Quantity
(used throughout pkg/utils/resources). Internally every quantity is a float:
cpu in cores, memory/storage in bytes, counts as plain numbers. Parsing
accepts the k8s grammar: decimal ("1.5"), milli ("1500m"), binary suffixes
("1Gi"), and decimal suffixes ("1G").
"""

from __future__ import annotations

_BINARY = {
    "Ki": 2**10,
    "Mi": 2**20,
    "Gi": 2**30,
    "Ti": 2**40,
    "Pi": 2**50,
    "Ei": 2**60,
}
_DECIMAL = {
    "n": 1e-9,
    "u": 1e-6,
    "m": 1e-3,
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
}


def parse_quantity(value) -> float:
    """Parse a k8s quantity string (or passthrough number) to a float."""
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip()
    if not s:
        return 0.0
    for suffix, mult in _BINARY.items():
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * mult
    # longest decimal suffixes are single-char; check last char
    last = s[-1]
    if last in _DECIMAL:
        return float(s[:-1]) * _DECIMAL[last]
    return float(s)


def format_quantity(value: float, resource: str = "") -> str:
    """Human-readable formatting; memory-like resources in binary units."""
    if resource in ("memory", "ephemeral-storage") and value >= 2**20:
        for suffix in ("Ei", "Pi", "Ti", "Gi", "Mi", "Ki"):
            mult = _BINARY[suffix]
            if value >= mult and abs(value / mult - round(value / mult, 3)) < 1e-9:
                return f"{round(value / mult, 3):g}{suffix}"
    if resource == "cpu" and 0 < value < 10 and abs(value * 1000 - round(value * 1000)) < 1e-9:
        m = round(value * 1000)
        if m % 1000:
            return f"{m}m"
    return f"{value:g}"
