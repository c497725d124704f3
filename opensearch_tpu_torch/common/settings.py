"""Time and byte values of settings and request parameters (the part of
the JAX package's ``common/settings.py`` that the port reads:
``parse_time``, for a search request's ``timeout``, and ``parse_bytes``,
for a node's ``device.memory.budget_bytes`` and
``device.pager.page_bytes``).  The typed settings registry is not ported
(ROADMAP Queue A)."""

from __future__ import annotations

_TIME_UNITS = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}
_BYTE_UNITS = {"b": 1, "kb": 1024, "mb": 1024**2, "gb": 1024**3,
               "tb": 1024**4}


def parse_time(value) -> float:
    """'30s' / '500ms' / '1m' -> seconds (common/unit/TimeValue analog)."""
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip().lower()
    if s == "-1":
        return -1.0
    for suffix in sorted(_TIME_UNITS, key=len, reverse=True):
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * _TIME_UNITS[suffix]
    return float(s)


def parse_bytes(value) -> int:
    """'512mb' -> bytes (core/common/unit/ByteSizeValue analog)."""
    if isinstance(value, (int, float)):
        return int(value)
    s = str(value).strip().lower()
    if s == "-1":
        return -1
    for suffix in sorted(_BYTE_UNITS, key=len, reverse=True):
        if s.endswith(suffix):
            return int(float(s[: -len(suffix)]) * _BYTE_UNITS[suffix])
    return int(s)
