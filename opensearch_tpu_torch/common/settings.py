"""Time values of settings and request parameters (the part of the JAX
package's ``common/settings.py`` that the port reads: ``parse_time``, for
a search request's ``timeout``).  The typed settings registry is not
ported (ROADMAP Queue A)."""

from __future__ import annotations

_TIME_UNITS = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}


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
