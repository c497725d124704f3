"""Hierarchical circuit breakers: memory budgets that reject work
instead of dying (a copy of the JAX package's ``common/breakers.py``).

Analog of the reference's HierarchyCircuitBreakerService (ref
indices/breaker/HierarchyCircuitBreakerService.java:1,
common/breaker/).  Children account independent concerns and a parent
caps their sum:

- ``fielddata`` — device-staged segment columns (the HBM budget; in
  this package nothing charges it until the pager is ported);
- ``request``   — per-request transient host memory (here: the shard
  request cache's entries);
- ``in_flight_requests`` — raw HTTP payload bytes being parsed.

Tripping raises ``CircuitBreakingError`` (429, like the reference's
too_many_requests mapping) with the would-be usage in the message.
"""

from __future__ import annotations

import threading
from typing import Optional

from opensearch_tpu_torch.common.errors import OpenSearchTpuError


class CircuitBreakingError(OpenSearchTpuError):
    status = 429


class CircuitBreaker:
    def __init__(self, name: str, limit: int, parent: "ParentBreaker"):
        self.name = name
        self.limit = int(limit)
        self.parent = parent
        self.used = 0
        self.trip_count = 0
        self._lock = threading.Lock()

    def add_estimate(self, bytes_: int, label: str = "<unknown>") -> None:
        """Reserve ``bytes_`` against this breaker + the parent; raises
        CircuitBreakingError without reserving when either would trip."""
        bytes_ = int(bytes_)
        if bytes_ <= 0:
            return
        with self._lock:
            new = self.used + bytes_
            if new > self.limit:
                self.trip_count += 1
                raise CircuitBreakingError(
                    f"[{self.name}] Data too large, data for [{label}] "
                    f"would be [{new}b], which is larger than the limit "
                    f"of [{self.limit}b]")
            self.parent.check(bytes_, self.name, label)
            self.used = new

    def release(self, bytes_: int) -> None:
        bytes_ = int(bytes_)
        if bytes_ <= 0:
            return
        with self._lock:
            self.used = max(0, self.used - bytes_)

    def stats(self) -> dict:
        return {"limit_size_in_bytes": self.limit,
                "estimated_size_in_bytes": self.used,
                "tripped": self.trip_count}


class ParentBreaker:
    def __init__(self, limit: int):
        self.limit = int(limit)
        self.trip_count = 0
        self._children: list[CircuitBreaker] = []
        self._lock = threading.Lock()

    def check(self, extra: int, child: str, label: str) -> None:
        with self._lock:
            total = sum(c.used for c in self._children) + extra
            if total > self.limit:
                self.trip_count += 1
                raise CircuitBreakingError(
                    f"[parent] Data too large, data for [{label}] (child "
                    f"[{child}]) would be [{total}b], which is larger "
                    f"than the limit of [{self.limit}b]")


class CircuitBreakerService:
    """The node's breaker registry.  Limits are plain byte counts taken
    from settings (defaults sized for a dev host; production tunes them
    like the reference's indices.breaker.* settings)."""

    GB = 1 << 30

    def __init__(self, settings: Optional[dict] = None):
        s = settings or {}
        parent_limit = int(s.get("breaker.total.limit", 12 * self.GB))
        self.parent = ParentBreaker(parent_limit)
        self.fielddata = self._child(
            "fielddata", int(s.get("breaker.fielddata.limit",
                                   8 * self.GB)))
        self.request = self._child(
            "request", int(s.get("breaker.request.limit", 4 * self.GB)))
        self.in_flight = self._child(
            "in_flight_requests",
            int(s.get("breaker.inflight.limit", 2 * self.GB)))

    def _child(self, name: str, limit: int) -> CircuitBreaker:
        b = CircuitBreaker(name, limit, self.parent)
        self.parent._children.append(b)
        return b

    def stats(self) -> dict:
        out = {b.name: b.stats()
               for b in (self.fielddata, self.request, self.in_flight)}
        out["parent"] = {
            "limit_size_in_bytes": self.parent.limit,
            "estimated_size_in_bytes": sum(
                b.used for b in self.parent._children),
            "tripped": self.parent.trip_count}
        return out


# Node-global default service: library users (engine/searcher) account
# against this unless a node installs its own configured instance.
_default = CircuitBreakerService()


def breaker_service() -> CircuitBreakerService:
    return _default

