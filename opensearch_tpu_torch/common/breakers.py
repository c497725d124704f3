"""Hierarchical circuit breakers: memory budgets that reject work
instead of dying (a copy of the JAX package's ``common/breakers.py``).

Analog of the reference's HierarchyCircuitBreakerService (ref
indices/breaker/HierarchyCircuitBreakerService.java:1,
common/breaker/).  Children account independent concerns and a parent
caps their sum:

- ``fielddata`` — device-staged segment columns (the HBM budget: each
  ``DeviceSegment`` charges twice its segment's host footprint, released
  on eviction or collection, ``release_later``);
- ``request``   — per-request transient host memory (here: the shard
  request cache's entries);
- ``in_flight_requests`` — raw HTTP payload bytes being parsed.

Tripping raises ``CircuitBreakingError`` (429, like the reference's
too_many_requests mapping) with the would-be usage in the message.
"""

from __future__ import annotations

import collections
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
        self._used = 0
        self._later: collections.deque = collections.deque()
        self.trip_count = 0
        self._lock = threading.Lock()

    @property
    def used(self) -> int:
        with self._lock:
            self._drain()
            return self._used

    def _drain(self) -> None:
        """Apply the releases ``release_later`` queued (lock held)."""
        while self._later:
            self._used = max(0, self._used - self._later.popleft())

    def add_estimate(self, bytes_: int, label: str = "<unknown>") -> None:
        """Reserve ``bytes_`` against this breaker + the parent; raises
        CircuitBreakingError without reserving when either would trip."""
        bytes_ = int(bytes_)
        if bytes_ <= 0:
            return
        with self._lock:
            self._drain()
            new = self._used + bytes_
            if new > self.limit:
                self.trip_count += 1
                raise CircuitBreakingError(
                    f"[{self.name}] Data too large, data for [{label}] "
                    f"would be [{new}b], which is larger than the limit "
                    f"of [{self.limit}b]")
            self.parent.check(bytes_, self.name, label)
            self._used = new

    def release(self, bytes_: int) -> None:
        bytes_ = int(bytes_)
        if bytes_ <= 0:
            return
        with self._lock:
            self._drain()
            self._used = max(0, self._used - bytes_)

    def release_later(self, bytes_: int) -> None:
        """``release`` from a finalizer: garbage collection may run it on
        a thread that holds this breaker's lock, so it only queues the
        bytes (one atomic append); the next use of the breaker applies
        them."""
        if int(bytes_) > 0:
            self._later.append(int(bytes_))

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
            # the children's counts as they stand (a child calls this
            # holding its own lock)
            total = sum(c._used for c in self._children) + extra
            if total > self.limit:
                self.trip_count += 1
                raise CircuitBreakingError(
                    f"[parent] Data too large, data for [{label}] (child "
                    f"[{child}]) would be [{total}b], which is larger "
                    f"than the limit of [{self.limit}b]")


class CircuitBreakerService:
    """The node's breaker registry.  Limits are plain byte counts taken
    from settings (defaults sized for a dev host; production tunes them
    like the reference's indices.breaker.* settings).  Unless
    ``breaker.fielddata.limit`` is set, the first CUDA view staged raises
    the fielddata default to the card (``size_for``)."""

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
        self._fixed = {k for k in ("breaker.fielddata.limit",
                                   "breaker.total.limit") if k in s}
        self._sized: set[str] = set()

    def size_for(self, device) -> None:
        """Size the fielddata default to a CUDA ``device``: twice the
        card's memory, since a staged view charges twice its segment's
        host footprint, so the breaker trips about when the card is full
        (the dev-host default would refuse a few GB).  The parent limit
        rises by as much.  Once per device; a limit set in the settings
        stays as set; the CPU keeps the defaults."""
        if device.type != "cuda" or "breaker.fielddata.limit" in self._fixed:
            return
        key = str(device)
        if key in self._sized:
            return
        import torch

        card = torch.cuda.get_device_properties(device).total_memory
        with self.fielddata._lock:
            if key in self._sized:
                return
            self._sized.add(key)
            grow = max(0, 2 * int(card) - self.fielddata.limit)
            self.fielddata.limit += grow
            if "breaker.total.limit" not in self._fixed:
                self.parent.limit += grow

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

