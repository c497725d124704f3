"""Device fault tolerance: per-kernel-class circuit breakers (the port of
the JAX package's ``common/device_health.py``).

- ``DeviceHealthService`` keeps one breaker per kernel class (``staging``,
  ``dispatch``, ``batch``, ``mesh``).  A breaker is *closed* (healthy),
  *open* after ``failure_threshold`` consecutive device errors (counted
  in ``device.breaker.trips``), *half_open* once ``open_interval_s`` has
  passed (the next requests run as probes), and closed again on a probe
  that succeeds (``device.breaker.closes``) or open again on one that
  fails.  Every recorded failure counts ``device.errors``.
- ``is_device_error`` is the classifier: torch's device faults
  (``torch.OutOfMemoryError``, ``torch.AcceleratorError``, a
  ``RuntimeError`` whose message is a CUDA or NCCL runtime error), an
  allocator ``MemoryError``, and anything marked ``__device_fault__``.
  Client errors, the breakers' ``CircuitBreakingError`` (an admission
  decision) and a hand kernel's failed launch (``ops/cuda_build.py``
  ``KernelLaunchError``, marked ``__device_fault__ = False``: the
  kernel's fault, which no demotion may answer by doing the kernel's
  work elsewhere) are not device errors.

Only the ``mesh`` class is wired in the port so far: an open ``mesh``
breaker, a mesh that cannot be built or a device error inside the
collective demote a mesh request to the counted host scatter
(``indices/service.py`` ``_mesh_search``).  The other classes, the
result-sanity guard (``check_finite``, ``record_poison``) and the flight
recorder capture on a trip wait for ROADMAP Queue A item 4: their
reference degrades by scoring on the host, which the port does not.

The service is process-global, as the ledger is; tests reset it with
``device_health().reset()``.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Callable, Optional

import torch

from opensearch_tpu_torch.common.errors import OpenSearchTpuError
from opensearch_tpu_torch.common.telemetry import metrics as _metrics

#: the kernel classes with their own breaker (callers may use others;
#: breakers are created on first record)
KERNEL_CLASSES = ("staging", "dispatch", "batch", "mesh")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# a RuntimeError carrying one of these is a CUDA / NCCL runtime fault
_DEVICE_MESSAGE = re.compile(
    r"CUDA error|CUDA out of memory|cuda runtime error|CUBLAS_STATUS_|"
    r"CUDNN_STATUS_|NCCL error|device-side assert")
_TORCH_DEVICE_ERRORS = tuple(
    klass for klass in (getattr(torch, "OutOfMemoryError", None),
                        getattr(torch, "AcceleratorError", None))
    if klass is not None)


class DeviceDegradedError(OpenSearchTpuError):
    """A device-side failure with no equal fallback: the search degrades
    (a partial response at the coordinator), never a 500."""

    status = 503


def is_device_error(exc: BaseException) -> bool:
    """Device-fault classifier (module docstring)."""
    marked = getattr(exc, "__device_fault__", None)
    if marked is not None:
        return bool(marked)
    if isinstance(exc, MemoryError) or isinstance(exc,
                                                  _TORCH_DEVICE_ERRORS):
        return True
    return (isinstance(exc, RuntimeError)
            and not isinstance(exc, OpenSearchTpuError)
            and _DEVICE_MESSAGE.search(str(exc)) is not None)


class _Breaker:
    """One kernel class's circuit-breaker state."""

    __slots__ = ("kind", "state", "streak", "trips", "closes",
                 "failures", "successes", "opened_at", "last_error")

    def __init__(self, kind: str):
        self.kind = kind
        self.state = CLOSED
        self.streak = 0            # consecutive failures while closed
        self.trips = 0
        self.closes = 0
        self.failures = 0
        self.successes = 0
        self.opened_at: Optional[float] = None
        self.last_error: Optional[str] = None

    def to_dict(self, now: float) -> dict:
        out = {"state": self.state, "consecutive_failures": self.streak,
               "trips": self.trips, "closes": self.closes,
               "failures": self.failures, "successes": self.successes}
        if self.opened_at is not None and self.state != CLOSED:
            out["open_for_ms"] = round((now - self.opened_at) * 1000.0, 3)
        if self.last_error:
            out["last_error"] = self.last_error
        return out


class DeviceHealthService:
    """Per-kernel-class circuit breakers over an injectable clock (module
    docstring).  ``allow`` / ``record_success`` / ``record_failure`` are
    the whole caller contract."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self.enabled = True
        self.failure_threshold = 3
        self.open_interval_s = 30.0
        self._breakers: dict[str, _Breaker] = {
            k: _Breaker(k) for k in KERNEL_CLASSES}

    # -- settings consumers ------------------------------------------------

    def set_enabled(self, v: bool) -> None:
        self.enabled = bool(v)

    def set_failure_threshold(self, v: int) -> None:
        self.failure_threshold = max(1, int(v))

    def set_open_interval_s(self, v: float) -> None:
        self.open_interval_s = max(0.0, float(v))

    # -- the caller contract -----------------------------------------------

    def _breaker(self, kind: str) -> _Breaker:
        b = self._breakers.get(kind)
        if b is None:
            with self._lock:
                b = self._breakers.setdefault(kind, _Breaker(kind))
        return b

    def allow(self, kind: str) -> bool:
        """May this kernel class dispatch to the device now?  False only
        while its breaker is open inside its cooldown; once
        ``open_interval_s`` has passed the breaker turns half-open and
        requests run as probes."""
        if not self.enabled:
            return True
        b = self._breaker(kind)
        if b.state == CLOSED:
            return True
        with self._lock:
            if b.state == OPEN:
                if (b.opened_at is not None
                        and self._clock() - b.opened_at
                        >= self.open_interval_s):
                    b.state = HALF_OPEN
                else:
                    return False
            return b.state == HALF_OPEN

    def record_success(self, kind: str) -> None:
        """A device operation of this class completed: resets the failure
        streak; a half-open probe's success closes the breaker."""
        b = self._breaker(kind)
        if b.state == CLOSED and b.streak == 0:
            b.successes += 1       # hot path: no lock, plain increment
            return
        with self._lock:
            b.successes += 1
            b.streak = 0
            if b.state == CLOSED:
                return
            b.state = CLOSED
            b.opened_at = None
            b.closes += 1
        _metrics().counter("device.breaker.closes").inc()

    def record_failure(self, kind: str,
                       exc: Optional[BaseException] = None) -> None:
        """One device error of this class.  ``failure_threshold``
        consecutive errors open the breaker; a failure while half-open
        opens it again at once.  ``exc`` is marked, so that a handler
        further out that catches the same fault does not count it
        twice."""
        if exc is not None:
            if getattr(exc, "_dh_recorded", False):
                return
            try:
                exc._dh_recorded = True
            except AttributeError:     # a slotted exception: count anyway
                pass
        b = self._breaker(kind)
        now = self._clock()
        tripped = False
        with self._lock:
            b.failures += 1
            b.streak += 1
            if exc is not None:
                b.last_error = f"{type(exc).__name__}: {exc}"[:200]
            if self.enabled and b.state == HALF_OPEN:
                b.state = OPEN
                b.opened_at = now
            elif self.enabled and b.state == CLOSED \
                    and b.streak >= self.failure_threshold:
                b.state = OPEN
                b.opened_at = now
                b.trips += 1
                tripped = True
        _metrics().counter("device.errors").inc()
        if tripped:
            _metrics().counter("device.breaker.trips").inc()

    # -- readout -----------------------------------------------------------

    def stats(self) -> dict:
        """The ``device.health`` block of the reference's
        ``_nodes/stats``."""
        now = self._clock()
        with self._lock:
            breakers = {k: b.to_dict(now)
                        for k, b in sorted(self._breakers.items())}
        return {"enabled": self.enabled,
                "failure_threshold": self.failure_threshold,
                "open_interval_s": self.open_interval_s,
                "breakers": breakers}

    def breaker_states(self) -> dict:
        """{kind: state} snapshot."""
        with self._lock:
            return {k: b.state for k, b in self._breakers.items()}

    def reset(self) -> None:
        """Every breaker closed, counts zeroed, settings at their
        defaults."""
        with self._lock:
            self._breakers = {k: _Breaker(k) for k in KERNEL_CLASSES}
            self.enabled = True
            self.failure_threshold = 3
            self.open_interval_s = 30.0


_health = DeviceHealthService()


def device_health() -> DeviceHealthService:
    return _health
