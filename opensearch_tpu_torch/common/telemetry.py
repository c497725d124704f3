"""Telemetry: the metrics registry (the port of the metrics half of the
JAX package's ``common/telemetry.py``).

- ``Counter``: a named monotonic count.
- ``Histogram``: a fixed-bucket latency histogram with percentile
  readout (the Prometheus ``histogram_quantile`` estimate: linear inside
  the winning bucket, never above the observed maximum).
- ``MetricsRegistry``: named counters and histograms, created on first
  use and kept for the life of the process; ``stats()`` is the JSON
  readout.

The counters the port increments today: ``search.mesh.fallback`` (a mesh
request demoted to the host scatter, ``indices/service.py``) and the
device breakers' ``device.errors``, ``device.breaker.trips`` and
``device.breaker.closes`` (``common/device_health.py``).

Not ported yet (ROADMAP Queue A item 4, where spans are wired into the
request path): the reference's ``Tracer`` and its spans, the W3C
``traceparent`` propagation, the ``FlightRecorder``, and the registry's
``time_ms`` and ``prometheus_text`` (the ``/_metrics`` scrape).  The
registry is process-global, as in the reference; tests reset it with
``metrics().reset()``.
"""

from __future__ import annotations

import threading
from bisect import bisect_left

# default latency buckets in milliseconds (upper bounds; +inf implied),
# the reference's
DEFAULT_BUCKETS_MS = (0.5, 1, 2, 5, 10, 25, 50, 100, 250, 500, 1000,
                      2500, 5000, 10000, 30000)


class Counter:
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Histogram:
    """Fixed-bucket latency histogram with percentile readout (module
    docstring)."""

    def __init__(self, name: str, buckets=DEFAULT_BUCKETS_MS):
        self.name = name
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)   # last = +inf
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def observe(self, value_ms: float) -> None:
        value_ms = float(value_ms)
        idx = bisect_left(self.buckets, value_ms)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += value_ms
            if value_ms > self._max:
                self._max = value_ms

    @property
    def count(self) -> int:
        return self._count

    def percentile(self, q: float) -> float:
        """q in [0, 100]; linear interpolation inside the target bucket."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
            hi = self._max
        if total == 0:
            return 0.0
        rank = (q / 100.0) * total
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                up = self.buckets[i] if i < len(self.buckets) else hi
                up = max(lo, min(up, hi))
                frac = (rank - cum) / c
                return lo + (up - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return hi

    def bucket_counts(self) -> tuple:
        """``(bucket upper bounds, per-bucket counts, count, sum ms)`` in
        one snapshot; the last count is the +inf bucket."""
        with self._lock:
            return (self.buckets, list(self._counts), self._count,
                    self._sum)

    def stats(self) -> dict:
        buckets, counts, count, total = self.bucket_counts()
        with self._lock:
            mx = self._max
        out = {"count": count,
               "sum_in_millis": round(total, 3),
               "max_in_millis": round(mx, 3)}
        if count:
            out["avg_in_millis"] = round(total / count, 3)
            out["percentiles"] = {
                "50.0": round(self.percentile(50), 3),
                "90.0": round(self.percentile(90), 3),
                "99.0": round(self.percentile(99), 3)}
            cum = 0
            rendered = []
            for le, c in zip(buckets, counts):
                cum += c
                rendered.append({"le": le, "count": cum})
            rendered.append({"le": "+Inf", "count": count})
            out["buckets"] = rendered
        return out


class MetricsRegistry:
    """Named counters + histograms; instruments are created on first use
    and live forever, as in the reference."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def histogram(self, name: str,
                  buckets=DEFAULT_BUCKETS_MS) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name,
                                                Histogram(name, buckets))
        return h

    def stats(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            histograms = dict(self._histograms)
        return {"counters": {n: c.value
                             for n, c in sorted(counters.items())},
                "histograms": {n: h.stats()
                               for n, h in sorted(histograms.items())}}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._histograms.clear()


_metrics = MetricsRegistry()


def metrics() -> MetricsRegistry:
    return _metrics
