"""Reader contexts: scroll cursors, points in time, sliced scans (the port
of the JAX package's ``search/contexts.py``).

Analog of the reference's server-held reader leases (ref
search/internal/PitReaderContext.java, SearchService.java:170,185
keepalive machinery, search/slice/SliceBuilder.java:81).  A context pins
a ``ShardSearcher``, which is already a point-in-time snapshot (its
``ShardContext`` captured the live bitmaps at acquire; segments are
immutable), so deletes and refreshes after creation never change what
the context sees, exactly like a held Lucene reader.

- **Scroll**: every matched row is ordered once on creation, on the
  searcher's device (``ShardSearcher.scan_rows``: ``sorting.OrderedRows``,
  the rows' flat positions and their sort keys or scores as tensors), and
  paged by slicing those arrays: a page's rows are the only ones read
  back.  The cursor is charged to the request breaker at the reference's
  96 bytes a row (``ScrollContext._ROW_BYTES``), so the breaker trips at
  the reference's sizes; keepalive bounds the damage.
- **PIT**: pins only the searcher; each page re-runs the query against
  the frozen snapshot with ``search_after`` pagination.
- **Slice**: ``{"id": i, "max": n}`` partitions the doc space by a hash
  of (segment, local doc): n independent cursors over disjoint doc sets
  whose union is exactly the full set (``sorting.slice_filter``, which
  ``scan_rows`` applies).

``parse_keepalive`` parses a keep-alive; ``ReaderContextRegistry`` holds
the open contexts under their ``uuid4`` ids, with keepalive expiry on an
injectable clock.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Callable, Optional

from opensearch_tpu_torch.common.errors import (IllegalArgumentError,
                                                OpenSearchTpuError)


class SearchContextMissingError(OpenSearchTpuError):
    status = 404


def parse_keepalive(value, default_ms: int = 60_000) -> int:
    if value is None:
        return default_ms
    if isinstance(value, (int, float)):
        return int(value)
    s = str(value)
    units = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000,
             "d": 86_400_000}
    try:
        for suffix, mult in sorted(units.items(),
                                   key=lambda kv: -len(kv[0])):
            if s.endswith(suffix):
                return int(float(s[: -len(suffix)]) * mult)
        return int(float(s) * 1000)
    except ValueError:
        raise IllegalArgumentError(
            f"failed to parse keep-alive [{s}]") from None


class ScrollContext:
    _ROW_BYTES = 96         # the reference's host cost of a row

    def __init__(self, searcher, ordered, total: int, page_size: int,
                 source_spec, index_name: str):
        """``ordered``: the ``sorting.OrderedRows`` of ``scan_rows``."""
        from opensearch_tpu_torch.common.breakers import breaker_service
        self.searcher = searcher
        self.ordered = ordered
        self.total = total
        self.page_size = page_size
        self.source_spec = source_spec
        self.index_name = index_name
        self.pos = 0
        # the cursor is the scroll's memory cost: charged to the request
        # breaker until the context closes or expires
        self._breaker = breaker_service().request
        self._reserved = len(ordered) * self._ROW_BYTES
        self._breaker.add_estimate(self._reserved, label="scroll context")

    def next_page(self) -> list:
        """The next page's rows (``seg``, ``local``, ``score``, ``sort``),
        read back from the device in one copy."""
        stop = min(self.pos + self.page_size, len(self.ordered))
        if stop <= self.pos:
            return []
        rows, _ = self.ordered.take(positions=slice(self.pos, stop))
        self.pos = stop
        return rows

    def release(self):
        self._breaker.release(self._reserved)
        self._reserved = 0


class PitContext:
    def __init__(self, searcher, index_name: str):
        self.searcher = searcher
        self.index_name = index_name


class ReaderContextRegistry:
    """Keepalive-bounded registry of scroll and PIT contexts.  ``now_fn``
    is injectable so tests drive expiry deterministically.  The node's
    dynamic settings ``search.max_keep_alive``,
    ``search.default_keep_alive`` and ``search.max_open_scroll_context``
    are not ported (ROADMAP Queue A): their defaults apply."""

    def __init__(self, now_fn: Callable[[], float] = time.monotonic,
                 max_open: int = 500):
        self._now = now_fn
        self._max_open = max_open
        self._lock = threading.Lock()
        # id -> (ctx, expires_at_monotonic_ms, keepalive_ms)
        self._ctxs: dict[str, tuple[object, float, int]] = {}

    @staticmethod
    def _release(ctx):
        rel = getattr(ctx, "release", None)
        if rel is not None:
            rel()

    def _reap(self):
        now = self._now() * 1000
        for cid in [c for c, (_ctx, exp, _ka) in self._ctxs.items()
                    if exp <= now]:
            self._release(self._ctxs.pop(cid)[0])

    # search.max_keep_alive's default
    max_keep_alive_s = 24 * 3600.0

    # search.default_keep_alive's default: the keepalive a PIT opened
    # without an explicit keep_alive gets
    default_keep_alive_s = 300.0

    def _check_keepalive(self, keepalive_ms: int):
        limit_ms = int(self.max_keep_alive_s * 1000)
        if keepalive_ms > limit_ms:
            raise IllegalArgumentError(
                f"Keep alive for request ({keepalive_ms}ms) is too "
                f"large. It must be less than ({limit_ms}ms). This "
                "limit can be set by changing the [search.max_keep_"
                "alive] cluster level setting.")

    def open(self, ctx, keepalive_ms: int) -> str:
        self._check_keepalive(keepalive_ms)
        with self._lock:
            self._reap()
            if len(self._ctxs) >= self._max_open:
                raise IllegalArgumentError(
                    f"trying to open too many search contexts "
                    f"(>{self._max_open}) — close scrolls/PITs or let "
                    "keepalives lapse")
            cid = uuid.uuid4().hex
            self._ctxs[cid] = (ctx, self._now() * 1000 + keepalive_ms,
                               keepalive_ms)
            return cid

    def get(self, cid: str, keepalive_ms: Optional[int] = None):
        """Fetch and touch (every access extends the lease, like the
        reference's keepalive refresh on use)."""
        with self._lock:
            self._reap()
            entry = self._ctxs.get(cid)
            if entry is None:
                raise SearchContextMissingError(
                    f"No search context found for id [{cid}]")
            ctx, _exp, ka = entry
            if keepalive_ms is not None:
                self._check_keepalive(keepalive_ms)
                ka = keepalive_ms
            self._ctxs[cid] = (ctx, self._now() * 1000 + ka, ka)
            return ctx

    def close(self, cid: str) -> bool:
        with self._lock:
            entry = self._ctxs.pop(cid, None)
            if entry is not None:
                self._release(entry[0])
            return entry is not None

    def close_all(self) -> int:
        with self._lock:
            n = len(self._ctxs)
            for ctx, _exp, _ka in self._ctxs.values():
                self._release(ctx)
            self._ctxs.clear()
            return n

    def count(self) -> int:
        with self._lock:
            self._reap()
            return len(self._ctxs)
