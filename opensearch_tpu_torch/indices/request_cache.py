"""Shard-level search request cache (a copy of the JAX package's
``indices/request_cache.py``, without the node-level clear, resize
and stats that only unported routes and settings call).

Analog of the reference's ``indices/IndicesRequestCache.java``: a
node-level cache of shard query-phase results keyed on (shard owner,
reader generation, canonicalized request body).  Keying on the reader
generation makes staleness structurally impossible — a refresh, mapping
change or checkpoint install bumps the generation and every old key
stops matching; ``IndexService._dirty`` additionally drops the dead
generation's entries eagerly so memory follows visibility.

Values are the JSON-serialized response bytes, not the response object:

- a hit deserializes a FRESH dict, so per-request coordinator mutations
  (``_shards`` rewrites, ``track_total_hits`` folding) can never poison
  the cached copy, and
- the round-trip guarantees a hit renders byte-identical to the miss
  that populated it (including ``took``) — the property the tests pin.

Residency is bounded by ``DEFAULT_MAX_BYTES`` (the reference's
``indices.requests.cache.size`` default; the dynamic setting is not
ported) and charged against the ``request`` circuit breaker via
the underlying ``common/cache.py`` primitive.  Responses that are not
JSON-serializable (device partials) or that timed out (partial results)
are computed but never admitted.

Process-global singleton like ``breaker_service()``: multi-node-in-one-
process tests share it, which is safe because every key carries the
owning IndexService's uuid (two nodes' copies of the same shard never
collide).  It is this package's own: a process that also runs the JAX
package's node keeps two request caches that never see each other.
"""

from __future__ import annotations

import json
import threading
from typing import Callable

from opensearch_tpu_torch.common.cache import EVICTED, Cache

DEFAULT_MAX_BYTES = 64 << 20          # indices.requests.cache.size default


class IndicesRequestCache:
    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES):
        self._lock = threading.Lock()
        # index name -> {"hit_count", "miss_count", "evictions"}
        self._per_index: dict[str, dict] = {}
        self._cache = Cache(
            "request_cache", max_weight=int(max_bytes),
            weigher=self._weigh, breaker="request",
            removal_listener=self._on_remove)

    # key = (svc_uuid, shard_key, reader_gen, body_key)
    # value = (index_name, payload_bytes)

    @staticmethod
    def _weigh(key, value) -> int:
        return len(key[3]) + len(value[1]) + 64

    def _on_remove(self, key, value, reason: str) -> None:
        if reason == EVICTED:
            with self._lock:
                self._index_stats(value[0])["evictions"] += 1

    def _index_stats(self, index: str) -> dict:
        return self._per_index.setdefault(
            index, {"hit_count": 0, "miss_count": 0, "evictions": 0})

    @staticmethod
    def request_key(body: dict) -> str:
        """Canonical request identity: key order in the body must not
        change the cache key (raises TypeError for unserializable
        bodies — those are uncacheable anyway)."""
        return json.dumps(body or {}, sort_keys=True,
                          separators=(",", ":"))

    # -- the read path -----------------------------------------------------

    def get_or_compute(self, *, index: str, svc_uuid: str, shard_key: str,
                       reader_gen: int, body: dict,
                       compute: Callable[[], dict]) -> tuple[dict, bool]:
        """Serve ``compute()``'s response through the cache; returns
        (response, was_hit).  Uncacheable requests/responses fall
        through to a plain compute."""
        try:
            bkey = self.request_key(body)
        except (TypeError, ValueError):
            return compute(), False
        key = (svc_uuid, str(shard_key), int(reader_gen), bkey)
        cached = self._cache.get(key)
        if cached is not None:
            with self._lock:
                self._index_stats(index)["hit_count"] += 1
            return json.loads(cached[1]), True
        resp = compute()
        with self._lock:
            self._index_stats(index)["miss_count"] += 1
        # partial results must never be replayed as complete ones
        if resp.get("timed_out") or \
                (resp.get("resp") or {}).get("timed_out"):
            return resp, False
        try:
            payload = json.dumps(resp, separators=(",", ":")).encode()
        except (TypeError, ValueError):
            return resp, False           # device partials et al.
        self._cache.put(key, (index, payload))
        return resp, False

    # -- invalidation ------------------------------------------------------

    def invalidate_service(self, svc_uuid: str) -> int:
        """Drop every entry owned by one IndexService instance (refresh /
        mapping change / shard set change / close)."""
        return self._cache.invalidate_if(lambda k, v: k[0] == svc_uuid)

    def stats_for_index(self, index: str) -> dict:
        """Per-index ``_stats`` section."""
        memory = sum(w for _k, v, w in self._cache.entries()
                     if v[0] == index)
        entries = sum(1 for _k, v, _w in self._cache.entries()
                      if v[0] == index)
        with self._lock:
            counts = dict(self._per_index.get(
                index, {"hit_count": 0, "miss_count": 0, "evictions": 0}))
        return {"memory_size_in_bytes": memory, "entries": entries,
                **counts}


# node-global default instance (the breaker_service() singleton pattern)
_default = IndicesRequestCache()


def request_cache() -> IndicesRequestCache:
    return _default

