"""Caches that threads may share.

- ``BoundedCache``: the searcher's plan, prepared-bindings and batch
  caches.  Eviction is first in, first out: once ``limit`` entries are
  held, adding a new key drops the oldest.  Every read and write holds
  the lock, so two threads never evict the same key.
- ``Cache``: the JAX package's weighted LRU cache
  (``opensearch_tpu/common/cache.py``, the analog of the reference's
  ``common/cache/Cache.java``) that the shard request cache is built on:
  a per-entry weigher, max-weight LRU eviction, a removal listener told
  the removal reason, an optional circuit breaker
  charged for every resident byte (a put that would trip it first
  evicts the cache's own LRU tail, then skips caching), and a
  ``stats()`` readout.  Left out: the reference's per-cache telemetry
  counters (``cache.<name>.{hits,misses,evictions}``; telemetry has no
  counterpart in this package yet, and ``stats()`` carries the same
  counts), and its TTL, dynamic resize, compute-if-absent and single-key
  invalidation, which no caller here uses.
- ``attached_cache``: a ``Cache`` kept on its owner (a segment, a
  nested block, a searcher's compile context), whose breaker charge is
  released when the owner dies (the reference's ``attached_cache``).
"""

from __future__ import annotations

import sys
import threading
import weakref
from collections import OrderedDict
from typing import Callable, Optional

from opensearch_tpu_torch.common.breakers import CircuitBreakingError


class BoundedCache:
    """``{key: value}`` of at most ``limit`` entries, safe across
    threads."""

    def __init__(self, limit: int, on_drop: Optional[Callable] = None):
        """``on_drop(key, value)`` runs, outside the lock, for each entry
        the limit pushes out or ``drop_where`` removes."""
        self.limit = int(limit)
        self.on_drop = on_drop
        self._entries: dict = {}
        self._lock = threading.Lock()

    def get(self, key, default=None):
        with self._lock:
            return self._entries.get(key, default)

    def put(self, key, value):
        """Cache ``value`` under ``key`` unless the key is already held;
        returns the value the cache holds for ``key`` after the call."""
        dropped = None
        with self._lock:
            kept = self._entries.get(key)
            if kept is not None:
                return kept
            if len(self._entries) >= self.limit:
                old = next(iter(self._entries))
                dropped = (old, self._entries.pop(old))
            self._entries[key] = value
        if dropped is not None and self.on_drop is not None:
            self.on_drop(*dropped)
        return value

    def get_or_make(self, key, make):
        """The cached value of ``key``, else ``make()``, cached.  ``make``
        runs outside the lock, so two threads may both make a missing
        value; the first one cached is returned to both."""
        value = self.get(key)
        return self.put(key, make()) if value is None else value

    def drop_where(self, pred: Callable) -> int:
        """Remove every entry whose key satisfies ``pred``; returns how
        many."""
        with self._lock:
            gone = [(k, v) for k, v in self._entries.items() if pred(k)]
            for k, _v in gone:
                del self._entries[k]
        if self.on_drop is not None:
            for k, v in gone:
                self.on_drop(k, v)
        return len(gone)

    def clear(self) -> None:
        self.drop_where(lambda _k: True)

    def values(self) -> list:
        """A snapshot of the cached values."""
        with self._lock:
            return list(self._entries.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# removal reasons (RemovalNotification.RemovalReason analog)
EXPLICIT = "explicit"        # invalidate_if()
REPLACED = "replaced"        # put() over an existing key
EVICTED = "evicted"          # weight pressure pushed it out


def estimate_weight(obj) -> int:
    """Cheap recursive byte estimate for cache weighers: exact for
    bytes/str/array-likes (``nbytes``: numpy arrays and torch tensors),
    structural for containers, 8 for scalars."""
    if obj is None:
        return 8
    nbytes = getattr(obj, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    if isinstance(obj, (bytes, bytearray)):
        return len(obj)
    if isinstance(obj, str):
        return 2 * len(obj) + 40
    if isinstance(obj, (int, float, bool)):
        return 8
    if isinstance(obj, dict):
        return 64 + sum(estimate_weight(k) + estimate_weight(v)
                        for k, v in obj.items())
    if isinstance(obj, (list, tuple, set, frozenset)):
        return 56 + sum(estimate_weight(v) for v in obj)
    try:
        return sys.getsizeof(obj)
    except TypeError:
        return 64


def _default_weigher(key, value) -> int:
    return estimate_weight(key) + estimate_weight(value)


class _Entry:
    __slots__ = ("value", "weight")

    def __init__(self, value, weight: int):
        self.value = value
        self.weight = weight


class Cache:
    """Thread-safe weighted LRU cache.

    ``breaker``: a ``CircuitBreaker`` object, or a child name
    ("fielddata"/"request"/"in_flight") resolved against the installed
    breaker service at charge time.  ``max_weight=None`` disables weight
    eviction (the breaker still bounds residency).  Removal listeners run
    under the cache's lock and must not re-enter the cache.
    """

    def __init__(self, name: str, *,
                 max_weight: Optional[int] = None,
                 weigher: Optional[Callable] = None,
                 removal_listener: Optional[Callable] = None,
                 breaker=None):
        self.name = name
        self.max_weight = max_weight
        self.weigher = weigher or _default_weigher
        self.removal_listener = removal_listener
        self._breaker_ref = breaker
        self._lock = threading.RLock()
        self._entries: "OrderedDict" = OrderedDict()
        self._weight = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._rejections = 0

    # -- breaker plumbing --------------------------------------------------

    def _breaker(self):
        ref = self._breaker_ref
        if isinstance(ref, str):
            from opensearch_tpu_torch.common.breakers import breaker_service
            return getattr(breaker_service(), ref)
        return ref

    def _charge(self, weight: int) -> bool:
        breaker = self._breaker()
        if breaker is None:
            return True
        try:
            breaker.add_estimate(weight, label=f"cache.{self.name}")
            return True
        except CircuitBreakingError:
            return False

    def _release(self, weight: int) -> None:
        breaker = self._breaker()
        if breaker is not None:
            breaker.release(weight)

    # -- internals (call with the lock held) -------------------------------

    def _remove(self, key, reason: str):
        entry = self._entries.pop(key, None)
        if entry is None:
            return
        self._weight -= entry.weight
        self._release(entry.weight)
        if reason == EVICTED:
            self._evictions += 1
        if self.removal_listener is not None:
            self.removal_listener(key, entry.value, reason)

    def _evict_lru(self) -> bool:
        if not self._entries:
            return False
        self._remove(next(iter(self._entries)), EVICTED)
        return True

    # -- public API --------------------------------------------------------

    def get(self, key, default=None):
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._misses += 1
                return default
            self._entries.move_to_end(key)
            self._hits += 1
            return entry.value

    def put(self, key, value) -> bool:
        """Insert; returns False when the entry could not be admitted
        (single entry over max_weight, or the breaker refused even after
        evicting the whole cache)."""
        weight = int(self.weigher(key, value))
        with self._lock:
            self._remove(key, REPLACED)
            if self.max_weight is not None and weight > self.max_weight:
                self._rejections += 1
                return False
            # make room under the breaker by shedding our own LRU tail
            # before giving up: other components' memory is not ours to
            # evict, so a still-tripping breaker means "don't cache"
            while not self._charge(weight):
                if not self._evict_lru():
                    self._rejections += 1
                    return False
            self._entries[key] = _Entry(value, weight)
            self._weight += weight
            if self.max_weight is not None:
                while self._weight > self.max_weight:
                    self._evict_lru()
            return True

    def invalidate_all(self) -> None:
        with self._lock:
            for key in list(self._entries):
                self._remove(key, EXPLICIT)

    def invalidate_if(self, pred: Callable) -> int:
        """Remove every entry where ``pred(key, value)`` is true; returns
        the number removed (targeted invalidation, e.g. one index's
        request-cache entries)."""
        with self._lock:
            doomed = [k for k, e in self._entries.items()
                      if pred(k, e.value)]
            for key in doomed:
                self._remove(key, EXPLICIT)
            return len(doomed)

    def entries(self) -> list[tuple]:
        """Snapshot of (key, value, weight), LRU to MRU."""
        with self._lock:
            return [(k, e.value, e.weight)
                    for k, e in self._entries.items()]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "memory_size_in_bytes": self._weight,
                    "hit_count": self._hits,
                    "miss_count": self._misses,
                    "evictions": self._evictions,
                    "rejections": self._rejections}


def attached_cache(owner, attr: str, *, name: str,
                   max_weight: Optional[int] = None,
                   weigher: Optional[Callable] = None,
                   breaker=None) -> Cache:
    """The ``Cache`` kept as ``owner.<attr>``, made on first use.  A
    weakref finalizer releases the cache's breaker charge when the owner
    dies, so a per-segment or per-searcher cache never leaks accounted
    bytes."""
    cache = getattr(owner, attr, None)
    if cache is None:
        cache = Cache(name, max_weight=max_weight, weigher=weigher,
                      breaker=breaker)
        try:
            weakref.finalize(owner, cache.invalidate_all)
        except TypeError:
            pass                 # owner not weakref-able: best effort
        setattr(owner, attr, cache)
    return cache
