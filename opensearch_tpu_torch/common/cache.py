"""A bounded cache that threads may share (the searcher's plan, prepared
bindings and batch caches; the reference guards its caches the same way,
``opensearch_tpu/common/cache.py``, with an ``RLock``).

Eviction is first in, first out: once ``limit`` entries are held, adding
a new key drops the oldest.  Every read and write holds the lock, so two
threads never evict the same key.
"""

from __future__ import annotations

import threading


class BoundedCache:
    """``{key: value}`` of at most ``limit`` entries, safe across
    threads."""

    def __init__(self, limit: int):
        self.limit = int(limit)
        self._entries: dict = {}
        self._lock = threading.Lock()

    def get(self, key, default=None):
        with self._lock:
            return self._entries.get(key, default)

    def put(self, key, value):
        """Cache ``value`` under ``key`` unless the key is already held;
        returns the value the cache holds for ``key`` after the call."""
        with self._lock:
            kept = self._entries.get(key)
            if kept is not None:
                return kept
            if len(self._entries) >= self.limit:
                del self._entries[next(iter(self._entries))]
            self._entries[key] = value
            return value

    def get_or_make(self, key, make):
        """The cached value of ``key``, else ``make()``, cached.  ``make``
        runs outside the lock, so two threads may both make a missing
        value; the first one cached is returned to both."""
        value = self.get(key)
        return self.put(key, make()) if value is None else value

    def values(self) -> list:
        """A snapshot of the cached values."""
        with self._lock:
            return list(self._entries.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
