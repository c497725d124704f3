"""Device residency and transfer accounting: the staging ledger (the port
of the JAX package's ``common/device_ledger.py``).

- **Residency ledger.** Every column a ``DeviceSegment`` stages (postings,
  impacts, doc values, vectors, geo points, live masks, positions, nested
  blocks, the ANN indexes it adopts) is recorded under one group per
  segment view: its owner (index, shard, segment), the exact staged bytes
  per entry, the staging tick, and the group's dispatch count and last
  dispatch tick.  The searcher's sort key columns are adopted under kind
  ``sort_keys``.
- **Transfer accounting.** Host-to-device (stage) and device-to-host
  (fetch) bytes, operations and seconds.
- **Compile registry.** ``KernelCompileRegistry`` counts the hand-kernel
  libraries ``ops/cuda_build.py`` has built or loaded in this process,
  per library; the profiler's ``xla_compiles`` is its delta over a
  request (the reference counts jit programs there).
- **Budget.** ``device.memory.budget_bytes``: when resident bytes exceed
  it, the least recently dispatched sealed groups are unstaged (pager
  pages before whole segments).  An evicted segment is staged again on
  its next use and counted in ``restages``; nothing is scored on the host
  instead (the reference scores an evicted segment's term bags on its
  host impact tables; ``stats()`` keeps its ``host_fallbacks`` key, 0).
- **Working set.** A request opens a scope (``request()``); while a budget
  is set, every group the request touches in that scope is pinned until
  the scope closes, and the budget is enforced when it closes, not while
  the request stages (the reference enforces at each staging, protecting
  only the group staged): the request's launches never lose a segment
  they read, a segment it staged is never evicted to make room for the
  next one it stages, and a budget below one request's working set
  leaves the ledger over budget while the request runs, as ``stats()``
  shows.
- **Pager.** ``DevicePager`` stages quantized table sets as fixed-size
  pages under the same budget (capacity ``budget_bytes // page_bytes``),
  least recently used first out; ``prefetch`` stages only into free
  pages; ``discard`` drops an entry its owner's own bound pushed out.

Staged tensors live on the device of the view that asked (``cuda``, or
``cpu`` in the tests).  Finalizers (a collected view or searcher, a
collected segment's pages) only queue what they release: the garbage
collector may run them on a thread that holds a ledger lock, so the
queues are drained under the lock by the next call that takes it.  The
ledger is process-global, as the breaker service is; tests reset it
with ``device_ledger().reset()``.  The reference's ``prometheus_text``
waits for the telemetry module (ROADMAP Queue A).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
import weakref
from typing import Callable, Optional

import numpy as np

# the kinds a DeviceSegment stages; the batch, pager and sort-key
# producers add their own
SEGMENT_KINDS = ("postings", "numeric", "ordinal", "vector", "geo",
                 "impacts", "live", "nested", "ann")


def host_footprint(seg, per_field: bool = False):
    """Host-side footprint of one ``Segment`` in bytes: the one source of
    a segment's size (its staging breaker charge is twice this).  Returns
    the total, or ``{(kind, field): bytes}`` with ``per_field``."""
    out: dict[tuple, int] = {}

    def put(kind, field, *arrays):
        n = sum(int(getattr(a, "nbytes", 0)) for a in arrays
                if a is not None)
        if n:
            out[(kind, field)] = out.get((kind, field), 0) + n

    for name, pf in seg.postings.items():
        put("postings", name, pf.offsets, pf.doc_ids, pf.tfs,
            pf.pos_offsets, pf.positions, pf.doc_lens, pf.df, pf.present)
    for name, dv in seg.numeric_dv.items():
        put("numeric", name, dv.offsets, dv.values, dv.value_docs,
            dv.minv, dv.maxv, dv.exists)
    for name, dv in seg.ordinal_dv.items():
        put("ordinal", name, dv.offsets, dv.ords, dv.value_docs,
            dv.min_ord, dv.max_ord, dv.exists)
    for name, dv in seg.vector_dv.items():
        put("vector", name, dv.values, dv.exists)
    for name, dv in seg.geo_dv.items():
        put("geo", name, dv.offsets, dv.lats, dv.lons, dv.value_docs,
            dv.exists)
    if per_field:
        return out
    return sum(out.values())


def _loaded_libraries() -> dict:
    from opensearch_tpu_torch.ops import cuda_build
    return cuda_build.loaded()


class KernelCompileRegistry:
    """Per-library count of the hand kernels built or loaded in this
    process (``ops/cuda_build.py`` ``library``: one per source and set of
    ``-D`` macros), with the reference's ``counts()`` shape.  A table that
    cannot be read is counted under ``unavailable``, never raised."""

    def __init__(self, libraries: Callable = _loaded_libraries):
        self._libraries = libraries

    def counts(self) -> dict:
        """{"kernels": {name: count}, "unavailable": n, "total": n}."""
        try:
            out = {f"cuda.{k}": int(v)
                   for k, v in self._libraries().items()}
            unavailable = 0
        except Exception:
            out, unavailable = {}, 1
        return {"kernels": dict(sorted(out.items())),
                "unavailable": unavailable, "total": sum(out.values())}

    def program_count(self) -> int:
        """Libraries loaded so far (the profiler's ``xla_compiles``
        delta source)."""
        return self.counts()["total"]


class _Group:
    """One staging owner's entries: one segment view's columns, one pager
    entry, or one searcher's sort keys.  The group is the eviction
    unit."""

    __slots__ = ("index", "shard", "segment", "entries", "staged_tick",
                 "dispatches", "last_dispatch_tick", "sealed", "pins",
                 "evict_cb", "evict_class", "_gid", "__weakref__")

    def __init__(self, index: str, shard, segment: str,
                 evict_cb: Optional[Callable] = None,
                 evict_class: str = "segment"):
        self.index = index
        self.shard = shard
        self.segment = segment
        self.entries: dict[tuple, int] = {}   # (kind, field, name) -> bytes
        self.staged_tick = 0
        self.dispatches = 0
        self.last_dispatch_tick = 0
        self.sealed = False                   # unsealed groups never evict
        self.pins = 0                         # requests holding it now
        self.evict_cb = evict_cb              # None: never evicted
        self.evict_class = evict_class        # "page" goes before "segment"
        self._gid = -1

    def nbytes(self) -> int:
        return sum(self.entries.values())

    def by_kind(self) -> dict:
        out: dict[str, int] = {}
        for (kind, _f, _n), b in self.entries.items():
            out[kind] = out.get(kind, 0) + b
        return out

    def to_dict(self) -> dict:
        return {"index": self.index, "shard": self.shard,
                "segment": self.segment, "bytes": self.nbytes(),
                "entries": len(self.entries),
                "by_kind": dict(sorted(self.by_kind().items())),
                "staged_tick": self.staged_tick,
                "dispatches": self.dispatches,
                "last_dispatch_tick": self.last_dispatch_tick,
                "evictable": self.evict_cb is not None and self.sealed}


def _tensor_bytes(value) -> int:
    """Bytes of every tensor under ``value``: a tensor, a tuple, list or
    dict of them, or an object with an ``nbytes()`` method (a staged ANN
    index)."""
    import torch

    total = 0
    stack = [value]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        elif isinstance(v, (tuple, list)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif callable(getattr(v, "nbytes", None)):
            total += int(v.nbytes())
    return total


class _RequestScope:
    """``DeviceResidencyLedger.request``'s context manager (a class, not a
    generator: every request opens one)."""

    __slots__ = ("_led", "_depth")

    def __init__(self, led: "DeviceResidencyLedger"):
        self._led = led
        self._depth = 0

    def __enter__(self) -> None:
        tls = self._led._tls
        depth = self._depth = getattr(tls, "depth", 0)
        if depth == 0:
            tls.held = []
        tls.depth = depth + 1

    def __exit__(self, *exc) -> bool:
        led, depth = self._led, self._depth
        tls = led._tls
        tls.depth = depth
        if depth == 0:
            held, tls.held = tls.held, None
            if held:
                with led._lock:
                    for g in held:
                        g.pins -= 1
            led._enforce()
        return False


class DeviceResidencyLedger:
    """The residency, transfer and budget ledger (module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._groups: dict[int, _Group] = {}
        self._dead: collections.deque = collections.deque()
        self._next_id = itertools.count(1)
        self._tick = itertools.count(1)
        self._tls = threading.local()
        self.budget_bytes: Optional[int] = None
        self.evictions = 0
        self.restages = 0
        self._evicted_bytes = 0
        self._restage_seconds = 0.0
        self._transfers = {
            "stage": {"bytes": 0, "ops": 0, "seconds": 0.0},
            "fetch": {"bytes": 0, "ops": 0, "seconds": 0.0}}

    # -- group lifecycle ---------------------------------------------------

    def open_group(self, *, index: str = "-", shard=0, segment: str = "-",
                   evict: Optional[Callable] = None,
                   evict_class: str = "segment") -> _Group:
        """A new, unsealed group, held by the current request scope.
        ``evict`` is the unstage callback the budget may call (groups
        without one are counted, never evicted); ``evict_class="page"``
        marks a group cheaper to stage again (a pager entry), spent
        before whole segments."""
        g = _Group(index, shard, segment, evict_cb=evict,
                   evict_class=evict_class)
        g.staged_tick = next(self._tick)
        g._gid = next(self._next_id)
        with self._lock:
            self._groups[g._gid] = g
        self.hold(g)
        return g

    def tether(self, owner, group: _Group) -> None:
        """Close ``group`` when ``owner`` (weakref-able) is collected."""
        weakref.finalize(owner, self._forget, group._gid)

    def _forget(self, gid: int) -> None:
        """A finalizer's close: queued (module docstring)."""
        self._dead.append(gid)

    def _reap(self) -> None:
        """Close the groups finalizers queued (lock held)."""
        while self._dead:
            self._groups.pop(self._dead.popleft(), None)

    def seal(self, group: _Group) -> None:
        """Mark the group fully staged: only sealed groups evict."""
        group.sealed = True
        self._enforce(protect=group)

    def close_group(self, group: _Group) -> None:
        with self._lock:
            self._groups.pop(group._gid, None)

    # -- staging (H2D) -----------------------------------------------------

    def stage(self, group: Optional[_Group], host_array, *, device,
              kind: str, field: str = "", name: str = ""):
        """The host-to-device copy of the port's staging: ``host_array``
        (numpy) as a tensor on ``device``, timed and recorded under
        ``group`` with its exact bytes."""
        import torch

        t0 = time.monotonic()
        out = torch.from_numpy(np.ascontiguousarray(host_array)).to(device)
        dt = time.monotonic() - t0
        self._record(group, (kind, field, name),
                     out.numel() * out.element_size(), dt)
        return out

    def adopt(self, group: _Group, arrays, *, kind: str, field: str = "",
              name: str = "") -> None:
        """Record tensors staged elsewhere (an ANN index's layout, a key
        column built on the device) without copying them again."""
        self._record(group, (kind, field, name), _tensor_bytes(arrays), 0.0)

    def _record(self, group: Optional[_Group], key: tuple, nbytes: int,
                seconds: float) -> None:
        new = False
        with self._lock:
            if group is not None:
                new = key not in group.entries
                group.entries[key] = int(nbytes)
            t = self._transfers["stage"]
            t["bytes"] += int(nbytes)
            t["ops"] += 1
            t["seconds"] += seconds
        if group is not None and new and group.sealed:
            # columns staged after the seal count against the budget too
            self._enforce(protect=group)

    def drop(self, group: _Group, *, kind: str, field: str = "",
             name: str = "") -> None:
        """Remove one entry whose tensor its owner dropped."""
        with self._lock:
            group.entries.pop((kind, field, name), None)

    # -- the request's working set -----------------------------------------

    def request(self) -> "_RequestScope":
        """One request's scope (re-entrant on a thread): while a budget is
        set, the groups it touches (``hold``) stay pinned until the
        outermost scope closes; then the budget is enforced."""
        return _RequestScope(self)

    def hold(self, group: Optional[_Group]) -> None:
        """Pin ``group`` for the current request scope (once a scope);
        nothing to do without a budget or outside a scope."""
        if self.budget_bytes is None or group is None:
            return
        held = getattr(self._tls, "held", None)
        if held is None or any(g is group for g in held):
            return
        with self._lock:
            group.pins += 1
        held.append(group)

    # -- dispatch + fetch-back accounting ----------------------------------

    def record_dispatch(self, groups) -> None:
        """One request's or batch group's launches read ``groups`` (a
        group or an iterable of them): the LRU signal eviction orders by.
        One tick for all of them."""
        if groups is None:
            return
        if isinstance(groups, _Group):
            groups = (groups,)
        with self._lock:
            tick = next(self._tick)
            for g in groups:
                if g is not None:
                    g.dispatches += 1
                    g.last_dispatch_tick = tick

    def record_fetch(self, nbytes: int, seconds: float) -> None:
        """A device-to-host read-back of results."""
        with self._lock:
            t = self._transfers["fetch"]
            t["bytes"] += int(nbytes)
            t["ops"] += 1
            t["seconds"] += seconds

    def record_restage(self, seconds: float = 0.0) -> None:
        """An evicted segment was staged again on its next use."""
        with self._lock:
            self.restages += 1
            self._restage_seconds += seconds

    # -- budget enforcement ------------------------------------------------

    def set_budget(self, budget_bytes: Optional[int]) -> None:
        """``device.memory.budget_bytes``; 0 / None = unlimited.  Applies
        at once."""
        b = int(budget_bytes) if budget_bytes else 0
        self.budget_bytes = b if b > 0 else None
        self._enforce()

    def _enforce(self, protect: Optional[_Group] = None) -> None:
        """Unstage the least recently dispatched sealed, unpinned groups
        (pages first) until resident bytes fit the budget; with nothing
        left to evict, stay over it."""
        budget = self.budget_bytes
        if budget is None or getattr(self._tls, "held", None) is not None:
            return              # none, or deferred to the scope's close
        while True:
            with self._lock:
                self._reap()
                resident = sum(g.nbytes() for g in self._groups.values())
                if resident <= budget:
                    return
                victims = [g for g in self._groups.values()
                           if g.sealed and g.evict_cb is not None
                           and g.pins <= 0 and g is not protect]
                if not victims:
                    return
                victim = min(victims,
                             key=lambda g: (g.evict_class != "page",
                                            g.last_dispatch_tick,
                                            g.staged_tick))
                self.evictions += 1
                self._evicted_bytes += victim.nbytes()
                cb = victim.evict_cb
                victim.evict_cb = None        # never evict twice
            try:
                cb()
            finally:
                self.close_group(victim)

    # -- readout -----------------------------------------------------------

    def resident_bytes(self) -> int:
        with self._lock:
            self._reap()
            return sum(g.nbytes() for g in self._groups.values())

    def transfer_snapshot(self) -> tuple[int, int]:
        """(stage bytes, fetch bytes), monotonic totals."""
        with self._lock:
            return (self._transfers["stage"]["bytes"],
                    self._transfers["fetch"]["bytes"])

    def device_footprint(self, seg) -> int:
        """Bytes one ``Segment``'s views hold now (0 when none is
        staged)."""
        groups = [getattr(d, "_ledger_group", None)
                  for d in list(seg._device.values())]
        with self._lock:
            self._reap()
            return sum(g.nbytes() for g in groups
                       if g is not None and g._gid in self._groups)

    def stats(self) -> dict:
        """Residency per index and kind, transfers, the budget and its
        evictions, the pager, the compile registry and the allocator's
        own view (``backend``)."""
        with self._lock:
            self._reap()
            groups = list(self._groups.values())
            transfers = {
                side: {"bytes": t["bytes"], "ops": t["ops"],
                       "time_ms": round(t["seconds"] * 1000.0, 3)}
                for side, t in self._transfers.items()}
            budget = self.budget_bytes
            ev, evb = self.evictions, self._evicted_bytes
            rs = self.restages
            rs_ms = self._restage_seconds * 1000.0
            per_index: dict[str, dict] = {}
            by_kind: dict[str, int] = {}
            resident = dispatches = pinned = 0
            for g in groups:
                b = g.nbytes()
                resident += b
                dispatches += g.dispatches
                pinned += g.pins > 0
                ix = per_index.setdefault(
                    g.index, {"bytes": 0, "segments": 0, "dispatches": 0})
                ix["bytes"] += b
                ix["segments"] += 1
                ix["dispatches"] += g.dispatches
                for kind, kb in g.by_kind().items():
                    by_kind[kind] = by_kind.get(kind, 0) + kb
        return {
            "resident_bytes": resident,
            "resident_segments": len(groups),
            "dispatches": dispatches,
            "by_kind": dict(sorted(by_kind.items())),
            "budget": {
                "budget_bytes": budget or 0,
                "over_budget": budget is not None and resident > budget,
                "pinned_groups": pinned,
                "evictions": ev,
                "evicted_bytes": evb,
                "restages": rs,
                "restage_time_ms": round(rs_ms, 3),
                # the reference's evicted segments scored on the host:
                # the port restages them instead (module docstring)
                "host_fallbacks": 0,
            },
            "transfers": transfers,
            "pager": device_pager().stats(),
            "indices": dict(sorted(per_index.items())),
            "compile_registry": kernel_registry().counts(),
            "backend": _backend_memory_stats(),
        }

    def segments(self) -> list[dict]:
        """Per-group rows (the debug surface)."""
        with self._lock:
            self._reap()
            groups = sorted(self._groups.values(),
                            key=lambda g: (g.index, str(g.shard),
                                           g.segment, g._gid))
        return [g.to_dict() for g in groups]

    def reset(self) -> None:
        """Test hook: forget every group and zero the counters (the staged
        tensors stay with their owners)."""
        with self._lock:
            self._groups.clear()
            self._dead.clear()
            self.budget_bytes = None
            self.evictions = self.restages = 0
            self._evicted_bytes = 0
            self._restage_seconds = 0.0
            for t in self._transfers.values():
                t["bytes"] = t["ops"] = 0
                t["seconds"] = 0.0
        device_pager().reset()


class _PageEntry:
    """One pager unit: the staged tensors of one quantized (segment,
    field, avgdl) table set, counted in fixed-size pages."""

    __slots__ = ("key", "arrays", "group", "nbytes", "pages",
                 "last_use_tick")

    def __init__(self, key, arrays, group, nbytes, pages, tick):
        self.key = key
        self.arrays = arrays
        self.group = group
        self.nbytes = nbytes
        self.pages = pages
        self.last_use_tick = tick


class DevicePager:
    """Pages of quantized table sets under ``device.memory.budget_bytes``:
    capacity ``budget_bytes // page_bytes``; an ``acquire`` that does not
    fit evicts the least recently used entry not held by the current
    request first; ``prefetch`` stages only into free pages.  Every
    staging goes through the ledger, whose own budget may evict a pager
    group like any other (pages first).  ``listen(key, fn)`` calls ``fn``
    when ``key``'s entry is evicted, so owners of cached references to
    its tensors drop them."""

    DEFAULT_PAGE_BYTES = 1 << 20

    def __init__(self, ledger: DeviceResidencyLedger):
        self._led = ledger
        self._lock = threading.Lock()
        self.page_bytes = self.DEFAULT_PAGE_BYTES
        self._entries: dict[tuple, _PageEntry] = {}
        self._listeners: dict[tuple, Callable] = {}
        self._dead: collections.deque = collections.deque()
        self._tick = itertools.count(1)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.evicted_pages = 0
        self.prefetches = 0

    def set_page_bytes(self, n) -> None:
        """``device.pager.page_bytes`` (0 / None keeps the default)."""
        n = int(n) if n else 0
        self.page_bytes = n if n > 0 else self.DEFAULT_PAGE_BYTES

    def capacity_pages(self):
        """None = unlimited (no budget set)."""
        budget = self._led.budget_bytes
        if budget is None:
            return None
        return max(1, budget // self.page_bytes)

    def resident_pages(self) -> int:
        with self._lock:
            return sum(e.pages for e in self._entries.values())

    def resident(self, key) -> Optional[dict]:
        """``key``'s tensors when resident, else None (no hit counted)."""
        with self._lock:
            e = self._entries.get(key)
            return None if e is None else e.arrays

    def entry_bytes(self, key) -> int:
        """Bytes ``key``'s entry holds now (0 when it is not resident)."""
        with self._lock:
            e = self._entries.get(key)
            return 0 if e is None else e.nbytes

    def _pages_of(self, nbytes: int) -> int:
        return max(1, -(-int(nbytes) // self.page_bytes))

    def listen(self, key, fn: Callable) -> None:
        with self._lock:
            self._listeners[key] = fn

    def acquire(self, key, loader, *, device, index: str = "-", shard=0,
                segment: str = "-") -> dict:
        """The resident tensors of ``key`` ({name: tensor}), staged on
        ``device`` (evicting least recently used pages to fit) on a miss.
        ``loader()`` gives the host payload as ``(name, kind, array)``
        triples."""
        self._reap()
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self.hits += 1
                e.last_use_tick = next(self._tick)
            else:
                self.misses += 1
        if e is not None:
            self._led.hold(e.group)
            self._led.record_dispatch(e.group)
            return e.arrays
        return self._stage(key, loader(), device=device, index=index,
                           shard=shard, segment=segment, prefetched=False)

    def prefetch(self, key, loader, nbytes_hint: int, *, device,
                 index: str = "-", shard=0, segment: str = "-") -> bool:
        """Stage ``key`` ahead of demand if it fits in free pages (never
        evicting).  True when staged."""
        self._reap()
        cap = self.capacity_pages()
        need = self._pages_of(nbytes_hint)
        with self._lock:
            if key in self._entries:
                return False
            if cap is not None and \
                    cap - sum(e.pages for e in self._entries.values()) \
                    < need:
                return False
        self._stage(key, loader(), device=device, index=index, shard=shard,
                    segment=segment, prefetched=True)
        return True

    def _stage(self, key, items, *, device, index, shard, segment,
               prefetched) -> dict:
        field = key[3] if len(key) > 3 else ""
        group = self._led.open_group(
            index=index, shard=shard, segment=segment,
            evict=lambda: self._on_ledger_evict(key), evict_class="page")
        arrays = {}
        nbytes = 0
        for name, kind, arr in items:
            t = arrays[name] = self._led.stage(group, arr, device=device,
                                               kind=kind, field=field,
                                               name=name)
            nbytes += t.numel() * t.element_size()
        entry = _PageEntry(key, arrays, group, nbytes,
                           self._pages_of(nbytes), next(self._tick))
        evicted = []
        with self._lock:
            prior = self._entries.get(key)   # a racing load: keep ours
            self._entries[key] = entry
            cap = self.capacity_pages()
            if cap is not None:
                while sum(e.pages for e in self._entries.values()) > cap:
                    victims = [e for e in self._entries.values()
                               if e is not entry and e.group.pins <= 0]
                    if not victims:
                        break                # over capacity, all in use
                    v = min(victims, key=lambda e: e.last_use_tick)
                    del self._entries[v.key]
                    self.evictions += 1
                    self.evicted_pages += v.pages
                    evicted.append(v)
            if prefetched:
                self.prefetches += 1
        if prior is not None:
            self._led.close_group(prior.group)
        for v in evicted:
            self._led.close_group(v.group)
            self._notify(v.key)
        # seal after the pager's own eviction, so the ledger's budget sees
        # the footprint after it
        self._led.seal(group)
        return arrays

    def _notify(self, key) -> None:
        with self._lock:
            fn = self._listeners.get(key)
        if fn is not None:
            fn()

    def _on_ledger_evict(self, key) -> None:
        """The ledger's budget chose this entry's group."""
        with self._lock:
            e = self._entries.pop(key, None)
            if e is None:
                return
            self.evictions += 1
            self.evicted_pages += e.pages
        self._notify(key)

    def discard(self, key) -> None:
        """Drop ``key``'s entry now (its owner keeps a bound of its own):
        its group closes, and its listener is told and forgotten."""
        with self._lock:
            e = self._entries.pop(key, None)
            fn = self._listeners.pop(key, None)
        if e is not None:
            self._led.close_group(e.group)
            if fn is not None:
                fn()

    def invalidate(self, key) -> None:
        """Owner teardown (the segment was collected), from a finalizer:
        queued, and applied by the pager's next call (``_reap``)."""
        self._dead.append(key)

    def _reap(self) -> None:
        """Drop the entries of collected owners (lock NOT held)."""
        gone = []
        with self._lock:
            while self._dead:
                key = self._dead.popleft()
                self._listeners.pop(key, None)
                e = self._entries.pop(key, None)
                if e is not None:
                    gone.append(e)
        for e in gone:
            self._led.close_group(e.group)

    def stats(self) -> dict:
        self._reap()
        with self._lock:
            return {
                "page_bytes": self.page_bytes,
                "capacity_pages": self.capacity_pages(),
                "resident_pages": sum(e.pages
                                      for e in self._entries.values()),
                "resident_entries": len(self._entries),
                "resident_bytes": sum(e.nbytes
                                      for e in self._entries.values()),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "evicted_pages": self.evicted_pages,
                "prefetches": self.prefetches,
            }

    def reset(self) -> None:
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
            self._dead.clear()
            self.hits = self.misses = self.evictions = 0
            self.evicted_pages = self.prefetches = 0
            self.page_bytes = self.DEFAULT_PAGE_BYTES
        for e in entries:
            self._led.close_group(e.group)
            self._notify(e.key)


def _backend_memory_stats() -> dict:
    """The CUDA caching allocator's own view beside the ledger's
    (``torch.cuda.mem_get_info`` and ``memory_stats``) once this process
    uses the card; {} otherwise.  It reads counters only."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {}
    try:
        free, total = torch.cuda.mem_get_info()
        raw = torch.cuda.memory_stats()
    except Exception:
        return {"available": False}
    keep = {k: int(v) for k, v in raw.items()
            if isinstance(v, (int, float)) and ("bytes" in k or "allocs" in k)}
    return {"available": True, "platform": "cuda", "free_bytes": int(free),
            "total_bytes": int(total), **keep}


_ledger = DeviceResidencyLedger()
_registry = KernelCompileRegistry()
_pager = DevicePager(_ledger)


def device_ledger() -> DeviceResidencyLedger:
    return _ledger


def device_pager() -> DevicePager:
    return _pager


def kernel_registry() -> KernelCompileRegistry:
    return _registry
