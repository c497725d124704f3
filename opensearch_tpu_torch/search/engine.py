"""One query engine: the entry a caller routes a search through (the port
of the JAX package's ``search/engine.py``, cut to the threadpool, the
continuous batcher and the single-shard entry).

- ``SearchThreadpool``: a bounded pool of named daemon workers for work
  that does not coalesce (msearch's fallback bodies).  Overflow runs on
  the caller's thread, a call from a worker runs inline (no nested
  wait can deadlock), and ``stop()`` is an idempotent bounded join.
- ``ContinuousBatcher``: concurrent single searches whose plans share a
  batch group (same field and size) park for a window and run as ONE
  ``BatchGroup`` (one K3 launch on CUDA), each caller receiving its own
  response, byte-identical to the sequential one.  The first member of a
  group leads: it waits out the window on its own thread and runs the
  group; followers park on an event.  A request waits only when
  concurrent batchable traffic is in flight (serial traffic never
  parks), a group of one runs the sequential path, and ``max_parked``
  spills late arrivals to the sequential path instead of queueing.
- ``QueryEngine.execute``: the batcher runs only for a caller that
  passes a ``service`` (it needs a searcher that stays the same across
  requests): the node's ``IndexService`` (``indices/service.py``), whose
  cached node-local searcher is the same across concurrent requests
  until a refresh.  ``msearch`` and ``count`` are the other entries the
  service calls.

A profiled member of a continuous group gets the group's profiler
(``search/profile.py``: one for the group, its ``batch`` block with
``continuous: true``) and its own ``queue`` phase, the time it waited
before the group ran.  The reference's telemetry counters
(``search.batcher.*``) are plain counters on the batcher here
(``stats()``); insights are not ported.  ``BATCHER_*`` and
``AUTO_WINDOW_MS`` are module globals, as in the reference, where its
dynamic settings land.
"""

from __future__ import annotations

import contextvars
import os
import queue
import threading
import time
from typing import Optional

from opensearch_tpu_torch.common.errors import NotYetPortedError
from opensearch_tpu_torch.search import profile
from opensearch_tpu_torch.search.profile import QueryProfiler

BATCHER_ENABLED = True
BATCHER_WINDOW_MS = 0.0          # 0: use AUTO_WINDOW_MS
BATCHER_MAX_BATCH = 64
AUTO_WINDOW_MS = 10.0


class SearchThreadpool:
    """Bounded, named-daemon-thread worker pool.  Workers spawn lazily on
    first use and respawn after ``stop()``.  ``run_all`` keeps submission
    order and runs overflow work on the caller's thread; callables run
    under a copy of the caller's context."""

    def __init__(self, size: Optional[int] = None, queue_cap: int = 256):
        self.size = int(size or max(2, min(8, os.cpu_count() or 4)))
        self.queue_cap = int(queue_cap)
        self._q: "queue.Queue" = queue.Queue(self.queue_cap)
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._spawned = 0
        self.inline_runs = 0
        self.submitted = 0

    def _ensure_workers(self) -> bool:
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]
            while len(self._threads) < self.size:
                self._spawned += 1
                t = threading.Thread(
                    target=self._worker,
                    name=f"search-engine-{self._spawned}", daemon=True)
                t.start()
                self._threads.append(t)
            return bool(self._threads)

    def _worker(self):
        self._tls.in_worker = True
        while True:
            item = self._q.get()
            if item is None:           # stop sentinel
                return
            fn, ctx, slot = item
            try:
                slot["result"] = ctx.run(fn)
            except BaseException as e:  # noqa: BLE001 — re-raised by waiter
                slot["error"] = e
            finally:
                slot["event"].set()

    def run_all(self, fns: list) -> list:
        """Run callables concurrently; results in submission order.  The
        first exception (by submission order) re-raises on the caller's
        thread once every callable finished.  Called from a pool worker,
        everything runs inline: a worker waiting on subtasks only another
        worker can run would deadlock the queue."""
        if getattr(self._tls, "in_worker", False):
            with self._lock:
                self.inline_runs += len(fns)
            return [fn() for fn in fns]
        slots = []
        for fn in fns:
            slot: dict = {"event": threading.Event()}
            ctx = contextvars.copy_context()
            submitted = False
            if self._ensure_workers():
                try:
                    self._q.put_nowait((fn, ctx, slot))
                    submitted = True
                except queue.Full:
                    pass
            with self._lock:
                if submitted:
                    self.submitted += 1
                else:
                    self.inline_runs += 1
            if not submitted:
                # caller-runs overflow: a bounded queue, guaranteed
                # progress (and the only behaviour once stop() drained it)
                try:
                    slot["result"] = ctx.run(fn)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    slot["error"] = e
                slot["event"].set()
            slots.append(slot)
        for slot in slots:
            slot["event"].wait()
        for slot in slots:
            if "error" in slot:
                raise slot["error"]
        return [slot["result"] for slot in slots]

    def stop(self, timeout: float = 5.0):
        """Idempotent bounded join: one sentinel per live worker, each
        joined against a shared deadline.  A later ``run_all`` respawns
        workers."""
        with self._lock:
            threads, self._threads = self._threads, []
        for _ in threads:
            self._q.put(None)
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))

    def stats(self) -> dict:
        with self._lock:
            alive = sum(1 for t in self._threads if t.is_alive())
            return {"threads": alive, "size": self.size,
                    "submitted": self.submitted,
                    "inline_runs": self.inline_runs}


class _Member:
    """One parked search inside an open batch group."""

    __slots__ = ("body", "bind", "event", "rows", "total", "max_score",
                 "error", "t0", "queue_s", "gprof", "group_size")

    def __init__(self, body: dict, bind: dict, t0: float):
        self.body = body
        self.bind = bind
        self.event = threading.Event()
        self.rows = None
        self.total = 0
        self.max_score = None
        self.error: Optional[BaseException] = None
        self.t0 = t0               # arrival
        self.queue_s = 0.0         # arrival to the group's run
        self.gprof = None          # the group's profiler, when profiled
        self.group_size = 1


class _OpenGroup:
    __slots__ = ("key", "members", "sealed")

    def __init__(self, key):
        self.key = key
        self.members: list[_Member] = []
        self.sealed = False


class ContinuousBatcher:
    """Coalesce concurrent searches of one (searcher, field, size) into
    shared ``BatchGroup`` runs (module docstring).  No thread of its own:
    the leader runs the group on its request thread."""

    # backstop for a follower's wait (window + the group's run): a leader
    # that vanished sends the follower to the sequential path
    FOLLOWER_TIMEOUT_S = 60.0

    def __init__(self):
        self._cond = threading.Condition()
        self._groups: dict[tuple, _OpenGroup] = {}
        self._active = 0           # in-flight batchable searches
        self._parked = 0
        self.max_parked = 256
        # counters behind stats(), under _cond
        self.batched = 0           # members served by a group run
        self.bypass = 0            # bodies the batcher cannot serve
        self.window_waits = 0      # windows a leader waited out
        self.dispatches = 0        # group runs (one K3 launch each)

    @staticmethod
    def effective_window_s() -> float:
        w = BATCHER_WINDOW_MS if BATCHER_WINDOW_MS > 0 else AUTO_WINDOW_MS
        return max(0.0, float(w)) / 1000.0

    def execute(self, searcher, body: dict) -> Optional[dict]:
        """Serve one body through the batcher, or return None to bypass
        (the body cannot be batched).  A batchable body that finds no
        companions runs the sequential path here, inside the in-flight
        count: that count is the concurrency a later arrival sees."""
        from opensearch_tpu_torch.search.batch import batchable

        # only plans the searcher has compiled already: a first-seen
        # query runs (and compiles) on the sequential path
        parsed = batchable(searcher, body, peek=True) \
            if searcher.segments else None
        if parsed is None:
            with self._cond:
                self.bypass += 1
            return None
        plan, bind, k = parsed
        t0 = time.monotonic()
        with self._cond:
            self._active += 1
        try:
            resp = self._coalesce(searcher, body, plan, bind, k, t0)
            return resp if resp is not None else searcher.search(body)
        finally:
            with self._cond:
                self._active -= 1

    def _coalesce(self, searcher, body, plan, bind, k,
                  t0: float) -> Optional[dict]:
        key = (id(searcher), plan.field, k)
        member = _Member(body, bind, t0)
        window = self.effective_window_s()
        with self._cond:
            g = self._groups.get(key)
            if g is not None and not g.sealed \
                    and len(g.members) < BATCHER_MAX_BATCH \
                    and self._parked < self.max_parked:
                g.members.append(member)
                self._parked += 1
                if len(g.members) >= BATCHER_MAX_BATCH:
                    g.sealed = True
                    self._groups.pop(key, None)
                    self._cond.notify_all()
                follower = True
            else:
                # no joinable group: lead one, but only park (and pay the
                # window) when concurrent batchable traffic exists now
                follower = False
                concurrent = self._active > 1 or self._parked > 0
                if not (concurrent and window > 0
                        and self._parked < self.max_parked):
                    return None
                g = _OpenGroup(key)
                g.members.append(member)
                self._groups[key] = g
        if follower:
            if not member.event.wait(window + self.FOLLOWER_TIMEOUT_S):
                return None        # leader vanished: degrade, don't hang
            if member.error is not None:
                raise member.error
            return self._render(searcher, member, t0)
        # leader: wait out the window (a full group wakes it early), then
        # run the whole group on this thread
        deadline = t0 + window
        with self._cond:
            self.window_waits += 1
            while not g.sealed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            g.sealed = True
            if self._groups.get(key) is g:
                del self._groups[key]
            members = list(g.members)
            self._parked -= len(members) - 1
        if len(members) == 1:
            return None            # nobody came: the sequential path
        try:
            self._run_group(searcher, plan.field, k, members)
        except BaseException as e:     # noqa: BLE001 — fan the error out
            for m in members:
                m.error = e
                m.event.set()
            raise
        for m in members:
            m.event.set()
        return self._render(searcher, member, t0)

    def _run_group(self, searcher, field: str, k: int,
                   members: list[_Member]):
        """One ``BatchGroup`` run for the whole group, on the leader's
        thread; every member shares (field, k) by the group key."""
        from opensearch_tpu_torch.search.batch import BatchGroup

        t_run = time.monotonic()
        gprof = None
        if any((m.body or {}).get("profile") for m in members):
            gprof = QueryProfiler()
            gprof.set("plan_cache", "batched")
            gprof.set("batch", {"field": field, "k": k,
                                "queries": len(members),
                                "continuous": True})
        group = BatchGroup(field, k)
        for i, m in enumerate(members):
            group.add(i, m.bind)
        # members rarely meet twice in one combination: the group's inputs
        # are assembled for this run and not cached (the msearch groups in
        # the searcher's cache stay)
        out = group.run(searcher, cache=False, prof=gprof)
        with self._cond:
            self.dispatches += 1
            self.batched += len(members)
        for i, m in enumerate(members):
            m.rows, m.total, m.max_score = out[i]
            m.queue_s = max(0.0, t_run - m.t0)
            m.gprof = gprof
            m.group_size = len(members)

    @staticmethod
    def _render(searcher, member: _Member, t0: float) -> dict:
        """A member's response, shaped as ``ShardSearcher.search``'s; a
        profiled member's profile is the group's plus its own queue wait
        and fetch."""
        body = member.body or {}
        prof = None
        if member.gprof is not None and body.get("profile"):
            prof = member.gprof.copy()
            prof.add("queue", member.queue_s)
        with profile.phase(prof, "fetch"):
            resp = searcher._response(member.rows or [], member.total,
                                      member.max_score, body.get("_source"),
                                      t0)
        if prof is not None:
            resp["profile"] = {"shards": [prof.shard_section(
                searcher.index_name, searcher.shard_id,
                plan_type="TermBagPlan",
                description=(f"continuous batch member of "
                             f"{member.group_size}"),
                total_segments=len(searcher.segments))]}
        return resp

    def stats(self) -> dict:
        with self._cond:
            return {
                "enabled": bool(BATCHER_ENABLED),
                "window_ms": (BATCHER_WINDOW_MS if BATCHER_WINDOW_MS > 0
                              else AUTO_WINDOW_MS),
                "max_batch": int(BATCHER_MAX_BATCH),
                "open_groups": len(self._groups),
                "parked": self._parked,
                "batched": self.batched,
                "bypass": self.bypass,
                "window_waits": self.window_waits,
                "dispatches": self.dispatches,
            }


class QueryEngine:
    """The entry a caller hands a point-in-time ``ShardSearcher`` (and, at
    a serving edge, the service that owns it)."""

    def __init__(self):
        self.pool = SearchThreadpool()
        self.batcher = ContinuousBatcher()

    def execute(self, searcher, body: Optional[dict] = None, *,
                agg_partials: bool = False, service=None) -> dict:
        """One search body -> one response.  ``service`` enables the
        continuous batcher (it needs the service's cached searcher, the
        same across requests); without one the plain pipeline runs.
        ``agg_partials`` asks for the aggregations' shard partials (a
        multi-index coordinator reduces them)."""
        body = body or {}
        if service is not None and service._use_mesh(body):
            raise NotYetPortedError(
                "the mesh search is not ported to the torch package yet")
        if service is not None and not agg_partials and BATCHER_ENABLED:
            out = self.batcher.execute(searcher, body)
            if out is not None:
                return out
        return searcher.search(body, agg_partials=agg_partials)

    def msearch(self, searcher, bodies: list) -> list[dict]:
        """The multi-search entry (``ShardSearcher.msearch``)."""
        return searcher.msearch(bodies)

    def count(self, searcher, query: Optional[dict] = None) -> int:
        """The count entry (``ShardSearcher.count``)."""
        return searcher.count(query)

    def shutdown(self):
        """Idempotent bounded-join shutdown of the worker threads; the
        next search respawns them."""
        self.pool.stop()

    def stats(self) -> dict:
        return {"threadpool": self.pool.stats(),
                "batcher": self.batcher.stats()}


_engine = QueryEngine()


def query_engine() -> QueryEngine:
    return _engine
