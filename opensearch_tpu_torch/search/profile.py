"""Per-query phase-attributed profiler: the Profile API (the port of the
JAX package's ``search/profile.py``).

The observable phases are the host-side stages around the kernels:

    queue       the continuous batcher's wait before its group ran
    rewrite     query-DSL parse
    plan_cache  canonicalization + compiled-plan cache lookup
    compile     plan-tree construction
    prepare     per-(plan, segment) inputs (incl. H2D staging)
    can_match   can-match and min_score / k-th bound decisions
    dispatch    kernel launches and the torch ops around them
    reduce      read-back (the host waits for the card here) + merge
    fetch       source, highlight, docvalues

plus the engine attribution: plan-cache and prepared-inputs hits and
misses, segments scanned and pruned (and why), kernel libraries built
during the request (``xla_compiles``, the key kept so a client of the
reference parses this response: here the libraries ``ops/cuda_build.py``
built or loaded, read through ``common/device_ledger.py``
``kernel_registry``; a warm request shows 0), the execution path and the
msearch / continuous batch membership.

One launch covers many segments.  Where the reference launches a
program per segment and times each, the port's request-wide paths (K2's
top-k, the dense entry, the plan top-k, K1, K8 / K9) launch once over
every segment the request evaluates: each of those segments is recorded
``scanned`` as it joins the launch (``scan``), and the launch's host
time with the segments' setup is shared among them in equal parts once
known (``launched``), so their records sum to the ``dispatch`` phase.
A segment left out by can-match or by the min_score / k-th bounds is
recorded pruned with its reason.  ``scanned + pruned + not_reached ==
total`` and the records number ``scanned + pruned``, as in the
reference.

Zero cost when off: a ``QueryProfiler`` exists only when the request
carried ``profile: true``; every probe is guarded by ``prof is not
None`` per request or per segment (``phase`` below is empty without a
profiler; only the clock reads around a launch, one or two a segment,
are taken either way), a profiled request
runs the same kernels in the same order with no extra synchronization,
so the device time shows in ``reduce``, where the read-back waits, and
the hits are byte-identical with and without profiling.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

# response-breakdown phase keys, in pipeline order
PHASES = ("queue", "rewrite", "plan_cache", "compile", "prepare",
          "can_match", "dispatch", "reduce", "fetch")

# phases counted into the query section's time_in_nanos (the collector
# section owns "reduce"; fetch is its own response field)
_QUERY_PHASES = ("rewrite", "plan_cache", "compile", "prepare",
                 "can_match", "dispatch")

# bound on the per-segment decision list
_MAX_SEGMENT_RECORDS = 256


def xla_program_count() -> int:
    """Hand-kernel libraries loaded so far in this process (the
    reference counts its live compiled jit programs here)."""
    from opensearch_tpu_torch.common.device_ledger import kernel_registry
    return kernel_registry().program_count()


class QueryProfiler:
    """Phase timings and engine attribution of ONE query execution (or of
    one msearch / continuous batch group, whose members share it)."""

    __slots__ = ("phases", "counts", "attrs", "segments", "_pending",
                 "_recorded", "_xla0")

    def __init__(self):
        self.phases: dict[str, float] = {}       # name -> seconds
        self.counts: dict[str, int] = {}
        self.attrs: dict = {}
        self.segments: list[dict] = []
        # (record, segment id, setup seconds) of the segments joining the
        # next launch
        self._pending: list[tuple] = []
        self._recorded = 0.0                     # every phase's seconds
        self._xla0 = xla_program_count()

    # -- timing ------------------------------------------------------------

    def add(self, phase: str, seconds: float, n: int = 1) -> None:
        self.phases[phase] = self.phases.get(phase, 0.0) + seconds
        self.counts[phase] = self.counts.get(phase, 0) + n
        self._recorded += seconds

    def mark(self) -> tuple:
        """The start of a stretch of host time that ``since`` reads."""
        return time.monotonic(), self._recorded

    def since(self, mark: tuple) -> float:
        """Host seconds since ``mark``, less those recorded into phases in
        between (a scan inside a reduce records its own phases inline):
        the phases stay disjoint."""
        t0, inner0 = mark
        return max(0.0, time.monotonic() - t0 - (self._recorded - inner0))

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time the block into ``name`` (``since``)."""
        mark = self.mark()
        yield
        self.add(name, self.since(mark))

    # -- attribution -------------------------------------------------------

    def set(self, key: str, value) -> None:
        self.attrs[key] = value

    def inc(self, key: str, n: int = 1) -> None:
        self.attrs[key] = self.attrs.get(key, 0) + n

    # -- per-segment decisions ---------------------------------------------

    def seg_pruned(self, seg_id: str, reason: str,
                   seconds: float) -> None:
        """A segment left out of the launches: ``pruned_can_match`` /
        ``pruned_min_score`` / ``pruned_kth``; the decision's cost lands
        in ``can_match``."""
        self.add("can_match", seconds)
        self._seg(seg_id, reason, seconds)

    def scan(self, seg_id: str, setup: float = 0.0) -> None:
        """A segment joining the next launch: its ``scanned`` record now,
        in segment order, with ``setup`` host seconds; its time once the
        launch's is known (``launched``)."""
        self._pending.append((self._seg(seg_id, "scanned", 0.0), seg_id,
                              setup))

    def launched(self, seconds: float) -> None:
        """The pending segments' launch took ``seconds`` of host time: it
        and their setups are the ``dispatch`` phase, counted once a
        segment as the reference counts it, and an equal share each."""
        pending, self._pending = self._pending, []
        total = seconds + sum(setup for _r, _s, setup in pending)
        self.add("dispatch", total, n=len(pending))
        share = int(total / len(pending) * 1e9) if pending else 0
        for rec, _seg_id, _setup in pending:
            if rec is not None:
                rec["time_in_nanos"] = share

    def take_pending(self) -> list:
        """The pending segments as (segment id, setup seconds), their
        records withdrawn: a launch a segment ``settle``s each on its own
        (one the deadline stops is not reached)."""
        pending, self._pending = self._pending, []
        gone = {id(rec) for rec, _s, _t in pending}
        self.segments = [r for r in self.segments if id(r) not in gone]
        return [(seg_id, setup) for _rec, seg_id, setup in pending]

    def settle(self, entry: tuple, seconds: float,
               decision: str = "scanned") -> None:
        """One segment's own launch (``scanned``, into ``dispatch``) or its
        later ``pruned_kth`` (into ``can_match``): its setup plus
        ``seconds``."""
        seg_id, setup = entry
        total = setup + seconds
        self.add("dispatch" if decision == "scanned" else "can_match",
                 total)
        self._seg(seg_id, decision, total)

    def _seg(self, seg_id: str, decision: str,
             seconds: float) -> Optional[dict]:
        if len(self.segments) >= _MAX_SEGMENT_RECORDS:
            return None
        rec = {"segment": seg_id, "decision": decision,
               "time_in_nanos": int(seconds * 1e9)}
        self.segments.append(rec)
        return rec

    def segment_summary(self, total: int) -> dict:
        counts = {"total": int(total), "scanned": 0,
                  "pruned_can_match": 0, "pruned_min_score": 0,
                  "pruned_kth": 0}
        for rec in self.segments:
            d = rec["decision"]
            counts[d] = counts.get(d, 0) + 1
        reached = sum(v for k, v in counts.items() if k != "total")
        # a deadline can stop the scan early: the rest is not_reached
        counts["not_reached"] = max(0, int(total) - reached)
        return counts

    # -- rendering ---------------------------------------------------------

    def breakdown(self) -> dict:
        out = {}
        for name in PHASES:
            out[name] = int(self.phases.get(name, 0.0) * 1e9)
            out[f"{name}_count"] = self.counts.get(name, 0)
        return out

    def copy(self) -> "QueryProfiler":
        """A member's own profiler over a group's shared one (the
        continuous batcher adds each member's queue wait to it)."""
        out = QueryProfiler.__new__(QueryProfiler)
        out.phases = dict(self.phases)
        out.counts = dict(self.counts)
        out.attrs = dict(self.attrs)
        out.segments = list(self.segments)
        out._pending = []
        out._recorded = self._recorded
        out._xla0 = self._xla0
        return out

    def shard_section(self, index_name: str, shard_id, *,
                      plan_type: str, description: str,
                      total_segments: int,
                      query_json: Optional[dict] = None) -> dict:
        """One ``profile.shards[]`` element in the OpenSearch response
        shape (``searches[].query[].breakdown``, ``rewrite_time``,
        ``collector``), with the ``engine`` attribution block and the
        per-segment decisions."""
        bd = self.breakdown()
        query_ns = sum(bd[p] for p in _QUERY_PHASES)
        engine = dict(self.attrs)
        engine.setdefault("plan_cache", "miss")
        engine.setdefault("execution_path", "device")
        # profiled bodies never use the request cache
        # (indices/service.py): the attribution states the policy
        engine.setdefault("request_cache", "bypass")
        engine["xla_compiles"] = max(
            0, xla_program_count() - self._xla0)
        engine["segments"] = self.segment_summary(total_segments)
        section = {
            "id": f"[{index_name}][{shard_id}]",
            "searches": [{
                "query": [{
                    "type": plan_type,
                    "description": description[:200],
                    "time_in_nanos": query_ns,
                    "breakdown": bd,
                    "children": [],
                }],
                "rewrite_time": bd["rewrite"],
                "collector": [{
                    "name": "SimpleTopDocsCollector",
                    "reason": "search_top_hits",
                    "time_in_nanos": bd["reduce"],
                }],
            }],
            "engine": engine,
        }
        if self.segments:
            section["segments"] = list(self.segments)
        return section


_NULL = contextlib.nullcontext()


def phase(prof: Optional[QueryProfiler], name: str):
    """``prof.phase(name)``, or nothing when the request is not profiled
    (for a stretch timed once a request; a segment's probes are
    ``mark`` / ``since`` under ``prof is not None``)."""
    return _NULL if prof is None else prof.phase(name)


def describe_plan(plan, bind) -> str:
    """The plan's description for the profile (``Query.toString()``
    analog): structural, never echoing document data beyond the query's
    own terms."""
    try:
        return plan.describe(bind)
    except Exception:
        return type(plan).__name__
