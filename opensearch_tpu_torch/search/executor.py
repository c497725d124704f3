"""Shard-side query phase: run a compiled plan over every segment, merge
top-k across segments, order, collapse and rescore the rows, fetch the
page (the port of the JAX package's ``search/executor.py``: ``query``,
``size``, ``from``, ``min_score``, ``_source``, ``track_total_hits``,
``timeout``, ``aggs``, ``sort``, ``search_after``, ``collapse``,
``rescore``, ``highlight``, ``explain``, ``docvalue_fields``,
``fields`` and ``stored_fields``).

A scored ``match`` / ``term`` (a ``TermBagPlan`` at the root) takes every
segment's top-k, total and max from one call (``ops/bm25.py``
``term_bag_topk_segments_auto``: one K2 launch on CUDA, or one K4 launch
over segments that ``index/codec.py`` quantizes) and one read-back.
Other plans gather the segments the request evaluates first (can-match
and ``min_score``-bound skips, the deadline at segment boundaries), launch
each term-bag leaf of the plan once over all of them, and all its phrase
and span leaves in one launch of each kernel (``plan.py``
``dense_prepass``: K2's dense entry, one launch per leaf and row layout
on CUDA; K8 and K9), run the rest of the plan as eager torch ops per
segment, and
take every segment's top-k, total and max from one call
(``ops/bm25.py`` ``plan_topk_segments_auto``: one launch of the plan
top-k, ``csrc/plan_topk.cu``) and one read-back.  Requests that waive
exact totals (``track_total_hits: false``, whose running k-th-score
pruning needs results segment by segment) launch the leaves once over
the segments the same way, then keep one program per segment (a plan
top-k of one segment each), all launched before the host reads any
result back.  The per-shard "reduce" over segments is
a host-side k-way merge with Lucene's tie-break (score desc, then index
order = (segment, local doc)).

``msearch`` batches the bodies that compile to a scored term bag into
one ``BatchGroup`` per (field, size) (``search/batch.py``: one K3 launch
per group on CUDA) and serves the others through ``search``.
``merge_hit_rows`` is the coordinator's merge of several indices' hits
(the REST layer's multi-index ``_search``).

A request's ``timeout`` is a ``SearchDeadline`` checked between
per-segment programs, as in the reference: once it expires no further
segment is launched and the response carries ``timed_out: true`` with
what the launched segments found.  A ``hybrid`` query
(``_hybrid_search``) runs one top-k per sub-query and combines them on
the host through the normalization processor of ``search/pipeline.py``
(``_hybrid_pipeline`` in the body, which the REST layer fills from
``?search_pipeline=``).

A body with ``aggs`` runs the full-scores pass once (``_run_full``) and
feeds both its hits (``_topk_from_views``) and the aggregations
(``search/aggs.py``); ``agg_partials`` returns the shard's mergeable
partials instead (``aggregation_partials``), which a coordinator
reduces with ``reduce_aggs``.

A field ``sort`` (with ``search_after``), ``collapse`` and the score
order of a collapse are computed over every matched row on the
searcher's device (``search/sorting.py``), and only the page is read
back.  ``rescore`` runs its query over the segments that hold the
window's rows, gathers its scores at those rows on the device and
combines them on the host in float64, as the reference does.  The fetch
options run per hit of the page on the host (``search/fetch.py``).

``suggest`` runs the term, phrase and completion suggesters on the host
(``search/suggest.py``).  ``scan_rows`` orders every matched row on the
device for the REST layer's scroll contexts (``search/contexts.py``);
a point in time is a pinned searcher.

``profile: true`` returns the shard's phase-attributed profile
(``search/profile.py``): the plan cache, compile, prepare, can-match
and bound decisions per segment, the launches' host time shared among the
segments they cover, the read-back and merge (``reduce``) and the fetch;
a profiled request runs the same kernels in the same order as an
unprofiled one, and its hits are byte-identical.  ``msearch`` profiles
each batch group once (its members share it).  Not ported yet (ROADMAP):
the telemetry / insights / task / device-health hooks.  Other keys the
searcher does not read are ignored, as the reference's searcher ignores
them.

Every request runs in a residency-ledger scope
(``common/device_ledger.py`` ``request``): under a device budget the
segments it stages stay resident until its launches are queued, and one
``record_dispatch`` a request marks them used.

The searcher's caches are ``BoundedCache``s: the engine's threadpool and
the continuous batcher call ``search`` from many threads at once.
"""

from __future__ import annotations

import functools
import json
import math
import time
import weakref
from typing import Optional

import numpy as np
import torch

from opensearch_tpu_torch.common.cache import BoundedCache
from opensearch_tpu_torch.common.device_ledger import device_ledger
from opensearch_tpu_torch.common.errors import (IllegalArgumentError,
                                                ValidationError)
from opensearch_tpu_torch.common.torchenv import resolve_device
from opensearch_tpu_torch.index.segment import (LONG_MISSING_MAX,
                                                LONG_MISSING_MIN,
                                                DeviceSegment, Segment)
from opensearch_tpu_torch.ops import bm25 as bm25_ops
from opensearch_tpu_torch.ops.cuda_bm25 import K_MAX as TOPK_K_MAX
from opensearch_tpu_torch.ops.phrase import stage_positions
from opensearch_tpu_torch.search import plan as P
from opensearch_tpu_torch.search import profile
from opensearch_tpu_torch.search import sorting
from opensearch_tpu_torch.search.compiler import ShardContext, compile_query
from opensearch_tpu_torch.search.fetch import filter_source
from opensearch_tpu_torch.search.profile import QueryProfiler, describe_plan
from opensearch_tpu_torch.search.query_dsl import HybridQuery, parse_query

_I32 = np.int32

# the served keys that shape a response beyond a plain top-k: a body
# with one of them takes the sequential path (``search/batch.py``
# ``batchable``)
RESULT_KEYS = ("sort", "search_after", "rescore", "collapse", "highlight",
               "explain", "docvalue_fields", "fields", "stored_fields")
# the other keys that take the sequential path: ``suggest`` runs there,
# and the reference's batch sends ``script_fields`` and ``post_filter``
# there too (a profiled body batches: its group is profiled)
SEQUENTIAL_KEYS = ("suggest", "script_fields", "post_filter")
# query types whose bind injects a per-request column of every segment
# (``ScoredMaskPlan``: the knn winners, the parent-join masks, percolate's
# matches): their prepared inputs stay out of the searcher's cache
_INJECTED_QUERIES = ('"knn":', '"has_child":', '"has_parent":',
                     '"parent_id":', '"percolate":')
# bounds of the searcher's plan, prepared-bindings, batch and sort caches
# (entries; a sort cache entry is a key column of every doc, 8 bytes a
# doc, or a keyword's rank tables)
_PLAN_CACHE_MAX = 256
_PREP_CACHE_MAX = 1024
_BATCH_PREP_CACHE_MAX = 64
_SORT_CACHE_MAX = 32


def shards_section(total: int) -> dict:
    """The ``_shards`` response block of a single-shard response."""
    return {"total": int(total), "successful": int(total), "skipped": 0,
            "failed": 0}


def merge_hit_rows(rows, sort_json=None) -> list:
    """Coordinator-side merge of per-source hit lists (the JAX package's
    ``merge_hit_rows``, the SearchPhaseController.sortDocs analog that the
    REST multi-index merge uses).

    ``rows``: ``(hit, source_ordinal, position)`` tuples, each source's
    hits already in rank order and ``position`` a hit's rank within its
    source.  Without a sort clause (or with ``_score`` desc alone) merges
    by (score desc, source, position); with one, by the hits' ``sort``
    values through the reference's comparator
    (``search/sorting.py`` ``sort_comparator``), (source, position)
    breaking ties.  Returns the hits in merged order."""
    specs = sorting.parse_sort(sort_json)
    if specs is None:
        rows = sorted(rows, key=lambda t: (-(t[0]["_score"] or 0.0),
                                           t[1], t[2]))
    else:
        cmp = sorting.sort_comparator(specs)
        rows = sorted(rows, key=functools.cmp_to_key(
            lambda a, b: cmp({"sort": a[0].get("sort", []),
                              "seg": a[1], "local": a[2]},
                             {"sort": b[0].get("sort", []),
                              "seg": b[1], "local": b[2]})))
    return [h for h, _s, _p in rows]


class SearchDeadline:
    """Per-request time budget (QueryPhase's timeout runnable analog).

    Checked between per-segment device programs — the same granularity
    as cancellation.  When the budget expires the query phase stops
    launching segments and the response carries ``timed_out: true`` with
    the partial results collected so far, like the reference's
    TimeExceededException handling in QueryPhase.execute.
    """

    __slots__ = ("_deadline", "timed_out")

    def __init__(self, timeout, t0: Optional[float] = None):
        """``timeout``: "100ms"/"2s"-style or millis; None disables."""
        self.timed_out = False
        if timeout is None:
            self._deadline = None
            return
        from opensearch_tpu_torch.common.settings import parse_time
        seconds = parse_time(timeout)
        self._deadline = (None if seconds < 0
                          else (t0 if t0 is not None
                                else time.monotonic()) + seconds)

    def expired(self) -> bool:
        """True once the budget is spent; latches ``timed_out``."""
        if self._deadline is not None and \
                time.monotonic() >= self._deadline:
            self.timed_out = True
        return self.timed_out


def _dummy_for(group: str, field: str, dseg: DeviceSegment, mapper):
    """Shape-consistent empty arrays for a field absent from this segment
    (all-inactive: matches nothing, scores nothing)."""
    n_pad = dseg.n_pad
    dev = dseg.device
    dead = n_pad - 1
    if group == "postings":
        return {
            "offsets": torch.zeros(8, dtype=torch.int32, device=dev),
            "doc_ids": torch.full((8,), dead, dtype=torch.int32,
                                  device=dev),
            "tfs": torch.zeros(8, dtype=torch.float32, device=dev),
        }
    if group == "positions":
        cols = {
            "doc_ids": torch.full((8,), dead, dtype=torch.int32,
                                  device=dev),
            "pos_offsets": torch.zeros(16, dtype=torch.int32, device=dev),
            "positions": torch.zeros(8, dtype=torch.int32, device=dev),
            "doc_lens": torch.ones(n_pad, dtype=torch.float32, device=dev),
        }
        cols["staged"] = stage_positions(*cols.values(), 0, 0)
        return cols
    if group == "norms":
        return {"field_exists": torch.zeros(n_pad, dtype=torch.bool,
                                            device=dev)}
    if group in ("numeric", "ordinal"):
        # the columns the filter plans read, and a numeric column's
        # per-doc bounds (the decays, distance_feature, field_value_factor)
        ft = mapper.field_type(field)
        dtype = (torch.int32 if group == "ordinal" else torch.float64
                 if ft is not None and ft.dv_kind == "double"
                 else torch.int64)
        cols = {
            "values" if group == "numeric" else "ords": torch.full(
                (8,), 0 if group == "numeric" else -1, dtype=dtype,
                device=dev),
            "value_docs": torch.full((8,), dead, dtype=torch.int32,
                                     device=dev),
            "exists": torch.zeros(n_pad, dtype=torch.bool, device=dev),
        }
        if group == "numeric":
            lo, hi = ((math.inf, -math.inf) if dtype == torch.float64
                      else (LONG_MISSING_MAX, LONG_MISSING_MIN))
            cols["minv"] = torch.full((n_pad,), lo, dtype=dtype, device=dev)
            cols["maxv"] = torch.full((n_pad,), hi, dtype=dtype, device=dev)
        return cols
    if group == "geo":
        return {
            "lats": torch.zeros(8, dtype=torch.float64, device=dev),
            "lons": torch.zeros(8, dtype=torch.float64, device=dev),
            "value_docs": torch.full((8,), dead, dtype=torch.int32,
                                     device=dev),
            "exists": torch.zeros(n_pad, dtype=torch.bool, device=dev),
        }
    if group == "vector":
        ft = mapper.field_type(field)
        dim = getattr(ft, "dims", 1) or 1
        return {
            "values": torch.zeros((n_pad, dim), dtype=torch.float32,
                                  device=dev),
            "exists": torch.zeros(n_pad, dtype=torch.bool, device=dev),
        }
    raise IllegalArgumentError(f"unknown array group [{group}]")


def build_arrays(dseg: DeviceSegment, needed, mapper, live=None,
                 partial_ok=frozenset()):
    """Assemble the ``A`` dict a plan reads: live mask + requested field
    array groups (absent fields get all-inactive dummies).  ``live`` is
    the caller's point-in-time staged live mask (defaults to the
    segment's construction-time state).

    ``partial_ok`` holds the (group, field) pairs whose partial staging
    is fine as it is (a plan's ``skip_arrays(dims)``).  A quantized
    segment stages only the postings offsets eagerly; any other plan
    reading its postings demand-stages the f32 columns here
    (``DeviceSegment.ensure_postings``)."""
    A = {"live": dseg.live if live is None else live}
    sources = {"postings": dseg.postings, "numeric": dseg.numeric,
               "ordinal": dseg.ordinal, "vector": dseg.vector,
               "geo": dseg.geo}
    for group, field in sorted(needed):
        if group == "positions":
            # the phrase and span plans': positions staged on demand
            entry = dseg.ensure_positions(field)
        elif group == "norms":
            entry = dseg.ensure_norms(field)
        else:
            entry = sources[group].get(field)
        if entry is None:
            entry = _dummy_for(group, field, dseg, mapper)
        elif group == "postings" and (group, field) not in partial_ok:
            entry = dseg.ensure_postings(field)
        A.setdefault(group, {})[field] = entry
    return A


def _groups(dsegs) -> list:
    """The ledger groups of the views a launch reads."""
    return [d._ledger_group for d in dsegs]


def _plan_key(query_json, scored: bool):
    """The plan cache's key of a query body: None when it does not
    serialize, or when it holds a ``script_score``.  That query's bind
    holds per-row columns of its own query vectors (4 bytes a row and
    vector function, ``compiler._c_script_score``); requests bring new
    vectors, so cached columns would only fill the device."""
    try:
        key = json.dumps(query_json, sort_keys=True, separators=(",", ":"))
    except (TypeError, ValueError):
        return None
    return None if '"script_score":' in key else (key, scored)


def _prep_key(ckey):
    """The prepared-inputs cache's key of a query whose plan cache key is
    ``ckey``: None for a query holding one of ``_INJECTED_QUERIES``.  Such
    a bind's per-segment score column and mask are made per request (the
    plan keeps its state: a join's parent table, knn's winners), so
    caching them would only fill the device with columns no later request
    reads."""
    if ckey is None or any(q in ckey[0] for q in _INJECTED_QUERIES):
        return None
    return ckey


class ShardSearcher:
    """Immutable point-in-time view over a shard's segments (the
    Engine.Searcher / reader-context analog), serving on ``device``:
    ``cuda`` by default (raises without CUDA), ``cpu`` when asked."""

    def __init__(self, segments: list[Segment], mapper,
                 index_name: str = "index", shard_id: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.segments = [s for s in segments if s.n_docs > 0]
        self.mapper = mapper
        self.index_name = index_name
        self.shard_id = shard_id
        for seg in self.segments:      # the ledger's owner of their views
            if seg.index_name == "-":
                seg.index_name, seg.shard_id = index_name, shard_id
            seg._searchers.add(self)   # told when seg's view is evicted
        self.ctx = ShardContext(self.segments, mapper, self.device)
        self._plan_cache = BoundedCache(_PLAN_CACHE_MAX)
        # per (query, segment, the segment's view generation, kind):
        # dropped for a segment whose view or pages the budget evicts
        # (``_forget_segment``)
        self._prep_cache = BoundedCache(_PREP_CACHE_MAX)
        # msearch / continuous-batch group inputs, keyed by the group's
        # signature (``search/batch.py`` ``BatchGroup._prepare``)
        self._batch_prep_cache = BoundedCache(_BATCH_PREP_CACHE_MAX)
        # sort and collapse key columns, keyword ranks, segment starts
        # (``search/sorting.py``); the key columns are adopted into a
        # ledger group of this searcher (kind ``sort_keys``)
        self._sort_cache = BoundedCache(
            _SORT_CACHE_MAX, on_drop=functools.partial(
                sorting.key_column_dropped, weakref.ref(self)))
        self._sort_group = None
        # bytes the sorted, collapsed and rescored paths read back to the
        # host (``search/sorting.py``), and the plan top-k's copies: a
        # measure, which concurrent requests may race
        self.read_back_bytes = 0

    # -- compiled-plan / prepared-bindings caches -------------------------

    def compiled(self, query_json: Optional[dict], scored: bool = True,
                 with_key: bool = False, prof=None):
        """(plan, bind) for a raw query body through the searcher's plan
        cache, keyed on the canonicalized JSON.  The searcher is an
        immutable point-in-time view, so entries never go stale.
        ``with_key`` returns the prepared-inputs cache's key beside them
        (``_prep_key``).  ``prof`` times the lookup, the parse and the
        compile and records the hit or miss."""
        t_lookup = time.monotonic() if prof is not None else 0.0
        ckey = _plan_key(query_json, scored)
        out = self._plan_cache.get(ckey) if ckey is not None else None
        if prof is not None:
            prof.add("plan_cache", time.monotonic() - t_lookup)
            prof.set("plan_cache", "miss" if out is None else "hit")
        if out is None:
            with profile.phase(prof, "rewrite"):
                q = parse_query(query_json)
            out = compile_query(q, self.ctx, scored=scored, prof=prof)
            if ckey is not None:
                out = self._plan_cache.put(ckey, out)
        return (out, _prep_key(ckey)) if with_key else out

    def cached_plan(self, query_json: Optional[dict], scored: bool = True):
        """(plan, bind) when the plan cache already holds the query, else
        None: a peek that never compiles."""
        ckey = _plan_key(query_json, scored)
        return None if ckey is None else self._plan_cache.get(ckey)

    def _prepared(self, plan, bind, seg, dseg, ckey, prof=None):
        """``plan.prepare``'s per-(plan, segment) products — padded term
        ids, staged impact references, per-query tensors — cached so a
        repeated query does zero host-side prepare work and zero
        host-to-device copies per segment."""
        return self._cached(ckey, seg, "prepare",
                            lambda: plan.prepare(bind, seg, dseg, self.ctx),
                            prof)

    def _cached(self, ckey, seg, kind: str, make, prof=None):
        """``make()``, cached per (query, segment, the segment's view
        generation, ``kind``) while the query has a cache key.  ``prof``
        times a miss into ``prepare`` and counts ``prepared_hits`` /
        ``prepared_misses``."""
        key = (None if ckey is None
               else (ckey, id(seg), seg.view_generation(), kind))
        out = None if key is None else self._prep_cache.get(key)
        if out is not None:
            if prof is not None:
                prof.inc("prepared_hits")
            return out
        mark = None
        if prof is not None:
            prof.inc("prepared_misses")
            mark = prof.mark()
        out = make()
        if prof is not None:
            prof.add("prepare", prof.since(mark))
        if key is None:
            return out
        return self._prep_cache.put(key, out)

    def _forget_segment(self, seg) -> None:
        """The budget evicted a view or a page of ``seg``: drop the inputs
        cached for it (and every batch group's, which may read it), so
        its tensors are freed and the next use stages them again."""
        sid = id(seg)
        self._prep_cache.drop_where(lambda key: key[1] == sid)
        self._batch_prep_cache.clear()

    # -- public API -------------------------------------------------------

    def doc_count(self) -> int:
        return sum(s.live_count() for s in self.segments)

    def resident_bytes(self) -> int:
        """Bytes of this searcher's segments staged on its device now (a
        view the device budget evicted counts 0; this stages nothing)."""
        key = str(self.device)
        views = (seg._device.get(key) for seg in self.segments)
        return sum(d.nbytes() for d in views if d is not None)

    def count(self, query_json: Optional[dict] = None) -> int:
        if not self.segments:
            return 0
        with device_ledger().request():
            (plan, bind), ckey = self.compiled(query_json, scored=False,
                                               with_key=True)
            needed = plan.arrays()
            total = 0
            for _seg, _dseg, _scores, matched in self._run_full(
                    plan, bind, needed, None, can_match_skip=True,
                    ckey=ckey):
                total += int(matched.sum())
            return total

    def msearch(self, bodies: list) -> list[dict]:
        """Multi-search (the ``_msearch`` analog): bodies that compile to
        a scored term bag run as one batched program per (field, size)
        group — one K3 launch over every segment on CUDA (see
        ``search/batch.py``); every other body runs ``search``, fanned
        out over the engine's threadpool when there are several.
        Responses come back in request order, shaped as ``search``'s."""
        from opensearch_tpu_torch.search.batch import plan_batches

        t0 = time.monotonic()
        if not self.segments:
            return [self.search(b) for b in bodies]
        groups, fallback = plan_batches(self, bodies)
        results: list = [None] * len(bodies)
        for group in groups:
            members = sorted(group.positions + [p for p, _b in group.wide])
            gprof = None
            if any((bodies[p] or {}).get("profile") for p in members):
                # one profiler a coalesced group: its members share the
                # group's timings (that sharing is the attribution)
                gprof = QueryProfiler()
                gprof.set("plan_cache", "batched")
                gprof.set("batch", {"field": group.field, "k": group.k,
                                    "queries": len(members),
                                    "positions": members})
            out = group.run(self, prof=gprof)
            for pos, (rows, total, max_score) in out.items():
                body = bodies[pos] or {}
                with profile.phase(gprof, "fetch"):
                    results[pos] = self._response(rows, total, max_score,
                                                  body.get("_source"), t0)
                if gprof is not None and body.get("profile"):
                    results[pos]["profile"] = {"shards": [
                        gprof.shard_section(
                            self.index_name, self.shard_id,
                            plan_type="TermBagPlan",
                            description=(f"batched[{group.field}] member "
                                         f"{pos} of {len(members)}"),
                            total_segments=len(self.segments))]}
        if len(fallback) > 1:
            from opensearch_tpu_torch.search.engine import query_engine
            outs = query_engine().pool.run_all(
                [(lambda b=bodies[pos]: self.search(b)) for pos in fallback])
            for pos, resp in zip(fallback, outs):
                results[pos] = resp
        else:
            for pos in fallback:
                results[pos] = self.search(bodies[pos])
        return results

    def search(self, body: Optional[dict] = None, *,
               agg_partials: bool = False) -> dict:
        """One search body -> one response; with ``agg_partials`` the
        response carries the aggregations' shard partials
        (``aggregation_partials``) in place of ``aggregations``."""
        body = body or {}
        t0 = time.monotonic()
        with device_ledger().request():
            q_json = body.get("query")
            fetch_extras = self._fetch_extras(body)
            if isinstance(q_json, dict) and "hybrid" in q_json:
                q = parse_query(q_json)
                if isinstance(q, HybridQuery):
                    # as in the reference, a hybrid response carries no
                    # profile
                    return self._hybrid_search(body, q, t0, fetch_extras)
            # the profiler exists only for a profiled request: every probe
            # downstream is ``prof is not None``
            prof = QueryProfiler() if body.get("profile") else None
            return self._search_body(body, t0, agg_partials, fetch_extras,
                                     prof=prof)

    @staticmethod
    def _fetch_extras(body: dict) -> Optional[dict]:
        """The fetch options of ``body`` (highlight, explain,
        docvalue_fields, fields) with its parsed query, or None."""
        if not (body.get("highlight") or body.get("explain")
                or body.get("docvalue_fields") or body.get("fields")):
            return None
        return {"highlight": body.get("highlight"),
                "explain": bool(body.get("explain")),
                "docvalue_fields": body.get("docvalue_fields"),
                "fields": body.get("fields"),
                "query": parse_query(body.get("query"))}

    def _search_body(self, body: dict, t0: float,
                     agg_partials: bool = False,
                     fetch_extras: Optional[dict] = None,
                     prof=None) -> dict:
        size = int(body.get("size", 10))
        from_ = int(body.get("from", 0))
        deadline = SearchDeadline(body.get("timeout"), t0)
        sort_specs = sorting.parse_sort(body.get("sort"))
        min_score = body.get("min_score")
        source_spec = body.get("_source")
        stored = body.get("stored_fields")
        if stored is not None and source_spec is None:
            # legacy stored_fields: _source returns only when asked for
            # explicitly (RestSearchAction's stored-fields contract)
            if isinstance(stored, str):
                stored = [stored]
            if "_source" not in stored:
                source_spec = False
        search_after = body.get("search_after")
        if search_after is not None:
            if sort_specs is None:
                raise IllegalArgumentError(
                    "[search_after] requires an explicit [sort]")
            if not isinstance(search_after, (list, tuple)):
                raise IllegalArgumentError(
                    "[search_after] must be an array of sort values")
            if len(search_after) != len(sort_specs):
                raise IllegalArgumentError(
                    f"[search_after] has {len(search_after)} values but "
                    f"sort has {len(sort_specs)} fields")
        # field-sorted queries that never reference _score skip scoring
        needs_scores = (sort_specs is None
                        or any(s["field"] == "_score" for s in sort_specs)
                        or min_score is not None)
        (plan, bind), ckey = self.compiled(body.get("query"),
                                           scored=needs_scores,
                                           with_key=True, prof=prof)
        needed = plan.arrays()
        k_want = from_ + size
        # with exact totals waived, block-max pruning may also skip
        # segments that cannot beat the running k-th score (the
        # reference's track_total_hits=false contract: totals become a
        # lower bound, flagged with relation "gte")
        allow_kth_prune = body.get("track_total_hits") is False
        rescore = body.get("rescore")
        collapse = body.get("collapse")
        if rescore and collapse:
            raise IllegalArgumentError(
                "cannot use [collapse] in conjunction with [rescore]")
        if rescore is not None:
            if sort_specs is not None:
                raise IllegalArgumentError(
                    "rescore is only supported on score-sorted queries")
            # widen the first pass to the rescore window
            spec = rescore[0] if isinstance(rescore, list) else rescore
            k_want = max(k_want, int(spec.get("window_size", 10)))
        aggs_json = body.get("aggs") or body.get("aggregations")
        # with aggs, the full-scores pass runs ONCE and feeds the hits,
        # their order or collapse, and the aggregations
        views = (list(self._run_full(plan, bind, needed, min_score,
                                     deadline=deadline, ckey=ckey,
                                     prof=prof))
                 if aggs_json and self.segments else None)
        total_is_lower_bound = False
        if not self.segments:
            rows, total, max_score = [], 0, None
        elif collapse is not None:
            rows, total, max_score = self._collapsed(
                plan, bind, needed, k_want, sort_specs, min_score,
                collapse, views, search_after=search_after, ckey=ckey,
                prof=prof)
        elif sort_specs is None:
            if views is not None:
                rows, total, max_score = self._topk_from_views(
                    views, k_want, prof=prof)
            else:
                rows, total, max_score, total_is_lower_bound = self._topk(
                    plan, bind, needed, k_want, min_score,
                    deadline=deadline, ckey=ckey,
                    allow_kth_prune=allow_kth_prune, prof=prof)
        else:
            rows, total, max_score = self._field_sorted(
                plan, bind, needed, k_want, sort_specs, min_score, views,
                search_after=search_after, deadline=deadline, ckey=ckey,
                prof=prof)
        if rescore is not None and rows:
            rows, max_score = self._rescored(rows, rescore)
        with profile.phase(prof, "fetch"):
            resp = self._response(rows[from_: from_ + size], total,
                                  max_score, source_spec, t0,
                                  lower_bound=total_is_lower_bound,
                                  timed_out=deadline.timed_out,
                                  fetch_extras=fetch_extras)
        if prof is not None:
            resp["profile"] = {"shards": [prof.shard_section(
                self.index_name, self.shard_id,
                plan_type=type(plan).__name__,
                description=describe_plan(plan, bind),
                total_segments=len(self.segments))]}
        if aggs_json:
            from opensearch_tpu_torch.search.aggs import AggregationExecutor
            execu = AggregationExecutor(
                self.ctx, scores_of={seg.seg_id: scores
                                     for seg, _d, scores, _m in views or ()})
            seg_views = [(seg, dseg, matched)
                         for seg, dseg, _s, matched in views or ()]
            if agg_partials:
                resp["aggregation_partials"] = execu.collect(aggs_json,
                                                             seg_views)
            else:
                resp["aggregations"] = execu.run(aggs_json, seg_views)
            resp["took"] = int((time.monotonic() - t0) * 1000)
        if body.get("suggest"):
            from opensearch_tpu_torch.search.suggest import run_suggest
            resp["suggest"] = run_suggest(body["suggest"], self.ctx)
            for entries in resp["suggest"].values():
                for entry in entries:
                    for opt in entry.get("options", ()):
                        if "_id" in opt and "_index" not in opt:
                            opt["_index"] = self.index_name
        return resp

    def _hybrid_search(self, body: dict, q, t0, fetch_extras=None) -> dict:
        """Hybrid query: each sub-query runs as its own top-k (one K2 / K4
        launch for a ``match``, one K1 launch for a ``knn``); the
        normalization processor (``search/pipeline.py``) combines the
        per-sub-query top lists on the host.  ``_hybrid_pipeline`` in the
        body carries the processor config (wired by the REST layer from
        ``?search_pipeline=...``); absent -> min_max + arithmetic_mean.
        The fetch options apply to the combined page."""
        from opensearch_tpu_torch.search.pipeline import NormalizationConfig

        if (body.get("sort") is not None or body.get("aggs")
                or body.get("aggregations")
                or body.get("min_score") is not None
                or body.get("search_after") is not None):
            raise ValidationError(
                "[hybrid] query does not support [sort], [aggs], "
                "[min_score] or [search_after]")
        size = int(body.get("size", 10))
        from_ = int(body.get("from", 0))
        k_want = from_ + size
        deadline = SearchDeadline(body.get("timeout"), t0)
        conf = NormalizationConfig(body.get("_hybrid_pipeline"))
        per_query_rows = []
        max_total = 0
        for subq in q.queries:
            if deadline.expired():
                break            # partial: combine what completed
            plan, bind = compile_query(subq, self.ctx, scored=True)
            rows, tot, _mx, _lb = self._topk(plan, bind, plan.arrays(),
                                             k_want, None,
                                             deadline=deadline)
            per_query_rows.append(rows)
            max_total = max(max_total, int(tot))
        combined = conf.apply(per_query_rows, k_want)
        rows = combined[from_: from_ + size]
        # per-sub-query top-k truncation means the union is a lower
        # bound beyond the largest sub-query's exact count
        return {
            "took": int((time.monotonic() - t0) * 1000),
            "timed_out": deadline.timed_out,
            "_shards": shards_section(1),
            "hits": {"total": {"value": max_total, "relation": "gte"},
                     "max_score": (combined[0]["score"] if combined
                                   else None),
                     "hits": self._hits_from_rows(rows, body.get("_source"),
                                                  fetch_extras)},
        }

    def _response(self, rows, total, max_score, source_spec, t0: float,
                  lower_bound: bool = False, timed_out: bool = False,
                  fetch_extras: Optional[dict] = None) -> dict:
        """A search response (``search``'s, ``msearch``'s and the
        continuous batcher's): the page's ``rows``, the matched total
        (a lower bound when ``lower_bound``), the largest score, whether
        the request's deadline cut the query phase and the time since
        ``t0`` (the fetch included)."""
        hits = self._hits_from_rows(rows, source_spec, fetch_extras)
        return {
            "took": int((time.monotonic() - t0) * 1000),
            "timed_out": bool(timed_out),
            "_shards": shards_section(1),
            "hits": {
                "total": {"value": int(total),
                          "relation": "gte" if lower_bound else "eq"},
                "max_score": max_score,
                "hits": hits,
            },
        }

    def _hits_from_rows(self, rows, source_spec, fetch_extras=None):
        """The page's hits: id, score, filtered source, the rows' sort
        values and collapse key, then the fetch options, per hit."""
        from opensearch_tpu_torch.search.fetch import (docvalue_fields,
                                                       explain_hit,
                                                       fields_option,
                                                       run_highlight)

        hits = []
        for row in rows:
            seg = self.segments[row["seg"]]
            local = row["local"]
            hit = {"_index": self.index_name, "_id": seg.doc_ids[local],
                   "_score": row.get("score")}
            source = seg.source(local)
            src = filter_source(source, source_spec)
            if src is not None:
                hit["_source"] = src
            if "sort" in row:
                hit["sort"] = row["sort"]
            if "fields" in row:            # the collapse key
                hit["fields"] = dict(row["fields"])
            if fetch_extras is not None:
                if fetch_extras.get("highlight"):
                    hl = run_highlight(fetch_extras["highlight"], source,
                                       fetch_extras["query"], self.mapper)
                    if hl:
                        hit["highlight"] = hl
                fields = {}
                if fetch_extras.get("docvalue_fields"):
                    fields.update(docvalue_fields(
                        fetch_extras["docvalue_fields"], seg, local,
                        self.mapper))
                if fetch_extras.get("fields"):
                    fields.update(fields_option(fetch_extras["fields"],
                                                source))
                if fields:
                    hit["fields"] = fields
                if fetch_extras.get("explain"):
                    hit["_explanation"] = explain_hit(
                        row.get("score"), fetch_extras["query"], seg,
                        local, self.ctx)
            hits.append(hit)
        return hits

    # -- internals --------------------------------------------------------

    @staticmethod
    def _min_score(min_score) -> float:
        return -np.inf if min_score is None else float(np.float32(min_score))

    def _run_full(self, plan, bind, needed, min_score,
                  can_match_skip=False, deadline=None, ckey=None,
                  only=None, prof=None):
        """Yields (seg, dseg, scores, matched) per segment.
        ``can_match_skip`` and ``only`` (a set of segment indices: the
        others are skipped) are ONLY safe for consumers that don't index
        the yielded tuples by position.  An expired ``deadline`` stops
        the scan at the next segment boundary.  The plan's term-bag leaves
        are launched once over every segment scanned before the first is
        evaluated.  ``prof`` records each segment's decision; the scanned
        segments share the host time of the launches and evals."""
        ms = self._min_score(min_score)
        items = []
        for si, seg in enumerate(self.segments):
            if deadline is not None and deadline.expired():
                break
            if only is not None and si not in only:
                continue
            t_seg = time.monotonic() if prof is not None else 0.0
            if can_match_skip and not plan.can_match(bind, seg):
                if prof is not None:
                    prof.seg_pruned(seg.seg_id, "pruned_can_match",
                                    time.monotonic() - t_seg)
                continue
            items.append(self._evaluated(plan, bind, needed, seg, ckey,
                                         prof))
        device_ledger().record_dispatch(_groups(d for _s, d, *_r in items))
        # the launches' host time, the consumer's time between yields left
        # out
        disp, t_disp = 0.0, time.monotonic()
        P.dense_prepass(plan, [(A, dims, ins)
                               for _s, _d, dims, ins, A in items])
        for seg, dseg, dims, ins, A in items:
            scores, matched = P.run_full(plan, dims, A, ins, ms)
            disp += time.monotonic() - t_disp
            yield seg, dseg, scores, matched
            t_disp = time.monotonic()
        if prof is not None:
            prof.launched(disp)

    def _evaluated(self, plan, bind, needed, seg, ckey, prof=None) -> tuple:
        """``(seg, dseg, dims, ins, A)``: one segment's prepared inputs
        (cached per query) and its request-scoped arrays.  ``prof``
        records the segment as joining the launch (``scan``)."""
        mark = prof.mark() if prof is not None else None
        dseg = seg.device(self.device)
        dims, ins = self._prepared(plan, bind, seg, dseg, ckey, prof)
        A = build_arrays(dseg, needed, self.mapper,
                         live=self.ctx.live_mask(seg, dseg),
                         partial_ok=plan.skip_arrays(dims))
        if prof is not None:
            prof.scan(seg.seg_id, prof.since(mark))
        return seg, dseg, dims, ins, A

    def _topk_from_views(self, views, k_want, prof=None):
        """(rows, total, max_score) out of an already-run full-scores pass
        (aggs requests): every segment's top-k from one plan top-k call,
        read back in one copy."""
        with profile.phase(prof, "reduce"):
            if k_want == 0:
                total = sum(int(m.sum()) for _s, _d, _sc, m in views)
                return [], total, None
            if not views:
                return [], 0, None
            out = bm25_ops.plan_topk_segments_auto(
                [bm25_ops.PlanScores(scores, matched)
                 for _seg, _dseg, scores, matched in views], k=k_want)
            return self._rows_of(out, range(len(views)), k_want)

    def _rows_of(self, out, order, k_want):
        """(rows, total, max_score) of a ``TermBagTopK`` whose row ``j``
        is segment ``order[j]``'s, read back in one copy."""
        t_sync = time.monotonic()
        vals, ids, totals, maxes = out.numpy()
        nbytes = vals.nbytes + ids.nbytes + totals.nbytes + maxes.nbytes
        device_ledger().record_fetch(nbytes, time.monotonic() - t_sync)
        self.read_back_bytes += nbytes
        per_seg = []
        for j, si in enumerate(order):
            keep = vals[j] > -np.inf
            per_seg.append((vals[j][keep],
                            np.full(int(keep.sum()), si, _I32),
                            ids[j][keep]))
        return self._merge_topk(per_seg, k_want,
                                sum(int(t) for t in totals),
                                max(float(m) for m in maxes))

    def _merge_topk(self, per_seg, k_want, total, max_score):
        if not per_seg:
            return [], 0, None
        scores = np.concatenate([p[0] for p in per_seg])
        segi = np.concatenate([p[1] for p in per_seg])
        local = np.concatenate([p[2] for p in per_seg])
        order = np.lexsort((local, segi, -scores))[:k_want]
        rows = [{"seg": int(segi[i]), "local": int(local[i]),
                 "score": float(scores[i])} for i in order]
        return rows, total, (None if max_score == -np.inf else float(max_score))

    def _prune(self, plan, bind, seg, ms_host, prof) -> bool:
        """True when ``seg`` is left out of the launches: it cannot match,
        or its score bound is below ``min_score`` (exact: such docs never
        count in totals); ``prof`` records the decision and its time."""
        t_seg = time.monotonic() if prof is not None else 0.0
        if not plan.can_match(bind, seg):
            reason = "pruned_can_match"     # no staging, no program
        elif ms_host is not None and \
                plan.max_score_bound(bind, seg) < ms_host:
            reason = "pruned_min_score"
        else:
            if prof is not None:
                prof.add("can_match", time.monotonic() - t_seg)
            return False
        if prof is not None:
            prof.seg_pruned(seg.seg_id, reason, time.monotonic() - t_seg)
        return True

    def _topk(self, plan, bind, needed, k_want, min_score, deadline=None,
              ckey=None, allow_kth_prune=False, prof=None):
        """Returns (rows, total, max_score, total_is_lower_bound).

        Block-max pruning: segments whose ``plan.max_score_bound`` can't
        reach ``min_score`` are skipped exactly (such docs are excluded
        from hits AND totals anyway).  With ``allow_kth_prune`` (the
        request waived exact totals via track_total_hits=false),
        segments that can't beat the running k-th score are skipped too
        — the k-th score is harvested from programs that already
        finished, never blocking the launch pipeline.  An expired
        ``deadline`` stops the launches at the next segment: the result
        covers the segments launched before it."""
        if prof is not None:
            prof.set("execution_path", "device")
        if k_want == 0:            # size=0: counts only
            # the scan records its phases inline; the host's sum is the
            # reduce
            with profile.phase(prof, "reduce"):
                total = sum(int(m.sum()) for _s, _d, _sc, m
                            in self._run_full(plan, bind, needed, min_score,
                                              can_match_skip=True,
                                              deadline=deadline, ckey=ckey,
                                              prof=prof))
            return [], total, None, False
        ms = self._min_score(min_score)
        ms_host = None if min_score is None else float(min_score)
        if isinstance(plan, P.TermBagPlan) and plan.scored and \
                k_want <= TOPK_K_MAX and not allow_kth_prune:
            return (*self._topk_term_bag(plan, bind, needed, k_want, ms,
                                         ms_host, ckey, deadline=deadline,
                                         prof=prof),
                    False)

        if allow_kth_prune:
            return self._topk_per_segment(plan, bind, needed, k_want, ms,
                                          ms_host, deadline, ckey, prof)
        # the segments this request evaluates, then each term-bag leaf
        # launched once over all of them, then one plan top-k
        items, order = [], []
        for si, seg in enumerate(self.segments):
            if deadline is not None and deadline.expired():
                break              # partial top-k; response flags timed_out
            if self._prune(plan, bind, seg, ms_host, prof):
                continue
            items.append(self._evaluated(plan, bind, needed, seg, ckey,
                                         prof))
            order.append(si)
        if not items:
            return [], 0, None, False
        device_ledger().record_dispatch(_groups(d for _s, d, *_r in items))
        t_disp = time.monotonic()
        P.dense_prepass(plan, [(A, dims, ins)
                               for _s, _d, dims, ins, A in items])
        entries = []
        for _seg, _dseg, dims, ins, A in items:
            scores, matched = plan.eval(A, dims, ins)
            entries.append(bm25_ops.PlanScores(scores, matched, A["live"]))
        out = bm25_ops.plan_topk_segments_auto(entries, k=k_want,
                                               min_score=ms)
        if prof is not None:
            prof.launched(time.monotonic() - t_disp)
        with profile.phase(prof, "reduce"):
            return (*self._rows_of(out, order, k_want), False)

    def _topk_per_segment(self, plan, bind, needed, k_want, ms, ms_host,
                          deadline, ckey, prof=None):
        """``_topk`` with exact totals waived: the plan's term-bag leaves
        launched once over every segment that can match (``dense_prepass``),
        then one program per segment (the rest of the plan and a plan
        top-k of that segment), each launched before the host reads any
        result back, so that segments that cannot beat the running k-th
        score, harvested from programs already finished, are skipped.
        ``prof`` gives each segment its own record: its setup, its share
        of the pre-pass and its program (or its ``pruned_kth``
        decision)."""
        items = []
        for si, seg in enumerate(self.segments):
            if deadline is not None and deadline.expired():
                break              # partial top-k; response flags timed_out
            if self._prune(plan, bind, seg, ms_host, prof):
                continue
            items.append((si, self._evaluated(plan, bind, needed, seg,
                                              ckey, prof)))
        pending = prof.take_pending() if prof is not None else None
        device_ledger().record_dispatch(
            _groups(d for _si, (_s, d, *_r) in items))
        t_pre = time.monotonic()
        P.dense_prepass(plan, [(A, dims, ins)
                               for _si, (_s, _d, dims, ins, A) in items])
        share = (time.monotonic() - t_pre) / max(1, len(items))
        # phase 1: LAUNCH every segment's program without a host sync
        launched = []      # [si, vals, idx, tot, mx, synced_vals, event]
        kth = None         # running k-th best (harvested, host)
        total_is_lower_bound = False
        on_cuda = self.device.type == "cuda"
        for j, (si, (seg, _d, dims, ins, A)) in enumerate(items):
            if deadline is not None and deadline.expired():
                break              # partial top-k; response flags timed_out
            t_seg = time.monotonic()
            if kth is not None and plan.max_score_bound(bind, seg) <= kth:
                # the k-th holder launched earlier, so it wins any tie at
                # exactly the bound (seg-asc tie-break); totals become a
                # lower bound
                total_is_lower_bound = True
                if prof is not None:
                    prof.settle(pending[j], share + time.monotonic() - t_seg,
                                "pruned_kth")
                continue
            scores, matched = plan.eval(A, dims, ins)
            out = bm25_ops.plan_topk_segments_auto(
                [bm25_ops.PlanScores(scores, matched, A["live"])], k=k_want,
                min_score=ms)
            event = None
            if on_cuda:
                event = torch.cuda.Event()
                event.record()
            launched.append([si, out.vals[0], out.ids[0], out.totals[0],
                             out.maxes[0], None, event])
            if si + 1 < len(self.segments):
                kth = self._harvest_kth(launched, k_want, kth)
            if prof is not None:
                prof.settle(pending[j], share + time.monotonic() - t_seg)
        if not launched:
            return [], 0, None, total_is_lower_bound
        # phase 2: ONE host-sync region over all segments' results
        t_sync = time.monotonic()
        vals_h = torch.stack([e[1] for e in launched]).cpu().numpy()
        idx_h = torch.stack([e[2] for e in launched]).cpu().numpy()
        tot_h = torch.stack([e[3] for e in launched]).cpu().numpy()
        mx_h = torch.stack([e[4] for e in launched]).cpu().numpy()
        device_ledger().record_fetch(
            vals_h.nbytes + idx_h.nbytes + tot_h.nbytes + mx_h.nbytes,
            time.monotonic() - t_sync)
        per_seg = []
        for j, entry in enumerate(launched):
            keep = vals_h[j] > -np.inf
            per_seg.append((vals_h[j][keep],
                            np.full(int(keep.sum()), entry[0], _I32),
                            idx_h[j][keep]))
        rows, total, max_score = self._merge_topk(
            per_seg, k_want, int(tot_h.sum()), float(mx_h.max()))
        if prof is not None:
            prof.add("reduce", time.monotonic() - t_sync)
        return rows, total, max_score, total_is_lower_bound

    def _topk_term_bag(self, plan, bind, needed, k_want, ms, ms_host,
                       ckey, f32: bool = False, deadline=None, prof=None):
        """(rows, total, max_score) of a scored term bag: can-match and
        min_score bound skips on the host, then every remaining segment's
        top-k, total and max from one ``term_bag_topk_segments_auto``
        call, read back in one copy.  ``topk_input`` reads the f32 columns
        only on f32 segments, where they are always staged, unless ``f32``
        asks for the f32 lowering everywhere (the batched path's, for a
        bag K3 does not stage), which stages them on demand.  Quantized
        tables are prefetched into free pager pages first (the reference's
        oracle).  An expired ``deadline`` leaves the remaining segments
        out of the launch."""
        if not f32:
            plan.prefetch_quantized(bind, self.segments, self.device)
        inputs, order, dsegs = [], [], []
        for si, seg in enumerate(self.segments):
            if deadline is not None and deadline.expired():
                break
            if self._prune(plan, bind, seg, ms_host, prof):
                continue
            mark = prof.mark() if prof is not None else None
            dseg = seg.device(self.device)
            inputs.append(self._cached(
                ckey, seg, "topk_input_f32" if f32 else "topk_input",
                lambda seg=seg, dseg=dseg: plan.topk_input(
                    bind, seg, dseg, build_arrays(
                        dseg, needed, self.mapper,
                        live=self.ctx.live_mask(seg, dseg),
                        partial_ok=needed), f32=f32), prof))
            if prof is not None:
                prof.scan(seg.seg_id, prof.since(mark))
            order.append(si)
            dsegs.append(dseg)
        if not inputs:
            return [], 0, None
        device_ledger().record_dispatch(_groups(dsegs))
        t_disp = time.monotonic()
        out = bm25_ops.term_bag_topk_segments_auto(inputs, k=k_want,
                                                   min_score=ms)
        if prof is not None:
            prof.launched(time.monotonic() - t_disp)
        with profile.phase(prof, "reduce"):
            return self._rows_of(out, order, k_want)

    # -- order, collapse, rescore ------------------------------------------

    def _field_sorted(self, plan, bind, needed, k_want, sort_specs,
                      min_score, views=None, slice_spec=None,
                      search_after=None, deadline=None, ckey=None,
                      prof=None):
        """(rows, total, None): every matched row ordered by the parsed
        ``sort_specs`` on the device (``search/sorting.py``
        ``field_order``), the rows at or before ``search_after`` dropped,
        and the first ``k_want`` read back with their sort values.
        ``k_want=None`` returns the whole ordering as
        ``sorting.OrderedRows`` on the device (collapse, ``scan_rows``);
        ``slice_spec`` keeps a slice's rows (``sorting.slice_filter``), and
        ``total`` is then the slice's count.  ``prof``: the scan's phases
        inline, the keys, sorts and read-back as ``reduce``."""
        with profile.phase(prof, "reduce"):
            if views is None:
                views = list(self._run_full(plan, bind, needed, min_score,
                                            deadline=deadline, ckey=ckey,
                                            prof=prof))
            flat = sorting.matched_rows(self, views, slice_spec)
            probe = (None if search_after is None
                     else self._coerce_search_after(search_after,
                                                    sort_specs))
            ordered = sorting.field_order(self, views, flat, sort_specs,
                                          probe)
            if k_want is None:
                return ordered, ordered.total, None
            return ordered.take(k_want)[0], ordered.total, None

    def _coerce_search_after(self, search_after, sort_specs) -> list:
        """``search_after`` in the columns' space: a string for a numeric
        or date field goes through the field's ``range_bound``."""
        coerced = []
        for v, spec in zip(search_after, sort_specs):
            ft = (None if spec["field"] == "_score"
                  else self.ctx.field_type(spec["field"]))
            if ft is not None and isinstance(v, str) \
                    and ft.dv_kind in ("long", "double"):
                v = ft.range_bound(v)
            coerced.append(v)
        return coerced

    def _rescored(self, rows, rescore):
        """Query rescorer (search/rescore/QueryRescorer): re-rank the top
        window by combining the original score with a rescore query's
        score for those docs; tail rows keep their order.  The rescore
        query runs over the segments that hold the window's rows; its
        scores and mask are gathered at those rows on the device and
        read back in one copy; the arithmetic is the reference's, in
        float64 on the host."""
        spec = rescore[0] if isinstance(rescore, list) else rescore
        q = spec.get("query") or {}
        window = int(spec.get("window_size", 10))
        rq_json = q.get("rescore_query")
        if rq_json is None:
            raise IllegalArgumentError(
                "[rescore] requires [query.rescore_query]")
        qw = float(q.get("query_weight", 1.0))
        rw = float(q.get("rescore_query_weight", 1.0))
        mode = str(q.get("score_mode", "total"))
        combine = {"total": lambda a, b: a + b,
                   "multiply": lambda a, b: a * b,
                   "avg": lambda a, b: (a + b) / 2.0,
                   "max": max, "min": min}.get(mode)
        (rplan, rbind), rckey = self.compiled(rq_json, scored=True,
                                              with_key=True)
        if combine is None:
            raise IllegalArgumentError(
                f"unknown rescore score_mode [{mode}]")
        window_rows = rows[:window]
        locals_of: dict = {}
        for r in window_rows:
            locals_of.setdefault(r["seg"], []).append(r["local"])
        segs = sorted(locals_of)
        col = {}                # each window row's column in the copy
        for si in segs:
            for local in locals_of[si]:
                col[(si, local)] = len(col)
        gathered = []
        for si, (_seg, _dseg, scores, matched) in zip(segs, self._run_full(
                rplan, rbind, rplan.arrays(), None, ckey=rckey,
                only=set(segs))):
            idx = torch.tensor(locals_of[si], dtype=torch.int64,
                               device=self.device)
            gathered.append(torch.stack([scores[idx],
                                         matched[idx].to(torch.float32)]))
        host = sorting.to_host(self, torch.cat(gathered, dim=1)) \
            if gathered else None
        out = []
        for r in window_rows:
            c = col[(r["seg"], r["local"])]
            base = qw * (r.get("score") or 0.0)
            if host[1, c]:
                new = combine(base, rw * float(host[0, c]))
            else:
                new = base       # unmatched docs keep the weighted base
            out.append({**r, "score": new})
        out.sort(key=lambda r: (-r["score"], r["seg"], r["local"]))
        out.extend(rows[window:])
        return out, (out[0]["score"] if out else None)

    def _collapsed(self, plan, bind, needed, k_want, sort_specs,
                   min_score, collapse, views, search_after=None,
                   ckey=None, prof=None):
        """Field collapsing (search/collapse/): one hit per distinct
        value of the collapse field, the best-ranked in result order,
        found on the device (``sorting.collapse``).  ``prof``: the scan's
        phases inline, the ordering and the collapse as ``reduce``."""
        field = collapse.get("field") if isinstance(collapse, dict) \
            else None
        if not field:
            raise IllegalArgumentError("[collapse] requires a [field]")
        ft = self.ctx.field_type(field)
        if ft is None or ft.dv_kind not in ("long", "double", "ordinal"):
            raise IllegalArgumentError(
                f"cannot collapse on [{field}]: keyword or numeric doc "
                "values required")
        with profile.phase(prof, "reduce"):
            if sort_specs is not None:
                ordered, total, _ = self._field_sorted(
                    plan, bind, needed, None, sort_specs, min_score, views,
                    search_after=search_after, ckey=ckey, prof=prof)
            elif views is not None:
                # an aggs pass already ran the full query: rank from it
                # instead of a second device execution
                ordered, total = self._rows_from_views(views)
            else:
                ordered, total = self.scan_rows(
                    {"query": None, "min_score": min_score}, None,
                    _precompiled=(plan, bind, needed, ckey), _prof=prof)
            out = sorting.collapse(self, ordered, field, ft, k_want)
        max_score = (out[0].get("score") if out and sort_specs is None
                     else None)
        return out, total, max_score

    def _rows_from_views(self, views) -> tuple:
        """(``sorting.OrderedRows``, total): every matched row of an
        already-run full-scores pass in (score desc, seg, local) order,
        on the device."""
        ordered = sorting.score_order(self, views,
                                      sorting.matched_rows(self, views))
        return ordered, ordered.total

    def scan_rows(self, body: Optional[dict] = None, slice_spec=None,
                  _precompiled=None, _prof=None) -> tuple:
        """(``sorting.OrderedRows``, total): EVERY matched row in result
        order on the device — the body's field sort, else (score desc,
        seg, local) — for a cursor over all of them (``take`` reads a
        page back); ``slice_spec`` (``{"id": i, "max": n}``) keeps a
        slice's rows, and ``total`` is then the slice's count."""
        body = body or {}
        sort_specs = sorting.parse_sort(body.get("sort"))
        min_score = body.get("min_score")
        with device_ledger().request():
            if _precompiled is not None:
                plan, bind, needed, ckey = _precompiled
            else:
                needs_scores = sort_specs is None or min_score is not None \
                    or any(s["field"] == "_score" for s in sort_specs)
                (plan, bind), ckey = self.compiled(body.get("query"),
                                                   scored=needs_scores,
                                                   with_key=True)
                needed = plan.arrays()
            views = (list(self._run_full(plan, bind, needed, min_score,
                                         ckey=ckey, prof=_prof))
                     if self.segments else [])
            if sort_specs is not None:
                ordered, total, _ = self._field_sorted(
                    plan, bind, needed, None, sort_specs, min_score, views,
                    slice_spec=slice_spec)
                return ordered, total
            ordered = sorting.score_order(
                self, views, sorting.matched_rows(self, views, slice_spec))
            return ordered, ordered.total

    @staticmethod
    def _harvest_kth(launched, k_want, kth):
        """Update the running k-th best score from programs that ALREADY
        finished (a CPU result, or a CUDA one whose event has fired), so
        reading them never blocks the launch pipeline (the MaxScore
        running threshold)."""
        ready = []
        for entry in launched:
            if entry[5] is None and (entry[6] is None or entry[6].query()):
                entry[5] = entry[1].cpu().numpy()
            if entry[5] is not None:
                ready.append(entry[5])
        if not ready:
            return kth
        vals = np.concatenate(ready).ravel()
        vals = vals[vals > -np.inf]
        if len(vals) < k_want:
            return kth
        cand = float(np.partition(vals, -k_want)[-k_want])
        return cand if kth is None or cand > kth else kth
