"""Shard-side query phase: run a compiled plan over every segment, merge
top-k across segments, fetch sources (the port of the JAX package's
``search/executor.py``, cut to ``query``, ``size``, ``from``,
``min_score``, ``_source`` and ``track_total_hits``).

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

Not ported yet (ROADMAP): sort, collapse, rescore,
search_after, highlight / explain / fields, profile, suggest, and the
telemetry / insights / task / device-health hooks.  Requests that use
them raise ``NotYetPortedError``.

The searcher's caches are ``BoundedCache``s: the engine's threadpool and
the continuous batcher call ``search`` from many threads at once.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch

from opensearch_tpu_torch.common.cache import BoundedCache
from opensearch_tpu_torch.common.errors import (IllegalArgumentError,
                                                NotYetPortedError,
                                                ValidationError)
from opensearch_tpu_torch.common.torchenv import resolve_device
from opensearch_tpu_torch.index.segment import DeviceSegment, Segment
from opensearch_tpu_torch.ops import bm25 as bm25_ops
from opensearch_tpu_torch.ops.cuda_bm25 import K_MAX as TOPK_K_MAX
from opensearch_tpu_torch.ops.phrase import stage_positions
from opensearch_tpu_torch.search import plan as P
from opensearch_tpu_torch.search.compiler import ShardContext, compile_query
from opensearch_tpu_torch.search.fetch import filter_source
from opensearch_tpu_torch.search.query_dsl import HybridQuery, parse_query

_I32 = np.int32

# request-body keys this port serves; any other key raises rather than
# being ignored
_SUPPORTED_BODY_KEYS = frozenset({"query", "size", "from", "min_score",
                                  "_source", "track_total_hits", "timeout",
                                  "_hybrid_pipeline", "aggs",
                                  "aggregations"})
# bounds of the searcher's plan, prepared-bindings and batch caches
# (entries)
_PLAN_CACHE_MAX = 256
_PREP_CACHE_MAX = 1024
_BATCH_PREP_CACHE_MAX = 64


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
    source.  Merges by (score desc, source, position).  A ``sort`` clause
    raises ``NotYetPortedError``, as it does on the shard."""
    if sort_json is not None:
        raise NotYetPortedError(
            "sort is not ported to the torch package yet")
    rows = sorted(rows, key=lambda t: (-(t[0]["_score"] or 0.0), t[1], t[2]))
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
        # the columns the filter plans read (the sort columns min/max are
        # read by no ported plan)
        ft = mapper.field_type(field)
        dtype = (torch.int32 if group == "ordinal" else torch.float64
                 if ft is not None and ft.dv_kind == "double"
                 else torch.int64)
        return {
            "values" if group == "numeric" else "ords": torch.full(
                (8,), 0 if group == "numeric" else -1, dtype=dtype,
                device=dev),
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
               "ordinal": dseg.ordinal, "vector": dseg.vector}
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


def _check_body_keys(body: dict) -> None:
    """Request-body keys this port does not serve raise rather than being
    ignored."""
    unknown = sorted(set(body) - _SUPPORTED_BODY_KEYS)
    if unknown:
        raise NotYetPortedError(
            f"search request keys {unknown} are not ported to the torch "
            "package yet")


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
        self.ctx = ShardContext(self.segments, mapper, self.device)
        self._plan_cache = BoundedCache(_PLAN_CACHE_MAX)
        self._prep_cache = BoundedCache(_PREP_CACHE_MAX)
        # msearch / continuous-batch group inputs, keyed by the group's
        # signature (``search/batch.py`` ``BatchGroup._prepare``)
        self._batch_prep_cache = BoundedCache(_BATCH_PREP_CACHE_MAX)

    # -- compiled-plan / prepared-bindings caches -------------------------

    def compiled(self, query_json: Optional[dict], scored: bool = True,
                 with_key: bool = False):
        """(plan, bind) for a raw query body through the searcher's plan
        cache, keyed on the canonicalized JSON.  The searcher is an
        immutable point-in-time view, so entries never go stale."""
        ckey = _plan_key(query_json, scored)
        out = self._plan_cache.get(ckey) if ckey is not None else None
        if out is None:
            out = compile_query(parse_query(query_json), self.ctx,
                                scored=scored)
            if ckey is not None:
                out = self._plan_cache.put(ckey, out)
        return (out, ckey) if with_key else out

    def cached_plan(self, query_json: Optional[dict], scored: bool = True):
        """(plan, bind) when the plan cache already holds the query, else
        None: a peek that never compiles."""
        ckey = _plan_key(query_json, scored)
        return None if ckey is None else self._plan_cache.get(ckey)

    def _prepared(self, plan, bind, seg, dseg, ckey):
        """``plan.prepare``'s per-(plan, segment) products — padded term
        ids, staged impact references, per-query tensors — cached so a
        repeated query does zero host-side prepare work and zero
        host-to-device copies per segment."""
        return self._cached(ckey, seg, "prepare",
                            lambda: plan.prepare(bind, seg, dseg, self.ctx))

    def _cached(self, ckey, seg, kind: str, make):
        """``make()``, cached per (query, segment, ``kind``) while the
        query has a cache key."""
        if ckey is None:
            return make()
        return self._prep_cache.get_or_make((ckey, id(seg), kind), make)

    # -- public API -------------------------------------------------------

    def doc_count(self) -> int:
        return sum(s.live_count() for s in self.segments)

    def resident_bytes(self) -> int:
        """Bytes of this searcher's segments staged on its device."""
        return sum(seg.device(self.device).nbytes()
                   for seg in self.segments)

    def count(self, query_json: Optional[dict] = None) -> int:
        if not self.segments:
            return 0
        (plan, bind), ckey = self.compiled(query_json, scored=False,
                                           with_key=True)
        needed = plan.arrays()
        total = 0
        for _seg, _dseg, _scores, matched in self._run_full(
                plan, bind, needed, None, can_match_skip=True, ckey=ckey):
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
            for pos, (rows, total, max_score) in group.run(self).items():
                results[pos] = self._response(
                    rows, total, max_score,
                    (bodies[pos] or {}).get("_source"), t0)
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
        q_json = body.get("query")
        if isinstance(q_json, dict) and "hybrid" in q_json:
            q = parse_query(q_json)
            if isinstance(q, HybridQuery):
                return self._hybrid_search(body, q, t0)
        _check_body_keys(body)
        return self._search_body(body, t0, agg_partials)

    def _search_body(self, body: dict, t0: float,
                     agg_partials: bool = False) -> dict:
        size = int(body.get("size", 10))
        from_ = int(body.get("from", 0))
        deadline = SearchDeadline(body.get("timeout"), t0)
        min_score = body.get("min_score")
        (plan, bind), ckey = self.compiled(body.get("query"), scored=True,
                                           with_key=True)
        needed = plan.arrays()
        k_want = from_ + size
        # with exact totals waived, block-max pruning may also skip
        # segments that cannot beat the running k-th score (the
        # reference's track_total_hits=false contract: totals become a
        # lower bound, flagged with relation "gte")
        allow_kth_prune = body.get("track_total_hits") is False
        aggs_json = body.get("aggs") or body.get("aggregations")
        total_is_lower_bound = False
        views = None
        if not self.segments:
            rows, total, max_score = [], 0, None
        elif aggs_json:
            # with aggs, the full-scores pass runs ONCE and feeds both the
            # top-k and the aggregations
            views = list(self._run_full(plan, bind, needed, min_score,
                                        deadline=deadline, ckey=ckey))
            rows, total, max_score = self._topk_from_views(views, k_want)
        else:
            rows, total, max_score, total_is_lower_bound = self._topk(
                plan, bind, needed, k_want, min_score, deadline=deadline,
                ckey=ckey, allow_kth_prune=allow_kth_prune)
        resp = self._response(rows[from_: from_ + size], total, max_score,
                              body.get("_source"), t0,
                              lower_bound=total_is_lower_bound,
                              timed_out=deadline.timed_out)
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
        return resp

    def _hybrid_search(self, body: dict, q, t0) -> dict:
        """Hybrid query: each sub-query runs as its own top-k (one K2 / K4
        launch for a ``match``, one K1 launch for a ``knn``); the
        normalization processor (``search/pipeline.py``) combines the
        per-sub-query top lists on the host.  ``_hybrid_pipeline`` in the
        body carries the processor config (wired by the REST layer from
        ``?search_pipeline=...``); absent -> min_max + arithmetic_mean."""
        from opensearch_tpu_torch.search.pipeline import NormalizationConfig

        if (body.get("sort") is not None or body.get("aggs")
                or body.get("aggregations")
                or body.get("min_score") is not None
                or body.get("search_after") is not None):
            raise ValidationError(
                "[hybrid] query does not support [sort], [aggs], "
                "[min_score] or [search_after]")
        _check_body_keys(body)
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
                     "hits": self._hits_from_rows(rows,
                                                  body.get("_source"))},
        }

    def _response(self, rows, total, max_score, source_spec, t0: float,
                  lower_bound: bool = False, timed_out: bool = False) -> dict:
        """A search response (``search``'s, ``msearch``'s and the
        continuous batcher's): the page's ``rows``, the matched total
        (a lower bound when ``lower_bound``), the largest score, whether
        the request's deadline cut the query phase and the time since
        ``t0``."""
        return {
            "took": int((time.monotonic() - t0) * 1000),
            "timed_out": bool(timed_out),
            "_shards": shards_section(1),
            "hits": {
                "total": {"value": int(total),
                          "relation": "gte" if lower_bound else "eq"},
                "max_score": max_score,
                "hits": self._hits_from_rows(rows, source_spec),
            },
        }

    def _hits_from_rows(self, rows, source_spec):
        hits = []
        for row in rows:
            seg = self.segments[row["seg"]]
            local = row["local"]
            hit = {"_index": self.index_name, "_id": seg.doc_ids[local],
                   "_score": row.get("score")}
            src = filter_source(seg.source(local), source_spec)
            if src is not None:
                hit["_source"] = src
            hits.append(hit)
        return hits

    # -- internals --------------------------------------------------------

    @staticmethod
    def _min_score(min_score) -> float:
        return -np.inf if min_score is None else float(np.float32(min_score))

    def _run_full(self, plan, bind, needed, min_score,
                  can_match_skip=False, deadline=None, ckey=None):
        """Yields (seg, dseg, scores, matched) per segment.
        ``can_match_skip`` is ONLY safe for consumers that don't index
        the yielded tuples by position.  An expired ``deadline`` stops
        the scan at the next segment boundary.  The plan's term-bag leaves
        are launched once over every segment scanned before the first is
        evaluated."""
        ms = self._min_score(min_score)
        items = []
        for seg in self.segments:
            if deadline is not None and deadline.expired():
                break
            if can_match_skip and not plan.can_match(bind, seg):
                continue
            items.append(self._evaluated(plan, bind, needed, seg, ckey))
        P.dense_prepass(plan, [(A, dims, ins)
                               for _s, _d, dims, ins, A in items])
        for seg, dseg, dims, ins, A in items:
            scores, matched = P.run_full(plan, dims, A, ins, ms)
            yield seg, dseg, scores, matched

    def _evaluated(self, plan, bind, needed, seg, ckey) -> tuple:
        """``(seg, dseg, dims, ins, A)``: one segment's prepared inputs
        (cached per query) and its request-scoped arrays."""
        dseg = seg.device(self.device)
        dims, ins = self._prepared(plan, bind, seg, dseg, ckey)
        A = build_arrays(dseg, needed, self.mapper,
                         live=self.ctx.live_mask(seg, dseg),
                         partial_ok=plan.skip_arrays(dims))
        return seg, dseg, dims, ins, A

    def _topk_from_views(self, views, k_want):
        """(rows, total, max_score) out of an already-run full-scores pass
        (aggs requests): every segment's top-k from one plan top-k call,
        read back in one copy."""
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
        vals, ids, totals, maxes = out.numpy()
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

    def _topk(self, plan, bind, needed, k_want, min_score, deadline=None,
              ckey=None, allow_kth_prune=False):
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
        if k_want == 0:            # size=0: counts only
            total = sum(int(m.sum()) for _s, _d, _sc, m
                        in self._run_full(plan, bind, needed, min_score,
                                          can_match_skip=True,
                                          deadline=deadline, ckey=ckey))
            return [], total, None, False
        ms = self._min_score(min_score)
        ms_host = None if min_score is None else float(min_score)
        if isinstance(plan, P.TermBagPlan) and plan.scored and \
                k_want <= TOPK_K_MAX and not allow_kth_prune:
            return (*self._topk_term_bag(plan, bind, needed, k_want, ms,
                                         ms_host, ckey, deadline=deadline),
                    False)

        if allow_kth_prune:
            return self._topk_per_segment(plan, bind, needed, k_want, ms,
                                          ms_host, deadline, ckey)
        # the segments this request evaluates, then each term-bag leaf
        # launched once over all of them, then one plan top-k
        items, order = [], []
        for si, seg in enumerate(self.segments):
            if deadline is not None and deadline.expired():
                break              # partial top-k; response flags timed_out
            if not plan.can_match(bind, seg):
                continue           # can-match skip: no staging, no program
            if ms_host is not None and \
                    plan.max_score_bound(bind, seg) < ms_host:
                continue           # exact: such docs never count in totals
            items.append(self._evaluated(plan, bind, needed, seg, ckey))
            order.append(si)
        if not items:
            return [], 0, None, False
        P.dense_prepass(plan, [(A, dims, ins)
                               for _s, _d, dims, ins, A in items])
        entries = []
        for _seg, _dseg, dims, ins, A in items:
            scores, matched = plan.eval(A, dims, ins)
            entries.append(bm25_ops.PlanScores(scores, matched, A["live"]))
        out = bm25_ops.plan_topk_segments_auto(entries, k=k_want,
                                               min_score=ms)
        return (*self._rows_of(out, order, k_want), False)

    def _topk_per_segment(self, plan, bind, needed, k_want, ms, ms_host,
                          deadline, ckey):
        """``_topk`` with exact totals waived: the plan's term-bag leaves
        launched once over every segment that can match (``dense_prepass``),
        then one program per segment (the rest of the plan and a plan
        top-k of that segment), each launched before the host reads any
        result back, so that segments that cannot beat the running k-th
        score, harvested from programs already finished, are skipped."""
        items = []
        for si, seg in enumerate(self.segments):
            if deadline is not None and deadline.expired():
                break              # partial top-k; response flags timed_out
            if not plan.can_match(bind, seg):
                continue           # can-match skip: no staging, no program
            if ms_host is not None and \
                    plan.max_score_bound(bind, seg) < ms_host:
                continue           # exact: such docs never count in totals
            items.append((si, self._evaluated(plan, bind, needed, seg,
                                              ckey)))
        P.dense_prepass(plan, [(A, dims, ins)
                               for _si, (_s, _d, dims, ins, A) in items])
        # phase 1: LAUNCH every segment's program without a host sync
        launched = []      # [si, vals, idx, tot, mx, synced_vals, event]
        kth = None         # running k-th best (harvested, host)
        total_is_lower_bound = False
        on_cuda = self.device.type == "cuda"
        for si, (seg, _d, dims, ins, A) in items:
            if deadline is not None and deadline.expired():
                break              # partial top-k; response flags timed_out
            if kth is not None and plan.max_score_bound(bind, seg) <= kth:
                # the k-th holder launched earlier, so it wins any tie at
                # exactly the bound (seg-asc tie-break); totals become a
                # lower bound
                total_is_lower_bound = True
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
        if not launched:
            return [], 0, None, total_is_lower_bound
        # phase 2: ONE host-sync region over all segments' results
        vals_h = torch.stack([e[1] for e in launched]).cpu().numpy()
        idx_h = torch.stack([e[2] for e in launched]).cpu().numpy()
        tot_h = torch.stack([e[3] for e in launched]).cpu().numpy()
        mx_h = torch.stack([e[4] for e in launched]).cpu().numpy()
        per_seg = []
        for j, entry in enumerate(launched):
            keep = vals_h[j] > -np.inf
            per_seg.append((vals_h[j][keep],
                            np.full(int(keep.sum()), entry[0], _I32),
                            idx_h[j][keep]))
        rows, total, max_score = self._merge_topk(
            per_seg, k_want, int(tot_h.sum()), float(mx_h.max()))
        return rows, total, max_score, total_is_lower_bound

    def _topk_term_bag(self, plan, bind, needed, k_want, ms, ms_host,
                       ckey, f32: bool = False, deadline=None):
        """(rows, total, max_score) of a scored term bag: can-match and
        min_score bound skips on the host, then every remaining segment's
        top-k, total and max from one ``term_bag_topk_segments_auto``
        call, read back in one copy.  ``topk_input`` reads the f32 columns
        only on f32 segments, where they are always staged, unless ``f32``
        asks for the f32 lowering everywhere (the batched path's, for a
        bag K3 does not stage), which stages them on demand.  An expired
        ``deadline`` leaves the remaining segments out of the launch."""
        inputs, order = [], []
        for si, seg in enumerate(self.segments):
            if deadline is not None and deadline.expired():
                break
            if not plan.can_match(bind, seg):
                continue
            if ms_host is not None and \
                    plan.max_score_bound(bind, seg) < ms_host:
                continue           # exact: such docs never count
            dseg = seg.device(self.device)
            inputs.append(self._cached(
                ckey, seg, "topk_input_f32" if f32 else "topk_input",
                lambda seg=seg, dseg=dseg: plan.topk_input(
                    bind, seg, dseg, build_arrays(
                        dseg, needed, self.mapper,
                        live=self.ctx.live_mask(seg, dseg),
                        partial_ok=needed), f32=f32)))
            order.append(si)
        if not inputs:
            return [], 0, None
        return self._rows_of(bm25_ops.term_bag_topk_segments_auto(
            inputs, k=k_want, min_score=ms), order, k_want)

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
