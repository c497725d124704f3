"""Query tree -> (plan, bindings) against a shard's mapping + collection
statistics (the port of the part of the JAX package's
``search/compiler.py`` that match / term / terms / range / exists / ids /
prefix / bool / constant_score / knn / script_score queries need, the
positional full-text family: match_phrase, match_phrase_prefix,
match_bool_prefix, multi_match, dis_max, simple_query_string, the span
queries and intervals, the multi-term queries wildcard / regexp / fuzzy
and ``fuzziness``, the relevance-shaping queries function_score /
boosting / rank_feature / distance_feature, terms_set, more_like_this,
the geo filters geo_distance / geo_bounding_box / geo_polygon, nested
over a path's staged object columns, the parent-join queries has_child /
has_parent / parent_id over the join field's hidden ordinal columns, and
percolate).

idf/avgdl are computed here from CROSS-SEGMENT stats (Lucene computes
them in IndexSearcher.termStatistics over the whole reader, not per
leaf), so scores are consistent across segments.  ``_COMPILERS`` holds
every entry of the reference's table.
"""

from __future__ import annotations

import bisect
import ipaddress
import math
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from opensearch_tpu_torch.common.errors import (IllegalArgumentError,
                                                OpenSearchTpuError,
                                                ParsingError)
from opensearch_tpu_torch.mapping.types import (KeywordFieldType,
                                                TextFieldType,
                                                parse_date_millis,
                                                parse_ip_long)
from opensearch_tpu_torch.ops import bm25 as bm25_ops
from opensearch_tpu_torch.search import plan as P
from opensearch_tpu_torch.search import profile
from opensearch_tpu_torch.search import query_dsl as dsl

_I64_MIN = -(2**63)
_I64_MAX = 2**63 - 1


@dataclass
class FieldStats:
    doc_count: int
    total_len: float

    @property
    def avgdl(self) -> float:
        return self.total_len / self.doc_count if self.doc_count else 1.0


class ShardContext:
    """Per-searcher compile context: mapping + collection statistics over
    the segment set (IndexSearcher.collectionStatistics analog), and the
    device the searcher's segments are staged on."""

    def __init__(self, segments, mapper, device):
        self.segments = segments
        self.mapper = mapper
        self.device = torch.device(device)
        # point-in-time live-bitmap snapshot (apply_deletes replaces the
        # array, so this context keeps seeing the state at acquire time)
        self.lives = {id(s): s.live for s in segments}
        self._fstats: dict[str, FieldStats] = {}
        self._sorted_terms: dict[tuple[int, str], list[str]] = {}

    def live_mask(self, seg, dseg):
        return dseg.live_mask(self.lives[id(seg)])

    def field_type(self, field: str):
        return self.mapper.field_type(field)

    def field_stats(self, field: str) -> FieldStats:
        st = self._fstats.get(field)
        if st is None:
            doc_count = 0
            total_len = 0.0
            for seg in self.segments:
                pf = seg.postings.get(field)
                if pf is not None:
                    doc_count += pf.docs_with_field
                    total_len += pf.total_len
            st = FieldStats(doc_count, total_len)
            self._fstats[field] = st
        return st

    def df(self, field: str, term: str) -> int:
        total = 0
        for seg in self.segments:
            pf = seg.postings.get(field)
            if pf is not None:
                tid = pf.term_id(term)
                if tid >= 0:
                    total += int(pf.df[tid])
        return total

    def sorted_terms(self, seg, field: str) -> list[str]:
        key = (id(seg), field)
        out = self._sorted_terms.get(key)
        if out is None:
            out = list(seg.postings[field].terms)
            self._sorted_terms[key] = out
        return out

    def text_fields(self) -> list[str]:
        return [f for f, ft in self.mapper.field_types().items()
                if isinstance(ft, TextFieldType)]


def calc_min_should_match(optional: int, spec) -> int:
    """Lucene ``Queries.calculateMinShouldMatch`` subset: int, "-int",
    "N%", "-N%" (conditional "N<P" specs unsupported).  Percentages
    truncate toward zero (Java int cast).  May return a value LARGER than
    ``optional`` — the caller must then match nothing (Lucene rewrites to
    MatchNoDocsQuery)."""
    if spec is None:
        return 0
    s = str(spec).strip()
    if "<" in s:
        raise IllegalArgumentError(
            f"conditional minimum_should_match [{s}] is not supported")
    if s.endswith("%"):
        pct = int(s[:-1])
        result = (optional + int(optional * pct / 100.0) if pct < 0
                  else int(optional * pct / 100.0))
    else:
        n = int(s)
        result = n if n >= 0 else optional + n
    return max(0, result)


def _idfs_for(ctx: ShardContext, field: str, terms: list[str]) -> np.ndarray:
    stats = ctx.field_stats(field)
    return np.asarray(
        [bm25_ops.idf(ctx.df(field, t), stats.doc_count) for t in terms],
        dtype=np.float32)


def _term_bag(ctx, field, terms, required, boost, scored):
    idfs = _idfs_for(ctx, field, terms)
    bind = {"terms": tuple(terms), "idfs": idfs,
            "weights": np.full(len(terms), boost, np.float32),
            "avgdl": ctx.field_stats(field).avgdl, "required": required}
    return P.TermBagPlan(field=field, scored=scored), bind


def _none():
    return P.MatchNonePlan(), {}


def _ip_cidr_bind(value: str, boost: float) -> dict:
    net = ipaddress.ip_network(str(value), strict=False)
    return {"lo": parse_ip_long(net.network_address),
            "hi": parse_ip_long(net.broadcast_address), "boost": boost}


def _require_ft(ctx, field, qname):
    ft = ctx.field_type(field)
    if ft is None:
        return None
    if not ft.index_enabled and ft.dv_kind == "none":
        raise IllegalArgumentError(
            f"Cannot search on field [{field}] since it is not indexed")
    return ft


def compile_query(q: dsl.Query, ctx: ShardContext, scored: bool = True,
                  prof=None):
    """Returns (plan, bind).  ``prof`` (a ``search/profile.py``
    ``QueryProfiler``) times the plan's construction into the ``compile``
    phase and records the root query type."""
    fn = _COMPILERS.get(type(q))
    if fn is None:
        # a hybrid query runs only at the root, per sub-query
        # (executor._hybrid_search); nested, the reference refuses it
        raise IllegalArgumentError(
            f"query type [{type(q).__name__}] is not supported")
    with profile.phase(prof, "compile"):
        out = fn(q, ctx, scored)
    if prof is not None:
        prof.set("query_type", type(q).__name__)
    return out


def _c_match_all(q, ctx, scored):
    return P.MatchAllPlan(), {"boost": q.boost}


def _c_match_none(q, ctx, scored):
    return _none()


def _c_term(q, ctx, scored):
    if q.field == "_id":
        # term/terms on the _id metafield = an ids query
        # (IdFieldMapper.termQuery)
        return _c_ids(dsl.IdsQuery(values=[str(q.value)], boost=q.boost),
                      ctx, scored)
    ft = _require_ft(ctx, q.field, "term")
    if ft is None:
        return _none()
    if ft.type_name == "ip":
        if "/" in str(q.value):
            return (P.NumericRangePlan(field=q.field, kind="long"),
                    _ip_cidr_bind(q.value, q.boost))
        term = str(ipaddress.ip_address(str(q.value)))
        return _term_bag(ctx, q.field, [term], 1, q.boost, scored)
    if ft.dv_kind in ("long", "double") and ft.type_name != "boolean":
        return (P.NumericTermsPlan(field=q.field, kind=ft.dv_kind),
                {"values": [ft.term_for_query(q.value)], "boost": q.boost})
    term = ft.term_for_query(q.value)
    return _term_bag(ctx, q.field, [term], 1, q.boost, scored)


def _c_terms(q, ctx, scored):
    if q.field == "_id":
        return _c_ids(dsl.IdsQuery(values=[str(v) for v in q.values],
                                   boost=q.boost), ctx, scored)
    ft = _require_ft(ctx, q.field, "terms")
    if ft is None or not q.values:
        return _none()
    if ft.type_name == "ip":
        cidrs = [v for v in q.values if "/" in str(v)]
        exact = [str(ipaddress.ip_address(str(v))) for v in q.values
                 if "/" not in str(v)]
        if cidrs:
            children, binds = [], []
            if exact:
                p = P.PostingsMaskPlan(field=q.field)
                children.append(p)
                binds.append({"terms": tuple(exact), "boost": 1.0})
            for c in cidrs:
                net = ipaddress.ip_network(str(c), strict=False)
                children.append(P.NumericRangePlan(field=q.field, kind="long"))
                binds.append({"lo": parse_ip_long(net.network_address),
                              "hi": parse_ip_long(net.broadcast_address),
                              "boost": 1.0})
            inner = P.BoolPlan(should=tuple(children))
            return (P.ConstScorePlan(child=inner),
                    {"boost": q.boost,
                     "child": {"boost": 1.0, "required": 1,
                               "children": tuple(binds)}})
        return (P.PostingsMaskPlan(field=q.field),
                {"terms": tuple(exact), "boost": q.boost})
    if ft.dv_kind in ("long", "double") and ft.type_name != "boolean":
        return (P.NumericTermsPlan(field=q.field, kind=ft.dv_kind),
                {"values": [ft.term_for_query(v) for v in q.values],
                 "boost": q.boost})
    terms = [ft.term_for_query(v) for v in q.values]
    return (P.PostingsMaskPlan(field=q.field),
            {"terms": tuple(terms), "boost": q.boost})


def _c_match(q, ctx, scored):
    ft = _require_ft(ctx, q.field, "match")
    if ft is None:
        return _none()
    if not isinstance(ft, TextFieldType):
        try:
            return _c_term(dsl.TermQuery(field=q.field, value=q.query,
                                         boost=q.boost), ctx, scored)
        except (OpenSearchTpuError, ValueError):
            if q.lenient:
                return _none()
            raise
    qa = getattr(q, "analyzer", None)
    if qa:
        terms = ctx.mapper.analyzers.get(qa).terms(str(q.query))
    else:
        terms = ft.search_terms(q.query, ctx.mapper.analyzers)
    if not terms:
        return _none()
    if q.fuzziness is not None:
        # one constant-score fuzzy mask per term, combined as a bool
        children, binds = [], []
        for t in terms:
            plan, bind = _expand_terms(q.field, "fuzzy", {
                "pattern": t, "fuzzy_dist": _auto_fuzzy(q.fuzziness, t),
                "prefix_length": 0, "boost": q.boost}, ctx)
            children.append(plan)
            binds.append(bind)
        required = (len(terms) if q.operator == "and"
                    else max(1, calc_min_should_match(
                        len(terms), q.minimum_should_match)))
        return P.BoolPlan(should=tuple(children)), {
            "boost": 1.0, "required": required, "children": tuple(binds)}
    if q.operator == "and":
        required = len(terms)
    else:
        required = max(1, calc_min_should_match(len(terms),
                                                q.minimum_should_match))
    if required > len(terms):
        return _none()
    return _term_bag(ctx, q.field, terms, required, q.boost, scored)


def _auto_fuzzy(fuzziness, term: str) -> int:
    s = str(fuzziness).upper()
    if s.startswith("AUTO"):
        n = len(term)
        return 0 if n < 3 else (1 if n <= 5 else 2)
    return int(float(s))


def _c_bool(q, ctx, scored):
    groups = {}
    for name, qs, sub_scored in (("must", q.must, scored),
                                 ("should", q.should, scored),
                                 ("must_not", q.must_not, False),
                                 ("filter", q.filter, False)):
        plans, binds = [], []
        for sub in qs:
            p, b = compile_query(sub, ctx, sub_scored)
            plans.append(p)
            binds.append(b)
        groups[name] = (tuple(plans), tuple(binds))
    n_should = len(groups["should"][0])
    if q.minimum_should_match is not None:
        required = calc_min_should_match(n_should, q.minimum_should_match)
        if required > n_should:
            return _none()   # Lucene rewrites to MatchNoDocsQuery
    else:
        required = 0 if (q.must or q.filter) else (1 if n_should else 0)
    plan = P.BoolPlan(must=groups["must"][0], should=groups["should"][0],
                      must_not=groups["must_not"][0],
                      filter=groups["filter"][0])
    bind = {"boost": q.boost, "required": required,
            "children": (groups["must"][1] + groups["should"][1]
                         + groups["must_not"][1] + groups["filter"][1])}
    return plan, bind


def _c_range(q, ctx, scored):
    if getattr(q, "lenient", False):
        try:
            return _c_range_strict(q, ctx, scored)
        except (OpenSearchTpuError, ValueError):
            return _none()
    return _c_range_strict(q, ctx, scored)


def _c_range_strict(q, ctx, scored):
    ft = _require_ft(ctx, q.field, "range")
    if ft is None:
        return _none()
    if isinstance(ft, TextFieldType):
        raise IllegalArgumentError(
            f"range query on [text] field [{q.field}] is not supported")
    if isinstance(ft, KeywordFieldType):
        lo, lo_incl = (q.gte, True) if q.gte is not None else (q.gt, False)
        hi, hi_incl = (q.lte, True) if q.lte is not None else (q.lt, False)
        bind = {"lo": None if lo is None else str(lo), "lo_incl": lo_incl,
                "hi": None if hi is None else str(hi), "hi_incl": hi_incl,
                "boost": q.boost}
        return P.OrdinalRangePlan(field=q.field), bind
    kind = "double" if ft.dv_kind == "double" else "long"
    if kind == "long":
        lo = _I64_MIN if q.gte is None and q.gt is None else (
            ft.range_bound(q.gte) if q.gte is not None
            else ft.range_bound(q.gt) + 1)
        hi = _I64_MAX if q.lte is None and q.lt is None else (
            ft.range_bound(q.lte) if q.lte is not None
            else ft.range_bound(q.lt) - 1)
        return (P.NumericRangePlan(field=q.field, kind="long"),
                {"lo": lo, "hi": hi, "boost": q.boost})
    lo, lo_incl = (-np.inf, True)
    if q.gte is not None:
        lo, lo_incl = float(ft.range_bound(q.gte)), True
    elif q.gt is not None:
        lo, lo_incl = float(ft.range_bound(q.gt)), False
    hi, hi_incl = (np.inf, True)
    if q.lte is not None:
        hi, hi_incl = float(ft.range_bound(q.lte)), True
    elif q.lt is not None:
        hi, hi_incl = float(ft.range_bound(q.lt)), False
    return (P.NumericRangePlan(field=q.field, kind="double",
                               include_lo=lo_incl, include_hi=hi_incl),
            {"lo": lo, "hi": hi, "boost": q.boost})


def _c_exists(q, ctx, scored):
    if q.field in ("_id", "_index", "_seq_no", "_version"):
        # always-present metafields: every live doc matches
        # (exists rewrites to match_all for fields with norms/dv on all
        # docs — MetadataFieldMapper existence semantics)
        return _c_match_all(dsl.MatchAllQuery(boost=q.boost), ctx, scored)
    ft = ctx.field_type(q.field)
    if ft is None or ft.type_name == "object":
        # object container (explicit or implicit): exists = any child
        # field exists (ObjectMapper existence expansion)
        children = [f for f in getattr(ctx.mapper, "_fields", {})
                    if f.startswith(q.field + ".")]
        if not children:
            return _none()
        return _c_bool(dsl.BoolQuery(
            should=[dsl.ExistsQuery(field=f) for f in children],
            boost=q.boost), ctx, scored)
    src = {"long": "numeric", "double": "numeric", "ordinal": "ordinal",
           "vector": "vector", "geo_point": "geo", "none": "norms"}[ft.dv_kind]
    if src != "norms" and not ft.doc_values_enabled:
        if ft.indexed and ft.index_enabled:
            # doc_values disabled but indexed: existence via the
            # postings presence column (the reference's _field_names
            # fallback)
            src = "norms"
        else:
            raise IllegalArgumentError(
                f"exists on field [{q.field}] requires doc_values or an "
                "indexed field")
    return P.ExistsPlan(field=q.field, src=src), {"boost": q.boost}


def _c_ids(q, ctx, scored):
    wanted = set(map(str, q.values))

    def mask_fn(seg, dseg):
        m = np.zeros(dseg.n_pad, bool)
        for did in wanted:
            loc = seg.id_to_local.get(did)
            if loc is not None:
                m[loc] = True
        return m

    return P.MaskPlan(label="ids"), {"mask_fn": mask_fn, "boost": q.boost}


# -- parent-join (modules/parent-join) --------------------------------------


def _find_join_field(ctx):
    for f, ft in ctx.mapper.field_types().items():
        if ft.type_name == "join":
            return f, ft
    return None, None


class _JoinColumns:
    """A searcher's view of one join field's hidden ordinal columns
    (``<field>#name``, ``<field>#parent``, staged as ordinal doc values),
    keyed to ``U``, the sorted union of every segment's ``#parent`` terms
    (the parent ``_id``s that some child names).  Per segment (by
    ``id(seg)``): ``parent_u``, int32 on the device, the ``U`` index of
    each of the segment's ``#parent`` ordinals, and ``self_u``, int32
    [n_pad], the ``U`` index of each doc's own ``_id`` (-1 where it is no
    child's parent).  Built once a searcher (its compile context caches
    it): the segments are immutable."""

    def __init__(self, ctx, field: str):
        pfield = field + "#parent"
        terms = [np.asarray(seg.ordinal_dv[pfield].ord_terms, dtype=str)
                 for seg in ctx.segments
                 if pfield in seg.ordinal_dv
                 and seg.ordinal_dv[pfield].ord_terms]
        u = (np.unique(np.concatenate(terms)) if terms
             else np.zeros(0, dtype=str))
        self.n_u = len(u)
        self.parent_u: dict[int, Optional[torch.Tensor]] = {}
        self.self_u: dict[int, torch.Tensor] = {}
        for seg in ctx.segments:
            dseg = seg.device(ctx.device)
            dv = seg.ordinal_dv.get(pfield)
            self.parent_u[id(seg)] = (
                None if dv is None or not dv.ord_terms else torch.from_numpy(
                    np.searchsorted(u, np.asarray(dv.ord_terms, dtype=str))
                    .astype(np.int32)).to(ctx.device))
            own = np.full(dseg.n_pad, -1, np.int32)
            if self.n_u and seg.n_docs:
                ids = np.asarray(seg.doc_ids, dtype=str)
                at = np.searchsorted(u, ids).clip(max=self.n_u - 1)
                hit = u[at] == ids
                own[: seg.n_docs][hit] = at[hit]
            self.self_u[id(seg)] = torch.from_numpy(own).to(ctx.device)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (*self.parent_u.values(), *self.self_u.values())
                   if t is not None)


def _join_columns(ctx, field: str) -> _JoinColumns:
    from opensearch_tpu_torch.common.cache import attached_cache

    cache = attached_cache(ctx, "_join_col_cache",
                           name="query.join_columns",
                           max_weight=32 << 20, breaker="fielddata")
    out = cache.get(field)
    if out is None:
        out = _JoinColumns(ctx, field)
        cache.put(field, out)
    return out


def _ord_col(seg, dseg, field: str, term=None):
    """``(ords, ord of term)`` of a single-valued hidden ordinal column:
    each doc's ordinal (its last value, as the reference's per-doc map
    keeps it; -1 where it has none) [n_pad] on the device, and the
    segment's ordinal of ``term`` (None where the segment lacks the
    column or the term)."""
    dv = seg.ordinal_dv.get(field)
    if dv is None:
        return None, None
    ords = dseg.ordinal[field]["max_ord"]
    return ords, (None if term is None else dv.term_to_ord.get(term))


def _host_run_scored(ctx, q, select):
    """Run an inner query over every segment of the context (one
    ``dense_prepass``, then ``run_full`` per segment) and read back once
    the rows ``select(seg, dseg, scores, matched)`` keeps: it returns
    ``(rows bool [n_docs], keys int32 [n_docs])`` on the device, or None
    for none of the segment's rows.  Returns ``(keys, scores)``: the kept
    rows' keys (int32) and float32 scores on the host, in (segment, doc)
    order.  The pre-pass the join queries inject via ScoredMaskPlan."""
    from opensearch_tpu_torch.search.executor import build_arrays

    plan, bind = compile_query(q, ctx, scored=True)
    needed = plan.arrays()
    items = []
    for seg in ctx.segments:
        dseg = seg.device(ctx.device)
        dims, ins = plan.prepare(bind, seg, dseg, ctx)
        A = build_arrays(dseg, needed, ctx.mapper,
                         live=ctx.live_mask(seg, dseg),
                         partial_ok=plan.skip_arrays(dims))
        items.append((seg, dseg, dims, ins, A))
    P.dense_prepass(plan, [(A, dims, ins) for _s, _d, dims, ins, A in items])
    rows, keys, scores = [], [], []
    for seg, dseg, dims, ins, A in items:
        sc, matched = P.run_full(plan, dims, A, ins, -np.inf)
        picked = select(seg, dseg, sc, matched)
        if picked is not None:
            rows.append(picked[0])
            keys.append(picked[1])
            scores.append(sc[: seg.n_docs])
    if not rows:
        return np.zeros(0, np.int32), np.zeros(0, np.float32)
    sel = torch.nonzero(torch.cat(rows)).squeeze(1)
    kept = torch.cat([torch.cat(keys)[sel],
                      torch.cat(scores)[sel].view(torch.int32)])
    host = kept.cpu().numpy()
    n = len(host) // 2
    return host[:n], host[n:].view(np.float32)


def _join_mask_plan(ctx, fn, label):
    return P.ScoredMaskPlan(label=label), {"fn": fn}


def _c_has_child(q, ctx, scored):
    field, jft = _find_join_field(ctx)
    if field is None:
        return _none()
    parent_rel = jft.parent_of(q.type)
    if parent_rel is None:
        raise IllegalArgumentError(
            f"[has_child] join field [{field}] has no child relation "
            f"[{q.type}]")
    state: dict = {}

    def select(seg, dseg, scores, matched):
        names, child_ord = _ord_col(seg, dseg, field + "#name", q.type)
        parents, _o = _ord_col(seg, dseg, field + "#parent")
        if child_ord is None or parents is None:
            return None
        cols = _join_columns(ctx, field)
        n = seg.n_docs
        rows = (matched[:n] & (names[:n] == child_ord)
                & (parents[:n] >= 0))
        return rows, cols.parent_u[id(seg)][parents[:n].clamp(min=0).long()]

    def compute():
        u, s = _host_run_scored(ctx, q.query, select)
        n_u = _join_columns(ctx, field).n_u
        s64 = s.astype(np.float64)
        count = np.bincount(u, minlength=n_u)
        ok = count >= max(q.min_children, 1)
        if q.max_children is not None:
            ok &= count <= q.max_children
        mode = q.score_mode
        if mode in ("sum", "avg"):
            # float64 sums of float32 scores added in (segment, doc)
            # order (bincount adds its weights in input order)
            score = np.bincount(u, weights=s64, minlength=n_u)
            if mode == "avg":
                with np.errstate(divide="ignore", invalid="ignore"):
                    score = score / count
        elif mode in ("max", "min"):
            score = np.full(n_u, -np.inf if mode == "max" else np.inf)
            (np.maximum if mode == "max" else np.minimum).at(score, u, s64)
        else:
            score = np.ones(n_u)
        # q.boost * s in float64, rounded to float32 once
        table = np.where(ok, q.boost * score, 0.0).astype(np.float32)
        state["ok"] = torch.from_numpy(ok).to(ctx.device)
        state["table"] = torch.from_numpy(table).to(ctx.device)

    def fn(seg, dseg):
        if "table" not in state:
            compute()
        names, parent_ord = _ord_col(seg, dseg, field + "#name",
                                     parent_rel)
        if parent_ord is None or not len(state["table"]):
            return _empty_cols(dseg)
        own = _join_columns(ctx, field).self_u[id(seg)]
        at = own.clamp(min=0).long()
        # the searcher's point-in-time live bitmap in the join masks: the
        # reference reads the segment's current one (ROADMAP Queue C)
        mk = ((own >= 0) & state["ok"][at] & (names == parent_ord)
              & ctx.live_mask(seg, dseg))
        return torch.where(mk, state["table"][at], 0.0), mk

    return _join_mask_plan(ctx, fn, "has_child")


def _empty_cols(dseg):
    return (torch.zeros(dseg.n_pad, dtype=torch.float32, device=dseg.device),
            torch.zeros(dseg.n_pad, dtype=torch.bool, device=dseg.device))


def _c_has_parent(q, ctx, scored):
    field, jft = _find_join_field(ctx)
    if field is None:
        return _none()
    if q.parent_type not in jft.relations:
        raise IllegalArgumentError(
            f"[has_parent] join field [{field}] has no parent relation "
            f"[{q.parent_type}]")
    state: dict = {}

    def select(seg, dseg, scores, matched):
        names, parent_ord = _ord_col(seg, dseg, field + "#name",
                                     q.parent_type)
        if parent_ord is None:
            return None
        own = _join_columns(ctx, field).self_u[id(seg)]
        n = seg.n_docs
        return matched[:n] & (names[:n] == parent_ord) & (own[:n] >= 0), \
            own[:n]

    def compute():
        u, s = _host_run_scored(ctx, q.query, select)
        n_u = _join_columns(ctx, field).n_u
        # a parent _id met twice keeps its last score in (segment, doc)
        # order
        last = np.full(n_u, -1, np.int64)
        np.maximum.at(last, u, np.arange(len(u)))
        has = last >= 0
        score = np.zeros(n_u)
        score[has] = s[last[has]].astype(np.float64) if q.score else 1.0
        table = np.where(has, q.boost * score, 0.0).astype(np.float32)
        state["has"] = torch.from_numpy(has).to(ctx.device)
        state["table"] = torch.from_numpy(table).to(ctx.device)

    def fn(seg, dseg):
        if "table" not in state:
            compute()
        parents, _o = _ord_col(seg, dseg, field + "#parent")
        if parents is None or not len(state["table"]):
            return _empty_cols(dseg)
        table = _join_columns(ctx, field).parent_u[id(seg)]
        at = table[parents.clamp(min=0).long()].long()
        mk = (parents >= 0) & state["has"][at] & ctx.live_mask(seg, dseg)
        return torch.where(mk, state["table"][at], 0.0), mk

    return _join_mask_plan(ctx, fn, "has_parent")


def _c_parent_id(q, ctx, scored):
    field, jft = _find_join_field(ctx)
    if field is None:
        return _none()
    if jft.parent_of(q.type) is None:
        raise IllegalArgumentError(
            f"[parent_id] join field [{field}] has no child relation "
            f"[{q.type}]")

    def fn(seg, dseg):
        names, type_ord = _ord_col(seg, dseg, field + "#name", q.type)
        parents, id_ord = _ord_col(seg, dseg, field + "#parent", q.id)
        if type_ord is None or id_ord is None:
            return _empty_cols(dseg)
        mk = ((parents == id_ord) & (names == type_ord)
              & ctx.live_mask(seg, dseg))
        return P._const(mk, P._f32(q.boost))

    return _join_mask_plan(ctx, fn, "parent_id")


_MAX_CODEPOINT = chr(0x10FFFF)


def _c_prefix(q, ctx, scored):
    ft = _require_ft(ctx, q.field, "prefix")
    if ft is None:
        return _none()
    value = str(q.value)
    return (P.TermRangeMaskPlan(field=q.field),
            {"lo": value, "hi": value + _MAX_CODEPOINT, "boost": q.boost})


def _c_wildcard(q, ctx, scored):
    ft = _require_ft(ctx, q.field, "wildcard")
    if ft is None:
        return _none()
    return _expand_terms(q.field, "wildcard", {
        "pattern": str(q.value), "fuzzy_dist": 0, "prefix_length": 0,
        "nocase": bool(getattr(q, "case_insensitive", False)),
        "boost": q.boost}, ctx)


def _c_regexp(q, ctx, scored):
    ft = _require_ft(ctx, q.field, "regexp")
    if ft is None:
        return _none()
    return _expand_terms(q.field, "regexp", {
        "pattern": str(q.value), "fuzzy_dist": 0, "prefix_length": 0,
        "boost": q.boost}, ctx)


def _c_fuzzy(q, ctx, scored):
    ft = _require_ft(ctx, q.field, "fuzzy")
    if ft is None:
        return _none()
    return _expand_terms(q.field, "fuzzy", {
        "pattern": str(q.value),
        "fuzzy_dist": _auto_fuzzy(q.fuzziness, str(q.value)),
        "prefix_length": q.prefix_length, "boost": q.boost}, ctx)


def _expand_terms(field, mode, bind, ctx):
    """A multi-term query's ``ExpandTermsPlan`` and its bind, the terms
    that match found now over every segment's dictionary (a request's
    own walk: no verdict outlives it)."""
    plan = P.ExpandTermsPlan(field=field, mode=mode)
    return plan, {**bind, "terms": plan.expand(bind, ctx)}


def _c_constant_score(q, ctx, scored):
    child_plan, child_bind = compile_query(q.query, ctx, scored=False)
    return (P.ConstScorePlan(child=child_plan),
            {"boost": q.boost, "child": child_bind})


def _c_match_phrase(q, ctx, scored):
    ft = _require_ft(ctx, q.field, "match_phrase")
    if ft is None:
        return _none()
    if not isinstance(ft, TextFieldType):
        return _c_term(dsl.TermQuery(field=q.field, value=q.query,
                                     boost=q.boost), ctx, scored)
    analyzer = ctx.mapper.analyzers.get(ft.search_analyzer_name)
    toks = analyzer.analyze(str(q.query))
    if not toks:
        return _none()
    if len(toks) == 1:
        return _term_bag(ctx, q.field, [toks[0].term], 1, q.boost, scored)
    if q.slop:
        raise IllegalArgumentError(
            "match_phrase slop > 0 is not supported yet")
    return _phrase_from_tokens(ctx, q.field, [t.term for t in toks],
                               [t.position for t in toks], q.boost, scored)


def _c_multi_match(q, ctx, scored):
    if q.type == "bool_prefix":
        # dis-max of per-field match_bool_prefix
        # (MultiMatchQueryBuilder.Type.BOOL_PREFIX)
        plans, binds = [], []
        for field, fboost in q.fields:
            if ctx.field_type(field) is None:
                continue
            p, b = _c_match_bool_prefix(dsl.MatchBoolPrefixQuery(
                field=field, query=q.query, operator=q.operator,
                analyzer=getattr(q, "analyzer", None),
                minimum_should_match=q.minimum_should_match,
                fuzziness=getattr(q, "fuzziness", None),
                boost=q.boost * fboost), ctx, scored)
            if not isinstance(p, P.MatchNonePlan):
                plans.append(p)
                binds.append(b)
        return _dis_max_of(plans, binds, 1.0, q.tie_breaker)
    if q.type not in ("best_fields", "most_fields", "phrase"):
        raise IllegalArgumentError(
            f"multi_match type [{q.type}] is not supported")
    # "*" expands to every text field
    fields = []
    for field, fboost in q.fields:
        if field == "*":
            fields.extend((f, fboost) for f in ctx.text_fields())
        else:
            fields.append((field, fboost))
    children, binds = [], []
    for field, fboost in fields:
        if ctx.field_type(field) is None:
            continue
        if q.type == "phrase":
            sub = dsl.MatchPhraseQuery(field=field, query=q.query,
                                       boost=q.boost * fboost)
            p, b = _c_match_phrase(sub, ctx, scored)
        else:
            sub = dsl.MatchQuery(field=field, query=q.query,
                                 operator=q.operator,
                                 minimum_should_match=q.minimum_should_match,
                                 lenient=getattr(q, "lenient", False),
                                 analyzer=getattr(q, "analyzer", None),
                                 boost=q.boost * fboost)
            p, b = _c_match(sub, ctx, scored)
        if not isinstance(p, P.MatchNonePlan):
            children.append(p)
            binds.append(b)
    return _dis_max_of(children, binds, 1.0, q.tie_breaker)


def _dis_max_of(plans, binds, boost, tie_breaker):
    """match_none for no child, the child alone for one, else their
    dis_max."""
    if not plans:
        return _none()
    if len(plans) == 1:
        return plans[0], binds[0]
    return (P.DisMaxPlan(children=tuple(plans)),
            {"boost": boost, "tie_breaker": tie_breaker,
             "children": tuple(binds)})


def _c_dis_max(q, ctx, scored):
    plans, binds = [], []
    for sub in q.queries:
        p, b = compile_query(sub, ctx, scored)
        plans.append(p)
        binds.append(b)
    if not plans:
        return _none()
    return (P.DisMaxPlan(children=tuple(plans)),
            {"boost": q.boost, "tie_breaker": q.tie_breaker,
             "children": tuple(binds)})


_SQS_TOKEN = re.compile(r'([+-]?)"([^"]*)"|([+-]?)(\S+)')


def _c_simple_query_string(q, ctx, scored):
    fields = q.fields
    if not fields or fields == [("*", 1.0)]:
        fields = [(f, 1.0) for f in ctx.text_fields()]
    sub_queries = []
    for m in _SQS_TOKEN.finditer(q.query.strip()):
        if m.group(2) is not None:       # quoted -> phrase operator
            sign, text, is_phrase = m.group(1), m.group(2), True
        else:
            sign, text, is_phrase = m.group(3), m.group(4), False
            text = text.lstrip("+-")
        if not text.strip():
            continue
        mm = dsl.MultiMatchQuery(fields=fields, query=text,
                                 type="phrase" if is_phrase else "best_fields")
        sub_queries.append((sign == "-", mm))
    if not sub_queries:
        return P.MatchAllPlan(), {"boost": q.boost}
    must, must_not, should = [], [], []
    for negate, mm in sub_queries:
        if negate:
            must_not.append(mm)
        elif q.default_operator == "and":
            must.append(mm)
        else:
            should.append(mm)
    return _c_bool(dsl.BoolQuery(must=must, must_not=must_not, should=should,
                                 boost=q.boost), ctx, scored)


def _expand_prefix_terms(ctx, field, prefix: str, max_expansions: int):
    """Terms with ``prefix`` across all segments (sorted dictionaries =
    binary-searched range per segment), capped like MultiTermQuery's
    max_expansions."""
    out: list[str] = []
    seen: set = set()
    for seg in ctx.segments:
        pf = seg.postings.get(field)
        if pf is None:
            continue
        sterms = ctx.sorted_terms(seg, field)
        lo = bisect.bisect_left(sterms, prefix)
        for i in range(lo, len(sterms)):
            t = sterms[i]
            if not t.startswith(prefix):
                break
            if t not in seen:
                seen.add(t)
                out.append(t)
            if len(out) >= max_expansions:
                return out
    return out


def _phrase_from_tokens(ctx, field, terms, positions, boost, scored):
    """PhrasePlan bind straight from (term, position) tokens — keeps the
    analyzer's position gaps (stopword holes) intact."""
    if len(terms) == 1:
        return _term_bag(ctx, field, [terms[0]], 1, boost, scored)
    stats = ctx.field_stats(field)
    idf_sum = float(np.sum(_idfs_for(ctx, field, terms)))
    bind = {"terms": tuple(terms), "positions": tuple(positions),
            "idf_sum": idf_sum, "boost": boost, "avgdl": stats.avgdl}
    return P.PhrasePlan(field=field, scored=scored), bind


def _c_match_phrase_prefix(q, ctx, scored):
    """Phrase whose LAST token is a prefix: expand it against the term
    dictionary and dis-max the resulting phrases, substituting the last
    term IN PLACE so original token positions (incl. stopword gaps)
    survive (MatchPhrasePrefixQueryBuilder -> MultiPhrasePrefixQuery)."""
    ft = _require_ft(ctx, q.field, "match_phrase_prefix")
    if ft is None:
        return _none()
    if not isinstance(ft, TextFieldType):
        return _c_term(dsl.TermQuery(field=q.field, value=q.query,
                                     boost=q.boost), ctx, scored)
    analyzer = ctx.mapper.analyzers.get(ft.search_analyzer_name)
    toks = analyzer.analyze(str(q.query))
    if not toks:
        return _none()
    if q.slop:
        raise IllegalArgumentError(
            "match_phrase_prefix slop > 0 is not supported yet")
    terms = [t.term for t in toks]
    positions = [t.position for t in toks]
    expansions = _expand_prefix_terms(ctx, q.field, terms[-1],
                                      int(q.max_expansions))
    plans, binds = [], []
    for t in expansions:
        p, b = _phrase_from_tokens(ctx, q.field, terms[:-1] + [t],
                                   positions, q.boost, scored)
        plans.append(p)
        binds.append(b)
    return _dis_max_of(plans, binds, 1.0, 0.0)


def _c_match_bool_prefix(q, ctx, scored):
    """Every token a term clause, the last a prefix clause, combined as
    a bool (MatchBoolPrefixQueryBuilder).  With ``fuzziness`` the term
    clauses are ``fuzzy`` queries."""
    ft = _require_ft(ctx, q.field, "match_bool_prefix")
    if ft is None:
        return _none()
    if not isinstance(ft, TextFieldType):
        return _c_term(dsl.TermQuery(field=q.field, value=q.query,
                                     boost=q.boost), ctx, scored)
    analyzer_name = getattr(q, "analyzer", None)
    if analyzer_name:
        terms = ctx.mapper.analyzers.get(analyzer_name).terms(
            str(q.query))
    else:
        terms = ft.search_terms(str(q.query), ctx.mapper.analyzers)
    if not terms:
        return _none()
    fuzz = getattr(q, "fuzziness", None)
    if fuzz is not None:
        clauses = [dsl.FuzzyQuery(field=q.field, value=t,
                                  fuzziness=fuzz) for t in terms[:-1]]
    else:
        clauses = [dsl.TermQuery(field=q.field, value=t)
                   for t in terms[:-1]]
    expansions = _expand_prefix_terms(ctx, q.field, terms[-1],
                                      int(q.max_expansions))
    if expansions:
        # capped dictionary expansion, like the phrase-prefix sibling
        clauses.append(dsl.TermsQuery(field=q.field, values=expansions)
                       if len(expansions) > 1
                       else dsl.TermQuery(field=q.field,
                                          value=expansions[0]))
    elif not clauses:
        return _none()
    # an unexpandable prefix contributes nothing; other clauses still
    # match under OR semantics
    if q.operator == "and":
        return compile_query(dsl.BoolQuery(must=clauses, boost=q.boost),
                             ctx, scored)
    msm = getattr(q, "minimum_should_match", None) or "1"
    return compile_query(dsl.BoolQuery(should=clauses,
                                       minimum_should_match=str(msm),
                                       boost=q.boost), ctx, scored)


# span end disabled: any analyzer position is < this (< ops.phrase
# POS_BASE, the reference's key base)
_SPAN_NO_END = 1 << 21


def _span_near_state(ctx, field, terms, *, slop, ordered, end, boost,
                     scored):
    stats = ctx.field_stats(field)
    idf_sum = float(np.sum(_idfs_for(ctx, field, terms)))
    bind = {"terms": tuple(terms), "slop": int(slop), "end": int(end),
            "idf_sum": idf_sum, "boost": boost, "avgdl": stats.avgdl}
    return P.SpanNearPlan(field=field, ordered=ordered,
                          scored=scored), bind


def _c_span_term(q, ctx, scored):
    ft = _require_ft(ctx, q.field, "span_term")
    if ft is None:
        return _none()
    return _term_bag(ctx, q.field, [str(q.value)], 1, q.boost, scored)


def _span_clause_terms(clauses, qname):
    """Validate span sub-clauses: span_term only, one shared field."""
    field, terms = None, []
    for c in clauses:
        if not isinstance(c, dsl.SpanTermQuery):
            raise IllegalArgumentError(
                f"[{qname}] supports span_term clauses only, got "
                f"[{type(c).__name__}]")
        if field is None:
            field = c.field
        elif c.field != field:
            raise IllegalArgumentError(
                f"[{qname}] clauses must target a single field, got "
                f"[{field}] and [{c.field}]")
        terms.append(str(c.value))
    return field, terms


def _c_span_near(q, ctx, scored):
    field, terms = _span_clause_terms(q.clauses, "span_near")
    ft = _require_ft(ctx, field, "span_near")
    if ft is None:
        return _none()
    if len(terms) == 1:
        return _term_bag(ctx, field, terms, 1, q.boost, scored)
    if not q.in_order and len(terms) > 2:
        raise IllegalArgumentError(
            "[span_near] with [in_order]=false supports at most 2 "
            "clauses (unordered minimal-window matching beyond pairs "
            "is not implemented)")
    return _span_near_state(ctx, field, terms, slop=q.slop,
                            ordered=q.in_order, end=_SPAN_NO_END,
                            boost=q.boost, scored=scored)


def _c_span_first(q, ctx, scored):
    # restricted to a span_term match so 'span ends before [end]'
    # is exact (a single term at pos occupies [pos, pos+1))
    if not isinstance(q.match, dsl.SpanTermQuery):
        raise IllegalArgumentError(
            "[span_first] supports a span_term [match] only")
    ft = _require_ft(ctx, q.match.field, "span_first")
    if ft is None:
        return _none()
    return _span_near_state(ctx, q.match.field, [str(q.match.value)],
                            slop=0, ordered=True, end=q.end,
                            boost=q.boost, scored=scored)


def _c_span_or(q, ctx, scored):
    _span_clause_terms(q.clauses, "span_or")   # validation only
    return compile_query(
        dsl.BoolQuery(should=list(q.clauses), minimum_should_match="1",
                      boost=q.boost), ctx, scored)


_INTERVAL_OPTIONS = {"match": {"query", "ordered", "max_gaps", "mode"},
                     "any_of": {"intervals"},
                     "all_of": {"intervals", "ordered", "max_gaps", "mode"}}


def _c_intervals(q, ctx, scored):
    """intervals: match / any_of / all_of rules (ref
    IntervalQueryBuilder.java:43).  match compiles to the span plan;
    any_of is a should-of-1; all_of with unbounded gaps and no order is
    positionless AND, otherwise its sub-rules must be single terms so it
    flattens to one ordered/unordered near; prefix / wildcard / regexp
    rules expand against the term dictionary."""
    ft = _require_ft(ctx, q.field, "intervals")
    if ft is None:
        return _none()

    def rule_terms(rule):
        m = rule.get("match")
        if m is None or not isinstance(m, dict):
            return None
        analyzer = ctx.mapper.analyzers.get(ft.search_analyzer_name)
        return [t.term for t in analyzer.analyze(str(m.get("query", "")))]

    def near(terms, ordered, max_gaps, what, items):
        if not ordered and len(terms) > 2:
            raise IllegalArgumentError(
                f"[intervals] unordered [{what}] with [max_gaps] "
                f"supports at most 2 {items}")
        slop = max_gaps if max_gaps >= 0 else _SPAN_NO_END
        return _span_near_state(ctx, q.field, terms, slop=slop,
                                ordered=ordered, end=_SPAN_NO_END,
                                boost=q.boost, scored=scored)

    def compile_rule(rule):
        if len(rule) != 1:
            raise IllegalArgumentError(
                f"[intervals] rule must have exactly one key, got "
                f"{sorted(rule)}")
        kind, body = next(iter(rule.items()))
        if kind in _INTERVAL_OPTIONS and isinstance(body, dict):
            extra = set(body) - _INTERVAL_OPTIONS[kind]
            if extra:
                # silently dropping filter/analyzer/use_field/... would
                # return over-broad results
                raise IllegalArgumentError(
                    f"[intervals] [{kind}] options {sorted(extra)} are "
                    f"not supported — supported: "
                    f"{sorted(_INTERVAL_OPTIONS[kind])}")
        if kind == "match":
            terms = rule_terms(rule)
            if not terms:
                return _none()
            mode = body.get("mode")
            ordered = (mode == "ordered" if mode is not None
                       else bool(body.get("ordered", False)))
            max_gaps = int(body.get("max_gaps", -1))
            if len(terms) == 1:
                return _term_bag(ctx, q.field, terms, 1, q.boost, scored)
            if max_gaps < 0 and not ordered:
                return compile_query(dsl.BoolQuery(must=[
                    dsl.TermQuery(field=q.field, value=t)
                    for t in terms]), ctx, scored)
            return near(terms, ordered, max_gaps, "match", "terms")
        if kind in ("any_of", "all_of"):
            subs = body.get("intervals") or []
            if not subs:
                raise IllegalArgumentError(
                    f"[intervals] [{kind}] requires [intervals]")
            if body.get("mode") is not None:
                body = {**body, "ordered": body["mode"] == "ordered"}
            if kind == "all_of" and (body.get("ordered")
                                     or int(body.get("max_gaps", -1)) >= 0):
                # positional all_of flattens iff every sub-rule is a
                # single-term match
                flat = [rule_terms(s) for s in subs]
                if any(t is None or len(t) != 1 for t in flat):
                    raise IllegalArgumentError(
                        "[intervals] [all_of] with [ordered]/[max_gaps] "
                        "supports single-term [match] sub-rules only")
                return near([t[0] for t in flat],
                            bool(body.get("ordered", False)),
                            int(body.get("max_gaps", -1)), "all_of",
                            "sub-rules")
            wrapped = [dsl.IntervalsQuery(field=q.field, rule=s)
                       for s in subs]
            if kind == "any_of":
                return compile_query(
                    dsl.BoolQuery(should=wrapped,
                                  minimum_should_match="1",
                                  boost=q.boost), ctx, scored)
            return compile_query(dsl.BoolQuery(must=wrapped,
                                               boost=q.boost),
                                 ctx, scored)
        if kind in ("prefix", "wildcard", "regexp"):
            # multi-term rules expand against the term dictionary and
            # compile as a should-of-1 over the expansions (the
            # reference has no fuzzy interval source, so `fuzzy` is
            # rejected below rather than silently over-matching)
            terms = _interval_expansions(ctx, q.field, kind, body)
            if not terms:
                return _none()
            return compile_query(dsl.BoolQuery(
                should=[dsl.TermQuery(field=q.field, value=t)
                        for t in terms],
                minimum_should_match="1", boost=q.boost), ctx, scored)
        raise IllegalArgumentError(
            f"[intervals] unsupported rule [{kind}] — supported: "
            "match, any_of, all_of, prefix, wildcard, regexp")

    return compile_rule(q.rule)


def _interval_expansions(ctx, field, kind, body) -> list[str]:
    """The terms of a prefix / wildcard / regexp interval rule, at most
    128, in the reference's order."""
    import fnmatch

    if kind == "prefix":
        return _expand_prefix_terms(ctx, field, str(body.get("prefix", "")),
                                    128)
    pat = str(body.get("pattern", ""))
    flags = re.IGNORECASE if body.get("case_insensitive") else 0
    rx = re.compile(fnmatch.translate(pat) if kind == "wildcard" else pat,
                    flags)
    terms, seen = [], set()
    for seg in ctx.segments:
        if field not in seg.postings:
            continue
        for t in ctx.sorted_terms(seg, field):
            if t not in seen and rx.fullmatch(t):
                seen.add(t)
                terms.append(t)
            if len(terms) >= 128:
                break
    return terms


def _c_knn(q, ctx, scored):
    """knn query: per-segment vector search -- exact (ops/knn.py: one K1
    launch per query on CUDA over every segment, each segment's top-k
    inside the kernel) or ANN when the field mapping declares a
    ``method`` of ``ivf`` / ``ivf_pq`` (ops/ivf.py: the cluster-probed
    search over the segment's trained index, one K6 call over every
    segment on the flat route and one K7 call over every segment on the
    PQ route) -- with the global per-shard k winners injected into the
    plan tree as a ScoredMaskPlan.  Optional ``filter`` restricts
    candidates BEFORE the k cut (the plugin's filtered-knn semantics);
    ANN runs exact under a filter, as the reference does, and so does a
    segment without an index.  The host syncs once per query."""
    from opensearch_tpu_torch.ops.ivf import (IvfPqIndex, IvfSegment,
                                              ivf_search_segments_auto,
                                              ivfpq_search_segments_auto,
                                              k_offsets)
    from opensearch_tpu_torch.ops.knn import KnnSegment, knn_topk_segments_auto
    from opensearch_tpu_torch.search.executor import build_arrays

    ft = ctx.field_type(q.field)
    if ft is None:
        return _none()
    if ft.dv_kind != "vector":
        raise IllegalArgumentError(
            f"[knn] query requires a knn_vector/dense_vector field, "
            f"[{q.field}] is [{ft.type_name}]")
    qvec = np.asarray(q.vector, np.float32)
    if qvec.shape != (ft.dims,):
        raise IllegalArgumentError(
            f"query vector has dimension {qvec.shape[0]} but field "
            f"[{q.field}] expects {ft.dims}")
    space = {"l2": "l2", "cosinesimil": "cosinesimil",
             "innerproduct": "innerproduct"}.get(ft.space_type, "l2")
    method = dict(getattr(ft, "method", None) or {})
    # method_parameters is a SEARCH-TIME knob: only nprobe may be
    # overridden per request (nlist and m define the trained structure)
    if q.method_parameters and "nprobe" in q.method_parameters:
        method["nprobe"] = int(q.method_parameters["nprobe"])
    use_ann = method.get("name") in ("ivf", "ivf_pq") and q.filter is None

    filter_state = None
    if q.filter is not None:
        filter_state = compile_query(q.filter, ctx, scored=False)

    qvec_t = torch.from_numpy(qvec).to(ctx.device)
    # phase 1: every segment's inputs (the filter's masks are launched
    # here: each term-bag leaf of the filter once over every segment with
    # the field), then one launch per route over its segments.  The
    # inputs keep every tensor the launches read referenced until the
    # host sync below.
    inputs, orders, filter_items = [], [], []
    routes = {"flat": ([], []), "pq": ([], [])}   # (IvfSegments, orders)
    for seg_order, seg in enumerate(ctx.segments):
        dseg = seg.device(ctx.device)
        vcol = dseg.vector.get(q.field)
        if vcol is None:
            continue
        live = ctx.live_mask(seg, dseg)
        ann = seg.ann_index(q.field, method, ctx.device) if use_ann else None
        if ann is not None:
            nprobe = min(int(method.get("nprobe", 0))
                         or max(1, ann.nlist // 8), ann.nlist)
            # the probed candidate pool is nprobe * c_pad rows
            kk = min(q.k, dseg.n_pad, nprobe * ann.c_pad)
            route = "pq" if isinstance(ann, IvfPqIndex) and space == "l2" \
                else "flat"
            if route == "flat" and isinstance(ann, IvfPqIndex):
                # ADC tables are l2-residual based: in another space an
                # ivf_pq field probes the flat layout
                ann = seg.ann_index(q.field, {**method, "name": "ivf"},
                                    ctx.device)
            routes[route][0].append(IvfSegment(dseg.ann_staged(ann), live,
                                               nprobe, kk))
            routes[route][1].append(seg_order)
            continue
        if filter_state is not None:
            fplan, fbind = filter_state
            A = build_arrays(dseg, fplan.arrays(), ctx.mapper)
            dims, ins = fplan.prepare(fbind, seg, dseg, ctx)
            filter_items.append((A, dims, ins))
        inputs.append(KnnSegment(vcol["values"], vcol["exists"], live))
        orders.append(seg_order)
    if filter_state is not None:
        fplan = filter_state[0]
        P.dense_prepass(fplan, filter_items)
        inputs = [s._replace(mask=P.run_full(fplan, dims, A, ins,
                                             -np.inf)[1])
                  for s, (A, dims, ins) in zip(inputs, filter_items)]
    # (vals [S, k], ids [S, k], the segment order of each row's columns)
    results = []
    if inputs:
        vals, idx = knn_topk_segments_auto(inputs, qvec_t, space=space,
                                           k=q.k)
        results.append((vals, idx, [(o, i * q.k, (i + 1) * q.k)
                                    for i, o in enumerate(orders)]))
    queries = qvec_t[None, :]
    for route, (segs, seg_orders) in routes.items():
        if not segs:
            continue
        vals, idx = (ivf_search_segments_auto(segs, queries, space=space)
                     if route == "flat"
                     else ivfpq_search_segments_auto(segs, queries))
        offs = k_offsets(segs)
        results.append((vals, idx, list(zip(seg_orders, offs[:-1],
                                            offs[1:]))))
    candidates = []          # (score, seg_order, local)
    if results:
        # phase 2: one copy to the host for every route's top-k
        flat = torch.cat([t.reshape(-1).view(torch.int32)
                          for vals, idx, _ in results for t in (vals, idx)])
        host = flat.cpu().numpy()
        at = 0
        for vals, _idx, spans in results:
            n = vals.numel()
            v = host[at: at + n].view(np.float32)
            i = host[at + n: at + 2 * n]
            at += 2 * n
            for seg_order, a, b in spans:
                keep = (v[a:b] > -np.inf) & (i[a:b] >= 0)
                for score, local in zip(v[a:b][keep], i[a:b][keep]):
                    candidates.append((float(score), seg_order, int(local)))
    candidates.sort(key=lambda t: (-t[0], t[1], t[2]))
    winners: dict[int, list[tuple[int, float]]] = {}
    for score, seg_order, local in candidates[: q.k]:
        winners.setdefault(seg_order, []).append((local, score * q.boost))
    return _winners_plan(ctx, winners, "knn")


def _c_script_score(q, ctx, scored):
    """script_score: the child query's matched set rescored by a compiled
    score script (search/scripting.py); BASELINE config #2's
    knn-via-script shape.  A request-wide pre-pass, as ``_c_knn``'s,
    computes each distinct (vector function, field, query vector) of the
    script over every segment that has the field at once (one K1 scores
    launch each on CUDA, ``ops/knn.py`` ``vector_scores_segments_auto``);
    ``ScriptScorePlan.prepare`` hands each segment its view.  Unknown or
    unsupported scripts raise ScriptException -> a clean 400."""
    from opensearch_tpu_torch.search.scripting import (ScriptException,
                                                       compile_score_script)

    program = compile_score_script(q.script)
    for f in program.numeric_fields:
        ft = ctx.field_type(f)
        if ft is not None and ft.dv_kind not in ("long", "double"):
            raise ScriptException(
                f"doc['{f}'].value requires a numeric/date field, "
                f"[{f}] is [{ft.type_name}]")
    for f in program.vector_fields:
        ft = ctx.field_type(f)
        if ft is not None and ft.dv_kind != "vector":
            raise ScriptException(
                f"vector function over [{f}] requires a knn_vector "
                f"field, got [{ft.type_name}]")
    child = q.query if q.query is not None else dsl.MatchAllQuery()
    cplan, cbind = compile_query(child, ctx, scored=program.uses_score)
    calls, node_keys = program.vector_calls()
    return (P.ScriptScorePlan(child=cplan, program=program),
            {"child": cbind, "boost": q.boost, "min_score": q.min_score,
             "params": program.param_values(ctx.device),
             "vectors": _script_vector_columns(calls, ctx),
             "node_keys": node_keys})


def _script_vector_columns(calls, ctx, missing_zero: bool = False) -> dict:
    """{key: {id(segment): f32 [n_pad]}}: each distinct vector function
    of a script (``ScriptProgram.vector_calls``) over every row of every
    segment that has its field, in one call (one K1 launch on CUDA); with
    ``missing_zero`` a segment without the field takes part with zero
    rows, as the reference's function_score reads its empty column."""
    from opensearch_tpu_torch.ops.knn import (KnnSegment,
                                              vector_scores_segments_auto)
    from opensearch_tpu_torch.search.scripting import ScriptException

    out = {}
    for key, (fn, field, qvec) in calls.items():
        segs, ids = [], []
        for seg in ctx.segments:
            dseg = seg.device(ctx.device)
            vcol = dseg.vector.get(field)
            if vcol is None:
                if not missing_zero:
                    continue
                vcol = {"values": torch.zeros(
                    (dseg.n_pad, qvec.shape[0]), dtype=torch.float32,
                    device=ctx.device)}
            if vcol["values"].shape[1] != qvec.shape[0]:
                raise ScriptException(
                    f"[{fn}] query vector has dimension {qvec.shape[0]} "
                    f"but field [{field}] has {vcol['values'].shape[1]}")
            segs.append(KnnSegment(vcol["values"], None))
            ids.append(id(seg))
        cols = vector_scores_segments_auto(
            segs, torch.from_numpy(qvec.copy()).to(ctx.device),
            fn=fn) if segs else []
        out[key] = dict(zip(ids, cols))
    return out


def _c_boosting(q, ctx, scored):
    pos_p, pos_b = compile_query(q.positive, ctx, scored)
    neg_p, neg_b = compile_query(q.negative, ctx, scored=False)
    return (P.BoostingPlan(positive=pos_p, negative=neg_p),
            {"boost": q.boost, "negative_boost": q.negative_boost,
             "children": (pos_b, neg_b)})


def _c_terms_set(q, ctx, scored):
    ft = _require_ft(ctx, q.field, "terms_set")
    if ft is None:
        return _none()
    msm_ft = ctx.field_type(q.minimum_should_match_field)
    if msm_ft is None or msm_ft.dv_kind not in ("long", "double"):
        raise IllegalArgumentError(
            f"[terms_set] minimum_should_match_field "
            f"[{q.minimum_should_match_field}] must be a numeric field")
    terms = [ft.term_for_query(t) for t in q.terms]
    if not terms:
        return _none()
    return (P.TermsSetPlan(field=q.field,
                           msm_field=q.minimum_should_match_field,
                           scored=scored),
            {"terms": tuple(terms),
             "idfs": _idfs_for(ctx, q.field, terms),
             "weights": np.full(len(terms), q.boost, np.float32),
             "avgdl": ctx.field_stats(q.field).avgdl})


def _duration_ms(v) -> float:
    """A date field's distance: a duration string ("7d", "12h"), or
    milliseconds."""
    from opensearch_tpu_torch.search.aggs import _parse_duration_ms

    return float(_parse_duration_ms(v) if isinstance(v, str) else v)


def _c_distance_feature(q, ctx, scored):
    ft = _require_ft(ctx, q.field, "distance_feature")
    if ft is None:
        return _none()
    if ft.dv_kind == "geo_point":
        origin = dsl.parse_geo_point(q.origin)
        pivot = dsl.parse_distance_m(q.pivot)
        kind = "geo"
    elif ft.type_name in ("date", "date_nanos"):
        origin = float(parse_date_millis(q.origin))
        pivot = _duration_ms(q.pivot)
        kind = "numeric"
    elif ft.dv_kind in ("long", "double"):
        origin = float(q.origin)
        pivot = float(q.pivot)
        kind = "numeric"
    else:
        raise IllegalArgumentError(
            f"[distance_feature] field [{q.field}] must be date, numeric "
            f"or geo_point, got [{ft.type_name}]")
    if pivot <= 0:
        raise IllegalArgumentError("[distance_feature] pivot must be > 0")
    return (P.DistanceFeaturePlan(field=q.field, kind=kind),
            {"origin": origin, "pivot": pivot, "boost": q.boost})


def _geo_ft(ctx, field, qname):
    """The geo_point field type of a geo filter, None when unmapped."""
    ft = _require_ft(ctx, field, qname)
    if ft is not None and ft.dv_kind != "geo_point":
        raise IllegalArgumentError(
            f"[{qname}] field [{field}] is not a geo_point")
    return ft


def _c_geo_distance(q, ctx, scored):
    if _geo_ft(ctx, q.field, "geo_distance") is None:
        return _none()
    return (P.GeoDistancePlan(field=q.field),
            {"lat": q.lat, "lon": q.lon,
             "distance_m": dsl.parse_distance_m(q.distance),
             "boost": q.boost})


def _c_geo_bounding_box(q, ctx, scored):
    if _geo_ft(ctx, q.field, "geo_bounding_box") is None:
        return _none()
    return (P.GeoBoxPlan(field=q.field),
            {"top": q.top, "left": q.left, "bottom": q.bottom,
             "right": q.right, "boost": q.boost})


def _c_geo_polygon(q, ctx, scored):
    if _geo_ft(ctx, q.field, "geo_polygon") is None:
        return _none()
    return (P.GeoPolygonPlan(field=q.field),
            {"lats": [p[0] for p in q.points],
             "lons": [p[1] for p in q.points], "boost": q.boost})


def _positive_float(v, what: str) -> float:
    try:
        f = float(v)
    except (TypeError, ValueError):
        raise ParsingError(
            f"[rank_feature] {what} must be a number, got [{v}]") from None
    if not math.isfinite(f) or f <= 0:
        raise ParsingError(
            f"[rank_feature] {what} must be positive, got [{v}]")
    return f


def _c_rank_feature(q, ctx, scored):
    """rank_feature lowered onto the script-score plan over ``exists``:
    the saturation / log / sigmoid curves are score scripts over
    ``doc['f'].value`` (RankFeatureQueryBuilder; the feature column is a
    positive numeric doc value).  The default saturation pivot is the
    mean positive value over the shard's segments."""
    ft = _require_ft(ctx, q.field, "rank_feature")
    if ft is None:
        return _none()
    if ft.dv_kind not in ("long", "double"):
        raise IllegalArgumentError(
            f"[rank_feature] field [{q.field}] must be numeric "
            f"(rank_feature type), got [{ft.type_name}]")
    f = f"doc['{q.field}'].value"
    if q.log is not None:
        scaling = float(q.log.get("scaling_factor", 1.0))
        src = f"Math.log({scaling} + {f})"
    elif q.sigmoid is not None:
        if "pivot" not in q.sigmoid or "exponent" not in q.sigmoid:
            raise ParsingError(
                "[rank_feature] sigmoid requires [pivot] and [exponent]")
        pivot = _positive_float(q.sigmoid["pivot"], "sigmoid pivot")
        exp = _positive_float(q.sigmoid["exponent"], "sigmoid exponent")
        src = (f"Math.pow({f}, {exp}) / "
               f"(Math.pow({f}, {exp}) + Math.pow({pivot}, {exp}))")
    else:
        pivot = (q.saturation or {}).get("pivot")
        if pivot is not None:
            pivot = _positive_float(pivot, "saturation pivot")
        if pivot is None:
            # the field's mean value over the shard (the reference's
            # stand-in for an approximate geometric mean)
            total, count = 0.0, 0
            for seg in ctx.segments:
                dv = seg.numeric_dv.get(q.field)
                if dv is not None and len(dv.values):
                    total += float(np.sum(dv.values))
                    count += int(len(dv.values))
            pivot = (total / count) if count else 1.0
        src = f"{f} / ({f} + {float(pivot)})"
    return compile_query(dsl.ScriptScoreQuery(
        query=dsl.ExistsQuery(field=q.field),
        script={"source": src}, boost=q.boost), ctx, scored)


_DECAY_FNS = ("gauss", "exp", "linear")


def _c_function_score(q, ctx, scored):
    """function_score: each function compiles to a static
    ``FunctionSpec`` and a bind of its parameters (functionscore/:
    weight, field_value_factor, random_score, script_score and the
    decays).  The vector functions of every script_score function are
    computed here for the whole request, as ``_c_script_score``'s: one
    K1 scores launch per distinct (function, field, query vector) over
    every segment."""
    from opensearch_tpu_torch.search.scripting import compile_score_script

    child = q.query if q.query is not None else dsl.MatchAllQuery()
    cplan, cbind = compile_query(child, ctx, scored=True)
    specs, binds = [], []
    calls = {}             # every script function's vector calls, by key
    for f in q.functions:
        f = dict(f)
        fbind = {}
        fplan = None
        if f.get("filter") is not None:
            fplan, fb = compile_query(dsl.parse_query(f["filter"]), ctx,
                                      scored=False)
            fbind["filter"] = fb
        if "weight" in f:
            fbind["weight"] = float(f["weight"])
        decay_fn = next((d for d in _DECAY_FNS if d in f), None)
        if "field_value_factor" in f:
            fvf = f["field_value_factor"]
            field = fvf.get("field")
            ft = ctx.field_type(field or "")
            if ft is None or ft.dv_kind not in ("long", "double"):
                raise IllegalArgumentError(
                    f"[field_value_factor] field [{field}] must be "
                    "numeric")
            specs.append(P.FunctionSpec(
                kind="field_value_factor", filter=fplan, field=field,
                modifier=str(fvf.get("modifier", "none")).lower()))
            fbind.update({"factor": float(fvf.get("factor", 1.0)),
                          "missing": float(fvf.get("missing", 1.0))})
        elif "random_score" in f:
            rs = f.get("random_score") or {}
            specs.append(P.FunctionSpec(kind="random_score",
                                        filter=fplan))
            fbind["seed"] = float(rs.get("seed", 0))
        elif "script_score" in f:
            program = compile_score_script(
                (f["script_score"] or {}).get("script") or {})
            specs.append(P.FunctionSpec(kind="script_score",
                                        filter=fplan, program=program))
            fn_calls, node_keys = program.vector_calls()
            calls.update(fn_calls)
            fbind.update({"params": program.param_values(ctx.device),
                          "node_keys": node_keys})
        elif decay_fn is not None:
            body = f[decay_fn]
            ((field, conf),) = tuple(body.items()) if len(body) == 1 \
                else (_raise_decay(),)
            ft = ctx.field_type(field)
            if ft is None:
                return _none()
            if ft.dv_kind == "geo_point":
                lat, lon = dsl.parse_geo_point(conf["origin"])
                fbind.update({"origin_lat": lat, "origin_lon": lon,
                              "scale": dsl.parse_distance_m(conf["scale"]),
                              "offset": dsl.parse_distance_m(
                                  conf.get("offset", 0))})
                geo = True
            elif ft.type_name == "date":
                fbind.update({
                    "origin": float(parse_date_millis(conf["origin"])),
                    "scale": _duration_ms(conf["scale"]),
                    "offset": _duration_ms(conf.get("offset", 0))})
                geo = False
            elif ft.dv_kind in ("long", "double"):
                fbind.update({"origin": float(conf["origin"]),
                              "scale": float(conf["scale"]),
                              "offset": float(conf.get("offset", 0))})
                geo = False
            else:
                raise IllegalArgumentError(
                    f"[{decay_fn}] field [{field}] must be numeric, "
                    "date or geo_point")
            if fbind["scale"] <= 0:
                raise IllegalArgumentError(
                    f"[{decay_fn}] scale must be > 0")
            fbind["decay"] = float(conf.get("decay", 0.5))
            if not (0.0 < fbind["decay"] < 1.0):
                raise IllegalArgumentError(
                    f"[{decay_fn}] decay must be in (0, 1)")
            specs.append(P.FunctionSpec(kind="decay", filter=fplan,
                                        field=field, decay_fn=decay_fn,
                                        geo=geo))
        elif "weight" in f:
            specs.append(P.FunctionSpec(kind="weight", filter=fplan))
        else:
            raise IllegalArgumentError(
                f"unknown function_score function {sorted(f)}")
        binds.append(fbind)
    if q.score_mode not in ("multiply", "sum", "avg", "first", "max",
                            "min"):
        raise IllegalArgumentError(
            f"unknown score_mode [{q.score_mode}]")
    if q.boost_mode not in ("multiply", "replace", "sum", "avg", "max",
                            "min"):
        raise IllegalArgumentError(
            f"unknown boost_mode [{q.boost_mode}]")
    vectors = _script_vector_columns(calls, ctx, missing_zero=True)
    for spec, fbind in zip(specs, binds):
        if spec.kind == "script_score":
            fbind["vectors"] = vectors
    return (P.FunctionScorePlan(child=cplan, functions=tuple(specs),
                                score_mode=q.score_mode,
                                boost_mode=q.boost_mode),
            {"child": cbind, "functions": tuple(binds), "boost": q.boost,
             "max_boost": q.max_boost, "min_score": q.min_score})


def _raise_decay():
    raise IllegalArgumentError(
        "decay function must name exactly one field")


def _c_more_like_this(q, ctx, scored):
    """more_like_this: the like texts' (and liked docs' sources') terms
    picked by tf-idf on the host, then one should term bag per field
    (K2's dense entry, or its top-k for a lone bag), the liked docs
    excluded unless ``include`` (MoreLikeThisQueryBuilder's
    interesting-terms selection)."""
    fields = q.fields
    if not fields:
        fields = [f for f, ft in ctx.mapper.field_types().items()
                  if isinstance(ft, TextFieldType)]
    if not fields:
        return _none()
    texts: list[str] = []
    liked_ids: list[str] = []
    for item in q.like:
        if isinstance(item, dict):
            doc_id = item.get("_id")
            src = None
            for seg in ctx.segments:
                local = seg.id_to_local.get(str(doc_id))
                if local is not None:
                    src = seg.source(local)
                    break
            if src is None:
                continue
            liked_ids.append(str(doc_id))
            for f in fields:
                v = src.get(f)
                if isinstance(v, str):
                    texts.append(v)
        else:
            texts.append(str(item))
    if not texts:
        return _none()
    clauses = []
    for field in fields:
        ft = ctx.field_type(field)
        if not isinstance(ft, TextFieldType):
            continue
        tf: dict[str, int] = {}
        for text in texts:
            for t in ft.search_terms(text, ctx.mapper.analyzers):
                tf[t] = tf.get(t, 0) + 1
        n_docs = max(ctx.field_stats(field).doc_count, 1)
        cands = []
        for t, freq in tf.items():
            if freq < q.min_term_freq:
                continue
            df = ctx.df(field, t)
            if df < q.min_doc_freq:
                continue
            idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
            cands.append((freq * idf, t))
        cands.sort(key=lambda x: (-x[0], x[1]))
        terms = [t for _s, t in cands[: q.max_query_terms]]
        if terms:
            required = max(1, calc_min_should_match(
                len(terms), q.minimum_should_match))
            clauses.append(_term_bag(ctx, field, terms, required,
                                     q.boost, scored))
    if not clauses:
        return _none()
    if len(clauses) == 1 and not liked_ids:
        return clauses[0]
    # the liked docs are EXCLUDED unless include: true (the reference's
    # default: a doc is trivially most like itself)
    must_not = ()
    if liked_ids and not q.include:
        must_not = (compile_query(dsl.IdsQuery(values=liked_ids), ctx,
                                  scored=False),)
    return (P.BoolPlan(should=tuple(p for p, _b in clauses),
                       must_not=tuple(p for p, _b in must_not)),
            {"boost": 1.0, "required": 1,
             "children": (tuple(b for _p, b in clauses)
                          + tuple(b for _p, b in must_not))})


def _winners_plan(ctx, winners: dict, label: str):
    """(ScoredMaskPlan, bind) injecting host-computed per-segment winners
    {seg_order: [(local, score)]} into the plan tree."""
    seg_order_by_id = {id(s): i for i, s in enumerate(ctx.segments)}

    def fn(seg, dseg):
        scores = np.zeros(dseg.n_pad, np.float32)
        mask = np.zeros(dseg.n_pad, bool)
        for local, score in winners.get(
                seg_order_by_id.get(id(seg), -1), []):
            scores[local] = score
            mask[local] = True
        return scores, mask

    return P.ScoredMaskPlan(label=label), {"fn": fn}



def _c_percolate(q, ctx, scored):
    """percolate: reverse search (modules/percolator).  Each stored query
    (the ``percolator`` field's _source JSON) is counted against a
    throwaway searcher holding the candidate document(s), on the
    searcher's own device; stored queries that match ANY candidate become
    hits.  Matching happens at compile time: the result is a
    ScoredMaskPlan over the query docs (knn's injection pattern).  One
    count per live stored query, as in the reference: no selection of
    candidate queries by their terms."""
    from opensearch_tpu_torch.index.segment import SegmentWriter
    from opensearch_tpu_torch.mapping.mapper import DocumentMapper
    from opensearch_tpu_torch.search.executor import ShardSearcher

    ft = ctx.field_type(q.field)
    if ft is None or ft.type_name != "percolator":
        raise IllegalArgumentError(
            f"[percolate] field [{q.field}] must be a percolator field")
    # candidate docs in a throwaway searcher over an ISOLATED mapper
    # clone (the percolator's MemoryIndex analog): dynamic resolution of
    # unmapped candidate fields must never leak into the index mapping
    tmp_mapper = DocumentMapper(ctx.mapper.to_mapping())
    parsed = [tmp_mapper.parse(f"_tmp_{i}", d)
              for i, d in enumerate(q.documents)]
    cand = ShardSearcher([SegmentWriter().build(parsed, "_percolate_tmp")],
                         tmp_mapper, device=ctx.device)
    winners: dict[int, list[tuple[int, float]]] = {}
    for seg_order, seg in enumerate(ctx.segments):
        live = ctx.lives[id(seg)]    # the searcher's point-in-time view
        for local in range(seg.n_docs):
            if not live[local]:
                continue
            stored = seg.source(local).get(q.field)
            if not isinstance(stored, dict):
                continue             # absent or malformed: never matches
            try:
                n = cand.count(stored)
            except OpenSearchTpuError:
                continue             # a query shape the engine can't run
            if n > 0:
                winners.setdefault(seg_order, []).append((local, q.boost))
    return _winners_plan(ctx, winners, "percolate")


def _c_nested(q, ctx, scored):
    """nested query: inner conditions compile into object-space plans
    (plan.py Obj*Plan) evaluated against the path's object-major columns,
    scatter-ORed back to parents.  Scoring is constant (the reference's
    score_mode none; avg / sum / max degrade to it: inner BM25 scoring
    inside nested blocks is not modeled)."""
    ft = ctx.field_type(q.path)
    if ft is None or ft.dv_kind != "nested":
        if q.ignore_unmapped:
            return _none()
        raise IllegalArgumentError(
            f"[nested] failed to find nested object under path "
            f"[{q.path}]")
    inner, ibind = _compile_obj(q.query, q.path, ctx)
    return (P.NestedPlan(path=q.path, inner=inner),
            {"inner": ibind, "boost": q.boost})


def _compile_obj(node, path, ctx):
    """Inner (object-space) compiler for nested queries."""
    prefix = path + "."

    def child_ft(field):
        if not field.startswith(prefix):
            field = prefix + field       # accept relative child names
        ft = ctx.field_type(field)
        if ft is None:
            raise IllegalArgumentError(
                f"[nested] unknown field [{field}] under [{path}]")
        return field, ft

    if isinstance(node, dsl.MatchAllQuery) or node is None:
        return P.ObjMatchAllPlan(), {}
    if isinstance(node, (dsl.TermQuery, dsl.TermsQuery)):
        raw = ([node.value] if isinstance(node, dsl.TermQuery)
               else list(node.values))
        field, ft = child_ft(node.field)
        if ft.dv_kind in ("long", "double"):
            return (P.ObjTermsPlan(field=field, kind="numeric"),
                    {"values": [float(ft.doc_value(v)) for v in raw]})
        return (P.ObjTermsPlan(field=field, kind="ordinal"),
                {"values": [str(ft.term_for_query(v)) for v in raw]})
    if isinstance(node, dsl.MatchQuery):
        field, ft = child_ft(node.field)
        if hasattr(ft, "search_terms"):
            terms = ft.search_terms(str(node.query), ctx.mapper.analyzers)
            return (P.ObjTermsPlan(field=field, kind="ordinal"),
                    {"values": terms})
        if ft.dv_kind in ("long", "double"):
            return (P.ObjTermsPlan(field=field, kind="numeric"),
                    {"values": [float(ft.doc_value(node.query))]})
        return (P.ObjTermsPlan(field=field, kind="ordinal"),
                {"values": [str(ft.term_for_query(node.query))]})
    if isinstance(node, dsl.RangeQuery):
        field, ft = child_ft(node.field)
        if ft.dv_kind not in ("long", "double"):
            raise IllegalArgumentError(
                f"[nested] range over [{field}] requires a numeric/date "
                "child field")

        def conv(v):
            return float(ft.doc_value(v))
        lo = conv(node.gte) if node.gte is not None else (
            conv(node.gt) if node.gt is not None else -np.inf)
        hi = conv(node.lte) if node.lte is not None else (
            conv(node.lt) if node.lt is not None else np.inf)
        return (P.ObjRangePlan(field=field,
                               include_lo=node.gt is None,
                               include_hi=node.lt is None),
                {"lo": lo, "hi": hi})
    if isinstance(node, dsl.ExistsQuery):
        field, _ft = child_ft(node.field)
        return P.ObjExistsPlan(field=field), {}
    if isinstance(node, dsl.BoolQuery):
        groups = []
        binds = []
        for clause_list in (node.must + node.filter, node.should,
                            node.must_not):
            compiled = [_compile_obj(c, path, ctx) for c in clause_list]
            groups.append(tuple(p for p, _b in compiled))
            binds.extend(b for _p, b in compiled)
        required = calc_min_should_match(
            len(node.should),
            node.minimum_should_match
            if node.minimum_should_match is not None
            else (0 if (node.must or node.filter) else 1))
        return (P.ObjBoolPlan(must=groups[0], should=groups[1],
                              must_not=groups[2],
                              should_required=required >= 1),
                {"children": tuple(binds)})
    raise IllegalArgumentError(
        f"[nested] inner query type [{type(node).__name__}] is not "
        "supported — use term/terms/match/range/exists/bool")

_COMPILERS = {
    dsl.MatchAllQuery: _c_match_all,
    dsl.MatchNoneQuery: _c_match_none,
    dsl.TermQuery: _c_term,
    dsl.TermsQuery: _c_terms,
    dsl.MatchQuery: _c_match,
    dsl.BoolQuery: _c_bool,
    dsl.RangeQuery: _c_range,
    dsl.ExistsQuery: _c_exists,
    dsl.IdsQuery: _c_ids,
    dsl.PrefixQuery: _c_prefix,
    dsl.ConstantScoreQuery: _c_constant_score,
    dsl.KnnQuery: _c_knn,
    dsl.ScriptScoreQuery: _c_script_score,
    dsl.MatchPhraseQuery: _c_match_phrase,
    dsl.MultiMatchQuery: _c_multi_match,
    dsl.DisMaxQuery: _c_dis_max,
    dsl.SimpleQueryStringQuery: _c_simple_query_string,
    dsl.MatchPhrasePrefixQuery: _c_match_phrase_prefix,
    dsl.MatchBoolPrefixQuery: _c_match_bool_prefix,
    dsl.SpanTermQuery: _c_span_term,
    dsl.SpanNearQuery: _c_span_near,
    dsl.SpanFirstQuery: _c_span_first,
    dsl.SpanOrQuery: _c_span_or,
    dsl.IntervalsQuery: _c_intervals,
    dsl.WildcardQuery: _c_wildcard,
    dsl.RegexpQuery: _c_regexp,
    dsl.FuzzyQuery: _c_fuzzy,
    dsl.BoostingQuery: _c_boosting,
    dsl.TermsSetQuery: _c_terms_set,
    dsl.DistanceFeatureQuery: _c_distance_feature,
    dsl.FunctionScoreQuery: _c_function_score,
    dsl.MoreLikeThisQuery: _c_more_like_this,
    dsl.GeoDistanceQuery: _c_geo_distance,
    dsl.GeoPolygonQuery: _c_geo_polygon,
    dsl.RankFeatureQuery: _c_rank_feature,
    dsl.GeoBoundingBoxQuery: _c_geo_bounding_box,
    dsl.NestedQuery: _c_nested,
    dsl.HasChildQuery: _c_has_child,
    dsl.HasParentQuery: _c_has_parent,
    dsl.ParentIdQuery: _c_parent_id,
    dsl.PercolateQuery: _c_percolate,
}
