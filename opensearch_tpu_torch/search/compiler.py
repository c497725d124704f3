"""Query tree -> (plan, bindings) against a shard's mapping + collection
statistics (the port of the part of the JAX package's
``search/compiler.py`` that match / term / terms / range / exists / ids /
prefix / bool / constant_score / knn / script_score queries need).

idf/avgdl are computed here from CROSS-SEGMENT stats (Lucene computes
them in IndexSearcher.termStatistics over the whole reader, not per
leaf), so scores are consistent across segments.  Query types the
reference compiles but this package does not yet raise
``NotYetPortedError`` (HTTP 501) rather than answering differently.
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass

import numpy as np
import torch

from opensearch_tpu_torch.common.errors import (IllegalArgumentError,
                                                NotYetPortedError,
                                                OpenSearchTpuError)
from opensearch_tpu_torch.mapping.types import (KeywordFieldType,
                                                TextFieldType, parse_ip_long)
from opensearch_tpu_torch.ops import bm25 as bm25_ops
from opensearch_tpu_torch.search import plan as P
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


def _not_ported(what: str):
    raise NotYetPortedError(f"{what} is not ported to the torch package yet")


def _require_ft(ctx, field, qname):
    ft = ctx.field_type(field)
    if ft is None:
        return None
    if not ft.index_enabled and ft.dv_kind == "none":
        raise IllegalArgumentError(
            f"Cannot search on field [{field}] since it is not indexed")
    return ft


def compile_query(q: dsl.Query, ctx: ShardContext, scored: bool = True):
    """Returns (plan, bind)."""
    fn = _COMPILERS.get(type(q))
    if fn is None:
        # a hybrid query runs only at the root, per sub-query
        # (executor._hybrid_search); nested, the reference refuses it
        if isinstance(q, dsl.Query) and not isinstance(q, dsl.HybridQuery):
            _not_ported(f"query type [{type(q).__name__}]")
        raise IllegalArgumentError(
            f"query type [{type(q).__name__}] is not supported")
    return fn(q, ctx, scored)


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
        except NotYetPortedError:
            raise
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
        _not_ported("match with [fuzziness]")
    if q.operator == "and":
        required = len(terms)
    else:
        required = max(1, calc_min_should_match(len(terms),
                                                q.minimum_should_match))
    if required > len(terms):
        return _none()
    return _term_bag(ctx, q.field, terms, required, q.boost, scored)


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
    if src == "geo":
        _not_ported(f"exists on geo_point field [{q.field}]")
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


_MAX_CODEPOINT = chr(0x10FFFF)


def _c_prefix(q, ctx, scored):
    ft = _require_ft(ctx, q.field, "prefix")
    if ft is None:
        return _none()
    value = str(q.value)
    return (P.TermRangeMaskPlan(field=q.field),
            {"lo": value, "hi": value + _MAX_CODEPOINT, "boost": q.boost})


def _c_constant_score(q, ctx, scored):
    child_plan, child_bind = compile_query(q.query, ctx, scored=False)
    return (P.ConstScorePlan(child=child_plan),
            {"boost": q.boost, "child": child_bind})


def _c_knn(q, ctx, scored):
    """knn query: exact vector search of every segment at once
    (ops/knn.py -- one K1 launch per query on CUDA, each segment's top-k
    inside the kernel), with the global per-shard k winners injected
    into the plan tree as a ScoredMaskPlan.  Optional ``filter``
    restricts candidates BEFORE the k cut (the plugin's filtered-knn
    semantics).  The host syncs once per query.  ANN methods
    (``ivf``/``ivf_pq``) are not ported yet."""
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
    if method.get("name") in ("ivf", "ivf_pq"):
        _not_ported(f"knn method [{method['name']}] (ANN search)")

    filter_state = None
    if q.filter is not None:
        filter_state = compile_query(q.filter, ctx, scored=False)

    qvec_t = torch.from_numpy(qvec).to(ctx.device)
    # phase 1: every segment's inputs (the filter's masks are launched
    # here: each term-bag leaf of the filter once over every segment with
    # the field), then one top-k launch over them all.  ``inputs`` keeps
    # every tensor the launch reads referenced until the host sync below.
    inputs, orders, filter_items = [], [], []
    for seg_order, seg in enumerate(ctx.segments):
        dseg = seg.device(ctx.device)
        vcol = dseg.vector.get(q.field)
        if vcol is None:
            continue
        if filter_state is not None:
            fplan, fbind = filter_state
            A = build_arrays(dseg, fplan.arrays(), ctx.mapper)
            dims, ins = fplan.prepare(fbind, seg, dseg, ctx)
            filter_items.append((A, dims, ins))
        inputs.append(KnnSegment(vcol["values"], vcol["exists"],
                                 ctx.live_mask(seg, dseg)))
        orders.append(seg_order)
    if filter_state is not None:
        fplan = filter_state[0]
        P.dense_prepass(fplan, filter_items)
        inputs = [s._replace(mask=P.run_full(fplan, dims, A, ins,
                                             -np.inf)[1])
                  for s, (A, dims, ins) in zip(inputs, filter_items)]
    candidates = []          # (score, seg_order, local)
    if inputs:
        vals, idx = knn_topk_segments_auto(inputs, qvec_t, space=space,
                                           k=q.k)
        # phase 2: one host sync for all segments' top-k
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        for row, seg_order in enumerate(orders):
            keep = (vals[row] > -np.inf) & (idx[row] >= 0)
            for v, i in zip(vals[row][keep], idx[row][keep]):
                candidates.append((float(v), seg_order, int(i)))
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


def _script_vector_columns(calls, ctx) -> dict:
    """{key: {id(segment): f32 [n_pad]}}: each distinct vector function
    of a script (``ScriptProgram.vector_calls``) over every row of every
    segment that has its field, in one call (one K1 launch on CUDA)."""
    from opensearch_tpu_torch.ops.knn import (KnnSegment,
                                              vector_scores_segments_auto)
    from opensearch_tpu_torch.search.scripting import ScriptException

    out = {}
    for key, (fn, field, qvec) in calls.items():
        segs, ids = [], []
        for seg in ctx.segments:
            vcol = seg.device(ctx.device).vector.get(field)
            if vcol is None:
                continue
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
}
