"""Query plans: Query tree -> (plan, bindings) -> per-segment torch
program (the port of the part of the JAX package's ``search/plan.py``
that the match / term / bool / constant_score / knn path runs).

As in the reference:

- a *plan node* is a frozen, hashable dataclass holding only static
  STRUCTURE (field names, clause layout, scoring flags);
- per-query data (term strings, idfs, bounds, boosts) lives in a
  parallel *bindings tree*, consumed host-side by ``prepare`` which
  emits the per-segment ``dims`` (static sizes: padded term counts,
  gather budgets) and ``ins`` (tensors on the segment's device);
- every node evaluates to ``(scores f32 [n_pad], matched bool
  [n_pad])``; scores are zero wherever unmatched, so boolean
  composition is masked arithmetic.

There is no ``jit``: PyTorch runs eagerly, on whatever device the
staged segment lives on.  The term-bag leaves (``TermBagPlan``,
``PostingsMaskPlan``) read their dense columns from K2's dense entry:
``dense_prepass`` launches each leaf of a plan once over every segment a
request evaluates (one launch per row layout on CUDA; the phrase and
span leaves one launch per kernel over all of them) and leaves each
segment's views in its request-scoped arrays (``A["dense"]``, keyed by
the leaf's prepared inputs); a leaf evaluated without them (the k-NN
filter, an aggregation's filter mask) makes the same call over its one
segment.  The filter plans (numeric terms and ranges,
ordinal ranges, postings and term-range masks, exists, host masks) read
the doc-value columns ``DeviceSegment`` stages, through
``ops/filters.py``.  ``ScriptScorePlan`` rescores its child by a
compiled score script (``search/scripting.py``) over the numeric dense
view and the per-row vector columns the compiler's pre-pass made (K1).
``PhrasePlan`` and ``SpanNearPlan`` read a field's positions
(``DeviceSegment.ensure_positions``, the ``positions`` array group) and
take their scores and matched masks from K8 / K9 (``ops/phrase.py``,
``ops/span.py``): the same pre-pass launches each kernel once over every
phrase or span leaf of the request and every segment, BM25 inside the
kernel; ``DisMaxPlan`` combines its children as the reference does.
``ExpandTermsPlan`` (wildcard / regexp / fuzzy), ``BoostingPlan``,
``TermsSetPlan``, ``DistanceFeaturePlan``, the geo filters and
``FunctionScorePlan`` are torch ops over those columns and K1 / K2's
dense entries.  ``NestedPlan`` evaluates its object-space plans
(``ObjTermsPlan``, ``ObjRangePlan``, ``ObjExistsPlan``, ``ObjBoolPlan``,
``ObjMatchAllPlan``) over the staged nested blocks and scatters the
object masks to parents; the parent-join queries and ``percolate``
inject their per-segment results through ``ScoredMaskPlan``.
"""

from __future__ import annotations

import bisect
import fnmatch
import math
import re
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from opensearch_tpu_torch.common import torchenv  # noqa: F401
from opensearch_tpu_torch.index import codec
from opensearch_tpu_torch.index.segment import (LONG_MISSING_MAX,
                                                pad_bucket, pad_pow2,
                                                prefetch_quantized)
from opensearch_tpu_torch.ops import bm25 as bm25_ops
from opensearch_tpu_torch.ops import filters as filter_ops
from opensearch_tpu_torch.ops import phrase as phrase_ops
from opensearch_tpu_torch.ops.phrase import fma32
from opensearch_tpu_torch.ops import span as span_ops

_I32 = np.int32
_F32 = np.float32


def _f32(x) -> float:
    """A Python float holding exactly the float32 value of ``x``: torch
    applies a Python scalar to a float32 tensor in float32, so this is
    the reference's float32 scalar without a device transfer."""
    return float(np.float32(x))


def _tensor(arr, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(arr, dtype=dtype)).to(device)


def _exact(x, dtype):
    """A Python scalar holding exactly ``x`` cast to ``dtype`` (int64 or
    float64), the reference's ``_scalar``: torch compares an int64 or
    float64 column with it in the column's own type."""
    v = np.asarray(x, dtype=dtype)
    return int(v) if np.issubdtype(v.dtype, np.integer) else float(v)


def _pad_np(arr, size, fill, dtype) -> np.ndarray:
    out = np.full(size, fill, dtype=dtype)
    a = np.asarray(arr, dtype=dtype)
    out[: len(a)] = a
    return out


def _const(matched, boost):
    """``(where(matched, boost, 0) f32, matched)``: a constant-score
    filter's result."""
    return torch.where(matched, boost, 0.0).to(torch.float32), matched


def _live_n_pad(A) -> tuple:
    live = A["live"]
    return live.shape[0], live.device


def _term_slots(pf, terms):
    """The padded query-term slots of ``terms`` over a segment's postings
    ``pf`` (None: the field is absent) on the host: ``(t_pad, term ids,
    active, row ranges [t_pad, 2], budget)``."""
    t_pad = pad_pow2(len(terms), minimum=1)
    tids = np.zeros(t_pad, dtype=_I32)
    active = np.zeros(t_pad, dtype=bool)
    rows = np.zeros((t_pad, 2), dtype=np.int64)
    budget = 0
    for i, t in enumerate(terms):
        tid = pf.term_id(t) if pf is not None else -1
        if tid >= 0:
            tids[i] = tid
            active[i] = True
            rows[i] = pf.offsets[tid], pf.offsets[tid + 1]
            budget += int(pf.df[tid])
    return t_pad, tids, active, rows, pad_bucket(budget)


def _dense_cols(leaf, A, dims, ins):
    """A term-bag leaf's dense ``(scores | None, counts | None)`` on one
    segment: the request's pre-pass views (``dense_prepass``) when it made
    them, else one call of the dense entry over this segment alone."""
    cols = A.get("dense", {}).get(id(ins))
    if cols is None:
        cols = bm25_ops.term_bag_dense_auto(
            [leaf.dense_bag(A, dims, ins)], **leaf.dense_mode(dims))[0]
    return cols


def dense_prepass(plan, items) -> None:
    """Launch every leaf of ``plan`` that reads a kernel's dense views
    over the segments of ``items`` (``(A, dims, ins)`` per segment, as the
    caller prepared them): a term-bag leaf by one ``term_bag_dense_auto``
    call over its segments (one launch per row layout on CUDA); the
    phrase and span leaves by one call of their entry (``PositionalPlan.
    scores_auto``: K8, K9) over all of them and every segment.  Each
    segment's views go to its ``A["dense"]``, keyed by the id of the
    leaf's inputs, which the caller holds for the request: nothing enters
    the prepared inputs or the bindings, which the searcher caches across
    requests."""
    if not items:
        return
    walks = [list(plan.dense_leaves(dims, ins)) for _A, dims, ins in items]
    positional = {}
    for j, (leaf, dims0, _ins0) in enumerate(walks[0]):
        if isinstance(leaf, PositionalPlan):
            positional.setdefault(leaf.scores_auto, []).extend(
                (A, w[j][2], leaf.positional_leaf(A, w[j][1], w[j][2]))
                for (A, _d, _i), w in zip(items, walks))
            continue
        bags = [leaf.dense_bag(A, w[j][1], w[j][2])
                for (A, _d, _i), w in zip(items, walks)]
        cols = bm25_ops.term_bag_dense_auto(bags, **leaf.dense_mode(dims0))
        for (A, _d, _i), w, c in zip(items, walks, cols):
            A.setdefault("dense", {})[id(w[j][2])] = c
    for scores_auto, jobs in positional.items():
        views = scores_auto([leaf for _A, _i, leaf in jobs])
        for (A, ins, _leaf), view in zip(jobs, views):
            A.setdefault("dense", {})[id(ins)] = view


# ---------------------------------------------------------------------------
# Plan nodes.  All frozen + hashable: static query structure only.
# Each implements:
#   arrays() -> frozenset[(group, field)]         device arrays needed
#   prepare(bind, seg, dseg, ctx) -> (dims, ins)  host-side, per segment
#   eval(A, dims, ins) -> (scores, matched)       torch, on dseg's device
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Plan:
    def arrays(self) -> frozenset:
        return frozenset()

    def skip_arrays(self, dims) -> frozenset:
        """Subset of ``arrays()`` this plan does NOT need fully staged
        for the dims ``prepare`` returned: the executor passes it to
        ``build_arrays`` so a quantized lowering (which carries its
        tables in ``ins``) does not stage the f32 posting columns.
        Composites keep the default (empty), as in the reference."""
        return frozenset()

    def can_match(self, bind, seg) -> bool:
        """Host-side pre-filter: False only when NO doc in this segment
        can match (the CanMatchPreFilterSearchPhase analog).  Must stay
        conservative: returning True is always safe."""
        return True

    def max_score_bound(self, bind, seg) -> float:
        """Safe UPPER bound on any single doc's score in this segment —
        the MaxScore/BMW pruning surface over the per-term block-max
        impact metadata (``Segment.max_impacts``).  Returning
        ``math.inf`` (the default) is always safe; finite bounds carry a
        small multiplicative margin so float32 rounding can never make a
        real score exceed them."""
        return math.inf

    def dense_leaves(self, dims, ins):
        """``(leaf, dims, ins)`` of every term-bag, phrase and span leaf
        under this plan, in a fixed order (the same on every segment): what
        ``dense_prepass`` launches.  Composites walk their children's
        prepared inputs."""
        return ()

    def describe(self, bind) -> str:
        """Compact structural description for the Profile API's query
        section (``Query.toString()`` analog), as the reference writes
        it: the plan's static fields, then the bind's ``terms`` /
        ``values`` (the first 8) and ``queries`` / ``children`` counts,
        never document data.  A tensor prints as its numpy values, as
        the reference prints its array's."""
        import dataclasses
        parts = [f"{f.name}={getattr(self, f.name)!r}"
                 for f in dataclasses.fields(self)]
        if isinstance(bind, dict):
            for key in ("terms", "values"):
                v = bind.get(key)
                if isinstance(v, (list, tuple)) and v:
                    shown = ",".join(str(_host_value(x)) for x in v[:8])
                    more = ",…" if len(v) > 8 else ""
                    parts.append(f"{key}=[{shown}{more}]")
            for key in ("queries", "children"):
                v = bind.get(key)
                if isinstance(v, (list, tuple)):
                    parts.append(f"{key}#{len(v)}")
        return f"{type(self).__name__}({', '.join(parts)})"


def _host_value(x):
    """``x``, or a tensor's values as numpy (the profile's descriptions
    print no tensor repr)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


# float32 rounding can nudge a real score a few ulp above the float64
# host-side bound arithmetic; inflating every finite bound by this
# factor keeps pruning strictly conservative.
_BOUND_MARGIN = 1.0001


def _boost_bound(self, bind, seg) -> float:
    """max_score_bound for constant-score plans: the boost IS the only
    possible score."""
    b = float(bind["boost"])
    return b * _BOUND_MARGIN if b >= 0 else math.inf


@dataclass(frozen=True)
class MatchAllPlan(Plan):
    def prepare(self, bind, seg, dseg, ctx):
        return (), (_f32(bind["boost"]),)

    def eval(self, A, dims, ins):
        (boost,) = ins
        n_pad, dev = _live_n_pad(A)
        return (torch.full((n_pad,), boost, dtype=torch.float32,
                           device=dev),
                torch.ones(n_pad, dtype=torch.bool, device=dev))

    max_score_bound = _boost_bound


@dataclass(frozen=True)
class MatchNonePlan(Plan):
    def prepare(self, bind, seg, dseg, ctx):
        return (), ()

    def eval(self, A, dims, ins):
        n_pad, dev = _live_n_pad(A)
        return (torch.zeros(n_pad, dtype=torch.float32, device=dev),
                torch.zeros(n_pad, dtype=torch.bool, device=dev))

    def max_score_bound(self, bind, seg) -> float:
        return 0.0


@dataclass(frozen=True)
class TermBagPlan(Plan):
    """Weighted bag of terms over one field's postings: term / match.
    BM25-scored (Lucene TermQuery / BooleanQuery of term clauses).
    bind: {terms, idfs, weights, avgdl, required}; ``required`` is the
    per-doc matched-clause count needed (1 = OR, n_terms = AND,
    minimum_should_match otherwise)."""

    field: str = ""
    scored: bool = True

    def arrays(self):
        return frozenset({("postings", self.field)})

    def can_match(self, bind, seg):
        pf = seg.postings.get(self.field)
        if pf is None:
            return False
        present = sum(1 for t in bind["terms"] if pf.term_id(t) >= 0)
        # a doc can match at most `present` distinct query terms here
        return present >= max(int(bind.get("required", 1)), 1)

    def max_score_bound(self, bind, seg):
        if not self.scored:
            return 0.0                   # filter context scores are 0
        pf = seg.postings.get(self.field)
        if pf is None:
            return 0.0
        mi = seg.max_impacts(self.field, bind["avgdl"])
        total = 0.0
        for t, idf_v, w in zip(bind["terms"], bind["idfs"],
                               bind["weights"]):
            if w < 0:
                return math.inf          # negative weights: no bound
            tid = pf.term_id(t)
            if tid >= 0:
                total += float(idf_v) * float(w) * float(mi[tid])
        return total * _BOUND_MARGIN

    def _quantized(self, seg, dseg) -> bool:
        """Does this bag take the quantized lowering on this segment?
        Scored bags on a segment ``index/codec.py`` quantizes, as in the
        reference; filter-context bags stay on the f32 columns."""
        return (self.scored and dseg.quantized_mode
                and seg.postings.get(self.field) is not None)

    def _slots(self, bind, seg):
        """The padded query-term slots on the host: ``(t_pad, term ids,
        active, row ranges [t_pad, 2], budget)``."""
        return _term_slots(seg.postings.get(self.field), bind["terms"])

    def _scoring(self, bind, t_pad):
        """``(idfs f32 [t_pad], weights f32 [t_pad], fast)``.  Fast path:
        a plain OR bag with positive idf*weight scores > 0 exactly on
        matched docs, so the matched-count pass is skipped."""
        idfs = np.asarray(bind["idfs"], _F32)
        weights = np.asarray(bind["weights"], _F32)
        fast = (int(bind["required"]) == 1
                and bool((weights > 0).all()) and bool((idfs > 0).all()))
        pad = np.zeros(t_pad, _F32)
        return (np.concatenate([idfs, pad])[:t_pad],
                np.concatenate([weights, pad])[:t_pad], fast)

    def prepare(self, bind, seg, dseg, ctx):
        """dims ``(t_pad, budget, fast)``, and ``(t_pad, budget, fast,
        width)`` on the quantized lowering; ins ``(slots, rows, required)``:
        the host slots ``(term ids, active, idfs, weights, row ranges,
        budget)`` (idfs and weights 0 in filter context), then the f32
        impact column, or the quantized tables (``QuantizedBag``), or None
        (filter context)."""
        t_pad, tids, active, rows, budget = self._slots(bind, seg)
        required = int(bind["required"])
        if not self.scored:
            zeros = np.zeros(t_pad, _F32)
            return (t_pad, budget, False), (
                (tids, active, zeros, zeros, rows, budget), None, required)
        idfs, weights, fast = self._scoring(bind, t_pad)
        slots = (tids, active, idfs, weights, rows, budget)
        if self._quantized(seg, dseg):
            # the quantized lowering: the tables ride in ``ins``, the f32
            # posting columns are never staged (``skip_arrays``), and
            # dims grows a 4th element, the delta width
            quant = self._quant_bag(bind, seg, dseg, tids)
            return (t_pad, budget, fast, quant.width), (slots, quant,
                                                        required)
        # the f32 lowering (segments below the threshold)
        impacts = dseg.impacts(self.field, bind["avgdl"])  # quantize-ok
        return (t_pad, budget, fast), (slots, impacts, required)

    def _quant_bag(self, bind, seg, dseg, tids) -> bm25_ops.QuantizedBag:
        """The quantized tables of this segment and each slot's term base,
        scale and exact range from the host tables (the kernels read them
        from their launch tables)."""
        qt = seg.quantized_table(self.field, bind["avgdl"])
        q = dseg.quantized(self.field, bind["avgdl"])
        e0, e1 = qt.exact_offsets[tids], qt.exact_offsets[tids + 1]
        return bm25_ops.QuantizedBag(
            q["qvals"], q["scales"], q["exact_vals"], q["exact_offsets"],
            q["packed"], q["base"], int(qt.width),
            qt.base[tids].astype(np.int64), qt.scales[tids],
            np.where(e1 > e0, e0, -1).astype(np.int64))

    def prefetch_quantized(self, bind, segments, device) -> int:
        """The pager's prefetch oracle: rank the quantized segments that
        can match by their block-max score bound and stage their tables
        best first into FREE pager pages on ``device`` (never evicting).
        Returns the segments staged."""
        if not self.scored:
            return 0
        ranked = [(self.max_score_bound(bind, seg), i, seg)
                  for i, seg in enumerate(codec.quantized_segments(segments))
                  if self.can_match(bind, seg)]
        ranked.sort(key=lambda t: (-t[0], t[1]))
        return sum(prefetch_quantized(seg, self.field, bind["avgdl"], device)
                   for _b, _i, seg in ranked)

    def dense_mode(self, dims) -> dict:
        """The dense entry's columns this leaf reads: counts only in filter
        context, scores only on the fast path, else both."""
        if not self.scored:
            return dict(scores=False, counts=True)
        return dict(scores=True, counts=not dims[2])

    def dense_bag(self, A, dims, ins) -> bm25_ops.DenseBag:
        """This segment's ``DenseBag``: the staged rows of ``A`` (or the
        quantized tables of ``ins``) and the host slots of ``ins``."""
        slots, rows, _required = ins
        p = A["postings"][self.field]
        n_pad = A["live"].shape[0]
        if len(dims) == 4:
            return bm25_ops.DenseBag(p["offsets"], None, None, n_pad, *slots,
                                     quant=rows)
        return bm25_ops.DenseBag(p["offsets"], p["doc_ids"], rows, n_pad,
                                 *slots)

    def dense_leaves(self, dims, ins):
        return ((self, dims, ins),)

    def skip_arrays(self, dims) -> frozenset:
        # 4-tuple dims = quantized lowering: eval reads only the offsets
        # of the postings entry
        if len(dims) == 4:
            return frozenset({("postings", self.field)})
        return frozenset()

    def topk_input(self, bind, seg, dseg, A,
                   f32: bool = False) -> bm25_ops.TermBagSegment:
        """This segment's inputs to the fused top-k of a scored bag
        (``ops/bm25.py`` ``term_bag_topk_segments``): the slots of
        ``prepare``, each with its posting range read from the host CSR,
        and no per-query tensor copied to the device.  ``A`` is the
        segment's arrays (``executor.build_arrays``).  ``f32`` takes the
        f32 lowering on a quantized segment too (the batched path's), its
        f32 columns staged on demand."""
        if not self.scored:
            raise ValueError("topk_input takes a scored term bag")
        t_pad, tids, active, rows, budget = self._slots(bind, seg)
        idfs, weights, fast = self._scoring(bind, t_pad)
        p = A["postings"][self.field]
        args = (tids, active, idfs, weights, rows, int(bind["required"]),
                fast, budget)
        if f32 or not self._quantized(seg, dseg):
            # the f32 lowering: segments below the threshold, and the
            # batched path's bags on any segment
            if f32:
                p = dseg.ensure_postings(self.field)
            imp = dseg.impacts(self.field, bind["avgdl"])  # quantize-ok
            return bm25_ops.TermBagSegment(p["offsets"], p["doc_ids"], imp,
                                           A["live"], *args)
        return bm25_ops.TermBagSegment(
            p["offsets"], None, None, A["live"], *args,
            quant=self._quant_bag(bind, seg, dseg, tids))

    def eval(self, A, dims, ins):
        scores, count = _dense_cols(self, A, dims, ins)
        if not self.scored:
            n_pad, dev = _live_n_pad(A)
            return (torch.zeros(n_pad, dtype=torch.float32, device=dev),
                    count >= ins[2])
        matched = scores > 0.0 if dims[2] else count >= ins[2]
        return torch.where(matched, scores, 0.0), matched


@dataclass(frozen=True)
class ScoredMaskPlan(Plan):
    """Precomputed per-segment (scores, matched): the knn pre-pass's
    winners, the parent-join queries' masks and percolate's matches are
    injected into the tree through this node.
    bind: {fn: (seg, dseg) -> (scores f32 [n_pad], mask bool [n_pad]),
    numpy arrays or tensors on the segment's device}."""

    label: str = "knn"

    def prepare(self, bind, seg, dseg, ctx):
        scores, mask = bind["fn"](seg, dseg)
        if not isinstance(scores, torch.Tensor):
            scores = _tensor(scores, _F32, dseg.device)
            mask = _tensor(mask, bool, dseg.device)
        return (), (scores, mask)

    def eval(self, A, dims, ins):
        scores, mask = ins
        return torch.where(mask, scores, 0.0), mask


@dataclass(frozen=True)
class NumericTermsPlan(Plan):
    """term/terms over a numeric/date column: constant score (the reference
    compiles these to point/doc-values queries under ConstantScore).
    bind: {values, boost}."""

    field: str = ""
    kind: str = "long"               # long | double

    def arrays(self):
        return frozenset({("numeric", self.field)})

    def prepare(self, bind, seg, dseg, ctx):
        vals = bind["values"]
        q_pad = pad_pow2(len(vals), minimum=1)
        dtype = np.int64 if self.kind == "long" else np.float64
        fill = LONG_MISSING_MAX if self.kind == "long" else np.nan
        qv = _pad_np(vals, q_pad, fill, dtype)
        qvalid = _pad_np(np.ones(len(vals), bool), q_pad, False, bool)
        dev = dseg.device
        return (q_pad,), (_tensor(qv, dtype, dev), _tensor(qvalid, bool, dev),
                          _f32(bind["boost"]))

    def eval(self, A, dims, ins):
        qv, qvalid, boost = ins
        col = A["numeric"][self.field]
        n_pad, _dev = _live_n_pad(A)
        ok = (col["values"][:, None] == qv[None, :]) & qvalid[None, :]
        matched = filter_ops.scatter_any(ok.any(dim=1), col["value_docs"],
                                         n_pad)
        return _const(matched, boost)


@dataclass(frozen=True)
class NumericRangePlan(Plan):
    """bind: {lo, hi, boost} (inclusivity resolved into the bounds at
    compile time for longs; kept as static flags for doubles)."""

    field: str = ""
    kind: str = "long"               # long | double
    include_lo: bool = True
    include_hi: bool = True

    def arrays(self):
        return frozenset({("numeric", self.field)})

    def can_match(self, bind, seg):
        dv = seg.numeric_dv.get(self.field)
        if dv is None or not len(dv.value_docs):
            return False
        bounds = getattr(dv, "_value_bounds", None)
        if bounds is None:
            # immutable per segment: one scan serves every query
            bounds = dv._value_bounds = (dv.values.min(), dv.values.max())
        seg_lo, seg_hi = bounds
        lo, hi = bind["lo"], bind["hi"]
        if (seg_hi < lo or (seg_hi == lo and not self.include_lo)
                or seg_lo > hi or (seg_lo == hi and not self.include_hi)):
            return False
        return True

    def prepare(self, bind, seg, dseg, ctx):
        dtype = np.int64 if self.kind == "long" else np.float64
        return (), (_exact(bind["lo"], dtype), _exact(bind["hi"], dtype),
                    _f32(bind["boost"]))

    def eval(self, A, dims, ins):
        lo, hi, boost = ins
        col = A["numeric"][self.field]
        n_pad, _dev = _live_n_pad(A)
        matched = filter_ops.range_mask(
            col["values"], col["value_docs"], lo, hi,
            include_lo=self.include_lo, include_hi=self.include_hi,
            n_pad=n_pad)
        return _const(matched, boost)


@dataclass(frozen=True)
class OrdinalRangePlan(Plan):
    """Keyword range: per-segment ordinal bounds resolved host-side by
    binary search over the sorted term dictionary; the device compares
    ordinals (ordinal order == term order by construction).
    bind: {lo, lo_incl, hi, hi_incl, boost}."""

    field: str = ""

    def arrays(self):
        return frozenset({("ordinal", self.field)})

    def prepare(self, bind, seg, dseg, ctx):
        dv = seg.ordinal_dv.get(self.field)
        terms = dv.ord_terms if dv is not None else []
        lo, hi = bind["lo"], bind["hi"]
        lo_ord = 0
        hi_ord = len(terms)
        if lo is not None:
            lo_ord = (bisect.bisect_left(terms, lo) if bind["lo_incl"]
                      else bisect.bisect_right(terms, lo))
        if hi is not None:
            hi_ord = (bisect.bisect_right(terms, hi) if bind["hi_incl"]
                      else bisect.bisect_left(terms, hi))
        return (), (_exact(lo_ord, np.int32), _exact(hi_ord, np.int32),
                    _f32(bind["boost"]))

    def eval(self, A, dims, ins):
        lo_ord, hi_ord, boost = ins
        col = A["ordinal"][self.field]
        n_pad, _dev = _live_n_pad(A)
        matched = filter_ops.range_mask(
            col["ords"], col["value_docs"], lo_ord, hi_ord,
            include_lo=True, include_hi=False, n_pad=n_pad)
        return _const(matched, boost)


@dataclass(frozen=True)
class PostingsMaskPlan(Plan):
    """Constant-score docs-containing-any-of-these-terms (terms query on a
    keyword/text field — Lucene TermInSetQuery).  bind: {terms, boost}.
    K2's dense entry in counts-only mode: a doc matches with a count
    above 0 (the reference's ``postings_mask``)."""

    field: str = ""

    def arrays(self):
        return frozenset({("postings", self.field)})

    def prepare(self, bind, seg, dseg, ctx):
        t_pad, tids, active, rows, budget = _term_slots(
            seg.postings.get(self.field), bind["terms"])
        zeros = np.zeros(t_pad, _F32)
        return ((t_pad, budget),
                ((tids, active, zeros, zeros, rows, budget),
                 _f32(bind["boost"])))

    def dense_mode(self, dims) -> dict:
        return dict(scores=False, counts=True)

    def dense_bag(self, A, dims, ins) -> bm25_ops.DenseBag:
        p = A["postings"][self.field]
        return bm25_ops.DenseBag(p["offsets"], p["doc_ids"], None,
                                 A["live"].shape[0], *ins[0])

    def dense_leaves(self, dims, ins):
        return ((self, dims, ins),)

    def eval(self, A, dims, ins):
        _scores, count = _dense_cols(self, A, dims, ins)
        return _const(count > 0, ins[1])


def _row_runs(starts, stops, dev, boost):
    """``prepare``'s ``(dims, ins)`` of a constant-score mask over runs of
    posting rows, run r being CSR rows ``[starts[r], stops[r])``: dims
    ``(total,)``, the rows to read; ins ``(ends, base, boost)``, per run
    its end in the concatenated rows (int64, cumulative) and the shift
    from a row's place there to its place in the CSR."""
    lens = np.asarray(stops, np.int64) - np.asarray(starts, np.int64)
    ends = np.cumsum(lens)
    if not len(ends) or ends[-1] == 0:
        return (0,), (None, None, _f32(boost))
    return ((int(ends[-1]),),
            (_tensor(ends, np.int64, dev),
             _tensor(np.asarray(starts, np.int64) - (ends - lens),
                     np.int64, dev), _f32(boost)))


def _row_runs_mask(A, field, dims, ins):
    """The docs of every posting row of ``_row_runs``' runs, scatter-ORed
    into a constant-score mask: ``searchsorted`` maps a lane to its run
    (an empty run is never a lane's)."""
    (total,) = dims
    ends, base, boost = ins
    n_pad, dev = _live_n_pad(A)
    if total == 0:
        return _const(torch.zeros(n_pad, dtype=torch.bool, device=dev),
                      boost)
    i = torch.arange(total, dtype=torch.int64, device=dev)
    rows = i + base[torch.searchsorted(ends, i, right=True)]
    d = A["postings"][field]["doc_ids"][rows]
    ok = torch.ones(total, dtype=torch.bool, device=dev)
    return _const(filter_ops.scatter_any(ok, d, n_pad), boost)


@dataclass(frozen=True)
class TermRangeMaskPlan(Plan):
    """Constant-score docs containing any term in a CONTIGUOUS term-id
    range — a prefix is a range of the sorted term dict (Lucene
    PrefixQuery's automaton walk collapses to two binary searches): one
    run of posting rows (``_row_runs_mask``).  bind: {lo, hi, boost}
    (string bounds, [lo, hi)).  The range's posting bounds come from the
    host CSR, so no offset is read back."""

    field: str = ""

    def arrays(self):
        return frozenset({("postings", self.field)})

    def prepare(self, bind, seg, dseg, ctx):
        pf = seg.postings.get(self.field)
        o_lo = o_hi = 0
        if pf is not None:
            sterms = ctx.sorted_terms(seg, self.field)
            lo_tid = bisect.bisect_left(sterms, bind["lo"])
            hi_tid = bisect.bisect_left(sterms, bind["hi"])
            o_lo, o_hi = int(pf.offsets[lo_tid]), int(pf.offsets[hi_tid])
        return _row_runs([o_lo], [o_hi], dseg.device, bind["boost"])

    def eval(self, A, dims, ins):
        return _row_runs_mask(A, self.field, dims, ins)


@dataclass(frozen=True)
class ExpandTermsPlan(Plan):
    """wildcard / regexp / fuzzy: the terms that match, found on the host
    at compile time (``expand``: each segment's sorted dictionary walked
    as the reference's ``prepare`` walks it, each distinct term tested
    once a request), then a constant-score mask over every posting row of
    those terms (Lucene MultiTermQuery's CONSTANT_SCORE rewrite): the rows
    of a run of consecutive term ids are contiguous in the CSR, so the
    mask is ``_row_runs_mask`` over a list of runs.  A literal prefix of
    the pattern (a wildcard's, unless case-insensitive; fuzzy's
    ``prefix_length``) narrows the walk to its range of the dictionary by
    binary search.  bind: {pattern, fuzzy_dist, prefix_length, nocase,
    boost, terms}: ``terms`` the matched terms ``expand`` found."""

    field: str = ""
    mode: str = "wildcard"           # wildcard | regexp | fuzzy

    def arrays(self):
        return frozenset({("postings", self.field)})

    def _matcher(self, bind) -> tuple:
        """``(literal prefix of every match, predicate on a term)``: the
        reference's tests (a wildcard through ``fnmatch.translate`` and
        ``re.match``, a regexp ``re.fullmatch``, fuzzy the optimal string
        alignment distance with the prefix required)."""
        pat = bind["pattern"]
        if self.mode == "wildcard":
            nocase = bool(bind.get("nocase"))
            rx = re.compile(fnmatch.translate(pat),
                            re.IGNORECASE if nocase else 0)
            prefix = "" if nocase else re.match(r"[^*?\[]*", pat).group(0)
            return prefix, lambda t: rx.match(t) is not None
        if self.mode == "regexp":
            rx = re.compile(pat)
            return "", lambda t: rx.fullmatch(t) is not None
        k = int(bind["fuzzy_dist"])
        return (pat[: bind["prefix_length"]],
                lambda t: _edit_distance_le(pat, t, k))

    def expand(self, bind, ctx) -> frozenset:
        """The terms of ``field`` over every segment's dictionary that
        match, each distinct term tested once."""
        prefix, pred = self._matcher(bind)
        seen: dict[str, bool] = {}
        for seg in ctx.segments:
            if self.field not in seg.postings:
                continue
            sterms = ctx.sorted_terms(seg, self.field)
            for i in range(bisect.bisect_left(sterms, prefix), len(sterms)):
                t = sterms[i]
                if not t.startswith(prefix):
                    break
                if t not in seen:
                    seen[t] = pred(t)
        return frozenset(t for t, hit in seen.items() if hit)

    def prepare(self, bind, seg, dseg, ctx):
        pf = seg.postings.get(self.field)
        tids = np.sort(np.asarray(
            [] if pf is None else
            [pf.terms[t] for t in bind["terms"] if t in pf.terms],
            dtype=np.int64))
        if not len(tids):
            return _row_runs([], [], dseg.device, bind["boost"])
        cut = np.flatnonzero(np.diff(tids) != 1) + 1
        offsets = np.asarray(pf.offsets, dtype=np.int64)
        return _row_runs(offsets[tids[np.r_[0, cut]]],
                         offsets[tids[np.r_[cut - 1, len(tids) - 1]] + 1],
                         dseg.device, bind["boost"])

    def eval(self, A, dims, ins):
        return _row_runs_mask(A, self.field, dims, ins)


@dataclass(frozen=True)
class ExistsPlan(Plan):
    """Docs with a value in ``field``'s doc-value column (numeric,
    ordinal, vector or geo), or (``norms``) where the field was present
    in the postings, staged on demand (``DeviceSegment.ensure_norms``:
    the f32 posting columns of a quantized segment stay unstaged)."""

    field: str = ""
    src: str = "numeric"             # numeric | ordinal | vector | geo | norms

    def arrays(self):
        return frozenset({(self.src, self.field)})

    def prepare(self, bind, seg, dseg, ctx):
        return (), (_f32(bind["boost"]),)

    def eval(self, A, dims, ins):
        (boost,) = ins
        if self.src == "norms":
            # the norms-entry analog: matches zero-token values too
            matched = A["norms"][self.field]["field_exists"]
        else:
            matched = A[self.src][self.field]["exists"]
        return _const(matched, boost)


@dataclass(frozen=True)
class MaskPlan(Plan):
    """Host-precomputed per-segment boolean mask (ids query).
    bind: {mask_fn: (seg, dseg) -> np.bool_[n_pad], boost}."""

    label: str = "ids"

    def prepare(self, bind, seg, dseg, ctx):
        mask = bind["mask_fn"](seg, dseg)
        return (), (_tensor(mask, bool, dseg.device), _f32(bind["boost"]))

    def eval(self, A, dims, ins):
        mask, boost = ins
        return _const(mask, boost)


@dataclass(frozen=True)
class ScriptScorePlan(Plan):
    """Child plan scores re-mapped by a compiled script expression
    (ScriptScoreQuery; ref index/query/functionscore + the k-NN plugin's
    script-score path).  ``program`` is a ``scripting.ScriptProgram``,
    hashable by (source, param names).  bind: {child, boost, min_score,
    params, vectors, node_keys}: ``params`` the program's
    ``param_values`` on the searcher's device, ``vectors`` each distinct
    key of its ``vector_calls`` mapped to {id(segment): f32 [n_pad]
    column}, made by the compiler's request-wide pre-pass (one K1 scores
    launch per key on CUDA), ``node_keys`` each call's key."""

    child: Plan = None
    program: object = None

    def arrays(self):
        return self.child.arrays()

    def prepare(self, bind, seg, dseg, ctx):
        from opensearch_tpu_torch.search.scripting import ScriptException

        cdims, cins = self.child.prepare(bind["child"], seg, dseg, ctx)
        n_pad, dev = dseg.n_pad, dseg.device
        ncols = []
        for f in self.program.numeric_fields:
            col = dseg.numeric.get(f)
            if col is None:
                ncols.append((torch.zeros(n_pad, dtype=torch.float32,
                                          device=dev),
                              torch.zeros(n_pad, dtype=torch.bool,
                                          device=dev)))
            else:
                # dense single-value view: min == the value for
                # single-valued fields; missing slots read 0.0
                ncols.append((torch.where(col["exists"],
                                          col["minv"].to(torch.float32), 0.0),
                              col["exists"]))
        for f in self.program.vector_fields:
            if dseg.vector.get(f) is None:
                raise ScriptException(
                    f"script references vector field [{f}] with no "
                    "vectors in this index")
        vcols = {node: bind["vectors"][key][id(seg)]
                 for node, key in bind["node_keys"].items()}
        ms = bind.get("min_score")
        return (cdims,), (cins, tuple(ncols), vcols, bind["params"],
                          _f32(bind["boost"]),
                          _f32(-np.inf if ms is None else ms))

    def dense_leaves(self, dims, ins):
        return self.child.dense_leaves(dims[0], ins[0])

    def eval(self, A, dims, ins):
        (cdims,) = dims
        cins, ncols, vcols, param_vals, boost, min_score = ins
        scores, matched = self.child.eval(A, cdims, cins)
        new = self.program.eval(
            scores, dict(zip(self.program.numeric_fields, ncols)), vcols,
            param_vals, matched.device)
        if not isinstance(new, torch.Tensor):
            new = torch.tensor(new, device=matched.device)
        new = new.broadcast_to(matched.shape).to(torch.float32) * boost
        matched = matched & (new >= min_score)
        return torch.where(matched, new, 0.0), matched


def _all_terms_present(field, bind, seg) -> bool:
    """can_match of a phrase or span: every term in the segment."""
    pf = seg.postings.get(field)
    return pf is not None and all(pf.term_id(t) >= 0 for t in bind["terms"])


def _positional_bound(self, bind, seg) -> float:
    """max_score_bound of a phrase or span: tf/(tf+norm) < 1 always
    (norm >= k1*(1-b) > 0)."""
    if not self.scored:
        return 0.0
    return float(bind["idf_sum"]) * float(bind["boost"]) * _BOUND_MARGIN


def _positional_scoring(bind) -> tuple:
    """``(idf_sum * boost, avgdl)`` of a phrase or span as Python floats
    holding float32 values: the product in float32, as the reference's
    scalar product."""
    weight = float(np.float32(bind["idf_sum"]) * np.float32(bind["boost"]))
    return weight, _f32(bind["avgdl"])


@dataclass(frozen=True)
class PositionalPlan(Plan):
    """A phrase or span leaf over one field: its ``(scores, matched)``
    come from one kernel call over every such leaf and segment of the
    request (``dense_prepass``: ``scores_auto`` over the
    ``positional_leaf`` jobs), or, evaluated without that pre-pass, from
    one call over its own segment."""

    field: str = ""
    scored: bool = True

    def arrays(self):
        return frozenset({("positions", self.field)})

    def can_match(self, bind, seg):
        # every term present
        return _all_terms_present(self.field, bind, seg)

    max_score_bound = _positional_bound

    def dense_leaves(self, dims, ins):
        return ((self, dims, ins),)

    def eval(self, A, dims, ins):
        view = A.get("dense", {}).get(id(ins))
        if view is None:
            view = self.scores_auto([self.positional_leaf(A, dims, ins)])[0]
        return view


@dataclass(frozen=True)
class PhrasePlan(PositionalPlan):
    """Exact phrase over one field (match_phrase, slop=0).  bind: {terms,
    positions, idf_sum, boost, avgdl}.  Scored by K8 on CUDA
    (``ops/phrase.py`` ``phrase_scores_auto``), over the positions
    ``DeviceSegment.ensure_positions`` stages on the first such plan."""

    scores_auto = staticmethod(phrase_ops.phrase_scores_auto)

    def prepare(self, bind, seg, dseg, ctx):
        slots = phrase_ops.phrase_slots(seg.postings.get(self.field),
                                        bind["terms"], bind["positions"])
        return (), (slots, *_positional_scoring(bind))

    def positional_leaf(self, A, dims, ins) -> phrase_ops.PositionalLeaf:
        slots, weight, avgdl = ins
        return phrase_ops.PositionalLeaf(
            A["positions"][self.field]["staged"], slots, A["live"].shape[0],
            weight, avgdl, self.scored)


@dataclass(frozen=True)
class SpanNearPlan(PositionalPlan):
    """Span/interval proximity over one field (span_near, span_first,
    intervals match — ref SpanNearQueryBuilder.java:51,
    IntervalQueryBuilder.java:43).  bind: {terms, slop, end, idf_sum,
    boost, avgdl}.  Scored by K9 on CUDA (``ops/span.py``
    ``span_scores_auto``)."""

    ordered: bool = True
    scores_auto = staticmethod(span_ops.span_scores_auto)

    def prepare(self, bind, seg, dseg, ctx):
        slots = span_ops.span_slots(seg.postings.get(self.field),
                                    bind["terms"])
        # the reference's int32 scalars
        slop, end = (int(np.asarray(bind[k]).astype(_I32))
                     for k in ("slop", "end"))
        return (), (slots, slop, end, *_positional_scoring(bind))

    def positional_leaf(self, A, dims, ins) -> phrase_ops.PositionalLeaf:
        slots, slop, end, weight, avgdl = ins
        return phrase_ops.PositionalLeaf(
            A["positions"][self.field]["staged"], slots, A["live"].shape[0],
            weight, avgdl, self.scored, self.ordered, slop, end)


def _prepare_children(children, binds, seg, dseg, ctx):
    dims, ins = [], []
    for c, b in zip(children, binds):
        d, i = c.prepare(b, seg, dseg, ctx)
        dims.append(d)
        ins.append(i)
    return tuple(dims), tuple(ins)


@dataclass(frozen=True)
class BoolPlan(Plan):
    """bind: {boost, required, children: tuple of child binds} where
    ``required`` is the resolved minimum matching should-clause count."""

    must: tuple = ()
    should: tuple = ()
    must_not: tuple = ()
    filter: tuple = ()

    def _children(self):
        return (*self.must, *self.should, *self.must_not, *self.filter)

    def can_match(self, bind, seg):
        binds = bind["children"]
        nm, ns = len(self.must), len(self.should)
        nn = len(self.must_not)
        for c, b in zip(self.must, binds[:nm]):
            if not c.can_match(b, seg):
                return False
        for c, b in zip(self.filter, binds[nm + ns + nn:]):
            if not c.can_match(b, seg):
                return False
        if ns and not self.must and not self.filter and \
                int(bind.get("required", 1)) >= 1:
            return any(c.can_match(b, seg)
                       for c, b in zip(self.should, binds[nm: nm + ns]))
        return True

    def max_score_bound(self, bind, seg):
        binds = bind["children"]
        nm, ns = len(self.must), len(self.should)
        boost = float(bind["boost"])
        if boost < 0:
            return math.inf
        total = 0.0
        for c, b in zip(self.must, binds[:nm]):
            total += c.max_score_bound(b, seg)
        for c, b in zip(self.should, binds[nm: nm + ns]):
            total += c.max_score_bound(b, seg)
        return total * boost * _BOUND_MARGIN

    def arrays(self):
        out = frozenset()
        for c in self._children():
            out |= c.arrays()
        return out

    def prepare(self, bind, seg, dseg, ctx):
        cdims, cins = _prepare_children(
            self._children(), bind["children"], seg, dseg, ctx)
        return cdims, (cins, _f32(bind["boost"]), int(bind["required"]))

    def dense_leaves(self, dims, ins):
        return tuple(leaf for c, d, i in zip(self._children(), dims, ins[0])
                     for leaf in c.dense_leaves(d, i))

    def eval(self, A, dims, ins):
        cins, boost, required = ins
        n_pad, dev = _live_n_pad(A)
        outs = [c.eval(A, dims[i], cins[i])
                for i, c in enumerate(self._children())]
        nm, ns, nn = len(self.must), len(self.should), len(self.must_not)
        matched = torch.ones(n_pad, dtype=torch.bool, device=dev)
        scores = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        for s, m in outs[:nm]:                      # must
            matched &= m
            scores += s
        for _s, m in outs[nm + ns + nn:]:           # filter
            matched &= m
        for _s, m in outs[nm + ns: nm + ns + nn]:   # must_not
            matched &= ~m
        if ns:
            cnt = torch.zeros(n_pad, dtype=torch.int32, device=dev)
            for s, m in outs[nm: nm + ns]:          # should
                cnt += m.to(torch.int32)
                scores += s
            matched &= cnt >= required
        scores = torch.where(matched, scores * boost, 0.0)
        return scores, matched


@dataclass(frozen=True)
class DisMaxPlan(Plan):
    """bind: {boost, tie_breaker, children}: the best child's score plus
    ``tie_breaker`` times the others', in the reference's order."""

    children: tuple = ()

    def arrays(self):
        out = frozenset()
        for c in self.children:
            out |= c.arrays()
        return out

    def can_match(self, bind, seg):
        return any(c.can_match(b, seg)
                   for c, b in zip(self.children, bind["children"]))

    def max_score_bound(self, bind, seg):
        boost = float(bind["boost"])
        tie = float(bind["tie_breaker"])
        if boost < 0 or tie < 0 or tie > 1:
            return math.inf
        bounds = [c.max_score_bound(b, seg)
                  for c, b in zip(self.children, bind["children"])]
        if not bounds:
            return 0.0
        best = max(bounds)
        return (best + tie * (sum(bounds) - best)) * boost * _BOUND_MARGIN

    def prepare(self, bind, seg, dseg, ctx):
        cdims, cins = _prepare_children(
            self.children, bind["children"], seg, dseg, ctx)
        return cdims, (cins, _f32(bind["boost"]), _f32(bind["tie_breaker"]))

    def dense_leaves(self, dims, ins):
        return tuple(leaf for c, d, i in zip(self.children, dims, ins[0])
                     for leaf in c.dense_leaves(d, i))

    def eval(self, A, dims, ins):
        cins, boost, tie = ins
        n_pad, dev = _live_n_pad(A)
        best = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        total = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        matched = torch.zeros(n_pad, dtype=torch.bool, device=dev)
        for i, c in enumerate(self.children):
            s, m = c.eval(A, dims[i], cins[i])
            best = torch.maximum(best, s)
            total += s
            matched |= m
        # best + tie * (total - best), one fused multiply-add in the
        # reference
        scores = fma32(tie, total - best, best)
        return torch.where(matched, scores * boost, 0.0), matched


@dataclass(frozen=True)
class ConstScorePlan(Plan):
    """bind: {boost, child}."""

    child: Optional[Plan] = None

    def arrays(self):
        return self.child.arrays()

    def can_match(self, bind, seg):
        return self.child.can_match(bind["child"], seg)

    max_score_bound = _boost_bound

    def prepare(self, bind, seg, dseg, ctx):
        cdims, cins = self.child.prepare(bind["child"], seg, dseg, ctx)
        return cdims, (cins, _f32(bind["boost"]))

    def dense_leaves(self, dims, ins):
        return self.child.dense_leaves(dims, ins[0])

    def eval(self, A, dims, ins):
        cins, boost = ins
        _s, matched = self.child.eval(A, dims, cins)
        return torch.where(matched, boost, 0.0).to(torch.float32), matched


# ---------------------------------------------------------------------------
# Nested queries: object-space plans.  A nested path's objects form their
# own padded id space (``DeviceSegment.nested_staged``); inner conditions
# evaluate [n_obj_pad] masks, scatter-ORed to objects and then to parents
# (``filter_ops.scatter_any``: ToParentBlockJoinQuery's shape).  Each
# ``prepare(bind, block, staged)`` returns the condition's tensors (None:
# matches no object) and ``eval(ins, n_obj_pad, dev)`` its object mask.
# ---------------------------------------------------------------------------


def _no_objects(n_obj_pad: int, dev):
    return torch.zeros(n_obj_pad, dtype=torch.bool, device=dev)


@dataclass(frozen=True)
class ObjTermsPlan:
    """term/terms membership over one nested child column.
    bind: {"values": [...]} (raw terms for ordinal, numbers for numeric).
    """

    field: str = ""
    kind: str = "ordinal"            # ordinal | numeric

    def prepare(self, bind, block, staged):
        from opensearch_tpu_torch.common.cache import attached_cache

        col = (staged["ordinal"] if self.kind == "ordinal"
               else staged["numeric"]).get(self.field)
        if col is None:
            return None
        dev = col["value_objs"].device
        if self.kind == "ordinal":
            cache = attached_cache(block, "_term_to_ord",
                                   name="query.term_ords",
                                   max_weight=8 << 20,
                                   breaker="fielddata")
            term_to_ord = cache.get(self.field)
            if term_to_ord is None:
                ord_terms, _ords, _objs = block.ordinal[self.field]
                term_to_ord = {t: o for o, t in enumerate(ord_terms)}
                cache.put(self.field, term_to_ord)
            wanted = [term_to_ord[t] for t in bind["values"]
                      if t in term_to_ord]
            if not wanted:
                return None
            q_pad = pad_pow2(len(wanted), minimum=1)
            return (col["ords"], col["value_objs"],
                    _tensor(_pad_np(wanted, q_pad, -2, _I32), _I32, dev))
        wanted = [float(v) for v in bind["values"]]
        q_pad = pad_pow2(len(wanted), minimum=1)
        return (col["values"], col["value_objs"],
                _tensor(_pad_np(wanted, q_pad, np.nan, np.float64),
                        np.float64, dev))

    def eval(self, ins, n_obj_pad, dev):
        if ins is None:
            return _no_objects(n_obj_pad, dev)
        vals, objs, wanted = ins
        hit = (vals[:, None] == wanted[None, :]).any(dim=1)
        return filter_ops.scatter_any(hit, objs, n_obj_pad)


@dataclass(frozen=True)
class ObjRangePlan:
    """range over a numeric nested child.  bind: {"lo", "hi"} (floats,
    inclusivity resolved into static flags)."""

    field: str = ""
    include_lo: bool = True
    include_hi: bool = True

    def prepare(self, bind, block, staged):
        col = staged["numeric"].get(self.field)
        if col is None:
            return None
        return (col["values"], col["value_objs"],
                _exact(bind["lo"], np.float64), _exact(bind["hi"], np.float64))

    def eval(self, ins, n_obj_pad, dev):
        if ins is None:
            return _no_objects(n_obj_pad, dev)
        vals, objs, lo, hi = ins
        return filter_ops.range_mask(vals, objs, lo, hi,
                                     include_lo=self.include_lo,
                                     include_hi=self.include_hi,
                                     n_pad=n_obj_pad)


@dataclass(frozen=True)
class ObjExistsPlan:
    field: str = ""

    def prepare(self, bind, block, staged):
        col = (staged["numeric"].get(self.field)
               or staged["ordinal"].get(self.field))
        if col is None:
            return None
        return (col["value_objs"],)

    def eval(self, ins, n_obj_pad, dev):
        if ins is None:
            return _no_objects(n_obj_pad, dev)
        (objs,) = ins
        # padded entries point at the dead object slot
        return filter_ops.scatter_any(objs < n_obj_pad - 1, objs, n_obj_pad)


@dataclass(frozen=True)
class ObjBoolPlan:
    must: tuple = ()
    should: tuple = ()
    must_not: tuple = ()
    # shoulds required only when nothing else constrains (the top-level
    # bool's required-resolution, compiler _c_bool)
    should_required: bool = True

    def prepare(self, bind, block, staged):
        children = (*self.must, *self.should, *self.must_not)
        return tuple(c.prepare(b, block, staged)
                     for c, b in zip(children, bind["children"]))

    def eval(self, ins, n_obj_pad, dev):
        nm, ns = len(self.must), len(self.should)
        mask = torch.ones(n_obj_pad, dtype=torch.bool, device=dev)
        for c, i in zip(self.must, ins[:nm]):
            mask &= c.eval(i, n_obj_pad, dev)
        if ns and self.should_required:
            any_should = _no_objects(n_obj_pad, dev)
            for c, i in zip(self.should, ins[nm: nm + ns]):
                any_should |= c.eval(i, n_obj_pad, dev)
            mask &= any_should
        for c, i in zip(self.must_not, ins[nm + ns:]):
            mask &= ~c.eval(i, n_obj_pad, dev)
        return mask


@dataclass(frozen=True)
class ObjMatchAllPlan:
    def prepare(self, bind, block, staged):
        return ()

    def eval(self, ins, n_obj_pad, dev):
        return torch.ones(n_obj_pad, dtype=torch.bool, device=dev)


@dataclass(frozen=True)
class NestedPlan(Plan):
    """nested query: inner object-space condition -> parent mask, scored
    the constant ``boost`` (``score_mode`` changes nothing, as in the
    reference).  bind: {"inner": inner_bind, "boost": f}."""

    path: str = ""
    inner: object = None             # Obj*Plan

    def prepare(self, bind, seg, dseg, ctx):
        block = seg.nested.get(self.path)
        staged = dseg.nested_staged(self.path)
        if block is None or staged is None:
            return ("missing",), ()
        inner_ins = self.inner.prepare(bind["inner"], block, staged)
        return (staged["n_obj_pad"],), (
            staged["obj_to_doc"], staged["obj_valid"], inner_ins,
            _f32(bind["boost"]))

    def eval(self, A, dims, ins):
        n_pad, dev = _live_n_pad(A)
        if dims[0] == "missing":
            return (torch.zeros(n_pad, dtype=torch.float32, device=dev),
                    torch.zeros(n_pad, dtype=torch.bool, device=dev))
        n_obj_pad = dims[0]
        obj_to_doc, obj_valid, inner_ins, boost = ins
        obj_mask = self.inner.eval(inner_ins, n_obj_pad, dev) & obj_valid
        return _const(filter_ops.scatter_any(obj_mask, obj_to_doc, n_pad),
                      boost)

    def can_match(self, bind, seg):
        return self.path in seg.nested


_F32_TINY = float(np.finfo(np.float32).tiny)


def _f32_ftz(x64):
    """float64 ``x64`` cast to float32 with a subnormal result flushed to
    a zero of its sign, as the reference's XLA CPU code runs (flush to
    zero)."""
    x = x64.to(torch.float32)
    return torch.where(x.abs() < _F32_TINY, x * 0.0, x)


def _nearest_value_dist(col, origin: float):
    """float64 distance from ``origin`` to the NEAREST of a doc's values:
    0 when origin lies inside [min, max], else the gap to the closer bound
    (the reference's multi-valued semantics of distance_feature and the
    decays)."""
    mn = col["minv"].to(torch.float64)
    mx = col["maxv"].to(torch.float64)
    below = torch.clamp(mn - origin, min=0.0)  # origin below the range
    above = torch.clamp(origin - mx, min=0.0)  # origin above the range
    return torch.maximum(below, above)


_EARTH_R_M = 6371008.8
_RADIANS = np.pi / 180     # jnp.radians(x) is x * (pi / 180)


def _haversine_m(lat1, lon1, lat2: float, lon2: float):
    """Great-circle distance in meters of float64 degrees ``lat1`` /
    ``lon1`` from the point (``lat2``, ``lon2``), in the reference's order
    of operations."""
    p1 = lat1 * _RADIANS
    p2 = lat2 * _RADIANS
    dp = p2 - p1
    dl = lon2 * _RADIANS - lon1 * _RADIANS
    s_p = torch.sin(dp / 2)
    s_l = torch.sin(dl / 2)
    a = s_p * s_p + torch.cos(p1) * math.cos(p2) * (s_l * s_l)
    return 2 * _EARTH_R_M * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0,
                                                                1.0)))


def _geo_nearest(g, lat: float, lon: float, n_pad: int):
    """Per doc the float64 meters from (``lat``, ``lon``) to the nearest
    of its points (+inf without one): a scatter-min of each value's
    haversine, which no order of the scatter changes."""
    d = _haversine_m(g["lats"], g["lons"], lat, lon)
    out = torch.full((n_pad,), math.inf, dtype=torch.float64,
                     device=d.device)
    return out.scatter_reduce(0, g["value_docs"].long(), d, reduce="amin")


@dataclass(frozen=True)
class BoostingPlan(Plan):
    """boosting: the positive clause's scores, demoted by
    ``negative_boost`` where the negative clause matches too
    (BoostingQueryBuilder).  bind: {boost, negative_boost, children:
    (positive bind, negative bind)}."""

    positive: Plan = None
    negative: Plan = None

    def arrays(self):
        return self.positive.arrays() | self.negative.arrays()

    def can_match(self, bind, seg):
        return self.positive.can_match(bind["children"][0], seg)

    def max_score_bound(self, bind, seg):
        boost = float(bind["boost"])
        if boost < 0:
            return math.inf
        pos = self.positive.max_score_bound(bind["children"][0], seg)
        # negative_boost is usually in [0, 1); a larger value could
        # amplify demoted docs, so bound by whichever factor is bigger
        return (pos * boost * max(1.0, float(bind["negative_boost"]))
                * _BOUND_MARGIN)

    def prepare(self, bind, seg, dseg, ctx):
        cdims, cins = _prepare_children(
            (self.positive, self.negative), bind["children"], seg, dseg,
            ctx)
        return cdims, (cins, _f32(bind["boost"]),
                       _f32(bind["negative_boost"]))

    def dense_leaves(self, dims, ins):
        return (*self.positive.dense_leaves(dims[0], ins[0][0]),
                *self.negative.dense_leaves(dims[1], ins[0][1]))

    def eval(self, A, dims, ins):
        cins, boost, negative_boost = ins
        scores, matched = self.positive.eval(A, dims[0], cins[0])
        _ns, neg = self.negative.eval(A, dims[1], cins[1])
        scores = torch.where(neg, scores * negative_boost, scores) * boost
        return torch.where(matched, scores, 0.0), matched


@dataclass(frozen=True)
class TermsSetPlan(Plan):
    """terms_set: a term bag whose required count per doc comes from a
    numeric field of the doc itself (``minimum_should_match_field``;
    TermsSetQueryBuilder).  Scores and matched-term counts come from K2's
    dense entry in scores-and-counts mode (counts only in filter
    context), over the f32 columns on every segment as in the reference,
    one launch per request (``dense_prepass``).  A doc without the field
    never matches.  bind: {terms, idfs, weights, avgdl}."""

    field: str = ""
    msm_field: str = ""
    scored: bool = True

    def arrays(self):
        return frozenset({("postings", self.field),
                          ("numeric", self.msm_field)})

    def prepare(self, bind, seg, dseg, ctx):
        """dims ``(t_pad, budget)``; ins ``(slots, impacts | None)``: the
        host slots as ``TermBagPlan``'s, then the f32 impact column
        (None in filter context)."""
        t_pad, tids, active, rows, budget = _term_slots(
            seg.postings.get(self.field), bind["terms"])
        idfs = _pad_np(bind["idfs"], t_pad, 0.0, _F32)
        weights = _pad_np(bind["weights"], t_pad, 0.0, _F32)
        impacts = (dseg.impacts(self.field, bind["avgdl"])  # quantize-ok
                   if self.scored else None)
        return (t_pad, budget), ((tids, active, idfs, weights, rows,
                                  budget), impacts)

    def dense_mode(self, dims) -> dict:
        return dict(scores=self.scored, counts=True)

    def dense_bag(self, A, dims, ins) -> bm25_ops.DenseBag:
        slots, impacts = ins
        p = A["postings"][self.field]
        return bm25_ops.DenseBag(p["offsets"], p["doc_ids"], impacts,
                                 A["live"].shape[0], *slots)

    def dense_leaves(self, dims, ins):
        return ((self, dims, ins),)

    def eval(self, A, dims, ins):
        scores, count = _dense_cols(self, A, dims, ins)
        msm = A["numeric"][self.msm_field]
        required = torch.where(msm["exists"], msm["minv"].to(torch.int64),
                               2**62)
        matched = (count.to(torch.int64) >= required) & (count > 0)
        if scores is None:
            scores = torch.zeros(count.shape, dtype=torch.float32,
                                 device=count.device)
        return torch.where(matched, scores, 0.0), matched


@dataclass(frozen=True)
class DistanceFeaturePlan(Plan):
    """distance_feature: ``boost * pivot / (pivot + distance)`` over a
    numeric / date or geo_point field, the distance to a doc's nearest
    value (DistanceFeatureQueryBuilder); a doc without the field does not
    match.  bind: {boost, pivot, origin (a number, or (lat, lon))}."""

    field: str = ""
    kind: str = "numeric"            # numeric | geo

    def arrays(self):
        group = "geo" if self.kind == "geo" else "numeric"
        return frozenset({(group, self.field)})

    def prepare(self, bind, seg, dseg, ctx):
        if self.kind == "geo":
            origin = tuple(_exact(v, np.float64) for v in bind["origin"])
        else:
            origin = _exact(bind["origin"], np.float64)
        return (), (origin, _exact(bind["pivot"], np.float64),
                    _f32(bind["boost"]))

    def eval(self, A, dims, ins):
        origin, pivot, boost = ins
        n_pad, _dev = _live_n_pad(A)
        if self.kind == "geo":
            g = A["geo"][self.field]
            dist = _geo_nearest(g, *origin, n_pad)
            exists = g["exists"]
        else:
            col = A["numeric"][self.field]
            dist = _nearest_value_dist(col, origin)
            exists = col["exists"]
        score = boost * (pivot / (pivot + dist))
        return _f32_ftz(torch.where(exists, score, 0.0)), exists


@dataclass(frozen=True)
class GeoDistancePlan(Plan):
    """geo_distance filter: any of a doc's points within ``distance_m``
    meters (haversine) of the origin.  bind: {lat, lon, distance_m,
    boost}."""

    field: str = ""

    def arrays(self):
        return frozenset({("geo", self.field)})

    def prepare(self, bind, seg, dseg, ctx):
        return (), (_exact(bind["lat"], np.float64),
                    _exact(bind["lon"], np.float64),
                    _exact(bind["distance_m"], np.float64),
                    _f32(bind["boost"]))

    def eval(self, A, dims, ins):
        lat0, lon0, dist_m, boost = ins
        g = A["geo"][self.field]
        n_pad, _dev = _live_n_pad(A)
        d = _haversine_m(g["lats"], g["lons"], lat0, lon0)
        hit = filter_ops.scatter_any(d <= dist_m, g["value_docs"], n_pad)
        return _const(hit & g["exists"], boost)


@dataclass(frozen=True)
class GeoPolygonPlan(Plan):
    """geo_polygon filter: even-odd ray casting of every point against
    the polygon's edges, values x edges (GeoPolygonQueryBuilder; planar,
    as the reference's legacy path).  The vertices are padded to
    ``pad_pow2(n, minimum=4)`` by repeating the last one: a zero-length
    edge never crosses.  bind: {lats, lons, boost}."""

    field: str = ""

    def arrays(self):
        return frozenset({("geo", self.field)})

    def prepare(self, bind, seg, dseg, ctx):
        lats = np.asarray(bind["lats"], np.float64)
        lons = np.asarray(bind["lons"], np.float64)
        v_pad = pad_pow2(len(lats), minimum=4)
        plats = _pad_np(lats, v_pad, lats[-1], np.float64)
        plons = _pad_np(lons, v_pad, lons[-1], np.float64)
        # each edge's (i, j = i + 1) ends, the last closing the ring
        dev = dseg.device
        edges = np.stack([plats, plons, np.roll(plats, -1),
                          np.roll(plons, -1)])
        return (v_pad,), (_tensor(edges, np.float64, dev),
                          _f32(bind["boost"]))

    def eval(self, A, dims, ins):
        edges, boost = ins
        g = A["geo"][self.field]
        n_pad, _dev = _live_n_pad(A)
        y = g["lats"][:, None]                  # [V, 1]
        x = g["lons"][:, None]
        yi, xi, yj, xj = (e[None, :] for e in edges)   # [1, E]
        straddles = (yi > y) != (yj > y)
        # safe where straddles is False (the denominator can be 0 there)
        dy = yj - yi
        t = torch.where(straddles,
                        (y - yi) / torch.where(dy == 0, 1.0, dy), 0.0)
        crosses = straddles & (x < xi + t * (xj - xi))
        inside = (crosses.sum(dim=1) % 2) == 1
        hit = filter_ops.scatter_any(inside, g["value_docs"], n_pad)
        return _const(hit & g["exists"], boost)


@dataclass(frozen=True)
class GeoBoxPlan(Plan):
    """geo_bounding_box filter (no dateline wrap).  bind: {top, left,
    bottom, right, boost}."""

    field: str = ""

    def arrays(self):
        return frozenset({("geo", self.field)})

    def prepare(self, bind, seg, dseg, ctx):
        return (), tuple(_exact(bind[k], np.float64)
                         for k in ("top", "left", "bottom", "right")) + (
            _f32(bind["boost"]),)

    def eval(self, A, dims, ins):
        top, left, bottom, right, boost = ins
        g = A["geo"][self.field]
        n_pad, _dev = _live_n_pad(A)
        lats, lons = g["lats"], g["lons"]
        inside = ((lats <= top) & (lats >= bottom)
                  & (lons >= left) & (lons <= right))
        hit = filter_ops.scatter_any(inside, g["value_docs"], n_pad)
        return _const(hit & g["exists"], boost)


@dataclass(frozen=True)
class FunctionSpec:
    """One function_score function: static structure only; its parameters
    ride the bind tree."""

    kind: str = "weight"      # weight | field_value_factor | random_score
    #                           | script_score | decay
    filter: Optional[Plan] = None
    field: str = ""           # field_value_factor / decay target
    modifier: str = "none"    # field_value_factor modifier
    decay_fn: str = "gauss"   # gauss | exp | linear
    geo: bool = False         # decay over a geo_point field
    program: object = None    # scripting.ScriptProgram for script_score


_U32 = 0xFFFFFFFF


def _u32_of_f64(x: float) -> int:
    """XLA's float64 -> uint32 conversion on the CPU: truncation toward
    zero, saturated to [0, 2^32 - 1] (NaN to 0)."""
    if math.isnan(x):
        return 0
    if x >= _U32:
        return _U32
    return max(0, math.trunc(x))


def _random_unit(seed: int, n_pad: int, device):
    """``random_score``'s float64 values in [0, 1) of slots 0..n_pad-1:
    the reference's uint32 multiply-xorshift hash, its wrapping uint32
    products made in int64 and masked to 32 bits."""
    x = torch.arange(n_pad, dtype=torch.int64, device=device)
    x = (x * 2654435761 + seed) & _U32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _U32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & _U32
    x = x ^ (x >> 16)
    return x.to(torch.float64) / float(2**32)


def _fvf_modified(v, modifier: str):
    """A field_value_factor modifier over float64 ``v``, the reference's
    ten (an unknown one leaves ``v`` as it is, as there)."""
    if modifier == "log":
        return torch.log10(torch.clamp(v, min=1e-12))
    if modifier == "log1p":
        return torch.log10(1.0 + torch.clamp(v, min=0.0))
    if modifier == "log2p":
        return torch.log10(2.0 + torch.clamp(v, min=0.0))
    if modifier == "ln":
        return torch.log(torch.clamp(v, min=1e-12))
    if modifier == "ln1p":
        return torch.log1p(torch.clamp(v, min=0.0))
    if modifier == "ln2p":
        return torch.log(2.0 + torch.clamp(v, min=0.0))
    if modifier == "sqrt":
        return torch.sqrt(torch.clamp(v, min=0.0))
    if modifier == "square":
        return v * v
    if modifier == "reciprocal":
        return 1.0 / torch.where(v == 0, 1e-12, v)
    return v


def _decayed(decay_fn: str, eff, scale: float, decay: float):
    """gauss / exp / linear decay of float64 distances ``eff`` (past the
    offset), the reference's float64 formulas."""
    if decay_fn == "gauss":
        sigma2 = -(scale * scale) / (2.0 * math.log(decay))
        return torch.exp(-(eff * eff) / (2.0 * sigma2))
    if decay_fn == "exp":
        return torch.exp((math.log(decay) / scale) * eff)
    s = scale / (1.0 - decay)
    return torch.clamp((s - eff) / s, min=0.0)


@dataclass(frozen=True)
class FunctionScorePlan(Plan):
    """function_score (FunctionScoreQueryBuilder and functionscore/): the
    child's scores combined with per-doc function factors, in float64:
    ``weight``, ``field_value_factor`` (ten modifiers), ``random_score``
    (a hash of the slot and the seed plus the segment's salt, not a
    draw), ``script_score`` (a compiled score script; its vector
    functions are the compiler's request-wide K1 pre-pass, as
    ``ScriptScorePlan``'s) and the gauss / exp / linear decays over
    numeric, date and geo_point fields; every ``score_mode`` and
    ``boost_mode``, ``max_boost`` and ``min_score``.  bind: {boost,
    child, functions (per function {filter, weight, ...params}),
    max_boost, min_score}."""

    child: Plan = None
    functions: tuple = ()              # tuple[FunctionSpec]
    score_mode: str = "multiply"       # multiply|sum|avg|first|max|min
    boost_mode: str = "multiply"       # multiply|replace|sum|avg|max|min

    def arrays(self):
        out = self.child.arrays()
        for f in self.functions:
            if f.filter is not None:
                out |= f.filter.arrays()
            if f.kind in ("field_value_factor", "decay"):
                out |= frozenset({("geo" if f.geo else "numeric", f.field)})
        return out

    # each function kind's parameters, in the reference's order (weight
    # last: the weighted average reads it there)
    _PARAM_ORDER = {
        "weight": ("weight",),
        "field_value_factor": ("factor", "missing", "weight"),
        "random_score": ("seed", "salt", "weight"),
        "script_score": ("weight",),
        "decay": ("origin", "scale", "offset", "decay", "weight"),
        "decay_geo": ("origin_lat", "origin_lon", "scale", "offset",
                      "decay", "weight"),
    }
    _PARAM_DEFAULTS = {"weight": 1.0, "factor": 1.0, "missing": 1.0,
                       "seed": 0.0, "salt": 0.0, "offset": 0.0,
                       "decay": 0.5}

    def _params(self, spec, fb) -> dict:
        key = "decay_geo" if spec.kind == "decay" and spec.geo else spec.kind
        return {name: float(np.float64(
            fb.get(name, self._PARAM_DEFAULTS.get(name, 0.0))))
            for name in self._PARAM_ORDER[key]}

    def prepare(self, bind, seg, dseg, ctx):
        """dims ``(child dims, per function its filter's dims or ())``;
        ins ``(child ins, per function (filter ins | None, params,
        extra), boost, max_boost, min_score)``: ``extra`` the random
        seed's uint32 or a script's inputs on this segment."""
        cdims, cins = self.child.prepare(bind["child"], seg, dseg, ctx)
        fdims, fins = [], []
        for spec, fb in zip(self.functions, bind["functions"]):
            fd, fi = (), None
            if spec.filter is not None:
                fd, fi = spec.filter.prepare(fb["filter"], seg, dseg, ctx)
            params = self._params(spec, fb)
            extra = None
            if spec.kind == "random_score":
                # a per-segment salt, so random_score differs across
                # segments; the sum in float64, as the reference's
                salt = float(zlib.crc32(seg.seg_id.encode()))
                extra = _u32_of_f64(params["seed"] + salt)
            elif spec.kind == "script_score":
                extra = _script_inputs(spec.program, fb, seg, dseg)
            fdims.append(fd)
            fins.append((fi, params, extra))
        ms, mb = bind.get("min_score"), bind.get("max_boost")
        return (cdims, tuple(fdims)), (
            cins, tuple(fins), _f32(bind["boost"]),
            _exact(np.inf if mb is None else mb, np.float64),
            _f32(-np.inf if ms is None else ms))

    def dense_leaves(self, dims, ins):
        cdims, fdims = dims
        out = list(self.child.dense_leaves(cdims, ins[0]))
        for spec, fd, (fi, _p, _x) in zip(self.functions, fdims, ins[1]):
            if spec.filter is not None:
                out.extend(spec.filter.dense_leaves(fd, fi))
        return tuple(out)

    def _factor(self, spec, A, fdim, fin, n_pad, child_scores):
        """(float64 value [n_pad], applicable bool [n_pad]) of one
        function."""
        fi, params, extra = fin
        dev = child_scores.device
        if spec.kind == "weight":
            value = torch.full((n_pad,), params["weight"],
                               dtype=torch.float64, device=dev)
        elif spec.kind == "field_value_factor":
            col = A["numeric"][spec.field]
            v = torch.where(col["exists"], col["minv"].to(torch.float64),
                            params["missing"])
            v = _fvf_modified(v * params["factor"], spec.modifier)
            value = v * params["weight"]
        elif spec.kind == "random_score":
            value = _random_unit(extra, n_pad, dev) * params["weight"]
        elif spec.kind == "script_score":
            ncols, vcols, param_vals = extra
            new = spec.program.eval(child_scores,
                                    dict(zip(spec.program.numeric_fields,
                                             ncols)),
                                    vcols, param_vals, dev)
            if not isinstance(new, torch.Tensor):
                new = torch.tensor(new, device=dev)
            value = (new.to(torch.float64) * params["weight"]).broadcast_to(
                (n_pad,))
        else:                                          # decay
            if spec.geo:
                g = A["geo"][spec.field]
                dist = _geo_nearest(g, params["origin_lat"],
                                    params["origin_lon"], n_pad)
                exists = g["exists"]
            else:
                col = A["numeric"][spec.field]
                dist = _nearest_value_dist(col, params["origin"])
                exists = col["exists"]
            # a doc without the field: distance 0, factor 1
            dist = torch.where(exists, dist, 0.0)
            eff = torch.clamp(dist - params["offset"], min=0.0)
            value = _decayed(spec.decay_fn, eff, params["scale"],
                             params["decay"]) * params["weight"]
        if spec.filter is None:
            applicable = torch.ones(n_pad, dtype=torch.bool, device=dev)
        else:
            _fs, applicable = spec.filter.eval(A, fdim, fi)
        return value, applicable

    def _combined(self, values, apps, fins, n_pad, dev):
        """The functions' factor per doc by ``score_mode`` (1 where none
        applies)."""
        f64 = dict(dtype=torch.float64, device=dev)
        mode = self.score_mode
        if mode == "multiply":
            factor = torch.ones(n_pad, **f64)
            for v, a in zip(values, apps):
                factor = factor * torch.where(a, v, 1.0)
        elif mode == "sum":
            factor = torch.zeros(n_pad, **f64)
            for v, a in zip(values, apps):
                factor = factor + torch.where(a, v, 0.0)
        elif mode == "avg":
            # WEIGHTED average: the values carry their weight already, so
            # divide by the applicable weights, not by the count
            tot = torch.zeros(n_pad, **f64)
            wsum = torch.zeros(n_pad, **f64)
            for v, a, (_fi, params, _x) in zip(values, apps, fins):
                tot = tot + torch.where(a, v, 0.0)
                wsum = wsum + torch.where(
                    a, torch.full_like(wsum, params["weight"]), 0.0)
            factor = tot / torch.clamp(wsum, min=1e-12)
        elif mode == "max":
            factor = torch.full((n_pad,), -math.inf, **f64)
            for v, a in zip(values, apps):
                factor = torch.maximum(factor, torch.where(a, v, -math.inf))
        elif mode == "min":
            factor = torch.full((n_pad,), math.inf, **f64)
            for v, a in zip(values, apps):
                factor = torch.minimum(factor, torch.where(a, v, math.inf))
        else:                                          # first
            factor = torch.zeros(n_pad, **f64)
            assigned = torch.zeros(n_pad, dtype=torch.bool, device=dev)
            for v, a in zip(values, apps):
                factor = torch.where(a & ~assigned, v, factor)
                assigned = assigned | a
        any_app = apps[0]
        for a in apps[1:]:
            any_app = any_app | a
        return torch.where(any_app, factor, 1.0)

    def eval(self, A, dims, ins):
        cdims, fdims = dims
        cins, fins, boost, max_boost, min_score = ins
        scores, matched = self.child.eval(A, cdims, cins)
        n_pad, dev = _live_n_pad(A)
        s64 = scores.to(torch.float64)
        if self.functions:
            values, apps = [], []
            for spec, fd, fi in zip(self.functions, fdims, fins):
                v, a = self._factor(spec, A, fd, fi, n_pad, scores)
                values.append(v)
                apps.append(a)
            factor = self._combined(values, apps, fins, n_pad, dev)
        else:
            factor = torch.ones(n_pad, dtype=torch.float64, device=dev)
        if max_boost < math.inf:
            factor = torch.clamp(factor, max=max_boost)
        mode = self.boost_mode
        if mode == "multiply":
            out = s64 * factor
        elif mode == "replace":
            out = factor
        elif mode == "sum":
            out = s64 + factor
        elif mode == "avg":
            out = (s64 + factor) / 2.0
        elif mode == "max":
            out = torch.maximum(s64, factor)
        else:                                          # min
            out = torch.minimum(s64, factor)
        out = _f32_ftz(out * boost)
        matched = matched & (out >= min_score)
        return torch.where(matched, out, 0.0), matched


def _script_inputs(program, fb, seg, dseg) -> tuple:
    """A script function's inputs on one segment: ``(numeric columns,
    vector columns {id(call node): f32 [n_pad]}, param values)``, the
    numeric ones as ``ScriptScorePlan.prepare`` makes them, the vector
    ones the compiler's pre-pass views of this segment."""
    n_pad, dev = dseg.n_pad, dseg.device
    ncols = []
    for f in program.numeric_fields:
        col = dseg.numeric.get(f)
        if col is None:
            ncols.append((torch.zeros(n_pad, dtype=torch.float32,
                                      device=dev),
                          torch.zeros(n_pad, dtype=torch.bool, device=dev)))
        else:
            ncols.append((torch.where(col["exists"],
                                      col["minv"].to(torch.float32), 0.0),
                          col["exists"]))
    vcols = {node: fb["vectors"][key][id(seg)]
             for node, key in fb["node_keys"].items()}
    return tuple(ncols), vcols, fb["params"]


# constant-score leaves: the boost is the only score they can produce, so
# it IS the bound (the reference registers the same)
for _cls in (ExpandTermsPlan, GeoDistancePlan, GeoPolygonPlan, GeoBoxPlan):
    _cls.max_score_bound = _boost_bound
del _cls


def _edit_distance_le(a: str, b: str, k: int) -> bool:
    """Banded optimal-string-alignment distance (Levenshtein WITH
    transpositions: Lucene's fuzzy default, fuzzy_transpositions=true):
    True iff distance(a, b) <= k."""
    if abs(len(a) - len(b)) > k:
        return False
    if k == 0:
        return a == b
    prev2 = None
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        lo = max(1, i - k)
        hi = min(len(b), i + k)
        if lo > 1:
            cur[lo - 1] = k + 1
        for j in range(lo, hi + 1):
            cost = 0 if ca == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
            if (prev2 is not None and i > 1 and j > 1
                    and ca == b[j - 2] and a[i - 2] == b[j - 1]):
                cur[j] = min(cur[j], prev2[j - 2] + 1)   # transposition
        for j in range(hi + 1, len(b) + 1):
            cur[j] = k + 1
        prev2, prev = prev, cur
        if min(prev) > k:
            return False
    return prev[len(b)] <= k


# ---------------------------------------------------------------------------
# Entry points (the reference's jit entry points, run eagerly).
# ---------------------------------------------------------------------------


def run_full(plan: Plan, dims, A, ins, min_score):
    """(scores[n_pad] zeroed-unmatched, matched[n_pad]) — for counts and
    the knn filter."""
    scores, matched = plan.eval(A, dims, ins)
    matched = matched & A["live"] & (scores >= min_score)
    return torch.where(matched, scores, 0.0), matched
