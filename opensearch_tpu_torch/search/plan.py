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
request evaluates (one launch per row layout on CUDA) and leaves each
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
take their per-doc frequencies from K8 / K9 (``ops/phrase.py``,
``ops/span.py``: one launch per segment on CUDA); ``DisMaxPlan`` combines
its children as the reference does.  Plans of the reference that are not
ported yet (expand-terms, nested, geo, function_score, ...) are absent;
the compiler raises ``NotYetPortedError`` for queries that would need
them.
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from opensearch_tpu_torch.common import torchenv  # noqa: F401
from opensearch_tpu_torch.index.segment import (LONG_MISSING_MAX,
                                                pad_bucket, pad_pow2)
from opensearch_tpu_torch.ops import bm25 as bm25_ops
from opensearch_tpu_torch.ops import filters as filter_ops
from opensearch_tpu_torch.ops import phrase as phrase_ops
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
    """Launch every term-bag leaf of ``plan`` once over the segments of
    ``items`` (``(A, dims, ins)`` per segment, as the caller prepared
    them): one ``term_bag_dense_auto`` call per leaf, one launch per row
    layout on CUDA.  Each segment's views go to its ``A["dense"]``, keyed
    by the id of the leaf's inputs, which the caller holds for the
    request: nothing enters the prepared inputs or the bindings, which the
    searcher caches across requests."""
    if not items:
        return
    walks = [list(plan.dense_leaves(dims, ins)) for _A, dims, ins in items]
    for j, (leaf, dims0, _ins0) in enumerate(walks[0]):
        bags = [leaf.dense_bag(A, w[j][1], w[j][2])
                for (A, _d, _i), w in zip(items, walks)]
        cols = bm25_ops.term_bag_dense_auto(bags, **leaf.dense_mode(dims0))
        for (A, _d, _i), w, c in zip(items, walks, cols):
            A.setdefault("dense", {})[id(w[j][2])] = c


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
        """``(leaf, dims, ins)`` of every term-bag leaf under this plan, in
        a fixed order (the same on every segment): what ``dense_prepass``
        launches.  Composites walk their children's prepared inputs."""
        return ()


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
    """Precomputed per-segment (scores, matched) — knn pre-pass results
    are injected into the tree through this node.
    bind: {fn: (seg, dseg) -> (scores np.f32 [n_pad], mask np.bool)}."""

    label: str = "knn"

    def prepare(self, bind, seg, dseg, ctx):
        scores, mask = bind["fn"](seg, dseg)
        return (), (_tensor(scores, _F32, dseg.device),
                    _tensor(mask, bool, dseg.device))

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


@dataclass(frozen=True)
class TermRangeMaskPlan(Plan):
    """Constant-score docs containing any term in a CONTIGUOUS term-id
    range — a prefix is a range of the sorted term dict (Lucene
    PrefixQuery's automaton walk collapses to two binary searches).
    bind: {lo, hi, boost} (string bounds, [lo, hi)).  The range's
    posting bounds come from the host CSR, so no offset is read back."""

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
        return ((pad_bucket(o_hi - o_lo),),
                (o_lo, o_hi, _f32(bind["boost"])))

    def eval(self, A, dims, ins):
        (budget,) = dims
        o_lo, o_hi, boost = ins
        p = A["postings"][self.field]
        n_pad, dev = _live_n_pad(A)
        i = torch.arange(budget, dtype=torch.int64, device=dev)
        valid = i < (o_hi - o_lo)
        idx = torch.where(valid, o_lo + i, 0)
        d = torch.where(valid, p["doc_ids"][idx],
                        torch.full_like(idx, n_pad - 1, dtype=torch.int32))
        return _const(filter_ops.scatter_any(valid, d, n_pad), boost)


@dataclass(frozen=True)
class ExistsPlan(Plan):
    """Docs with a value in ``field``'s doc-value column, or (``norms``)
    where the field was present in the postings, staged on demand
    (``DeviceSegment.ensure_norms``: the f32 posting columns of a
    quantized segment stay unstaged)."""

    field: str = ""
    src: str = "numeric"             # numeric | ordinal | vector | norms

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


def fma32(a: float, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as the reference's XLA code
    computes it (its CPU compiler contracts a product that feeds an add
    into one fused multiply-add).  ``a`` is a Python float holding a
    float32 value, ``b`` and ``c`` float32 tensors.  The product of two
    float32 values is exact in float64; the float64 sum is made
    round-to-odd from its exact error (Knuth's two-sum), so the one
    rounding to float32 that follows is the fused operation's."""
    p = b.double() * a
    c64 = c.double()
    s = p + c64
    bv = s - c64
    err = (p - bv) + (c64 - (s - bv))
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


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


def _positional_scoring(bind, dev) -> tuple:
    """``(idf_sum * boost, avgdl)`` of a phrase or span: the product in
    float32, as the reference's scalar product, and avgdl a float32 0-d
    tensor on ``dev`` (a CUDA division by a host scalar multiplies by its
    reciprocal, which rounds differently)."""
    weight = float(np.float32(bind["idf_sum"]) * np.float32(bind["boost"]))
    return weight, torch.tensor(_f32(bind["avgdl"]), dtype=torch.float32,
                                device=dev)


def _positional_scores(tf, p, scored, weight, avgdl):
    """``(scores, matched)`` of a phrase or span from its per-doc ``tf``:
    ``idf_sum * boost * tf / (tf + norm)``, ``norm = k1 * (1 - b + b * dl /
    avgdl)``, in the reference's float32 order."""
    matched = tf > 0
    if not scored:
        return torch.zeros_like(tf), matched
    dl = p["doc_lens"]
    inner = 1.0 - bm25_ops.B_DEFAULT + bm25_ops.B_DEFAULT * dl / avgdl
    # tf + k1 * inner, one fused multiply-add in the reference
    scores = weight * tf / fma32(_f32(bm25_ops.K1_DEFAULT), inner, tf)
    return torch.where(matched, scores, 0.0), matched


@dataclass(frozen=True)
class PhrasePlan(Plan):
    """Exact phrase over one field (match_phrase, slop=0).  bind: {terms,
    positions, idf_sum, boost, avgdl}.  The per-doc frequency is K8's on
    CUDA (``ops/phrase.py`` ``phrase_freqs_auto``: one launch per segment),
    over the positions ``DeviceSegment.ensure_positions`` stages on the
    first such plan."""

    field: str = ""
    scored: bool = True

    def arrays(self):
        return frozenset({("positions", self.field)})

    def can_match(self, bind, seg):
        # an exact phrase needs EVERY term present
        return _all_terms_present(self.field, bind, seg)

    max_score_bound = _positional_bound

    def prepare(self, bind, seg, dseg, ctx):
        slots = phrase_ops.phrase_slots(seg.postings.get(self.field),
                                        bind["terms"], bind["positions"])
        return (), (slots, *_positional_scoring(bind, dseg.device))

    def eval(self, A, dims, ins):
        slots, weight, avgdl = ins
        p = A["positions"][self.field]
        tf = phrase_ops.phrase_freqs_auto(p, slots, A["live"].shape[0])
        return _positional_scores(tf, p, self.scored, weight, avgdl)


@dataclass(frozen=True)
class SpanNearPlan(Plan):
    """Span/interval proximity over one field (span_near, span_first,
    intervals match — ref SpanNearQueryBuilder.java:51,
    IntervalQueryBuilder.java:43).  bind: {terms, slop, end, idf_sum,
    boost, avgdl}.  The per-doc frequency is K9's on CUDA (``ops/span.py``
    ``span_near_freqs_auto``: one launch per segment)."""

    field: str = ""
    ordered: bool = True
    scored: bool = True

    def arrays(self):
        return frozenset({("positions", self.field)})

    def can_match(self, bind, seg):
        return _all_terms_present(self.field, bind, seg)

    max_score_bound = _positional_bound

    def prepare(self, bind, seg, dseg, ctx):
        slots = span_ops.span_slots(seg.postings.get(self.field),
                                    bind["terms"])
        # the reference's int32 scalars
        slop, end = (int(np.asarray(bind[k]).astype(_I32))
                     for k in ("slop", "end"))
        return (), (slots, slop, end,
                    *_positional_scoring(bind, dseg.device))

    def eval(self, A, dims, ins):
        slots, slop, end, weight, avgdl = ins
        p = A["positions"][self.field]
        tf = span_ops.span_near_freqs_auto(
            p, slots, A["live"].shape[0], ordered=self.ordered, slop=slop,
            end=end)
        return _positional_scores(tf, p, self.scored, weight, avgdl)


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
# Entry points (the reference's jit entry points, run eagerly).
# ---------------------------------------------------------------------------


def run_full(plan: Plan, dims, A, ins, min_score):
    """(scores[n_pad] zeroed-unmatched, matched[n_pad]) — for counts and
    the knn filter."""
    scores, matched = plan.eval(A, dims, ins)
    matched = matched & A["live"] & (scores >= min_score)
    return torch.where(matched, scores, 0.0), matched
