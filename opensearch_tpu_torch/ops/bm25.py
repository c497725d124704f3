"""BM25 scoring over precomputed impacts, on torch tensors (the port of
the JAX package's ``ops/bm25.py``).

Each function here is a plain PyTorch version of the reference's jnp
function, with the same float32 operation order, so that on the CPU it
equals the reference byte for byte.  ``impact_scores``,
``impact_score_count`` and ``match_count`` are also the wrappers of the
hand-written term-bag kernel's per-slot entry (K2, ``csrc/bm25.cu``):
given CUDA tensors they launch it (``ops/cuda_bm25.py``) or raise; given
CPU tensors they run the plain version.  The plain versions stay
callable on any device as ``*_plain`` so the kernel can be held against
them on the card.

``term_bag_topk_segments`` is the plain version of K2's top-k entry: a
scored bag's top-k, matched total and max on every segment of a shard
(the reference's ``run_topk`` over a ``TermBagPlan``, segment by
segment); ``term_bag_topk_segments_auto``, which the executor calls,
launches the kernel once for all segments on CUDA (once per row layout:
f32, int8 or int16 quantized, K4) and runs the plain version on the CPU.
A quantized segment is scored through ``ops/quantized.py``.

Accumulation order: per doc, contributions add in query-term SLOT order
starting from 0.0, each one ``w * (idf * imp)`` — the order of the
reference's in-order scatter-add over slot-major gather lanes.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from opensearch_tpu_torch.common import torchenv  # noqa: F401

K1_DEFAULT = 1.2
B_DEFAULT = 0.75


def idf(df: int, n_docs: int) -> float:
    """Lucene BM25Similarity idf: ln(1 + (N - df + 0.5) / (df + 0.5))."""
    return math.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))


def compute_impacts(tfs, doc_ids, doc_lens, avgdl, *,
                    k1: float = K1_DEFAULT, b: float = B_DEFAULT):
    """Per-posting BM25 impact ``tf / (tf + k1*(1-b + b*dl/avgdl))``,
    float32 end to end in the reference's operation order.  ``avgdl``
    is a float32 scalar (tensor or number)."""
    avgdl = torch.as_tensor(avgdl, dtype=torch.float32,
                            device=tfs.device)
    dl = doc_lens[doc_ids.long()]
    norm = k1 * (1.0 - b + b * dl / avgdl)
    return tfs / (tfs + norm)


def flatten_rows(offsets, term_ids, term_active, *, budget: int):
    """Lay the CSR rows of up to T terms end to end into ``budget`` lanes
    (cumsum + searchsorted), as the reference's gathers do.  Returns
    (idx[B] i32, slot[B] i32, valid[B] bool): each lane's flat posting
    index (0 past the rows) and the index into ``term_ids`` that
    produced it.  The caller must choose ``budget >= sum(df[term_ids])``."""
    tids = term_ids.long()
    starts = offsets[tids]
    lens = torch.where(term_active, offsets[tids + 1] - starts,
                       torch.zeros_like(starts))
    cum = torch.cumsum(lens, 0, dtype=torch.int32)
    total = cum[-1]
    i = torch.arange(budget, dtype=torch.int32, device=offsets.device)
    slot = torch.searchsorted(cum, i, right=True, out_int32=True)
    slot = torch.clamp(slot, max=term_ids.shape[0] - 1)
    slot_l = slot.long()
    prev = torch.where(slot > 0, cum[(slot_l - 1).clamp(min=0)],
                       torch.zeros_like(slot))
    valid = i < total
    idx = torch.where(valid, starts[slot_l] + i - prev,
                      torch.zeros_like(i))
    return idx, slot, valid


def gather_postings(offsets, doc_ids, tfs, term_ids, term_active, *,
                    budget: int, pad_doc: int):
    """Flatten the postings of up to T terms into ``budget`` lanes
    (``flatten_rows``), as the reference does.

    Returns (docs[B] i32, tfs[B], slot[B] i32, valid[B] bool): ``slot``
    is the index into ``term_ids`` that produced each lane.  The caller
    must choose ``budget >= sum(df[term_ids])``."""
    idx, slot, valid = flatten_rows(offsets, term_ids, term_active,
                                    budget=budget)
    d = torch.where(valid, doc_ids[idx.long()],
                    torch.full_like(idx, pad_doc))
    tf = torch.where(valid, tfs[idx.long()],
                     torch.zeros((), dtype=tfs.dtype, device=tfs.device))
    return d, tf, slot, valid


def scatter_in_slot_order(n_pad: int, d, slot, valid, contrib, t_pad: int,
                          dtype):
    """``zeros(n_pad).at[d].add(contrib)`` with the reference's in-order
    semantics: lanes are slot-major and a doc occurs at most once per
    slot, so adding slot by slot reproduces the per-doc order exactly
    (``index_put_(accumulate=True)`` promises no order)."""
    out = torch.zeros(n_pad, dtype=dtype, device=d.device)
    for s in range(t_pad):
        sel = valid & (slot == s)
        ds = d[sel].long()
        out[ds] = out[ds] + contrib[sel]
    return out


def impact_scores_plain(offsets, doc_ids, impacts, term_ids, term_active,
                        idfs, weights, *, n_pad: int, budget: int):
    """Plain version of K2's scores-only mode (the reference's
    ``impact_scores``)."""
    d, imp, slot, valid = gather_postings(
        offsets, doc_ids, impacts, term_ids, term_active,
        budget=budget, pad_doc=n_pad - 1)
    slot_l = slot.long()
    contrib = weights[slot_l] * (idfs[slot_l] * imp)
    return scatter_in_slot_order(n_pad, d, slot, valid, contrib,
                                 term_ids.shape[0], torch.float32)


def impact_score_count_plain(offsets, doc_ids, impacts, term_ids,
                             term_active, idfs, weights, *, n_pad: int,
                             budget: int, scored: bool):
    """Plain version of K2's scores-and-counts mode (the reference's
    ``impact_score_count``)."""
    d, imp, slot, valid = gather_postings(
        offsets, doc_ids, impacts, term_ids, term_active,
        budget=budget, pad_doc=n_pad - 1)
    t_pad = term_ids.shape[0]
    ones = torch.ones_like(d)
    count = scatter_in_slot_order(n_pad, d, slot, valid, ones, t_pad,
                                  torch.int32)
    if not scored:
        return torch.zeros(n_pad, dtype=torch.float32,
                           device=d.device), count
    slot_l = slot.long()
    contrib = weights[slot_l] * (idfs[slot_l] * imp)
    scores = scatter_in_slot_order(n_pad, d, slot, valid, contrib, t_pad,
                                   torch.float32)
    return scores, count


def match_count_plain(offsets, doc_ids, tfs, term_ids, term_active, *,
                      n_pad: int, budget: int):
    """Plain version of K2's counts-only mode (the reference's
    ``match_count``): per-doc count of distinct matched query terms."""
    d, _tf, slot, valid = gather_postings(
        offsets, doc_ids, tfs, term_ids, term_active,
        budget=budget, pad_doc=n_pad - 1)
    return scatter_in_slot_order(n_pad, d, slot, valid,
                                 torch.ones_like(d), term_ids.shape[0],
                                 torch.int32)


def impact_scores(offsets, doc_ids, impacts, term_ids, term_active,
                  idfs, weights, *, n_pad: int, budget: int):
    """Dense per-doc BM25 scores from precomputed impacts.  CUDA
    tensors launch K2; CPU tensors take the plain version."""
    if offsets.is_cuda:
        from opensearch_tpu_torch.ops import cuda_bm25
        scores, _count = cuda_bm25.term_bag_cuda(
            offsets, doc_ids, impacts, term_ids, term_active, idfs,
            weights, n_pad=n_pad, budget=budget, scores=True,
            counts=False)
        return scores
    return impact_scores_plain(offsets, doc_ids, impacts, term_ids,
                               term_active, idfs, weights, n_pad=n_pad,
                               budget=budget)


def impact_score_count(offsets, doc_ids, impacts, term_ids, term_active,
                       idfs, weights, *, n_pad: int, budget: int,
                       scored: bool):
    """Scores and matched-slot counts (AND / minimum_should_match).
    With ``scored=False`` only the counts are computed.  CUDA tensors
    launch K2; CPU tensors take the plain version."""
    if offsets.is_cuda:
        from opensearch_tpu_torch.ops import cuda_bm25
        scores, count = cuda_bm25.term_bag_cuda(
            offsets, doc_ids, impacts, term_ids, term_active, idfs,
            weights, n_pad=n_pad, budget=budget, scores=scored,
            counts=True)
        if scores is None:
            scores = torch.zeros(n_pad, dtype=torch.float32,
                                 device=offsets.device)
        return scores, count
    return impact_score_count_plain(
        offsets, doc_ids, impacts, term_ids, term_active, idfs, weights,
        n_pad=n_pad, budget=budget, scored=scored)


def match_count(offsets, doc_ids, tfs, term_ids, term_active, *,
                n_pad: int, budget: int):
    """Per-doc count of distinct matched query terms (filter context).
    CUDA tensors launch K2 in counts-only mode; CPU tensors take the
    plain version."""
    if offsets.is_cuda:
        from opensearch_tpu_torch.ops import cuda_bm25
        _s, count = cuda_bm25.term_bag_cuda(
            offsets, doc_ids, None, term_ids, term_active, None, None,
            n_pad=n_pad, budget=budget, scores=False, counts=True)
        return count
    return match_count_plain(offsets, doc_ids, tfs, term_ids, term_active,
                             n_pad=n_pad, budget=budget)


def topk(scores, k: int):
    """Top-k by score with the reference's tie-break (``lax.top_k``:
    equal scores -> LOWER index first): a stable descending sort.
    ``torch.topk`` promises no order among ties on CUDA."""
    vals, idx = torch.sort(scores, descending=True, stable=True)
    return vals[:k], idx[:k].to(torch.int32)


# -- a scored bag's top-k over every segment (K2's top-k entry) -----------

class QuantizedBag(NamedTuple):
    """The quantized part of a ``TermBagSegment`` on a segment that
    ``index/codec.py`` lowers: the six tables as
    ``DeviceSegment.quantized`` stages them (the qvals' dtype, int8 or
    int16, names the layout), the segment's delta width, and per slot
    its term's base, scale and exact range on the host (the kernel reads
    them from its launch table)."""
    qvals: torch.Tensor         # i8 / i16 [P_pad]
    scales: torch.Tensor        # f32, per term
    exact_vals: torch.Tensor    # f32 [E_pad]
    exact_offsets: torch.Tensor  # i32, per term + 1
    packed: torch.Tensor        # i32 [W_pad], the uint32 words' bits
    base: torch.Tensor          # i32, per term
    width: int
    slot_base: np.ndarray       # i64 [t_pad]
    slot_scale: np.ndarray      # f32 [t_pad]
    slot_exact: np.ndarray      # i64 [t_pad]: exact range start, -1 if none


class TermBagSegment(NamedTuple):
    """One segment's inputs to ``term_bag_topk_segments``: a scored bag of
    weighted terms over one field's staged postings, laid out by
    ``search/plan.py`` ``TermBagPlan.topk_input``.  The tensors live on
    the segment's device; the per-slot arrays stay on the host (the
    kernel reads them from its launch table).  On a quantized segment
    ``quant`` holds the tables and ``doc_ids`` / ``impacts`` are None."""
    offsets: torch.Tensor     # i32, the staged CSR offsets
    doc_ids: Optional[torch.Tensor]   # i32 [P_pad], rows doc-ascending
    impacts: Optional[torch.Tensor]   # f32 [P_pad]
    live: torch.Tensor        # bool [n_pad], the point-in-time live mask
    term_ids: np.ndarray      # i32 [t_pad]
    active: np.ndarray        # bool [t_pad]
    idfs: np.ndarray          # f32 [t_pad]
    weights: np.ndarray       # f32 [t_pad]
    rows: np.ndarray          # i64 [t_pad, 2]: each slot's posting range
    required: int             # matched slots a doc needs
    fast: bool                # required == 1 and every w, idf > 0
    budget: int               # gather lanes of the plain version
    quant: Optional[QuantizedBag] = None


class BatchSegment(NamedTuple):
    """One segment's inputs to a batch of scored bags over one field (the
    msearch path, ``search/batch.py``): the union of the batch's terms
    present in the segment, and each query's terms as union slots, in the
    reference's ``batch_impact_union_topk`` layout.  The tensors live on
    the segment's device; the per-slot arrays stay on the host (K3 reads
    them from its launch table)."""
    offsets: torch.Tensor     # i32, the staged CSR offsets
    doc_ids: torch.Tensor     # i32 [P_pad], rows doc-ascending
    impacts: torch.Tensor     # f32 [P_pad]
    live: torch.Tensor        # bool [n_pad], the point-in-time live mask
    union_tids: np.ndarray    # i32 [t_pad]: union slot -> term id
    union_active: np.ndarray  # bool [t_pad]
    union_idfs: np.ndarray    # f32 [t_pad]
    union_rows: np.ndarray    # i64 [t_pad, 2]: each slot's posting range
    qslots: np.ndarray        # i32 [q_pad, tq]: query q's j-th term's slot
    qweights: np.ndarray      # f32 [q_pad, tq]
    qact: np.ndarray          # f32 [q_pad, tq]: 1 on q's present terms
    budget: int               # gather lanes of the plain version


class TermBagTopK(NamedTuple):
    """Per-segment results of a scored bag (for a batch of Q bags, one row
    per (query, segment), row ``q * S + s``): ``vals`` f32 [S, k] and
    ``ids`` i32 [S, k] (score descending, lower doc id first on ties,
    ``(-inf, -1)`` past the matched docs), ``totals`` i32 [S] (matched
    docs) and ``maxes`` f32 [S] (largest matched score, -inf when none),
    all views of one ``packed`` i32 buffer, so ``numpy()`` reads them
    back in one copy.  ``keep`` holds the device buffers a launch reads
    until then."""
    vals: torch.Tensor
    ids: torch.Tensor
    totals: torch.Tensor
    maxes: torch.Tensor
    packed: torch.Tensor
    keep: tuple = ()

    def numpy(self):
        """``(vals, ids, totals, maxes)`` as numpy arrays, one
        device-to-host copy."""
        n_seg, k = self.vals.shape
        h = self.packed.cpu().numpy()
        n = n_seg * k
        return (h[:n].view(np.float32).reshape(n_seg, k),
                h[n: 2 * n].reshape(n_seg, k), h[2 * n: 2 * n + n_seg],
                h[2 * n + n_seg:].view(np.float32))


def empty_topk(n_seg: int, k: int, device) -> TermBagTopK:
    """An unfilled ``TermBagTopK`` of ``n_seg`` rows of ``k``."""
    packed = torch.empty(n_seg * (2 * k + 2), dtype=torch.int32,
                         device=device)
    n = n_seg * k
    return TermBagTopK(packed[:n].view(torch.float32).view(n_seg, k),
                       packed[n: 2 * n].view(n_seg, k),
                       packed[2 * n: 2 * n + n_seg],
                       packed[2 * n + n_seg:].view(torch.float32), packed)


def write_topk_row(out: TermBagTopK, s: int, vals, ids, total, mx) -> None:
    """Row ``s`` of ``out`` from one segment's ``segment_topk``, padded
    with ``(-inf, -1)`` to ``k``."""
    m = vals.shape[0]
    out.vals[s, :m] = vals
    out.ids[s, :m] = ids
    out.vals[s, m:] = -torch.inf
    out.ids[s, m:] = -1
    out.totals[s] = total
    out.maxes[s] = mx


def segment_topk(seg: TermBagSegment, k: int, min_score: float,
                 plain: bool = True):
    """One segment's ``(vals [min(k, n_pad)], ids, total, max)`` as the
    reference's ``run_topk`` computes them for a scored ``TermBagPlan``,
    with the ids past the matched docs set to -1.  ``plain`` scores with
    the ``*_plain`` functions; otherwise with their dispatchers (on CUDA
    tensors, K2's per-slot entry, or K4's on a quantized segment)."""
    dev = seg.live.device
    n_pad = seg.live.shape[0]
    bag = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (seg.term_ids, seg.active, seg.idfs, seg.weights))
    kw = dict(n_pad=n_pad, budget=seg.budget)
    if seg.quant is None:
        args = (seg.offsets, seg.doc_ids, seg.impacts, *bag)
        scores_fn = impact_scores_plain if plain else impact_scores
        count_fn = impact_score_count_plain if plain else impact_score_count
    else:
        from opensearch_tpu_torch.ops import quantized as qops
        q = seg.quant
        args = (seg.offsets, q.packed, q.base, q.qvals, q.scales,
                q.exact_vals, q.exact_offsets, *bag)
        kw["width"] = q.width
        scores_fn = (qops.quantized_impact_scores_plain if plain
                     else qops.quantized_impact_scores)
        count_fn = (qops.quantized_impact_score_count_plain if plain
                    else qops.quantized_impact_score_count)
    if seg.fast:
        scores = scores_fn(*args, **kw)
        matched = scores > 0.0
    else:
        scores, count = count_fn(*args, **kw, scored=True)
        matched = count >= seg.required
    matched = matched & seg.live & (scores >= min_score)
    key = torch.where(matched, scores, -torch.inf)
    vals, idx = topk(key, min(k, n_pad))
    idx = torch.where(torch.isneginf(vals), -1, idx)
    return vals, idx, matched.sum(), torch.max(key)


def term_bag_topk_segments(segments, *, k: int,
                           min_score: float = -math.inf) -> TermBagTopK:
    """Plain version of K2's top-k entry: row ``s`` of the result is
    ``segment_topk(segments[s], k, min_score)``, padded with ``(-inf,
    -1)`` to ``k``."""
    dev = segments[0].live.device if segments else torch.device("cpu")
    out = empty_topk(len(segments), k, dev)
    for s, seg in enumerate(segments):
        write_topk_row(out, s, *segment_topk(seg, k, min_score))
    return out


def term_bag_topk_segments_auto(segments, *, k: int,
                                min_score: float = -math.inf
                                ) -> TermBagTopK:
    """A scored bag's top-k, total and max on every segment: on CUDA
    tensors one launch for all segments of each row layout (K2 on f32
    segments, K4 on quantized ones), the plain version on CPU ones."""
    if segments and segments[0].live.is_cuda:
        from opensearch_tpu_torch.ops import cuda_bm25
        return cuda_bm25.term_bag_topk_segments_cuda(segments, k=k,
                                                     min_score=min_score)
    return term_bag_topk_segments(segments, k=k, min_score=min_score)
