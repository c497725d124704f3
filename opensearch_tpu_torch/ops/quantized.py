"""Quantized-impact scoring over bit-packed doc ids, on torch tensors (the
port of the JAX package's ``ops/quantized.py`` and of ``ops/bm25.py``
``gather_postings_packed``).

Same composition as the f32 impact scoring in ``ops/bm25.py`` — a CSR
gather, a weighted scatter-add in slot order — but the gather decodes
bit-packed doc-id deltas (``index/codec.py`` ``pack_doc_ids``) and the
impact column dequantizes int8/int16 codes against per-term scales,
overridden by the exact f32 block of a term the rank-parity guard kept
exact (``exact_vals`` / ``exact_offsets``).

Every contribution is ``weights[slot] * (idfs[slot] * imp)`` with ``imp =
q.float() * scales[term]`` in float32, the reference's order, so on the
CPU these equal the reference byte for byte, and they equal the f32
functions of ``ops/bm25.py`` fed ``QuantizedPostings.dequantized()``.

``quantized_impact_scores`` and ``quantized_impact_score_count`` are the
wrappers of the quantized per-slot entry of the term-bag kernel (K4,
``csrc/bm25.cu``): given CUDA tensors they launch it
(``ops/cuda_bm25.py`` ``term_bag_quantized_cuda``) or raise; given CPU
tensors they run the ``*_plain`` versions, which stay callable on any
device so the kernel can be held against them on the card.
"""

from __future__ import annotations

import torch

from opensearch_tpu_torch.common import torchenv  # noqa: F401
from opensearch_tpu_torch.ops.bm25 import flatten_rows, scatter_in_slot_order

_WORD_MASK = 0xFFFFFFFF


def gather_postings_packed(offsets, packed, base, term_ids, term_active, *,
                           width: int, budget: int, pad_doc: int):
    """``gather_postings`` over bit-packed doc ids: each lane decodes its
    delta from two aligned 32-bit words of ``packed`` (i32 holding the
    uint32 words' bits, guard word included) at ``width`` bits and adds
    its term's ``base``.  Returns (docs[B] i32, idx[B] i32, slot[B] i32,
    valid[B] bool): ``idx`` is the flat posting index (for the impact
    gather), ``slot`` the query-term slot, as in the reference."""
    idx, slot, valid = flatten_rows(offsets, term_ids, term_active,
                                    budget=budget)
    # bitpos = idx * width decomposed as idx = 32a + b, so the word and
    # bit math never overflows int32 at real posting counts
    a, b = idx >> 5, idx & 31
    bit = b * width
    w = (a * width + (bit >> 5)).long()
    off = (bit & 31).long()
    pair = ((packed[w].long() & _WORD_MASK)
            | ((packed[w + 1].long() & _WORD_MASK) << 32))
    delta = ((pair >> off) & ((1 << width) - 1)).to(torch.int32)
    tid = term_ids[slot.long()].long()
    d = torch.where(valid, base[tid] + delta,
                    torch.full_like(delta, pad_doc))
    return d, idx, slot, valid


def _dequant(idx, slot, valid, offsets, term_ids, qvals, scales,
             exact_vals, exact_offsets):
    """Per-lane impact: quantized code * the term's scale, overridden by
    the exact f32 block where the parity guard kept one.  ``idx -
    start`` is the in-row position, which indexes the exact CSR
    directly (same order as the postings CSR)."""
    slot_l = slot.long()
    tid = term_ids[slot_l].long()
    idx_l = idx.long()
    imp_q = qvals[idx_l].to(torch.float32) * scales[tid]
    pos = idx - offsets[term_ids.long()][slot_l]
    e0 = exact_offsets[tid]
    has_exact = exact_offsets[tid + 1] > e0
    ei = torch.clamp(e0 + pos, 0, exact_vals.shape[0] - 1).long()
    imp = torch.where(has_exact, exact_vals[ei], imp_q)
    return torch.where(valid, imp, torch.zeros_like(imp))


def quantized_impact_scores_plain(offsets, packed, base, qvals, scales,
                                  exact_vals, exact_offsets, term_ids,
                                  term_active, idfs, weights, *, width: int,
                                  n_pad: int, budget: int):
    """Plain version of K4's scores-only mode (the reference's
    ``quantized_impact_scores``: score > 0 iff matched)."""
    d, idx, slot, valid = gather_postings_packed(
        offsets, packed, base, term_ids, term_active, width=width,
        budget=budget, pad_doc=n_pad - 1)
    imp = _dequant(idx, slot, valid, offsets, term_ids, qvals, scales,
                   exact_vals, exact_offsets)
    slot_l = slot.long()
    contrib = weights[slot_l] * (idfs[slot_l] * imp)
    return scatter_in_slot_order(n_pad, d, slot, valid, contrib,
                                 term_ids.shape[0], torch.float32)


def quantized_impact_score_count_plain(offsets, packed, base, qvals, scales,
                                       exact_vals, exact_offsets, term_ids,
                                       term_active, idfs, weights, *,
                                       width: int, n_pad: int, budget: int,
                                       scored: bool):
    """Plain version of K4's scores-and-counts mode (the reference's
    ``quantized_impact_score_count``).  With ``scored=False`` only the
    counts are computed."""
    d, idx, slot, valid = gather_postings_packed(
        offsets, packed, base, term_ids, term_active, width=width,
        budget=budget, pad_doc=n_pad - 1)
    t_pad = term_ids.shape[0]
    count = scatter_in_slot_order(n_pad, d, slot, valid,
                                  torch.ones_like(d), t_pad, torch.int32)
    if not scored:
        return torch.zeros(n_pad, dtype=torch.float32,
                           device=d.device), count
    imp = _dequant(idx, slot, valid, offsets, term_ids, qvals, scales,
                   exact_vals, exact_offsets)
    slot_l = slot.long()
    contrib = weights[slot_l] * (idfs[slot_l] * imp)
    scores = scatter_in_slot_order(n_pad, d, slot, valid, contrib, t_pad,
                                   torch.float32)
    return scores, count


def quantized_impact_scores(offsets, packed, base, qvals, scales,
                            exact_vals, exact_offsets, term_ids, term_active,
                            idfs, weights, *, width: int, n_pad: int,
                            budget: int):
    """Dense per-doc BM25 scores from a quantized segment's tables.  CUDA
    tensors launch K4's per-slot entry; CPU tensors take the plain
    version."""
    args = (offsets, packed, base, qvals, scales, exact_vals, exact_offsets,
            term_ids, term_active, idfs, weights)
    if offsets.is_cuda:
        from opensearch_tpu_torch.ops import cuda_bm25
        scores, _count = cuda_bm25.term_bag_quantized_cuda(
            *args, width=width, n_pad=n_pad, budget=budget, scores=True,
            counts=False)
        return scores
    return quantized_impact_scores_plain(*args, width=width, n_pad=n_pad,
                                         budget=budget)


def quantized_impact_score_count(offsets, packed, base, qvals, scales,
                                 exact_vals, exact_offsets, term_ids,
                                 term_active, idfs, weights, *, width: int,
                                 n_pad: int, budget: int, scored: bool):
    """Scores and matched-slot counts (AND / minimum_should_match) from
    a quantized segment's tables.  CUDA tensors launch K4's per-slot
    entry; CPU tensors take the plain version."""
    args = (offsets, packed, base, qvals, scales, exact_vals, exact_offsets,
            term_ids, term_active, idfs, weights)
    if offsets.is_cuda:
        from opensearch_tpu_torch.ops import cuda_bm25
        scores, count = cuda_bm25.term_bag_quantized_cuda(
            *args, width=width, n_pad=n_pad, budget=budget, scores=scored,
            counts=True)
        if scores is None:
            scores = torch.zeros(n_pad, dtype=torch.float32,
                                 device=offsets.device)
        return scores, count
    return quantized_impact_score_count_plain(
        *args, width=width, n_pad=n_pad, budget=budget, scored=scored)
