"""BM25 scoring over precomputed impacts, on torch tensors (the port of
the JAX package's ``ops/bm25.py``).

Each function here is a plain PyTorch version of the reference's jnp
function, with the same float32 operation order, so that on the CPU it
equals the reference byte for byte.  ``impact_scores``,
``impact_score_count`` and ``match_count`` are also the wrappers of the
hand-written term-bag kernel (K2, ``csrc/bm25.cu``): given CUDA tensors
they launch it (``ops/cuda_bm25.py``) or raise; given CPU tensors they
run the plain version.  The plain versions stay callable on any device
as ``*_plain`` so the kernel can be held against them on the card.

Accumulation order: per doc, contributions add in query-term SLOT order
starting from 0.0, each one ``w * (idf * imp)`` — the order of the
reference's in-order scatter-add over slot-major gather lanes.
"""

from __future__ import annotations

import math

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


def gather_postings(offsets, doc_ids, tfs, term_ids, term_active, *,
                    budget: int, pad_doc: int):
    """Flatten the postings of up to T terms into ``budget`` lanes
    (cumsum + searchsorted over the CSR rows), as the reference does.

    Returns (docs[B] i32, tfs[B], slot[B] i32, valid[B] bool): ``slot``
    is the index into ``term_ids`` that produced each lane.  The caller
    must choose ``budget >= sum(df[term_ids])``."""
    dev = offsets.device
    tids = term_ids.long()
    starts = offsets[tids]
    lens = torch.where(term_active, offsets[tids + 1] - starts,
                       torch.zeros_like(starts))
    cum = torch.cumsum(lens, 0, dtype=torch.int32)
    total = cum[-1]
    i = torch.arange(budget, dtype=torch.int32, device=dev)
    slot = torch.searchsorted(cum, i, right=True, out_int32=True)
    slot = torch.clamp(slot, max=term_ids.shape[0] - 1)
    slot_l = slot.long()
    prev = torch.where(slot > 0, cum[(slot_l - 1).clamp(min=0)],
                       torch.zeros_like(slot))
    valid = i < total
    idx = torch.where(valid, starts[slot_l] + i - prev,
                      torch.zeros_like(i))
    d = torch.where(valid, doc_ids[idx.long()],
                    torch.full_like(idx, pad_doc))
    tf = torch.where(valid, tfs[idx.long()], torch.zeros((), dtype=tfs.dtype,
                                                         device=dev))
    return d, tf, slot, valid


def _scatter_in_slot_order(n_pad: int, d, slot, valid, contrib, t_pad: int,
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
    return _scatter_in_slot_order(n_pad, d, slot, valid, contrib,
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
    count = _scatter_in_slot_order(n_pad, d, slot, valid, ones, t_pad,
                                   torch.int32)
    if not scored:
        return torch.zeros(n_pad, dtype=torch.float32,
                           device=d.device), count
    slot_l = slot.long()
    contrib = weights[slot_l] * (idfs[slot_l] * imp)
    scores = _scatter_in_slot_order(n_pad, d, slot, valid, contrib, t_pad,
                                    torch.float32)
    return scores, count


def match_count_plain(offsets, doc_ids, tfs, term_ids, term_active, *,
                      n_pad: int, budget: int):
    """Plain version of K2's counts-only mode (the reference's
    ``match_count``): per-doc count of distinct matched query terms."""
    d, _tf, slot, valid = gather_postings(
        offsets, doc_ids, tfs, term_ids, term_active,
        budget=budget, pad_doc=n_pad - 1)
    return _scatter_in_slot_order(n_pad, d, slot, valid,
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
