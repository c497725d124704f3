"""Exact k-NN scoring on torch tensors (the port of the JAX package's
``ops/knn.py``), and the per-row vector functions of score scripts.

Score translations match the opensearch-knn plugin's space definitions:

- l2:            1 / (1 + ||v - q||^2)
- cosinesimil:   (2 - (1 - cos)) / 2  == (1 + cos) / 2
- innerproduct:  d >= 0 ? d + 1 : 1 / (1 - d)

The raw script functions (``search/scripting.py``: ``dotProduct``,
``l2Squared``, ``cosineSimilarity``) are v.q, max(|v|^2 - 2 v.q + |q|^2,
0) and v.q / max(|v| |q|, 1e-30), for every row: rows without a vector
are the zero rows ``DeviceSegment`` stages and score as zeros, as in the
reference.

``vector_scores`` computes any of the six (``FUNCTIONS``) for one
segment, ``vector_scores_segments`` for a list of them;
``knn_scores`` / ``knn_topk`` / ``knn_topk_segments`` are the plain
versions of the k-NN path (then a stable sort).  The dispatchers
``knn_topk_segments_auto`` and ``vector_scores_segments_auto`` send CUDA
tensors to the hand-written kernel K1 (``ops/cuda_knn.py``: one launch
for all of a shard's segments) and CPU tensors to the plain versions.
``knn_topk_batch`` is the reference's batched throughput path: one
float32 product for a batch of queries over one segment.

Precision: no summation order is fixed by the reference (its XLA matmul
and its Pallas ``sum(v*q)`` differ), so the port's scores agree with it
within ``RTOL``/``ATOL``, and hit ids agree except where neighbouring
scores lie within that tolerance.  Within the port, the plain versions
and K1 sum v.q, |v|^2 and |q|^2 in float64 (a product of two floats is
exact there) in the one order K1 takes, which depends on d alone
(``row_lanes``: lane j of a row's L lanes sums the units j, j + L, ...
in turn, then a halving tree over the lanes), and round the result to
float32 once.  So the card and the CPU give the same bytes by
construction, also where a raw v.q cancels to near zero.  The rounded
space translations are moreover the correctly rounded score but in rare
ties of rounding, whatever order the sums take.  That matters where
scores are normalized by the spread of a top list (``hybrid``'s
``min_max``), which magnifies float32 sums' last bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from opensearch_tpu_torch.common import torchenv  # noqa: F401
from opensearch_tpu_torch.ops.bm25 import topk

SPACES = ("l2", "cosinesimil", "innerproduct")
# the raw functions of score scripts (search/scripting.py)
SCRIPT_FNS = ("dotProduct", "l2Squared", "cosineSimilarity")
_ROW_BLOCK = 16_384           # rows the plain version sums at a time
# every function K1's scores entry computes, in the order of its codes
FUNCTIONS = SPACES + SCRIPT_FNS
RTOL = 1e-5
ATOL = 1e-6


class KnnSegment(NamedTuple):
    """One segment's inputs to K1: ``vectors`` f32 [n, d] and the bool
    [n] masks whose AND makes a row a candidate (``live`` and the
    ``filter``'s ``mask`` may be None; ``exists`` too, for the scores of
    every row that score scripts read)."""
    vectors: torch.Tensor
    exists: Optional[torch.Tensor]
    live: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None


def row_lanes(d: int) -> int:
    """Lanes that reduce one row of width ``d`` in K1 (``csrc/knn.cu``
    ``config``): the least power of two, at most 32, whose lanes hold
    at most four units each (a unit is a float4 when ``d % 4 == 0``,
    else a float)."""
    units = d // 4 if d % 4 == 0 else d
    lanes = 1
    while lanes < 32 and lanes * 4 < units:
        lanes *= 2
    return lanes


def _halve(x):
    """Sum over the last axis as K1's xor-shuffle tree leaves it in lane
    0: the two halves added, again and again."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _lanes_view(x, lanes: int, width: int):
    """``x`` [..., d] as float64 [steps, width, ..., lanes]: element
    ``(s, c, ..., j)`` is component c of unit ``j + s * lanes``, zero
    where that unit lies past d (one copy, so each step reads a
    contiguous slice)."""
    d = x.shape[-1]
    steps = -(-(d // width) // lanes)
    pad = steps * lanes * width - d
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    lead = x.shape[:-1]
    x = x.reshape(*lead, steps, lanes, width)
    x = x.permute(len(lead), len(lead) + 2, *range(len(lead)),
                  len(lead) + 1)
    out = torch.empty(x.shape, dtype=torch.float64, device=x.device)
    return out.copy_(x)


def row_sums(vectors, query):
    """``(v.q [n], |v|^2 [n], |q|^2)`` in float64, summed in K1's order:
    lane j of a row's ``row_lanes(d)`` lanes adds the units j, j + L,
    ... one after the other, each unit's values in turn (a float4's four,
    or one float when ``d % 4 != 0``), then ``_halve`` over the lanes;
    |q|^2 the same way over the 32 lanes of a warp, one float a unit.
    The units past d add +0.0: a sum that starts at +0.0 is never -0.0,
    so it stays as it was.  Each product of two floats is exact in
    float64, so ``addcmul_`` rounds once per term, as the kernel's fma."""
    q = query.to(torch.float32)
    d = q.shape[0]
    width = 4 if d % 4 == 0 else 1
    lanes = row_lanes(d)
    qv = _lanes_view(q, lanes, width)
    dots, v2s = [], []
    # blocks of rows, so the float64 copy stays in cache on the CPU
    for lo in range(0, vectors.shape[0], _ROW_BLOCK):
        v = _lanes_view(vectors[lo: lo + _ROW_BLOCK], lanes, width)
        dot = torch.zeros(v.shape[2:], dtype=torch.float64, device=v.device)
        v2 = torch.zeros_like(dot)
        for s in range(v.shape[0]):
            for c in range(width):
                a = v[s, c]
                dot.addcmul_(a, qv[s, c])
                v2.addcmul_(a, a)
        dots.append(_halve(dot))
        v2s.append(_halve(v2))
    qw = _lanes_view(q, 32, 1)
    q2 = torch.zeros(32, dtype=torch.float64, device=qw.device)
    for s in range(qw.shape[0]):
        q2.addcmul_(qw[s, 0], qw[s, 0])
    if not dots:
        dots = v2s = [torch.zeros(0, dtype=torch.float64,
                                  device=vectors.device)]
    return torch.cat(dots), torch.cat(v2s), _halve(q2)


def vector_scores(vectors, valid, query, *, fn: str):
    """Per-row ``fn`` (one of ``FUNCTIONS``) of ``vectors`` [n, d]
    float32 against ``query`` [d], float32 [n]: summed in float64 in K1's
    order and rounded once (see the module doc).  Rows where ``valid``
    (bool [n], or None for every row) is False score -inf."""
    if fn not in FUNCTIONS:
        raise ValueError(f"unknown function [{fn}]")
    dot, v2, q2 = row_sums(vectors, query)
    if fn == "l2":
        scores = 1.0 / (1.0 + torch.clamp(v2 - 2.0 * dot + q2, min=0.0))
    elif fn == "cosinesimil":
        cos = dot / torch.clamp(torch.sqrt(v2) * torch.sqrt(q2), min=1e-30)
        scores = (1.0 + cos) / 2.0
    elif fn == "innerproduct":
        scores = torch.where(dot >= 0, dot + 1.0, 1.0 / (1.0 - dot))
    elif fn == "dotProduct":
        scores = dot
    elif fn == "l2Squared":
        scores = torch.clamp(v2 - 2.0 * dot + q2, min=0.0)
    else:
        scores = dot / torch.clamp(torch.sqrt(v2) * torch.sqrt(q2),
                                   min=1e-30)
    scores = scores.to(torch.float32)
    if valid is None:
        return scores
    return torch.where(valid, scores, torch.full_like(scores, -torch.inf))


def knn_scores(vectors, valid, query, *, space: str):
    """Per-doc similarity scores [n_pad]; invalid rows score -inf.

    ``vectors`` [n_pad, d] float32, ``valid`` bool [n_pad] (exists &
    live), ``query`` [d].  Summed in float64, the score rounded to
    float32 once (see the module doc)."""
    if space not in SPACES:
        raise ValueError(f"unknown space [{space}]")
    return vector_scores(vectors, valid, query, fn=space)


def segment_valid(seg):
    """``exists & live & mask`` of a ``KnnSegment`` (the parts that are
    None left out; None when all are)."""
    valid = None
    for part in (seg.exists, seg.live, seg.mask):
        if part is not None:
            valid = part if valid is None else valid & part
    return valid


def vector_scores_segments(segments, query, *, fn: str):
    """Plain ``fn`` of every ``KnnSegment`` against ``query``: one
    float32 [n_s] per segment, -inf where ``exists & live & mask`` is
    False (``exists`` None: every row valid).  The tests and the CPU
    path use it; K1's scores entry is its counterpart on the card."""
    return [vector_scores(seg.vectors, segment_valid(seg), query, fn=fn)
            for seg in segments]


def vector_scores_segments_auto(segments, query, *, fn: str):
    """``fn`` of every segment: one K1 scores launch for all of them on
    a CUDA query, the plain version on a CPU one."""
    if query.is_cuda:
        from opensearch_tpu_torch.ops.cuda_knn import \
            knn_scores_segments_cuda
        return knn_scores_segments_cuda(segments, query, fn=fn)
    return vector_scores_segments(segments, query, fn=fn)


def knn_topk(vectors, valid, query, *, space: str, k: int):
    """Plain exact top-k: (scores [k], local ids [k] int32), lower id
    first on equal scores."""
    return topk(knn_scores(vectors, valid, query, space=space), k)


def knn_topk_segments(segments, query, *, space: str, k: int):
    """Plain exact top-k of each ``KnnSegment``: ``(vals f32 [S, k], ids
    i32 [S, k])``.  Row ``s`` is the first ``min(k, n_s)`` entries of a
    stable descending sort of segment ``s``'s scores, then ``(-inf,
    -1)``."""
    vals = torch.full((len(segments), k), -torch.inf, device=query.device)
    ids = torch.full((len(segments), k), -1, dtype=torch.int32,
                     device=query.device)
    for s, seg in enumerate(segments):
        valid = segment_valid(seg)
        v, i = knn_topk(seg.vectors, valid, query, space=space,
                        k=min(k, seg.vectors.shape[0]))
        vals[s, : v.shape[0]] = v
        ids[s, : i.shape[0]] = i
    return vals, ids


def knn_topk_segments_auto(segments, query, *, space: str, k: int):
    """Exact top-k of each segment: one K1 launch for all of them on a
    CUDA query, the plain version on a CPU one."""
    if query.is_cuda:
        from opensearch_tpu_torch.ops.cuda_knn import knn_topk_segments_cuda
        return knn_topk_segments_cuda(segments, query, space=space, k=k)
    return knn_topk_segments(segments, query, space=space, k=k)


def knn_topk_batch(vectors, valid, queries, *, space: str, k: int):
    """Batched queries ``[Q, d]`` -> ``(scores f32 [Q, k], ids i32 [Q,
    k])``: one ``[n, d] x [d, Q]`` float32 product for the whole batch
    (``torch.matmul``, TF32 off: ``common/torchenv.py``), the space's
    translation in float32 as the reference computes it, rows where
    ``valid`` (bool [n]) is False at -inf, and each query's top-k with the
    lower index first on equal scores (a stable descending sort).  The
    reference's throughput path, which nothing of it calls; its scores
    agree with K1's within ``RTOL`` / ``ATOL``, not byte for byte (K1
    sums in float64)."""
    if space not in SPACES:
        raise ValueError(f"unknown space [{space}]")
    q = queries.to(torch.float32)
    dots = torch.matmul(vectors, q.T)                       # [n, Q]
    if space == "l2":
        v2 = torch.sum(vectors * vectors, dim=1)[:, None]
        q2 = torch.sum(q * q, dim=1)[None, :]
        d2 = torch.clamp(v2 - 2.0 * dots + q2, min=0.0)
        scores = 1.0 / (1.0 + d2)
    elif space == "cosinesimil":
        norms = torch.sqrt(torch.sum(vectors * vectors, dim=1))[:, None]
        qn = torch.sqrt(torch.sum(q * q, dim=1))[None, :]
        cos = dots / torch.clamp(norms * qn, min=1e-30)
        scores = (1.0 + cos) / 2.0
    else:
        scores = torch.where(dots >= 0, dots + 1.0, 1.0 / (1.0 - dots))
    scores = torch.where(valid[:, None], scores,
                         torch.full_like(scores, -torch.inf))
    vals, idx = torch.sort(scores.T, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)
