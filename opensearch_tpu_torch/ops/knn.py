"""Exact k-NN scoring on torch tensors (the port of the JAX package's
``ops/knn.py``).

Score translations match the opensearch-knn plugin's space definitions:

- l2:            1 / (1 + ||v - q||^2)
- cosinesimil:   (2 - (1 - cos)) / 2  == (1 + cos) / 2
- innerproduct:  d >= 0 ? d + 1 : 1 / (1 - d)

``knn_scores`` / ``knn_topk`` / ``knn_topk_segments`` are the plain
versions (a matrix-vector product plus elementwise translation, as the
reference's jnp path, then a stable sort).
``knn_topk_segments_auto`` is the dispatcher the query compiler calls:
CUDA tensors go through the hand-written kernel K1
(``ops/cuda_knn.py``), one launch for all of a shard's segments; CPU
tensors through the plain version.  It handles any ``n``.

Precision: no summation order is fixed by the reference (its XLA matmul
and its Pallas ``sum(v*q)`` differ) and K1's differs again, so scores
agree within ``RTOL``/``ATOL``, and hit ids agree except where
neighbouring scores lie within that tolerance.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from opensearch_tpu_torch.common import torchenv  # noqa: F401
from opensearch_tpu_torch.ops.bm25 import topk

SPACES = ("l2", "cosinesimil", "innerproduct")
RTOL = 1e-5
ATOL = 1e-6


class KnnSegment(NamedTuple):
    """One segment's inputs to a k-NN top-k: ``vectors`` f32 [n, d] and
    the bool [n] masks whose AND makes a row a candidate (``live`` and
    the ``filter``'s ``mask`` may be None)."""
    vectors: torch.Tensor
    exists: torch.Tensor
    live: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None


def knn_scores(vectors, valid, query, *, space: str):
    """Per-doc similarity scores [n_pad]; invalid rows score -inf.

    ``vectors`` [n_pad, d] float32, ``valid`` bool [n_pad] (exists &
    live), ``query`` [d]."""
    q = query.to(torch.float32)
    dots = vectors @ q
    if space == "l2":
        v2 = torch.sum(vectors * vectors, dim=1)
        d2 = torch.clamp(v2 - 2.0 * dots + torch.dot(q, q), min=0.0)
        scores = 1.0 / (1.0 + d2)
    elif space == "cosinesimil":
        norms = torch.sqrt(torch.sum(vectors * vectors, dim=1))
        qn = torch.sqrt(torch.dot(q, q))
        cos = dots / torch.clamp(norms * qn, min=1e-30)
        scores = (1.0 + cos) / 2.0
    elif space == "innerproduct":
        scores = torch.where(dots >= 0, dots + 1.0, 1.0 / (1.0 - dots))
    else:
        raise ValueError(f"unknown space [{space}]")
    return torch.where(valid, scores, torch.full_like(scores, -torch.inf))


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
        valid = seg.exists
        for extra in (seg.live, seg.mask):
            if extra is not None:
                valid = valid & extra
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
