"""Exact k-NN scoring on torch tensors (the port of the JAX package's
``ops/knn.py``).

Score translations match the opensearch-knn plugin's space definitions:

- l2:            1 / (1 + ||v - q||^2)
- cosinesimil:   (2 - (1 - cos)) / 2  == (1 + cos) / 2
- innerproduct:  d >= 0 ? d + 1 : 1 / (1 - d)

``knn_scores`` / ``knn_topk`` are the plain versions (a matrix-vector
product plus elementwise translation, as the reference's jnp path).
``knn_topk_auto`` is the dispatcher the query compiler calls: CUDA
tensors go through the hand-written kernel K1 (``ops/cuda_knn.py``),
CPU tensors through the plain version.  It handles any ``n``.

Precision: no summation order is fixed by the reference (its XLA matmul
and its Pallas ``sum(v*q)`` differ) and K1's differs again, so scores
agree within ``RTOL``/``ATOL``, and hit ids agree except where
neighbouring scores lie within that tolerance.
"""

from __future__ import annotations

import torch

from opensearch_tpu_torch.common import torchenv  # noqa: F401
from opensearch_tpu_torch.ops.bm25 import topk

SPACES = ("l2", "cosinesimil", "innerproduct")
RTOL = 1e-5
ATOL = 1e-6


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


def knn_topk_auto(vectors, valid, query, *, space: str, k: int):
    """Exact top-k: scores from K1 on CUDA tensors, from the plain
    version on CPU tensors; the top-k itself is a stable sort either
    way."""
    if vectors.is_cuda:
        from opensearch_tpu_torch.ops.cuda_knn import knn_scores_cuda
        return topk(knn_scores_cuda(vectors, valid, query, space=space), k)
    return knn_topk(vectors, valid, query, space=space, k=k)
