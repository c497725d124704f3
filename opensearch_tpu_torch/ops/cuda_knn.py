"""Wrapper of K1, the hand-written exact k-NN scoring kernel
(``csrc/knn.cu``) — the counterpart of the JAX package's
``ops/pallas_knn.py`` (``knn_scores_pallas``), for all three spaces and
any row count.  Its plain twin is ``knn_scores_plain`` (the plain
``ops/knn.py::knn_scores``), which this wrapper never falls back to: a
CUDA tensor gets the kernel or an exception.

``knn_scores_cuda.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from opensearch_tpu_torch.ops import cuda_build
from opensearch_tpu_torch.ops.knn import knn_scores as knn_scores_plain  # noqa: F401

SPACE_CODES = {"l2": 0, "cosinesimil": 1, "innerproduct": 2}


def _declare(lib):
    p = ctypes.c_void_p
    lib.knn_scores_launch.argtypes = [p, p, p, p, p, ctypes.c_longlong,
                                      ctypes.c_int, ctypes.c_int, p]
    lib.knn_scores_launch.restype = ctypes.c_int


def knn_scores_cuda(vectors, valid, query, *, space: str):
    """Per-row scores float32 [n] of ``vectors`` f32 [n, d] against
    ``query`` f32 [d]; rows with ``valid`` (bool [n]) False score
    -inf."""
    code = SPACE_CODES.get(space)
    if code is None:
        raise ValueError(f"unknown space [{space}]")
    dev = vectors.device
    if dev.type != "cuda":
        raise ValueError(f"knn_scores_cuda needs CUDA tensors, got {dev}")
    if vectors.dtype != torch.float32 or vectors.dim() != 2:
        raise TypeError("vectors must be float32 [n, d]")
    n, d = vectors.shape
    if valid.dtype != torch.bool or tuple(valid.shape) != (n,):
        raise TypeError(f"valid must be bool [{n}]")
    if query.dtype != torch.float32 or tuple(query.shape) != (d,):
        raise TypeError(f"query must be float32 [{d}]")
    for name, t in (("vectors", vectors), ("valid", valid),
                    ("query", query)):
        if t.device != dev:
            raise ValueError(f"[{name}] is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"[{name}] must be contiguous")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    q2 = torch.sum(query * query).reshape(1)     # |q|^2 once per launch
    lib = cuda_build.library("knn", _declare)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.knn_scores_launch(
        ctypes.c_void_p(vectors.data_ptr()), ctypes.c_void_p(valid.data_ptr()),
        ctypes.c_void_p(query.data_ptr()), ctypes.c_void_p(q2.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), n, d, code,
        ctypes.c_void_p(stream))
    cuda_build.check(lib, rc, "knn_scores_launch")
    knn_scores_cuda.launches += 1
    return out


knn_scores_cuda.launches = 0
