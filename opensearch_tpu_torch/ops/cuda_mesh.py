"""Wrapper of K10, the cross-shard merge (``csrc/mesh_merge.cu``), which
replaces the reference's ``sharded_topk_merge``
(``opensearch_tpu/parallel/dist_search.py:170``): the top k of the mesh's
[R, w] sorted lists in one launch, the lower flat index first on ties.
Its plain twin is ``ops/mesh.py::mesh_merge_plain``.

It never falls back to its plain twin: a CUDA tensor gets the kernel or
an exception.  ``.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from opensearch_tpu_torch.ops import cuda_build


def _declare(lib):
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.mesh_merge_launch.argtypes = [p, i, i, i, p, p, p]
    lib.mesh_merge_launch.restype = i


def _library():
    return cuda_build.library("mesh_merge", _declare)


def mesh_merge_cuda(vals, k: int):
    """``(top_vals [k] f32, flat_idx [k] i64)`` of ``vals`` [R, w]
    (float32, contiguous, on one CUDA device; each row sorted descending
    with -inf padding), in one launch."""
    if vals.device.type != "cuda":
        raise ValueError(f"mesh_merge_cuda needs a CUDA tensor, got "
                         f"{vals.device}")
    if vals.dtype != torch.float32 or vals.dim() != 2:
        raise TypeError(f"[vals] must be float32 [R, w], got {vals.dtype} "
                        f"{list(vals.shape)}")
    if not vals.is_contiguous():
        raise ValueError("[vals] must be contiguous")
    rows, w = vals.shape
    if not 1 <= k <= rows * w:
        raise ValueError(f"k must be in [1, {rows * w}], got {k}")
    out_vals = torch.empty(k, dtype=torch.float32, device=vals.device)
    out_idx = torch.empty(k, dtype=torch.int64, device=vals.device)
    lib = _library()
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    rc = lib.mesh_merge_launch(
        ctypes.c_void_p(vals.data_ptr()), rows, w, k,
        ctypes.c_void_p(out_vals.data_ptr()),
        ctypes.c_void_p(out_idx.data_ptr()), ctypes.c_void_p(stream))
    cuda_build.check(lib, rc, "mesh_merge_launch")
    cuda_build.count(mesh_merge_cuda)
    return out_vals, out_idx


mesh_merge_cuda.launches = 0
