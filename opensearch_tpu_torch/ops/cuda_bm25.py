"""Wrapper of K2, the hand-written term-bag scoring kernel
(``csrc/bm25.cu``), which replaces the reference's ``gather_postings`` +
``impact_scores`` / ``impact_score_count`` / ``match_count`` on CUDA
tensors.  Its plain twins are ``ops/bm25.py``'s ``*_plain`` functions
(``impact_scores_plain`` etc.), which this wrapper never falls back to:
a CUDA tensor gets the kernel or an exception.

``term_bag_cuda.launches`` counts kernel launches (one per query-term
slot per call).
"""

from __future__ import annotations

import ctypes

import torch

from opensearch_tpu_torch.ops import cuda_build

_THREADS = 256
_MAX_GRID = 132 * 32


def _declare(lib):
    p = ctypes.c_void_p
    lib.term_bag_launch.argtypes = [p, p, p, p, p, p, p, ctypes.c_int,
                                    ctypes.c_int, p, p, p]
    lib.term_bag_launch.restype = ctypes.c_int


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _expect(t, name, dtype, dev, ndim=1):
    if t.device != dev:
        raise ValueError(f"[{name}] is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"[{name}] has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"[{name}] must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"[{name}] must be contiguous")


def term_bag_cuda(offsets, doc_ids, impacts, term_ids, term_active, idfs,
                  weights, *, n_pad: int, budget: int, scores: bool,
                  counts: bool):
    """Dense ``(scores f32 [n_pad] | None, counts i32 [n_pad] | None)``
    for a bag of weighted terms over one field's staged postings.

    ``offsets`` i32 [t_pad_offsets], ``doc_ids`` i32 [P_pad] (each row
    doc-ascending, values < n_pad), ``impacts`` f32 [P_pad],
    ``term_ids`` i32 [t_pad], ``term_active`` bool [t_pad], ``idfs`` /
    ``weights`` f32 [t_pad]; ``impacts``/``idfs``/``weights`` may be
    None when ``scores`` is False.  ``budget`` (>= the sum of the active
    rows' lengths, as ``TermBagPlan.prepare`` computes it on the host)
    sizes the grid without reading the offsets back."""
    dev = offsets.device
    if dev.type != "cuda":
        raise ValueError(f"term_bag_cuda needs CUDA tensors, got {dev}")
    _expect(offsets, "offsets", torch.int32, dev)
    _expect(doc_ids, "doc_ids", torch.int32, dev)
    _expect(term_ids, "term_ids", torch.int32, dev)
    _expect(term_active, "term_active", torch.bool, dev)
    t_pad = term_ids.shape[0]
    if term_active.shape[0] != t_pad:
        raise ValueError("term_ids and term_active differ in length")
    if scores:
        _expect(impacts, "impacts", torch.float32, dev)
        _expect(idfs, "idfs", torch.float32, dev)
        _expect(weights, "weights", torch.float32, dev)
        if impacts.shape[0] != doc_ids.shape[0]:
            raise ValueError("impacts and doc_ids differ in length")
        if idfs.shape[0] != t_pad or weights.shape[0] != t_pad:
            raise ValueError("idfs/weights must have t_pad entries")
    out_s = (torch.zeros(n_pad, dtype=torch.float32, device=dev)
             if scores else None)
    out_c = (torch.zeros(n_pad, dtype=torch.int32, device=dev)
             if counts else None)
    if t_pad == 0 or not (scores or counts):
        return out_s, out_c
    lib = cuda_build.library("bm25", _declare)
    # one thread per posting of the longest possible row (capped; the
    # grid-stride loop covers the rest)
    grid = max(1, min(_MAX_GRID, -(-int(budget) // _THREADS)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.term_bag_launch(
        _ptr(offsets), _ptr(doc_ids), _ptr(impacts if scores else None),
        _ptr(term_ids), _ptr(term_active),
        _ptr(idfs if scores else None), _ptr(weights if scores else None),
        t_pad, grid, _ptr(out_s), _ptr(out_c), ctypes.c_void_p(stream))
    cuda_build.check(lib, rc, "term_bag_launch")
    term_bag_cuda.launches += t_pad
    return out_s, out_c


term_bag_cuda.launches = 0
