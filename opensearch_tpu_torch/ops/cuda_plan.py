"""Wrapper of the plan top-k, the hand-written kernel
``csrc/plan_topk.cu``, which replaces the reference's ``run_topk`` /
``topk_from_scores`` (``search/plan.py``) after a plan's dense
evaluation on CUDA tensors: every plan that is not a scored term bag at
the root (``bool``, ``constant_score``, filters, ``knn``'s winners,
``hybrid``'s sub-queries, ``script_score``, an aggregations request's
hits).

- ``plan_topk_segments_cuda``: one launch over every segment of a
  request, each segment's top-k (score descending, the lower doc id
  first on ties), matched total and max computed inside the kernel.  Its
  plain twin is ``ops/bm25.py::plan_topk_segments``.  At ``k > K_MAX``
  (a deep page) every segment takes the plain version's stable sort
  instead; ``sorted_route_segments`` counts those.

It never falls back to its plain twin below ``K_MAX``: a CUDA tensor gets
the kernel or an exception.  ``.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from opensearch_tpu_torch.ops import bm25, cuda_bm25, cuda_build
from opensearch_tpu_torch.ops.cuda_bm25 import K_MAX, k_padded

# The launch table's layout and the tile decision, handed to
# csrc/plan_topk.cu as -D macros when it is built (see ``defines``).
TILE_DOCS = 4096      # docs a block keys and selects from
SEG_WORDS = 7         # int64 words per segment in the launch table


def defines() -> dict:
    """The macros ``csrc/plan_topk.cu`` is built with: this module's
    constants at the time of the call."""
    return {"PLAN_TILE_DOCS": TILE_DOCS, "PLAN_K_MAX": K_MAX,
            "PLAN_SEG_WORDS": SEG_WORDS}


def _declare(lib):
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.plan_topk_launch.argtypes = [p, i, i, i, i, ctypes.c_float, p, p, p,
                                     p, p, p]
    lib.plan_topk_launch.restype = i


def _library():
    return cuda_build.library("plan_topk", _declare, defines())


def plan_table(ptrs, n_pads) -> tuple[np.ndarray, int]:
    """The launch's table, one int64 buffer copied to the card per call,
    and its block count.  Per segment ``ptrs`` one ``(scores, matched,
    live)`` tuple of device addresses (live 0: every doc live) and
    ``n_pads`` its doc count; segment ``s`` writes output row ``s``.
    Layout (``csrc/plan_topk.cu`` reads it so): ``SEG_WORDS`` words per
    segment ``{scores, matched, live, n_pad, first tile, tiles, output
    row}``; then the work list, one word per block, ``segment << 32 |
    tile``; then ``2 * n_seg`` int32 zeros (tile counters, totals)."""
    n_seg = len(n_pads)
    tiles = np.asarray([cuda_bm25.n_tiles(n, TILE_DOCS) for n in n_pads],
                       np.int64)
    first = np.concatenate([[0], np.cumsum(tiles)])
    n_blocks = int(first[-1])
    head_words = n_seg * SEG_WORDS
    table = np.zeros(head_words + n_blocks + n_seg, np.int64)
    if n_seg:
        head = table[:head_words].reshape(n_seg, SEG_WORDS)
        head[:, 0:3] = ptrs
        head[:, 3] = n_pads
        head[:, 4] = first[:-1]
        head[:, 5] = tiles
        head[:, 6] = np.arange(n_seg)
    seg_of = np.repeat(np.arange(n_seg, dtype=np.int64), tiles)
    tile_of = np.arange(n_blocks, dtype=np.int64) - first[:-1][seg_of]
    table[head_words: head_words + n_blocks] = (seg_of << 32) | tile_of
    return table, n_blocks


def _expect(t, name, dtype, dev, n):
    if t.device != dev:
        raise ValueError(f"[{name}] is on {t.device}, expected {dev}")
    if t.dtype != dtype or tuple(t.shape) != (n,):
        raise TypeError(f"[{name}] must be {dtype} [{n}], got {t.dtype} "
                        f"{list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"[{name}] must be contiguous")


def _check(entries, dev):
    for i, e in enumerate(entries):
        n = e.scores.shape[0] if e.scores.dim() == 1 else -1
        _expect(e.scores, f"entries[{i}].scores", torch.float32, dev, n)
        _expect(e.matched, f"entries[{i}].matched", torch.bool, dev, n)
        if e.live is not None:
            _expect(e.live, f"entries[{i}].live", torch.bool, dev, n)


def plan_topk_segments_cuda(entries, *, k: int,
                            min_score: float = -np.inf) -> bm25.TermBagTopK:
    """Top-k, matched total and max of every segment of ``entries``
    (``bm25.PlanScores`` on one CUDA device): a ``bm25.TermBagTopK`` whose
    row ``s`` holds ``bm25.plan_segment_topk(entries[s], k, min_score)``'s
    matched part, ``(-inf, -1)`` past it.  At ``k <= K_MAX`` one launch
    for all segments (counted here); above it each segment's stable
    sort."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not entries:
        raise ValueError("plan_topk_segments_cuda needs a segment")
    dev = entries[0].scores.device
    if dev.type != "cuda":
        raise ValueError(f"plan_topk_segments_cuda needs CUDA tensors, got "
                         f"{dev}")
    _check(entries, dev)
    out = bm25.empty_topk(len(entries), k, dev)
    if k > K_MAX:
        for s, entry in enumerate(entries):
            cuda_build.count(plan_topk_segments_cuda,
                             attr="sorted_route_segments")
            bm25.write_topk_row(out, s, *bm25.plan_segment_topk(
                entry, k, min_score))
        return out
    table, n_blocks = plan_table(
        [(e.scores.data_ptr(), e.matched.data_ptr(),
          0 if e.live is None else e.live.data_ptr()) for e in entries],
        [e.scores.shape[0] for e in entries])
    kp = k_padded(k)
    table_dev = torch.from_numpy(table).pin_memory().to(dev,
                                                         non_blocking=True)
    scratch = torch.empty(n_blocks * kp, dtype=torch.int64, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.plan_topk_launch(
        ctypes.c_void_p(table_dev.data_ptr()), len(entries), n_blocks, k, kp,
        float(min_score), ctypes.c_void_p(out.vals.data_ptr()),
        ctypes.c_void_p(out.ids.data_ptr()),
        ctypes.c_void_p(out.totals.data_ptr()),
        ctypes.c_void_p(out.maxes.data_ptr()),
        ctypes.c_void_p(scratch.data_ptr()), ctypes.c_void_p(stream))
    cuda_build.check(lib, rc, "plan_topk_launch")
    cuda_build.count(plan_topk_segments_cuda)
    return out._replace(keep=out.keep + (table_dev, scratch,
                                         tuple(entries)))


plan_topk_segments_cuda.launches = 0
plan_topk_segments_cuda.sorted_route_segments = 0
