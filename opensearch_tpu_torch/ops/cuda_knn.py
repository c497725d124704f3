"""Wrappers of K1, the hand-written exact k-NN kernel (``csrc/knn.cu``)
-- the counterpart of the JAX package's ``ops/pallas_knn.py``
(``knn_scores_pallas``) and of the ``lax.top_k`` after it, for all
three spaces and any row count.

- ``knn_topk_segments_cuda``: one launch per query over every segment
  of a shard, each segment's exact top-k computed inside the kernel.
  Its plain twin is ``ops/knn.py::knn_topk_segments``.  A segment for
  which ``uses_sorted_route`` holds (``k > K_MAX``, or more merge
  candidates than ``MERGE_MAX_CANDIDATES``) takes the scores-only entry
  plus the stable sort (``ops/bm25.py::topk``) instead;
  ``sorted_route_segments`` counts those.
- ``knn_scores_cuda``: the scores of one segment.  Its plain twin is
  ``knn_scores_plain`` (``ops/knn.py::knn_scores``).

Neither ever falls back to its plain twin: a CUDA tensor gets the kernel
or an exception.  ``.launches`` on each wrapper counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from opensearch_tpu_torch.ops import cuda_build
from opensearch_tpu_torch.ops.bm25 import topk
from opensearch_tpu_torch.ops.knn import (  # noqa: F401
    knn_scores as knn_scores_plain)

SPACE_CODES = {"l2": 0, "cosinesimil": 1, "innerproduct": 2}
# The launch table's layout and the chunk decision, handed to csrc/knn.cu
# as -D macros when it is built (see ``defines``).
CHUNK_ROWS = 4096     # rows a block of the top-k entry scores
K_MAX = 256           # largest k selected inside the kernel
SEG_WORDS = 8         # int64 words per segment in the launch table
# Above this many candidates (chunks x k rounded up to a power of two) a
# segment's merge, serial in one block, costs more than the stable sort
# of its scores: at 1M x 128 on an H100, 62,720 candidates (k = 256)
# lost to the sort and 31,360 (k = 100) won (testing/k1_sweep.py).
MERGE_MAX_CANDIDATES = 32_768


def defines() -> dict:
    """The macros ``csrc/knn.cu`` is built with: this module's constants
    at the time of the call."""
    return {"KNN_CHUNK_ROWS": CHUNK_ROWS, "KNN_K_MAX": K_MAX,
            "KNN_SEG_WORDS": SEG_WORDS}


def _declare(lib):
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.knn_scores_launch.argtypes = [p, p, p, p, p, p, ctypes.c_longlong,
                                      i, i, p]
    lib.knn_scores_launch.restype = i
    lib.knn_topk_segments_launch.argtypes = [p, i, i, p, i, i, i, i, p, p,
                                             p, p]
    lib.knn_topk_segments_launch.restype = i
    lib.knn_d_max.argtypes = []
    lib.knn_d_max.restype = i
    lib.d_max = lib.knn_d_max()   # largest d the build takes, read once


def _library():
    return cuda_build.library("knn", _declare, defines())


def _addr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _ptr(t):
    return ctypes.c_void_p(_addr(t))


def _expect(t, name, dtype, dev, shape):
    if t.device != dev:
        raise ValueError(f"[{name}] is on {t.device}, expected {dev}")
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise TypeError(f"[{name}] must be {dtype} {list(shape)}, got "
                        f"{t.dtype} {list(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"[{name}] must be contiguous")


def _space_code(space: str) -> int:
    code = SPACE_CODES.get(space)
    if code is None:
        raise ValueError(f"unknown space [{space}]")
    return code


def _check_query(query, what: str):
    dev = query.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    if query.dtype != torch.float32 or query.dim() != 1:
        raise TypeError("query must be float32 [d]")
    if not query.is_contiguous():
        raise ValueError("[query] must be contiguous")
    d = query.shape[0]
    d_max = _library().d_max
    if d == 0 or d > d_max:
        raise ValueError(f"{what} takes 1 <= d <= {d_max}, got d={d}")
    return dev, d


def _check_segment(seg, dev, d, i):
    n = seg.vectors.shape[0] if seg.vectors.dim() == 2 else -1
    _expect(seg.vectors, f"segments[{i}].vectors", torch.float32, dev, (n, d))
    _expect(seg.exists, f"segments[{i}].exists", torch.bool, dev, (n,))
    if seg.live is not None:
        _expect(seg.live, f"segments[{i}].live", torch.bool, dev, (n,))
    if seg.mask is not None:
        _expect(seg.mask, f"segments[{i}].mask", torch.bool, dev, (n,))
    return n


def _scores_launch(vectors, exists, live, mask, query, d, code):
    n = vectors.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=vectors.device)
    if n == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(vectors.device).cuda_stream
    rc = lib.knn_scores_launch(_ptr(vectors), _ptr(exists), _ptr(live),
                               _ptr(mask), _ptr(query), _ptr(out), n, d,
                               code, ctypes.c_void_p(stream))
    cuda_build.check(lib, rc, "knn_scores_launch")
    cuda_build.count(knn_scores_cuda)
    return out


def knn_scores_cuda(vectors, valid, query, *, space: str):
    """Per-row scores float32 [n] of ``vectors`` f32 [n, d] against
    ``query`` f32 [d]; rows with ``valid`` (bool [n]) False score
    -inf."""
    code = _space_code(space)
    dev, d = _check_query(query, "knn_scores_cuda")
    n = vectors.shape[0] if vectors.dim() == 2 else -1
    _expect(vectors, "vectors", torch.float32, dev, (n, d))
    _expect(valid, "valid", torch.bool, dev, (n,))
    return _scores_launch(vectors, valid, None, None, query, d, code)


knn_scores_cuda.launches = 0


# -- the fused top-k: host-side layout (pure Python, tested on the CPU) --

def k_padded(k: int) -> int:
    """Candidates each chunk keeps: ``k`` rounded up to a power of two."""
    return 1 << (int(k) - 1).bit_length()


def n_chunks(n: int) -> int:
    """Blocks of the top-k launch for a segment of ``n`` rows (one even
    when it has none, so its output row is written)."""
    return max(1, -(-int(n) // CHUNK_ROWS))


def uses_sorted_route(k: int, n: int) -> bool:
    """True when the segment of ``n`` rows is served at ``k`` by the
    scores-only entry plus the stable sort: ``k`` above what the kernel
    selects in shared memory, or a merge of more than
    ``MERGE_MAX_CANDIDATES`` candidates."""
    return k > K_MAX or n_chunks(n) * k_padded(k) > MERGE_MAX_CANDIDATES


def launch_table(ptrs, rows, out_rows=None) -> tuple[np.ndarray, int]:
    """The top-k launch's table, one int64 buffer copied to the card
    per query, and its block count.

    ``ptrs`` holds one ``(vectors, exists, live, mask)`` tuple of device
    addresses per segment (0 for an absent live or mask), ``rows`` each
    segment's row count, ``out_rows`` the row of the output each segment
    writes (by default its position).  Layout (``csrc/knn.cu`` reads it
    so): ``SEG_WORDS`` words per segment ``{vectors, exists, live, mask,
    n, first chunk, chunks, output row}``; then the work list, one word
    per block, ``segment << 32 | chunk``; then one int32 counter per
    segment, zero."""
    n_seg = len(rows)
    chunks = [n_chunks(n) for n in rows]
    first = np.concatenate([[0], np.cumsum(chunks, dtype=np.int64)])
    n_blocks = int(first[-1])
    table = np.zeros(n_seg * SEG_WORDS + n_blocks + (n_seg + 1) // 2,
                     np.int64)
    head = table[: n_seg * SEG_WORDS].reshape(n_seg, SEG_WORDS)
    if n_seg:
        head[:, 0:4] = np.asarray(ptrs, np.int64)
        head[:, 4] = rows
        head[:, 5] = first[:-1]
        head[:, 6] = chunks
        head[:, 7] = range(n_seg) if out_rows is None else out_rows
    seg_of = np.repeat(np.arange(n_seg, dtype=np.int64), chunks)
    chunk_of = np.arange(n_blocks, dtype=np.int64) - first[:-1][seg_of]
    table[n_seg * SEG_WORDS: n_seg * SEG_WORDS + n_blocks] = \
        (seg_of << 32) | chunk_of
    return table, n_blocks


def knn_topk_segments_cuda(segments, query, *, space: str, k: int):
    """Exact top-k of every segment against ``query`` f32 [d]:
    ``(vals f32 [S, k], ids i32 [S, k])``.  Row ``s`` holds the first
    ``min(k, n_s)`` entries of a stable descending sort of segment
    ``s``'s scores (rows not ``exists & live & mask`` at -inf), then
    ``(-inf, -1)``.  ``segments`` are ``ops.knn.KnnSegment``s on the
    query's device.  One launch for the segments of the fused route; one
    scores-only launch plus the stable sort for each segment of the
    sorted route (``uses_sorted_route``)."""
    code = _space_code(space)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    dev, d = _check_query(query, "knn_topk_segments_cuda")
    rows = [_check_segment(seg, dev, d, i) for i, seg in enumerate(segments)]
    vals = torch.empty((len(rows), k), dtype=torch.float32, device=dev)
    ids = torch.empty((len(rows), k), dtype=torch.int32, device=dev)
    fused = [s for s, n in enumerate(rows) if not uses_sorted_route(k, n)]
    if fused:
        kp = k_padded(k)
        table, n_blocks = launch_table(
            [(_addr(segments[s].vectors), _addr(segments[s].exists),
              _addr(segments[s].live), _addr(segments[s].mask))
             for s in fused],
            [rows[s] for s in fused], fused)
        # one pinned H2D copy; the table, scratch and pinned buffer may be
        # freed on return: both allocators reuse them only after this
        # stream has passed the launch
        table_dev = torch.from_numpy(table).pin_memory().to(
            dev, non_blocking=True)
        scratch = torch.empty(n_blocks * kp, dtype=torch.int64, device=dev)
        lib = _library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.knn_topk_segments_launch(
            _ptr(table_dev), len(fused), n_blocks, _ptr(query), d, k, kp,
            code, _ptr(vals), _ptr(ids), _ptr(scratch),
            ctypes.c_void_p(stream))
        cuda_build.check(lib, rc, "knn_topk_segments_launch")
        cuda_build.count(knn_topk_segments_cuda)
    for s, seg in enumerate(segments):
        if not uses_sorted_route(k, rows[s]):
            continue
        cuda_build.count(knn_topk_segments_cuda,
                         attr="sorted_route_segments")
        v, i = topk(_scores_launch(seg.vectors, seg.exists, seg.live,
                                   seg.mask, query, d, code), k)
        vals[s, : v.shape[0]] = v
        ids[s, : i.shape[0]] = i
        if v.shape[0] < k:
            vals[s, v.shape[0]:] = -torch.inf
            ids[s, v.shape[0]:] = -1
    return vals, ids


knn_topk_segments_cuda.launches = 0
knn_topk_segments_cuda.sorted_route_segments = 0
