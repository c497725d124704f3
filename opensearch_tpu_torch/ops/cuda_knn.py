"""Wrappers of K1, the hand-written exact k-NN kernel (``csrc/knn.cu``)
-- the counterpart of the JAX package's ``ops/pallas_knn.py``
(``knn_scores_pallas``) and of the ``lax.top_k`` after it, for all
three spaces and any row count, and of score scripts' vector functions.

- ``knn_topk_segments_cuda``: one launch per query over every segment
  of a shard, each segment's exact top-k computed inside the kernel.
  Its plain twin is ``ops/knn.py::knn_topk_segments``.  The segments
  for which ``uses_sorted_route`` holds (``k > K_MAX``, or more merge
  candidates than ``MERGE_MAX_CANDIDATES``) take one launch of the
  scores entry over all of them plus the stable sort
  (``ops/bm25.py::topk``) of each instead; ``sorted_route_segments``
  counts those segments.
- ``knn_scores_segments_cuda``: one launch of the scores entry over a
  table of segments, any of the six functions of ``ops/knn.py``
  ``FUNCTIONS`` (``script_score``'s vector functions, the sorted
  route).  Its plain twin is ``ops/knn.py::vector_scores_segments``.
- ``knn_scores_cuda``: the scores of one segment, a table of one.  Its
  plain twin is ``knn_scores_plain`` (``ops/knn.py::knn_scores``).

None ever falls back to its plain twin: a CUDA tensor gets the kernel
or an exception.  ``.launches`` on each wrapper counts the kernel
launches made through it.
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import numpy as np
import torch

from opensearch_tpu_torch.ops import cuda_build
from opensearch_tpu_torch.ops.bm25 import topk
from opensearch_tpu_torch.ops.knn import (  # noqa: F401
    FUNCTIONS, KnnSegment, knn_scores as knn_scores_plain, row_lanes)

SPACE_CODES = {"l2": 0, "cosinesimil": 1, "innerproduct": 2}
# the scores entry's function codes: the spaces, then the script functions
FN_CODES = {fn: code for code, fn in enumerate(FUNCTIONS)}
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
# The scores entry's chunk: whole passes of a block, as few as still give
# SCORE_WAVES waves of SCORE_BLOCKS_PER_SM resident blocks on every SM, at
# most SCORE_MAX_PASSES.  Two waves is the least the design asks for, so
# that a one-segment call of 65,536 rows still fills the card;
# SCORE_BLOCKS_PER_SM is the kernel's __launch_bounds__ minimum
# (KNN_SCORE_MIN_BLOCKS).
SCORE_WAVES = 2
SCORE_BLOCKS_PER_SM = 4
SCORE_MAX_PASSES = 64


def defines() -> dict:
    """The macros ``csrc/knn.cu`` is built with: this module's constants
    at the time of the call."""
    return {"KNN_CHUNK_ROWS": CHUNK_ROWS, "KNN_K_MAX": K_MAX,
            "KNN_SEG_WORDS": SEG_WORDS,
            "KNN_SCORE_MIN_BLOCKS": SCORE_BLOCKS_PER_SM}


def _declare(lib):
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.knn_scores_segments_launch.argtypes = [p, i, i, p, i, i, i, i, p, p]
    lib.knn_scores_segments_launch.restype = i
    lib.knn_topk_segments_launch.argtypes = [p, i, i, p, i, i, i, i, p, p,
                                             p, p]
    lib.knn_topk_segments_launch.restype = i
    for name in ("knn_d_max", "knn_scores_threads"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.knn_row_lanes.argtypes = [i]
    lib.knn_row_lanes.restype = i
    lib.d_max = lib.knn_d_max()   # largest d the build takes, read once
    lib.score_threads = lib.knn_scores_threads()


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
    for name in ("exists", "live", "mask"):
        part = getattr(seg, name)
        if part is not None:
            _expect(part, f"segments[{i}].{name}", torch.bool, dev, (n,))
    return n


def score_chunk_rows(rows: int, d: int, sms: int, threads: int = 256) -> int:
    """Rows a block of the scores entry takes over a table of ``rows``
    rows in all: whole passes of the block (``threads / row_lanes(d)``
    rows each), the most passes, a power of two up to
    ``SCORE_MAX_PASSES``, that still make ``SCORE_WAVES`` waves of
    ``SCORE_BLOCKS_PER_SM`` blocks on ``sms`` SMs."""
    per_pass = threads // row_lanes(d)
    target = SCORE_WAVES * SCORE_BLOCKS_PER_SM * sms
    passes = 1
    while passes < SCORE_MAX_PASSES and \
            -(-rows // (per_pass * passes * 2)) >= target:
        passes *= 2
    return per_pass * passes


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _upload(table, dev):
    """One pinned H2D copy of a launch table; the table and the pinned
    buffer may be freed on return: both allocators reuse them only after
    this stream has passed the launch."""
    return torch.from_numpy(table).pin_memory().to(dev, non_blocking=True)


def _scores_table_launch(segments, query, d, code, counter):
    """One launch of the scores entry over ``segments`` (checked
    ``KnnSegment``s on the query's device): a flat float32 output, one
    view per segment.  The launch table's head reaches the card by one
    pinned copy.  Counts the launch on ``counter``."""
    dev = query.device
    rows = [seg.vectors.shape[0] for seg in segments]
    offsets = list(itertools.accumulate(rows, initial=0))
    out = torch.empty(offsets[-1], dtype=torch.float32, device=dev)
    views = [out[a: b] for a, b in zip(offsets[:-1], offsets[1:])]
    if not segments:
        return views
    lib = _library()
    chunk = score_chunk_rows(offsets[-1], d, _sm_count(dev.index),
                             lib.score_threads)
    head, n_blocks = launch_table(
        [(_addr(s.vectors), _addr(s.exists), _addr(s.live), _addr(s.mask))
         for s in segments], rows, offsets[:-1], chunk_rows=chunk,
        work_list=False)
    aligned = all(_addr(s.vectors) % 16 == 0 for s in segments)
    head_dev = _upload(head, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.knn_scores_segments_launch(
        _ptr(head_dev), len(segments), n_blocks, _ptr(query), d, chunk,
        int(aligned), code, _ptr(out), ctypes.c_void_p(stream))
    cuda_build.check(lib, rc, "knn_scores_segments_launch")
    cuda_build.count(counter)
    return views


def knn_scores_segments_cuda(segments, query, *, fn: str):
    """``fn`` (one of ``ops/knn.py`` ``FUNCTIONS``) of every row of every
    segment against ``query`` f32 [d], in ONE launch: one float32 [n_s]
    per segment (views of one buffer), -inf where ``exists & live &
    mask`` is False (``exists`` None: every row valid).  ``segments``
    are ``ops.knn.KnnSegment``s on the query's device; a segment of no
    rows takes no block."""
    code = FN_CODES.get(fn)
    if code is None:
        raise ValueError(f"unknown function [{fn}]")
    dev, d = _check_query(query, "knn_scores_segments_cuda")
    for i, seg in enumerate(segments):
        _check_segment(seg, dev, d, i)
    return _scores_table_launch(segments, query, d, code,
                                knn_scores_segments_cuda)


knn_scores_segments_cuda.launches = 0


def knn_scores_cuda(vectors, valid, query, *, space: str):
    """Per-row scores float32 [n] of ``vectors`` f32 [n, d] against
    ``query`` f32 [d]; rows with ``valid`` (bool [n]) False score
    -inf.  One launch of the scores entry over a table of one
    segment."""
    code = _space_code(space)
    dev, d = _check_query(query, "knn_scores_cuda")
    seg = KnnSegment(vectors, valid)
    _check_segment(seg, dev, d, 0)
    return _scores_table_launch([seg], query, d, code, knn_scores_cuda)[0]


knn_scores_cuda.launches = 0


# -- the fused top-k: host-side layout (pure Python, tested on the CPU) --

def k_padded(k: int) -> int:
    """Candidates each chunk keeps: ``k`` rounded up to a power of two."""
    return 1 << (int(k) - 1).bit_length()


def n_chunks(n: int, chunk_rows: int = 0) -> int:
    """Blocks of a launch for a segment of ``n`` rows, ``chunk_rows`` a
    block (``CHUNK_ROWS`` when 0, read at the call: the sweeps change
    it) -- one even when it has none, so its output row is written."""
    return max(1, -(-int(n) // (chunk_rows or CHUNK_ROWS)))


def uses_sorted_route(k: int, n: int) -> bool:
    """True when the segment of ``n`` rows is served at ``k`` by the
    scores-only entry plus the stable sort: ``k`` above what the kernel
    selects in shared memory, or a merge of more than
    ``MERGE_MAX_CANDIDATES`` candidates."""
    return k > K_MAX or n_chunks(n) * k_padded(k) > MERGE_MAX_CANDIDATES


def launch_table(ptrs, rows, out_rows=None, chunk_rows: int = 0,
                 work_list: bool = True) -> tuple[np.ndarray, int]:
    """A launch's table, one int64 buffer copied to the card per call,
    and its block count, at ``chunk_rows`` rows a
    block (0: the top-k entry's ``CHUNK_ROWS``; the scores entry's
    ``score_chunk_rows``, which reads the head alone: ``work_list``
    False leaves out the work list and the counters).

    ``ptrs`` holds one ``(vectors, exists, live, mask)`` tuple of device
    addresses per segment (0 for an absent live or mask), ``rows`` each
    segment's row count, ``out_rows`` the row of the output each segment
    writes (by default its position; the scores entry: its first
    element of the flat output).  Layout (``csrc/knn.cu`` reads it
    so): ``SEG_WORDS`` words per segment ``{vectors, exists, live, mask,
    n, first chunk, chunks, output row}``; then the work list, one word
    per block, ``segment << 32 | chunk``; then one int32 counter per
    segment, zero."""
    n_seg = len(rows)
    chunks = [n_chunks(n, chunk_rows) for n in rows]
    first = list(itertools.accumulate(chunks, initial=0))
    n_blocks = first[-1]
    table = np.zeros(n_seg * SEG_WORDS + (
        n_blocks + (n_seg + 1) // 2 if work_list else 0), np.int64)
    if n_seg:
        outs = range(n_seg) if out_rows is None else out_rows
        table[: n_seg * SEG_WORDS].reshape(n_seg, SEG_WORDS)[:, :8] = \
            np.fromiter(itertools.chain.from_iterable(
                (*p, n, f, c, o)
                for p, n, f, c, o in zip(ptrs, rows, first, chunks, outs)),
                np.int64, 8 * n_seg).reshape(n_seg, 8)
    if not work_list:
        return table, n_blocks
    seg_of = np.repeat(np.arange(n_seg, dtype=np.int64), chunks)
    chunk_of = np.arange(n_blocks, dtype=np.int64) - \
        np.asarray(first[:-1], np.int64)[seg_of]
    table[n_seg * SEG_WORDS: n_seg * SEG_WORDS + n_blocks] = \
        (seg_of << 32) | chunk_of
    return table, n_blocks


def knn_topk_segments_cuda(segments, query, *, space: str, k: int):
    """Exact top-k of every segment against ``query`` f32 [d]:
    ``(vals f32 [S, k], ids i32 [S, k])``.  Row ``s`` holds the first
    ``min(k, n_s)`` entries of a stable descending sort of segment
    ``s``'s scores (rows not ``exists & live & mask`` at -inf), then
    ``(-inf, -1)``.  ``segments`` are ``ops.knn.KnnSegment``s on the
    query's device, each with an ``exists`` mask.  One launch for the
    segments of the fused route; one launch of the scores entry over all
    the segments of the sorted route (``uses_sorted_route``), counted on
    ``knn_scores_segments_cuda``, and the stable sort of each."""
    code = _space_code(space)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    dev, d = _check_query(query, "knn_topk_segments_cuda")
    rows = [_check_segment(seg, dev, d, i) for i, seg in enumerate(segments)]
    if any(seg.exists is None for seg in segments):
        raise TypeError("knn_topk_segments_cuda needs every segment's "
                        "[exists] mask")
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
        table_dev = _upload(table, dev)
        # scratch may be freed on return, as the table (``_upload``)
        scratch = torch.empty(n_blocks * kp, dtype=torch.int64, device=dev)
        lib = _library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.knn_topk_segments_launch(
            _ptr(table_dev), len(fused), n_blocks, _ptr(query), d, k, kp,
            code, _ptr(vals), _ptr(ids), _ptr(scratch),
            ctypes.c_void_p(stream))
        cuda_build.check(lib, rc, "knn_topk_segments_launch")
        cuda_build.count(knn_topk_segments_cuda)
    by_sort = [s for s, n in enumerate(rows) if uses_sorted_route(k, n)]
    if by_sort:
        cuda_build.count(knn_topk_segments_cuda, len(by_sort),
                         attr="sorted_route_segments")
        scores = _scores_table_launch([segments[s] for s in by_sort], query,
                                      d, code, knn_scores_segments_cuda)
        for s, sc in zip(by_sort, scores):
            v, i = topk(sc, k)
            vals[s, : v.shape[0]] = v
            ids[s, : i.shape[0]] = i
            if v.shape[0] < k:
                vals[s, v.shape[0]:] = -torch.inf
                ids[s, v.shape[0]:] = -1
    return vals, ids


knn_topk_segments_cuda.launches = 0
knn_topk_segments_cuda.sorted_route_segments = 0
