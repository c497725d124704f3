"""Wrapper of K5, the hand-written bucket collector (``csrc/aggs.cu``):
every segment's bucket doc counts and per-bucket metric partials of one
aggregation, in one launch, equal byte for byte to its plain version
``ops/aggs.py`` ``bucket_collect_plain`` (the summation order is fixed:
see both files).

``bucket_collect_cuda`` takes ``ops.aggs.CollectSegment``s on one CUDA
device and returns the flat int64 output of ``ops.aggs.output_words``.
It never falls back to the plain version: CPU tensors raise.
``bucket_collect_cuda.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from opensearch_tpu_torch.ops import cuda_build
from opensearch_tpu_torch.ops.aggs import MODES, output_words

THREADS = 256            # csrc/aggs.cu kThreads
HEAD_WORDS = 8           # csrc/aggs.cu kHeadWords
TILE_MAX = 64            # buckets a block takes, at most
SMEM_MAX = 200 * 1024    # dynamic shared memory a block may ask for
EDGES_SMEM_MAX = 8192    # edges searched in shared memory up to this many
_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float64: 2}


def _declare(lib):
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.agg_collect_launch.argtypes = [p, i, i, i, i, i, i, ctypes.c_uint,
                                       i, i, i, p, i, i, p, p]
    lib.agg_collect_launch.restype = i
    lib.agg_smem_bytes.argtypes = [i, i, i, i]
    lib.agg_smem_bytes.restype = ctypes.c_longlong


def _library():
    return cuda_build.library("aggs", _declare)


def smem_bytes(tile: int, n_subs: int, levels: int, n_edges_smem: int) -> int:
    """A block's dynamic shared memory (``agg_smem_bytes`` of the .cu)."""
    return (8 * (n_subs * tile * levels + 2 * n_subs * tile + 3 * THREADS
                 + n_edges_smem)
            + 8 * (n_subs * tile + tile + THREADS)
            + 4 * (THREADS // 32 * tile + 2 * THREADS + 2))


def plan_launch(n_subs: int, levels: int, n_edges: int) -> tuple:
    """(tile, edges in shared memory) for one launch: the widest tile up
    to ``TILE_MAX`` buckets whose shared memory stays under
    ``SMEM_MAX``."""
    edges_smem = 0 < n_edges <= EDGES_SMEM_MAX
    tile = TILE_MAX
    while tile > 1 and smem_bytes(tile, n_subs, levels,
                                  n_edges if edges_smem else 0) > SMEM_MAX:
        tile //= 2
    if smem_bytes(tile, n_subs, levels, n_edges if edges_smem else 0) \
            > SMEM_MAX:
        raise ValueError(f"{n_subs} sub-columns do not fit one block")
    return tile, edges_smem


def launch_table(ptrs, sizes, tile: int) -> tuple[np.ndarray, int]:
    """The launch's table and its block count.  ``ptrs``: per segment
    ``(matched, keys, key_docs, [(values, offsets) per sub])`` device
    addresses (0 for an absent sub-column); ``sizes``: per segment
    ``(n_entries, n_buckets, n_buckets_pad, output offset)``.  Layout as
    ``csrc/aggs.cu`` reads it: per segment ``HEAD_WORDS`` words then 2 per
    sub-column, then one word per block, ``segment << 32 | tile``."""
    n_seg = len(sizes)
    n_subs = len(ptrs[0][3]) if n_seg else 0
    seg_words = HEAD_WORDS + 2 * n_subs
    tiles = [-(-nbp // tile) for _n, _nb, nbp, _o in sizes]
    work = [(s << 32) | t for s in range(n_seg) for t in range(tiles[s])]
    table = np.zeros(n_seg * seg_words + len(work), np.int64)
    for s, ((m, k, kd, subs), (n, nb, nbp, off)) in enumerate(
            zip(ptrs, sizes)):
        row = [m, k, kd, n, nb, nbp, off, 0]
        for vals, offs in subs:
            row += [vals, offs]
        table[s * seg_words: (s + 1) * seg_words] = row
    table[n_seg * seg_words:] = work
    return table, len(work)


def _check(t, name, dev, dtypes):
    if t.device != dev:
        raise ValueError(f"[{name}] is on {t.device}, expected {dev}")
    if t.dtype not in dtypes:
        raise TypeError(f"[{name}] must be one of {dtypes}, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"[{name}] must be a contiguous vector")


def bucket_collect_cuda(segments, *, mode: str, edges=None,
                        self_metric: bool = False):
    """K5 over every segment of ``segments`` (``ops.aggs.CollectSegment``
    on one CUDA device) in one launch; see ``bucket_collect_plain`` for
    the modes and the output."""
    if mode not in MODES:
        raise ValueError(f"unknown collector mode [{mode}]")
    if not segments:
        raise ValueError("bucket_collect_cuda needs at least one segment")
    dev = segments[0].matched.device
    if dev.type != "cuda":
        raise ValueError(f"bucket_collect_cuda needs CUDA tensors, got {dev}")
    n_subs = len(segments[0].subs)
    if self_metric:
        if mode != "single" or n_subs:
            raise ValueError("self_metric takes the single mode and no subs")
        n_subs = 1
    key_dtype = segments[0].keys.dtype
    if mode == "ordinal" and key_dtype != torch.int32:
        raise TypeError("ordinal keys must be int32")
    sub_f64 = 0
    ptrs, sizes = [], []
    offs = output_words(segments, n_subs)
    longest = 1
    for si, seg in enumerate(segments):
        _check(seg.matched, f"segments[{si}].matched", dev, {torch.bool})
        _check(seg.keys, f"segments[{si}].keys", dev, {key_dtype})
        _check(seg.key_docs, f"segments[{si}].key_docs", dev, {torch.int32})
        if seg.keys.shape != seg.key_docs.shape:
            raise ValueError(f"segments[{si}]: keys and key_docs differ")
        if len(seg.subs) != len(segments[0].subs):
            raise ValueError(f"segments[{si}]: sub-column counts differ")
        subs = []
        for j, col in enumerate(seg.subs):
            if col is None:
                subs.append((0, 0))
                continue
            _check(col["values"], f"segments[{si}].subs[{j}].values", dev,
                   {torch.int64, torch.float64})
            _check(col["offsets"], f"segments[{si}].subs[{j}].offsets", dev,
                   {torch.int32})
            if col["offsets"].shape[0] < seg.matched.shape[0] + 1:
                raise ValueError(f"segments[{si}].subs[{j}].offsets must "
                                 "cover every doc slot")
            if col["values"].dtype == torch.float64:
                sub_f64 |= 1 << j
            subs.append((col["values"].data_ptr(),
                         col["offsets"].data_ptr()))
        if self_metric:
            subs = [(0, 0)]      # the key column is the metric
        n = seg.keys.shape[0]
        longest = max(longest, n)
        ptrs.append((seg.matched.data_ptr(), seg.keys.data_ptr(),
                     seg.key_docs.data_ptr(), subs))
        sizes.append((n, seg.n_buckets, seg.n_buckets_pad, offs[si]))
    n_edges = 0
    if mode == "edges":
        _check(edges, "edges", dev, {torch.float64})
        n_edges = edges.shape[0]
    levels = max(1, longest.bit_length())
    tile, edges_smem = plan_launch(n_subs, levels, n_edges)
    table, n_blocks = launch_table(ptrs, sizes, tile)
    # one pinned H2D copy; the buffers may be freed on return: both
    # allocators reuse them only after this stream has passed the launch
    table_dev = torch.from_numpy(table).pin_memory().to(dev,
                                                        non_blocking=True)
    out = torch.empty(offs[-1], dtype=torch.int64, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.agg_collect_launch(
        ctypes.c_void_p(table_dev.data_ptr()), len(segments), n_blocks,
        HEAD_WORDS + 2 * n_subs, MODES.index(mode), _DTYPES[key_dtype],
        n_subs, sub_f64, int(self_metric), tile, levels,
        ctypes.c_void_p(edges.data_ptr() if mode == "edges" else 0),
        n_edges, int(edges_smem), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(stream))
    cuda_build.check(lib, rc, "agg_collect_launch")
    cuda_build.count(bucket_collect_cuda)
    return out


bucket_collect_cuda.launches = 0
