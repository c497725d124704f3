"""Wrapper of K5, the hand-written bucket collector (``csrc/aggs.cu``):
the bucket doc counts and per-bucket metric partials of every job of one
call, equal byte for byte to its plain version ``ops/aggs.py``
``bucket_collect_plain`` (the summation order is fixed: see both files).
A job is one key column over one segment; the single mode takes several
columns in one call (``self_metric`` a flag per segment).

``bucket_collect_cuda`` takes ``ops.aggs.CollectSegment``s on one CUDA
device and returns the flat int64 output of ``ops.aggs.output_words``.
It never falls back to the plain version: CPU tensors raise.
``bucket_collect_cuda.launches`` counts calls, ``.kernels`` the kernels
they launched (two without sub-columns: count and scan; four with:
count, scan, reduce, merge).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from opensearch_tpu_torch.ops import cuda_build
from opensearch_tpu_torch.ops.aggs import MODES, output_words

THREADS = 512            # csrc/aggs.cu kThreads (count and reduce)
SCAN_BUCKETS = 8         # buckets a scan block takes (kLineWarps)
MERGE_BUCKETS = 4        # buckets a merge block takes (kMergeWarps)
HEAD_WORDS = 16          # csrc/aggs.cu kHeadWords
CALL_WORDS = 24          # the host words of agg_collect_launch
CHUNK = 4096             # entries a block takes (AGG_CHUNK)
EDGES_SMEM_MAX = 8192    # edges searched in shared memory up to this many
_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float64: 2}
_ALIGN = 16


def defines() -> dict:
    """The macros ``csrc/aggs.cu`` is built with: this module's constants
    at the time of the call."""
    return {"AGG_CHUNK": CHUNK}


def _declare(lib):
    p = ctypes.c_void_p
    lib.agg_collect_launch.argtypes = [p, p, p]
    lib.agg_collect_launch.restype = ctypes.c_int
    lib.agg_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.agg_smem_bytes.restype = ctypes.c_longlong
    lib.agg_chunk.restype = ctypes.c_int


def _library():
    return cuda_build.library("aggs", _declare, defines())


def smem_bytes(which: int, n_edges_smem: int, dense_cols: int,
               rec_stride_max: int) -> int:
    """Dynamic shared memory of a count (``which`` 0) or reduce (1) block
    (``agg_smem_bytes`` of the .cu)."""
    if which == 0:
        return 8 * n_edges_smem + 4 * (CHUNK + 1 + 2 * THREADS
                                       + THREADS // 32 + 1 + dense_cols)
    return 32 * CHUNK + 4 * (2 * rec_stride_max + 1)


def plan_launch(n_buckets_pads, n_edges: int) -> tuple:
    """(edges in shared memory, widest dense row, widest record stride)
    of one call over jobs of these ``n_buckets_pad``: a job of at most
    ``CHUNK`` buckets gets a dense row per chunk; a chunk holds at most
    ``min(CHUNK, n_buckets_pad)`` records."""
    dense = [nbp for nbp in n_buckets_pads if nbp <= CHUNK]
    return (0 < n_edges <= EDGES_SMEM_MAX, max(dense, default=0),
            max((min(CHUNK, nbp) for nbp in n_buckets_pads), default=0))


def launch_table(jobs) -> tuple:
    """The device table of one call and its scratch plan.  ``jobs``: per
    job ``(pointers, sizes)``, pointers ``(matched, keys, key_docs,
    [(values, offsets) per sub-column of the call])`` (0 for an absent
    sub-column), sizes ``(n_entries, n_buckets, n_buckets_pad, output
    offset, key dtype code, self_metric, sub-columns of the job)``.

    Returns ``(table, counts, scratch, job words)``: the table as
    ``csrc/aggs.cu`` reads it (per job ``HEAD_WORDS`` words then 2 per
    sub-column; then a word per chunk ``job << 32 | chunk``, per scan
    block of ``SCAN_BUCKETS`` buckets ``job << 32 | block``, per merge
    block of ``MERGE_BUCKETS`` ``job << 40 | sub << 32 | block``),
    ``counts`` (chunk, scan and merge items) and ``scratch`` {array:
    (elements, bytes each)} for the wrapper to allocate."""
    chunk = CHUNK
    n_call_subs = len(jobs[0][0][3]) if jobs else 0
    job_words = HEAD_WORDS + 2 * n_call_subs
    heads, chunk_items, scan_items, merge_items = [], [], [], []
    at = {"chunks": 0, "slots": 0, "dense": 0, "nodes": 0, "subrec": 0}
    for ji, ((m, k, kd, subs), (n, nb, nbp, off, dt, self_metric,
                                n_subs)) in enumerate(jobs):
        n_chunks = -(-n // chunk)
        stride = min(chunk, nbp)
        dense = at["dense"] if nbp <= chunk else -1
        row = [m, k, kd, n, nb, nbp, off,
               dt | (int(self_metric) << 8) | (n_subs << 16),
               at["chunks"], n_chunks, at["slots"], stride, dense,
               at["nodes"], at["subrec"], 0]
        for vals, offs in subs:
            row += [vals, offs]
        heads.append(row)
        chunk_items.append(np.arange(n_chunks, dtype=np.int64) | (ji << 32))
        scan_items.append(np.arange(-(-nbp // SCAN_BUCKETS),
                                    dtype=np.int64) | (ji << 32))
        blocks = np.arange(-(-nbp // MERGE_BUCKETS), dtype=np.int64)
        merge_items += [blocks | (ji << 40) | (j << 32)
                        for j in range(n_subs)]
        at["chunks"] += n_chunks
        at["slots"] += n_chunks * stride
        if dense >= 0:
            at["dense"] += n_chunks * nbp
        at["nodes"] += n_subs * n_chunks * chunk
        at["subrec"] += n_subs * n_chunks * stride
    lists = [np.concatenate(x) if x else np.zeros(0, np.int64)
             for x in (chunk_items, scan_items, merge_items)]
    table = np.concatenate([np.array(heads, np.int64).reshape(-1), *lists])
    counts = tuple(len(x) for x in lists)
    scratch = {"rec_n": (at["chunks"], 4), "rec_bucket": (at["slots"], 4),
               "rec_cnt": (at["slots"], 4), "rec_loc": (at["slots"], 4),
               "rec_r0": (at["slots"], 4), "dense_idx": (at["dense"], 4),
               "perm": (at["chunks"] * chunk, 2),
               "nodes": (at["nodes"], 8), "sub_cnt": (at["subrec"], 8),
               "sub_min": (at["subrec"], 8), "sub_max": (at["subrec"], 8)}
    return table, counts, scratch, job_words


def scratch_offsets(scratch) -> tuple:
    """Byte offsets of each scratch array in one arena (each aligned to 16
    bytes) and the arena's bytes."""
    offs, at = {}, 0
    for name, (n, size) in scratch.items():
        offs[name] = at
        at += -(-(n * size) // _ALIGN) * _ALIGN
    return offs, at


def _check(t, name, dev, dtypes):
    """``name``: the tensor's path, or ``(segment, path)`` spelled only
    when the check fails."""
    if t.device != dev or t.dtype not in dtypes or t.dim() != 1 \
            or not t.is_contiguous():
        if isinstance(name, tuple):
            name = f"segments[{name[0]}].{name[1]}"
        if t.device != dev:
            raise ValueError(f"[{name}] is on {t.device}, expected {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"[{name}] must be one of {dtypes}, "
                            f"got {t.dtype}")
        raise ValueError(f"[{name}] must be a contiguous vector")


def _self_flags(segments, mode, self_metric) -> list:
    flags = ([bool(f) for f in self_metric]
             if isinstance(self_metric, (list, tuple))
             else [bool(self_metric)] * len(segments))
    if len(flags) != len(segments):
        raise ValueError("self_metric needs one flag per segment")
    if any(flags) and (mode != "single" or segments[0].subs):
        raise ValueError("self_metric takes the single mode and no subs")
    return flags


def bucket_collect_cuda(segments, *, mode: str, edges=None,
                        self_metric=False):
    """K5 over every job of ``segments`` (``ops.aggs.CollectSegment`` on
    one CUDA device: one job each) in one call; see
    ``bucket_collect_plain`` for the modes and the output.
    ``self_metric``: a bool, or in the single mode a flag per segment
    (a batch of columns; each flagged job's output has one sub part)."""
    if mode not in MODES:
        raise ValueError(f"unknown collector mode [{mode}]")
    if not segments:
        raise ValueError("bucket_collect_cuda needs at least one segment")
    dev = segments[0].matched.device
    if dev.type != "cuda":
        raise ValueError(f"bucket_collect_cuda needs CUDA tensors, got {dev}")
    flags = _self_flags(segments, mode, self_metric)
    n_call_subs = len(segments[0].subs)
    n_subs = [1 if f else n_call_subs for f in flags]
    key_dtypes = {torch.int32} if mode == "ordinal" else set(_DTYPES)
    sub_f64 = 0
    jobs = []
    offs = output_words(segments, n_subs)
    for si, seg in enumerate(segments):
        _check(seg.matched, (si, "matched"), dev, {torch.bool})
        _check(seg.keys, (si, "keys"), dev, key_dtypes)
        _check(seg.key_docs, (si, "key_docs"), dev, {torch.int32})
        if seg.keys.shape != seg.key_docs.shape:
            raise ValueError(f"segments[{si}]: keys and key_docs differ")
        if len(seg.subs) != n_call_subs:
            raise ValueError(f"segments[{si}]: sub-column counts differ")
        subs = []
        for j, col in enumerate(seg.subs):
            if col is None:
                subs.append((0, 0))
                continue
            _check(col["values"], (si, f"subs[{j}].values"), dev,
                   {torch.int64, torch.float64})
            _check(col["offsets"], (si, f"subs[{j}].offsets"), dev,
                   {torch.int32})
            if col["offsets"].shape[0] < seg.matched.shape[0] + 1:
                raise ValueError(f"segments[{si}].subs[{j}].offsets must "
                                 "cover every doc slot")
            if col["values"].dtype == torch.float64:
                sub_f64 |= 1 << j
            subs.append((col["values"].data_ptr(),
                         col["offsets"].data_ptr()))
        jobs.append(((seg.matched.data_ptr(), seg.keys.data_ptr(),
                      seg.key_docs.data_ptr(), subs),
                     (seg.keys.shape[0], seg.n_buckets, seg.n_buckets_pad,
                      offs[si], _DTYPES[seg.keys.dtype], flags[si],
                      n_subs[si])))
    n_edges = 0
    if mode == "edges":
        _check(edges, "edges", dev, {torch.float64})
        n_edges = edges.shape[0]
    edges_smem, dense_cols, stride = plan_launch(
        [seg.n_buckets_pad for seg in segments], n_edges)
    table, (n_chunk, n_scan, n_merge), scratch, job_words = \
        launch_table(jobs)
    where, nbytes = scratch_offsets(scratch)
    arena = torch.empty(max(1, nbytes // 8), dtype=torch.int64, device=dev)
    base = arena.data_ptr()
    out = torch.empty(offs[-1], dtype=torch.int64, device=dev)
    words = np.array(
        [len(jobs), job_words, n_chunk, n_scan, n_merge, MODES.index(mode),
         sub_f64, edges.data_ptr() if mode == "edges" else 0, n_edges,
         int(edges_smem), dense_cols, stride, out.data_ptr()]
        + [base + where[name] for name in scratch], np.int64)
    assert words.shape[0] == CALL_WORDS
    # one pinned H2D copy; the buffers may be freed on return: both
    # allocators reuse them only after this stream has passed the launch
    table_dev = torch.from_numpy(table).pin_memory().to(dev,
                                                        non_blocking=True)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.agg_collect_launch(
        ctypes.c_void_p(table_dev.data_ptr()),
        words.ctypes.data_as(ctypes.c_void_p), ctypes.c_void_p(stream))
    cuda_build.check(lib, rc, "agg_collect_launch")
    cuda_build.count(bucket_collect_cuda)
    cuda_build.count(bucket_collect_cuda, kernels_launched(
        n_chunk, n_scan, n_merge), attr="kernels")
    return out


def kernels_launched(n_chunk: int, n_scan: int, n_merge: int) -> int:
    """The kernels one call launches (``agg_collect_launch``)."""
    n = int(n_chunk > 0) + int(n_scan > 0)
    if n_merge:
        n += int(n_chunk > 0) + 1
    return n


bucket_collect_cuda.launches = 0
bucket_collect_cuda.kernels = 0
