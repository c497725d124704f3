"""Wrappers of K8 and K9, the hand-written kernels of
``csrc/positions.cu``, which replace the reference's ``phrase_freqs``
(``ops/phrase.py``) and ``span_near_freqs`` (``ops/span.py``) and the
BM25 scoring after them on CUDA tensors: one launch per request and
kernel over every (leaf, segment) job.

- ``phrase_scores_cuda``: K8, plain twin ``ops/phrase.py``
  ``phrase_scores``;
- ``span_scores_cuda``: K9, plain twin ``ops/span.py`` ``span_scores``.

Each takes a request's ``ops.phrase.PositionalLeaf`` jobs and returns
each job's ``(scores f32 [n_pad], matched bool [n_pad])``: views of one
output arena, zeroed by one memset a request.  The host's part of a call
is ``job_table`` (the launch table: ``JOB_WORDS`` int64 words a job, then
its slots' ``{row start, row end, shift}``; a job that cannot match, an
anchor without entries or for K8 a slot whose term the segment lacks,
gets no words and keeps its zeros), ``upload`` (one copy from a pinned
arena the calling thread reuses), ``zeroed_output``, ``launch`` and
``output_views``.  No launch when no job has work.  They never fall back
to the plain versions: a CUDA tensor gets the kernel or an exception.
``.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import NamedTuple

import numpy as np
import torch

from opensearch_tpu_torch.index.segment import pad_pow2
from opensearch_tpu_torch.ops import cuda_build
from opensearch_tpu_torch.ops.bm25 import B_DEFAULT, K1_DEFAULT
from opensearch_tpu_torch.ops.phrase import POS_BASE, StagedPositions

# The kernels' shape, handed to csrc/positions.cu as -D macros
# (``defines``): anchor positions a block owns, its threads, the blocks
# an SM should hold, a slot window's tile of doc ids, and the ratio of window to entries past which
# a warp searches the window doc by doc instead of walking it.
CHUNK = 1024
THREADS = 256
# blocks an SM should hold (__launch_bounds__' minimum): 6 caps a thread
# at 40 registers, which the block's ~34 KB of shared memory also allows;
# uncapped, the kernels took 66-72 registers, 3 blocks an SM, and ran
# 1.7x slower (``testing/k8_sweep.py``'s variants)
MIN_BLOCKS = 6
TILE_IDS = 1024
SPARSE = 8
JOB_WORDS = 16        # int64 words a job (csrc/positions.cu JobWord)
W_OUT, W_SLOTS, W_NSLOTS, W_BLOCK0 = 4, 5, 6, 7
W_PBEGIN, W_PCOUNT, W_SCORING, W_FLAGS, W_SLOP, W_END = 8, 9, 10, 11, 12, 13
W_ROW0, W_ROW1 = 14, 15
SCORED, ORDERED, SAME_TERM = 1, 2, 4
KINDS = ("phrase", "span")


def _f32_bits(x: float) -> int:
    return int(np.asarray(x, np.float32).view(np.int32))


def defines() -> dict:
    """The -D macros ``csrc/positions.cu`` is built with."""
    return {"POS_CHUNK": CHUNK, "POS_THREADS": THREADS,
            "POS_MIN_BLOCKS": MIN_BLOCKS, "POS_TILE_IDS": TILE_IDS,
            "POS_SPARSE": SPARSE, "POS_JOB_WORDS": JOB_WORDS,
            "POS_BASE": f"{POS_BASE}ll",
            "POS_K1_BITS": _f32_bits(K1_DEFAULT),
            "POS_B_BITS": _f32_bits(B_DEFAULT),
            "POS_ONE_MINUS_B_BITS": _f32_bits(1.0 - B_DEFAULT)}


def _declare(lib):
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.positions_launch.argtypes = [i, p, i, ctypes.c_longlong, p, p, p, p]
    lib.positions_launch.restype = i


def _library():
    return cuda_build.library("positions", _declare, defines())


class JobTable(NamedTuple):
    """The host side of one call: the launch table, its jobs and blocks,
    and each leaf's first element in the outputs (``offsets``, one more
    than leaves: the last is their total)."""

    table: np.ndarray
    n_jobs: int
    n_blocks: int
    offsets: np.ndarray


def _has_work(leaf, span: bool) -> bool:
    """Whether a job can match a doc: an anchor with entries and, for a
    phrase or an ordered span, every slot's term in the segment."""
    sl = leaf.slots
    return sl.n_anchor > 0 and ((span and not leaf.ordered) or sl.complete)


def _int32(x, name: str) -> int:
    """``x`` as the kernel's int argument (the plan passes int32 values)."""
    x = int(x)
    if not -2**31 <= x < 2**31:
        raise ValueError(f"[{name}] {x} does not fit in int32")
    return x


def _check(leaves, kind: str):
    """The device of ``leaves``, which must be CUDA, each job's staged
    columns a ``StagedPositions`` there (checked when staged)."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if not leaves:
        raise ValueError(f"{kind}_scores_cuda needs a job")
    dev = leaves[0].cols.device
    if dev.type != "cuda":
        raise ValueError(f"K8 / K9 need CUDA tensors, got {dev}")
    for i, leaf in enumerate(leaves):
        if not isinstance(leaf.cols, StagedPositions):
            raise TypeError(f"leaves[{i}].cols must be StagedPositions "
                            "(ops.phrase.stage_positions)")
        if leaf.cols.device != dev:
            raise ValueError(f"leaves[{i}] is on {leaf.cols.device}, "
                             f"expected {dev}")
        if kind == "span" and not leaf.ordered and \
                leaf.slots.rows.shape[0] != 2:
            raise ValueError("an unordered span takes exactly 2 clauses")
    return dev


def job_table(leaves, kind: str) -> JobTable:
    """The launch table of one call of ``kind`` ("phrase": K8, "span":
    K9) over ``leaves``: per job with work, ``JOB_WORDS`` words in the
    order of ``csrc/positions.cu``'s ``JobWord`` (its ``StagedPositions``
    addresses, output offset, slots' offset and count, first block, the
    anchor's positions, weight and avgdl as float32 bits, flags, slop,
    end, the anchor's row), then every job's slots
    (``PositionSlots.words``).  A job owns
    ``ceil(positions / CHUNK)`` blocks.  Raises when a job's slots were
    not made (and checked) over columns of its ``StagedPositions``'
    limits."""
    span = kind == "span"
    rows, slot_words = [], []
    out = block0 = slot0 = 0
    for leaf in leaves:
        sl = leaf.slots
        if _has_work(leaf, span):
            if sl.limits != leaf.cols.limits:
                raise ValueError(f"slots over {sl.limits} (posting entries, "
                                 f"positions) given columns of "
                                 f"{leaf.cols.limits}")
            p0, p1 = sl.anchor_positions
            m = len(sl.words)
            rows.append((*leaf.cols.words, out, slot0, m, block0, p0,
                         p1 - p0, struct.unpack("<q", struct.pack(
                             "<ff", leaf.weight, leaf.avgdl))[0],
                         SCORED * bool(leaf.scored)
                         + ORDERED * bool(span and leaf.ordered)
                         + SAME_TERM * bool(sl.same_term),
                         _int32(leaf.slop, "slop") if span else 0,
                         _int32(leaf.end, "end") if span else 0,
                         *sl.anchor_row))
            slot_words.append(sl.words)
            block0 += -(-(p1 - p0) // CHUNK)
            slot0 += 3 * m
        out += leaf.n_pad
    offsets = np.zeros(len(leaves) + 1, np.int64)
    offsets[1:] = np.cumsum([leaf.n_pad for leaf in leaves])
    if not rows:
        return JobTable(np.zeros(0, np.int64), 0, 0, offsets)
    words = np.asarray(rows, np.int64)
    words[:, W_SLOTS] += words.size     # the slots follow the jobs
    return JobTable(np.concatenate([words.reshape(-1)]
                                   + [w.reshape(-1) for w in slot_words]),
                    len(rows), block0, offsets)


class _Arena(threading.local):
    """A calling thread's pinned upload buffer (and its numpy view) and
    the event of its last copy: the buffer is refilled only once that
    copy is done."""

    buf = None
    host = None
    done = None


_arena = _Arena()


def upload(jt: JobTable, dev) -> torch.Tensor:
    """``jt.table`` on ``dev``: one copy from the calling thread's pinned
    arena (grown to a power of two when too small)."""
    n = jt.table.size
    a = _arena
    if a.buf is None or a.buf.numel() < n:
        a.buf = torch.empty(pad_pow2(n), dtype=torch.int64, pin_memory=True)
        a.host = a.buf.numpy()
        a.done = torch.cuda.Event()
    else:
        a.done.synchronize()
    a.host[:n] = jt.table
    table = a.buf[:n].to(dev, non_blocking=True)
    a.done.record()
    return table


def output_bytes(jt: JobTable) -> tuple:
    """(total bytes, scratch's and matched's byte offsets) of one call's
    output arena: scores f32 [n] first, then two ints a block for the
    entries that span blocks, then matched bool [n]."""
    n = int(jt.offsets[-1])
    scratch = 4 * n
    matched = scratch + 8 * jt.n_blocks
    return matched + n, scratch, matched


def zeroed_output(jt: JobTable, dev) -> torch.Tensor:
    """The call's output arena (``output_bytes``), zeroed: one memset."""
    return torch.zeros(output_bytes(jt)[0], dtype=torch.uint8, device=dev)


def launch(kind: str, jt: JobTable, table, out, dev) -> None:
    """One launch of K8 / K9 over ``jt`` (none without a job): the table
    uploaded (``upload``) and the zeroed arena ``out``."""
    if jt.n_jobs == 0:
        return
    _total, scratch, matched = output_bytes(jt)
    base = out.data_ptr()
    lib = _library()
    rc = lib.positions_launch(
        int(kind == "span"), ctypes.c_void_p(table.data_ptr()), jt.n_jobs,
        jt.n_blocks, ctypes.c_void_p(base), ctypes.c_void_p(base + matched),
        ctypes.c_void_p(base + scratch),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    cuda_build.check(lib, rc, f"positions_launch ({kind})")
    cuda_build.count(phrase_scores_cuda if kind == "phrase"
                     else span_scores_cuda)


def output_views(jt: JobTable, out) -> list:
    """Each leaf's ``(scores f32 [n_pad], matched bool [n_pad])``: views
    of the arena ``out``."""
    n = int(jt.offsets[-1])
    _total, _scratch, matched = output_bytes(jt)
    sizes = np.diff(jt.offsets).tolist()
    return list(zip(out[: 4 * n].view(torch.float32).split(sizes),
                    out[matched: matched + n].view(torch.bool).split(sizes)))


def _scores(leaves, kind: str) -> list:
    dev = _check(leaves, kind)
    jt = job_table(leaves, kind)
    table = upload(jt, dev) if jt.n_jobs else None
    out = zeroed_output(jt, dev)
    launch(kind, jt, table, out, dev)
    return output_views(jt, out)


def phrase_scores_cuda(leaves) -> list:
    """Each phrase job's ``(scores, matched)`` (K8): what
    ``ops.phrase.phrase_scores`` returns for the same jobs."""
    return _scores(leaves, "phrase")


phrase_scores_cuda.launches = 0


def span_scores_cuda(leaves) -> list:
    """Each span job's ``(scores, matched)`` (K9): what
    ``ops.span.span_scores`` returns for the same jobs."""
    return _scores(leaves, "span")


span_scores_cuda.launches = 0
