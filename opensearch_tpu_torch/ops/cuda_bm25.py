"""Wrappers of K2, the hand-written term-bag kernel (``csrc/bm25.cu``),
which replaces the reference's ``gather_postings`` + ``impact_scores`` /
``impact_score_count`` / ``match_count`` on CUDA tensors, and on the
``match`` path the ``run_topk`` after them; and of K3
(``csrc/union_topk.cu``), the batched path's kernel, which replaces
``search/batch.py`` ``batch_impact_union_topk``.

- ``term_bag_topk_segments_cuda``: one launch per ``match`` query over
  every segment of a shard, each segment's exact top-k, matched total
  and max computed inside the kernel.  Its plain twin is
  ``ops/bm25.py::term_bag_topk_segments``.  At ``k > K_MAX`` every
  segment takes the dense entry plus the stable sort instead
  (``ops/bm25.py::segment_topk``); ``sorted_route_segments`` counts
  those.
- ``term_bag_dense_cuda``: a bag's dense scores and/or matched-slot
  counts over every segment of a request (``bool``, ``constant_score``,
  ``count``, filter bags, ``postings_mask``, the k-NN filter), in one
  launch per row layout (one for the f32 segments, counted on
  ``dense_f32``, one for the quantized ones of each qvals dtype, on
  ``dense_quantized``): the top-k entry's tile core, a block per (segment,
  ``FOLD_TILE_DOCS`` docs) that adds the slots from the launch table
  (``dense_table``) in slot order in shared memory and writes its tile
  once into one output arena.  Its plain twin is
  ``ops/bm25.py::term_bag_dense``.
- ``batch_term_bag_topk_cuda`` (K3): one launch of ``union_topk.cu`` per
  msearch or continuous-batch group, persistent blocks per (query chunk,
  segment) staging each union posting once in shared memory and scoring
  every query of the chunk from there (``union_table``), each (query,
  segment)'s exact top-k, total and max.  Its plain twin is
  ``search/batch.py::batch_term_bag_topk_segments``.
- K4, the quantized row layout (int8/int16 impacts and bit-packed doc
  ids, ``index/codec.py``), which replaces the reference's
  ``gather_postings_packed`` and ``ops/quantized.py``:
  ``term_bag_topk_quantized_cuda``, the top-k entry over quantized
  segments, its own kernel (``csrc/quant_topk.cu``: each block stages its
  tile's run of every row in shared memory with bulk asynchronous copies
  and decodes the ids there; ``term_bag_topk_segments_cuda`` sends a
  shard's quantized segments there, one launch per qvals dtype, beside
  one f32 launch for the others), and the quantized instantiation of
  the dense entry's kernel, which ``term_bag_dense_cuda`` launches for
  quantized segments.
  Their plain twins are ``ops/bm25.py::term_bag_topk_segments`` and
  ``ops/bm25.py::term_bag_dense`` (``ops/quantized.py``'s ``*_plain``
  functions).

None ever falls back to its plain twin: a CUDA tensor gets the kernel
or an exception.  ``.launches`` on each wrapper (on ``dense_f32`` and
``dense_quantized`` for the dense entry) counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from opensearch_tpu_torch.ops import bm25, cuda_build

# The launch table's layout and the tile decision, handed to csrc/bm25.cu
# and csrc/quant_topk.cu as -D macros when they are built (see ``defines``
# and ``quant_defines``).
TILE_DOCS = 4096      # docs a block of a top-k entry owns (K2 and K4)
# docs a block of the dense (per-slot) entry owns: the fastest of 512 to
# 4,096 over the 16 scale segments in one launch, on the median and the
# heaviest bag (``testing/k2_sweep.py``'s dense sweep)
FOLD_TILE_DOCS = 2048
K_MAX = 256           # largest k selected inside the kernel
SEG_WORDS = 11        # int64 words per segment in the launch table
QSEG_WORDS = 13       # ... per quantized segment
QSLOT_WORDS = 4       # ... per slot of a quantized segment (f32: 2)
# K4 stages each row's run of a tile with bulk copies of whole 16-byte
# units: every staged quantized column starts on, and spans, a whole number
# of them (DeviceSegment.quantized pads them so)
STAGE_ALIGN = 16
# qvals dtype -> the kernel's code width in bytes
_Q_BYTES = {torch.int8: 1, torch.int16: 2}


def defines() -> dict:
    """The macros ``csrc/bm25.cu`` is built with: this module's constants
    at the time of the call."""
    return {"BM25_TILE_DOCS": TILE_DOCS, "BM25_K_MAX": K_MAX,
            "BM25_SEG_WORDS": SEG_WORDS, "BM25_QSEG_WORDS": QSEG_WORDS,
            "BM25_QSLOT_WORDS": QSLOT_WORDS,
            "BM25_FOLD_TILE_DOCS": FOLD_TILE_DOCS}


def quant_defines() -> dict:
    """The macros ``csrc/quant_topk.cu`` is built with."""
    return {"QUANT_TILE_DOCS": TILE_DOCS, "QUANT_K_MAX": K_MAX,
            "QUANT_SEG_WORDS": QSEG_WORDS, "QUANT_SLOT_WORDS": QSLOT_WORDS}


def _declare(lib):
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.term_bag_dense_launch.argtypes = [p, i, i, i, i, p, p, p]
    lib.term_bag_dense_launch.restype = i
    lib.term_bag_topk_segments_launch.argtypes = [
        p, i, i, i, i, i, ctypes.c_float, p, p, p, p, p, p]
    lib.term_bag_topk_segments_launch.restype = i


def _library():
    return cuda_build.library("bm25", _declare, defines())


def _quant_declare(lib):
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.quant_topk_launch.argtypes = [
        p, i, i, i, i, i, ctypes.c_float, p, p, p, p, p, i, p]
    lib.quant_topk_launch.restype = i


def _quant_library():
    return cuda_build.library("quant_topk", _quant_declare, quant_defines())


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


def _q_bytes(qvals) -> int:
    q_bytes = _Q_BYTES.get(qvals.dtype)
    if q_bytes is None:
        raise TypeError(f"[qvals] has dtype {qvals.dtype}, expected int8 or "
                        "int16")
    return q_bytes


def _check_width(width: int) -> None:
    if not 1 <= int(width) <= 31:
        raise ValueError(f"width must be in 1..31, got {width}")


def _check_dense(bags, what: str, scores: bool):
    """The device of ``bags`` (``bm25.DenseBag``s), which must be CUDA;
    each bag's row tensors checked."""
    if not bags:
        raise ValueError(f"{what} needs a bag")
    dev = bags[0].offsets.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    for i, bag in enumerate(bags):
        if bag.quant is not None:
            q = bag.quant
            _check_width(q.width)
            _q_bytes(q.qvals)
            _expect(q.qvals, f"bags[{i}].qvals", q.qvals.dtype, dev)
            _expect(q.packed, f"bags[{i}].packed", torch.int32, dev)
            _expect(q.exact_vals, f"bags[{i}].exact_vals", torch.float32,
                    dev)
            continue
        _expect(bag.doc_ids, f"bags[{i}].doc_ids", torch.int32, dev)
        if scores:
            _expect(bag.impacts, f"bags[{i}].impacts", torch.float32, dev)
            if bag.impacts.shape[0] != bag.doc_ids.shape[0]:
                raise ValueError(f"bags[{i}]: impacts and doc_ids differ in "
                                 "length")
    return dev


def dense_table(bags, out_offsets, scores: bool) -> tuple[np.ndarray, int,
                                                          int]:
    """The dense entry's launch table of ``bm25.DenseBag``s all of one row
    layout, its block count and its slot count: ``launch_table``'s layout
    at ``FOLD_TILE_DOCS`` docs a block, each segment's output row its
    offset ``out_offsets[i]`` in the output arena, no counters.  Each
    segment's row pointers are ``(doc_ids, impacts)`` (impacts 0 when
    only counts are asked for) or ``(packed, qvals)`` on a quantized
    one."""
    active = [np.asarray(b.active, bool) for b in bags]
    act = np.concatenate(active)
    quant = bags[0].quant is not None

    def ptrs(b):
        if quant:
            return (b.quant.packed.data_ptr(), b.quant.qvals.data_ptr(), 0)
        return (b.doc_ids.data_ptr(), b.impacts.data_ptr() if scores else 0,
                0)

    return launch_table(
        [ptrs(b) for b in bags], [b.n_pad for b in bags],
        [int(a.sum()) for a in active],
        np.concatenate([b.rows for b in bags])[act],
        np.concatenate([b.idfs for b in bags])[act],
        np.concatenate([b.weights for b in bags])[act], 0, False,
        out_rows=out_offsets,
        quant=_quant_words(bags, act) if quant else None,
        tile_docs=FOLD_TILE_DOCS, counters=False)


def dense_launches(bags, scores: bool) -> tuple[np.ndarray, list]:
    """The host side of one dense call over ``bags``: the output arena's
    offsets (each segment's ``n_pad`` docs end to end) and, per row layout
    present in order of first appearance, ``(positions of its bags,
    table, blocks, slots, q_bytes)``: one launch each, f32 (q_bytes 0),
    then int8 (1) or int16 (2) quantized, each table ``dense_table`` of its
    bags writing at their offsets."""
    offsets = np.concatenate([[0], np.cumsum([b.n_pad for b in bags],
                                             dtype=np.int64)])
    groups: dict = {}
    for i, bag in enumerate(bags):
        groups.setdefault(_layout(bag), []).append(i)
    launches = []
    for layout, idx in groups.items():
        table, n_blocks, n_slots = dense_table(
            [bags[i] for i in idx], offsets[idx], scores)
        launches.append((idx, table, n_blocks, n_slots,
                         0 if layout is None else _Q_BYTES[layout]))
    return offsets, launches


class LaunchCount:
    """Launches of one row layout of the dense entry (``.launches``):
    ``term_bag_dense_cuda`` adds to ``dense_f32`` for its f32 launch and
    to ``dense_quantized`` for each quantized one."""

    def __init__(self):
        self.launches = 0


dense_f32 = LaunchCount()
dense_quantized = LaunchCount()


def term_bag_dense_cuda(bags, *, scores: bool, counts: bool) -> list:
    """Each bag's dense ``(scores f32 [n_pad] | None, counts i32 [n_pad] |
    None)`` over every segment of ``bags`` (``bm25.DenseBag``s on one
    CUDA device): views of one output arena per column, each segment's
    docs written whole, zeros included; one launch for the f32 segments
    (counted on ``dense_f32``) and one for the quantized segments of each
    qvals dtype (on ``dense_quantized``).  A segment without the field
    (``build_arrays``' stand-in rows, no active slot) gets its zero
    columns."""
    dev = _check_dense(bags, "term_bag_dense_cuda", scores)
    offsets, launches = dense_launches(bags, scores)
    n = int(offsets[-1])
    out_s = (torch.empty(n, dtype=torch.float32, device=dev)
             if scores else None)
    out_c = torch.empty(n, dtype=torch.int32, device=dev) if counts else None
    if scores or counts:
        lib = _library()
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        for idx, table, n_blocks, n_slots, q_bytes in launches:
            table_dev = torch.from_numpy(table).pin_memory().to(
                dev, non_blocking=True)
            rc = lib.term_bag_dense_launch(
                _ptr(table_dev), len(idx), n_slots, n_blocks, q_bytes,
                _ptr(out_s), _ptr(out_c), stream)
            cuda_build.check(lib, rc, "term_bag_dense_launch")
            cuda_build.count(dense_quantized if q_bytes else dense_f32)
    sizes = [b.n_pad for b in bags]
    return list(zip(*(
        [None] * len(bags) if out is None else out.split(sizes)
        for out in (out_s, out_c))))


# -- the fused top-k: host-side layout (pure Python, tested on the CPU) --

def k_padded(k: int) -> int:
    """Candidates each tile keeps: ``k`` rounded up to a power of two."""
    return 1 << (int(k) - 1).bit_length()


def n_tiles(n_pad: int, tile_docs: int = 0) -> int:
    """Blocks of a launch for a segment of ``n_pad`` docs at
    ``tile_docs`` docs a block (``TILE_DOCS``, the top-k entry's, when
    0), at least one."""
    return max(1, -(-int(n_pad) // (tile_docs or TILE_DOCS)))


def _f32_bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)


def launch_table(ptrs, n_pads, slot_counts, rows, idfs, weights, required,
                 fast, out_rows=None, quant=None, tile_docs: int = 0,
                 counters: bool = True) -> tuple[np.ndarray, int, int]:
    """The top-k launch's table, one int64 buffer copied to the card per
    query, its block count and its slot count.

    Per segment: ``ptrs`` one ``(doc_ids, impacts, live)`` tuple of
    device addresses, ``n_pads`` its doc count, ``slot_counts`` its
    active slots, ``required`` and ``fast`` its bag's matched-slot count
    and fast-path flag, ``out_rows`` the row of the output it writes (by
    default its position).  Per active slot, segment after segment and
    in slot order within one: ``rows`` ``[n, 2]`` its posting range,
    ``idfs`` and ``weights`` its float32 idf and weight.  Layout
    (``csrc/bm25.cu`` reads it so): ``SEG_WORDS`` words per segment
    ``{doc_ids, impacts, live, n_pad, first tile, tiles, output row, first
    slot, slots, required, fast}``; then two words per slot ``{start |
    end << 32, idf bits | weight bits << 32}``; then the work list, one
    word per block, ``segment << 32 | tile``; then ``3 * n_seg`` int32
    zeros (tile counters, totals, max keys).

    ``quant`` lays out a table of quantized segments (K4): ``(seg_extra
    [n_seg, 2], slot_extra [n_slots, 2])`` int64.  Each segment's
    pointers are then ``(packed, qvals, live)`` and its entry has
    ``QSEG_WORDS`` words, ending ``{exact_vals, width}``; each slot has
    ``QSLOT_WORDS`` words, ending ``{base | scale bits << 32, exact
    start | exact << 32}``.  ``tile_docs`` is the docs of a block
    (``TILE_DOCS`` when 0; the dense entry's ``FOLD_TILE_DOCS``);
    ``counters`` False leaves out the zeros the dense entry does not
    use."""
    n_seg = len(n_pads)
    seg_words, slot_words = ((SEG_WORDS, 2) if quant is None
                             else (QSEG_WORDS, QSLOT_WORDS))
    tiles = np.asarray([n_tiles(n, tile_docs) for n in n_pads], np.int64)
    first = np.concatenate([[0], np.cumsum(tiles)])
    n_blocks = int(first[-1])
    slot_first = np.concatenate([[0], np.cumsum(slot_counts,
                                                dtype=np.int64)])
    n_slots = int(slot_first[-1])
    head_words = n_seg * seg_words
    table = np.zeros(head_words + slot_words * n_slots + n_blocks
                     + ((3 * n_seg + 1) // 2 if counters else 0), np.int64)
    if n_seg:
        head = table[:head_words].reshape(n_seg, seg_words)
        head[:, 0:3] = ptrs
        head[:, 3] = n_pads
        head[:, 4] = first[:-1]
        head[:, 5] = tiles
        head[:, 6] = range(n_seg) if out_rows is None else out_rows
        head[:, 7] = slot_first[:-1]
        head[:, 8] = slot_counts
        head[:, 9] = required
        head[:, 10] = fast
        if quant is not None:
            head[:, 11:13] = quant[0]
    if n_slots:
        rows = np.asarray(rows, np.int64).reshape(n_slots, 2)
        words = table[head_words: head_words + slot_words * n_slots
                      ].reshape(n_slots, slot_words)
        words[:, 0] = rows[:, 0] | (rows[:, 1] << 32)
        words[:, 1] = (_f32_bits(idfs)
                       | (_f32_bits(weights) << np.uint64(32))).view(np.int64)
        if quant is not None:
            words[:, 2:4] = quant[1]
    seg_of = np.repeat(np.arange(n_seg, dtype=np.int64), tiles)
    tile_of = np.arange(n_blocks, dtype=np.int64) - first[:-1][seg_of]
    at = head_words + slot_words * n_slots
    table[at: at + n_blocks] = (seg_of << 32) | tile_of
    return table, n_blocks, n_slots


def _quant_words(segments, act) -> tuple:
    """``launch_table``'s ``quant`` of quantized ``TermBagSegment``s:
    per segment ``{exact_vals address, width}``, per active slot ``{base
    | scale bits << 32, exact start | exact << 32}``."""
    seg_extra = [(seg.quant.exact_vals.data_ptr(), seg.quant.width)
                 for seg in segments]
    base = np.concatenate([seg.quant.slot_base for seg in segments])[act]
    scale = np.concatenate([seg.quant.slot_scale for seg in segments])[act]
    exact = np.concatenate([seg.quant.slot_exact for seg in segments])[act]
    slot_extra = np.zeros((len(base), 2), np.int64)
    slot_extra[:, 0] = ((np.asarray(base, np.int64) & 0xFFFFFFFF)
                        | (_f32_bits(scale) << np.uint64(32)).view(np.int64))
    slot_extra[:, 1] = np.where(exact >= 0, exact | (1 << 32), 0)
    return np.asarray(seg_extra, np.int64).reshape(-1, 2), slot_extra


def segments_table(segments, out_rows=None) -> tuple[np.ndarray, int, int]:
    """``launch_table`` of ``bm25.TermBagSegment``s on the card, all of
    one row layout: f32, or quantized (``quant`` set, one qvals dtype)."""
    active = [np.asarray(seg.active, bool) for seg in segments]
    act = np.concatenate(active)
    quant = segments[0].quant is not None
    return launch_table(
        [(seg.quant.packed.data_ptr(), seg.quant.qvals.data_ptr(),
          seg.live.data_ptr()) if quant else
         (seg.doc_ids.data_ptr(), seg.impacts.data_ptr(),
          seg.live.data_ptr()) for seg in segments],
        [seg.live.shape[0] for seg in segments],
        [int(a.sum()) for a in active],
        np.concatenate([seg.rows for seg in segments])[act],
        np.concatenate([seg.idfs for seg in segments])[act],
        np.concatenate([seg.weights for seg in segments])[act],
        [int(seg.required) for seg in segments],
        [bool(seg.fast) for seg in segments], out_rows=out_rows,
        quant=_quant_words(segments, act) if quant else None)


def _check_segment(seg, dev, i):
    _expect(seg.live, f"segments[{i}].live", torch.bool, dev)
    if getattr(seg, "quant", None) is not None:
        q = seg.quant
        _check_width(q.width)
        _q_bytes(q.qvals)
        _expect(q.qvals, f"segments[{i}].qvals", q.qvals.dtype, dev)
        _expect(q.packed, f"segments[{i}].packed", torch.int32, dev)
        _expect(q.exact_vals, f"segments[{i}].exact_vals", torch.float32,
                dev)
        return
    _expect(seg.doc_ids, f"segments[{i}].doc_ids", torch.int32, dev)
    _expect(seg.impacts, f"segments[{i}].impacts", torch.float32, dev)
    if seg.impacts.shape[0] != seg.doc_ids.shape[0]:
        raise ValueError(f"segments[{i}]: impacts and doc_ids differ in "
                         "length")


def _check_staged(t, name):
    """A column K4 copies in 16-byte units must start on one and span a
    whole number of them, so a window widened to those bounds stays
    inside it."""
    if t.data_ptr() % STAGE_ALIGN or \
            (t.numel() * t.element_size()) % STAGE_ALIGN:
        raise ValueError(f"[{name}] must start on and span whole "
                         f"{STAGE_ALIGN}-byte units, as "
                         "DeviceSegment.quantized stages it")


def _layout(seg):
    """The row layout a segment's rows are read in: None (f32) or the
    quantized codes' dtype."""
    return None if seg.quant is None else seg.quant.qvals.dtype


def term_bag_topk_segments_cuda(segments, *, k: int,
                                min_score: float = -np.inf):
    """Exact top-k, matched total and max of a scored term bag on every
    segment: a ``bm25.TermBagTopK`` whose row ``s`` equals
    ``bm25.segment_topk(segments[s], k, min_score)``.  ``segments`` are
    ``bm25.TermBagSegment``s on one CUDA device.  At ``k <= K_MAX`` one
    launch for all of the f32 segments (counted here) and one
    ``term_bag_topk_quantized_cuda`` launch for the quantized segments of
    each qvals dtype, all writing one result; above it, one dense-entry
    call over every segment, then each segment's stable sort."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not segments:
        raise ValueError("term_bag_topk_segments_cuda needs a segment")
    dev = segments[0].live.device
    if dev.type != "cuda":
        raise ValueError(f"term_bag_topk_segments_cuda needs CUDA tensors, "
                         f"got {dev}")
    for i, seg in enumerate(segments):
        _check_segment(seg, dev, i)
    out = bm25.empty_topk(len(segments), k, dev)
    if k > K_MAX:
        cols = term_bag_dense_cuda([bm25.dense_bag(seg) for seg in segments],
                                   scores=True,
                                   counts=not segments[0].fast)
        for s, seg in enumerate(segments):
            cuda_build.count(term_bag_topk_segments_cuda,
                             attr="sorted_route_segments")
            bm25.write_topk_row(out, s, *bm25.segment_topk(
                seg, k, min_score, cols=cols[s]))
        return out
    groups: dict = {}
    for s, seg in enumerate(segments):
        groups.setdefault(_layout(seg), []).append(s)
    for layout, rows in groups.items():
        part = [segments[s] for s in rows]
        if layout is not None:
            out = term_bag_topk_quantized_cuda(part, k=k, min_score=min_score,
                                               out=out, out_rows=rows)
            continue
        table, n_blocks, n_slots = segments_table(part, out_rows=rows)
        out = topk_launch(torch.from_numpy(table).pin_memory(), len(part),
                           n_blocks, n_slots, k, min_score, out)
        cuda_build.count(term_bag_topk_segments_cuda)
    return out


def term_bag_topk_quantized_cuda(segments, *, k: int,
                                 min_score: float = -np.inf, out=None,
                                 out_rows=None):
    """K4's top-k entry: one launch of ``csrc/quant_topk.cu`` over
    quantized ``bm25.TermBagSegment``s whose codes share one dtype,
    writing segment ``i``'s top-k, total and max to row ``out_rows[i]``
    (by default ``i``) of ``out`` (a new ``bm25.TermBagTopK`` of
    ``len(segments)`` rows when None)."""
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k must be in 1..{K_MAX}, got {k}")
    if not segments:
        raise ValueError("term_bag_topk_quantized_cuda needs a segment")
    dev = segments[0].live.device
    if dev.type != "cuda":
        raise ValueError(f"term_bag_topk_quantized_cuda needs CUDA tensors, "
                         f"got {dev}")
    for i, seg in enumerate(segments):
        if seg.quant is None:
            raise ValueError(f"segments[{i}] has no quantized part")
        _check_segment(seg, dev, i)
        for name in ("packed", "qvals", "exact_vals"):
            _check_staged(getattr(seg.quant, name), f"segments[{i}].{name}")
    if len({_layout(seg) for seg in segments}) != 1:
        raise ValueError("quantized segments of one launch share a dtype")
    if out is None:
        out = bm25.empty_topk(len(segments), k, dev)
    table, n_blocks, n_slots = segments_table(segments, out_rows=out_rows)
    out = topk_launch(torch.from_numpy(table).pin_memory(), len(segments),
                       n_blocks, n_slots, k, min_score, out,
                       q_bytes=_q_bytes(segments[0].quant.qvals))
    cuda_build.count(term_bag_topk_quantized_cuda)
    return out


term_bag_topk_quantized_cuda.launches = 0


def topk_launch(table, n_entries: int, n_blocks: int, n_slots: int, k: int,
                 min_score: float, out, q_bytes: int = 0):
    """One top-k launch over ``table`` (a ``launch_table`` in pinned host
    memory, ``n_entries`` entries) into ``out``: one H2D copy of the
    table, which the kernel then counts into.  ``q_bytes`` picks the
    kernel: 0 K2's f32 top-k (``csrc/bm25.cu``), 1 or 2 K4
    (``csrc/quant_topk.cu``) over codes of that width.  The result holds
    the table and the scratch (and the caller the segments' tensors)
    until it is read back."""
    dev = out.vals.device
    kp = k_padded(k)
    table_dev = table.to(dev, non_blocking=True)
    scratch = torch.empty(n_blocks * kp, dtype=torch.int64, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    args = (_ptr(table_dev), n_entries, n_slots, n_blocks, k, kp,
            float(min_score), _ptr(out.vals), _ptr(out.ids),
            _ptr(out.totals), _ptr(out.maxes), _ptr(scratch))
    if q_bytes:
        lib = _quant_library()
        rc = lib.quant_topk_launch(*args, q_bytes, stream)
        cuda_build.check(lib, rc, "quant_topk_launch")
    else:
        lib = _library()
        rc = lib.term_bag_topk_segments_launch(*args, stream)
        cuda_build.check(lib, rc, "term_bag_topk_segments_launch")
    return out._replace(keep=out.keep + (table_dev, scratch, table))


term_bag_topk_segments_cuda.launches = 0
term_bag_topk_segments_cuda.sorted_route_segments = 0


# -- K3, the batched top-k (csrc/union_topk.cu) --------------------------------

SUBTILE_DOCS = 4096       # docs a K3 block stages at once at most (the widest D)
PLAN_DOCS = 256           # the D at which a batch is cut into query chunks
BLOCKS_PER_SEGMENT = 8    # K3 blocks per (query chunk, segment)
CHUNK_QUERIES = 64        # queries of one chunk at most
MAX_SUBTILES = 32         # sub-tiles a K3 block walks at most
UNION_SMEM = 232448 - 1024   # dynamic shared memory a K3 block may take
UNION_MAX_TERMS = 1024    # terms of a batchable query at most
_SEG_WORDS_K3 = 6
_K3_WARPS = 16            # union_topk.cu's kWarps


def _union_declare(lib):
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.union_topk_launch.argtypes = [p] + [i] * 15 + [p] * 5 + [p]
    lib.union_topk_launch.restype = i
    lib.union_topk_smem_bytes.argtypes = [i] * 8
    lib.union_topk_smem_bytes.restype = ctypes.c_longlong


def _union_library():
    return cuda_build.library("union_topk", _union_declare)


def _a16(x: int) -> int:
    return (int(x) + 15) // 16 * 16


def union_smem_bytes(t_cap: int, q_cap: int, s_cap: int, sub_cap: int,
                     docs: int, cand: int, raw_cap: int,
                     need_counts: bool) -> int:
    """Dynamic shared memory of a K3 block (``union_topk.cu``'s
    ``smem_bytes``): candidate buffers with their thresholds and counts
    (one per query, or per query and selecting warp, at least 16), the
    dense staging ``[t_cap, docs]`` f32, the posting buffer of
    ``raw_cap`` postings, the slots, per-term row ranges and idfs, two
    prefixes over the terms, per-term bounds of ``sub_cap`` sub-tiles,
    per-query state, per-(warp, query) matched counts and maxes, pass
    bits, presence bytes when counted, live bytes."""
    nb = max(q_cap, _K3_WARPS)
    return (_a16(nb * cand * 8) + _a16(nb * 8) + _a16(nb * 4)
            + _a16(t_cap * docs * 4) + _a16(raw_cap * 10) + _a16(s_cap * 8)
            + _a16(t_cap * 12) + _a16(2 * (t_cap + 1) * 4)
            + _a16(t_cap * (sub_cap + 1) * 4) + _a16(q_cap * 32)
            + _a16(q_cap * _K3_WARPS * 8) + _a16(q_cap * (docs // 32) * 4)
            + (_a16(t_cap * docs) if need_counts else 0) + _a16(docs))


def block_spans(n_pads, docs: int, max_sub: int) -> list[tuple[int, int]]:
    """Each segment's (blocks, span): ``BLOCKS_PER_SEGMENT`` ranges of
    whole sub-tiles, more where a range would walk more than ``max_sub``
    sub-tiles."""
    out = []
    for n_pad in n_pads:
        span = -(-int(n_pad) // BLOCKS_PER_SEGMENT)
        span = min(-(-span // docs), max_sub) * docs
        out.append((-(-int(n_pad) // span), span))
    return out


def _sub_cap(n_pads, docs: int, max_sub: int) -> int:
    return max(span // docs for _b, span in block_spans(n_pads, docs,
                                                        max_sub))


def cand_keys(kp: int) -> int:
    """Keys of a query's candidate buffer: room for the kp kept and a round
    of 32, a power of two."""
    return max(64, 2 * int(kp))


class UnionTable(NamedTuple):
    """K3's launch table (``table``, int64, numpy or pinned) and the
    launch's shape: ``n_chunks`` query chunks, ``blocks`` per (chunk,
    segment) at most, the caps of any (chunk, segment) (``t_cap`` terms,
    ``q_cap`` queries, ``s_cap`` slots), ``sub_cap`` the sub-tiles of a
    block at most, ``docs`` the sub-tile width, ``cand`` the candidate
    keys per buffer, ``raw_cap`` the postings of the posting buffer,
    ``kp`` the keys each block keeps."""
    table: object
    n_seg: int
    n_chunks: int
    n_q: int
    n_terms: int
    blocks: int
    t_cap: int
    q_cap: int
    s_cap: int
    sub_cap: int
    docs: int
    cand: int
    raw_cap: int
    kp: int
    need_counts: bool

    def offsets(self) -> dict:
        """Word offset of each section of ``table`` (``union_topk.cu``'s
        ``Layout``)."""
        S, C, Q = self.n_seg, self.n_chunks, self.n_q
        at = {"seg": 0}
        at["chunk"] = at["seg"] + _SEG_WORDS_K3 * S
        at["cs"] = at["chunk"] + 2 * C
        at["qs"] = at["cs"] + 2 * C * S
        at["req"] = at["qs"] + Q * S
        at["counters"] = at["req"] + Q
        at["term"] = at["counters"] + (C * S + 2 * Q * S + 1) // 2
        at["slot"] = at["term"] + 2 * self.n_terms
        return at


def _query_terms(segments, n_queries: int):
    """``present`` [S, Q, t] (query q names union slot t of segment s) and
    ``n_slots`` [S, Q] (q's present slots there, duplicates included)."""
    t_max = max(seg.union_rows.shape[0] for seg in segments)
    present = np.zeros((len(segments), n_queries, t_max), bool)
    n_slots = np.zeros((len(segments), n_queries), np.int64)
    for s, seg in enumerate(segments):
        act = seg.qact[:n_queries] > 0
        present[s, np.nonzero(act)[0], seg.qslots[:n_queries][act]] = True
        n_slots[s] = act.sum(axis=1)
    return present, n_slots


def _greedy_chunks(present, n_slots, sub_cap: int, cand: int,
                   need_counts: bool) -> list:
    """Queries in order, a chunk growing while it holds at most
    ``CHUNK_QUERIES`` and a block's shared memory at ``PLAN_DOCS`` fits."""
    chunks = []
    start = 0
    union = np.zeros_like(present[:, 0])
    slots = np.zeros(present.shape[0], np.int64)
    for q in range(present.shape[1]):
        grown, grown_slots = union | present[:, q], slots + n_slots[:, q]
        size = q - start + 1
        need = union_smem_bytes(int(grown.sum(axis=1).max()), size,
                                int(grown_slots.max()), sub_cap, PLAN_DOCS,
                                cand, 0, need_counts)
        if size > 1 and (size > CHUNK_QUERIES or need > UNION_SMEM):
            chunks.append((start, q - start))
            start = q
            grown, grown_slots = present[:, q].copy(), n_slots[:, q].copy()
        union, slots = grown, grown_slots
    chunks.append((start, present.shape[1] - start))
    return chunks


def _caps(present, n_slots, chunks) -> tuple[int, int, int]:
    """(terms, queries, slots) of the largest (chunk, segment)."""
    t_cap = max(int(present[:, q0: q0 + nq].any(axis=1).sum(axis=1).max())
                for q0, nq in chunks)
    s_cap = max(int(n_slots[:, q0: q0 + nq].sum(axis=1).max())
                for q0, nq in chunks)
    return max(t_cap, 1), max(nq for _q0, nq in chunks), max(s_cap, 1)


def union_chunks(segments, *, n_queries: int, kp: int,
                 need_counts: bool) -> tuple[list, int, int, tuple]:
    """Cut a batch into query chunks, in query order, and pick the
    sub-tile width D.  A chunk grows while it holds at most
    ``CHUNK_QUERIES`` queries and a block's shared memory at
    ``PLAN_DOCS`` fits ``UNION_SMEM``.  D is then the widest power of two
    that fits the largest (chunk, segment), from ``SUBTILE_DOCS`` (or a
    block's doc range, if narrower) down to 32 (fewer sub-tiles, fewer
    barriers); at 32 a block walks fewer sub-tiles until it fits (a query
    of many terms).  Returns ``([(first query, queries)], D, sub-tiles a
    block walks at most, (terms, queries, slots) of the largest (chunk,
    segment))``."""
    cand = cand_keys(kp)
    present, n_slots = _query_terms(segments, n_queries)
    n_pads = [seg.live.shape[0] for seg in segments]
    chunks = _greedy_chunks(present, n_slots,
                            _sub_cap(n_pads, PLAN_DOCS, MAX_SUBTILES), cand,
                            need_counts)
    caps = _caps(present, n_slots, chunks)
    span = -(-max(n_pads) // BLOCKS_PER_SEGMENT)
    docs = min(SUBTILE_DOCS, max(32, 1 << (span - 1).bit_length()))
    max_sub = MAX_SUBTILES
    while union_smem_bytes(*caps, _sub_cap(n_pads, docs, max_sub), docs,
                           cand, 0, need_counts) > UNION_SMEM:
        if docs > 32:
            docs //= 2
        elif max_sub > 1:
            max_sub //= 2
        else:
            raise ValueError(f"a query names {caps[0]} terms: more than "
                             "K3's shared memory stages")
    return chunks, docs, max_sub, caps


def union_table(segments, required, *, n_queries: int, k: int,
                need_counts: bool) -> UnionTable:
    """K3's launch table for a batch of ``n_queries`` scored bags over
    ``bm25.BatchSegment``s (layout in ``union_topk.cu``).  Per (chunk,
    segment) its terms are the union slots its queries name there, in
    union-slot order, each with its posting range and idf; each query's
    slots are its present terms in term order (a duplicate term is two
    slots naming one row), each a term of its chunk and its weight;
    ``required`` f32 [>= n_queries] becomes each query's int count."""
    kp = k_padded(k)
    cand = cand_keys(kp)
    n_seg = len(segments)
    chunks, docs, max_sub, (t_cap, q_cap, s_cap) = union_chunks(
        segments, n_queries=n_queries, kp=kp, need_counts=need_counts)
    spans = block_spans([seg.live.shape[0] for seg in segments], docs,
                        max_sub)
    seg_words = np.zeros((n_seg, _SEG_WORDS_K3), np.int64)
    for s, (seg, (blocks, span)) in enumerate(zip(segments, spans)):
        seg_words[s] = (seg.doc_ids.data_ptr(), seg.impacts.data_ptr(),
                        seg.live.data_ptr(), seg.live.shape[0], blocks, span)
    cs_words = np.zeros((len(chunks), n_seg, 2), np.int64)
    qs_words = np.zeros((n_queries, n_seg), np.int64)
    term_words, slot_words = [], []
    n_terms = n_slots = 0
    for c, (q0, nq) in enumerate(chunks):
        for s, seg in enumerate(segments):
            act = seg.qact[q0: q0 + nq] > 0
            named = seg.qslots[q0: q0 + nq][act].astype(np.int64)
            weights = seg.qweights[q0: q0 + nq][act]
            used, local = np.unique(named, return_inverse=True)
            rows = seg.union_rows[used].astype(np.int64)
            words = np.zeros((len(used), 2), np.int64)
            words[:, 0] = rows[:, 0] | (rows[:, 1] << 32)
            words[:, 1] = _f32_bits(seg.union_idfs[used]).view(np.int64)
            term_words.append(words.ravel())
            slot_words.append((local.astype(np.int64).ravel()
                               | (_f32_bits(weights) << np.uint64(32))
                               .view(np.int64)))
            per_q = act.sum(axis=1).astype(np.int64)
            first = np.concatenate([[0], np.cumsum(per_q)[:-1]])
            qs_words[q0: q0 + nq, s] = first | (per_q << 32)
            cs_words[c, s] = (n_terms | (len(used) << 32),
                              n_slots | (len(named) << 32))
            n_terms += len(used)
            n_slots += len(named)
    sub_cap = max(span // docs for _b, span in spans)
    # the posting buffer takes what shared memory is left
    raw_cap = (UNION_SMEM - union_smem_bytes(
        t_cap, q_cap, s_cap, sub_cap, docs, cand, 0, need_counts)) // 80 * 8
    meta = UnionTable(None, n_seg, len(chunks), n_queries, n_terms,
                      max(b for b, _span in spans), t_cap, q_cap, s_cap,
                      sub_cap, docs, cand, raw_cap, kp, bool(need_counts))
    at = meta._replace(table=np.zeros(0, np.int64)).offsets()
    table = np.zeros(at["slot"] + n_slots, np.int64)
    table[at["seg"]: at["chunk"]] = seg_words.ravel()
    table[at["chunk"]: at["cs"]] = np.asarray(chunks, np.int64).ravel()
    table[at["cs"]: at["qs"]] = cs_words.ravel()
    table[at["qs"]: at["req"]] = qs_words.ravel()
    table[at["req"]: at["counters"]] = np.asarray(
        required[:n_queries], np.float32).astype(np.int64)
    if n_terms:
        table[at["term"]: at["slot"]] = np.concatenate(term_words)
    if n_slots:
        table[at["slot"]:] = np.concatenate(slot_words)
    return meta._replace(table=table)


def pinned_union_table(segments, required, *, n_queries: int, k: int,
                       need_counts: bool) -> UnionTable:
    """``union_table`` with its table in pinned host memory: what
    ``batch_term_bag_topk_cuda`` takes as ``table``.  A caller may build it
    once per group and pass it to every run: each launch copies it to the
    card afresh (its counters start at zero every time)."""
    t = union_table(segments, required, n_queries=n_queries, k=k,
                    need_counts=need_counts)
    return t._replace(table=torch.from_numpy(t.table).pin_memory())


def batch_term_bag_topk_cuda(segments, required, *, n_queries: int, k: int,
                             need_counts: bool, table=None):
    """Exact top-k, matched total and max of each of ``n_queries`` scored
    bags on every segment, in one launch of K3 (``csrc/union_topk.cu``):
    a ``bm25.TermBagTopK`` whose row ``q * S + s`` equals row ``q * S + s``
    of ``search/batch.py::batch_term_bag_topk_segments``.  ``segments``
    are ``bm25.BatchSegment``s on one CUDA device; ``table`` is what
    ``pinned_union_table`` built for these inputs and this k (built here
    when None)."""
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k must be in 1..{K_MAX}, got {k}")
    if n_queries < 1:
        raise ValueError(f"n_queries must be >= 1, got {n_queries}")
    if not segments:
        raise ValueError("batch_term_bag_topk_cuda needs a segment")
    dev = segments[0].doc_ids.device
    if dev.type != "cuda":
        raise ValueError(f"batch_term_bag_topk_cuda needs CUDA tensors, "
                         f"got {dev}")
    for i, seg in enumerate(segments):
        _check_segment(seg, dev, i)
    if table is None:
        table = pinned_union_table(segments, required, n_queries=n_queries,
                                   k=k, need_counts=need_counts)
    if (table.n_seg, table.n_q, table.kp, table.need_counts) != (
            len(segments), n_queries, k_padded(k), bool(need_counts)):
        raise ValueError("table was built for another batch or k")
    n_rows = n_queries * len(segments)
    out = bm25.empty_topk(n_rows, k, dev)
    table_dev = table.table.to(dev, non_blocking=True)
    scratch = torch.empty(n_rows * table.blocks * table.kp, dtype=torch.int64,
                          device=dev)
    lib = _union_library()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    rc = lib.union_topk_launch(
        _ptr(table_dev), table.n_seg, table.n_chunks, n_queries,
        table.n_terms, table.blocks, table.t_cap, table.q_cap, table.s_cap,
        table.sub_cap, table.docs, table.cand, table.raw_cap, k, table.kp,
        int(table.need_counts),
        _ptr(out.vals), _ptr(out.ids), _ptr(out.totals), _ptr(out.maxes),
        _ptr(scratch), stream)
    cuda_build.check(lib, rc, "union_topk_launch")
    cuda_build.count(batch_term_bag_topk_cuda)
    return out._replace(keep=out.keep + (table_dev, scratch, table.table))


batch_term_bag_topk_cuda.launches = 0
