"""Wrappers of K2, the hand-written term-bag kernel (``csrc/bm25.cu``),
which replaces the reference's ``gather_postings`` + ``impact_scores`` /
``impact_score_count`` / ``match_count`` on CUDA tensors, and on the
``match`` path the ``run_topk`` after them; its top-k entry also serves
the batched path (K3), which replaces ``search/batch.py``
``batch_impact_union_topk``.

- ``term_bag_topk_segments_cuda``: one launch per ``match`` query over
  every segment of a shard, each segment's exact top-k, matched total
  and max computed inside the kernel.  Its plain twin is
  ``ops/bm25.py::term_bag_topk_segments``.  At ``k > K_MAX`` every
  segment takes the per-slot entry plus the stable sort instead
  (``ops/bm25.py::segment_topk``); ``sorted_route_segments`` counts
  those.
- ``term_bag_cuda``: the dense scores and/or matched-slot counts of one
  segment, one launch per query-term slot (``bool``, ``constant_score``,
  ``count``).  Its plain twins are ``ops/bm25.py``'s ``*_plain``
  functions.
- ``batch_term_bag_topk_cuda`` (K3): one launch of the top-k entry per
  msearch or continuous-batch group, with one table entry per (query,
  segment) (``batch_table``), each writing that pair's exact top-k,
  total and max.  Its plain twin is
  ``search/batch.py::batch_term_bag_topk_segments``.
- K4, the kernel's quantized row layout (int8/int16 impacts and
  bit-packed doc ids, ``index/codec.py``), which replaces the
  reference's ``gather_postings_packed`` and ``ops/quantized.py``:
  ``term_bag_topk_quantized_cuda``, the top-k entry over quantized
  segments (``term_bag_topk_segments_cuda`` sends a shard's quantized
  segments there, one launch per qvals dtype, beside one f32 launch for
  the others), and ``term_bag_quantized_cuda``, the per-slot entry.
  Their plain twins are ``ops/bm25.py::term_bag_topk_segments`` and
  ``ops/quantized.py``'s ``*_plain`` functions.

None ever falls back to its plain twin: a CUDA tensor gets the kernel
or an exception.  ``.launches`` on each wrapper counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from opensearch_tpu_torch.ops import bm25, cuda_build

_THREADS = 256
_MAX_GRID = 132 * 32
# The launch table's layout and the tile decision, handed to csrc/bm25.cu
# as -D macros when it is built (see ``defines``).
TILE_DOCS = 4096      # docs a block of the top-k entry owns
K_MAX = 256           # largest k selected inside the kernel
SEG_WORDS = 11        # int64 words per segment in the launch table
QSEG_WORDS = 13       # ... per quantized segment
QSLOT_WORDS = 4       # ... per slot of a quantized segment (f32: 2)
# qvals dtype -> the kernel's code width in bytes
_Q_BYTES = {torch.int8: 1, torch.int16: 2}


def defines() -> dict:
    """The macros ``csrc/bm25.cu`` is built with: this module's constants
    at the time of the call."""
    return {"BM25_TILE_DOCS": TILE_DOCS, "BM25_K_MAX": K_MAX,
            "BM25_SEG_WORDS": SEG_WORDS, "BM25_QSEG_WORDS": QSEG_WORDS,
            "BM25_QSLOT_WORDS": QSLOT_WORDS}


def _declare(lib):
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.term_bag_launch.argtypes = [p, p, p, p, p, p, p, i, i, p, p, p]
    lib.term_bag_launch.restype = i
    lib.term_bag_quantized_launch.argtypes = [
        p, p, p, i, p, i, p, p, p, p, p, p, p, i, i, p, p, p]
    lib.term_bag_quantized_launch.restype = i
    lib.term_bag_topk_segments_launch.argtypes = [
        p, i, i, i, i, i, ctypes.c_float, p, p, p, p, p, p]
    lib.term_bag_topk_segments_launch.restype = i
    lib.term_bag_topk_quantized_launch.argtypes = [
        p, i, i, i, i, i, ctypes.c_float, p, p, p, p, p, i, p]
    lib.term_bag_topk_quantized_launch.restype = i


def _library():
    return cuda_build.library("bm25", _declare, defines())


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
    lib = _library()
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
    cuda_build.count(term_bag_cuda, t_pad)
    return out_s, out_c


term_bag_cuda.launches = 0


def _q_bytes(qvals) -> int:
    q_bytes = _Q_BYTES.get(qvals.dtype)
    if q_bytes is None:
        raise TypeError(f"[qvals] has dtype {qvals.dtype}, expected int8 or "
                        "int16")
    return q_bytes


def _check_width(width: int) -> None:
    if not 1 <= int(width) <= 31:
        raise ValueError(f"width must be in 1..31, got {width}")


def term_bag_quantized_cuda(offsets, packed, base, qvals, scales, exact_vals,
                            exact_offsets, term_ids, term_active, idfs,
                            weights, *, width: int, n_pad: int, budget: int,
                            scores: bool, counts: bool):
    """``term_bag_cuda`` over a quantized segment (K4's per-slot entry):
    dense ``(scores f32 [n_pad] | None, counts i32 [n_pad] | None)``.

    ``packed`` i32 (the uint32 words' bits, guard word included) at
    ``width`` bits, ``base`` i32 / ``scales`` f32 / ``exact_offsets``
    i32 per term, ``qvals`` int8 or int16 [P_pad], ``exact_vals`` f32,
    as ``DeviceSegment.quantized`` stages them; the rest as
    ``term_bag_cuda``."""
    dev = offsets.device
    if dev.type != "cuda":
        raise ValueError(f"term_bag_quantized_cuda needs CUDA tensors, got "
                         f"{dev}")
    _check_width(width)
    for t, name, dtype in ((offsets, "offsets", torch.int32),
                           (packed, "packed", torch.int32),
                           (base, "base", torch.int32),
                           (scales, "scales", torch.float32),
                           (exact_vals, "exact_vals", torch.float32),
                           (exact_offsets, "exact_offsets", torch.int32),
                           (term_ids, "term_ids", torch.int32),
                           (term_active, "term_active", torch.bool)):
        _expect(t, name, dtype, dev)
    _expect(qvals, "qvals", qvals.dtype, dev)
    q_bytes = _q_bytes(qvals)
    t_pad = term_ids.shape[0]
    if term_active.shape[0] != t_pad:
        raise ValueError("term_ids and term_active differ in length")
    if scores:
        _expect(idfs, "idfs", torch.float32, dev)
        _expect(weights, "weights", torch.float32, dev)
        if idfs.shape[0] != t_pad or weights.shape[0] != t_pad:
            raise ValueError("idfs/weights must have t_pad entries")
    out_s = (torch.zeros(n_pad, dtype=torch.float32, device=dev)
             if scores else None)
    out_c = (torch.zeros(n_pad, dtype=torch.int32, device=dev)
             if counts else None)
    if t_pad == 0 or not (scores or counts):
        return out_s, out_c
    lib = _library()
    grid = max(1, min(_MAX_GRID, -(-int(budget) // _THREADS)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.term_bag_quantized_launch(
        _ptr(offsets), _ptr(packed), _ptr(base), int(width), _ptr(qvals),
        q_bytes, _ptr(scales), _ptr(exact_vals), _ptr(exact_offsets),
        _ptr(term_ids), _ptr(term_active), _ptr(idfs if scores else None),
        _ptr(weights if scores else None), t_pad, grid, _ptr(out_s),
        _ptr(out_c), ctypes.c_void_p(stream))
    cuda_build.check(lib, rc, "term_bag_quantized_launch")
    cuda_build.count(term_bag_quantized_cuda, t_pad)
    return out_s, out_c


term_bag_quantized_cuda.launches = 0


# -- the fused top-k: host-side layout (pure Python, tested on the CPU) --

def k_padded(k: int) -> int:
    """Candidates each tile keeps: ``k`` rounded up to a power of two."""
    return 1 << (int(k) - 1).bit_length()


def n_tiles(n_pad: int) -> int:
    """Blocks of the top-k launch for a segment of ``n_pad`` docs."""
    return max(1, -(-int(n_pad) // TILE_DOCS))


def _f32_bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)


def launch_table(ptrs, n_pads, slot_counts, rows, idfs, weights, required,
                 fast, out_rows=None, quant=None) -> tuple[np.ndarray, int,
                                                            int]:
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
    start | exact << 32}``."""
    n_seg = len(n_pads)
    seg_words, slot_words = ((SEG_WORDS, 2) if quant is None
                             else (QSEG_WORDS, QSLOT_WORDS))
    tiles = np.asarray([n_tiles(n) for n in n_pads], np.int64)
    first = np.concatenate([[0], np.cumsum(tiles)])
    n_blocks = int(first[-1])
    slot_first = np.concatenate([[0], np.cumsum(slot_counts,
                                                dtype=np.int64)])
    n_slots = int(slot_first[-1])
    head_words = n_seg * seg_words
    table = np.zeros(head_words + slot_words * n_slots + n_blocks
                     + (3 * n_seg + 1) // 2, np.int64)
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
    each qvals dtype, all writing one result; above it, each segment
    takes the per-slot entry plus the stable sort."""
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
        for s, seg in enumerate(segments):
            cuda_build.count(term_bag_topk_segments_cuda,
                             attr="sorted_route_segments")
            bm25.write_topk_row(out, s, *bm25.segment_topk(
                seg, k, min_score, plain=False))
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
        out = _topk_launch(torch.from_numpy(table).pin_memory(), len(part),
                           n_blocks, n_slots, k, min_score, out)
        cuda_build.count(term_bag_topk_segments_cuda)
    return out


def term_bag_topk_quantized_cuda(segments, *, k: int,
                                 min_score: float = -np.inf, out=None,
                                 out_rows=None):
    """K4's top-k entry: one launch over quantized ``bm25.TermBagSegment``s
    whose codes share one dtype, writing segment ``i``'s top-k, total
    and max to row ``out_rows[i]`` (by default ``i``) of ``out`` (a new
    ``bm25.TermBagTopK`` of ``len(segments)`` rows when None)."""
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
    if len({_layout(seg) for seg in segments}) != 1:
        raise ValueError("quantized segments of one launch share a dtype")
    if out is None:
        out = bm25.empty_topk(len(segments), k, dev)
    table, n_blocks, n_slots = segments_table(segments, out_rows=out_rows)
    out = _topk_launch(torch.from_numpy(table).pin_memory(), len(segments),
                       n_blocks, n_slots, k, min_score, out,
                       q_bytes=_q_bytes(segments[0].quant.qvals))
    cuda_build.count(term_bag_topk_quantized_cuda)
    return out


term_bag_topk_quantized_cuda.launches = 0


def _topk_launch(table, n_entries: int, n_blocks: int, n_slots: int, k: int,
                 min_score: float, out, q_bytes: int = 0):
    """One launch of the top-k entry over ``table`` (a ``launch_table``
    in pinned host memory, ``n_entries`` entries) into ``out``: one H2D
    copy of the table, which the kernel then counts into.  ``q_bytes``
    picks the row layout: 0 f32, 1 or 2 the quantized codes' width.  The
    result holds the table and the scratch (and the caller the segments'
    tensors) until it is read back."""
    dev = out.vals.device
    kp = k_padded(k)
    table_dev = table.to(dev, non_blocking=True)
    scratch = torch.empty(n_blocks * kp, dtype=torch.int64, device=dev)
    lib = _library()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    args = (_ptr(table_dev), n_entries, n_slots, n_blocks, k, kp,
            float(min_score), _ptr(out.vals), _ptr(out.ids),
            _ptr(out.totals), _ptr(out.maxes), _ptr(scratch))
    if q_bytes:
        rc = lib.term_bag_topk_quantized_launch(*args, q_bytes, stream)
        cuda_build.check(lib, rc, "term_bag_topk_quantized_launch")
    else:
        rc = lib.term_bag_topk_segments_launch(*args, stream)
        cuda_build.check(lib, rc, "term_bag_topk_segments_launch")
    return out._replace(keep=out.keep + (table_dev, scratch, table))


term_bag_topk_segments_cuda.launches = 0
term_bag_topk_segments_cuda.sorted_route_segments = 0


# -- K3, the batched top-k: the top-k entry over (query, segment) entries --

def batch_table(segments, required, *, n_queries: int,
                need_counts: bool) -> tuple[np.ndarray, int, int]:
    """``launch_table`` of a batch of ``n_queries`` scored bags over
    ``bm25.BatchSegment``s: one entry per (query, segment), segment after
    segment and query after query within one (the blocks of a segment's
    queries run side by side and share its postings in L2), entry (s, q)
    writing output row ``q * S + s``.  Its slots are the query's present
    terms in term order, each its union slot's posting range and idf
    and its own weight (a duplicate term is two slots naming one row);
    ``required`` f32 [>= n_queries]; ``fast`` is ``not need_counts`` for
    every entry, the plain twin's match rule for the whole batch."""
    n_seg = len(segments)
    rows, idfs, weights, counts = [], [], [], []
    for seg in segments:
        act = seg.qact[:n_queries] > 0        # [Q, tq], term order per row
        slots = seg.qslots[:n_queries][act]
        rows.append(seg.union_rows[slots])
        idfs.append(seg.union_idfs[slots])
        weights.append(seg.qweights[:n_queries][act])
        counts.append(act.sum(axis=1))
    q = np.arange(n_queries, dtype=np.int64)
    return launch_table(
        [(seg.doc_ids.data_ptr(), seg.impacts.data_ptr(),
          seg.live.data_ptr()) for seg in segments for _ in q],
        np.repeat([seg.live.shape[0] for seg in segments], n_queries),
        np.concatenate(counts), np.concatenate(rows).reshape(-1, 2),
        np.concatenate(idfs), np.concatenate(weights),
        np.tile(np.asarray(required[:n_queries], np.float32)
                .astype(np.int64), n_seg),
        np.full(n_seg * n_queries, not need_counts),
        out_rows=(q[None, :] * n_seg
                  + np.arange(n_seg, dtype=np.int64)[:, None]).ravel())


def pinned_batch_table(segments, required, *, n_queries: int,
                       need_counts: bool) -> tuple[torch.Tensor, int, int]:
    """``batch_table`` in pinned host memory, with its block and slot
    counts: what ``batch_term_bag_topk_cuda`` takes as ``table``.  A
    caller may build it once per group and pass it to every run: each
    launch copies it to the card afresh."""
    table, n_blocks, n_slots = batch_table(
        segments, required, n_queries=n_queries, need_counts=need_counts)
    return torch.from_numpy(table).pin_memory(), n_blocks, n_slots


def batch_term_bag_topk_cuda(segments, required, *, n_queries: int, k: int,
                             need_counts: bool, table=None):
    """Exact top-k, matched total and max of each of ``n_queries`` scored
    bags on every segment, in one launch of the top-k entry: a
    ``bm25.TermBagTopK`` whose row ``q * S + s`` equals row ``q * S + s``
    of ``search/batch.py::batch_term_bag_topk_segments``.  ``segments``
    are ``bm25.BatchSegment``s on one CUDA device; ``table`` is what
    ``pinned_batch_table`` built for these inputs (built here when
    None)."""
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
        table = pinned_batch_table(segments, required, n_queries=n_queries,
                                   need_counts=need_counts)
    host, n_blocks, n_slots = table
    n_entries = n_queries * len(segments)
    out = _topk_launch(host, n_entries, n_blocks, n_slots, k, -np.inf,
                       bm25.empty_topk(n_entries, k, dev))
    cuda_build.count(batch_term_bag_topk_cuda)
    return out


batch_term_bag_topk_cuda.launches = 0
