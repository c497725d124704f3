"""Exact-phrase frequencies and scores on torch tensors (the port of the
JAX package's ``ops/phrase.py``, and of the scoring its phrase plan runs
after it).

The reference encodes every occurrence of a phrase term as the int64 key
``doc * POS_BASE + position``, gathers a power-of-two budget of keys per
slot and runs a ``searchsorted`` for every occurrence of the anchor
(slot 0).  The port compares (doc, position) pairs instead, which gives
the same answer while every position plus its phrase offset is below
``POS_BASE``:

- the anchor is the slot whose term has the fewest positions in the
  segment (Lucene leads a phrase with its rarest term); each other slot
  j keeps its position offset from the anchor (``shifts[j]``, negative
  for a slot before it), so each phrase occurrence still counts once;
- per posting entry of the anchor (one doc), each other slot's entry for
  that doc is found by binary search of its term's doc-ascending
  ``doc_ids`` row, and each anchor position by binary search of that
  entry's positions for ``position + shifts[j]``;
- the doc's frequency is the count of anchor positions that every slot
  confirms, written once per doc (a doc appears once in a term's row).

``phrase_freqs`` is that algorithm vectorised over the anchor
occurrences, on one segment.  A request's phrase leaves over its
segments are ``PositionalLeaf`` jobs: ``phrase_scores`` (the plain
version: the CPU path, and the card's yardstick) gives each job's
``(scores, matched)`` from ``phrase_freqs`` and ``positional_scores``;
``phrase_scores_auto``, which the plan's pre-pass calls, launches the
hand-written kernel K8 (``ops/cuda_positions.py``, ``csrc/positions.cu``:
one launch over every job, BM25 in the kernel) on CUDA tensors and runs
the plain version on CPU tensors.  ``PositionSlots`` are a leaf's slots
over one segment's postings, made on the host from its CSR
(``phrase_slots``); ``StagedPositions`` a segment's staged columns,
checked once when staged.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from opensearch_tpu_torch.common import torchenv  # noqa: F401
from opensearch_tpu_torch.ops.bm25 import B_DEFAULT, K1_DEFAULT

POS_BASE = 1 << 22  # > any token position (position_increment_gap padded)


@dataclass(frozen=True, eq=False)
class PositionSlots:
    """A phrase or span leaf's query slots over one segment's postings,
    on the host.  ``rows`` int64 [m, 2]: each slot's posting entries
    ``[e0, e1)`` of its term (``[0, 0]`` when the segment lacks it);
    ``shifts`` int64 [m]: each slot's position minus the anchor's (slot 0
    is the anchor); ``same_term``: slots 0 and 1 hold one term (an
    unordered span must not pair an occurrence with itself);
    ``anchor_positions``: the anchor row's ``[first, end)`` indices of the
    segment's ``positions`` (K8 / K9 cut it into their blocks' runs);
    ``limits``: the segment's ``(posting entries, positions)``, which the
    rows and the anchor's positions are checked against here, once (K8 /
    K9 take slots only over columns of the same limits).  Made once per
    (leaf, segment) with the prepared inputs, it keeps what the kernels'
    launch table reads: ``anchor_row`` (its ``(e0, e1)``), ``n_anchor``
    (the anchor's posting entries), ``complete`` (every slot's term in the
    segment) and ``words`` (int64 [m, 3]: each slot's ``{row start, row
    end, shift}``)."""

    rows: np.ndarray
    shifts: np.ndarray
    same_term: bool = False
    anchor_positions: tuple = (0, 0)
    limits: tuple = None
    anchor_row: tuple = field(init=False)
    n_anchor: int = field(init=False)
    complete: bool = field(init=False)
    words: np.ndarray = field(init=False, repr=False)

    def __post_init__(self):
        rows = np.asarray(self.rows, np.int64)
        shifts = np.asarray(self.shifts, np.int64)
        if rows.ndim != 2 or rows.shape[0] < 1 or rows.shape[1] != 2 or \
                shifts.shape != (rows.shape[0],):
            raise ValueError("a phrase or span needs [m, 2] rows and m "
                             "shifts, m >= 1")
        n_anchor = int(rows[0, 1] - rows[0, 0])
        if self.limits is not None:
            n_entries, n_positions = self.limits
            p0, p1 = self.anchor_positions
            if (rows[:, 0] > rows[:, 1]).any() or (rows < 0).any() or \
                    int(rows.max()) > n_entries:
                raise ValueError("slot rows outside the segment's postings")
            if (np.abs(shifts) >= 1 << 30).any():
                raise ValueError("a slot's shift must stay within 2^30")
            if not 0 <= p0 <= p1 <= n_positions or p1 - p0 < n_anchor:
                raise ValueError("anchor positions outside the segment's "
                                 "positions")
        words = np.empty((rows.shape[0], 3), np.int64)
        words[:, :2] = rows
        words[:, 2] = shifts
        for name, value in (("rows", rows), ("shifts", shifts),
                            ("anchor_row", (int(rows[0, 0]), int(rows[0, 1]))),
                            ("n_anchor", n_anchor),
                            ("complete", bool((rows[:, 1] > rows[:, 0])
                                              .all())),
                            ("words", words)):
            object.__setattr__(self, name, value)


def postings_limits(pf) -> tuple:
    """``(posting entries, positions)`` of ``pf`` (None: no field)."""
    if pf is None:
        return (0, 0)
    return (len(pf.doc_ids), len(pf.positions))


def term_rows(pf, terms) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(rows int64 [m, 2], positions int64 [m], term ids int64 [m])`` of
    ``terms`` over a segment's postings ``pf`` (None: the field is
    absent): each term's posting entries, its position count in the
    segment, and its term id (-1 when absent, with an empty row)."""
    m = len(terms)
    rows = np.zeros((m, 2), np.int64)
    counts = np.zeros(m, np.int64)
    tids = np.full(m, -1, np.int64)
    for j, t in enumerate(terms):
        tid = pf.term_id(t) if pf is not None else -1
        if tid >= 0:
            e0, e1 = int(pf.offsets[tid]), int(pf.offsets[tid + 1])
            rows[j] = e0, e1
            counts[j] = int(pf.pos_offsets[e1]) - int(pf.pos_offsets[e0])
            tids[j] = tid
    return rows, counts, tids


def phrase_slots(pf, terms, offsets) -> PositionSlots:
    """A phrase's ``PositionSlots`` over ``pf``: ``offsets`` are the
    analyzer positions of ``terms`` (stopword gaps kept).  The anchor is
    the slot with the fewest positions (the first of equals); the other
    slots follow in phrase order."""
    rows, counts, _tids = term_rows(pf, terms)
    a = int(np.argmin(counts)) if len(terms) else 0
    order = [a] + [j for j in range(len(terms)) if j != a]
    offs = np.asarray(offsets, np.int64)
    return PositionSlots(rows[order], offs[order] - offs[a],
                         anchor_positions=anchor_span(pf, rows[a]),
                         limits=postings_limits(pf))


def anchor_span(pf, row) -> tuple:
    """``[first, end)`` of the positions of posting entries ``row`` of
    ``pf`` (``(0, 0)`` for an empty row)."""
    e0, e1 = int(row[0]), int(row[1])
    if e0 == e1:
        return (0, 0)
    return (int(pf.pos_offsets[e0]), int(pf.pos_offsets[e1]))


def lower_bound(seq, lo, hi, target, right: bool = False):
    """Per lane, the first index ``i`` in ``[lo, hi)`` with ``seq[i] >=
    target`` (``> target`` when ``right``), ``hi`` when there is none:
    the kernels' binary search, lane by lane (int64 lanes)."""
    lo, hi = lo.clone(), hi.clone()
    if not lo.numel():
        return lo
    last = max(seq.shape[0] - 1, 0)
    steps = int((hi - lo).clamp(min=0).max()).bit_length()
    for _ in range(steps):
        live = lo < hi
        mid = (lo + hi) // 2
        v = seq[mid.clamp(0, last)].long()
        go = (v <= target) if right else (v < target)
        lo = torch.where(live & go, mid + 1, lo)
        hi = torch.where(live & ~go, mid, hi)
    return lo


def anchor_occurrences(doc_ids, pos_offsets, positions, rows):
    """The anchor's posting entries ``[e0, e1)`` (``rows[0]``) and every
    position of them: ``(docs int64 [E], owner int64 [O], pos int64 [O],
    entry_ok bool [E])``, ``owner`` the anchor entry of each occurrence
    (``entry_ok`` all True, for the callers to narrow)."""
    dev = doc_ids.device
    e0, e1 = int(rows[0, 0]), int(rows[0, 1])
    ent = torch.arange(e0, e1, dtype=torch.int64, device=dev)
    p0 = pos_offsets[ent].long()
    n = pos_offsets[ent + 1].long() - p0
    owner = torch.repeat_interleave(
        torch.arange(e1 - e0, dtype=torch.int64, device=dev), n)
    start = torch.cumsum(n, 0) - n
    idx = (p0[owner] + torch.arange(owner.numel(), dtype=torch.int64,
                                    device=dev) - start[owner])
    return (doc_ids[ent].long(), owner, positions[idx].long(),
            torch.ones(e1 - e0, dtype=torch.bool, device=dev))


def find_entries(doc_ids, row, docs):
    """``(entry int64, found bool)`` of each doc of ``docs`` in the
    doc-ascending posting row ``row = (e0, e1)`` of ``doc_ids``: binary
    search, as the kernels find a slot's entry for an anchor's doc."""
    lo = torch.full_like(docs, int(row[0]))
    hi = torch.full_like(docs, int(row[1]))
    e = lower_bound(doc_ids, lo, hi, docs)
    last = max(doc_ids.shape[0] - 1, 0)
    found = (e < hi) & (doc_ids[e.clamp(0, last)].long() == docs)
    return e, found


def entry_ranges(pos_offsets, e, owner):
    """Each occurrence's ``[q0, q1)`` of positions in its doc's entry
    ``e`` of a slot (``e`` per anchor entry, ``owner`` per occurrence)."""
    last = max(pos_offsets.shape[0] - 2, 0)
    ec = e.clamp(0, last)
    return pos_offsets[ec].long()[owner], pos_offsets[ec + 1].long()[owner]


def per_doc(docs, owner, ok, n_pad: int, device) -> torch.Tensor:
    """float32 [n_pad]: each anchor doc's count of ``ok`` occurrences,
    written once per doc (zero elsewhere), as the kernels write it."""
    counts = torch.zeros(docs.shape[0], dtype=torch.int64, device=device)
    counts.index_add_(0, owner, ok.long())
    tf = torch.zeros(n_pad, dtype=torch.float32, device=device)
    tf[docs] = counts.to(torch.float32)
    return tf


def phrase_freqs(doc_ids, pos_offsets, positions, slots: PositionSlots,
                 n_pad: int) -> torch.Tensor:
    """Per-doc exact-phrase frequency, float32 [n_pad] (the plain version
    of K8, on any device): ``doc_ids`` / ``pos_offsets`` / ``positions``
    are the segment's staged columns (``DeviceSegment.ensure_positions``),
    ``slots`` the phrase's ``phrase_slots``."""
    dev = doc_ids.device
    if slots.n_anchor == 0 or not slots.complete:
        return torch.zeros(n_pad, dtype=torch.float32, device=dev)
    docs, owner, pos, entry_ok = anchor_occurrences(
        doc_ids, pos_offsets, positions, slots.rows)
    ok = torch.ones_like(pos, dtype=torch.bool)
    last = max(positions.shape[0] - 1, 0)
    for j in range(1, len(slots.rows)):
        e, found = find_entries(doc_ids, slots.rows[j], docs)
        entry_ok &= found
        q0, q1 = entry_ranges(pos_offsets, e, owner)
        target = pos + int(slots.shifts[j])
        k = lower_bound(positions, q0, q1, target)
        ok &= (k < q1) & (positions[k.clamp(0, last)].long() == target)
    return per_doc(docs, owner, ok & entry_ok[owner], n_pad, dev)


@dataclass(frozen=True, eq=False)
class StagedPositions:
    """A segment's positions as K8 / K9 read them, on one device:
    ``doc_ids``, ``pos_offsets`` (int32, padded as
    ``DeviceSegment.ensure_positions`` pads them), ``positions`` (int32)
    and ``doc_lens`` (float32 [n_pad]).  ``stage_positions`` checks them
    once; on CUDA the kernels copy whole 16-byte units of the int32
    columns, so each starts on 16 bytes and spans whole units.
    ``words``: their device addresses, the launch table's first words."""

    doc_ids: torch.Tensor
    pos_offsets: torch.Tensor
    positions: torch.Tensor
    doc_lens: torch.Tensor
    n_entries: int
    n_positions: int
    words: tuple = field(repr=False)

    @property
    def device(self) -> torch.device:
        return self.doc_ids.device

    @property
    def limits(self) -> tuple:
        """``(posting entries, positions)``: what a job's slots must stay
        within."""
        return self.n_entries, self.n_positions

    @property
    def cols(self) -> tuple:
        """``(doc_ids, pos_offsets, positions)``: ``phrase_freqs``'s and
        ``span_near_freqs``' first arguments."""
        return self.doc_ids, self.pos_offsets, self.positions


def stage_positions(doc_ids, pos_offsets, positions, doc_lens,
                    n_entries: int, n_positions: int,
                    entry_positions_min: int = 1) -> StagedPositions:
    """The checked ``StagedPositions`` of a segment's staged columns:
    ``n_entries`` posting entries holding ``n_positions`` positions, the
    fewest an entry holds ``entry_positions_min`` (K8 / K9 give a block
    at most as many entries as positions: each must hold one).  Raises on
    a layout the kernels do not take."""
    dev = doc_ids.device
    for name, t, dtype in (("doc_ids", doc_ids, torch.int32),
                           ("pos_offsets", pos_offsets, torch.int32),
                           ("positions", positions, torch.int32),
                           ("doc_lens", doc_lens, torch.float32)):
        if t.device != dev:
            raise ValueError(f"[{name}] is on {t.device}, expected {dev}")
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"[{name}] must be a contiguous {dtype} vector, "
                            f"got {t.dtype} {list(t.shape)}")
        if dev.type == "cuda" and name != "doc_lens" and (
                t.data_ptr() % 16 or t.numel() % 4):
            raise ValueError(f"[{name}] must start on 16 bytes and span "
                             "whole 16-byte units")
    if pos_offsets.numel() < n_entries + 1 or doc_ids.numel() < n_entries \
            or positions.numel() < n_positions:
        raise ValueError(f"{n_entries} posting entries and {n_positions} "
                         "positions do not fit the staged columns")
    if n_entries and entry_positions_min < 1:
        raise ValueError("every posting entry must hold a position")
    words = tuple(t.data_ptr() for t in (doc_ids, pos_offsets, positions,
                                         doc_lens))
    return StagedPositions(doc_ids, pos_offsets, positions, doc_lens,
                           int(n_entries), int(n_positions), words)


def stage_host_positions(pf, device) -> StagedPositions:
    """``pf``'s (a ``PostingsField``) columns staged on ``device`` as
    ``DeviceSegment.ensure_positions`` stages them, checked."""
    from opensearch_tpu_torch.index.segment import pad_pow2

    def put(a, size, fill, dtype):
        out = np.full(size, fill, dtype)
        out[: len(a)] = a
        return torch.from_numpy(out).to(device)

    n_docs = len(pf.doc_lens)
    po = pf.pos_offsets
    return stage_positions(
        put(pf.doc_ids, pad_pow2(len(pf.doc_ids)), n_docs, np.int32),
        put(po, pad_pow2(len(po)), po[-1] if len(po) else 0, np.int32),
        put(pf.positions, pad_pow2(len(pf.positions)), 0, np.int32),
        put(pf.doc_lens, pad_pow2(n_docs + 1), 1.0, np.float32),
        len(pf.doc_ids), len(pf.positions),
        int(np.diff(po).min()) if len(po) > 1 else 1)


class PositionalLeaf(NamedTuple):
    """One phrase or span leaf over one segment: a job of K8 / K9.
    ``cols`` the segment's ``StagedPositions``, ``slots`` its
    ``PositionSlots``, ``n_pad`` the output's length; ``weight`` (idf sum
    times boost) and ``avgdl`` Python floats holding float32 values;
    ``scored`` False for a filter (zero scores); ``ordered``, ``slop``
    and ``end`` a span's (``ops/span.py``)."""

    cols: StagedPositions
    slots: PositionSlots
    n_pad: int
    weight: float
    avgdl: float
    scored: bool = True
    ordered: bool = True
    slop: int = 0
    end: int = 0


def fma32(a: float, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as the reference's XLA code
    computes it (its CPU compiler contracts a product that feeds an add
    into one fused multiply-add).  ``a`` is a Python float holding a
    float32 value, ``b`` and ``c`` float32 tensors.  The product of two
    float32 values is exact in float64; the float64 sum is made
    round-to-odd from its exact error (Knuth's two-sum), so the one
    rounding to float32 that follows is the fused operation's."""
    p = b.double() * a
    c64 = c.double()
    s = p + c64
    bv = s - c64
    err = (p - bv) + (c64 - (s - bv))
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def positional_scores(tf, doc_lens, scored: bool, weight: float,
                      avgdl: float):
    """``(scores, matched)`` of a phrase or span from its per-doc ``tf``:
    ``weight * tf / (tf + norm)``, ``norm = k1 * (1 - b + b * dl /
    avgdl)``, in the reference's float32 order (``avgdl`` a float32 0-d
    tensor: a CUDA division by a host scalar multiplies by its
    reciprocal, which rounds differently)."""
    matched = tf > 0
    if not scored:
        return torch.zeros_like(tf), matched
    avgdl = torch.tensor(avgdl, dtype=torch.float32, device=tf.device)
    inner = 1.0 - B_DEFAULT + B_DEFAULT * doc_lens / avgdl
    # tf + k1 * inner, one fused multiply-add in the reference
    scores = weight * tf / fma32(float(np.float32(K1_DEFAULT)), inner, tf)
    return torch.where(matched, scores, 0.0), matched


def phrase_scores(leaves) -> list:
    """Each ``PositionalLeaf``'s ``(scores f32 [n_pad], matched bool
    [n_pad])`` of its exact phrase (the plain version of K8, on any
    device): ``phrase_freqs`` then ``positional_scores``, job by job."""
    out = []
    for leaf in leaves:
        tf = phrase_freqs(*leaf.cols.cols, leaf.slots, leaf.n_pad)
        out.append(positional_scores(tf, leaf.cols.doc_lens[: leaf.n_pad],
                                     leaf.scored, leaf.weight, leaf.avgdl))
    return out


def phrase_scores_auto(leaves) -> list:
    """``phrase_scores`` of a request's phrase jobs: K8 on CUDA tensors
    (one launch over every job that can match: none when no job has an
    anchor entry and every slot's term), the plain version on CPU
    tensors."""
    if leaves and leaves[0].cols.device.type == "cuda":
        from opensearch_tpu_torch.ops.cuda_positions import \
            phrase_scores_cuda
        return phrase_scores_cuda(leaves)
    return phrase_scores(leaves)
