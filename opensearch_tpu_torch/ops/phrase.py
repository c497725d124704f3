"""Exact-phrase frequencies on torch tensors (the port of the JAX
package's ``ops/phrase.py``).

The reference encodes every occurrence of a phrase term as the int64 key
``doc * POS_BASE + position``, gathers a power-of-two budget of keys per
slot and runs a ``searchsorted`` for every occurrence of the anchor
(slot 0).  The port compares (doc, position) pairs instead, which gives
the same answer while every position plus its phrase offset is below
``POS_BASE``, and follows the hand-written kernel K8
(``csrc/positions.cu`` ``phrase_freqs_kernel``):

- the anchor is the slot whose term has the fewest positions in the
  segment (Lucene leads a phrase with its rarest term); each other slot
  j keeps its position offset from the anchor (``shifts[j]``, negative
  for a slot before it), so each phrase occurrence still counts once;
- per posting entry of the anchor (one doc), each other slot's entry for
  that doc is found by binary search of its term's doc-ascending
  ``doc_ids`` row, and each anchor position by binary search of that
  entry's positions for ``position + shifts[j]``;
- the doc's frequency is the count of anchor positions that every slot
  confirms, written once per doc (a doc appears once in a term's row),
  so the result needs no atomics and is the same in any order.

``phrase_freqs`` is that algorithm vectorised over the anchor
occurrences (the plain version: the CPU path, and the card's yardstick
for K8); ``phrase_freqs_auto``, which ``PhrasePlan`` calls, launches K8
on a CUDA tensor (``ops/cuda_positions.py``) and runs the plain version
on a CPU tensor.  ``PositionSlots`` are a leaf's slots over one
segment's postings, made on the host from its CSR (``phrase_slots``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opensearch_tpu_torch.common import torchenv  # noqa: F401

POS_BASE = 1 << 22  # > any token position (position_increment_gap padded)


class PositionSlots(NamedTuple):
    """A phrase or span leaf's query slots over one segment's postings,
    on the host.  ``rows`` int64 [m, 2]: each slot's posting entries
    ``[e0, e1)`` of its term (``[0, 0]`` when the segment lacks it);
    ``shifts`` int64 [m]: each slot's position minus the anchor's (slot 0
    is the anchor); ``same_term``: slots 0 and 1 hold one term (an
    unordered span must not pair an occurrence with itself)."""

    rows: np.ndarray
    shifts: np.ndarray
    same_term: bool = False

    @property
    def n_anchor(self) -> int:
        """Posting entries of the anchor: K8 / K9 give each a thread."""
        return int(self.rows[0, 1] - self.rows[0, 0])

    @property
    def complete(self) -> bool:
        """Every slot's term is in the segment."""
        return bool((self.rows[:, 1] > self.rows[:, 0]).all())


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
    return PositionSlots(rows[order], offs[order] - offs[a])


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


def phrase_freqs_auto(postings: dict, slots: PositionSlots,
                      n_pad: int) -> torch.Tensor:
    """``phrase_freqs`` over a staged postings entry (``doc_ids``,
    ``pos_offsets``, ``positions``): K8 on a CUDA tensor (one launch; none
    when the anchor has no entry or a slot's term is absent, where no doc
    can match), the plain version on a CPU tensor."""
    args = (postings["doc_ids"], postings["pos_offsets"],
            postings["positions"], slots, n_pad)
    if postings["doc_ids"].device.type == "cuda":
        from opensearch_tpu_torch.ops.cuda_positions import phrase_freqs_cuda
        return phrase_freqs_cuda(*args)
    return phrase_freqs(*args)
