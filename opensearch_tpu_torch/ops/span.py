"""Span-near frequencies on torch tensors (the port of the JAX package's
``ops/span.py``): ``span_near``, ``span_first`` and the ``intervals``
rules that flatten to a near.

Per occurrence of clause 0 (the anchor) before ``end``:

- ordered: for each later clause the smallest of its positions strictly
  after the previous clause's match in the same doc (none: no match);
  the chain matches when ``last - first - (k - 1) <= slop``;
- unordered (2 clauses): the nearest occurrence of clause 1 on either
  side of the anchor, ``|gap| - 1 <= slop``; when both clauses are one
  term, the anchor's own occurrence does not count.  As in the
  reference, an anchor with no such occurrence has the gap ``POS_BASE``
  (so a slop of ``POS_BASE`` or more accepts it).

A doc's frequency is its count of matching anchors.  The reference
compares the phrase kernel's int64 (doc, position) keys; the port
compares the pairs (``ops/phrase.py``), the same answer while positions
stay below ``POS_BASE``.  Its full-bucket fix (an ordered clause never
matches backwards) holds here by construction: a search runs within one
doc's entry and finds nothing past its end.

``span_near_freqs`` is that algorithm vectorised over the anchor
occurrences, on one segment; ``span_scores`` (the plain version of the
hand-written kernel K9, ``csrc/positions.cu`` ``span_scores_kernel``)
gives each of a request's span jobs (``ops.phrase.PositionalLeaf``) its
``(scores, matched)``; ``span_scores_auto``, which the plan's pre-pass
calls, launches K9 over every job on CUDA tensors (one launch, BM25 in
the kernel) and runs the plain version on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from opensearch_tpu_torch.ops.phrase import (POS_BASE, PositionSlots,
                                             anchor_occurrences,
                                             anchor_span, entry_ranges,
                                             find_entries, lower_bound,
                                             per_doc, positional_scores,
                                             postings_limits, term_rows)


def span_slots(pf, terms) -> PositionSlots:
    """A span's ``PositionSlots`` over ``pf``: clause 0 is the anchor,
    the clauses keep their order (no shifts: a span's slop is data)."""
    rows, _counts, tids = term_rows(pf, terms)
    same = len(terms) > 1 and tids[0] >= 0 and tids[0] == tids[1]
    return PositionSlots(rows, np.zeros(len(terms), np.int64), bool(same),
                         anchor_span(pf, rows[0]) if len(terms) else (0, 0),
                         postings_limits(pf))


def span_near_freqs(doc_ids, pos_offsets, positions, slots: PositionSlots,
                    n_pad: int, *, ordered: bool, slop: int,
                    end: int) -> torch.Tensor:
    """Per-doc count of clause-0 occurrences that start a span match,
    float32 [n_pad] (the plain version of K9, on any device).  ``slop``:
    the largest total gap; ``end``: spans start before this position
    (span_first; ``compiler._SPAN_NO_END`` disables it)."""
    dev = doc_ids.device
    m = len(slots.rows)
    if slots.n_anchor == 0:
        return torch.zeros(n_pad, dtype=torch.float32, device=dev)
    docs, owner, pos, entry_ok = anchor_occurrences(
        doc_ids, pos_offsets, positions, slots.rows)
    ok = pos < int(end)
    last = max(positions.shape[0] - 1, 0)
    if ordered:
        prev = pos
        for j in range(1, m):
            e, found = find_entries(doc_ids, slots.rows[j], docs)
            entry_ok &= found
            q0, q1 = entry_ranges(pos_offsets, e, owner)
            k = lower_bound(positions, q0, q1, prev, right=True)
            ok &= k < q1
            prev = torch.where(k < q1, positions[k.clamp(0, last)].long(),
                               prev)
        ok &= entry_ok[owner]
        if m > 1:
            ok &= prev - pos - (m - 1) <= int(slop)
    else:
        e, found = find_entries(doc_ids, slots.rows[1], docs)
        q0, q1 = entry_ranges(pos_offsets, e, owner)
        near = lower_bound(positions, q0, q1, pos)
        best = torch.full_like(pos, POS_BASE)
        for c in (near - 1, near, near + 1):
            x = positions[c.clamp(0, last)].long()
            inside = found[owner] & (c >= q0) & (c < q1)
            if slots.same_term:
                inside &= x != pos
            best = torch.where(inside,
                               torch.minimum(best, (x - pos).abs() - 1), best)
        ok &= best <= int(slop)
    return per_doc(docs, owner, ok, n_pad, dev)


def span_scores(leaves) -> list:
    """Each span ``PositionalLeaf``'s ``(scores f32 [n_pad], matched bool
    [n_pad])`` (the plain version of K9, on any device):
    ``span_near_freqs`` then ``positional_scores``, job by job."""
    out = []
    for leaf in leaves:
        tf = span_near_freqs(*leaf.cols.cols, leaf.slots, leaf.n_pad,
                             ordered=leaf.ordered, slop=leaf.slop,
                             end=leaf.end)
        out.append(positional_scores(tf, leaf.cols.doc_lens[: leaf.n_pad],
                                     leaf.scored, leaf.weight, leaf.avgdl))
    return out


def span_scores_auto(leaves) -> list:
    """``span_scores`` of a request's span jobs: K9 on CUDA tensors (one
    launch over every job with an anchor entry), the plain version on
    CPU tensors."""
    if leaves and leaves[0].cols.device.type == "cuda":
        from opensearch_tpu_torch.ops.cuda_positions import span_scores_cuda
        return span_scores_cuda(leaves)
    return span_scores(leaves)
