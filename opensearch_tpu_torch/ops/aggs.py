"""Aggregation ops on torch tensors: bucket counting and metrics over
doc-value columns (the port of the JAX package's ``ops/aggs.py``), and
the plain version of K5, the bucket collector (``ops/cuda_aggs.py``,
``csrc/aggs.cu``).

The seven functions of the reference keep its shapes and pads: the dead
bucket is ``n_buckets_pad - 1`` (``n_buckets_pad = pad_pow2(n_buckets +
1)``), the dead doc ``n_pad - 1``; padded column entries carry
``value_docs = n_docs`` (never matched) and ``ords = -1``; sums, min and
max are float64, counts int64.

Summation order.  Counts, min and max do not depend on the order their
terms are combined in; float64 sums do, and CUDA's ``index_add_`` adds
in whatever order its atomics land.  So every float sum here has one
fixed order, the same on the CPU and on the card:

- per doc (``per_doc_partials``): the doc's values in column order, from
  0.0, one round per value rank (a doc is added to once per round), as
  the reference's sequential scatter adds them;
- per bucket (``scatter_partials_to_buckets``, ``masked_metrics``,
  ``masked_centroids``' bins): the **pairwise tree** over the bucket's
  run of valid entries in entry order (``pairwise_sums``): the entry of
  rank ``r`` in the run takes the node of rank ``r + 2^l`` at level ``l``
  when ``r`` is a multiple of ``2^(l+1)``; the root is the sum, plus
  0.0.  K5 builds the same tree streaming, as a binary counter
  (``csrc/aggs.cu``), so its sums equal these byte for byte.  Against
  the reference's sequential order a bucket sum over a double column
  differs in its last bits (rtol 1e-12 holds); over long columns whose
  partial sums stay below 2^53 every order is exact.

``bucket_collect`` is K5's plain version over many segments: on CPU
tensors it runs here, on CUDA tensors it launches K5 (``cuda_aggs``) or
raises.  ``masked_centroids`` stays torch ops on every device (a float64
sort, then ``pairwise_sums`` over contiguous rank bins), equal on the
card and the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import torch

from opensearch_tpu_torch.common import torchenv  # noqa: F401

_F64 = torch.float64
_I64 = torch.int64
MODES = ("ordinal", "edges", "single")


def pairwise_sums(x, seg, n_seg: int):
    """Float64 sums of ``x`` grouped by ``seg`` (int64 in
    ``[0, n_seg)``), each group's entries combined in the pairwise tree
    of their order in ``x`` (see the module doc); empty groups sum to
    0.0."""
    n = x.shape[0]
    out = torch.zeros(n_seg, dtype=_F64, device=x.device)
    if n == 0:
        return out
    order = torch.argsort(seg, stable=True)
    xs = x.to(_F64)[order]
    ss = seg[order]
    counts = torch.bincount(ss, minlength=n_seg)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=x.device)
    rank = pos - starts[ss]
    length = counts[ss]
    longest = int(counts.max())
    step = 1
    while step < longest:
        take = (rank % (2 * step) == 0) & (rank + step < length)
        partner = (pos + step).clamp(max=n - 1)
        xs = torch.where(take, xs + xs[partner], xs)
        step *= 2
    first = xs[starts.clamp(max=n - 1)]
    return torch.where(counts > 0, first + 0.0, out)


def masked_centroids(values, value_docs, matched, *, n_cent: int):
    """Equal-weight centroids of the MATCHED values (the percentiles
    sketch): one float64 sort puts the matched values first, ranks bin
    them into ``n_cent`` equal-count runs, and each run's mean is its
    ``pairwise_sums`` sum over its count.  Returns (means [n_cent] f64,
    weights [n_cent] i64)."""
    ok = matched[value_docs.long()]
    key = torch.where(ok, values.to(_F64),
                      torch.tensor(torch.inf, dtype=_F64,
                                   device=values.device))
    sv = torch.sort(key).values
    total = ok.sum()
    ranks = torch.arange(sv.shape[0], device=values.device)
    valid = ranks < total
    bins = torch.clamp((ranks * n_cent) // torch.clamp(total, min=1), 0,
                       n_cent - 1)
    tgt = torch.where(valid, bins, n_cent)
    sums = pairwise_sums(torch.where(valid, sv, 0.0), tgt, n_cent + 1)
    cnts = torch.zeros(n_cent + 1, dtype=_I64, device=values.device)
    cnts.index_add_(0, tgt, valid.to(_I64))
    means = sums[:n_cent] / torch.clamp(cnts[:n_cent], min=1)
    return means, cnts[:n_cent]


def _first_occurrence(docs, buckets):
    """Mask of entries that are the first (doc, bucket) occurrence in the
    (sorted-per-doc) expanded arrays."""
    prev_same = torch.cat([
        torch.zeros(1, dtype=torch.bool, device=docs.device),
        (docs[1:] == docs[:-1]) & (buckets[1:] == buckets[:-1])])
    return ~prev_same


def edge_buckets(values, edges):
    """``searchsorted(edges, values, side="right") - 1`` with the values
    compared as float64, as the reference promotes them."""
    return torch.searchsorted(edges.to(_F64), values.to(_F64),
                              right=True).to(torch.int32) - 1


def ordinal_counts(ords, value_docs, matched, *, n_buckets_pad: int):
    """Per-ordinal doc counts over matched docs (terms agg on a keyword
    column; ordinals pre-deduped per doc at segment build)."""
    ok = matched[value_docs.long()] & (ords >= 0)
    tgt = torch.where(ok, ords.long(), n_buckets_pad - 1)
    out = torch.zeros(n_buckets_pad, dtype=_I64, device=ords.device)
    return out.index_add_(0, tgt, ok.to(_I64))


def bucketed_counts(values, value_docs, matched, edges, *,
                    n_buckets_pad: int):
    """Histogram doc counts: bucket b covers [edges[b], edges[b+1]).
    Values outside [edges[0], edges[-1]) are dropped; docs count once
    per bucket even with several values in it."""
    b = edge_buckets(values, edges)
    ok = (matched[value_docs.long()] & (b >= 0)
          & (b < edges.shape[0] - 1))
    ok &= _first_occurrence(value_docs, b)
    tgt = torch.where(ok, b.long(), n_buckets_pad - 1)
    out = torch.zeros(n_buckets_pad, dtype=_I64, device=values.device)
    return out.index_add_(0, tgt, ok.to(_I64))


def _min_max(tgt, vals_min, vals_max, size: int):
    dev = tgt.device
    mn = torch.full((size,), torch.inf, dtype=_F64, device=dev)
    mx = torch.full((size,), -torch.inf, dtype=_F64, device=dev)
    mn.scatter_reduce_(0, tgt, vals_min, reduce="amin", include_self=True)
    mx.scatter_reduce_(0, tgt, vals_max, reduce="amax", include_self=True)
    return mn, mx


def masked_metrics(values, value_docs, matched):
    """(sum, value_count, min, max) over every value of matched docs
    (SortedNumeric keeps duplicates — they all count); the sum is the
    pairwise tree over the matched values in column order."""
    ok = matched[value_docs.long()]
    fvals = values.to(_F64)
    s = pairwise_sums(torch.where(ok, fvals, 0.0), (~ok).long(), 2)[0]
    c = ok.sum()
    mn = torch.where(ok, fvals, torch.inf).min()
    mx = torch.where(ok, fvals, -torch.inf).max()
    return s, c, mn, mx


def per_doc_partials(values, value_docs, matched, *, n_pad: int):
    """Per-doc (sum, count, min, max) of a numeric column — the building
    block for metric sub-aggregations under bucket aggs.  A doc's sum
    adds its values in column order from 0.0, one round per value rank,
    so no doc is added to twice in one op (deterministic on CUDA)."""
    dev = values.device
    docs = value_docs.long()
    ok = matched[docs]
    fvals = values.to(_F64)
    tgt = torch.where(ok, docs, n_pad - 1)
    s = torch.zeros(n_pad, dtype=_F64, device=dev)
    if docs.numel():
        rank = torch.arange(docs.shape[0], device=dev) - \
            torch.searchsorted(value_docs, value_docs)
        rounds = int(torch.where(ok, rank, 0).max()) + 1
        for r in range(rounds):
            sel = ok & (rank == r)
            s.index_add_(0, torch.where(sel, docs, n_pad - 1),
                         torch.where(sel, fvals, 0.0))
    c = torch.zeros(n_pad, dtype=_I64, device=dev).index_add_(
        0, tgt, ok.to(_I64))
    mn, mx = _min_max(tgt, torch.where(ok, fvals, torch.inf),
                      torch.where(ok, fvals, -torch.inf), n_pad)
    return s, c, mn, mx


def scatter_partials_to_buckets(bucket_entries_docs, bucket_entries_b,
                                entry_ok, per_doc, *, n_buckets_pad: int):
    """Second-level scatter: per-doc metric partials -> per-bucket partials
    through the bucket-entry (doc, bucket) pairs (docs in several buckets
    contribute to each); each bucket's sum is the pairwise tree over its
    entries in entry order."""
    s_doc, c_doc, mn_doc, mx_doc = per_doc
    tgt = torch.where(entry_ok, bucket_entries_b.long(), n_buckets_pad - 1)
    d = bucket_entries_docs.long()
    s = pairwise_sums(torch.where(entry_ok, s_doc[d], 0.0), tgt,
                      n_buckets_pad)
    c = torch.zeros(n_buckets_pad, dtype=_I64, device=d.device).index_add_(
        0, tgt, torch.where(entry_ok, c_doc[d], 0))
    mn, mx = _min_max(tgt, torch.where(entry_ok, mn_doc[d], torch.inf),
                      torch.where(entry_ok, mx_doc[d], -torch.inf),
                      n_buckets_pad)
    return s, c, mn, mx


# -- K5's plain version: the bucket collector over a request's segments --

@dataclass
class CollectSegment:
    """One segment's input to the bucket collector (K5).

    ``matched`` bool [n_pad]; ``keys`` the key column's entries (int32
    ordinals in ``ordinal`` mode and for an ordinal ``single`` count,
    int64 or float64 values otherwise) and ``key_docs`` int32 their
    docs, sorted by doc with the column's pads; ``n_buckets`` the real
    buckets (``n_buckets_pad = pad_pow2(n_buckets + 1)``); ``subs`` one
    numeric column dict (``values``, ``value_docs``, ``offsets``) per
    metric sub-column, or None where the segment lacks it."""

    matched: torch.Tensor
    keys: torch.Tensor
    key_docs: torch.Tensor
    n_buckets: int
    subs: list = dc_field(default_factory=list)

    @property
    def n_buckets_pad(self) -> int:
        from opensearch_tpu_torch.index.segment import pad_pow2
        return pad_pow2(self.n_buckets + 1)


def output_words(segments, n_subs: int) -> list:
    """Each segment's first word in the collector's flat int64 output:
    per segment ``[counts | sum_0, count_0, min_0, max_0 | ...]``, each
    part ``n_buckets_pad`` words (sums, min and max as float64 bits)."""
    offs, at = [], 0
    for seg in segments:
        offs.append(at)
        at += seg.n_buckets_pad * (1 + 4 * n_subs)
    offs.append(at)
    return offs


def unpack(flat, segments, n_subs: int) -> list:
    """The collector's flat output, read back as a numpy int64 array, as
    per segment ``(counts, [(sum, count, min, max) per sub])``."""
    offs = output_words(segments, n_subs)
    out = []
    for si, seg in enumerate(segments):
        nbp = seg.n_buckets_pad
        part = flat[offs[si]: offs[si + 1]].reshape(1 + 4 * n_subs, nbp)
        subs = [(part[1 + 4 * j].view("float64"), part[2 + 4 * j],
                 part[3 + 4 * j].view("float64"),
                 part[4 + 4 * j].view("float64")) for j in range(n_subs)]
        out.append((part[0], subs))
    return out


def _collect_one(seg: CollectSegment, mode: str, edges, self_metric: bool):
    nbp = seg.n_buckets_pad
    docs = seg.key_docs.long()
    ok = seg.matched[docs]
    if mode == "ordinal":
        b = seg.keys.long()
        ok = ok & (b >= 0)
    elif mode == "edges":
        b = edge_buckets(seg.keys, edges).long()
        ok = ok & (b >= 0) & (b < seg.n_buckets)
        ok &= _first_occurrence(seg.key_docs, b)
    else:
        b = torch.zeros_like(docs)
        if seg.keys.dtype == torch.int32:
            ok = ok & (seg.keys >= 0)
    tgt = torch.where(ok, b, nbp - 1)
    counts = torch.zeros(nbp, dtype=_I64, device=docs.device).index_add_(
        0, tgt, ok.to(_I64))
    parts = [counts]
    if self_metric:
        v = seg.keys.to(_F64)
        s = pairwise_sums(torch.where(ok, v, 0.0), tgt, nbp)
        mn, mx = _min_max(tgt, torch.where(ok, v, torch.inf),
                          torch.where(ok, v, -torch.inf), nbp)
        parts += [s.view(_I64), counts.clone(), mn.view(_I64),
                  mx.view(_I64)]
    n_pad = seg.matched.shape[0]
    for col in seg.subs:
        if col is None:
            empty = torch.zeros(0, dtype=_F64, device=docs.device)
            col = {"values": empty,
                   "value_docs": torch.zeros(0, dtype=torch.int32,
                                             device=docs.device)}
        per_doc = per_doc_partials(col["values"], col["value_docs"],
                                   seg.matched, n_pad=n_pad)
        s, c, mn, mx = scatter_partials_to_buckets(
            seg.key_docs, b, ok, per_doc, n_buckets_pad=nbp)
        parts += [s.view(_I64), c, mn.view(_I64), mx.view(_I64)]
    return torch.cat(parts)


def bucket_collect_plain(segments, *, mode: str, edges=None,
                         self_metric: bool = False):
    """K5's plain version: every segment's bucket doc counts and, per
    metric sub-column, per-bucket (sum, count, min, max), in the flat
    int64 layout of ``output_words``.

    - ``ordinal``: the bucket is the entry's ordinal (terms on a
      keyword; ordinals are deduplicated per doc);
    - ``edges``: ``edge_buckets(keys, edges)``, counting only a doc's
      first entry in a bucket (histogram, date_histogram);
    - ``single``: one bucket.  With ``self_metric`` the key column's own
      values are the metric (min / max / sum / avg / stats: sums over
      every matched value, duplicates included) and ``subs`` is empty;
      an int32 key column counts its entries with an ordinal >= 0
      (value_count on a keyword)."""
    if mode not in MODES:
        raise ValueError(f"unknown collector mode [{mode}]")
    if self_metric and (mode != "single"
                        or any(seg.subs for seg in segments)):
        raise ValueError("self_metric takes the single mode and no subs")
    parts = [_collect_one(seg, mode, edges, self_metric)
             for seg in segments]
    if not parts:
        return torch.zeros(0, dtype=_I64)
    return torch.cat(parts)


def bucket_collect(segments, *, mode: str, edges=None,
                   self_metric: bool = False):
    """The bucket collector: K5 (one launch over every segment) on CUDA
    tensors, its plain version on CPU tensors."""
    if segments and segments[0].matched.is_cuda:
        from opensearch_tpu_torch.ops import cuda_aggs
        return cuda_aggs.bucket_collect_cuda(
            segments, mode=mode, edges=edges, self_metric=self_metric)
    return bucket_collect_plain(segments, mode=mode, edges=edges,
                                self_metric=self_metric)
