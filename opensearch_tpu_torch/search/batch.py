"""Batched multi-query execution (the port of the JAX package's
``search/batch.py``): the scored term bags of an msearch, or of a
continuous batch, that share (field, size) run as ONE program over every
segment of the shard.

- ``batch_impact_union_topk`` is the reference's per-segment kernel in
  plain torch, with its signature, its return value and its float32
  operation order: one gather over the union of the batch's terms, one
  flat scatter of ``idf * imp`` into a ``[T * n_pad]`` arena, each
  query's weighted row gathers in its own term order, the optional
  presence counts against ``required``, then a top-k with the lower doc
  first on ties (a stable descending sort).
- ``batch_term_bag_topk_segments`` runs it on every segment of a batch
  and lays the results out as K3 returns them; ``batch_term_bag_topk_auto``
  launches K3 (``ops/cuda_bm25.py`` ``batch_term_bag_topk_cuda``,
  ``csrc/union_topk.cu``: each union posting staged once in shared
  memory, every query of a chunk scored from there) once for the whole
  batch on CUDA tensors and takes the plain version on CPU ones.
- ``BatchGroup`` assembles a group's inputs (cached on the searcher per
  group signature for msearch), runs them, and merges each query's rows
  across segments on the host as the reference does.
- ``plan_batches`` splits msearch bodies into one group per (field,
  size) and the bodies that take the sequential path.

A group runs in a residency-ledger scope, marks its segments used with
one ``record_dispatch`` and counts its read-back with one
``record_fetch``.  With a profiler (``search/profile.py``), shared by the
group's members, it records ``execution_path`` ``device_batched``, the
``batch_prep_cache`` hit or miss, the assembly as ``prepare``, the
segments no term of the batch reaches as ``pruned_can_match``, the others
as scanned (sharing the launch's host time) and the read-back and merge
as ``reduce``.

Per (query, doc) the contributions add in the query's term order from
0.0, each ``w * (idf * imp)``, so batched scores equal the sequential
path's byte for byte.  Unlike the reference there is no host fallback
on a device error: a CUDA tensor gets K3 or an exception.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from opensearch_tpu_torch.common import torchenv  # noqa: F401
from opensearch_tpu_torch.common.device_ledger import device_ledger
from opensearch_tpu_torch.common.errors import OpenSearchTpuError
from opensearch_tpu_torch.index.segment import pad_bucket, pad_pow2
from opensearch_tpu_torch.ops import bm25 as bm25_ops
from opensearch_tpu_torch.ops.cuda_bm25 import K_MAX, UNION_MAX_TERMS
from opensearch_tpu_torch.search import plan as P
from opensearch_tpu_torch.search import profile

_I32 = np.int32
_F32 = np.float32


def batch_impact_union_topk(offsets, doc_ids, impacts, live,
                            union_tids, union_active, union_idfs,
                            qslots, qweights, qact, required,
                            *, n_pad: int, budget: int, k: int,
                            need_counts: bool):
    """Score Q term-bag queries against one segment (the reference's
    ``batch_impact_union_topk``).  ``union_tids`` / ``union_active`` /
    ``union_idfs`` are [T]; ``qslots`` / ``qweights`` / ``qact`` are [Q,
    TQ] — query q's j-th term as a union slot, its weight and its
    occurrence (0 on padding, so duplicate terms keep counting for AND);
    ``required`` is [Q] (inf on padding rows).  Returns (vals [Q, k],
    idx [Q, k] i32, totals [Q], maxes [Q])."""
    d, imp, slot, valid = bm25_ops.gather_postings(
        offsets, doc_ids, impacts, union_tids, union_active,
        budget=budget, pad_doc=n_pad - 1)
    slot_l = slot.long()
    base = torch.where(valid, union_idfs[slot_l] * imp, 0.0)
    t_pad = union_tids.shape[0]
    flat_idx = slot_l * n_pad + d.long()
    dev = offsets.device
    # each (slot, doc) receives one posting at most, beside zeros, so the
    # scatter is exact in any order
    dense = torch.zeros(t_pad * n_pad, dtype=torch.float32,
                        device=dev).index_add_(0, flat_idx, base)
    dense = dense.view(t_pad, n_pad)
    q_pad, tq = qslots.shape
    scores = torch.zeros((q_pad, n_pad), dtype=torch.float32, device=dev)
    for j in range(tq):
        scores = scores + qweights[:, j: j + 1] * dense[qslots[:, j].long()]
    if need_counts:
        pres = torch.zeros(t_pad * n_pad, dtype=torch.float32,
                           device=dev).index_add_(0, flat_idx,
                                                  valid.to(torch.float32))
        pres = pres.view(t_pad, n_pad)
        counts = torch.zeros((q_pad, n_pad), dtype=torch.float32,
                             device=dev)
        for j in range(tq):
            counts = counts + qact[:, j: j + 1] * torch.clamp(
                pres[qslots[:, j].long()], max=1.0)
        matched = (counts >= required[:, None]) & live[None, :]
    else:
        # every query is a positive-weight OR bag: score > 0 iff matched
        matched = (scores > 0.0) & live[None, :]
    key = torch.where(matched, scores, -torch.inf)
    vals, idx = torch.sort(key, dim=1, descending=True, stable=True)
    return (vals[:, :k], idx[:, :k].to(torch.int32), matched.sum(dim=1),
            torch.max(key, dim=1).values)


def _host(arr, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def batch_term_bag_topk_segments(segments, required, *, n_queries: int,
                                 k: int, need_counts: bool
                                 ) -> bm25_ops.TermBagTopK:
    """Plain version of K3: ``batch_impact_union_topk`` on every
    ``bm25.BatchSegment`` at ``min(k, n_pad)``, laid out as K3 returns
    it.  Row ``q * S + s`` holds query q's top-k on segment s, with the
    ids past the matched docs set to -1 and padded with ``(-inf, -1)`` to
    ``k``; ``required`` is f32 [q_pad]."""
    dev = segments[0].doc_ids.device
    n_seg = len(segments)
    out = bm25_ops.empty_topk(n_queries * n_seg, k, dev)
    vals_out = out.vals.view(n_queries, n_seg, k)
    ids_out = out.ids.view(n_queries, n_seg, k)
    req = _host(required, dev)
    for s, seg in enumerate(segments):
        n_pad = seg.live.shape[0]
        kk = min(k, n_pad)
        vals, idx, totals, maxes = batch_impact_union_topk(
            seg.offsets, seg.doc_ids, seg.impacts, seg.live,
            *(_host(a, dev) for a in (seg.union_tids, seg.union_active,
                                      seg.union_idfs, seg.qslots,
                                      seg.qweights, seg.qact)),
            req, n_pad=n_pad, budget=seg.budget, k=kk,
            need_counts=need_counts)
        vals, idx = vals[:n_queries], idx[:n_queries]
        vals_out[:, s, :kk] = vals
        vals_out[:, s, kk:] = -torch.inf
        ids_out[:, s, :kk] = torch.where(torch.isneginf(vals), -1, idx)
        ids_out[:, s, kk:] = -1
        out.totals.view(n_queries, n_seg)[:, s] = totals[:n_queries]
        out.maxes.view(n_queries, n_seg)[:, s] = maxes[:n_queries]
    return out


def batch_term_bag_topk_auto(segments, required, *, n_queries: int, k: int,
                             need_counts: bool, table=None
                             ) -> bm25_ops.TermBagTopK:
    """Every (query, segment)'s top-k, total and max of a batch of scored
    bags: one K3 launch for the whole batch on CUDA tensors (``table``,
    what ``cuda_bm25.pinned_union_table`` built for these inputs and k, or
    None to build it), the plain version on CPU ones."""
    if segments[0].doc_ids.is_cuda:
        from opensearch_tpu_torch.ops import cuda_bm25
        return cuda_bm25.batch_term_bag_topk_cuda(
            segments, required, n_queries=n_queries, k=k,
            need_counts=need_counts, table=table)
    return batch_term_bag_topk_segments(segments, required,
                                        n_queries=n_queries, k=k,
                                        need_counts=need_counts)


class BatchGroup:
    """Scored term bags sharing (field, k), run as one program over every
    segment."""

    def __init__(self, field: str, k: int):
        self.field = field
        self.k = k
        self.positions: list[int] = []    # index into the caller's bodies
        self.terms: list[tuple] = []
        self.idfs: list[np.ndarray] = []
        self.weights: list[np.ndarray] = []
        self.required: list[int] = []
        self.avgdl = 1.0
        self.wide: list[tuple[int, dict]] = []   # (position, bind)

    def add(self, pos: int, bind: dict):
        if len(bind["terms"]) > UNION_MAX_TERMS:
            self.wide.append((pos, bind))    # more than K3 stages
            return
        self.positions.append(pos)
        self.terms.append(tuple(bind["terms"]))
        self.idfs.append(np.asarray(bind["idfs"], _F32))
        self.weights.append(np.asarray(bind["weights"], _F32))
        self.required.append(int(bind["required"]))
        self.avgdl = float(bind["avgdl"])

    def signature(self) -> tuple:
        """Value identity of the batch: same signature -> identical
        inputs (idfs and avgdl derive from the searcher's statistics,
        and the cache lives on that searcher)."""
        return (self.field, self.k, tuple(self.terms),
                tuple(tuple(float(x) for x in w) for w in self.weights),
                tuple(self.required))

    def _prepare(self, searcher) -> dict:
        """Host assembly of every segment's union and per-query slots
        (the reference's ``_prepare``), and on CUDA K3's launch table in
        pinned memory.  Segments where no term of the batch exists are
        left out (nothing can match there).  Quantized segments stay on
        the f32 lowering, as in the reference: their f32 columns stage on
        demand here (``DeviceSegment.ensure_postings``)."""
        n_q = len(self.positions)
        q_pad = pad_pow2(n_q, minimum=8)
        lens = np.asarray([len(t) for t in self.terms], np.int64)
        tq = pad_pow2(int(lens.max(initial=1)), minimum=1)
        need_counts = any(r != 1 for r in self.required) \
            or any((w <= 0).any() for w in self.weights) \
            or any((i <= 0).any() for i in self.idfs)
        required = np.full(q_pad, np.inf, _F32)   # padding matches nothing
        required[:n_q] = self.required
        # the batch's terms in order of first use: union slots follow it
        distinct = list(dict.fromkeys(t for ts in self.terms for t in ts))
        pos_of = {t: i for i, t in enumerate(distinct)}
        flat = np.asarray([pos_of[t] for ts in self.terms for t in ts],
                          np.int64)
        q_of = np.repeat(np.arange(n_q), lens)
        starts = np.concatenate([[0], np.cumsum(lens)])[:-1]
        idf_flat = np.concatenate(self.idfs)
        w_flat = np.concatenate(self.weights)
        dev = searcher.device
        segs, order, views = [], [], []
        for seg_order, seg in enumerate(searcher.segments):
            pf = seg.postings.get(self.field)
            if pf is None:
                continue
            tids = np.asarray([pf.term_id(t) for t in distinct], np.int64)
            present = tids >= 0
            n_u = int(present.sum())
            if not n_u:
                continue
            t_pad = pad_pow2(n_u, minimum=8)
            slot_of = np.cumsum(present) - 1      # distinct term -> slot
            union_tids = np.zeros(t_pad, _I32)
            union_active = np.zeros(t_pad, bool)
            union_idfs = np.zeros(t_pad, _F32)
            union_rows = np.zeros((t_pad, 2), np.int64)
            union_tids[:n_u] = tids[present]
            union_active[:n_u] = True
            union_rows[:n_u, 0] = pf.offsets[tids[present]]
            union_rows[:n_u, 1] = pf.offsets[tids[present] + 1]
            # each query's present terms in its term order: its j-th
            # present term -> union slot, weight, occurrence (duplicate
            # terms keep satisfying AND)
            hit = present[flat]
            seen = np.concatenate([[0], np.cumsum(hit)])
            j_of = seen[:-1] - np.repeat(seen[starts], lens)
            slots = slot_of[flat[hit]]
            qslots = np.zeros((q_pad, tq), _I32)
            qweights = np.zeros((q_pad, tq), _F32)
            qact = np.zeros((q_pad, tq), _F32)
            qslots[q_of[hit], j_of[hit]] = slots
            qweights[q_of[hit], j_of[hit]] = w_flat[hit]
            qact[q_of[hit], j_of[hit]] = 1.0
            # the reference keeps the idf of the last query to name the
            # term; idf is a property of the term
            last = np.full(n_u, -1, np.int64)
            np.maximum.at(last, slots, np.flatnonzero(hit))
            union_idfs[:n_u] = idf_flat[last]
            dseg = seg.device(dev)
            p = dseg.ensure_postings(self.field)
            segs.append(bm25_ops.BatchSegment(
                p["offsets"], p["doc_ids"],
                # quantize-ok: the batched path stays on the f32 lowering
                dseg.impacts(self.field, self.avgdl),
                searcher.ctx.live_mask(seg, dseg), union_tids,
                union_active, union_idfs, union_rows, qslots, qweights,
                qact, pad_bucket(int(pf.df[tids[present]].sum()))))
            order.append(seg_order)
            views.append(dseg)
        table = None
        if segs and dev.type == "cuda":
            from opensearch_tpu_torch.ops import cuda_bm25
            # device pointers of this searcher's point-in-time live masks:
            # cached on this searcher only
            table = cuda_bm25.pinned_union_table(
                segs, required, n_queries=n_q, k=self.k,
                need_counts=need_counts)
        return {"segs": segs, "order": np.asarray(order, _I32),
                "required": required, "need_counts": need_counts,
                "table": table, "groups": [d._ledger_group for d in views]}

    def run(self, searcher, cache: bool = True, prof=None) -> dict:
        """Execute against every segment; returns {pos: (rows, total,
        max_score)} in the sequential path's row format: one K3 launch
        and one read-back on CUDA, the plain version on the CPU, then a
        host merge per query (score desc, then segment, then doc); a bag
        beyond ``UNION_MAX_TERMS`` takes ``_run_wide`` instead.  With
        ``cache`` the group's inputs are kept on the searcher per
        signature, so a repeated batch assembles nothing.  ``prof``: the
        group's profiler (module docstring)."""
        with device_ledger().request():
            return self._run(searcher, cache, prof)

    def _run(self, searcher, cache: bool, prof) -> dict:
        out = {pos: self._run_wide(searcher, bind)
               for pos, bind in self.wide}
        if not self.positions:
            return out
        if prof is not None:
            prof.set("execution_path", "device_batched")
        with profile.phase(prof, "prepare"):
            prep = searcher._batch_prep_cache.get(self.signature()) \
                if cache else None
            if prof is not None:
                prof.set("batch_prep_cache",
                         "miss" if prep is None else "hit")
            if prep is None:
                prep = self._prepare(searcher)
                if cache:
                    prep = searcher._batch_prep_cache.put(self.signature(),
                                                          prep)
        if prof is not None:
            # a segment the union leaves out holds no term of the batch:
            # the batched path's can-match (recorded first, as the
            # reference records them)
            staged = prep["order"].tolist()
            for so, seg in enumerate(searcher.segments):
                if so not in staged:
                    prof.seg_pruned(seg.seg_id, "pruned_can_match", 0.0)
            for so in staged:
                prof.scan(searcher.segments[so].seg_id)
        segs = prep["segs"]
        if not segs:
            return {**out, **{pos: ([], 0, None) for pos in self.positions}}
        n_q, n_seg, k = len(self.positions), len(segs), self.k
        device_ledger().record_dispatch(prep["groups"])
        t_disp = time.monotonic()
        result = batch_term_bag_topk_auto(
            segs, prep["required"], n_queries=n_q, k=k,
            need_counts=prep["need_counts"], table=prep["table"])
        t_sync = time.monotonic()
        if prof is not None:
            prof.launched(t_sync - t_disp)
        vals, ids, totals, maxes = result.numpy()
        device_ledger().record_fetch(
            vals.nbytes + ids.nbytes + totals.nbytes + maxes.nbytes,
            time.monotonic() - t_sync)
        vals = vals.reshape(n_q, n_seg * k)
        ids = ids.reshape(n_q, n_seg * k)
        totals = totals.reshape(n_q, n_seg).astype(np.int64).sum(axis=1)
        maxes = maxes.reshape(n_q, n_seg).max(axis=1)
        seg_of = np.repeat(prep["order"], k)
        for qi, pos in enumerate(self.positions):
            keep = vals[qi] > -np.inf
            v, s, loc = vals[qi][keep], seg_of[keep], ids[qi][keep]
            top = np.lexsort((loc, s, -v))[:k]
            rows = [{"seg": int(s[i]), "local": int(loc[i]),
                     "score": float(v[i])} for i in top]
            mx = float(maxes[qi])
            out[pos] = (rows, int(totals[qi]),
                        None if mx == -np.inf else mx)
        if prof is not None:
            prof.add("reduce", time.monotonic() - t_sync)
        return out


    def _run_wide(self, searcher, bind) -> tuple:
        """A bag of more terms than K3 stages (``UNION_MAX_TERMS``): K2's
        top-k over every segment in the f32 lowering, the batched path's
        lowering on quantized segments too, as in the reference, whose
        batch takes a bag of any size."""
        return searcher._topk_term_bag(
            P.TermBagPlan(field=self.field), bind,
            frozenset({("postings", self.field)}), self.k,
            searcher._min_score(None), None, None, f32=True)


def batchable(searcher, body: dict, *, peek: bool = False):
    """``(plan, bind, k)`` when ``body`` may take the batched path with the
    sequential path's response, else None.  The sequential path serves
    the others: ``executor.SEQUENTIAL_KEYS`` (``suggest``, which it
    runs, and ``script_fields`` and ``post_filter``, as the reference's
    batch sends them; a ``profile`` batches, as in the reference), the
    keys that
    shape a response beyond a plain top-k (``executor.RESULT_KEYS``:
    ``sort``, ``search_after``, ``collapse``, ``rescore`` and the fetch
    options, as the reference's exclusion list tests them), a
    ``timeout`` (its deadline is checked between the sequential path's
    per-segment programs), ``min_score``, ``track_total_hits: false``
    (whose pruning may legally return lower-bound totals), ``from > 0``,
    plans other than a scored term bag, and ``size`` outside 1..K_MAX
    (K3 keeps at most K_MAX candidates per (query, segment), and the
    sequential path, K2's dense entry plus the stable sort, gives the
    same answer for a larger page).  ``aggs`` / ``aggregations`` are
    excluded by name: the batched path answers hits only.  Compiles
    through the searcher's plan cache; with ``peek`` only a plan that
    cache already holds counts (the continuous batcher's rule: a
    first-seen query runs, and compiles, on the sequential path)."""
    from opensearch_tpu_torch.search.executor import (RESULT_KEYS,
                                                      SEQUENTIAL_KEYS)

    if (body.get("sort") is not None
            or any(body.get(key) for key in RESULT_KEYS + SEQUENTIAL_KEYS)
            or body.get("aggs") or body.get("aggregations")
            or body.get("min_score") is not None
            or body.get("timeout") is not None
            or body.get("track_total_hits") is False
            or int(body.get("from", 0)) != 0):
        return None
    k = int(body.get("size", 10))
    if not 1 <= k <= K_MAX:
        return None
    if peek:
        out = searcher.cached_plan(body.get("query"))
        if out is None:
            return None
        plan, bind = out
    else:
        try:
            plan, bind = searcher.compiled(body.get("query"), scored=True)
        except OpenSearchTpuError:
            return None              # the sequential path raises it
    if not isinstance(plan, P.TermBagPlan) or not plan.scored:
        return None
    return plan, bind, k


def plan_batches(searcher, bodies: list) -> tuple[list, list]:
    """Partition msearch bodies into batchable groups and a fallback
    list: ``([BatchGroup], [positions for the sequential path])``.  One
    group per (field, size)."""
    groups: dict = {}
    fallback = []
    for pos, body in enumerate(bodies):
        parsed = batchable(searcher, body or {})
        if parsed is None:
            fallback.append(pos)
            continue
        plan, bind, k = parsed
        group = groups.get((plan.field, k))
        if group is None:
            group = groups[(plan.field, k)] = BatchGroup(plan.field, k)
        group.add(pos, bind)
    return list(groups.values()), fallback
