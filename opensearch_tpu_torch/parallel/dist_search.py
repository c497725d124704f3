"""Cross-shard search over a device mesh: the scatter-gather of an index's
shards as device work, merged on the card (the port of the JAX package's
``parallel/dist_search.py``).

The reference's mesh is one controller driving several devices, and so
is this one: a mesh is a plain list of ``torch.device``, one per shard
(``make_mesh``), and no ``torch.distributed`` process group is involved.

- ``MeshSearcher.search``: every shard's plan runs on its own mesh device
  through the port's kernels (K2 / K4's top-k entry for a scored term
  bag, else the pre-pass, the plan's ops and the plan top-k; K1 under a
  ``knn``), and each leaves its per-segment top-k lists on that device
  with no host sync.  The lists of every (shard, segment) then meet on
  the first mesh device (a peer copy a shard on several cards, a view on
  one) and K10 (``ops/cuda_mesh.py``, ``csrc/mesh_merge.cu``) merges them
  in one launch: their rows in shard-major, segment-major order make its
  lower-flat-index tie-break the reference's (score desc, shard asc,
  local rank asc), local rank being (segment asc, doc asc).  The host
  reads back the k winners, their flat indices and the local ids they
  pick, in one copy.  Scoring statistics are each shard's own (the
  reference's query_then_fetch).
- ``MeshSearcher.mesh_metric_aggs``: a ``size: 0`` request of top-level
  ``sum`` / ``avg`` / ``min`` / ``max`` / ``value_count`` / ``stats``
  over numeric fields: each shard's float64 ``(sum, count, min, max,
  total)`` partials from one K5 call (single mode) on its device,
  reduced on the first mesh device by ``sharded_metric_reduce`` (torch
  ops: five numbers a shard and agg, no kernel is worth writing for
  them).
- ``prepare_match_query`` / ``put_on_mesh`` / ``sharded_impact_topk``:
  a ``match`` with GLOBAL statistics (avgdl and df summed over the
  shards), each shard's impacts staged at the global avgdl, scored by
  K2's dense entry and cut by the plan top-k on its device, merged by
  K10; global doc id = ``shard * n_pad + local``.
- ``sharded_topk_merge``: the merge alone, K10 over ``[S, k]``.

A shard whose searcher already serves on its mesh device runs there as
it is (on one card nothing is staged twice); otherwise the mesh keeps a
searcher over the same segments on that device (until ``update_shards``
swaps the snapshot), whose views are staged there through the residency
ledger (the reference's per-device ``_dseg`` copies).
``put_on_mesh`` stages its per-query arrays through the ledger under
kind ``mesh``.  Several CUDA cards (peer copies to the first) are
untested: the card the port is measured on is one H100, where a mesh of
``[cuda:0] * S`` stands in for them.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import numpy as np
import torch

from opensearch_tpu_torch.common import torchenv  # noqa: F401
from opensearch_tpu_torch.common.device_ledger import device_ledger
from opensearch_tpu_torch.common.torchenv import resolve_device
from opensearch_tpu_torch.index.segment import pad_pow2
from opensearch_tpu_torch.ops import aggs as agg_ops
from opensearch_tpu_torch.ops import bm25 as bm25_ops
from opensearch_tpu_torch.ops.mesh import mesh_merge

_F64 = torch.float64
_MESH_METRICS = {"sum", "avg", "min", "max", "value_count", "stats"}


def make_mesh(n_devices: int, device=None) -> list:
    """The mesh of ``n_devices`` shards on ``device``'s kind (``cuda``
    unless the caller asks for the CPU): the first ``n_devices`` CUDA
    cards, raising when fewer are visible; on the CPU, ``n_devices``
    entries of the CPU device (the counterpart of the reference's
    virtual host devices)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * n_devices
    count = torch.cuda.device_count()
    if count < n_devices:
        raise ValueError(f"a mesh of {n_devices} devices needs {n_devices} "
                         f"CUDA cards, {count} visible")
    return [torch.device("cuda", i) for i in range(n_devices)]


def _canonical(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _on(dev):
    """The CUDA device context of ``dev`` (the hand kernels launch on the
    current device); nothing on the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def stack_shards(shard_list: list[dict]) -> dict:
    """Stack per-shard array dicts (identical bucketed shapes) along a new
    leading shards axis."""
    return {key: np.stack([np.asarray(s[key]) for s in shard_list])
            for key in shard_list[0]}


class MeshArray(list):
    """A stacked host array placed on the mesh: one tensor a shard (shard
    ``i``'s on mesh device ``i``), with the stacked numpy array it came
    from in ``host`` (the kernels' launch tables read per-slot values on
    the host)."""

    def __init__(self, tensors, host: np.ndarray):
        super().__init__(tensors)
        self.host = host


def put_on_mesh(stacked: dict, devices: list) -> dict:
    """Place shard-stacked host arrays on the mesh, each shard's slice on
    its device, staged through the residency ledger under kind ``mesh``
    (per-query inputs: recorded as transfers, not as resident groups)."""
    led = device_ledger()
    return {k: MeshArray([led.stage(None, v[i], device=devices[i],
                                    kind="mesh", name=k)
                          for i in range(v.shape[0])], v)
            for k, v in stacked.items()}


def prepare_match_query(segments: list, field: str, terms: list[str]):
    """Host-side prep of a global-statistics ``match``: per-shard postings
    laid out to common bucketed shapes, per-shard term ids, and the
    GLOBAL idf / avgdl summed over the shards (the reference's
    DFS_QUERY_THEN_FETCH), each shard's impact column computed at the
    global avgdl (``Segment.impact_table``).  Returns (stacked dict
    [S, ...], {"n_pad", "budget"})."""
    n_pad = pad_pow2(max(s.n_docs for s in segments) + 1)
    t_pad = pad_pow2(max((len(s.postings[field].offsets) for s in segments
                          if field in s.postings), default=8))
    p_pad = pad_pow2(max((len(s.postings[field].doc_ids) for s in segments
                          if field in s.postings), default=8))
    q_pad = pad_pow2(len(terms))

    doc_count = sum(s.postings[field].docs_with_field
                    for s in segments if field in s.postings)
    total_len = sum(s.postings[field].total_len
                    for s in segments if field in s.postings)
    avgdl = total_len / doc_count if doc_count else 1.0
    idfs = np.zeros(q_pad, np.float32)
    for i, t in enumerate(terms):
        df = 0
        for s in segments:
            pf = s.postings.get(field)
            if pf is not None:
                tid = pf.term_id(t)
                if tid >= 0:
                    df += int(pf.df[tid])
        idfs[i] = bm25_ops.idf(df, doc_count)

    shards = []
    budget = 8
    for s in segments:
        pf = s.postings.get(field)
        sh = {
            "offsets": np.zeros(t_pad, np.int32),
            "doc_ids": np.full(p_pad, n_pad - 1, np.int32),
            "impacts": np.zeros(p_pad, np.float32),
            "tids": np.zeros(q_pad, np.int32),
            "active": np.zeros(q_pad, bool),
            "idfs": idfs,
            "weights": np.where(np.arange(q_pad) < len(terms), 1.0, 0.0
                                ).astype(np.float32),
        }
        if pf is not None:
            impacts, _mx = s.impact_table(field, avgdl)
            sh["offsets"][: len(pf.offsets)] = pf.offsets
            sh["offsets"][len(pf.offsets):] = pf.offsets[-1]
            sh["doc_ids"][: len(pf.doc_ids)] = pf.doc_ids
            sh["impacts"][: len(impacts)] = impacts
            local_budget = 0
            for i, t in enumerate(terms):
                tid = pf.term_id(t)
                if tid >= 0:
                    sh["tids"][i] = tid
                    sh["active"][i] = True
                    local_budget += int(pf.df[tid])
            budget = max(budget, pad_pow2(local_budget))
        shards.append(sh)
    return stack_shards(shards), {"n_pad": n_pad, "budget": budget}


def _gather(parts, dev0) -> torch.Tensor:
    """``parts`` (one tensor, or a list of tensors on the mesh devices,
    each [n] or [r, n]) as one [R, n] tensor on ``dev0``: peer copies of
    the parts on other devices, a view of a lone part already there."""
    if isinstance(parts, torch.Tensor):
        parts = [parts]
    rows = [p.reshape(-1, p.shape[-1]).to(dev0) for p in parts]
    return rows[0] if len(rows) == 1 else torch.cat(rows)


def sharded_topk_merge(devices: list, k: int):
    """The coordinator's reduce on the mesh: ``merge(vals)`` takes every
    shard's top-k list (vals [k] or [r, k] per shard, each row sorted
    descending, -inf padding, a list over the mesh devices or one [S, k]
    tensor) and returns ``(vals [k], flat_idx [k] int64)`` on the first
    mesh device: one K10 launch on CUDA.  ``flat_idx`` indexes the
    shard-major concatenation (shard = flat_idx // k for [S, k]), ties
    broken (score desc, shard asc, local rank asc), as the reference's
    all-gather and ``lax.top_k``."""
    dev0 = devices[0]

    def merge(vals):
        with _on(dev0):
            return mesh_merge(_gather(vals, dev0), k)

    return merge


def sharded_metric_reduce(devices: list):
    """``reduce(parts)``: per-shard float64 metric partials ``[..., 5]``
    ``(sum, count, min, max, total)`` (a list over the mesh devices, or
    one [S, ..., 5] tensor) reduced to one ``[..., 5]`` on the first mesh
    device: sums, counts and totals added in shard order, min and max
    over the shards (the reference's psum / pmin / pmax)."""
    dev0 = devices[0]

    def reduce(parts):
        parts = [p.to(dev0) for p in parts]
        with _on(dev0):
            acc = parts[0].clone()
            for p in parts[1:]:
                acc[..., 0] += p[..., 0]
                acc[..., 1] += p[..., 1]
                acc[..., 2] = torch.minimum(acc[..., 2], p[..., 2])
                acc[..., 3] = torch.maximum(acc[..., 3], p[..., 3])
                acc[..., 4] += p[..., 4]
            return acc

    return reduce


def _slot_rows(offsets: np.ndarray, tids: np.ndarray,
               active: np.ndarray) -> np.ndarray:
    """Each query slot's posting range ``[start, end)`` in a shard's CSR
    ``offsets`` ((0, 0) where the slot is inactive)."""
    t = tids.astype(np.int64)
    rows = np.stack([offsets[t], offsets[t + 1]], axis=1).astype(np.int64)
    return np.where(active[:, None], rows, 0)


def sharded_impact_topk(devices: list, *, n_pad: int, budget: int,
                        k: int):
    """The one-step distributed query of a ``prepare_match_query``:
    ``step(offsets, doc_ids, impacts, tids, active, idfs, weights)`` over
    ``put_on_mesh``'s arrays.  Every shard scores its postings from its
    precomputed impact column on its own device (K2's dense entry), takes
    its top k of all ``n_pad`` docs, zeros included (the plan top-k,
    lower doc first on ties, as ``lax.top_k``), and K10 merges the
    shards' lists on the first mesh device.  Returns (scores [k],
    global_doc_ids [k] int64) there; global id = shard * n_pad + local,
    so ties break (score desc, shard asc, local doc asc)."""
    merge = sharded_topk_merge(devices, k)

    def step(offsets, doc_ids, impacts, tids, active, idfs, weights):
        vals, gids = [], []
        for i, dev in enumerate(devices):
            with _on(dev):
                bag = bm25_ops.DenseBag(
                    offsets[i], doc_ids[i], impacts[i], n_pad,
                    tids.host[i], active.host[i], idfs.host[i],
                    weights.host[i],
                    _slot_rows(offsets.host[i], tids.host[i],
                               active.host[i]), budget)
                (scores, _c), = bm25_ops.term_bag_dense_auto(
                    [bag], scores=True, counts=False)
                every = torch.ones(n_pad, dtype=torch.bool, device=dev)
                out = bm25_ops.plan_topk_segments_auto(
                    [bm25_ops.PlanScores(scores, every)], k=k)
                vals.append(out.vals)
                gids.append(out.ids.to(torch.int64) + i * n_pad)
        fv, fi = merge(vals)
        return fv, _gather(gids, devices[0]).reshape(-1)[fi]

    return step


class MeshSearcher:
    """Distributed search over shards, one mesh device a shard (module
    docstring).  ``shards`` are ``ShardSearcher`` snapshots; ``devices``
    the mesh (``make_mesh`` over the first shard's device kind when
    None).  An explicit list may repeat a device: on the CPU it stands in
    for the reference's virtual devices, on one card for several."""

    def __init__(self, shards: list, devices: Optional[list] = None):
        self.shards = shards
        if devices is None:
            devices = make_mesh(len(shards),
                                shards[0].device if shards else None)
        self.devices = [_canonical(d) for d in devices]
        if len(self.devices) < len(self.shards):
            raise ValueError(f"mesh has {len(self.devices)} devices for "
                             f"{len(self.shards)} shards")
        # shard index -> (snapshot, the searcher serving it on its mesh
        # device): the snapshot itself where it serves there; ``shards``
        # and ``_on_mesh`` change under ``_lock``
        self._on_mesh: dict[int, tuple] = {}
        self._lock = threading.Lock()

    def update_shards(self, shards: list):
        """Swap in fresh shard snapshots (after a refresh): the searchers
        kept for shards whose snapshot changed are dropped.  The mesh's
        copies of segments on other devices live on their segments
        (``Segment.device``) and go with the segments no snapshot holds
        any more."""
        if len(shards) > len(self.devices):
            raise ValueError(f"mesh has {len(self.devices)} devices for "
                             f"{len(shards)} shards")
        with self._lock:
            self.shards = shards
            self._on_mesh = {i: v for i, v in self._on_mesh.items()
                             if i < len(shards) and v[0] is shards[i]}

    def _searchers(self, shards: Optional[list] = None) -> list:
        """The searchers that run one request's shard snapshots on their
        mesh devices: ``shards`` (the caller's, taken once) or else this
        mesh's, read once, so a request never mixes two snapshots
        whatever ``update_shards`` swaps meanwhile."""
        with self._lock:
            if shards is None:
                shards = self.shards
            if len(shards) > len(self.devices):
                raise ValueError(f"mesh has {len(self.devices)} devices "
                                 f"for {len(shards)} shards")
            return [self._searcher(i, s) for i, s in enumerate(shards)]

    def _searcher(self, i: int, shard):
        """The searcher that runs snapshot ``shard`` of shard ``i`` on
        mesh device ``i`` (under ``_lock``)."""
        kept = self._on_mesh.get(i)
        if kept is not None and kept[0] is shard:
            return kept[1]
        dev = self.devices[i]
        if _canonical(shard.device) == dev:
            searcher = shard
        else:
            from opensearch_tpu_torch.search.executor import ShardSearcher
            searcher = ShardSearcher(shard.segments, shard.mapper,
                                     index_name=shard.index_name,
                                     shard_id=shard.shard_id, device=dev)
        self._on_mesh[i] = (shard, searcher)
        return searcher

    def supports_mesh_aggs(self, aggs_json: dict) -> bool:
        """True when every agg is a single-level numeric metric over a
        long or double field: the family the on-device partial reduce
        covers."""
        if not self.shards:
            return False
        ctx = self.shards[0].ctx
        for body in (aggs_json or {}).values():
            if not isinstance(body, dict):
                return False
            types = [k for k in body if k not in ("aggs", "aggregations",
                                                  "meta")]
            if (len(types) != 1 or types[0] not in _MESH_METRICS
                    or body.get("aggs") or body.get("aggregations")
                    or not isinstance(body[types[0]], dict)):
                return False
            field = body[types[0]].get("field")
            if not field:
                return False
            ft = ctx.field_type(field)
            if ft is None or ft.dv_kind not in ("long", "double"):
                return False
        return True

    @staticmethod
    def _metric_partials(searcher, query, reqs) -> torch.Tensor:
        """One shard's float64 ``[aggs, 5]`` ``(sum, count, min, max,
        total)`` on its device: the query's matched masks, then one K5
        call (single mode, a job a (field, segment)); sums and totals
        added in segment order."""
        dev = searcher.device
        total = torch.zeros((), dtype=_F64, device=dev)
        inf = torch.full((), np.inf, dtype=_F64, device=dev)
        # (0, 0, inf, -inf), made on the device: no copy, no sync
        empty = torch.stack([total, total, inf, -inf])
        if not searcher.segments:
            return torch.cat([empty, total.view(1)]).repeat(len(reqs), 1)
        (plan, bind), ckey = searcher.compiled(query, scored=False,
                                               with_key=True)
        views = list(searcher._run_full(plan, bind, plan.arrays(), None,
                                        ckey=ckey))
        for _seg, _dseg, _scores, matched in views:
            total = total + matched.sum().to(_F64)
        jobs, spans = [], []
        for r in reqs:
            lo = len(jobs)
            for _seg, dseg, _scores, matched in views:
                col = dseg.numeric.get(r.params["field"])
                if col is not None:
                    jobs.append(agg_ops.CollectSegment(
                        matched, col["values"], col["value_docs"], 1))
            spans.append((lo, len(jobs)))
        if jobs:
            flat = agg_ops.bucket_collect(jobs, mode="single",
                                          self_metric=[True] * len(jobs))
            # per job [counts | sum, count, min, max], each over its
            # padded buckets; bucket 0 is the one
            words = flat.view(len(jobs), 5, jobs[0].n_buckets_pad)[:, 1:, 0]
            sums = words[:, 0].view(_F64)
            counts = words[:, 1].to(_F64)
            mins = words[:, 2].view(_F64)
            maxes = words[:, 3].view(_F64)
        rows = []
        for lo, hi in spans:
            if lo == hi:
                rows.append(torch.cat([empty, total.view(1)]))
                continue
            s = sums[lo]
            for j in range(lo + 1, hi):
                s = s + sums[j]
            rows.append(torch.stack([s, counts[lo:hi].sum(),
                                     mins[lo:hi].min(), maxes[lo:hi].max(),
                                     total]))
        return torch.stack(rows)

    def mesh_metric_aggs(self, body: dict, aggs_json: dict,
                         shards: Optional[list] = None) -> dict:
        """A ``size: 0`` metric-agg request on the mesh over ``shards``
        (this mesh's snapshots when None): every shard's partials on its
        device, one reduce on the first mesh device, and 5 numbers an agg
        read back."""
        from opensearch_tpu_torch.search.aggs import (_finish_metric,
                                                      parse_aggs)

        t0 = time.monotonic()
        reqs = parse_aggs(aggs_json)
        searchers = self._searchers(shards)
        S = len(searchers)
        parts = []
        with device_ledger().request():
            for i, searcher in enumerate(searchers):
                with _on(self.devices[i]):
                    parts.append(self._metric_partials(
                        searcher, body.get("query"), reqs))
            merged = sharded_metric_reduce(self.devices)(parts)
            t_sync = time.monotonic()
            host = merged.cpu().numpy()
            device_ledger().record_fetch(host.nbytes,
                                         time.monotonic() - t_sync)
        out_aggs = {}
        total_docs = 0
        for r, (s_, c_, mn_, mx_, tot) in zip(reqs, host):
            total_docs = int(tot)
            out_aggs[r.name] = _finish_metric(
                r.type, (float(s_), int(c_),
                         float(mn_) if c_ else np.inf,
                         float(mx_) if c_ else -np.inf))
        return {
            "took": int((time.monotonic() - t0) * 1000),
            "timed_out": False,
            "_shards": {"total": S, "successful": S, "skipped": 0,
                        "failed": 0},
            "hits": {"total": {"value": total_docs, "relation": "eq"},
                     "max_score": None, "hits": []},
            "aggregations": out_aggs,
        }

    def search(self, body: Optional[dict] = None,
               shards: Optional[list] = None) -> dict:
        """Scored top-k search over ``shards`` (this mesh's snapshots when
        None; sort and aggs stay on the host scatter)."""
        from opensearch_tpu_torch.search.fetch import filter_source

        body = body or {}
        t0 = time.monotonic()
        size = int(body.get("size", 10))
        from_ = int(body.get("from", 0))
        k = max(from_ + size, 1)
        searchers = self._searchers(shards)
        S = len(searchers)
        dev0 = self.devices[0]
        # phase 1: launch every shard's top-k on its device; nothing is
        # read back inside the loop
        blocks, owners = [], []
        with device_ledger().request():
            for i, searcher in enumerate(searchers):
                if not searcher.segments:
                    continue
                with _on(self.devices[i]):
                    (plan, bind), ckey = searcher.compiled(
                        body.get("query"), scored=True, with_key=True)
                    launched = searcher.topk_launch(
                        plan, bind, plan.arrays(), k, body.get("min_score"),
                        ckey=ckey)
                if launched is None:
                    continue
                out, order = launched
                blocks.append(out)
                owners.extend((i, g) for g in order)
            # phase 2: the lists meet on the first mesh device; one K10
            # launch merges them
            if blocks:
                fv, fi = sharded_topk_merge(self.devices, k)(
                    [o.vals for o in blocks])
                with _on(dev0):
                    picked = _gather([o.ids for o in blocks],
                                     dev0).reshape(-1)[fi]
                    total = torch.cat([o.totals.to(dev0) for o in blocks]
                                      ).sum(dtype=torch.int64)
                    packed = torch.cat([
                        fi, picked.to(torch.int64),
                        fv.view(torch.int32).to(torch.int64),
                        total.view(1)])
                # phase 3: the winners read back in one copy
                t_sync = time.monotonic()
                host = packed.cpu().numpy()
                device_ledger().record_fetch(host.nbytes,
                                             time.monotonic() - t_sync)
        hits = []
        total_hits = 0
        max_score = None
        if blocks:
            flat, local = host[:k], host[k: 2 * k]
            vals = host[2 * k: 3 * k].astype(np.int32).view(np.float32)
            total_hits = int(host[-1])
            if size > 0 or from_ > 0:
                source_spec = body.get("_source")
                for val, f, loc in zip(vals, flat, local):
                    if val == -np.inf:
                        break
                    si, g = owners[int(f) // k]
                    shard = searchers[si]
                    seg = shard.segments[g]
                    hit = {"_index": shard.index_name,
                           "_id": seg.doc_ids[int(loc)],
                           "_score": float(val), "_shard": shard.shard_id}
                    src = filter_source(seg.source(int(loc)), source_spec)
                    if src is not None:
                        hit["_source"] = src
                    hits.append(hit)
                if hits:
                    max_score = hits[0]["_score"]
                hits = hits[from_: from_ + size]
        return {
            "took": int((time.monotonic() - t0) * 1000),
            "timed_out": False,
            "_shards": {"total": S, "successful": S, "skipped": 0,
                        "failed": 0},
            "hits": {"total": {"value": total_hits, "relation": "eq"},
                     "max_score": max_score,
                     "hits": hits},
        }


def host_scatter(searchers: list, body: dict) -> dict:
    """The mesh's fallback (the reference's ``IndexService.
    _host_scatter_search``): the same scatter-gather with the merge on
    the host.  Every shard queries its own searcher (on its device,
    per-shard statistics as on the mesh) and the hits merge in the
    coordinator's tie-break order; aggregation partials and suggestions
    reduce as the coordinator's do."""
    from opensearch_tpu_torch.search.aggs import reduce_aggs
    from opensearch_tpu_torch.search.executor import merge_hit_rows
    from opensearch_tpu_torch.search.suggest import merge_suggest

    t0 = time.monotonic()
    size = int(body.get("size", 10) if body.get("size") is not None else 10)
    from_ = int(body.get("from", 0) or 0)
    aggs_json = body.get("aggs") or body.get("aggregations")
    sub = dict(body)
    sub["from"] = 0
    sub["size"] = from_ + size
    shard_resps = [s.search(sub, agg_partials=bool(aggs_json))
                   for s in searchers]
    rows = []
    total = 0
    max_score = None
    for si, r in enumerate(shard_resps):
        for pos, h in enumerate(r["hits"]["hits"]):
            rows.append((h, si, pos))
        total += r["hits"]["total"]["value"]
        ms_ = r["hits"]["max_score"]
        if ms_ is not None and (max_score is None or ms_ > max_score):
            max_score = ms_
    all_hits = merge_hit_rows(rows, body.get("sort"))
    resp = {
        "took": int((time.monotonic() - t0) * 1000),
        "timed_out": any(r.get("timed_out") for r in shard_resps),
        "hits": {"total": {"value": total, "relation": "eq"},
                 "max_score": max_score,
                 "hits": all_hits[from_: from_ + size]},
    }
    if aggs_json:
        resp["aggregations"] = reduce_aggs(
            aggs_json, [r.get("aggregation_partials") or {}
                        for r in shard_resps])
    if body.get("suggest"):
        resp["suggest"] = merge_suggest(
            [r.get("suggest") for r in shard_resps])
    return resp
