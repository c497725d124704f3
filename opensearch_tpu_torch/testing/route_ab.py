"""Per-request latencies of the routes that evaluate one segment at a
time, and of phase 11's histogram kinds, for an A/B of two trees of the
port on one card.

    python3 opensearch_tpu_torch/testing/route_ab.py [--root DIR] [--label NAME] [--n N] [--device cpu --docs D --segments S]

``--root`` puts DIR's ``opensearch_tpu_torch`` first on the path, so
the same script times another checkout (a parent commit unpacked by
``git archive``); by default this file's own tree.  It builds
``profile_scale``'s scale corpus (1M docs in 16 segments on the card)
and times, ``N`` requests of each kind after 5 of warm-up, one after
another, each ending on the host's read of its answer:

- ``match_untracked`` / ``bool_untracked``: ``profile_scale``'s
  ``match`` and ``bool_filter`` bodies with ``track_total_hits: false``
  (one program per segment: the k-th-score pruning);
- ``bool``: the ``bool_filter`` bodies as they are (the request-wide
  route, for comparison);
- ``knn_filter``: a ``knn`` (k 10) under a ``term`` filter on ``tag``
  (the filter's mask made segment by segment);
- ``aggs_filter``: a ``filter`` aggregation on a ``tag`` term with a
  ``sum`` sub (the filter's mask made segment by segment);
- ``aggs_date_histogram`` / ``aggs_histogram``: ``chip_smoke.py`` phase
  11's ``date_histogram`` (half under a 21-day range) and ``histogram``
  (under a ``price`` range filter) bodies.

Then one segment's calls, ``--reps`` of each in a row: the plan's eval
of a ``match`` pair in filter context and scored (the dense entry over
one segment), and the top-k of one segment after it (the plan top-k of
one segment; a stable sort on a tree that has no plan top-k), as the
host's ms per call (launches only, one sync at the end) and as ms per
call with a sync after each.

Prints one JSON line per kind: qps, p50, mean, p90 and max ms, the
slowest request's position, and the Python garbage collector's pauses
(ms and collections) over the kind; and the card's name and power
limit.  Needs CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np


class GcClock:
    """The garbage collector's pause time and collections while on."""

    def __init__(self):
        self.ms, self.n, self._t = 0.0, 0, None

    def _cb(self, phase, _info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.ms += (time.perf_counter() - self._t) * 1e3
            self.n += 1
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


def bodies(n: int) -> dict:
    from opensearch_tpu_torch.testing import corpus, profile_scale

    q = profile_scale.query_bodies(n)
    aggs = profile_scale.agg_bodies(n)
    rng = np.random.default_rng(45)

    def tag():
        return corpus.tag_name(min(int(rng.zipf(1.3)) - 1, 19))

    def vec():
        return rng.standard_normal(profile_scale.DIM).astype(
            np.float32).tolist()

    hist = {"size": 0,
            "query": {"bool": {"filter": [{"range": {"price": {
                "gte": 0, "lt": 5000}}}]}},
            "aggs": {"by_price": {"histogram": {"field": "price",
                                                "interval": 500},
                                  "aggs": {"fare": {"stats": {
                                      "field": "fare"}}}}}}
    return {
        "match_untracked": [{**b, "track_total_hits": False}
                            for b in q["match"]],
        "bool_untracked": [{**b, "track_total_hits": False}
                           for b in q["bool_filter"]],
        "bool": q["bool_filter"],
        "knn_filter": [{"query": {"knn": {"vec": {
            "vector": vec(), "k": 10, "filter": {"term": {"tag": tag()}}}}},
            "size": 10, "_source": False} for _ in range(n)],
        "aggs_filter": [{"size": 0, "aggs": {"f": {
            "filter": {"term": {"tag": tag()}},
            "aggs": {"s": {"sum": {"field": "fare"}}}}}} for _ in range(n)],
        "aggs_date_histogram": aggs["aggs_date_histogram"],
        "aggs_histogram": [hist] * n,
    }


def request_kind(searcher, qs: list) -> dict:
    for body in qs[:5]:                      # warm-up: staging, builds
        searcher.search(dict(body))
    lat = []
    with GcClock() as clock:
        t0 = time.perf_counter()
        for body in qs[5:]:
            t = time.perf_counter()
            searcher.search(dict(body))
            lat.append((time.perf_counter() - t) * 1e3)
        wall = time.perf_counter() - t0
    lat = np.asarray(lat)
    return {"requests": len(lat), "qps": len(lat) / wall,
            "p50_ms": float(np.median(lat)), "mean_ms": float(lat.mean()),
            "p90_ms": float(np.percentile(lat, 90)),
            "max_ms": float(lat.max()), "slowest": int(lat.argmax()),
            "gc_ms": clock.ms, "gc_collections": clock.n}


def segment_calls(searcher, reps: int, sync) -> dict:
    """One segment's dense eval (filter context and scored) and its top-k,
    ms per call."""
    import torch

    from opensearch_tpu_torch.ops import bm25
    from opensearch_tpu_torch.search import plan as P
    from opensearch_tpu_torch.search.executor import build_arrays

    seg = searcher.segments[0]
    dseg = seg.device(searcher.device)
    out = {}
    for name, scored in (("filter", False), ("scored", True)):
        plan, bind = searcher.compiled({"match": {"body": "t0 t10576"}},
                                       scored=scored)
        dims, ins = plan.prepare(bind, seg, dseg, searcher.ctx)

        def arrays():
            return build_arrays(dseg, plan.arrays(), searcher.mapper,
                                live=searcher.ctx.live_mask(seg, dseg),
                                partial_ok=plan.skip_arrays(dims))

        As = [arrays() for _ in range(reps)]     # fresh: no pre-pass views
        plan.eval(arrays(), dims, ins)
        sync()
        t = time.perf_counter()
        for A in As:
            plan.eval(A, dims, ins)
        sync()
        out[f"dense_{name}_ms"] = (time.perf_counter() - t) / reps * 1e3
        t = time.perf_counter()
        for A in [arrays() for _ in range(reps)]:
            plan.eval(A, dims, ins)
            sync()
        out[f"dense_{name}_synced_ms"] = (time.perf_counter() - t) / reps * 1e3
    scores, matched = plan.eval(arrays(), dims, ins)
    live = searcher.ctx.live_mask(seg, dseg)
    if hasattr(bm25, "plan_topk_segments_auto"):
        def topk():
            return bm25.plan_topk_segments_auto(
                [bm25.PlanScores(scores, matched, live)], k=10)

        def read(r):
            return r.numpy()
        out["topk_route"] = "plan top-k"
    else:
        def topk():
            return P.topk_from_scores(scores, 10, matched & live)

        def read(r):
            return [x.cpu() for x in r]
        out["topk_route"] = "stable sort"
    topk()
    sync()
    t = time.perf_counter()
    for _ in range(reps):
        topk()
    sync()
    out["topk_ms"] = (time.perf_counter() - t) / reps * 1e3
    t = time.perf_counter()
    for _ in range(reps):
        read(topk())
    out["topk_read_ms"] = (time.perf_counter() - t) / reps * 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--label", default="")
    ap.add_argument("--n", type=int, default=60)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--segments", type=int, default=16)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("route_ab: CUDA is not available", file=sys.stderr)
        return 1
    from opensearch_tpu_torch.testing import profile_scale

    gpu = "cpu"
    if args.device == "cuda":
        gpu = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    label = args.label or os.path.basename(os.path.abspath(args.root))
    t0 = time.perf_counter()
    searcher = profile_scale.build_searcher(args.docs, args.segments,
                                            args.device)
    built = time.perf_counter() - t0
    for kind, qs in bodies(args.n + 5).items():
        print(json.dumps({"tree": label, "kind": kind, "gpu": gpu,
                          **request_kind(searcher, qs)}), flush=True)
    print(json.dumps({"tree": label, "kind": "one_segment", "gpu": gpu,
                      "segment_docs": searcher.segments[0].n_docs,
                      **segment_calls(searcher, args.reps, sync),
                      "build_s": built}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
