"""Where a query's time goes on the card: the scale corpus of
``chip_smoke.py`` (1M docs in 16 segments, ~22M postings, 128-d f32
vectors), a window of ``match`` and ``knn`` queries through
``ShardSearcher.search``, and of ``match`` queries through
``ShardSearcher.msearch`` in batches of 64, under ``torch.profiler``.

    python3 -m opensearch_tpu_torch.testing.profile_scale [n_queries] [--aggs | --script | --ann]

``n_queries`` sizes the ``match`` and ``knn`` windows; the ``msearch``
window is 4 batches of 64 (their group inputs assembled in the window,
after one warm-up batch).  Then ``bool_filter`` (the ``match`` pair
filtered by a ``price`` range over ~40% of the docs and a ``tag`` term,
``chip_smoke.py`` phase 10's ``bool``) and ``hybrid`` ([the ``match``
pair, a ``knn``] through a min_max / arithmetic_mean pipeline) and
``script_score`` (the k-NN plugin's ``knn_score`` script, l2, over
``match_all``: ``chip_smoke.py`` phase 12's main kind; a new vector each,
so each request compiles and makes its K1 scores launch; alone with
``--script``) windows.
A last ``match_quantized`` window runs the ``match`` queries over the
same 1M docs in 8 segments of 125,000, which the port quantizes (K4,
``chip_smoke.py`` phase 7's layout), and a ``bool_filter_quantized``
one the ``bool_filter`` queries there.  The ``aggs_*`` windows (after
the f32 kinds; alone with ``--aggs``) are ``chip_smoke.py`` phase 11's
kinds on the f32 layout: ``aggs_date_histogram`` (a day
``date_histogram`` on ``ts`` with a ``stats`` sub on ``fare``, half
under a 21-day ``range``), ``aggs_terms_hits`` (the ``match`` pair,
``size`` 10, ``terms`` on ``tag`` with ``avg`` / ``max`` subs) and
``aggs_metrics`` (``match_all`` with 6 metric aggs on each of ``price``
and ``fare``).  ``--ann`` profiles only ``chip_smoke.py`` phase 13's
ANN ``knn`` kinds on its corpus (``testing/ann.py``: GloVe-100's shape,
1,183,514 x 100 in 16 segments): ``ann_cos`` (config 3's cosine
``ivf_pq`` field, default nprobe: K6) and ``ann_l2_pq`` (the same field
in l2: K7), k = 10, each on held-out queries after ``ANN_WARM``
warm-ups (the first trains the segments' indexes; the searcher keeps
each distinct body's prepared columns, and the first ~64 of them grow
the device pool).  Prints one JSON line per query
kind: wall ms
per query (profiler on), device busy ms per query (the sum of the CUDA
kernels' and copies' own time; one stream, so they do not overlap), the
idle share ``1 - busy / wall``, the device calls (kernels and copies)
per query, the ``cudaLaunchKernel`` calls, the CUB radix-sort kernels,
K1's scores kernels, K2's dense-entry kernels, the plan top-k's and K6 /
K7's probe and scan kernels (and their device ms) per query, the top device entries and the top host ops
by self time.
Needs CUDA; without it, exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

DIM = 128


def _device_self_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _is_device(evt) -> bool:
    return getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA


def build_searcher(n_docs: int, n_segments: int, device):
    from opensearch_tpu_torch.mapping.mapper import DocumentMapper
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus

    raw = corpus.build_raw_corpus(n_docs, seed=42)
    vecs = corpus.random_vectors(n_docs, DIM, seed=43)
    segs = corpus.make_segments(raw, n_segments, vectors=vecs,
                                columns=corpus.doc_value_columns(n_docs,
                                                                 seed=11))
    mapper = DocumentMapper({"properties": {
        "body": {"type": "text"},
        "vec": {"type": "knn_vector", "dimension": DIM,
                "space_type": "l2"}, **corpus.COLUMNS_MAPPING}})
    return ShardSearcher(segs, mapper, index_name="scale", device=device)


def query_bodies(n: int, seed: int = 9) -> dict:
    from opensearch_tpu_torch.testing import corpus

    rng = np.random.default_rng(44)
    pairs = corpus.zipf_query_log(n, seed=seed)
    width = int(corpus.PRICE_MAX * 0.4)

    def vec():
        return rng.standard_normal(DIM).astype(np.float32).tolist()

    def bool_filter(a, b):
        lo = int(rng.integers(0, corpus.PRICE_MAX - width))
        tag = corpus.tag_name(min(int(rng.zipf(1.3)) - 1, 19))
        return {"query": {"bool": {
            "must": [{"match": {"body": f"t{a} t{b}"}}],
            "filter": [{"range": {"price": {"gte": lo, "lt": lo + width}}},
                       {"term": {"tag": tag}}]}},
            "size": 10, "_source": False}

    return {
        "match": [{"query": {"match": {"body": f"t{a} t{b}"}}, "size": 10,
                   "_source": False} for a, b in pairs],
        "knn": [{"query": {"knn": {"vec": {"vector": vec(), "k": 10}}},
                 "size": 10, "_source": False} for _ in range(n)],
        "bool_filter": [bool_filter(a, b) for a, b in pairs],
        "hybrid": [{"query": {"hybrid": {"queries": [
            {"match": {"body": f"t{a} t{b}"}},
            {"knn": {"vec": {"vector": vec(), "k": 10}}}]}},
            "size": 10, "_source": False, "_hybrid_pipeline": {
                "combination": {"technique": "arithmetic_mean",
                                "parameters": {"weights": [0.3, 0.7]}}}}
            for a, b in pairs],
        "script_score": script_bodies(n, rng),
    }


def script_bodies(n: int, rng) -> list:
    """``n`` ``script_score`` bodies with the ``knn_score`` script (l2)
    over ``match_all``, each with a new vector."""
    return [{"query": {"script_score": {
        "query": {"match_all": {}},
        "script": {"lang": "knn", "source": "knn_score", "params": {
            "field": "vec", "space_type": "l2",
            "query_value": rng.standard_normal(DIM).astype(
                np.float32).tolist()}}}}, "size": 10, "_source": False}
        for _ in range(n)]


DAY_MS = 86_400_000
ANN_WARM = 70           # --ann: warm-up bodies of a window (module doc)
# (name, a substring of the kernel's name) counted per query
KERNELS = (("dense", "term_bag_dense_kernel"),
           ("plan_topk", "plan_topk_kernel"),
           ("ivf_probe", "ivf_probe_kernel"),
           ("ivf_scan", "ivf_scan_kernel"),
           ("ivfpq_scan", "ivfpq_scan_kernel"))


def agg_bodies(n: int, seed: int = 81) -> dict:
    """``chip_smoke.py`` phase 11's aggregation kinds, ``n`` of each."""
    from opensearch_tpu_torch.testing import corpus

    rng = np.random.default_rng(seed)
    per_day = {"per_day": {"date_histogram": {
        "field": "ts", "calendar_interval": "day"},
        "aggs": {"fare": {"stats": {"field": "fare"}}}}}
    dh = []
    for i in range(n):
        body = {"size": 0, "aggs": per_day}
        if i % 2 == 0:
            lo = corpus.TS_START_MS + int(rng.integers(0, 344)) * DAY_MS
            body["query"] = {"range": {"ts": {"gte": lo,
                                              "lt": lo + 21 * DAY_MS}}}
        dh.append(body)
    metrics = {f"{m}_{f}": {m: {"field": f}} for f in ("price", "fare")
               for m in ("min", "max", "avg", "sum", "value_count",
                         "stats")}
    return {
        "aggs_date_histogram": dh,
        "aggs_terms_hits": [
            {"query": {"match": {"body": f"t{a} t{b}"}}, "size": 10,
             "_source": False,
             "aggs": {"tags": {"terms": {"field": "tag", "size": 10},
                               "aggs": {"avg_fare": {"avg": {
                                   "field": "fare"}},
                                   "max_price": {"max": {
                                       "field": "price"}}}}}}
            for a, b in corpus.zipf_query_log(n, seed=7)],
        "aggs_metrics": [{"size": 0, "query": {"match_all": {}},
                          "aggs": metrics} for _ in range(n)]}


def profile_window(searcher, bodies: list, batch: int = 0) -> dict:
    """One profiled window over ``bodies``, searched one by one, or with
    ``batch`` > 0 through ``msearch`` in batches of that many: per-query
    wall and device busy time, idle share, top device entries and top
    host ops."""
    from torch.profiler import ProfilerActivity, profile

    n = len(bodies)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        if batch:
            for i in range(0, n, batch):
                searcher.msearch(bodies[i: i + batch])
        else:
            for body in bodies:
                searcher.search(body)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    events = prof.key_averages()
    dev = sorted((e for e in events if _is_device(e)),
                 key=_device_self_us, reverse=True)
    busy_ms = sum(_device_self_us(e) for e in dev) / 1e3
    host = sorted((e for e in events if not _is_device(e)),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    return {
        "queries": n,
        "queries_per_call": batch or 1,
        "wall_ms_per_query": wall_ms / n,
        "device_busy_ms_per_query": (busy_ms / n) if dev else None,
        "idle_share": (1.0 - busy_ms / wall_ms) if dev else None,
        "device_calls_per_query": sum(e.count for e in dev) / n,
        "launch_kernel_calls_per_query": sum(
            e.count for e in host if e.key == "cudaLaunchKernel") / n,
        "radix_sort_calls_per_query": sum(
            e.count for e in dev if "RadixSort" in e.key) / n,
        "k1_scores_kernels_per_query": sum(
            e.count for e in dev if "knn_scores_kernel" in e.key) / n,
        "k1_scores_device_ms_per_query": sum(
            _device_self_us(e) for e in dev
            if "knn_scores_kernel" in e.key) / 1e3 / n,
        **{f"{name}_kernels_per_query": sum(
            e.count for e in dev if kernel in e.key) / n
           for name, kernel in KERNELS},
        **{f"{name}_device_ms_per_query": sum(
            _device_self_us(e) for e in dev if kernel in e.key) / 1e3 / n
           for name, kernel in KERNELS},
        "k5_kernels_per_query": sum(
            e.count for e in dev if "agg_" in e.key) / n,
        "k5_device_ms_per_query": sum(
            _device_self_us(e) for e in dev if "agg_" in e.key) / 1e3 / n,
        "top_device": [{"name": e.key[:80], "ms_per_query":
                        _device_self_us(e) / 1e3 / n,
                        "calls_per_query": e.count / n} for e in dev[:8]],
        "top_host": [{"name": e.key[:60], "self_ms_per_query":
                      e.self_cpu_time_total / 1e3 / n,
                      "calls_per_query": e.count / n} for e in host[:10]],
    }


def profile_ann(n: int, gpu: str) -> None:
    """The ``--ann`` windows (module doc)."""
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import ann

    w = n + ANN_WARM
    segs, held = ann.corpus_segments(n_queries=2 * w)
    for i, (kind, space) in enumerate((("ann_cos", "cosinesimil"),
                                       ("ann_l2_pq", "l2"))):
        searcher = ShardSearcher(segs, ann.mapper(space, True),
                                 index_name="glove", device="cuda")
        qs = [ann.body(q) for q in held[i * w: (i + 1) * w]]
        for body in qs[:ANN_WARM]:           # warm-up: training, staging
            searcher.search(body)
        out = profile_window(searcher, qs[ANN_WARM:])
        print(json.dumps({"kind": kind, "gpu": gpu, **out}), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("profile_scale: CUDA is not available", file=sys.stderr)
        return 1
    only_aggs = "--aggs" in argv
    only_script = "--script" in argv
    only_ann = "--ann" in argv
    argv = [a for a in argv if a not in ("--aggs", "--script", "--ann")]
    n = int(argv[0]) if argv else 30
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if only_ann:
        profile_ann(n, gpu)
        return 0
    searcher = build_searcher(1_000_000, 16, "cuda")
    if only_script:
        bodies = {"script_score": script_bodies(
            n + 5, np.random.default_rng(44))}
    else:
        bodies = {} if only_aggs else query_bodies(n + 5)
        bodies.update(agg_bodies(n + 5))
    for kind, qs in bodies.items():
        for body in qs[:5]:                  # warm-up: staging, builds
            searcher.search(body)
        out = profile_window(searcher, qs[5:])
        print(json.dumps({"kind": kind, "gpu": gpu, **out}), flush=True)
    if only_aggs or only_script:
        return 0
    batch = 64
    qs = query_bodies(5 * batch, seed=10)["match"]
    searcher.msearch(qs[:batch])             # warm-up
    out = profile_window(searcher, qs[batch:], batch=batch)
    print(json.dumps({"kind": "msearch", "gpu": gpu, **out}), flush=True)
    del searcher
    searcher = build_searcher(1_000_000, 8, "cuda")
    for kind in ("match", "bool_filter"):
        qs = bodies[kind]
        for body in qs[:5]:
            searcher.search(body)
        out = profile_window(searcher, qs[5:])
        print(json.dumps({"kind": f"{kind}_quantized", "gpu": gpu, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
