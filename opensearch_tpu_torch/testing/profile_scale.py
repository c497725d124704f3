"""Where a query's time goes on the card: the scale corpus of
``chip_smoke.py`` (1M docs in 16 segments, ~22M postings, 128-d f32
vectors), a window of ``match`` and ``knn`` queries through
``ShardSearcher.search``, and of ``match`` queries through
``ShardSearcher.msearch`` in batches of 64, under ``torch.profiler``.

    python3 -m opensearch_tpu_torch.testing.profile_scale [n_queries]

``n_queries`` sizes the ``match`` and ``knn`` windows; the ``msearch``
window is 4 batches of 64 (their group inputs assembled in the window,
after one warm-up batch).  A last ``match_quantized`` window runs the
``match`` queries over the same 1M docs in 8 segments of 125,000, which
the port quantizes (K4, ``chip_smoke.py`` phase 7's layout).  Prints one JSON line per query kind: wall ms
per query (profiler on), device busy ms per query (the sum of the CUDA
kernels' and copies' own time; one stream, so they do not overlap), the
idle share ``1 - busy / wall``, the device calls (kernels and copies)
per query, the ``cudaLaunchKernel`` calls and the CUB radix-sort kernels
per query, the top device entries and the top host ops by self time.
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
    segs = corpus.make_segments(raw, n_segments, vectors=vecs)
    mapper = DocumentMapper({"properties": {
        "body": {"type": "text"},
        "vec": {"type": "knn_vector", "dimension": DIM,
                "space_type": "l2"}}})
    return ShardSearcher(segs, mapper, index_name="scale", device=device)


def query_bodies(n: int, seed: int = 9) -> dict:
    from opensearch_tpu_torch.testing import corpus

    rng = np.random.default_rng(44)
    return {
        "match": [{"query": {"match": {"body": f"t{a} t{b}"}}, "size": 10,
                   "_source": False}
                  for a, b in corpus.zipf_query_log(n, seed=seed)],
        "knn": [{"query": {"knn": {"vec": {
            "vector": rng.standard_normal(DIM).astype(np.float32).tolist(),
            "k": 10}}}, "size": 10, "_source": False} for _ in range(n)],
    }


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
        "top_device": [{"name": e.key[:80], "ms_per_query":
                        _device_self_us(e) / 1e3 / n,
                        "calls_per_query": e.count / n} for e in dev[:8]],
        "top_host": [{"name": e.key[:60], "self_ms_per_query":
                      e.self_cpu_time_total / 1e3 / n,
                      "calls_per_query": e.count / n} for e in host[:10]],
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("profile_scale: CUDA is not available", file=sys.stderr)
        return 1
    n = int(argv[0]) if argv else 30
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    searcher = build_searcher(1_000_000, 16, "cuda")
    bodies = query_bodies(n + 5)
    for kind, qs in bodies.items():
        for body in qs[:5]:                  # warm-up: staging, builds
            searcher.search(body)
        out = profile_window(searcher, qs[5:])
        print(json.dumps({"kind": kind, "gpu": gpu, **out}), flush=True)
    batch = 64
    qs = query_bodies(5 * batch, seed=10)["match"]
    searcher.msearch(qs[:batch])             # warm-up
    out = profile_window(searcher, qs[batch:], batch=batch)
    print(json.dumps({"kind": "msearch", "gpu": gpu, **out}), flush=True)
    del searcher
    searcher = build_searcher(1_000_000, 8, "cuda")
    qs = bodies["match"]
    for body in qs[:5]:
        searcher.search(body)
    out = profile_window(searcher, qs[5:])
    print(json.dumps({"kind": "match_quantized", "gpu": gpu, **out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
