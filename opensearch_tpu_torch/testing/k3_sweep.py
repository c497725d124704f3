"""K3 on the card: one batched launch against one K2 launch per query,
and its tile size.

    python3 -m opensearch_tpu_torch.testing.k3_sweep

Builds the scale corpus of ``chip_smoke.py`` (1M docs in 16 segments of
62,500), takes the 256 ``match`` queries of ``zipf_query_log(256,
seed=7)`` in 4 batches of 64, and for each tile size in ``TILES``
(``csrc/bm25.cu`` rebuilt with that ``BM25_TILE_DOCS``; ptxas' register
and spill lines are printed) checks K3 (K2's top-k kernel over one
table entry per (query, segment)) against its plain twin, byte for
byte, on every batch at k = 10 and 100, then times each batch's launch
(its table built once, as msearch caches it).  Beside it, the same 64
queries as 64 launches of K2's sequential entry
(``term_bag_topk_segments_cuda``, each query's own table).  Times are
device milliseconds per batch under ``torch.profiler`` (every kernel
and copy of the calls), each the lower of two readings taken in turns.
Prints one JSON line per (batch, k) and the card's name and power
limit.  Needs CUDA; without it, exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from opensearch_tpu_torch.testing.k1_sweep import device_ms

TILES = (2048, 4096, 8192)
KS = (10, 100)
BATCH = 64


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_sweep: CUDA is not available", file=sys.stderr)
        return 1
    from opensearch_tpu_torch.ops import cuda_bm25, cuda_build
    from opensearch_tpu_torch.search import batch
    from opensearch_tpu_torch.search.executor import build_arrays
    from opensearch_tpu_torch.testing import corpus
    from opensearch_tpu_torch.testing.profile_scale import build_searcher

    dev = torch.device("cuda")
    searcher = build_searcher(1_000_000, 16, dev)
    bodies = [{"query": {"match": {"body": f"t{a} t{b}"}}, "size": 10}
              for a, b in corpus.zipf_query_log(256, seed=7)]

    def sequential_inputs(body):
        plan, bind = searcher.compiled(body["query"])
        out = []
        for seg in searcher.segments:
            dseg = seg.device(dev)
            A = build_arrays(dseg, plan.arrays(), searcher.mapper,
                             live=searcher.ctx.live_mask(seg, dseg))
            out.append(plan.topk_input(bind, seg, dseg, A))
        return out

    preps, singles = [], []
    for i in range(0, len(bodies), BATCH):
        groups, fallback = batch.plan_batches(searcher,
                                              bodies[i: i + BATCH])
        assert len(groups) == 1 and not fallback
        preps.append(groups[0]._prepare(searcher))
        singles.append([sequential_inputs(b) for b in bodies[i: i + BATCH]])

    def batched(prep, k):
        return cuda_bm25.batch_term_bag_topk_cuda(
            prep["segs"], prep["required"], n_queries=BATCH, k=k,
            need_counts=prep["need_counts"], table=prep["table"])

    def per_query(inputs, k):
        return [cuda_bm25.term_bag_topk_segments_cuda(segs, k=k)
                for segs in inputs]

    default = cuda_bm25.TILE_DOCS
    try:
        for tile in TILES:
            cuda_bm25.TILE_DOCS = tile
            logs = cuda_build.build(["bm25"], {"bm25": cuda_bm25.defines()})
            for line in logs.get("bm25", "").splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas bm25 tile {tile}: {line.strip()}")
            for prep in preps:
                # the table's tile count follows TILE_DOCS
                prep["table"] = cuda_bm25.pinned_batch_table(
                    prep["segs"], prep["required"], n_queries=BATCH,
                    need_counts=prep["need_counts"])
                for k in KS:
                    got = batched(prep, k).numpy()
                    ref = batch.batch_term_bag_topk_segments(
                        prep["segs"], prep["required"], n_queries=BATCH,
                        k=k, need_counts=prep["need_counts"]).numpy()
                    if any(a.tobytes() != b.tobytes()
                           for a, b in zip(got, ref)):
                        raise AssertionError(f"tile {tile} k={k}: differs "
                                             "from the plain twin")
        tables = {}
        for tile in TILES:
            cuda_bm25.TILE_DOCS = tile
            tables[tile] = [cuda_bm25.pinned_batch_table(
                p["segs"], p["required"], n_queries=BATCH,
                need_counts=p["need_counts"]) for p in preps]
        for b, prep in enumerate(preps):
            for k in KS:
                row = {"batch": b, "queries": BATCH, "k": k,
                       "union_terms_seg0": int(
                           prep["segs"][0].union_active.sum())}
                for _turn in range(2):
                    for tile in TILES:
                        cuda_bm25.TILE_DOCS = tile
                        prep["table"] = tables[tile][b]
                        ms = device_ms(lambda: batched(prep, k))
                        key = f"k3_{tile}_ms"
                        row[key] = min(row.get(key, ms), ms)
                    cuda_bm25.TILE_DOCS = default
                    ms = device_ms(lambda: per_query(singles[b], k), reps=3)
                    row["k2_per_query_ms"] = min(
                        row.get("k2_per_query_ms", ms), ms)
                print(json.dumps(row), flush=True)
    finally:
        cuda_bm25.TILE_DOCS = default
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
