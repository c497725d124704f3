"""K3 on the card: its sub-tile width and blocks per segment, where its
time goes, against the route it replaced and against one K2 launch per
query.

    python3 -m opensearch_tpu_torch.testing.k3_sweep

Builds the scale corpus of ``chip_smoke.py`` (1M docs in 16 segments of
62,500) and takes the 256 ``match`` queries of ``zipf_query_log(256,
seed=7)`` in 4 batches of 64, plus batches of 1 and 7 (the first queries
of the log).  Prints ptxas' register and spill lines of
``csrc/union_topk.cu``; then for each (widest D, blocks per segment) in
``CONFIGS`` checks K3 (``batch_term_bag_topk_cuda``) against its plain
twin, byte for byte, on every batch at k = 10 and 100, and times each
batch's launch (its table built once, as msearch caches it; the D the
wrapper took is printed beside it, and the host time of building the
table at the default sizes, as a continuous-batch group builds it on
every run), and the first configuration again without the posting
buffer (``raw_cap`` 0: every posting loaded when its sub-tile opens,
none copied while the previous one is scored).  Beside it,
in turns in the same call: the route K3 replaced, K2's top-k kernel
(``csrc/bm25.cu``) over one table entry per (query, segment)
(``batch_table`` below, kept here as the yardstick only: no path of the
port routes to it), and the same queries as one launch of K2's
sequential entry each.  Times are device milliseconds per batch under
``torch.profiler`` (every kernel and copy of the calls), each the lower
of two readings.  Prints one JSON line per (batch, k); then, from a
build with ``-DUNION_PHASES``, where a block's cycles go at the default
sizes on the batches of 1, 7 and the first of 64 (block start, zeroing
and the wait for the posting copy, scatter, scoring, selection,
posting, the last block's merge, each in SM cycles per block); and the
card's name and power limit.  Needs CUDA; without it, exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from opensearch_tpu_torch.ops import bm25, cuda_bm25
from opensearch_tpu_torch.testing.k1_sweep import device_ms, keep_lower

# (widest sub-tile D, blocks per (chunk, segment))
CONFIGS = ((4096, 8), (1024, 8), (256, 8), (4096, 16))
KS = (10, 100)
BATCH = 64


# -- the replaced route: K2's top-k entry over (query, segment) entries --

def batch_table(segments, required, *, n_queries: int,
                need_counts: bool) -> tuple[np.ndarray, int, int]:
    """``cuda_bm25.launch_table`` of a batch of ``n_queries`` scored bags
    over ``bm25.BatchSegment``s: one entry per (query, segment), segment
    after segment and query after query within one, entry (s, q) writing
    output row ``q * S + s``.  Its slots are the query's present terms in
    term order, each its union slot's posting range and idf and its own
    weight (a duplicate term is two slots naming one row); ``required``
    f32 [>= n_queries]; ``fast`` is ``not need_counts`` for every entry,
    the plain twin's match rule for the whole batch."""
    n_seg = len(segments)
    rows, idfs, weights, counts = [], [], [], []
    for seg in segments:
        act = seg.qact[:n_queries] > 0        # [Q, tq], term order per row
        slots = seg.qslots[:n_queries][act]
        rows.append(seg.union_rows[slots])
        idfs.append(seg.union_idfs[slots])
        weights.append(seg.qweights[:n_queries][act])
        counts.append(act.sum(axis=1))
    q = np.arange(n_queries, dtype=np.int64)
    return cuda_bm25.launch_table(
        [(seg.doc_ids.data_ptr(), seg.impacts.data_ptr(),
          seg.live.data_ptr()) for seg in segments for _ in q],
        np.repeat([seg.live.shape[0] for seg in segments], n_queries),
        np.concatenate(counts), np.concatenate(rows).reshape(-1, 2),
        np.concatenate(idfs), np.concatenate(weights),
        np.tile(np.asarray(required[:n_queries], np.float32)
                .astype(np.int64), n_seg),
        np.full(n_seg * n_queries, not need_counts),
        out_rows=(q[None, :] * n_seg
                  + np.arange(n_seg, dtype=np.int64)[:, None]).ravel())


def pinned_batch_table(segments, required, *, n_queries: int,
                       need_counts: bool) -> tuple[torch.Tensor, int, int]:
    """``batch_table`` in pinned host memory, with its block and slot
    counts."""
    table, n_blocks, n_slots = batch_table(
        segments, required, n_queries=n_queries, need_counts=need_counts)
    return torch.from_numpy(table).pin_memory(), n_blocks, n_slots


def old_route(segments, table, *, n_queries: int, k: int):
    """One launch of K2's top-k kernel over ``pinned_batch_table``'s
    entries: the batch's ``bm25.TermBagTopK``, as K3 lays it out."""
    host, n_blocks, n_slots = table
    n_entries = n_queries * len(segments)
    return cuda_bm25.topk_launch(host, n_entries, n_blocks, n_slots, k,
                                 -np.inf, bm25.empty_topk(
                                     n_entries, k, segments[0].live.device))


PHASES = ("start", "zero_wait", "scatter", "score", "select", "post",
          "merge_last")
WARP_PHASES = ("issue", "score", "select")


def phase_cycles(batch, k: int) -> dict:
    """SM cycles per block in each phase of one K3 launch at the default
    sizes, from ``union_topk.cu`` built with ``-DUNION_PHASES`` (thread 0
    of each block adds the cycles between its phase marks; the merge only
    in the last block of each (chunk, segment), divided over all
    blocks)."""
    import ctypes

    from opensearch_tpu_torch.ops import cuda_build

    def declare(lib):
        cuda_bm25._union_declare(lib)
        lib.union_topk_phases.argtypes = [ctypes.c_void_p]
        lib.union_topk_phases.restype = ctypes.c_int

    lib = cuda_build.library("union_topk", declare, {"UNION_PHASES": 1})
    p = batch["prep"]
    table = cuda_bm25.pinned_union_table(
        p["segs"], p["required"], n_queries=batch["n"], k=k,
        need_counts=p["need_counts"])
    out = (ctypes.c_ulonglong * (len(PHASES) + len(WARP_PHASES)))()
    default = cuda_bm25._union_library
    cuda_bm25._union_library = lambda: lib
    try:
        for _ in range(2):      # the second run's counts, from zero
            cuda_bm25.batch_term_bag_topk_cuda(
                p["segs"], p["required"], n_queries=batch["n"], k=k,
                need_counts=p["need_counts"], table=table)
            torch.cuda.synchronize()
            cuda_build.check(lib, lib.union_topk_phases(
                ctypes.cast(out, ctypes.c_void_p)), "union_topk_phases")
    finally:
        cuda_bm25._union_library = default
    # each segment's blocks, word 4 of its entry, once per chunk
    blocks = int(table.table.numpy()[4: 6 * table.n_seg: 6].sum()) \
        * table.n_chunks
    return {"batch": batch["name"], "k": k, "blocks": blocks,
            "docs": table.docs, "sub_tiles": table.sub_cap,
            "cycles_per_block": {n: int(out[i]) // blocks
                                 for i, n in enumerate(PHASES)},
            "cycles_per_warp": {n: int(out[len(PHASES) + i]) // blocks // 16
                                for i, n in enumerate(WARP_PHASES)}}


def table_host_ms(batch, k: int, reps: int = 20) -> float:
    """Host milliseconds of one ``pinned_union_table`` at the default
    sizes (the lowest of ``reps``)."""
    p = batch["prep"]
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        cuda_bm25.pinned_union_table(
            p["segs"], p["required"], n_queries=batch["n"], k=k,
            need_counts=p["need_counts"])
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_sweep: CUDA is not available", file=sys.stderr)
        return 1
    from opensearch_tpu_torch.ops import cuda_build
    from opensearch_tpu_torch.search import batch
    from opensearch_tpu_torch.search.executor import build_arrays
    from opensearch_tpu_torch.testing import corpus
    from opensearch_tpu_torch.testing.profile_scale import build_searcher

    dev = torch.device("cuda")
    logs = cuda_build.build(["union_topk", "bm25"],
                            {"bm25": cuda_bm25.defines()})
    for name, text in logs.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    searcher = build_searcher(1_000_000, 16, dev)
    pairs = corpus.zipf_query_log(256, seed=7)
    bodies = [{"query": {"match": {"body": f"t{a} t{b}"}}, "size": 10}
              for a, b in pairs]

    def sequential_inputs(body):
        plan, bind = searcher.compiled(body["query"])
        out = []
        for seg in searcher.segments:
            dseg = seg.device(dev)
            A = build_arrays(dseg, plan.arrays(), searcher.mapper,
                             live=searcher.ctx.live_mask(seg, dseg))
            out.append(plan.topk_input(bind, seg, dseg, A))
        return out

    spans = [(0, 1), (0, 7)] + [(i, BATCH) for i in range(0, 256, BATCH)]
    batches = []
    for at, n in spans:
        groups, fallback = batch.plan_batches(searcher, bodies[at: at + n])
        assert len(groups) == 1 and not fallback
        prep = groups[0]._prepare(searcher)
        batches.append({
            "name": f"{n}@{at}", "n": n, "prep": prep,
            "singles": [sequential_inputs(b) for b in bodies[at: at + n]],
            "old": pinned_batch_table(prep["segs"], prep["required"],
                                      n_queries=n,
                                      need_counts=prep["need_counts"])})

    def k3(b, k, table):
        p = b["prep"]
        return cuda_bm25.batch_term_bag_topk_cuda(
            p["segs"], p["required"], n_queries=b["n"], k=k,
            need_counts=p["need_counts"], table=table)

    default = (cuda_bm25.SUBTILE_DOCS, cuda_bm25.BLOCKS_PER_SEGMENT)
    try:
        for k in KS:
            built = {}
            for docs, blocks in CONFIGS:
                cuda_bm25.SUBTILE_DOCS, cuda_bm25.BLOCKS_PER_SEGMENT = \
                    docs, blocks
                built[(docs, blocks)] = [cuda_bm25.pinned_union_table(
                    b["prep"]["segs"], b["prep"]["required"],
                    n_queries=b["n"], k=k,
                    need_counts=b["prep"]["need_counts"]) for b in batches]
            for i, b in enumerate(batches):
                p = b["prep"]
                ref = batch.batch_term_bag_topk_segments(
                    p["segs"], p["required"], n_queries=b["n"], k=k,
                    need_counts=p["need_counts"]).numpy()
                no_copy = built[CONFIGS[0]][i]._replace(raw_cap=0)
                for cfg, table in [(c, built[c][i]) for c in CONFIGS] + [
                        ("no copy", no_copy)]:
                    got = k3(b, k, table).numpy()
                    if any(x.tobytes() != y.tobytes()
                           for x, y in zip(got, ref)):
                        raise AssertionError(f"K3 {cfg} batch {b['name']} "
                                             f"k={k}: differs from the "
                                             "plain twin")
                old = old_route(p["segs"], b["old"], n_queries=b["n"],
                                k=k).numpy()
                if any(x.tobytes() != y.tobytes() for x, y in zip(old, ref)):
                    raise AssertionError(f"old route batch {b['name']} "
                                         f"k={k}: differs")
                row = {"batch": b["name"], "queries": b["n"], "k": k,
                       "union_terms_seg0": int(
                           p["segs"][0].union_active.sum()),
                       "chunks": built[CONFIGS[0]][i].n_chunks,
                       "docs": {f"d{c[0]}_b{c[1]}": built[c][i].docs
                                for c in CONFIGS},
                       "union_table_host_ms": table_host_ms(b, k)}
                for _turn in range(2):
                    for cfg in CONFIGS:
                        keep_lower(row, f"k3_d{cfg[0]}_b{cfg[1]}_ms",
                                   device_ms(lambda: k3(b, k, built[cfg][i])))
                    # the default table without the posting buffer:
                    # every posting loaded directly, nothing copied ahead
                    no_copy = built[CONFIGS[0]][i]._replace(raw_cap=0)
                    keep_lower(row, "k3_no_copy_ms",
                               device_ms(lambda: k3(b, k, no_copy)))
                    keep_lower(row, "old_route_ms", device_ms(
                        lambda: old_route(p["segs"], b["old"],
                                          n_queries=b["n"], k=k)))
                    keep_lower(row, "k2_per_query_ms", device_ms(lambda: [
                        cuda_bm25.term_bag_topk_segments_cuda(segs, k=k)
                        for segs in b["singles"]], reps=3))
                print(json.dumps(row), flush=True)
    finally:
        cuda_bm25.SUBTILE_DOCS, cuda_bm25.BLOCKS_PER_SEGMENT = default
    for k in KS:
        for b in batches[:3]:
            print(json.dumps({"phases": phase_cycles(b, k)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
