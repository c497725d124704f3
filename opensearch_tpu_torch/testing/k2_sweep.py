"""K2's top-k entry against the route it replaced, and its tile size, on
the card; and the route K2's dense (per-slot) entry replaced, one launch
per query-term slot (``slot_route_cuda``, ``slot_route_quantized_cuda``),
which ``chip_smoke.py`` times beside the one-launch entry in the same
call.

    python3 -m opensearch_tpu_torch.testing.k2_sweep

Builds the scale corpus of ``chip_smoke.py`` (1M docs in 16 segments of
62,500), takes the median and the heaviest bag of its ``match`` query
log (by postings in the first segment), and for each tile size in
``TILES`` (``csrc/bm25.cu`` rebuilt with that ``BM25_TILE_DOCS``;
ptxas' register and spill lines are printed) checks the fused top-k
launch against its plain twin, byte for byte, and times it at k = 10 and
100.  The route it replaced, the per-slot entry plus the masks and the
stable sort per segment, is timed at the same inputs.  Then the per-slot
(dense) entry, ``term_bag_cuda``, at each block width of ``FOLD_TILES``
(``csrc/bm25.cu`` rebuilt with that ``BM25_FOLD_TILE_DOCS``): checked
against its plain twin (scores; counts only) and timed on the median and
the heaviest bag over the 16 segments, one call per segment, beside the
route it replaced (``slot_route_cuda``: a memset and one launch per
slot).  Times are device milliseconds per query (per segment for the
per-slot entry) under ``torch.profiler`` (the sum of every device kernel
and copy of the call), each the lower of two readings taken in turns.
Prints one JSON line per reading and the card's name and power limit.
Needs CUDA; without it, exits non-zero.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from opensearch_tpu_torch.testing.k1_sweep import device_ms

TILES = (2048, 4096, 8192)
KS = (10, 100)
FOLD_TILES = (512, 1024, 2048, 4096)
_THREADS = 256
_MAX_GRID = 132 * 32


def _slot_grid(budget: int) -> int:
    """Blocks per launch of the replaced route: one thread per posting of
    the bag (capped; the grid-stride loop covers the rest)."""
    return max(1, min(_MAX_GRID, -(-int(budget) // _THREADS)))


def _slot_declare(lib):
    from opensearch_tpu_torch.ops import cuda_bm25

    cuda_bm25._declare(lib)
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.term_bag_slot_launch.argtypes = [p, p, p, p, p, p, p, i, i, p, p, p]
    lib.term_bag_slot_launch.restype = i
    lib.term_bag_quantized_slot_launch.argtypes = [
        p, p, p, i, p, i, p, p, p, p, p, p, p, i, i, p, p, p]
    lib.term_bag_quantized_slot_launch.restype = i


def _slot_library():
    """``csrc/bm25.cu`` built with the replaced route's entries
    (``BM25_SLOT_ROUTE``), which the search paths' library leaves out."""
    from opensearch_tpu_torch.ops import cuda_bm25, cuda_build

    return cuda_build.library("bm25", _slot_declare,
                              {**cuda_bm25.defines(), "BM25_SLOT_ROUTE": 1})


def slot_route_cuda(offsets, doc_ids, impacts, term_ids, term_active, idfs,
                    weights, *, n_pad: int, budget: int, scores: bool,
                    counts: bool):
    """The route ``cuda_bm25.term_bag_cuda`` replaced: zeroed dense
    columns, then one launch of ``term_bag_slot_kernel`` per slot.  Same
    arguments and result; ``slot_route_cuda.launches`` counts launches."""
    from opensearch_tpu_torch.ops import cuda_bm25, cuda_build

    dev = offsets.device
    out_s = torch.zeros(n_pad, dtype=torch.float32, device=dev) \
        if scores else None
    out_c = torch.zeros(n_pad, dtype=torch.int32, device=dev) \
        if counts else None
    t_pad = term_ids.shape[0]
    lib = _slot_library()
    p = cuda_bm25._ptr
    rc = lib.term_bag_slot_launch(
        p(offsets), p(doc_ids), p(impacts if scores else None),
        p(term_ids), p(term_active), p(idfs if scores else None),
        p(weights if scores else None), t_pad, _slot_grid(budget), p(out_s),
        p(out_c), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    cuda_build.check(lib, rc, "term_bag_slot_launch")
    cuda_build.count(slot_route_cuda, t_pad)
    return out_s, out_c


def slot_route_quantized_cuda(offsets, packed, base, qvals, scales,
                              exact_vals, exact_offsets, term_ids,
                              term_active, idfs, weights, *, width: int,
                              n_pad: int, budget: int, scores: bool,
                              counts: bool):
    """``slot_route_cuda`` over a quantized segment (the route
    ``cuda_bm25.term_bag_quantized_cuda`` replaced)."""
    from opensearch_tpu_torch.ops import cuda_bm25, cuda_build

    dev = offsets.device
    out_s = torch.zeros(n_pad, dtype=torch.float32, device=dev) \
        if scores else None
    out_c = torch.zeros(n_pad, dtype=torch.int32, device=dev) \
        if counts else None
    t_pad = term_ids.shape[0]
    lib = _slot_library()
    p = cuda_bm25._ptr
    rc = lib.term_bag_quantized_slot_launch(
        p(offsets), p(packed), p(base), int(width), p(qvals),
        cuda_bm25._q_bytes(qvals), p(scales), p(exact_vals),
        p(exact_offsets), p(term_ids), p(term_active),
        p(idfs if scores else None), p(weights if scores else None), t_pad,
        _slot_grid(budget), p(out_s), p(out_c),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    cuda_build.check(lib, rc, "term_bag_quantized_slot_launch")
    cuda_build.count(slot_route_quantized_cuda, t_pad)
    return out_s, out_c


slot_route_cuda.launches = 0
slot_route_quantized_cuda.launches = 0


def fold_sweep(searcher, bags) -> None:
    """The per-slot entry at each width of ``FOLD_TILES`` beside the
    route it replaced, on every segment of ``searcher`` (see the module
    doc)."""
    from opensearch_tpu_torch.ops import bm25, cuda_bm25, cuda_build

    calls = {}
    for name, terms in bags.items():
        plan, bind = searcher.compiled({"match": {"body": " ".join(terms)}})
        calls[name] = []
        for seg in searcher.segments:
            dseg = seg.device(searcher.device)
            (_t, budget, _f), (tids, act, idfs, w, imp, _r) = plan.prepare(
                bind, seg, dseg, searcher.ctx)
            p = dseg.postings["body"]
            calls[name].append(((p["offsets"], p["doc_ids"], imp, tids, act,
                                 idfs, w), dict(n_pad=dseg.n_pad,
                                                budget=budget)))
    n_seg = len(searcher.segments)
    default = cuda_bm25.FOLD_TILE_DOCS
    try:
        for tile in FOLD_TILES:
            cuda_bm25.FOLD_TILE_DOCS = tile
            logs = cuda_build.build(["bm25"], {"bm25": cuda_bm25.defines()})
            for line in logs.get("bm25", "").splitlines():
                if "fold" in line or ("registers" in line and "smem" in line
                                      and tile == FOLD_TILES[0]):
                    print(f"ptxas bm25 fold tile {tile}: {line.strip()}")
            for name in bags:
                for a, kw in calls[name]:
                    got = bm25.impact_score_count(*a, **kw, scored=True)
                    ref = bm25.impact_score_count_plain(*a, **kw,
                                                        scored=True)
                    cnt = cuda_bm25.term_bag_cuda(
                        *a, **kw, scores=False, counts=True)[1]
                    if not (torch.equal(got[0], ref[0])
                            and torch.equal(got[1], ref[1])
                            and torch.equal(cnt, ref[1])):
                        raise AssertionError(f"fold tile {tile} {name}: "
                                             "differs from the plain twin")
        for name, terms in bags.items():
            row = {"bag": terms, "per": "segment"}
            for _turn in range(2):
                for tile in FOLD_TILES:
                    cuda_bm25.FOLD_TILE_DOCS = tile
                    ms = device_ms(lambda: [bm25.impact_scores(*a, **kw)
                                            for a, kw in calls[name]])
                    key = f"fold_{tile}_ms"
                    row[key] = min(row.get(key, 1e9), ms / n_seg)
                ms = device_ms(lambda: [slot_route_cuda(
                    *a, **kw, scores=True, counts=False)
                    for a, kw in calls[name]])
                row["replaced_route_ms"] = min(
                    row.get("replaced_route_ms", 1e9), ms / n_seg)
            print(json.dumps(row), flush=True)
    finally:
        cuda_bm25.FOLD_TILE_DOCS = default


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_sweep: CUDA is not available", file=sys.stderr)
        return 1
    from opensearch_tpu_torch.ops import bm25, cuda_bm25, cuda_build
    from opensearch_tpu_torch.search.executor import build_arrays
    from opensearch_tpu_torch.testing import corpus
    from opensearch_tpu_torch.testing.profile_scale import build_searcher

    dev = torch.device("cuda")
    searcher = build_searcher(1_000_000, 16, dev)
    segs = searcher.segments
    pf0 = segs[0].postings["body"]

    def postings(terms):
        return sum(int(pf0.df[pf0.term_id(t)]) for t in terms
                   if pf0.term_id(t) >= 0)

    bags = sorted(({f"t{a}", f"t{b}"} for a, b in
                   corpus.zipf_query_log(200, seed=7)), key=postings)
    bags = {"median": sorted(bags[len(bags) // 2]),
            "heaviest": sorted(bags[-1])}

    def inputs_for(terms):
        plan, bind = searcher.compiled({"match": {"body": " ".join(terms)}})
        out = []
        for seg in segs:
            dseg = seg.device(dev)
            A = build_arrays(dseg, plan.arrays(), searcher.mapper,
                             live=searcher.ctx.live_mask(seg, dseg))
            out.append(plan.topk_input(bind, seg, dseg, A))
        return out

    inputs = {name: inputs_for(terms) for name, terms in bags.items()}

    def fused(name, k):
        return cuda_bm25.term_bag_topk_segments_cuda(inputs[name], k=k)

    def per_slot_route(name, k):
        return [bm25.segment_topk(seg, k, -np.inf, plain=False)
                for seg in inputs[name]]

    default = cuda_bm25.TILE_DOCS
    try:
        for tile in TILES:
            cuda_bm25.TILE_DOCS = tile
            logs = cuda_build.build(["bm25"], {"bm25": cuda_bm25.defines()})
            for line in logs.get("bm25", "").splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas bm25 tile {tile}: {line.strip()}")
            for name in bags:
                for k in KS:
                    got = fused(name, k).numpy()
                    ref = bm25.term_bag_topk_segments(inputs[name],
                                                      k=k).numpy()
                    if any(a.tobytes() != b.tobytes()
                           for a, b in zip(got, ref)):
                        raise AssertionError(f"tile {tile} {name} k={k}: "
                                             "differs from the plain twin")
        for name, terms in bags.items():
            for k in KS:
                row = {"bag": terms, "k": k,
                       "postings": int(sum(
                           int((s.rows[s.active, 1] - s.rows[s.active, 0])
                               .sum()) for s in inputs[name]))}
                for _turn in range(2):
                    for tile in TILES:
                        cuda_bm25.TILE_DOCS = tile
                        ms = device_ms(lambda: fused(name, k))
                        key = f"fused_{tile}_ms"
                        row[key] = min(row.get(key, ms), ms)
                    ms = device_ms(lambda: per_slot_route(name, k))
                    row["per_slot_route_ms"] = min(
                        row.get("per_slot_route_ms", ms), ms)
                print(json.dumps(row), flush=True)
    finally:
        cuda_bm25.TILE_DOCS = default
    fold_sweep(searcher, bags)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
