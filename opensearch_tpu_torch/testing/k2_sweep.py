"""K2's top-k entry against the route it replaced, and its tile size, on
the card; and K2's dense (per-slot) entry against the per-segment kernel
it replaced, at each block width.

    python3 -m opensearch_tpu_torch.testing.k2_sweep

Builds the scale corpus of ``chip_smoke.py`` (1M docs in 16 segments of
62,500), takes the median and the heaviest bag of its ``match`` query
log (by postings in the first segment), and for each tile size in
``TILES`` (``csrc/bm25.cu`` rebuilt with that ``BM25_TILE_DOCS``;
ptxas' register and spill lines are printed) checks the fused top-k
launch against its plain twin, byte for byte, and times it at k = 10 and
100.  The route it replaced, the dense entry plus the masks and the
stable sort per segment, is timed at the same inputs.  Then the dense
(per-slot) entry, ``term_bag_dense_cuda`` (one launch over a table of the
16 segments), at each block width of ``FOLD_TILES`` (``csrc/bm25.cu``
rebuilt with that ``BM25_FOLD_TILE_DOCS``): checked against its plain
twin byte for byte (scores; scores and counts; counts only) and timed on
the median and the heaviest bag, beside the per-segment kernel it
replaced (``term_bag_fold_kernel``, one launch per segment, built only
into this sweep's library with ``-DBM25_OLD_FOLD``: ``old_fold_library``,
``OldFold``; kept as the yardstick only), checked against the
same twin.  Times are device milliseconds per query under
``torch.profiler`` (the sum of every device kernel and copy of the
call; for the dense entry per request and bag over the 16 segments, the
kernel's own time: its one launch, or 16 of the replaced kernel's), each
the lower of two readings taken in turns.
Prints one JSON line per reading and the card's name and power limit.
Needs CUDA; without it, exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from opensearch_tpu_torch.testing.k1_sweep import device_ms, keep_lower

TILES = (2048, 4096, 8192)
KS = (10, 100)
FOLD_TILES = (512, 1024, 2048, 4096)


def dense_bags(searcher, terms, scored: bool = True) -> list:
    """The ``DenseBag`` of a ``match`` of ``terms`` on every segment of
    ``searcher``, as the executor's pre-pass lays it out (``scored``
    False: the bag in filter context)."""
    from opensearch_tpu_torch.search.executor import build_arrays

    plan, bind = searcher.compiled({"match": {"body": " ".join(terms)}},
                                   scored=scored)
    bags = []
    for seg in searcher.segments:
        dseg = seg.device(searcher.device)
        dims, ins = plan.prepare(bind, seg, dseg, searcher.ctx)
        A = build_arrays(dseg, plan.arrays(), searcher.mapper,
                         live=searcher.ctx.live_mask(seg, dseg),
                         partial_ok=plan.skip_arrays(dims))
        bags.append(plan.dense_bag(A, dims, ins))
    return bags


def old_fold_library():
    """``csrc/bm25.cu`` built with ``-DBM25_OLD_FOLD``: the replaced
    per-segment kernel's entries ``term_bag_launch`` and
    ``term_bag_quantized_launch`` beside the product's."""
    import ctypes

    from opensearch_tpu_torch.ops import cuda_bm25, cuda_build

    def declare(lib):
        cuda_bm25._declare(lib)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.term_bag_launch.argtypes = [p, p, p, p, p, p, p, i, i, p, p, p]
        lib.term_bag_launch.restype = i
        lib.term_bag_quantized_launch.argtypes = [
            p, p, p, i, p, i, p, p, p, p, p, p, p, i, i, p, p, p]
        lib.term_bag_quantized_launch.restype = i

    return cuda_build.library("bm25", declare,
                              {**cuda_bm25.defines(), "BM25_OLD_FOLD": 1})


class OldFold:
    """The replaced route over ``bags`` (``DenseBag``s on the card): one
    launch of ``term_bag_fold_kernel`` per segment, its slots read from
    per-call device arrays of term ids, active flags, idfs and weights
    (made here, once) and the staged CSR offsets; each call allocates its
    segment's columns, as the replaced wrapper did."""

    def __init__(self, bags, scores: bool, counts: bool):
        import ctypes

        self.lib = old_fold_library()
        self.scores, self.counts = scores, counts
        dev = bags[0].offsets.device
        self.stream = ctypes.c_void_p(
            torch.cuda.current_stream(dev).cuda_stream)
        self.calls = []
        for b in bags:
            slots = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                          for a in (b.term_ids, b.active, b.idfs, b.weights))
            self.calls.append((b, slots))

    def __call__(self) -> list:
        import ctypes

        from opensearch_tpu_torch.ops import cuda_build

        def ptr(t):
            return ctypes.c_void_p(0 if t is None else t.data_ptr())

        out = []
        for b, (tids, act, idfs, w) in self.calls:
            dev = b.offsets.device
            s = torch.empty(b.n_pad, dtype=torch.float32, device=dev) \
                if self.scores else None
            c = torch.empty(b.n_pad, dtype=torch.int32, device=dev) \
                if self.counts else None
            sc = self.scores
            if b.quant is None:
                rc = self.lib.term_bag_launch(
                    ptr(b.offsets), ptr(b.doc_ids),
                    ptr(b.impacts if sc else None), ptr(tids), ptr(act),
                    ptr(idfs if sc else None), ptr(w if sc else None),
                    len(b.term_ids), b.n_pad, ptr(s), ptr(c), self.stream)
            else:
                q = b.quant
                rc = self.lib.term_bag_quantized_launch(
                    ptr(b.offsets), ptr(q.packed), ptr(q.base), q.width,
                    ptr(q.qvals), q.qvals.element_size(), ptr(q.scales),
                    ptr(q.exact_vals), ptr(q.exact_offsets), ptr(tids),
                    ptr(act), ptr(idfs if sc else None),
                    ptr(w if sc else None), len(b.term_ids), b.n_pad,
                    ptr(s), ptr(c), self.stream)
            cuda_build.check(self.lib, rc, "term_bag_launch")
            out.append((s, c))
        return out


def same(got, want) -> bool:
    """Every ``(scores | None, counts | None)`` pair byte-equal."""
    return all((g is None) == (w is None)
               and (g is None or torch.equal(g, w))
               for gp, wp in zip(got, want) for g, w in zip(gp, wp))


MODES = ((True, False), (True, True), (False, True))


def launch_ms(fn, name: str, reps: int = 20):
    """Mean device milliseconds per launch of the kernels whose name holds
    ``name`` over ``reps`` calls of ``fn`` under ``torch.profiler`` (a
    window that drops some events still gives the mean of those it
    kept); None when it shows none."""
    from torch.profiler import ProfilerActivity, profile

    from opensearch_tpu_torch.testing.profile_scale import (_device_self_us,
                                                            _is_device)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if _is_device(e) and name in e.key]
    count = sum(e.count for e in hits)
    return sum(_device_self_us(e) for e in hits) / 1e3 / count \
        if count else None


def dense_sweep(searcher, bags) -> None:
    """The dense entry at each width of ``FOLD_TILES`` over every segment
    of ``searcher``, beside the replaced per-segment kernel (see the
    module doc)."""
    from opensearch_tpu_torch.ops import bm25, cuda_bm25, cuda_build

    inputs = {name: {scored: dense_bags(searcher, terms, scored)
                     for scored in (True, False)}
              for name, terms in bags.items()}

    def bag_of(name, sc):
        return inputs[name][sc]

    old = {(name, sc, cn): OldFold(bag_of(name, sc), sc, cn)
           for name in bags for sc, cn in MODES}
    for key, route in old.items():
        if not same(route(), bm25.term_bag_dense(
                bag_of(key[0], key[1]), scores=key[1], counts=key[2])):
            raise AssertionError(f"replaced dense route {key}: differs "
                                 "from the plain twin")
    default = cuda_bm25.FOLD_TILE_DOCS
    try:
        for tile in FOLD_TILES:
            cuda_bm25.FOLD_TILE_DOCS = tile
            logs = cuda_build.build(["bm25"], {"bm25": cuda_bm25.defines()})
            for line in logs.get("bm25", "").splitlines():
                if "dense" in line or ("registers" in line and "smem" in
                                       line and tile == FOLD_TILES[0]):
                    print(f"ptxas bm25 dense tile {tile}: {line.strip()}")
            for name in bags:
                for sc, cn in MODES:
                    got = cuda_bm25.term_bag_dense_cuda(
                        bag_of(name, sc), scores=sc, counts=cn)
                    if not same(got, bm25.term_bag_dense(
                            bag_of(name, sc), scores=sc, counts=cn)):
                        raise AssertionError(f"dense tile {tile} {name} "
                                             f"{sc, cn}: differs from the "
                                             "plain twin")
        for name, terms in bags.items():
            n_seg = len(bag_of(name, True))
            row = {"bag": terms, "per": f"request of {n_seg} segments, "
                   "scores"}
            for _turn in range(2):
                ms = launch_ms(old[(name, True, False)],
                               "term_bag_fold_kernel")
                keep_lower(row, "replaced_per_segment_ms",
                           ms and ms * n_seg)
                for tile in FOLD_TILES:
                    cuda_bm25.FOLD_TILE_DOCS = tile
                    keep_lower(row, f"dense_{tile}_ms", launch_ms(
                        lambda: cuda_bm25.term_bag_dense_cuda(
                            bag_of(name, True), scores=True, counts=False),
                        "term_bag_dense_kernel"))
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
        segs_in = inputs[name]
        cols = cuda_bm25.term_bag_dense_cuda(
            [bm25.dense_bag(s) for s in segs_in], scores=True,
            counts=not segs_in[0].fast)
        return [bm25.segment_topk(seg, k, -np.inf, cols=c)
                for seg, c in zip(segs_in, cols)]

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
                        keep_lower(row, f"fused_{tile}_ms",
                                   device_ms(lambda: fused(name, k)))
                    keep_lower(row, "per_slot_route_ms",
                               device_ms(lambda: per_slot_route(name, k)))
                print(json.dumps(row), flush=True)
    finally:
        cuda_bm25.TILE_DOCS = default
    dense_sweep(searcher, bags)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
