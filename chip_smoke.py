"""Drive the PyTorch/CUDA port (``opensearch_tpu_torch``) on one NVIDIA
GPU and check it: the quickest proof that the port starts on the card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. toolkit: torch / CUDA / nvcc versions, the device, its power limit;
   the hand-written kernels are built from ``opensearch_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together);
2. kernels vs their plain PyTorch twins on the card, timed:
   K1's top-k entry ``knn_topk_segments_cuda`` (one launch over many
   segments: 1 segment of 1M, the 16 scale segments, ragged n = 7,
   1,000, 65,536 and 1M in one call and a segment of duplicated rows;
   k in 1, 10, 100, K_MAX, K_MAX + 1; three spaces; with and without a
   filter mask; and widths d = 3, 30, 960 beside the main path's 128;
   the fused launch and the sorted route each taken where
   ``uses_sorted_route`` says, in one call where they mix)
   against ``knn_topk_segments``, K1's scores-only entry
   ``knn_scores`` (three spaces; 1M x 128, the per-segment shape, a
   ragged n), both within the stated tolerance; K2's per-slot entry
   (the term-bag scorer) on three real query bags, byte for byte; and
   K2's top-k entry ``term_bag_topk_segments_cuda`` (one launch over the
   16 scale segments) against ``term_bag_topk_segments``, byte for byte,
   on the median bag, the heaviest bag, a 4-term bag, an ``and`` bag, a
   ``min_score`` bag and segments with deletes, k in 1, 10, 100, K_MAX,
   K_MAX + 1 (the per-slot entry plus the stable sort); and K3
   ``batch_term_bag_topk_cuda`` (``csrc/union_topk.cu``, one launch per
   batch of queries over the 16 scale segments: persistent blocks per
   (query chunk, segment) stage each union posting once in shared memory
   and score every query of the chunk from there) against
   ``batch_term_bag_topk_segments``, byte for byte, on batches of 1, 7
   and 64 zipf OR bags (with and without the presence counts), 64
   ``and`` bags, 64 OR bags over segments with deletes, 64 bags with a
   duplicate term (OR and ``and``), 64 bags with negative weights and 256
   bags of 3-4 terms (several query chunks at K_MAX), k in 1, 10, 100,
   K_MAX, and timed at k = 10 and 100 beside the route it replaced (K2's
   top-k kernel over one table entry per (query, segment),
   ``testing/k3_sweep.py``); and K4, the quantized row layout, on 8
   segments of 125,000 docs that the port quantizes (the same corpus):
   its top-k entry ``term_bag_topk_quantized_cuda`` (its own kernel,
   ``csrc/quant_topk.cu``: each block stages its tile's run of every row
   in shared memory with bulk asynchronous copies and decodes the ids
   there) against ``term_bag_topk_segments``, byte for byte, on the
   median, heaviest, 4-term, ``and``, ``min_score``, deletes, unguarded
   and code-dominated bags and a term some segments lack (blocks with no
   slot), k in 1, 10, 100, K_MAX, K_MAX + 1, int8 and
   int16 codes, bags with and without guarded (exact) terms, and on 4
   segments of 5,000 docs quantized under ``QUANTIZED_MODE = "on"``
   (13-bit deltas against the scale shard's 17); its per-slot entry (the
   quantized instantiation of K2's per-slot kernel) on three bags (and
   timed at the median bag on one 125,000-doc segment); a mixed call
   over 2 quantized and 2 f32 segments; and K4 against K2 over the same
   segments' ``dequantized()`` column staged as f32, byte for byte;
3. ingest path: ~2,000 JSON docs through the port's DocumentMapper and
   SegmentWriter into 2 segments with deletes, then match / bool / knn
   (three spaces, filtered, and one k above K1's in-kernel maximum)
   searches and counts through ``ShardSearcher`` on the card, held to
   the same searcher on the CPU (the plain versions): BM25 byte for
   byte, k-NN within tolerance;
4. scale: 1,000,000 docs in 16 segments (62,500 docs each, under the
   reference's quantization threshold) with ~22M postings and a 128-d
   float32 vector per doc; 200 zipf ``match`` and 100 ``knn`` queries
   through ``ShardSearcher.search`` (qps, p50, kernel launches per
   query: one K2 top-k launch per ``match`` query and no per-slot one,
   one K1 launch per ``knn`` query), a sample checked against the CPU
   searcher;
5. msearch: the 256 queries of ``zipf_query_log(256, seed=7)`` through
   ``ShardSearcher.msearch`` in 4 batches of 64 (one K3 launch and no K2
   launch per batch, every response equal to sequential ``search``,
   batched qps at least 0.8 x sequential qps);
6. continuous batching: the same queries from 16 client threads through
   ``query_engine().execute(..., service=shim)`` with a 4 ms window
   (fewer than one dispatch per query, every response equal to
   sequential ``search``; qps, p50 and p99), then once more with the
   batcher off (each thread's searches one after another) for its qps,
   p50 and p99;
7. quantized scale: the same 1,000,000 docs in 8 segments of 125,000
   (every one at or above ``QUANTIZED_MIN_DOCS``, so quantized as the
   reference quantizes them; the time the quantization takes is
   logged); the 200 zipf ``match`` queries of phase 4 through
   ``ShardSearcher.search`` (qps, p50, launches per query: one K4 top-k
   launch and no per-slot one per ``match``), a ``bool`` /
   ``constant_score`` / ``count`` sample (K4's per-slot entry, K2's on
   the demand-staged f32 columns for filters), a sample byte-equal to
   the CPU searcher, and the resident bytes against the f32 layout of
   the same segments;
8. write path: 160,000 docs of the same corpus shape as text
   (``testing/corpus.render_texts``) indexed through the port's
   ``InternalEngine(..., device="cuda")`` (a ``body`` text field and a
   ``tag`` keyword) in bulks of 1,000 with one ``ensure_synced()`` each
   (the reference's ``request`` durability), ~1% updates and ~0.5%
   deletes, one stale ``if_seq_no`` write refused before each of the 10
   refreshes (one every 16,000 docs); after each refresh 20 zipf
   ``match`` queries and a ``bool`` with a ``term`` filter byte-equal
   to the CPU searcher over the same segments; every updated and
   deleted id and a 2,000-id sample read back by realtime ``get``;
   ``count`` equal to the acked live docs; the 200 ``match`` queries
   on the 10 f32 segments (one K2 top-k launch each) and one
   ``msearch`` batch of 64 (one K3 launch); ``force_merge(2)`` into two
   quantized segments, after which the device holds no byte of the
   merged-away ones; the 200 queries again (one K4 top-k launch each);
   ``flush``, ``close`` and a reopen whose first ``match`` builds and
   writes the ``.quant`` sidecars, and a second reopen whose first
   ``match`` quantizes nothing; then 1,000 more docs, the engine
   dropped without ``close`` and reopened: the translog replay brings
   them back (gets, counts and searches equal to the CPU searcher) and
   moves the avgdl under the quantized segments.  One ``write path:``
   line prints the rates and times;
9. serving node: ``opensearch_tpu_torch.node.Node(..., device="cuda")``
   driven over HTTP only: ``GET /`` and ``/_cluster/health``; an index
   ``corpus`` of 2 shards (phase 8's mapping) fed 20,000 rendered docs
   by 20 ``_bulk`` requests of 1,000 items with ~1% ``update`` and ~0.5%
   ``delete`` items and one refused ``create`` of an existing id (one
   translog sync per item), a ``_refresh`` every 5,000 docs; a sample
   of acked ids read back by ``GET _doc``; ``_count`` equal to the acked
   live docs; the 200 ``match`` queries as ``_search`` requests one at a
   time (one K2 top-k launch over both shards' segments and no other
   each, equal to the CPU searcher; qps, p50, p99, and beside them the
   p50 of the same bodies through ``IndexService.search`` and through
   the REST controller in process, and of a keep-alive ``GET /``); one
   ``_msearch`` of 64 (one K3 launch, equal to sequential); the 256
   queries from 16 client threads, in this process and then in a child
   process (the continuous batcher behind the real ``IndexService``:
   fewer than one dispatch per query, equal to sequential); an index
   ``vectors`` of 5,000 128-d vectors by ``_bulk`` and 50 ``knn``
   searches (one K1 launch each, within
   tolerance of the CPU); a multi-index ``match_all``; ``aggs`` answering
   501 and a missing index 404; ``_forcemerge``, ``_flush``, ``DELETE
   /vectors`` (the device bytes it held released); then a restart on the
   same data path (the index reloaded, ``vectors`` gone, ``_count`` and
   20 responses unchanged, the acked docs read back).  One ``serving:``
   line prints the rates and times.

Every kernel wrapper counts its launches; the counts are zeroed just
before phase 3 and read after phase 4, and zeroed again just before
phases 5, 6, 7, 8 and 9 and read after each: each kernel of each path
must have run.
The line before the last is one JSON object with each kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  Without CUDA the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
SCALE_DOCS = 1_000_000
BIG_N = 1_000_000                # the single large segment of phase 2
SCALE_SEGMENTS = 16
QUANT_SEGMENTS = 8               # phase 7: 8 x 125,000 docs, all quantized
DIM = 128
DEVICE = "cuda"


def log(*a):
    print(*a, flush=True)


def gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per ``fn()`` on the card: CUDA events around
    ``reps`` calls after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(kernel, plain, reps: int) -> tuple:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain in one
    call; each is the lower of its two readings."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return min(k1, k2), min(p1, p2)


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_device_ms(fn, reps: int, name: str):
    """Mean device milliseconds per launch of the kernels whose name
    holds ``name``, over ``reps`` calls of ``fn`` under
    ``torch.profiler``; None when the profiler shows no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from opensearch_tpu_torch.testing.profile_scale import (_device_self_us,
                                                            _is_device)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if _is_device(e) and name in e.key]
    count = sum(e.count for e in hits)
    return sum(_device_self_us(e) for e in hits) / 1e3 / count \
        if count else None


# -- phase 1 ----------------------------------------------------------------

def phase_toolkit():
    import torch

    from opensearch_tpu_torch.ops import cuda_bm25, cuda_build, cuda_knn

    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"toolkit: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc "
        f"[{nvcc.stdout.strip().splitlines()[-1]}]")
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()}")
    log(f"gpu: {gpu_name_power()}")
    t0 = time.monotonic()
    logs = cuda_build.build(["knn", "bm25", "union_topk", "quant_topk"],
                            {"knn": cuda_knn.defines(),
                             "bm25": cuda_bm25.defines(),
                             "quant_topk": cuda_bm25.quant_defines()})
    log(f"kernels built in {time.monotonic() - t0:.1f}s: "
        f"{sorted(logs) or 'cached'}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or \
                    "entry function" in line:
                log(f"  ptxas {name}: {line.strip()}")


# -- phase 2 ----------------------------------------------------------------

def phase_knn_topk(scale_segs, dev, gen):
    """K1's top-k entry against its plain twin at every shape, k, space
    and mask the contract lists, then timed over the 16 scale segments
    in one launch (k = 10, l2) beside the plain twin, the library chain
    ``[torch.topk(v @ q, k) for each segment]`` and the bound."""
    import torch

    from opensearch_tpu_torch.ops import cuda_knn, knn
    from opensearch_tpu_torch.testing.parity import topk_mismatch

    def rand_segment(n, dup=False, d=DIM):
        v = torch.randn(n, d, device=dev, generator=gen)
        if dup:      # 64 distinct rows, each repeated: ties everywhere
            v = v[:64][torch.randint(0, 64, (n,), device=dev,
                                     generator=gen)].contiguous()
        flags = [torch.rand(n, device=dev, generator=gen) > p
                 for p in (0.05, 0.05, 0.5)]
        return v, *flags

    scale = []
    for seg in scale_segs:
        dseg = seg.device(dev)
        vcol = dseg.vector["vec"]
        scale.append((vcol["values"], vcol["exists"], dseg.live,
                      torch.rand(dseg.n_pad, device=dev,
                                 generator=gen) > 0.5))
    big = rand_segment(BIG_N)
    sets = {f"n={BIG_N}": [big], "scale16": scale,
            f"ragged 7/1000/65536/{BIG_N}": [rand_segment(n) for n in
                                             (7, 1000, 65_536)] + [big],
            "duplicated rows": [rand_segment(65_536, dup=True)]}
    q = torch.randn(DIM, device=dev, generator=gen)
    ks = (1, 10, 100, cuda_knn.K_MAX, cuda_knn.K_MAX + 1)
    max_err = 0.0
    for name, raw in sets.items():
        for filtered in (False, True):
            segs = [knn.KnnSegment(v, e, lv, m if filtered else None)
                    for v, e, lv, m in raw]
            for space in knn.SPACES:
                for k in ks:
                    fn = cuda_knn.knn_topk_segments_cuda
                    before = fn.launches, fn.sorted_route_segments
                    got = fn(segs, q, space=space, k=k)
                    ref = knn.knn_topk_segments(segs, q, space=space, k=k)
                    routes = [cuda_knn.uses_sorted_route(k, s.vectors.shape[0])
                              for s in segs]
                    if (fn.launches - before[0], fn.sorted_route_segments
                            - before[1]) != (int(not all(routes)),
                                             sum(routes)):
                        raise AssertionError(
                            f"K1 top-k {name} k={k}: routes {routes} gave "
                            f"{fn.launches - before[0]} fused launches and "
                            f"{fn.sorted_route_segments - before[1]} "
                            f"sorted segments")
                    bad, err = topk_mismatch(
                        *(t.cpu().numpy() for t in got + ref))
                    if bad is None and name == "duplicated rows" and \
                            got[1].cpu().numpy().tobytes() != \
                            ref[1].cpu().numpy().tobytes():
                        bad = "ids are not byte-equal"
                    if bad:
                        raise AssertionError(
                            f"K1 top-k {name} filtered={filtered} {space} "
                            f"k={k}: {bad}")
                    max_err = max(max_err, err)
            ties = "; ids byte-equal" if name.startswith("dup") else ""
            sorted_k = [k for k in ks if any(
                cuda_knn.uses_sorted_route(k, s.vectors.shape[0])
                for s in segs)]
            log(f"K1 top-k {name} filtered={filtered}: 3 spaces x k "
                f"{list(ks)} agree with the plain twin (rtol=1e-5, "
                f"atol=1e-6{ties}); sorted route taken by some segment at "
                f"k {sorted_k}")
    del sets
    # other widths: scalar loads and 4-byte copies (d % 4 != 0), one lane
    # per row (d = 3), a whole warp per row (d = 960)
    for d in (3, 30, 960):
        segs = [knn.KnnSegment(*rand_segment(n, d=d))
                for n in (5000, 70_000)]
        qd = torch.randn(d, device=dev, generator=gen)
        for space in knn.SPACES:
            for k in (10, cuda_knn.K_MAX):
                bad, err = topk_mismatch(*(t.cpu().numpy() for t in (
                    cuda_knn.knn_topk_segments_cuda(segs, qd, space=space,
                                                    k=k)
                    + knn.knn_topk_segments(segs, qd, space=space, k=k))))
                if bad:
                    raise AssertionError(f"K1 top-k d={d} {space} k={k}: "
                                         f"{bad}")
                max_err = max(max_err, err)
        log(f"K1 top-k d={d} (filtered, n = 5000 and 70,000): 3 spaces x k "
            f"[10, {cuda_knn.K_MAX}] agree with the plain twin")

    segs = [knn.KnnSegment(v, e, lv) for v, e, lv, _m in scale]
    k = 10
    ms, plain_ms = in_turns(
        lambda: cuda_knn.knn_topk_segments_cuda(segs, q, space="l2", k=k),
        lambda: knn.knn_topk_segments(segs, q, space="l2", k=k), 20)
    lib_ms = cuda_ms(lambda: [torch.topk(s.vectors @ q, k) for s in segs],
                     20)
    dev_ms = kernel_device_ms(
        lambda: cuda_knn.knn_topk_segments_cuda(segs, q, space="l2", k=k),
        20, "knn_topk_kernel")
    rows = sum(s.vectors.shape[0] for s in segs)
    nbytes = rows * (DIM * 4 + 2) + DIM * 4 + len(segs) * k * 8
    bms, by = bound_ms(nbytes, 4.0 * rows * DIM)
    log(f"K1 top-k l2 k={k} over {len(segs)} segments of "
        f"{segs[0].vectors.shape[0]}x{DIM}, one launch per query: ms {ms:.4f} "
        f"device_ms {dev_ms} plain_ms {plain_ms:.4f} library_ms"
        f"(topk(v @ q) chain) {lib_ms:.4f} bound_ms {bms:.4f} ({by}: "
        f"{nbytes} bytes) on "
        f"{gpu_name_power()}")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
            "bound_bytes": nbytes, "max_abs_err": max_err,
            "shape": f"{len(segs)}x{segs[0].vectors.shape[0]}x{DIM}, k={k}"}


def match_query(terms, **extra) -> dict:
    """A ``match`` query over ``body`` for the bag ``terms``."""
    return {"match": {"body": {"query": " ".join(terms), **extra}}}


def df_sum(pf, terms) -> int:
    """Postings of ``terms`` in one segment's ``body`` field."""
    return sum(int(pf.df[pf.term_id(t)]) for t in terms
               if pf.term_id(t) >= 0)


def topk_inputs(segs, searcher, query) -> list:
    """Each segment's ``TermBagSegment`` of a scored bag, as the
    searcher's one top-k call builds them."""
    from opensearch_tpu_torch.search.executor import build_arrays

    plan, bind = searcher.compiled(query)
    out = []
    for seg in segs:
        dseg = seg.device(searcher.device)
        A = build_arrays(dseg, plan.arrays(), searcher.mapper,
                         live=searcher.ctx.live_mask(seg, dseg),
                         partial_ok=plan.arrays())
        out.append(plan.topk_input(bind, seg, dseg, A))
    return out


def phase_kernels(scale_segs, searcher, query_pairs):
    """K1 and K2 against their plain twins on the card, and timed at the
    shapes the main path gives them."""
    import torch

    from opensearch_tpu_torch.ops import bm25, cuda_knn, knn

    dev = torch.device(DEVICE)
    out = {}
    gen = torch.Generator(device=dev).manual_seed(1234)
    k1_err = 0.0
    for n in (BIG_N, 65_536, 1000):
        v = torch.randn(n, DIM, device=dev, generator=gen)
        valid = torch.rand(n, device=dev, generator=gen) > 0.05
        q = torch.randn(DIM, device=dev, generator=gen)
        for space in knn.SPACES:
            a = cuda_knn.knn_scores_cuda(v, valid, q, space=space)
            b = cuda_knn.knn_scores_plain(v, valid, q, space=space)
            torch.cuda.synchronize()
            if not torch.equal(torch.isneginf(a), ~valid) or \
                    not torch.equal(torch.isneginf(b), ~valid):
                raise AssertionError(f"K1 {space} n={n}: -inf rows differ")
            ok = valid
            err = (a[ok] - b[ok]).abs()
            tol = knn.ATOL + knn.RTOL * b[ok].abs()
            if not bool((err <= tol).all()):
                raise AssertionError(
                    f"K1 {space} n={n}: max err {err.max().item()} "
                    "beyond rtol=1e-5, atol=1e-6")
            k1_err = max(k1_err, err.max().item())
            log(f"K1 {space:12s} n={n:8d} d={DIM}: max_abs_err "
                f"{err.max().item():.3e} (rtol=1e-5, atol=1e-6) ok")
        if n == BIG_N:
            ms, plain_ms = in_turns(
                lambda: cuda_knn.knn_scores_cuda(v, valid, q, space="l2"),
                lambda: cuda_knn.knn_scores_plain(v, valid, q, space="l2"),
                20)
            lib_ms = cuda_ms(lambda: v @ q, 20)
            bms, by = bound_ms(n * DIM * 4 + n + DIM * 4 + n * 4,
                               4.0 * n * DIM)
            log(f"K1 l2 1Mx128: ms {ms:.4f} plain_ms {plain_ms:.4f} "
                f"library_ms(vectors @ q) {lib_ms:.4f} bound_ms {bms:.4f} "
                f"({by}) on {gpu_name_power()}")
            out["k1_1m"] = {"ms": ms, "plain_ms": plain_ms,
                            "library_ms": lib_ms, "bound_ms": bms}
        del v, valid, q

    # K1's scores-only entry at the per-segment shape: every scale
    # segment's [n_pad, 128] vectors in turn (32 MiB each, so L2 does
    # not hold them across the sixteen), against one query
    cols = []
    for seg in scale_segs:
        dseg = seg.device(dev)
        vcol = dseg.vector["vec"]
        cols.append((vcol["values"], vcol["exists"] & dseg.live))
    q = torch.from_numpy(np.random.default_rng(5).standard_normal(
        DIM, dtype=np.float32)).to(dev)
    nseg = len(cols)
    ms, plain_ms = in_turns(
        lambda: [cuda_knn.knn_scores_cuda(v, m, q, space="l2")
                 for v, m in cols],
        lambda: [cuda_knn.knn_scores_plain(v, m, q, space="l2")
                 for v, m in cols], 10)
    lib_ms = cuda_ms(lambda: [v @ q for v, _m in cols], 10)
    dev_ms = kernel_device_ms(
        lambda: [cuda_knn.knn_scores_cuda(v, m, q, space="l2")
                 for v, m in cols], 5, "knn_scores_kernel")
    n_pad = cols[0][0].shape[0]
    bms, by = bound_ms(n_pad * DIM * 4 + n_pad + DIM * 4 + n_pad * 4,
                       4.0 * n_pad * DIM)
    out["knn_scores"] = {
        "ms": ms / nseg, "plain_ms": plain_ms / nseg,
        "library_ms": lib_ms / nseg, "bound_ms": bms, "bound_by": by,
        "device_ms": dev_ms, "max_abs_err": k1_err,
        "shape": f"{n_pad}x{DIM}"}
    log(f"K1 scores l2 {n_pad}x{DIM} per segment: ms {ms / nseg:.4f} "
        f"device_ms {dev_ms} plain_ms {plain_ms / nseg:.4f} library_ms "
        f"{lib_ms / nseg:.4f} bound_ms {bms:.4f} ({by})")
    del cols

    out["knn_topk"] = phase_knn_topk(scale_segs, dev, gen)

    # K2 on real query bags of the scale corpus: byte for byte against
    # the plain twin, in both modes (scores only; scores + counts)
    seg0 = scale_segs[0]
    d0 = seg0.device(dev)
    pf0 = seg0.postings["body"]
    bags = []
    for a, b in query_pairs:
        bags.append([f"t{a}", f"t{b}"] if a != b else [f"t{a}"])

    def bag_inputs(seg, terms):
        plan, bind = searcher.compiled(
            {"match": {"body": {"query": " ".join(terms)}}})
        dseg = seg.device(dev)
        dims, ins = plan.prepare(bind, seg, dseg, searcher.ctx)
        return plan, bind, dseg, dims, ins

    by_size = sorted(bags, key=lambda t: df_sum(pf0, t))
    median_bag = by_size[len(by_size) // 2]
    checks = [median_bag, by_size[-1],
              by_size[len(by_size) // 4] + by_size[-2]]   # a 4-term bag
    for terms in checks:
        _plan, _bind, dseg, dims, ins = bag_inputs(seg0, terms)
        t_pad, budget, _fast = dims
        tids, active, idfs, weights, impacts, _req = ins
        p = dseg.postings["body"]
        args = (p["offsets"], p["doc_ids"], impacts, tids, active, idfs,
                weights)
        s1, c1 = bm25.impact_score_count(*args, n_pad=dseg.n_pad,
                                         budget=budget, scored=True)
        s2, c2 = bm25.impact_score_count_plain(*args, n_pad=dseg.n_pad,
                                               budget=budget, scored=True)
        s3 = bm25.impact_scores(*args, n_pad=dseg.n_pad, budget=budget)
        s4 = bm25.impact_scores_plain(*args, n_pad=dseg.n_pad,
                                      budget=budget)
        torch.cuda.synchronize()
        if not (torch.equal(s1, s2) and torch.equal(c1, c2)
                and torch.equal(s3, s4) and torch.equal(s1, s3)):
            raise AssertionError(f"K2 differs from its plain twin on {terms}")
        log(f"K2 bag {terms} ({df_sum(pf0, terms)} postings): scores and "
            f"counts byte-equal to the plain twin")

    # K2 timed on the median bag, in every segment in turn (the main
    # path's calls: OR bag, scores only)
    calls = []
    nbytes = 0
    for seg in scale_segs:
        plan, bind, dseg, dims, ins = bag_inputs(seg, median_bag)
        t_pad, budget, _fast = dims
        tids, active, idfs, weights, impacts, _req = ins
        p = dseg.postings["body"]
        pf = seg.postings["body"]
        rows = []
        for i, t in enumerate(median_bag):
            tid = pf.term_id(t)
            if tid >= 0:
                rows.append((int(pf.offsets[tid]), int(pf.offsets[tid + 1]),
                             float(bind["idfs"][i]),
                             float(bind["weights"][i])))
        nbytes += sum(8 * (e - s) for s, e, _i, _w in rows) + 4 * dseg.n_pad
        calls.append(((p["offsets"], p["doc_ids"], impacts, tids, active,
                       idfs, weights), dseg.n_pad, budget, rows))

    def lib_chain():
        for (_o, docs, imp, *_r), n_pad, _b, rows in calls:
            acc = torch.zeros(n_pad, dtype=torch.float32, device=dev)
            for s, e, idf_v, w in rows:
                acc.index_add_(0, docs[s:e], imp[s:e] * idf_v, alpha=w)

    ms, plain_ms = in_turns(
        lambda: [bm25.impact_scores(*a, n_pad=n, budget=b)
                 for a, n, b, _r in calls],
        lambda: [bm25.impact_scores_plain(*a, n_pad=n, budget=b)
                 for a, n, b, _r in calls], 20)
    lib_ms = cuda_ms(lib_chain, 20)
    nseg = len(calls)
    bms, by = bound_ms(nbytes / nseg, 3.0 * (nbytes / nseg) / 8)
    out["term_bag_scores"] = {
        "ms": ms / nseg, "plain_ms": plain_ms / nseg,
        "library_ms": lib_ms / nseg, "bound_ms": bms, "bound_by": by,
        "max_abs_err": 0.0, "bag": median_bag}
    log(f"K2 median bag {median_bag} per segment: ms {ms / nseg:.4f} "
        f"plain_ms {plain_ms / nseg:.4f} library_ms(index_add_ chain) "
        f"{lib_ms / nseg:.4f} bound_ms {bms:.5f} ({by})")

    out["term_bag_topk"] = phase_term_bag_topk(
        scale_segs, searcher, dev, gen, median_bag, by_size[-1],
        checks[2])
    out["batch_topk"] = phase_batch_topk(searcher, dev, gen, query_pairs)
    return out


def phase_term_bag_topk(scale_segs, searcher, dev, gen, median_bag,
                        heaviest_bag, four_bag):
    """K2's top-k entry against its plain twin over the 16 scale
    segments, byte for byte, at every bag, mask and k the contract lists;
    then timed (one launch per query) on the median and the heaviest bag
    beside the plain twin, the library chain ``[torch.topk(zeros(n_pad)
    .index_add_(...), k) for each segment]`` and the bound."""
    import torch

    from opensearch_tpu_torch.ops import bm25, cuda_bm25

    def inputs_for(query):
        return topk_inputs(scale_segs, searcher, query)

    median = inputs_for(match_query(median_bag))
    deleted = [seg._replace(live=seg.live & (torch.rand(
        seg.live.shape[0], device=dev, generator=gen) > 0.1))
        for seg in median]
    cases = {"median": (median, -np.inf),
             "heaviest": (inputs_for(match_query(heaviest_bag)), -np.inf),
             "4-term": (inputs_for(match_query(four_bag)), -np.inf),
             "and": (inputs_for(match_query(heaviest_bag, operator="and")),
                     -np.inf),
             "deletes": (deleted, -np.inf)}
    top = bm25.term_bag_topk_segments(median, k=100).numpy()[0]
    cut = float(np.float32(np.median(top[np.isfinite(top)])))
    cases["min_score"] = (median, cut)
    fn = cuda_bm25.term_bag_topk_segments_cuda
    ks = (1, 10, 100, cuda_bm25.K_MAX, cuda_bm25.K_MAX + 1)
    for name, (inputs, ms) in cases.items():
        for k in ks:
            before = fn.launches, fn.sorted_route_segments
            got = fn(inputs, k=k, min_score=ms).numpy()
            ref = bm25.term_bag_topk_segments(inputs, k=k,
                                              min_score=ms).numpy()
            sorted_route = k > cuda_bm25.K_MAX
            if (fn.launches - before[0], fn.sorted_route_segments
                    - before[1]) != (int(not sorted_route),
                                     len(inputs) * sorted_route):
                raise AssertionError(f"K2 top-k {name} k={k}: wrong route")
            for what, a, b in zip(("vals", "ids", "totals", "maxes"), got,
                                  ref):
                if a.tobytes() != b.tobytes():
                    raise AssertionError(
                        f"K2 top-k {name} k={k}: {what} differ from the "
                        "plain twin")
        log(f"K2 top-k {name} (min_score {ms}): k {list(ks)} byte-equal to "
            f"the plain twin (vals, ids, totals, maxes); totals "
            f"{int(ref[2].sum())}")

    out = {}
    for name in ("median", "heaviest"):
        inputs = cases[name][0]
        k = 10
        calls = []
        nbytes = 0
        for seg in inputs:
            act = seg.active
            rows = [(int(a), int(b), float(i), float(w)) for (a, b), i, w
                    in zip(seg.rows[act], seg.idfs[act], seg.weights[act])]
            n_pad = seg.live.shape[0]
            nbytes += sum(8 * (b - a) for a, b, _i, _w in rows) + n_pad + \
                8 * k + 8
            calls.append((seg, rows, n_pad))

        def lib_chain():
            for seg, rows, n_pad in calls:
                acc = torch.zeros(n_pad, dtype=torch.float32, device=dev)
                for a, b, idf_v, w in rows:
                    acc.index_add_(0, seg.doc_ids[a:b],
                                   seg.impacts[a:b] * idf_v, alpha=w)
                torch.topk(acc, k)

        ms, plain_ms = in_turns(
            lambda: fn(inputs, k=k),
            lambda: bm25.term_bag_topk_segments(inputs, k=k), 20)
        lib_ms = cuda_ms(lib_chain, 20)
        dev_ms = kernel_device_ms(lambda: fn(inputs, k=k), 20,
                                  "term_bag_topk_kernel")
        postings = sum(b - a for _s, rows, _n in calls for a, b, _i, _w in rows)
        bms, by = bound_ms(nbytes, 3.0 * postings)
        bag = median_bag if name == "median" else heaviest_bag
        log(f"K2 top-k {name} bag {bag} k={k} over {len(inputs)} segments "
            f"({postings} postings), one launch per query: ms {ms:.4f} "
            f"device_ms {dev_ms} plain_ms {plain_ms:.4f} library_ms"
            f"(index_add_ + topk chain) {lib_ms:.4f} bound_ms {bms:.5f} "
            f"({by}: {nbytes} bytes) on {gpu_name_power()}")
        out[name] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                     "bound_bytes": nbytes, "bag": bag, "postings": postings}
    return {**out["median"], "max_abs_err": 0.0, "heaviest": out["heaviest"]}


def match_body(a: int, b: int, size: int = 10, **extra) -> dict:
    """A ``match`` body over the scale corpus's ``body`` field."""
    terms = f"t{a} t{b}"
    query = {"query": terms, **extra} if extra else terms
    return {"query": {"match": {"body": query}}, "size": size,
            "_source": False}


def batch_inputs(searcher, bodies) -> dict:
    """The prepared inputs of the one ``BatchGroup`` that ``bodies`` (one
    field, one size) form: ``{"segs", "required", "need_counts", ...}``."""
    from opensearch_tpu_torch.search.batch import plan_batches

    groups, fallback = plan_batches(searcher, bodies)
    if fallback or len(groups) != 1:
        raise AssertionError(f"bodies form {len(groups)} groups and "
                             f"{len(fallback)} fallbacks")
    return groups[0]._prepare(searcher)


def phase_batch_topk(searcher, dev, gen, query_pairs):
    """K3 against its plain twin over the 16 scale segments, byte for
    byte: batches of 1, 7 and 64 ``match`` queries of the zipf log (OR
    bags, with and without the presence counts), 64 ``and`` bags, 64 OR
    bags over segments with deletes, 64 bags with a duplicate term (OR
    and ``and``), 64 bags with negative weights, and 256 bags of 3-4
    distinct terms (several query chunks at K_MAX), k in 1, 10, 100,
    K_MAX; then timed on the 64-query OR batch at k = 10 and 100 (one
    launch per batch, the launch table cached as the main path caches it)
    beside the plain twin, the library chain (the reference's formulation
    per segment: ``index_add_`` into a [T * n_pad] arena, row gathers,
    ``torch.topk``), the route K3 replaced (K2's top-k kernel over one
    table entry per (query, segment), ``testing/k3_sweep.py``) and the
    bound."""
    import torch

    from opensearch_tpu_torch.ops import cuda_bm25
    from opensearch_tpu_torch.search import batch
    from opensearch_tpu_torch.testing import corpus, k3_sweep

    fn = cuda_bm25.batch_term_bag_topk_cuda
    lib = cuda_bm25._union_library()
    for caps in ((60, 64, 128, 16, 512, 64, 4000, 0),
                 (3, 45, 150, 32, 256, 512, 0, 1),
                 (1000, 1, 1000, 1, 32, 512, 88, 1)):
        if lib.union_topk_smem_bytes(*caps) != cuda_bm25.union_smem_bytes(
                *caps):
            raise AssertionError(f"K3 shared memory sum differs from the "
                                 f"wrapper's at {caps}")
    cases = {}

    def add(name, bodies):
        prep = batch_inputs(searcher, bodies)
        cases[name] = (prep["segs"], prep["required"], len(bodies),
                       prep["need_counts"])

    for n in (1, 7, 64):
        add(f"{n} or", [match_body(a, b) for a, b in query_pairs[:n]])
    add("64 and", [match_body(a, b, operator="and")
                   for a, b in query_pairs[64:128]])
    segs64, req64, _n, _nc = cases["64 or"]
    deleted = [seg._replace(live=seg.live & (torch.rand(
        seg.live.shape[0], device=dev, generator=gen) > 0.1))
        for seg in segs64]
    cases["64 or, deletes"] = (deleted, req64, 64, False)

    def dup_body(a, b, **extra):
        body = match_body(a, b, **extra)
        q = body["query"]["match"]["body"]
        text = f"t{a} t{a} t{b}"
        body["query"]["match"]["body"] = ({**q, "query": text}
                                          if extra else text)
        return body

    add("64 duplicate", [dup_body(a, b) for a, b in query_pairs[:64]])
    add("64 duplicate and", [dup_body(a, b, operator="and")
                             for a, b in query_pairs[:64]])
    # negative weights: every other query's second slot at -0.5, so the
    # batch takes the counted match rule, as the plain twin does
    sign = np.where(np.arange(segs64[0].qweights.shape[0]) % 2, 1.0,
                    -0.5).astype(np.float32)[:, None]
    negative = [seg._replace(qweights=np.concatenate(
        [seg.qweights[:, :1], seg.qweights[:, 1:] * sign], axis=1))
        for seg in segs64]
    cases["64 negative"] = (negative, req64, 64, True)
    draws = iter(t for pair in corpus.zipf_query_log(4096, seed=11)
                 for t in pair)
    wide = []
    for i in range(256):
        terms: dict = {}
        while len(terms) < 3 + i % 2:
            terms[f"t{next(draws)}"] = None
        wide.append({"query": {"match": {"body": " ".join(terms)}},
                     "size": cuda_bm25.K_MAX, "_source": False})
    add("256 wide", wide)
    wide_segs, wide_req, _n, wide_nc = cases["256 wide"]
    chunks = cuda_bm25.union_table(wide_segs, wide_req, n_queries=256,
                                   k=cuda_bm25.K_MAX,
                                   need_counts=wide_nc).n_chunks
    if chunks < 2:
        raise AssertionError(f"K3 256 wide at K_MAX: {chunks} chunk")
    ks = (1, 10, 100, cuda_bm25.K_MAX)
    for name, (segs, req, n, need_counts) in cases.items():
        ways = (need_counts,) if need_counts else (False, True)
        for nc in ways:
            for k in ks:
                before = fn.launches
                got = fn(segs, req, n_queries=n, k=k,
                         need_counts=nc).numpy()
                ref = batch.batch_term_bag_topk_segments(
                    segs, req, n_queries=n, k=k, need_counts=nc).numpy()
                if fn.launches - before != 1:
                    raise AssertionError(f"K3 {name} k={k}: "
                                         f"{fn.launches - before} launches")
                for what, a, b in zip(("vals", "ids", "totals", "maxes"),
                                      got, ref):
                    if a.tobytes() != b.tobytes():
                        raise AssertionError(
                            f"K3 {name} need_counts={nc} k={k}: {what} "
                            "differ from the plain twin")
        log(f"K3 batch {name} ({len(segs)} segments, need_counts "
            f"{list(ways)}): k {list(ks)} byte-equal to the plain twin "
            f"(vals, ids, totals, maxes), one launch each; totals "
            f"{int(ref[2].sum())}")
    log(f"K3 batch 256 wide at k={cuda_bm25.K_MAX}: {chunks} query chunks "
        "in one launch")

    n = 64
    nbytes = {}
    postings = 0
    query_postings = 0         # each query's rows, summed over queries
    lib_inputs = []
    for seg in segs64:
        n_u = int(seg.union_active.sum())
        rows = seg.union_rows[:n_u]
        lens = rows[:, 1] - rows[:, 0]
        seg_postings = int(lens.sum())
        postings += seg_postings
        query_postings += int(lens[seg.qslots[:n]][seg.qact[:n] > 0].sum())
        n_pad = seg.live.shape[0]
        for k in (10, 100):
            nbytes[k] = nbytes.get(k, 0) + 8 * seg_postings + n_pad \
                + n * (8 * k + 8)
        pos = np.concatenate([np.arange(a, b) for a, b in rows])
        slot = np.repeat(np.arange(n_u), rows[:, 1] - rows[:, 0])
        docs = seg.doc_ids[torch.from_numpy(pos).to(dev)].long()
        lib_inputs.append((
            seg, n_u, torch.from_numpy(pos).to(dev),
            torch.from_numpy(slot).to(dev) * n_pad + docs,
            torch.from_numpy(seg.union_idfs[slot]).to(dev),
            torch.from_numpy(seg.qslots[:n]).to(dev).long(),
            torch.from_numpy(seg.qweights[:n]).to(dev)))

    def lib_chain(k):
        for seg, n_u, pos, flat, idf_p, qs, qw in lib_inputs:
            n_pad = seg.live.shape[0]
            arena = torch.zeros(n_u * n_pad, dtype=torch.float32,
                                device=dev).index_add_(
                0, flat, seg.impacts[pos] * idf_p)
            dense = arena.view(n_u, n_pad)
            scores = torch.zeros((n, n_pad), dtype=torch.float32,
                                 device=dev)
            for j in range(qs.shape[1]):
                scores = scores + qw[:, j: j + 1] * dense[qs[:, j]]
            key = torch.where((scores > 0) & seg.live, scores, -torch.inf)
            torch.topk(key, k, dim=1)

    old_table = k3_sweep.pinned_batch_table(segs64, req64, n_queries=n,
                                            need_counts=False)
    out = {}
    unions = [int(seg.union_active.sum()) for seg in segs64]
    for k in (10, 100):
        table = cuda_bm25.pinned_union_table(segs64, req64, n_queries=n,
                                             k=k, need_counts=False)

        def kernel():
            return fn(segs64, req64, n_queries=n, k=k, need_counts=False,
                      table=table)

        def old():
            return k3_sweep.old_route(segs64, old_table, n_queries=n, k=k)

        got, ref = kernel().numpy(), old().numpy()
        if any(a.tobytes() != b.tobytes() for a, b in zip(got, ref)):
            raise AssertionError(f"K3 k={k}: differs from the old route")
        ms, plain_ms = in_turns(
            kernel, lambda: batch.batch_term_bag_topk_segments(
                segs64, req64, n_queries=n, k=k, need_counts=False), 10)
        old_ms, _ = in_turns(old, kernel, 10)
        lib_ms = cuda_ms(lambda: lib_chain(k), 10)
        dev_ms = kernel_device_ms(kernel, 20, "union_topk_kernel")
        old_dev_ms = kernel_device_ms(old, 20, "term_bag_topk_kernel")
        dev_ms2 = kernel_device_ms(kernel, 20, "union_topk_kernel")
        old_dev_ms2 = kernel_device_ms(old, 20, "term_bag_topk_kernel")
        if None in (dev_ms, dev_ms2, old_dev_ms, old_dev_ms2):
            raise AssertionError("the profiler shows no K3 or old-route "
                                 "kernel")
        # bytes: each union posting (id + impact) read once, a live byte
        # per doc, each (query, segment)'s k keys, total and max written
        # once; operations: w * (idf * imp) + score per posting of each
        # query
        bms, by = bound_ms(nbytes[k], 3.0 * query_postings)
        log(f"K3 batch of {n} OR bags k={k} over {len(segs64)} segments "
            f"(union {min(unions)}-{max(unions)} terms, {postings} union "
            f"postings, {query_postings} summed over the queries; "
            f"{table.n_chunks} chunk, D {table.docs}, {table.blocks} blocks "
            f"per segment), one launch per batch: ms {ms:.4f} device_ms "
            f"{dev_ms} / {dev_ms2} plain_ms {plain_ms:.4f} "
            f"library_ms(index_add_ arena + row gathers + topk chain) "
            f"{lib_ms:.4f} old route (K2 kernel over (query, segment) "
            f"entries) ms {old_ms:.4f} device_ms {old_dev_ms} / "
            f"{old_dev_ms2} bound_ms {bms:.5f} ({by}: {nbytes[k]} bytes) on "
            f"{gpu_name_power()}")
        out[k] = {"ms": ms, "device_ms": min(dev_ms, dev_ms2),
                  "plain_ms": plain_ms, "library_ms": lib_ms,
                  "old_route_ms": old_ms,
                  "old_route_device_ms": min(old_dev_ms, old_dev_ms2),
                  "bound_ms": bms, "bound_by": by, "bound_bytes": nbytes[k],
                  "postings": postings, "query_postings": query_postings,
                  "max_abs_err": 0.0, "batch": n, "k": k}
    return {**out[10], "k100": out[100]}


# -- phase 3 ----------------------------------------------------------------

INGEST_MAPPING = {"properties": {
    "body": {"type": "text"},
    "tag": {"type": "keyword"},
    "vec": {"type": "knn_vector", "dimension": DIM, "space_type": "l2"},
    "vec_cos": {"type": "knn_vector", "dimension": DIM,
                "space_type": "cosinesimil"},
    "vec_ip": {"type": "knn_vector", "dimension": DIM,
               "space_type": "innerproduct"},
}}


def ingest_docs(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    tags = ["red", "green", "blue", "gold", "grey"]
    docs = []
    for i in range(n):
        words = (rng.zipf(1.3, size=int(rng.integers(5, 40))) - 1) % 2000
        vec = rng.standard_normal(DIM).astype(np.float32).tolist()
        docs.append({"body": " ".join(f"w{w}" for w in words),
                     "tag": tags[i % len(tags)],
                     "vec": vec, "vec_cos": vec, "vec_ip": vec})
    return docs


def ingest_queries(seed: int) -> list:
    rng = np.random.default_rng(seed)
    qv = [rng.standard_normal(DIM).astype(np.float32).tolist()
          for _ in range(4)]
    bm25_q = [
        {"match": {"body": "w0 w3 w17"}},
        {"match": {"body": {"query": "w1 w2", "operator": "and"}}},
        {"match": {"body": {"query": "w0 w5 w9 w11",
                            "minimum_should_match": 2}}},
        {"bool": {"must": [{"match": {"body": "w2 w4"}}],
                  "filter": [{"term": {"tag": "blue"}}]}},
        {"constant_score": {"filter": {"term": {"tag": "gold"}},
                            "boost": 1.5}},
    ]
    from opensearch_tpu_torch.ops.cuda_knn import K_MAX
    knn_q = [
        {"knn": {"vec": {"vector": qv[0], "k": 10}}},
        {"knn": {"vec_cos": {"vector": qv[1], "k": 10}}},
        {"knn": {"vec_ip": {"vector": qv[2], "k": 10}}},
        {"knn": {"vec": {"vector": qv[3], "k": 10,
                         "filter": {"term": {"tag": "red"}}}}},
        # above the kernel's in-kernel k: the scores-only route
        {"knn": {"vec_cos": {"vector": qv[0], "k": K_MAX + 1}}},
    ]
    return ([{"query": q, "size": 20} for q in bm25_q]
            + [{"query": {"match": {"body": "w1 w6"}}, "size": 20,
                "min_score": 0.8},
               {"query": {"match": {"body": "w0 w1"}}, "size": 5,
                "track_total_hits": False}],
            [{"query": q, "size": 10, "_source": False} for q in knn_q])


def phase_ingest():
    from opensearch_tpu_torch.index.segment import SegmentWriter
    from opensearch_tpu_torch.mapping.mapper import DocumentMapper
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing.parity import (bm25_mismatch,
                                                     knn_mismatch)

    mapper = DocumentMapper(INGEST_MAPPING)
    docs = ingest_docs(2000, seed=11)
    parsed = [mapper.parse(str(i), d) for i, d in enumerate(docs)]
    writer = SegmentWriter()
    segs = [writer.build(parsed[:1100], "ingest_0"),
            writer.build(parsed[1100:], "ingest_1")]
    segs[0].apply_deletes([3, 10, 500, 1099])
    segs[1].apply_deletes([0, 7, 899])
    gpu = ShardSearcher(segs, mapper, device=DEVICE)
    cpu = ShardSearcher(segs, mapper, device="cpu")
    bm25_bodies, knn_bodies = ingest_queries(seed=12)
    for body in bm25_bodies:
        a, b = gpu.search(body), cpu.search(body)
        bad = bm25_mismatch(a, b)
        if bad:
            raise AssertionError(f"ingest {body['query']}: {bad}")
        if not a["hits"]["hits"]:
            raise AssertionError(f"ingest {body['query']}: no hits")
        log(f"ingest bm25 ok: {json.dumps(body)[:80]} "
            f"total={a['hits']['total']['value']}")
    for q in ({"match": {"body": "w0 w3 w17"}}, {"term": {"tag": "red"}}):
        a, b = gpu.count(q), cpu.count(q)
        if a != b or not a:
            raise AssertionError(f"ingest count {q}: {a} vs {b}")
        log(f"ingest count ok: {json.dumps(q)} = {a}")
    for body in knn_bodies:
        a, b = gpu.search(body), cpu.search(body)
        bad = knn_mismatch(a, b)
        if bad:
            raise AssertionError(f"ingest knn: {bad}")
        if len(a["hits"]["hits"]) != 10:
            raise AssertionError("ingest knn: expected 10 hits")
        field = next(iter(body["query"]["knn"]))
        spec = body["query"]["knn"][field]
        log(f"ingest knn ok: field={field} k={spec['k']} filtered="
            f"{'filter' in spec}")


# -- phase 4 ----------------------------------------------------------------

def build_scale():
    import torch

    from opensearch_tpu_torch.mapping.mapper import DocumentMapper
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus

    t0 = time.monotonic()
    raw = corpus.build_raw_corpus(SCALE_DOCS, seed=42)
    vecs = corpus.random_vectors(SCALE_DOCS, DIM, seed=43)
    segs = corpus.make_segments(raw, SCALE_SEGMENTS, vectors=vecs)
    mapper = DocumentMapper({"properties": {
        "body": {"type": "text"},
        "vec": {"type": "knn_vector", "dimension": DIM,
                "space_type": "l2"}}})
    searcher = ShardSearcher(segs, mapper, index_name="scale",
                             device=DEVICE)
    # stage every segment and its impact column before any timing
    avgdl = searcher.ctx.field_stats("body").avgdl
    for seg in segs:
        seg.device(searcher.device).impacts("body", avgdl)
    torch.cuda.synchronize()
    log(f"scale corpus: {SCALE_DOCS} docs, {len(segs)} segments of "
        f"{segs[0].n_docs} docs, {len(raw['doc_ids'])} postings, "
        f"{DIM}-d f32 vectors; built and staged in "
        f"{time.monotonic() - t0:.1f}s")
    log(f"scale resident bytes on device: {searcher.resident_bytes()}")
    return segs, mapper, searcher, raw


def timed(searcher, bodies) -> tuple:
    """(qps, p50 ms) of ``bodies`` searched one after another; every hit
    list must be at most ``size`` long with finite scores, and most
    queries must find something (a zipf tail pair may match nothing)."""
    lat = []
    answered = 0
    t0 = time.monotonic()
    for body in bodies:
        t = time.monotonic()
        resp = searcher.search(body)
        lat.append((time.monotonic() - t) * 1e3)
        hits = resp["hits"]["hits"]
        if len(hits) > body["size"] or \
                not all(np.isfinite(h["_score"]) for h in hits):
            raise AssertionError(f"bad hits for {json.dumps(body)[:80]}")
        answered += bool(hits)
    wall = time.monotonic() - t0
    if answered < 0.9 * len(bodies):
        raise AssertionError(f"only {answered} of {len(bodies)} queries "
                             "found hits")
    return len(bodies) / wall, float(np.median(lat))


def phase_scale(segs, mapper, searcher):
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus
    from opensearch_tpu_torch.testing.parity import (bm25_mismatch,
                                                     knn_mismatch)

    rng = np.random.default_rng(44)

    def match_bodies(n, seed):
        return [{"query": {"match": {"body": f"t{a} t{b}"}}, "size": 10,
                 "_source": False}
                for a, b in corpus.zipf_query_log(n, seed=seed)]

    def knn_bodies(n):
        return [{"query": {"knn": {"vec": {
            "vector": rng.standard_normal(DIM).astype(np.float32).tolist(),
            "k": 10}}}, "size": 10, "_source": False} for _ in range(n)]

    timed(searcher, match_bodies(20, seed=8))          # warm-up
    timed(searcher, knn_bodies(5))
    match_qs, knn_qs = match_bodies(200, seed=7), knn_bodies(100)
    from opensearch_tpu_torch.ops import cuda_bm25, cuda_knn
    counters = {"knn_topk": cuda_knn.knn_topk_segments_cuda,
                "knn_scores": cuda_knn.knn_scores_cuda,
                "term_bag": cuda_bm25.term_bag_cuda,
                "term_bag_topk": cuda_bm25.term_bag_topk_segments_cuda}

    def counts():
        return {name: fn.launches for name, fn in counters.items()}

    c0 = counts()
    m_qps, m_p50 = timed(searcher, match_qs)
    c1 = counts()
    k_qps, k_p50 = timed(searcher, knn_qs)
    c2 = counts()
    per_query = {}
    for name in counters:
        per_query[f"match_{name}"] = (c1[name] - c0[name]) / len(match_qs)
        per_query[f"knn_{name}"] = (c2[name] - c1[name]) / len(knn_qs)
    if per_query["knn_knn_topk"] != 1.0 or per_query["knn_knn_scores"]:
        raise AssertionError(f"a knn query must make exactly one K1 "
                             f"launch: {per_query}")
    if per_query["match_term_bag_topk"] != 1.0 or \
            per_query["match_term_bag"]:
        raise AssertionError(f"a match query must make exactly one K2 "
                             f"top-k launch and no per-slot one: "
                             f"{per_query}")
    gpu = gpu_name_power()
    log(f"scale match: {len(match_qs)} queries, qps {m_qps:.2f}, p50 "
        f"{m_p50:.3f} ms on {gpu}")
    log(f"scale knn: {len(knn_qs)} queries (k=10), qps {k_qps:.2f}, p50 "
        f"{k_p50:.3f} ms on {gpu}")
    # a sample against the same segments on the CPU (plain versions)
    cpu = ShardSearcher(segs, mapper, index_name="scale", device="cpu")
    for body in match_qs[:5]:
        bad = bm25_mismatch(searcher.search(body), cpu.search(body))
        if bad:
            raise AssertionError(f"scale match vs cpu: {bad}")
    for body in knn_qs[:3]:
        bad = knn_mismatch(searcher.search(body), cpu.search(body))
        if bad:
            raise AssertionError(f"scale knn vs cpu: {bad}")
    log("scale sample: 5 match queries byte-equal and 3 knn queries "
        "within tolerance of the CPU searcher")
    log("scale launches per query: match "
        f"{per_query['match_term_bag_topk']:.2f} K2 top-k (was 32 per-slot "
        f"launches) + {per_query['match_term_bag']:.2f} K2 per-slot + "
        f"{per_query['match_knn_topk']:.2f} K1; knn "
        f"{per_query['knn_knn_topk']:.2f} K1 (was 16, one per segment) + "
        f"{per_query['knn_knn_scores']:.2f} K1 scores-only + "
        f"{per_query['knn_term_bag']:.2f} K2 per-slot + "
        f"{per_query['knn_term_bag_topk']:.2f} K2 top-k")
    return {"match_qps": m_qps, "match_p50_ms": m_p50, "knn_qps": k_qps,
            "knn_p50_ms": k_p50, "launches_per_query": per_query}


# -- phases 5 and 6 ----------------------------------------------------------

def strip_took(resp: dict) -> str:
    return json.dumps({key: v for key, v in resp.items() if key != "took"},
                      sort_keys=True)


def phase_msearch(searcher, bodies, counters) -> dict:
    """The 256 ``match`` queries through ``ShardSearcher.msearch`` in 4
    batches of 64 (the batch path's first run: every group assembled,
    one K3 launch each), then again (group inputs cached), against the
    same queries through ``search`` one after another (after a warm-up
    pass).  Every response must equal the sequential one, each batch
    make one K3 launch and no K2 one, and batched qps reach 0.8 x
    sequential qps."""
    for body in bodies:                        # warm: plans, inputs
        searcher.search(body)
    t0 = time.monotonic()
    seq = [strip_took(searcher.search(body)) for body in bodies]
    seq_s = time.monotonic() - t0
    n_batches = len(bodies) // 64
    for fn in counters.values():               # the batched path starts
        fn.launches = 0
    t0 = time.monotonic()
    out = []
    for i in range(n_batches):
        out += searcher.msearch(bodies[64 * i: 64 * (i + 1)])
    cold_s = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    t0 = time.monotonic()
    warm = []
    for i in range(n_batches):
        warm += searcher.msearch(bodies[64 * i: 64 * (i + 1)])
    warm_s = time.monotonic() - t0
    per_batch = launches["batch_topk"] / n_batches
    if per_batch != 1.0 or launches["term_bag_topk"] or \
            launches["term_bag_scores"]:
        raise AssertionError(f"an msearch batch must make exactly one K3 "
                             f"launch and no K2 one: {launches}")
    bad = [i for i, r in enumerate(out + warm)
           if strip_took(r) != seq[i % len(bodies)]]
    if bad:
        raise AssertionError(f"msearch responses {bad[:5]} differ from "
                             "sequential search")
    seq_qps = len(bodies) / seq_s
    qps, warm_qps = len(bodies) / cold_s, len(bodies) / warm_s
    if qps < 0.8 * seq_qps:
        raise AssertionError(f"batched qps {qps:.1f} below 0.8 x "
                             f"sequential {seq_qps:.1f}")
    log(f"msearch: {len(bodies)} match queries in {n_batches} batches of "
        f"64, every response equal to sequential search; qps {qps:.2f} "
        f"(group inputs assembled) / {warm_qps:.2f} (cached) against "
        f"sequential {seq_qps:.2f}; launches per batch {per_batch:.2f} K3, "
        f"{launches['term_bag_topk'] / n_batches:.2f} K2 top-k, "
        f"{launches['term_bag_scores'] / n_batches:.2f} K2 per-slot on "
        f"{gpu_name_power()}")
    return {"qps": qps, "qps_cached": warm_qps, "seq_qps": seq_qps,
            "k3_launches_per_batch": per_batch, "launches": launches,
            "seq": seq}


def phase_continuous(searcher, bodies, seq, counters,
                     concurrency: int = 16) -> dict:
    """``concurrency`` client threads send the same queries as single
    searches through ``query_engine().execute(..., service=shim)``, the
    continuous batcher on with a 4 ms window and batches of at most 64:
    fewer than one dispatch per query (the reference bench's bar), every
    response equal to sequential search; qps, p50 and p99 latency.  Then
    the same threads with the batcher off, for the qps and latency that
    the batcher is held against."""
    import threading

    from opensearch_tpu_torch.search import engine as engine_mod

    class Shim:
        """Service shim: a bare searcher behind the engine, no mesh."""

        @staticmethod
        def _use_mesh(body):
            return False

    eng = engine_mod.query_engine()
    n = len(bodies)

    def drive() -> tuple:
        results = [None] * n
        lat = [0.0] * n
        errors = []

        def client(t):
            try:
                for i in range(t, n, concurrency):
                    t1 = time.monotonic()
                    results[i] = eng.execute(searcher, dict(bodies[i]),
                                             service=Shim())
                    lat[i] = (time.monotonic() - t1) * 1e3
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(t,),
                                    name=f"smoke-client-{t}", daemon=True)
                   for t in range(concurrency)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        wall = time.monotonic() - t0
        if any(t.is_alive() for t in threads):
            raise AssertionError("a continuous-batching client hung")
        if errors:
            raise errors[0]
        bad = [i for i, r in enumerate(results) if strip_took(r) != seq[i]]
        if bad:
            raise AssertionError(f"responses {bad[:5]} of {concurrency} "
                                 "threads differ from sequential search")
        p50, p99 = (float(np.percentile(lat, q)) for q in (50, 99))
        return n / wall, p50, p99

    prev = (engine_mod.BATCHER_ENABLED, engine_mod.BATCHER_WINDOW_MS,
            engine_mod.BATCHER_MAX_BATCH)
    engine_mod.BATCHER_WINDOW_MS = 4.0
    engine_mod.BATCHER_MAX_BATCH = 64
    try:
        engine_mod.BATCHER_ENABLED = True
        s0 = eng.batcher.stats()
        for fn in counters.values():
            fn.launches = 0
        qps, p50, p99 = drive()
        launches = {name: fn.launches for name, fn in counters.items()}
        s1 = eng.batcher.stats()
        engine_mod.BATCHER_ENABLED = False
        off_qps, off_p50, off_p99 = drive()
    finally:
        (engine_mod.BATCHER_ENABLED, engine_mod.BATCHER_WINDOW_MS,
         engine_mod.BATCHER_MAX_BATCH) = prev
        eng.shutdown()
    batched = s1["batched"] - s0["batched"]
    groups = s1["dispatches"] - s0["dispatches"]
    bypass = s1["bypass"] - s0["bypass"]
    solo = n - batched - bypass
    per_query = (groups + solo + bypass) / n
    if per_query >= 1.0 or launches["batch_topk"] != groups:
        raise AssertionError(f"continuous batching: {per_query} dispatches "
                             f"per query, {groups} groups, {launches}")
    log(f"continuous: {n} searches from {concurrency} threads, window 4 ms: "
        f"{groups} groups ({batched} members, mean {batched / max(groups, 1):.2f}),"
        f" {solo} solo, {bypass} bypass; {per_query:.4f} dispatches per "
        f"query; qps {qps:.2f}, p50 {p50:.3f} ms, p99 {p99:.3f} ms; batcher "
        f"off: qps {off_qps:.2f}, p50 {off_p50:.3f} ms, p99 {off_p99:.3f} "
        f"ms; every response equal to sequential search on "
        f"{gpu_name_power()}")
    return {"dispatches_per_query": per_query, "groups": groups,
            "batched": batched, "solo": solo, "bypass": bypass,
            "qps": qps, "p50_ms": p50, "p99_ms": p99,
            "batcher_off": {"qps": off_qps, "p50_ms": off_p50,
                            "p99_ms": off_p99},
            "launches": launches}


# -- the quantized layout (K4): phase 2's checks and phase 7 ------------------

def build_quantized(raw, mapper, dtype: str) -> tuple:
    """The scale corpus ``raw`` in ``QUANT_SEGMENTS`` segments of 125,000
    docs (each at or above ``QUANTIZED_MIN_DOCS``, so the port quantizes
    them as the reference does) with ``dtype`` codes, their tables built
    on the host (timed) and staged on the card.  Returns ``(segments,
    searcher, stats)``."""
    import torch

    from opensearch_tpu_torch.index import codec
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus

    segs = corpus.make_segments(raw, QUANT_SEGMENTS)
    searcher = ShardSearcher(segs, mapper, index_name=f"quant_{dtype}",
                             device=DEVICE)
    avgdl = searcher.ctx.field_stats("body").avgdl
    prev = codec.QUANTIZED_DTYPE
    codec.QUANTIZED_DTYPE = dtype
    try:
        t0 = time.monotonic()
        tables = [seg.quantized_table("body", avgdl) for seg in segs]
        quantize_s = time.monotonic() - t0
    finally:
        codec.QUANTIZED_DTYPE = prev
    for seg in segs:
        dseg = seg.device(searcher.device)
        if not dseg.quantized_mode:
            raise AssertionError(f"segment of {seg.n_docs} docs is not "
                                 "quantized")
        dseg.quantized("body", avgdl)
    torch.cuda.synchronize()
    stats = {key: sum(int(t.stats[key]) for t in tables)
             for key in ("terms", "postings", "exact_terms",
                         "exact_postings", "f32_bytes", "quant_bytes")}
    stats.update(dtype=dtype, width=[int(t.width) for t in tables],
                 segments=len(segs), docs_per_segment=segs[0].n_docs,
                 quantize_s=quantize_s)
    log(f"quantized {dtype}: {len(segs)} segments of {segs[0].n_docs} docs "
        f"quantized on the host in {quantize_s:.2f}s: {stats}")
    return segs, searcher, stats


def build_small_quantized(dtype: str) -> tuple:
    """A 20,000-doc corpus in 4 segments of 5,000 docs, under the
    reference's threshold but quantized all the same (``QUANTIZED_MODE``
    "on", as a user may set it) with ``dtype`` codes: K4 at another delta
    width (13 bits) than the scale shard's.  Returns ``(segments,
    searcher)``."""
    from opensearch_tpu_torch.index import codec
    from opensearch_tpu_torch.mapping.mapper import DocumentMapper
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus

    segs = corpus.make_segments(corpus.build_raw_corpus(20_000, seed=5), 4)
    mapper = DocumentMapper({"properties": {"body": {"type": "text"}}})
    prev = codec.QUANTIZED_MODE, codec.QUANTIZED_DTYPE
    codec.QUANTIZED_MODE, codec.QUANTIZED_DTYPE = "on", dtype
    try:
        searcher = ShardSearcher(segs, mapper, index_name=f"small_{dtype}",
                                 device=DEVICE)
        avgdl = searcher.ctx.field_stats("body").avgdl
        for seg in segs:
            dseg = seg.device(searcher.device)
            if not dseg.quantized_mode:
                raise AssertionError("QUANTIZED_MODE on did not quantize")
            dseg.quantized("body", avgdl)
    finally:
        codec.QUANTIZED_MODE, codec.QUANTIZED_DTYPE = prev
    return segs, searcher


def quantized_counters() -> dict:
    """K4's launch counters: its top-k entry and its per-slot entry."""
    from opensearch_tpu_torch.ops import cuda_bm25

    return {"term_bag_quantized_topk": cuda_bm25.term_bag_topk_quantized_cuda,
            "term_bag_quantized_scores": cuda_bm25.term_bag_quantized_cuda}


def phase_quantized_kernels(quant, f32_segs, f32_searcher, query_pairs):
    """K4 against its plain twin on the card, byte for byte: the top-k
    entry over the 8 quantized segments at every bag, mask and k the
    contract lists, with int8 and int16 codes, bags with and without
    guarded terms, a term some segments lack (their blocks have no slot),
    and over 4 small segments at another delta width; the
    per-slot entry on three bags; a mixed call over 2 quantized and 2 f32
    segments; and K4 against K2 over the same segments'
    ``dequantized()`` column staged as f32.  Then the top-k entry timed
    (one launch per query) on the median and the heaviest bag beside the
    plain twin, the library chain ``[torch.topk(zeros(
    n_pad).index_add_(dequantized ...), k) for each segment]``, K2 over
    the dequantized column and the bound."""
    import torch

    from opensearch_tpu_torch.index.segment import pad_pow2
    from opensearch_tpu_torch.ops import bm25, cuda_bm25
    from opensearch_tpu_torch.ops import quantized as qops

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(4321)
    fn = cuda_bm25.term_bag_topk_segments_cuda
    k4 = cuda_bm25.term_bag_topk_quantized_cuda
    qsegs, qsearcher, _stats = quant["int8"]
    avgdl = qsearcher.ctx.field_stats("body").avgdl

    def guarded(terms):
        for seg in qsegs:
            pf = seg.postings["body"]
            ex = np.diff(seg.quantized_table("body", avgdl).exact_offsets)
            if any(pf.term_id(t) >= 0 and ex[pf.term_id(t)] > 0
                   for t in terms):
                return True
        return False

    pf0 = qsegs[0].postings["body"]
    bags = [[f"t{a}", f"t{b}"] if a != b else [f"t{a}"]
            for a, b in query_pairs]
    by_size = sorted(bags, key=lambda t: df_sum(pf0, t))
    median_bag, heaviest_bag = by_size[len(by_size) // 2], by_size[-1]
    four_bag = by_size[len(by_size) // 4] + by_size[-2]
    coded = [b for b in by_size if not guarded(b)]
    unguarded_bag = coded[-1]
    # the median of the bags the parity guard left all quantized
    coded_bag = coded[len(coded) // 2]
    # the term of the first segment with the most postings there that
    # another segment lacks: that segment's blocks have no active slot
    present = [set(seg.postings["body"].terms) for seg in qsegs[1:]]
    absent_bag = [min((t for t in pf0.terms
                       if not all(t in p for p in present)),
                      key=lambda t: (-int(pf0.df[pf0.term_id(t)]), t))]

    median = topk_inputs(qsegs, qsearcher, match_query(median_bag))
    deleted = [seg._replace(live=seg.live & (torch.rand(
        seg.live.shape[0], device=dev, generator=gen) > 0.1))
        for seg in median]
    cases = {"median": (median, -np.inf),
             "heaviest": (topk_inputs(qsegs, qsearcher,
                                      match_query(heaviest_bag)),
                          -np.inf),
             "4-term": (topk_inputs(qsegs, qsearcher, match_query(four_bag)),
                        -np.inf),
             "and": (topk_inputs(qsegs, qsearcher,
                                match_query(heaviest_bag, operator="and")),
                     -np.inf),
             "deletes": (deleted, -np.inf),
             "unguarded": (topk_inputs(qsegs, qsearcher,
                                      match_query(unguarded_bag)), -np.inf),
             "code-dominated": (topk_inputs(qsegs, qsearcher,
                                           match_query(coded_bag)),
                                -np.inf),
             "absent from a segment": (topk_inputs(qsegs, qsearcher,
                                                  match_query(absent_bag)),
                                       -np.inf)}
    top = bm25.term_bag_topk_segments(median, k=100).numpy()[0]
    cut = float(np.float32(np.median(top[np.isfinite(top)])))
    cases["min_score"] = (median, cut)
    s16, q16, _st16 = quant["int16"]
    cases["int16 median"] = (topk_inputs(s16, q16, match_query(median_bag)),
                             -np.inf)
    cases["int16 heaviest"] = (topk_inputs(s16, q16,
                                           match_query(heaviest_bag)),
                               -np.inf)
    cases["int16 absent from a segment"] = (
        topk_inputs(s16, q16, match_query(absent_bag)), -np.inf)

    def exact_slots(inputs):
        return sum(int((seg.quant.slot_exact[seg.active] >= 0).sum())
                   for seg in inputs)

    if exact_slots(cases["heaviest"][0]) == 0 or \
            exact_slots(cases["unguarded"][0]) != 0 or \
            exact_slots(cases["code-dominated"][0]) != 0:
        raise AssertionError("K4 cases: need a bag with guarded terms and "
                             "bags without")
    if all(np.asarray(seg.active).any()
           for seg in cases["absent from a segment"][0]):
        raise AssertionError("K4 cases: need a segment with no active slot")
    # 4 small segments quantized at another width, int8 and int16
    small = {dtype: build_small_quantized(dtype)
             for dtype in ("int8", "int16")}
    s_pf0 = small["int8"][0][0].postings["body"]
    s_bags = sorted(bags, key=lambda t: df_sum(s_pf0, t))
    small_views = {}        # case -> (segments, avgdl) of its f32 view
    for dtype, (ssegs, ssearcher) in small.items():
        s_avgdl = ssearcher.ctx.field_stats("body").avgdl
        width = ssegs[0].quantized_table("body", s_avgdl).width
        if width == qsegs[0].quantized_table("body", avgdl).width:
            raise AssertionError("the small segments share the scale "
                                 "shard's width")
        for name, bag, extra in (
                ("median", s_bags[len(s_bags) // 2], {}),
                ("heaviest", s_bags[-1], {}),
                ("and", s_bags[-1], {"operator": "and"})):
            case = f"small {dtype} {name} (width {width})"
            cases[case] = (topk_inputs(ssegs, ssearcher,
                                       match_query(bag, **extra)), -np.inf)
            small_views[case] = (ssegs, s_avgdl)
    ks = (1, 10, 100, cuda_bm25.K_MAX, cuda_bm25.K_MAX + 1)
    for name, (inputs, ms) in cases.items():
        for k in ks:
            before = (k4.launches, fn.launches, fn.sorted_route_segments)
            got = fn(inputs, k=k, min_score=ms).numpy()
            ref = bm25.term_bag_topk_segments(inputs, k=k,
                                              min_score=ms).numpy()
            sorted_route = k > cuda_bm25.K_MAX
            moved = (k4.launches - before[0], fn.launches - before[1],
                     fn.sorted_route_segments - before[2])
            if moved != (int(not sorted_route), 0,
                         len(inputs) * sorted_route):
                raise AssertionError(f"K4 top-k {name} k={k}: launches "
                                     f"{moved}")
            for what, a, b in zip(("vals", "ids", "totals", "maxes"), got,
                                  ref):
                if a.tobytes() != b.tobytes():
                    raise AssertionError(
                        f"K4 top-k {name} k={k}: {what} differ from the "
                        "plain twin")
        log(f"K4 top-k {name} (min_score {ms}, {exact_slots(inputs)} "
            f"guarded slots): k {list(ks)} byte-equal to the plain twin "
            f"(vals, ids, totals, maxes); totals {int(ref[2].sum())}")

    # the per-slot entry on three bags, scores only and scores + counts
    for terms in (median_bag, heaviest_bag, four_bag):
        plan, bind = qsearcher.compiled(match_query(terms))
        seg = qsegs[0]
        dseg = seg.device(dev)
        dims, ins = plan.prepare(bind, seg, dseg, qsearcher.ctx)
        _t_pad, budget, _fast, width = dims
        *tables, _req = ins
        tids, active, idfs, weights, qv, sc, ev, eo, pk, bs = tables
        args = (dseg.postings["body"]["offsets"], pk, bs, qv, sc, ev, eo,
                tids, active, idfs, weights)
        kw = dict(width=width, n_pad=dseg.n_pad, budget=budget)
        s1, c1 = qops.quantized_impact_score_count(*args, **kw, scored=True)
        s2, c2 = qops.quantized_impact_score_count_plain(*args, **kw,
                                                         scored=True)
        s3 = qops.quantized_impact_scores(*args, **kw)
        s4 = qops.quantized_impact_scores_plain(*args, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(s1, s2) and torch.equal(c1, c2)
                and torch.equal(s3, s4) and torch.equal(s1, s3)):
            raise AssertionError(f"K4 per-slot differs from its plain twin "
                                 f"on {terms}")
        log(f"K4 per-slot bag {terms} ({df_sum(pf0, terms)} postings): "
            "scores and counts byte-equal to the plain twin")

    # a mixed call: 2 quantized and 2 f32 segments, one launch of each
    f32_median = topk_inputs(f32_segs[:2], f32_searcher,
                             match_query(median_bag))
    mixed = [median[0], f32_median[0], median[1], f32_median[1]]
    for k in (10, cuda_bm25.K_MAX):
        before = (k4.launches, fn.launches)
        got = fn(mixed, k=k).numpy()
        ref = bm25.term_bag_topk_segments(mixed, k=k).numpy()
        if (k4.launches - before[0], fn.launches - before[1]) != (1, 1):
            raise AssertionError("mixed call: expected one K4 and one K2 "
                                 "launch")
        if any(a.tobytes() != b.tobytes() for a, b in zip(got, ref)):
            raise AssertionError(f"mixed call k={k} differs from the plain "
                                 "twin")
    log("K4 + K2 mixed call (2 quantized, 2 f32 segments): one launch of "
        "each, byte-equal to the plain twin at k 10 and K_MAX")

    # K4 against K2 over the same segments' dequantized column, staged
    # here only (the segments' own staging stays quantized)
    def as_f32(inputs, segs, avgdl=avgdl):
        out = []
        for inp, seg in zip(inputs, segs):
            pf = seg.postings["body"]
            qt = seg.quantized_table("body", avgdl)
            p_pad = pad_pow2(len(pf.doc_ids))
            ids = np.full(p_pad, seg.n_docs, np.int32)
            ids[: len(pf.doc_ids)] = pf.doc_ids
            deq = np.zeros(p_pad, np.float32)
            deq[: len(pf.doc_ids)] = qt.dequantized()
            out.append(inp._replace(doc_ids=torch.from_numpy(ids).to(dev),
                                    impacts=torch.from_numpy(deq).to(dev),
                                    quant=None))
        return out

    f32_views = {}
    for name in ("median", "heaviest", "and", "deletes", "min_score",
                 "code-dominated", "absent from a segment", *small_views):
        inputs, ms = cases[name]
        f32_views[name] = as_f32(inputs, *small_views.get(name, (qsegs,)))
        for k in (10, 100, cuda_bm25.K_MAX):
            a = fn(inputs, k=k, min_score=ms).numpy()
            b = fn(f32_views[name], k=k, min_score=ms).numpy()
            if any(x.tobytes() != y.tobytes() for x, y in zip(a, b)):
                raise AssertionError(f"K4 {name} k={k} differs from K2 over "
                                     "dequantized()")
    log(f"K4 byte-equal to K2 over the dequantized() column "
        f"({', '.join(f32_views)}; k 10, 100, K_MAX)")

    # the per-slot entry timed at the median bag on one quantized segment
    # (scores only, as bool / constant_score call it)
    slot_fn = cuda_bm25.term_bag_quantized_cuda
    plan, bind = qsearcher.compiled(match_query(median_bag))
    seg, one = qsegs[0], median[0]
    dseg = seg.device(dev)
    dims, ins = plan.prepare(bind, seg, dseg, qsearcher.ctx)
    _t_pad, budget, _fast, width = dims
    tids, active, idfs, weights, qv, sc, ev, eo, pk, bs = ins[:-1]
    args = (dseg.postings["body"]["offsets"], pk, bs, qv, sc, ev, eo, tids,
            active, idfs, weights)
    kw = dict(width=width, n_pad=dseg.n_pad, budget=budget)
    before = slot_fn.launches
    qops.quantized_impact_scores(*args, **kw)
    per_call = slot_fn.launches - before
    slot_ms, slot_plain_ms = in_turns(
        lambda: qops.quantized_impact_scores(*args, **kw),
        lambda: qops.quantized_impact_scores_plain(*args, **kw), 20)
    view = f32_views["median"][0]

    def slot_lib():
        acc = torch.zeros(view.live.shape[0], dtype=torch.float32,
                          device=dev)
        for (a, b), act, idf_v, w in zip(view.rows, view.active, view.idfs,
                                         view.weights):
            if act:
                acc.index_add_(0, view.doc_ids[a:b],
                               view.impacts[a:b] * float(idf_v),
                               alpha=float(w))

    slot_lib_ms = cuda_ms(slot_lib, 20)
    per_launch = kernel_device_ms(
        lambda: qops.quantized_impact_scores(*args, **kw), 20,
        "term_bag_slot_kernel")
    if per_launch is None:
        raise AssertionError("the profiler shows no K4 per-slot kernel")
    slot_bytes = 4.0 * dseg.n_pad       # the dense scores written
    slot_ops = 0
    slot_postings = 0
    q_bytes = one.quant.qvals.element_size()
    for (a, b), ex in zip(one.rows[one.active],
                          one.quant.slot_exact[one.active]):
        n = int(b - a)
        slot_postings += n
        slot_bytes += n * (one.quant.width / 8 + (4 if ex >= 0 else q_bytes))
        slot_ops += n * (3 if ex >= 0 else 4)
    slot_bms, slot_by = bound_ms(slot_bytes, float(slot_ops))
    log(f"K4 per-slot bag {median_bag} on one quantized segment of "
        f"{seg.n_docs} docs ({slot_postings} postings, {per_call} launches "
        f"a call): ms {slot_ms:.4f} device_ms {per_launch * per_call:.5f} "
        f"({per_launch:.5f} a launch) plain_ms {slot_plain_ms:.4f} "
        f"library_ms(index_add_ chain over dequantized()) "
        f"{slot_lib_ms:.4f} bound_ms {slot_bms:.5f} ({slot_by}: "
        f"{slot_bytes:.0f} bytes) on {gpu_name_power()}")
    slot_row = {"ms": slot_ms, "device_ms": per_launch * per_call,
                "plain_ms": slot_plain_ms, "library_ms": slot_lib_ms,
                "bound_ms": slot_bms, "bound_by": slot_by,
                "bound_bytes": slot_bytes, "launches_per_call": per_call,
                "max_abs_err": 0.0, "postings": slot_postings}

    out = {}
    k = 10
    for name in ("median", "heaviest", "int16 median"):
        inputs = cases[name][0]
        views = f32_views.get(name) or as_f32(inputs, s16 if name.startswith(
            "int16") else qsegs)
        nbytes = 0.0
        ops = 0
        postings = 0
        exact_postings = 0
        for seg in inputs:
            q = seg.quant
            q_bytes = q.qvals.element_size()
            act = seg.active
            for (a, b), ex in zip(seg.rows[act], q.slot_exact[act]):
                n = int(b - a)
                postings += n
                exact_postings += n * int(ex >= 0)
                nbytes += n * (q.width / 8 + (4 if ex >= 0 else q_bytes))
                ops += n * (3 if ex >= 0 else 4)
            nbytes += seg.live.shape[0] + 8 * k + 8

        def lib_chain(views=views):
            for seg in views:
                acc = torch.zeros(seg.live.shape[0], dtype=torch.float32,
                                  device=dev)
                for (a, b), act, idf_v, w in zip(seg.rows, seg.active,
                                                 seg.idfs, seg.weights):
                    if act:
                        acc.index_add_(0, seg.doc_ids[a:b],
                                       seg.impacts[a:b] * float(idf_v),
                                       alpha=float(w))
                torch.topk(acc, k)

        ms, plain_ms = in_turns(
            lambda: fn(inputs, k=k),
            lambda: bm25.term_bag_topk_segments(inputs, k=k), 10)
        lib_ms = cuda_ms(lib_chain, 10)
        dev_ms = kernel_device_ms(lambda: fn(inputs, k=k), 20,
                                  "quant_topk_kernel")
        k2_ms = kernel_device_ms(lambda: fn(views, k=k), 20, "F32Rows")
        bms, by = bound_ms(nbytes, float(ops))
        bag = heaviest_bag if name == "heaviest" else median_bag
        log(f"K4 top-k {name} bag {bag} k={k} over {len(inputs)} quantized "
            f"segments ({postings} postings, {exact_postings} of guarded "
            f"terms), one launch per query: ms {ms:.4f} device_ms {dev_ms} "
            f"plain_ms {plain_ms:.4f} library_ms(index_add_ of dequantized "
            f"+ topk chain) {lib_ms:.4f} K2-over-dequantized device_ms "
            f"{k2_ms} bound_ms {bms:.5f} ({by}: {nbytes:.0f} bytes) on "
            f"{gpu_name_power()}")
        out[name] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                     "bound_bytes": nbytes, "k2_dequantized_device_ms": k2_ms,
                     "bag": bag, "postings": postings,
                     "exact_postings": exact_postings}
    del f32_views
    return {**out["median"], "max_abs_err": 0.0,
            "heaviest": out["heaviest"], "int16": out["int16 median"],
            "per_slot": slot_row}


def phase_quantized_scale(segs, mapper, searcher, build, counters) -> dict:
    """Phase 7: the 200 zipf ``match`` queries of phase 4 through
    ``ShardSearcher.search`` over the 8 quantized segments (qps, p50;
    one K4 top-k launch and no per-slot launch per query), then a
    ``bool`` / ``constant_score`` / ``count`` / large-``size`` sample (the
    per-slot entries), a sample byte-equal to the CPU searcher, and the
    resident bytes against the f32 layout of the same segments."""
    import torch

    from opensearch_tpu_torch.common.errors import NotYetPortedError
    from opensearch_tpu_torch.index import codec
    from opensearch_tpu_torch.index.segment import DeviceSegment
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus
    from opensearch_tpu_torch.testing.parity import bm25_mismatch

    def match_bodies(n, seed):
        return [{"query": {"match": {"body": f"t{a} t{b}"}}, "size": 10,
                 "_source": False}
                for a, b in corpus.zipf_query_log(n, seed=seed)]

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in counters.items()}

    match_qs = match_bodies(200, seed=7)
    pairs = corpus.zipf_query_log(8, seed=21)
    sample = [
        {"query": {"bool": {"must": [{"match": {"body": f"t{a} t{b}"}}],
                            "should": [{"match": {"body": "t3"}}]}},
         "size": 10, "_source": False} for a, b in pairs[:3]] + [
        {"query": {"bool": {"must": [{"match": {"body": f"t{a}"}}],
                            "filter": [{"match": {"body": f"t{b}"}}]}},
         "size": 10, "_source": False} for a, b in pairs[3:5]] + [
        {"query": {"constant_score": {"filter": {"match": {
            "body": f"t{pairs[5][0]} t{pairs[5][1]}"}}, "boost": 2.0}},
         "size": 10, "_source": False},
        {"query": {"match": {"body": f"t{pairs[6][0]} t{pairs[6][1]}"}},
         "size": 300, "_source": False},
        {"query": {"match": {"body": f"t{pairs[7][0]} t{pairs[7][1]}"}},
         "size": 10, "track_total_hits": False, "_source": False}]
    count_qs = [{"match": {"body": f"t{a} t{b}"}} for a, b in pairs[:3]]
    try:
        timed(searcher, match_bodies(20, seed=8))          # warm-up
        zero()
        m_qps, m_p50 = timed(searcher, match_qs)
        match_launches = counts()
        resident = searcher.resident_bytes()
        zero()
        for body in sample:
            searcher.search(body)
        gpu_counts = [searcher.count(q) for q in count_qs]
        sample_launches = counts()
        cpu = ShardSearcher(segs, mapper, index_name="quant_int8",
                            device="cpu")
        for body in match_qs[:5] + sample:
            bad = bm25_mismatch(searcher.search(body), cpu.search(body))
            if bad:
                raise AssertionError(f"quantized scale vs cpu "
                                     f"{json.dumps(body)[:80]}: {bad}")
        if gpu_counts != [cpu.count(q) for q in count_qs]:
            raise AssertionError("quantized scale: counts differ from the "
                                 "CPU searcher")
    except NotYetPortedError as e:
        raise AssertionError(f"quantized scale refused a query: {e}") from e
    per_query = {n: c / len(match_qs) for n, c in match_launches.items()}
    if per_query["term_bag_quantized_topk"] != 1.0 or any(
            per_query[n] for n in per_query
            if n != "term_bag_quantized_topk"):
        raise AssertionError(f"a match query on quantized segments must "
                             f"make one K4 top-k launch and no other: "
                             f"{per_query}")
    if not sample_launches["term_bag_quantized_scores"] or \
            not sample_launches["term_bag_scores"]:
        raise AssertionError(f"the sample must run K4's and K2's per-slot "
                             f"entries: {sample_launches}")
    # the f32 layout of the same segments, staged and measured, then freed
    avgdl = searcher.ctx.field_stats("body").avgdl
    prev = codec.QUANTIZED_MODE
    codec.QUANTIZED_MODE = "off"
    try:
        f32_bytes = 0
        for seg in segs:
            dseg = DeviceSegment(seg, searcher.device)
            dseg.impacts("body", avgdl)
            f32_bytes += dseg.nbytes()
            del dseg
    finally:
        codec.QUANTIZED_MODE = prev
    torch.cuda.empty_cache()
    if resident >= f32_bytes:
        raise AssertionError(f"quantized resident bytes {resident} not below "
                             f"the f32 layout's {f32_bytes}")
    gpu = gpu_name_power()
    log(f"quantized scale: {build['segments']} segments of "
        f"{build['docs_per_segment']} docs ({build['dtype']}, quantized in "
        f"{build['quantize_s']:.2f}s on the host, {build['exact_terms']} "
        f"guarded terms holding {build['exact_postings']} of "
        f"{build['postings']} postings); {len(match_qs)} match queries, qps "
        f"{m_qps:.2f}, p50 {m_p50:.3f} ms on {gpu}")
    log(f"quantized scale launches per match query: "
        f"{per_query['term_bag_quantized_topk']:.2f} K4 top-k, "
        f"{per_query['term_bag_quantized_scores']:.2f} K4 per-slot, "
        f"{per_query['term_bag_topk']:.2f} K2 top-k, "
        f"{per_query['term_bag_scores']:.2f} K2 per-slot; sample "
        f"(bool / constant_score / count / size 300 / untracked totals) "
        f"launches {sample_launches}; 5 match queries, the sample and 3 "
        f"counts byte-equal to the CPU searcher")
    log(f"quantized scale resident bytes on device: {resident} (after the "
        f"match queries) against {f32_bytes} for the f32 layout of the same "
        f"segments (x{f32_bytes / resident:.3f}); tables "
        f"{build['quant_bytes']} quantized against {build['f32_bytes']} f32 "
        f"bytes (codec stats); "
        f"{searcher.resident_bytes()} after the sample (filters stage the "
        f"f32 columns on demand)")
    return {"match_qps": m_qps, "match_p50_ms": m_p50,
            "launches_per_query": per_query,
            "sample_launches": sample_launches,
            "resident_bytes": resident, "f32_layout_bytes": f32_bytes,
            "build": build,
            "k4_launches": {n: match_launches[n] + sample_launches[n]
                            for n in ("term_bag_quantized_topk",
                                      "term_bag_quantized_scores")}}


# -- phase 8 ----------------------------------------------------------------

WRITE_DOCS = 160_000             # phase 8: docs indexed through the engine
WRITE_BULK = 1_000               # docs per bulk, one fsync each
WRITE_REFRESH_EVERY = 16_000     # docs between refreshes: 10 NRT segments
WRITE_REPLAY_DOCS = 1_000        # indexed last, then replayed after a kill
WRITE_MAPPING = {"properties": {"body": {"type": "text"},
                                "tag": {"type": "keyword"}}}
WRITE_TAGS = ("red", "green", "blue", "gold", "grey")


def device_allocated() -> int:
    import torch
    return torch.cuda.memory_allocated()


class WriteState:
    """The last acked state of every doc phase 8 writes (None when
    deleted), and what was updated or deleted."""

    def __init__(self, texts):
        self.texts = texts
        self.docs: dict = {}
        self.updated: set = set()
        self.deleted: set = set()
        self.conflicts = 0

    def source(self, i: int) -> dict:
        return {"body": self.texts[i], "tag": WRITE_TAGS[i % 5]}

    def live(self) -> int:
        return sum(src is not None for src in self.docs.values())

    def check(self, engine, ids) -> int:
        """Realtime ``get`` of ``ids`` against the acked state; returns
        how many were read."""
        for doc in ids:
            got = engine.get(doc)
            want = self.docs[doc]
            if (got is None) != (want is None) or \
                    (got is not None and got["_source"] != want):
                raise AssertionError(f"write path: get [{doc}] returned "
                                     f"{str(got)[:80]}, acked "
                                     f"{str(want)[:80]}")
        return len(ids)

    def sample(self, rng, n: int) -> list:
        keys = list(self.docs)
        picks = rng.choice(len(keys), size=min(n, len(keys)), replace=False)
        return sorted(self.updated | self.deleted
                      | {keys[int(i)] for i in picks})


def write_bulk(engine, state, rng, lo: int, hi: int) -> None:
    """Index docs ``lo`` to ``hi`` plus ~1% updates and ~0.5% deletes of
    earlier docs, then one ``ensure_synced()``: the writes are acked.
    Before each refresh, one write with a stale ``if_seq_no`` must be
    refused."""
    from opensearch_tpu_torch.common.errors import VersionConflictError

    for i in range(lo, hi):
        r = engine.index(str(i), state.source(i))
        if r.result != "created":
            raise AssertionError(f"write path: new doc [{i}] {r.result}")
        state.docs[str(i)] = state.source(i)
    n = hi - lo
    for j in rng.integers(0, hi, size=n // 100):
        doc = str(int(j))
        if state.docs[doc] is None:
            continue
        src = {"body": state.texts[int(rng.integers(0, hi))], "tag": "gold"}
        if engine.index(doc, src).result != "updated":
            raise AssertionError(f"write path: update of [{doc}] refused")
        state.docs[doc] = src
        state.updated.add(doc)
    for j in rng.integers(0, hi, size=n // 200):
        doc = str(int(j))
        if state.docs[doc] is None:
            continue
        if engine.delete(doc).result != "deleted":
            raise AssertionError(f"write path: delete of [{doc}] refused")
        state.docs[doc] = None
        state.deleted.add(doc)
    engine.ensure_synced()
    if hi % WRITE_REFRESH_EVERY:
        return
    doc = next(d for d in (str(int(j)) for j in rng.integers(0, hi, 50))
               if state.docs[d] is not None)
    stale = engine.get(doc)["_seq_no"] - 1
    try:
        engine.index(doc, {"body": "stale", "tag": "red"}, if_seq_no=stale)
    except VersionConflictError:
        state.conflicts += 1
    else:
        raise AssertionError(f"write path: a write to [{doc}] with the "
                             f"stale if_seq_no {stale} was accepted")


def write_bodies(seed: int, n: int = 20) -> list:
    """``n`` zipf ``match`` bodies and one ``bool`` with a ``term``
    filter on ``tag``."""
    from opensearch_tpu_torch.testing import corpus

    pairs = corpus.zipf_query_log(n + 1, seed=seed)
    a, b = pairs[-1]
    return [{"query": {"match": {"body": f"t{x} t{y}"}}, "size": 10,
             "_source": False} for x, y in pairs[:n]] + [
        {"query": {"bool": {"must": [{"match": {"body": f"t{a} t{b}"}}],
                            "filter": [{"term": {
                                "tag": WRITE_TAGS[seed % 5]}}]}},
         "size": 10, "_source": False}]


def against_cpu(engine, mapper, bodies, what: str) -> None:
    """``bodies`` on the engine's searcher, byte-equal to a searcher on
    the CPU over the same segments, with equal counts."""
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing.parity import bm25_mismatch

    searcher = engine.acquire_searcher()
    cpu = ShardSearcher(engine.segments, mapper, device="cpu")
    for body in bodies:
        bad = bm25_mismatch(searcher.search(body), cpu.search(body))
        if bad:
            raise AssertionError(f"write path {what}: "
                                 f"{json.dumps(body)[:80]}: {bad}")
    for q in ({"match_all": {}}, bodies[-1]["query"]):
        if searcher.count(q) != cpu.count(q):
            raise AssertionError(f"write path {what}: count of {q} differs "
                                 "from the CPU searcher")


def first_query_ms(engine, body) -> float:
    t0 = time.monotonic()
    engine.acquire_searcher().search(body)
    return (time.monotonic() - t0) * 1e3


def per_match(searcher, bodies, counters, want: str) -> tuple:
    """(qps, p50 ms, launches per query) of ``bodies`` (``match``); each
    query with a term in the shard must make one ``want`` launch and no
    other (a query none of whose terms occur makes none: the can-match
    skip)."""
    timed(searcher, bodies[:20])                          # warm-up
    c0 = {name: fn.launches for name, fn in counters.items()}
    qps, p50 = timed(searcher, bodies)
    reach = sum(any(searcher.ctx.df("body", t)
                    for t in b["query"]["match"]["body"].split())
                for b in bodies)
    per_query = {name: (fn.launches - c0[name]) / reach
                 for name, fn in counters.items()}
    if per_query[want] != 1.0 or any(v for name, v in per_query.items()
                                     if name != want):
        raise AssertionError(f"write path: a match query must make one "
                             f"{want} launch and no other: {per_query}")
    return qps, p50, per_query


def phase_write_path(counters) -> dict:
    """Phase 8: the write path on the card (see the module doc)."""
    import gc
    import shutil
    import tempfile

    from opensearch_tpu_torch.index import codec
    from opensearch_tpu_torch.index.engine import InternalEngine
    from opensearch_tpu_torch.mapping.mapper import DocumentMapper
    from opensearch_tpu_torch.testing import corpus

    t_phase = time.monotonic()
    mapper = DocumentMapper(WRITE_MAPPING)
    state = WriteState(corpus.render_texts(WRITE_DOCS + WRITE_REPLAY_DOCS,
                                           seed=42))
    rng = np.random.default_rng(81)
    path = tempfile.mkdtemp(prefix="chip_smoke_write_")
    quantized = [0]
    real_quantize = codec.quantize_postings

    def counted_quantize(*args, **kw):
        quantized[0] += 1
        return real_quantize(*args, **kw)

    def open_engine():
        t0 = time.monotonic()
        engine = InternalEngine(path, mapper, index_name="write",
                                device=DEVICE)
        return engine, time.monotonic() - t0

    match_qs = [{"query": {"match": {"body": f"t{a} t{b}"}}, "size": 10,
                 "_source": False}
                for a, b in corpus.zipf_query_log(200, seed=7)]
    codec.quantize_postings = counted_quantize
    for fn in counters.values():                # this path starts here
        fn.launches = 0
    try:
        engine, _ = open_engine()
        index_s, refresh_ms, visible_ms = 0.0, [], []
        for lo in range(0, WRITE_DOCS, WRITE_BULK):
            t0 = time.monotonic()
            write_bulk(engine, state, rng, lo, lo + WRITE_BULK)
            index_s += time.monotonic() - t0
            if (lo + WRITE_BULK) % WRITE_REFRESH_EVERY:
                continue
            t0 = time.monotonic()
            engine.refresh()
            refresh_ms.append((time.monotonic() - t0) * 1e3)
            bodies = write_bodies(seed=100 + len(refresh_ms))
            engine.acquire_searcher().search(bodies[0])
            visible_ms.append((time.monotonic() - t0) * 1e3)
            against_cpu(engine, mapper, bodies,
                        f"after refresh {len(refresh_ms)}")
        n_segments = len(engine.segments)
        read = state.check(engine, state.sample(rng, 2000))
        live = state.live()
        searcher = engine.acquire_searcher()
        if searcher.count({"match_all": {}}) != live or \
                engine.doc_count() != live:
            raise AssertionError(f"write path: {live} live docs acked, "
                                 f"count {searcher.count({'match_all': {}})}")
        f32 = per_match(searcher, match_qs, counters, "term_bag_topk")
        batch = match_qs[:64]
        seq = [strip_took(searcher.search(b)) for b in batch]
        k3_before = counters["batch_topk"].launches
        if [strip_took(r) for r in searcher.msearch(batch)] != seq or \
                counters["batch_topk"].launches - k3_before != 1:
            raise AssertionError("write path: an msearch batch of 64 on the "
                                 "engine's searcher must make one K3 launch "
                                 "and equal sequential search")
        old_resident = searcher.resident_bytes()
        del searcher
        gc.collect()
        before = device_allocated()
        t0 = time.monotonic()
        if engine.force_merge(2) != 2:
            raise AssertionError("write path: force_merge(2) did not give "
                                 "2 segments")
        merge_s = time.monotonic() - t0
        gc.collect()
        after = device_allocated()
        if after > before - old_resident:
            raise AssertionError(
                f"write path: {after} bytes allocated on the device after "
                f"the merge, more than {before} before it less the merged-"
                f"away segments' {old_resident}")
        merged = [seg.n_docs for seg in engine.segments]
        searcher = engine.acquire_searcher()
        if min(merged) < codec.QUANTIZED_MIN_DOCS or not all(
                seg.device(searcher.device).quantized_mode
                for seg in engine.segments):
            raise AssertionError(f"write path: merged segments {merged} "
                                 "are not all quantized")
        merge_first_ms = first_query_ms(engine, match_qs[0])
        against_cpu(engine, mapper, write_bodies(seed=300), "after merge")
        quant = per_match(searcher, match_qs, counters,
                          "term_bag_quantized_topk")
        del searcher
        engine.flush()
        engine.close()
        engine, recovery_s = open_engine()
        quantized[0] = 0
        cold_ms = first_query_ms(engine, match_qs[0])
        cold_quantized = quantized[0]
        sidecars = sorted(n for n in os.listdir(os.path.join(path, "segments"))
                          if n.endswith(".quant"))
        if cold_quantized != 2 or len(sidecars) != 2:
            raise AssertionError(f"write path: the first match after the "
                                 f"reopen quantized {cold_quantized} tables "
                                 f"and left sidecars {sidecars}")
        against_cpu(engine, mapper, write_bodies(seed=301), "after reopen")
        engine.close()
        engine, recovery2_s = open_engine()
        quantized[0] = 0
        warm_ms = first_query_ms(engine, match_qs[0])
        if quantized[0]:
            raise AssertionError(f"write path: the second reopen quantized "
                                 f"{quantized[0]} tables: sidecars unused")
        against_cpu(engine, mapper, write_bodies(seed=302),
                    "after the second reopen")
        replay = range(WRITE_DOCS, WRITE_DOCS + WRITE_REPLAY_DOCS)
        for i in replay:
            engine.index(str(i), state.source(i))
            state.docs[str(i)] = state.source(i)
        engine.ensure_synced()
        engine = None                            # killed: no close()
        gc.collect()
        engine, replay_s = open_engine()
        live = state.live()
        if engine.doc_count() != live:
            raise AssertionError(f"write path: {engine.doc_count()} docs "
                                 f"after the replay, {live} acked")
        engine.refresh()
        quantized[0] = 0
        shift_ms = first_query_ms(engine, match_qs[0])
        shift_quantized = quantized[0]
        read += state.check(engine, [str(i) for i in replay]
                            + state.sample(rng, 500))
        against_cpu(engine, mapper, write_bodies(seed=303),
                    "after the kill and replay")
        if engine.acquire_searcher().count({"match_all": {}}) != live:
            raise AssertionError("write path: count after the replay")
        engine.close()
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        codec.quantize_postings = real_quantize
        shutil.rmtree(path, ignore_errors=True)
    if min(launches[n] for n in ("term_bag_topk", "term_bag_quantized_topk",
                                 "batch_topk")) <= 0:
        raise AssertionError(f"write path: a kernel never launched: "
                             f"{launches}")
    gpu = gpu_name_power()
    out = {
        "docs": WRITE_DOCS, "nrt_segments": n_segments,
        "merged_segments": merged, "live_docs": live,
        "docs_per_s": WRITE_DOCS / index_s, "index_s": index_s,
        "refresh_s": sum(refresh_ms) / 1e3,
        "refresh_ms_p50": float(np.median(refresh_ms)),
        "refresh_ms_max": max(refresh_ms),
        "refresh_to_first_search_ms_p50": float(np.median(visible_ms)),
        "refresh_to_first_search_ms_max": max(visible_ms),
        "f32_match_qps": f32[0], "f32_match_p50_ms": f32[1],
        "quantized_match_qps": quant[0], "quantized_match_p50_ms": quant[1],
        "merge_s": merge_s, "first_match_after_merge_ms": merge_first_ms,
        "recovery_s": recovery_s, "recovery2_s": recovery2_s,
        "replay_s": replay_s, "first_match_cold_ms": cold_ms,
        "first_match_sidecar_ms": warm_ms,
        "first_match_after_avgdl_shift_ms": shift_ms,
        "quantized_after_shift": shift_quantized,
        "device_bytes_before_merge": before,
        "device_bytes_after_merge": after,
        "merged_away_resident_bytes": old_resident,
        "gets_read_back": read, "stale_writes_refused": state.conflicts,
        "updated": len(state.updated), "deleted": len(state.deleted),
        "launches": launches,
        "launches_per_match_f32": f32[2], "launches_per_match_quantized":
            quant[2], "wall_s": time.monotonic() - t_phase}
    log(f"write path: {WRITE_DOCS} docs in bulks of {WRITE_BULK} (one fsync "
        f"each) at {out['docs_per_s']:.1f} docs/s with "
        f"{len(state.updated)} updates, {len(state.deleted)} deletes and "
        f"{state.conflicts} stale writes refused; {n_segments} refreshes: "
        f"refresh ms p50 {out['refresh_ms_p50']:.1f} max "
        f"{out['refresh_ms_max']:.1f}, refresh-to-first-search ms p50 "
        f"{out['refresh_to_first_search_ms_p50']:.1f} max "
        f"{out['refresh_to_first_search_ms_max']:.1f}; f32 match "
        f"({n_segments} segments) qps {f32[0]:.2f} p50 {f32[1]:.3f} ms; "
        f"force_merge(2) {merge_s:.1f} s into {merged} docs; quantized "
        f"match qps {quant[0]:.2f} p50 {quant[1]:.3f} ms; recovery "
        f"{recovery_s:.2f} s / {recovery2_s:.2f} s / replay of "
        f"{WRITE_REPLAY_DOCS} ops {replay_s:.2f} s; first match ms: after "
        f"the merge {merge_first_ms:.1f}, cold {cold_ms:.1f} (quantized "
        f"{cold_quantized} tables, sidecars written), with the sidecar "
        f"{warm_ms:.1f} (0 quantized), after the replay's avgdl shift "
        f"{shift_ms:.1f} ({shift_quantized} quantized); device bytes "
        f"{before} before the merge, {after} after it (merged-away "
        f"segments held {old_resident}); {read} gets read back; launches "
        f"{launches}; on {gpu}")
    return out


# -- phase 9 ----------------------------------------------------------------

SERVE_DOCS = 20_000              # phase 9: docs indexed through _bulk
SERVE_BULK = 1_000               # items of a _bulk request
SERVE_REFRESH_EVERY = 5_000      # docs between _refresh calls: 4 refreshes
SERVE_VECTORS = 5_000            # docs of the 128-d vectors index
SERVE_SAMPLE = 500               # acked ids read back by GET _doc


class HttpClient:
    """One keep-alive HTTP/1.1 connection to the node (a client's
    connection pool of one); ``call`` returns (status, parsed body)."""

    def __init__(self, port: int):
        import http.client
        self.conn = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=300)

    def call(self, method: str, path: str, body=None, ndjson=None):
        headers = {}
        data = None
        if ndjson is not None:
            data = ("\n".join(json.dumps(x) for x in ndjson)
                    + "\n").encode()
            headers["Content-Type"] = "application/x-ndjson"
        elif body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        self.conn.request(method, path, body=data, headers=headers)
        resp = self.conn.getresponse()
        payload = resp.read()
        return resp.status, (json.loads(payload) if payload else {})

    def ok(self, method: str, path: str, body=None, ndjson=None,
           want: int = 200):
        status, out = self.call(method, path, body, ndjson)
        if status != want:
            raise AssertionError(f"serving: {method} {path} answered "
                                 f"{status}, not {want}: "
                                 f"{json.dumps(out)[:300]}")
        return out

    def close(self):
        self.conn.close()


def serve_bulk(client, state, rng, lo: int, hi: int) -> int:
    """One ``_bulk`` of docs ``lo`` to ``hi`` of ``corpus`` with ~1%
    ``update`` and ~0.5% ``delete`` items of earlier docs; every item's
    answer is checked and the acked state kept.  The first request also
    carries a ``create`` of an existing id, which must be refused.
    Returns the number of items."""
    items, expect = [], []
    for i in range(lo, hi):
        items += [{"index": {"_index": "corpus", "_id": str(i)}},
                  state.source(i)]
        expect.append((str(i), "index", state.source(i)))
    n = hi - lo
    for j in rng.integers(0, max(lo, 1), size=n // 100):
        doc = str(int(j))
        if state.docs.get(doc) is None:
            continue
        tag = WRITE_TAGS[int(rng.integers(0, 5))]
        items += [{"update": {"_index": "corpus", "_id": doc}},
                  {"doc": {"tag": tag}}]
        expect.append((doc, "update", {**state.docs[doc], "tag": tag}))
        state.docs[doc] = {**state.docs[doc], "tag": tag}
    for j in rng.integers(0, max(lo, 1), size=n // 200):
        doc = str(int(j))
        if state.docs.get(doc) is None:
            continue
        items.append({"delete": {"_index": "corpus", "_id": doc}})
        expect.append((doc, "delete", None))
        state.docs[doc] = None
    if lo == 0:
        items += [{"create": {"_index": "corpus", "_id": "0"}},
                  {"body": "t1", "tag": "red"}]
        expect.append(("0", "create", "conflict"))
    out = client.ok("POST", "/_bulk", ndjson=items)
    if len(out["items"]) != len(expect):
        raise AssertionError("serving: _bulk answered "
                             f"{len(out['items'])} items for {len(expect)}")
    for (doc, action, src), item in zip(expect, out["items"]):
        (got_action, res), = item.items()
        if action == "create":
            # the reference refuses a create of an existing id inside
            # _bulk with its version-conflict message (status 400,
            # opensearch_tpu/indices/service.py:329-334)
            if "version conflict" not in res.get("error", {}).get(
                    "reason", ""):
                raise AssertionError(f"serving: a create of the existing "
                                     f"id [{doc}] was not refused: {res}")
            state.conflicts += 1
            continue
        if got_action != action or res.get("error") or \
                res["status"] not in (200, 201):
            raise AssertionError(f"serving: {action} [{doc}] answered "
                                 f"{res}")
        if action == "index":
            state.docs[doc] = src
        elif action == "update":
            state.updated.add(doc)
        else:
            state.deleted.add(doc)
    return len(expect)


def read_back(client, state, ids) -> int:
    """``GET /corpus/_doc/{id}`` of ``ids`` against the acked state."""
    for doc in ids:
        status, out = client.call("GET", f"/corpus/_doc/{doc}")
        want = state.docs[doc]
        if (want is None and status != 404) or (
                want is not None and (status != 200
                                      or out.get("_source") != want)):
            raise AssertionError(f"serving: GET [{doc}] answered {status} "
                                 f"{json.dumps(out)[:120]}, acked "
                                 f"{str(want)[:80]}")
    return len(ids)


def serve_sequential(client, bodies, counters, reach: int) -> tuple:
    """(qps, p50 ms, p99 ms, responses, launches per query that can
    match) of ``bodies`` sent one at a time as ``_search`` requests."""
    c0 = {name: fn.launches for name, fn in counters.items()}
    lat, out = [], []
    t0 = time.monotonic()
    for body in bodies:
        t = time.monotonic()
        out.append(client.ok("POST", "/corpus/_search", body))
        lat.append((time.monotonic() - t) * 1e3)
    wall = time.monotonic() - t0
    per_query = {name: (fn.launches - c0[name]) / reach
                 for name, fn in counters.items()}
    return (len(bodies) / wall, float(np.percentile(lat, 50)),
            float(np.percentile(lat, 99)), out, per_query)


def client_threads(port: int, bodies, threads: int) -> tuple:
    """(responses, latencies ms, wall s) of ``bodies`` sent as
    ``/corpus/_search`` requests from ``threads`` client threads, each on
    its own keep-alive connection."""
    import threading

    n = len(bodies)
    results, lat, errors = [None] * n, [0.0] * n, []

    def client_thread(t):
        client = HttpClient(port)
        try:
            for i in range(t, n, threads):
                t1 = time.monotonic()
                results[i] = client.ok("POST", "/corpus/_search", bodies[i])
                lat[i] = (time.monotonic() - t1) * 1e3
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
        finally:
            client.close()

    pool = [threading.Thread(target=client_thread, args=(t,),
                             name=f"serve-client-{t}", daemon=True)
            for t in range(threads)]
    t0 = time.monotonic()
    for t in pool:
        t.start()
    for t in pool:
        t.join(300)
    wall = time.monotonic() - t0
    if any(t.is_alive() for t in pool):
        raise AssertionError("serving: a concurrent client hung")
    if errors:
        raise errors[0]
    return results, lat, wall


def client_process_main(port: int, threads: int, in_path: str,
                        out_path: str) -> None:
    """``client_threads`` in a process of its own (run by
    ``serve_concurrent``): the bodies come from ``in_path``, the
    responses, latencies and wall time go to ``out_path``."""
    with open(in_path) as f:
        bodies = json.load(f)
    results, lat, wall = client_threads(port, bodies, threads)
    with open(out_path, "w") as f:
        json.dump({"results": results, "lat": lat, "wall": wall}, f)


def serve_concurrent(port: int, bodies, seq, threads: int,
                     own_process: bool) -> tuple:
    """(qps, p50 ms, p99 ms) of ``bodies`` sent as ``_search`` requests
    from ``threads`` client threads, in this process (their JSON and HTTP
    work shares the node's interpreter lock) or in a child process of
    their own; every response must equal the sequential one."""
    import tempfile

    if own_process:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_clients_") as d:
            in_path = os.path.join(d, "bodies.json")
            out_path = os.path.join(d, "out.json")
            with open(in_path, "w") as f:
                json.dump(bodies, f)
            subprocess.run(
                [sys.executable, "-c",
                 "import chip_smoke as cs; cs.client_process_main("
                 f"{port}, {threads}, {in_path!r}, {out_path!r})"],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                check=True, timeout=600)
            with open(out_path) as f:
                out = json.load(f)
        results, lat, wall = out["results"], out["lat"], out["wall"]
    else:
        results, lat, wall = client_threads(port, bodies, threads)
    bad = [i for i, r in enumerate(results)
           if strip_took(r) != seq[i]]
    if bad:
        raise AssertionError(f"serving: concurrent responses {bad[:5]} "
                             "differ from sequential ones")
    return (len(bodies) / wall, float(np.percentile(lat, 50)),
            float(np.percentile(lat, 99)))


def phase_serving(counters) -> dict:
    """Phase 9: the serving node on the card, over HTTP only (see the
    module doc)."""
    import gc
    import shutil
    import tempfile

    import torch

    from opensearch_tpu_torch.node import Node
    from opensearch_tpu_torch.search import engine as engine_mod
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus
    from opensearch_tpu_torch.testing.parity import knn_mismatch

    t_phase = time.monotonic()
    path = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    state = WriteState(corpus.render_texts(SERVE_DOCS, seed=44))
    rng = np.random.default_rng(91)
    match_qs = [{"query": {"match": {"body": f"t{a} t{b}"}}, "size": 10}
                for a, b in corpus.zipf_query_log(200, seed=7)]
    log_qs = [{"query": {"match": {"body": f"t{a} t{b}"}}, "size": 10}
              for a, b in corpus.zipf_query_log(256, seed=7)]
    nodes = []
    for fn in counters.values():                # this path starts here
        fn.launches = 0
    try:
        node = Node(path, port=0, device=DEVICE).start()
        nodes.append(node)
        client = HttpClient(node.port)
        root = client.ok("GET", "/")
        health = client.ok("GET", "/_cluster/health")
        client.ok("PUT", "/corpus", {"settings": {"number_of_shards": 2},
                                     "mappings": WRITE_MAPPING})
        bulk_s, refresh_ms, ops = 0.0, [], 0
        for lo in range(0, SERVE_DOCS, SERVE_BULK):
            t0 = time.monotonic()
            ops += serve_bulk(client, state, rng, lo, lo + SERVE_BULK)
            bulk_s += time.monotonic() - t0
            if (lo + SERVE_BULK) % SERVE_REFRESH_EVERY == 0:
                t0 = time.monotonic()
                client.ok("POST", "/corpus/_refresh")
                refresh_ms.append((time.monotonic() - t0) * 1e3)
        sample = state.sample(rng, SERVE_SAMPLE)
        read = read_back(client, state, sample)
        live = state.live()
        count = client.ok("GET", "/corpus/_count")["count"]
        if count != live:
            raise AssertionError(f"serving: _count {count}, {live} acked "
                                 "live docs")
        svc = node.indices.get("corpus")
        searcher = svc.searcher()
        n_segments = len(searcher.segments)
        reach = sum(any(searcher.ctx.df("body", t)
                        for t in b["query"]["match"]["body"].split())
                    for b in match_qs)
        client.ok("POST", "/corpus/_search", match_qs[0])      # warm-up
        qps, p50, p99, seq_out, per_query = serve_sequential(
            client, match_qs, counters, reach)
        if per_query["term_bag_topk"] != 1.0 or any(
                v for name, v in per_query.items()
                if name != "term_bag_topk"):
            raise AssertionError(f"serving: a match _search must make one "
                                 f"K2 top-k launch and no other: "
                                 f"{per_query}")
        cpu = ShardSearcher(searcher.segments, svc.mapper,
                            index_name="corpus", device="cpu")
        for body, got in zip(match_qs, seq_out):
            want = json.loads(json.dumps(cpu.search(body)))
            if got["hits"] != want["hits"]:
                raise AssertionError(f"serving: {json.dumps(body)} over "
                                     "HTTP differs from the CPU searcher")
        del cpu
        lat = []
        for body in match_qs:
            t0 = time.monotonic()
            svc.search(body)
            lat.append((time.monotonic() - t0) * 1e3)
        inproc_p50 = float(np.percentile(lat, 50))
        # the same bodies through the REST controller in process (the
        # response encoded as the HTTP layer encodes it), and the HTTP
        # floor: a keep-alive round trip of GET /
        lat = []
        for body in match_qs:
            raw = json.dumps(body).encode()
            t0 = time.monotonic()
            status, resp = node.rest.dispatch("POST", "/corpus/_search", {},
                                              raw, "application/json")
            json.dumps(resp)
            lat.append((time.monotonic() - t0) * 1e3)
            if status != 200:
                raise AssertionError(f"serving: dispatch answered {status}")
        dispatch_p50 = float(np.percentile(lat, 50))
        lat = []
        for _ in range(200):
            t0 = time.monotonic()
            client.ok("GET", "/")
            lat.append((time.monotonic() - t0) * 1e3)
        root_p50 = float(np.percentile(lat, 50))
        # _msearch: one K3 launch for the batch of 64
        batch = log_qs[:64]
        seq64 = [strip_took(client.ok("POST", "/corpus/_search", b))
                 for b in batch]
        k3_before = counters["batch_topk"].launches
        lines = []
        for body in batch:
            lines += [{}, body]
        ms = client.ok("POST", "/corpus/_msearch", ndjson=lines)
        k3_msearch = counters["batch_topk"].launches - k3_before
        got64 = [strip_took({k: v for k, v in r.items() if k != "status"})
                 for r in ms["responses"]]
        if k3_msearch != 1 or got64 != seq64:
            raise AssertionError(f"serving: an _msearch of 64 made "
                                 f"{k3_msearch} K3 launches or differs "
                                 "from sequential _search")
        # 16 concurrent clients: the continuous batcher behind the real
        # IndexService (plans compiled by the sequential pass first)
        seq256 = [strip_took(client.ok("POST", "/corpus/_search", b))
                  for b in log_qs]
        eng = engine_mod.query_engine()
        prev = (engine_mod.BATCHER_WINDOW_MS, engine_mod.BATCHER_MAX_BATCH)
        engine_mod.BATCHER_WINDOW_MS, engine_mod.BATCHER_MAX_BATCH = 4.0, 64
        concurrent = {}
        try:
            for where in ("in_process", "own_process"):
                s0 = eng.batcher.stats()
                k3_before = counters["batch_topk"].launches
                c_qps, c_p50, c_p99 = serve_concurrent(
                    node.port, log_qs, seq256, 16,
                    own_process=where == "own_process")
                s1 = eng.batcher.stats()
                groups = s1["dispatches"] - s0["dispatches"]
                batched = s1["batched"] - s0["batched"]
                bypass = s1["bypass"] - s0["bypass"]
                solo = len(log_qs) - batched - bypass
                dispatches = (groups + solo + bypass) / len(log_qs)
                if dispatches >= 1.0 or \
                        counters["batch_topk"].launches - k3_before != groups:
                    raise AssertionError(
                        f"serving: {dispatches} dispatches per query from "
                        f"16 clients {where}, {groups} groups")
                concurrent[where] = {
                    "qps": c_qps, "p50_ms": c_p50, "p99_ms": c_p99,
                    "groups": groups, "batched": batched, "solo": solo,
                    "bypass": bypass, "dispatches_per_query": dispatches}
        finally:
            engine_mod.BATCHER_WINDOW_MS, engine_mod.BATCHER_MAX_BATCH = prev
        # the vectors index: one K1 launch per knn _search
        client.ok("PUT", "/vectors", {"mappings": {"properties": {
            "vec": {"type": "knn_vector", "dimension": DIM,
                    "space_type": "l2"}}}})
        vecs = corpus.random_vectors(SERVE_VECTORS, DIM, seed=45)
        t0 = time.monotonic()
        for lo in range(0, SERVE_VECTORS, SERVE_BULK):
            items = []
            for i in range(lo, lo + SERVE_BULK):
                items += [{"index": {"_index": "vectors", "_id": f"v{i}"}},
                          {"vec": vecs[i].tolist()}]
            if client.ok("POST", "/_bulk", ndjson=items)["errors"]:
                raise AssertionError("serving: a vectors _bulk item failed")
        client.ok("POST", "/vectors/_refresh")
        vec_bulk_s = time.monotonic() - t0
        vsvc = node.indices.get("vectors")
        vcpu = ShardSearcher(vsvc.searcher().segments, vsvc.mapper,
                             index_name="vectors", device="cpu")
        knn_qs = [{"query": {"knn": {"vec": {"vector": q.tolist(),
                                             "k": 10}}}, "size": 10}
                  for q in corpus.random_vectors(50, DIM, seed=46)]
        k1_before = counters["knn_topk"].launches
        knn_lat, knn_out = [], []
        for body in knn_qs:
            t0 = time.monotonic()
            knn_out.append(client.ok("POST", "/vectors/_search", body))
            knn_lat.append((time.monotonic() - t0) * 1e3)
        k1_per_query = (counters["knn_topk"].launches - k1_before) / len(
            knn_qs)
        if k1_per_query != 1.0:
            raise AssertionError(f"serving: {k1_per_query} K1 launches per "
                                 "knn _search")
        for body, got in zip(knn_qs, knn_out):
            bad = knn_mismatch(got, json.loads(json.dumps(vcpu.search(body))))
            if bad:
                raise AssertionError(f"serving: knn over HTTP: {bad}")
        del vcpu
        multi = client.ok("GET", "/corpus,vectors/_search",
                          {"query": {"match_all": {}}, "size": 5})
        if multi["hits"]["total"]["value"] != live + SERVE_VECTORS or \
                multi["_shards"]["total"] != 3:
            raise AssertionError(f"serving: multi-index search answered "
                                 f"{json.dumps(multi)[:200]}")
        aggs = client.call("POST", "/corpus/_search", {
            "size": 0, "aggs": {"t": {"terms": {"field": "tag"}}}})
        missing = client.call("GET", "/missing/_search")
        if aggs[0] != 501 or \
                aggs[1]["error"]["type"] != "not_yet_ported_exception" or \
                missing[0] != 404 or missing[1] != {
                    "error": {"root_cause": [{
                        "type": "index_not_found_exception",
                        "reason": "no such index [missing]"}],
                        "type": "index_not_found_exception",
                        "reason": "no such index [missing]",
                        "metadata": {"index": "missing"}},
                    "status": 404}:
            raise AssertionError(f"serving: aggs answered {aggs}, a "
                                 f"missing index {missing}")
        # merge, flush, delete the vectors index
        del searcher
        t0 = time.monotonic()
        client.ok("POST", "/corpus/_forcemerge?max_num_segments=1")
        merge_s = time.monotonic() - t0
        client.ok("POST", "/corpus/_flush")
        keep = match_qs[:20]
        before_restart = [strip_took(client.ok("POST", "/corpus/_search",
                                               b)) for b in keep]
        resident_vectors = vsvc.searcher().resident_bytes()
        del vsvc
        gc.collect()
        torch.cuda.synchronize()
        bytes_before = device_allocated()
        client.ok("DELETE", "/vectors")
        gc.collect()
        bytes_after = device_allocated()
        if bytes_after > bytes_before - resident_vectors:
            raise AssertionError(
                f"serving: {bytes_after} device bytes after DELETE "
                f"/vectors, more than {bytes_before} before it less the "
                f"index's {resident_vectors} resident")
        client.close()
        # restart on the same data path
        del svc
        t0 = time.monotonic()
        node.stop()
        node = Node(path, port=0, device=DEVICE).start()
        nodes.append(node)
        restart_s = time.monotonic() - t0
        client = HttpClient(node.port)
        t0 = time.monotonic()
        first = client.ok("POST", "/corpus/_search", keep[0])
        first_ms = (time.monotonic() - t0) * 1e3
        after_restart = [strip_took(first)] + [
            strip_took(client.ok("POST", "/corpus/_search", b))
            for b in keep[1:]]
        if after_restart != before_restart:
            raise AssertionError("serving: _search after the restart "
                                 "differs from before it")
        if client.call("HEAD", "/vectors")[0] != 404 or \
                sorted(node.indices.indices) != ["corpus"]:
            raise AssertionError("serving: the deleted index came back")
        if client.ok("GET", "/corpus/_count")["count"] != live:
            raise AssertionError("serving: _count changed across the "
                                 "restart")
        read += read_back(client, state, sample)
        client.close()
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        for n in nodes:
            n.stop()
        shutil.rmtree(path, ignore_errors=True)
    if min(launches[n] for n in ("term_bag_topk", "batch_topk",
                                 "knn_topk")) <= 0:
        raise AssertionError(f"serving: a kernel never launched: {launches}")
    gpu = gpu_name_power()
    out = {
        "docs": SERVE_DOCS, "shards": 2, "bulk_ops": ops,
        "bulk_ops_per_s": ops / bulk_s, "bulk_s": bulk_s,
        "refresh_ms": refresh_ms, "nrt_segments": n_segments,
        "live_docs": live, "gets_read_back": read,
        "create_conflicts": state.conflicts,
        "updated": len(state.updated), "deleted": len(state.deleted),
        "match_qps": qps, "match_p50_ms": p50, "match_p99_ms": p99,
        "match_inprocess_p50_ms": inproc_p50,
        "match_dispatch_p50_ms": dispatch_p50,
        "get_root_p50_ms": root_p50,
        "rest_http_p50_ms": p50 - inproc_p50,
        "launches_per_match": per_query, "msearch_k3_launches": k3_msearch,
        "concurrent_16": concurrent,
        "vectors": SERVE_VECTORS, "vectors_bulk_s": vec_bulk_s,
        "knn_p50_ms": float(np.percentile(knn_lat, 50)),
        "k1_launches_per_knn": k1_per_query,
        "merge_s": merge_s,
        "device_bytes_before_delete": bytes_before,
        "device_bytes_after_delete": bytes_after,
        "vectors_resident_bytes": resident_vectors,
        "restart_s": restart_s, "first_search_after_restart_ms": first_ms,
        "version": root["version"]["number"],
        "health": health["status"], "launches": launches,
        "wall_s": time.monotonic() - t_phase}
    log(f"serving: node on {DEVICE}, {SERVE_DOCS} docs in "
        f"{SERVE_DOCS // SERVE_BULK} _bulk requests of {SERVE_BULK} into "
        f"2 shards ({ops} ops, one translog sync each) at "
        f"{out['bulk_ops_per_s']:.1f} ops/s with {len(state.updated)} "
        f"updates, {len(state.deleted)} deletes and {state.conflicts} "
        f"refused create; refresh ms {[round(x, 1) for x in refresh_ms]}; "
        f"{read} acked docs read back by GET (before and after the "
        f"restart); _count {live}; match _search over HTTP ({n_segments} "
        f"segments): qps {qps:.2f}, p50 {p50:.3f} ms, p99 {p99:.3f} ms "
        f"(IndexService.search in process p50 {inproc_p50:.3f} ms, the "
        f"REST controller's dispatch and encode in process p50 "
        f"{dispatch_p50:.3f} ms, a keep-alive GET / p50 {root_p50:.3f} ms; "
        f"so REST + HTTP {p50 - inproc_p50:.3f} ms), launches per match "
        f"{per_query}, equal to the CPU searcher; _msearch of 64: "
        f"{k3_msearch} K3 launch, equal to sequential; 16 clients "
        + "; ".join(
            f"{where}: qps {c['qps']:.2f}, p50 {c['p50_ms']:.3f} ms, p99 "
            f"{c['p99_ms']:.3f} ms, {c['groups']} groups, "
            f"{c['dispatches_per_query']:.4f} dispatches per query"
            for where, c in concurrent.items())
        + ", equal to sequential; "
        f"vectors: {SERVE_VECTORS} docs by _bulk in {vec_bulk_s:.2f} s, "
        f"knn p50 {out['knn_p50_ms']:.3f} ms, {k1_per_query:.2f} K1 "
        f"launches per knn _search, within tolerance of the CPU; aggs "
        f"501, missing index 404; _forcemerge {merge_s:.2f} s; device "
        f"bytes {bytes_before} before DELETE /vectors, {bytes_after} after "
        f"(index resident {resident_vectors}); restart {restart_s:.2f} s, "
        f"first _search {first_ms:.1f} ms, 20 responses equal to before; "
        f"launches {launches}; on {gpu}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from opensearch_tpu_torch.ops import cuda_bm25, cuda_knn
    from opensearch_tpu_torch.testing.corpus import zipf_query_log

    t_start = time.monotonic()
    phase_toolkit()
    segs, mapper, searcher, raw = build_scale()
    quant = {dtype: build_quantized(raw, mapper, dtype)
             for dtype in ("int8", "int16")}
    del raw
    kern = phase_kernels(segs, searcher, zipf_query_log(200, seed=7))
    kern["term_bag_quantized"] = phase_quantized_kernels(
        quant, segs, searcher, zipf_query_log(200, seed=7))

    counters = {"knn_topk": cuda_knn.knn_topk_segments_cuda,
                "knn_scores": cuda_knn.knn_scores_cuda,
                "term_bag_scores": cuda_bm25.term_bag_cuda,
                "term_bag_topk": cuda_bm25.term_bag_topk_segments_cuda,
                "batch_topk": cuda_bm25.batch_term_bag_topk_cuda}
    for fn in counters.values():              # the main path starts here
        fn.launches = 0
    phase_ingest()
    after_ingest = {n: fn.launches for n, fn in counters.items()}
    scale = phase_scale(segs, mapper, searcher)
    launches = {n: fn.launches for n, fn in counters.items()}
    log(f"launches over phases 3-4: {launches} (ingest {after_ingest})")
    sequential_path = [n for n in counters if n != "batch_topk"]
    if min(launches[n] for n in sequential_path) <= 0 or \
            min(after_ingest[n] for n in sequential_path) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches} (ingest {after_ingest})")
    # the batched path: msearch, then the continuous batcher, each with
    # the counts zeroed just before it and read just after
    bodies = [match_body(a, b) for a, b in zipf_query_log(256, seed=7)]
    msearch = phase_msearch(searcher, bodies, counters)
    continuous = phase_continuous(searcher, bodies, msearch.pop("seq"),
                                  counters)
    launches["batch_topk"] = (msearch["launches"]["batch_topk"]
                              + continuous["launches"]["batch_topk"])
    # the quantized path, its counts zeroed just before it
    qsegs, qsearcher, qbuild = quant["int8"]
    qscale = phase_quantized_scale(qsegs, mapper, qsearcher, qbuild,
                                   {**counters, **quantized_counters()})
    launches["term_bag_quantized"] = \
        qscale["k4_launches"]["term_bag_quantized_topk"]
    launches["term_bag_quantized_scores"] = \
        qscale["k4_launches"]["term_bag_quantized_scores"]
    kern["term_bag_quantized_scores"] = kern["term_bag_quantized"].pop(
        "per_slot")
    # the write path, then the serving node, each with its counts zeroed
    # just before it and read just after
    write = phase_write_path({**counters, **quantized_counters()})
    serving = phase_serving({**counters, **quantized_counters()})
    for phase in (write, serving):
        for name, n in phase["launches"].items():
            name = "term_bag_quantized" \
                if name == "term_bag_quantized_topk" else name
            launches[name] += n
    sources = {"knn_topk": ("knn.cu", "opensearch_tpu/ops/pallas_knn.py:62"),
               "knn_scores": ("knn.cu",
                              "opensearch_tpu/ops/pallas_knn.py:62"),
               "term_bag_scores": ("bm25.cu",
                                   "opensearch_tpu/ops/bm25.py:191"),
               "term_bag_topk": ("bm25.cu",
                                 "opensearch_tpu/search/plan.py:1760"),
               "batch_topk": ("union_topk.cu",
                              "opensearch_tpu/search/batch.py:69"),
               # and gather_postings_packed, opensearch_tpu/ops/bm25.py:114
               "term_bag_quantized": ("quant_topk.cu",
                                      "opensearch_tpu/ops/quantized.py:46"),
               "term_bag_quantized_scores": (
                   "bm25.cu", "opensearch_tpu/ops/quantized.py:64")}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"opensearch_tpu_torch/csrc/{src}", "replaces": rep,
         "launches": launches[name],
         **{key: kern[name][key] for key in keys}}
        for name, (src, rep) in sources.items()]}
    log(json.dumps({"scale": scale, "msearch": msearch,
                    "continuous": continuous, "quantized_scale": qscale,
                    "write_path": write, "serving": serving,
                    "k1_1m": kern["k1_1m"],
                    "k2_topk_heaviest": kern["term_bag_topk"]["heaviest"],
                    "k4_topk_heaviest":
                        kern["term_bag_quantized"]["heaviest"],
                    "k3_k100": kern["batch_topk"]["k100"],
                    "device_ms": {n: kern[n].get("device_ms")
                                  for n in sources},
                    "wall_s": time.monotonic() - t_start}))
    log(json.dumps(kernels))
    log(gpu_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
