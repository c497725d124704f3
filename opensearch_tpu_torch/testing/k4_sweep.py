"""K4's top-k kernel on the card: its tile size, where its time goes,
against the route it replaced and against K2 over the dequantized
column.

    python3 -m opensearch_tpu_torch.testing.k4_sweep

Builds phase 7's shard of ``chip_smoke.py`` (the 1M-doc scale corpus in
8 segments of 125,000, which the port quantizes) with int8 and with
int16 codes, and takes seven bags of each: of its ``match`` query log
(``zipf_query_log(200, seed=7)``) the median and the heaviest (by
postings in the first segment), a 4-term bag, the heaviest as an ``and``
bag and the code-dominated bag (the median of the bags none of whose
terms the parity guard kept exact: under int8 codes the log's all-coded
bags are few and short); the code-heavy bag, the ``CODE_TERMS`` terms
the guard left coded in every segment with the most postings (the
codes' path at the most volume a ``match`` reads them); and the term of
the first segment with the most postings there that some other segment
lacks (a block of that segment has no slot).  Prints ptxas' register
and spill lines of ``csrc/bm25.cu`` and of ``csrc/quant_topk.cu`` at
each tile size of ``TILES``; checks K4 at each tile size (at
``TILE_DOCS`` through its wrapper ``term_bag_topk_quantized_cuda``, at
the others through a library and a table of that tile size built here),
the replaced route (K2's top-k kernel instantiated over ``QuantRows``,
``csrc/bm25.cu``, kept here only as the yardstick: no path of the port
routes to it) and K2 over the same segments' ``dequantized()`` column
staged as f32 against the plain twin, byte for byte, at k = 10, 100 and
``K_MAX``; and times them at k = 10 and 100, in turns in the same call,
as each kernel's own device milliseconds per call under
``torch.profiler``, the lower of two readings, beside the byte bound.
One JSON line per (codes, bag, k).  Then, from ``-DQUANT_PHASES``
builds, where a K4 block's cycles go (``csrc/phases.cuh``) at each tile
size on the median, heaviest, code-dominated and code-heavy bags, at
k = 10 and 100; and the card's name and power limit.  Needs CUDA;
without it, exits non-zero.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from opensearch_tpu_torch.testing.profile_scale import (_device_self_us,
                                                        _is_device)

KS = (10, 100)
TILES = (2048, 4096, 8192)       # K4's candidate tile sizes
SEGMENTS = 8
REPS = 20
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
PHASES = ("start", "search", "copy_wait", "scatter", "keys", "select",
          "post_merge")
# terms of the code-heavy bag: as many as OpenSearch's more_like_this
# query sends by default (max_query_terms 25)
CODE_TERMS = 25
PHASE_BAGS = ("median", "heaviest", "code-dominated", "code-heavy")
NEW_KERNEL = "quant_topk_kernel"
OLD_KERNEL = "QuantRows"
K2_KERNEL = "F32Rows"


def kernel_ms(fn, name: str, reps: int = REPS, tries: int = 3) -> float:
    """Device milliseconds per call of the kernels whose name holds
    ``name`` (one launch a call), over ``reps`` calls of ``fn`` under
    ``torch.profiler`` after a warm-up call.  A reading in which the
    profiler kept another count of such launches is taken again."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if _is_device(e) and name in e.key]
        count = sum(e.count for e in hits)
        if count == reps:
            return sum(_device_self_us(e) for e in hits) / 1e3 / reps
    raise AssertionError(f"the profiler kept {count} of {reps} launches of "
                         f"{name}")


# -- the shard ------------------------------------------------------------------

def quantized_shard(raw, mapper, dtype: str, dev):
    """``raw`` in ``SEGMENTS`` segments of 125,000 docs, quantized with
    ``dtype`` codes and staged: ``(segments, searcher)``."""
    from opensearch_tpu_torch.index import codec
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus

    segs = corpus.make_segments(raw, SEGMENTS)
    searcher = ShardSearcher(segs, mapper, index_name=f"k4_{dtype}",
                             device=dev)
    avgdl = searcher.ctx.field_stats("body").avgdl
    prev = codec.QUANTIZED_DTYPE
    codec.QUANTIZED_DTYPE = dtype
    try:
        for seg in segs:
            seg.quantized_table("body", avgdl)
    finally:
        codec.QUANTIZED_DTYPE = prev
    for seg in segs:
        dseg = seg.device(searcher.device)
        if not dseg.quantized_mode:
            raise AssertionError("a 125,000-doc segment is not quantized")
        dseg.quantized("body", avgdl)
    return segs, searcher


def topk_inputs(searcher, terms, **extra) -> list:
    """Each segment's ``TermBagSegment`` of the ``match`` bag ``terms``,
    as the searcher's one top-k call builds them."""
    from opensearch_tpu_torch.search.executor import build_arrays

    plan, bind = searcher.compiled(
        {"match": {"body": {"query": " ".join(terms), **extra}}})
    out = []
    for seg in searcher.segments:
        dseg = seg.device(searcher.device)
        A = build_arrays(dseg, plan.arrays(), searcher.mapper,
                         live=searcher.ctx.live_mask(seg, dseg),
                         partial_ok=plan.arrays())
        out.append(plan.topk_input(bind, seg, dseg, A))
    return out


def pick_bags(searcher, pairs) -> dict:
    """The seven bags of the docstring, each a list of terms (and the
    ``and`` flag)."""
    avgdl = searcher.ctx.field_stats("body").avgdl
    segs = searcher.segments
    pf0 = segs[0].postings["body"]
    exact = [np.diff(seg.quantized_table("body", avgdl).exact_offsets)
             for seg in segs]

    def postings(terms):
        return sum(int(pf0.df[pf0.term_id(t)]) for t in terms
                   if pf0.term_id(t) >= 0)

    def guarded(terms):
        for seg, ex in zip(segs, exact):
            pf = seg.postings["body"]
            if any(pf.term_id(t) >= 0 and ex[pf.term_id(t)] > 0
                   for t in terms):
                return True
        return False

    bags = sorted(([f"t{a}", f"t{b}"] if a != b else [f"t{a}"]
                   for a, b in pairs), key=postings)
    coded = [b for b in bags if not guarded(b)]
    total = {}
    for seg, ex in zip(segs, exact):
        pf = seg.postings["body"]
        for t, tid in pf.terms.items():
            if ex[tid] > 0:
                total[t] = -1
            elif total.get(t, 0) >= 0:
                total[t] = total.get(t, 0) + int(pf.df[tid])
    code_heavy = sorted((t for t in total if total[t] > 0),
                        key=lambda t: (-total[t], t))[:CODE_TERMS]
    present = [set(seg.postings["body"].terms) for seg in segs[1:]]
    absent = min((t for t in pf0.terms if not all(t in p for p in present)),
                 key=lambda t: (-int(pf0.df[pf0.term_id(t)]), t))
    return {"median": (bags[len(bags) // 2], False),
            "heaviest": (bags[-1], False),
            "4-term": (bags[len(bags) // 4] + bags[-2], False),
            "and": (bags[-1], True),
            "code-dominated": (coded[len(coded) // 2], False),
            "code-heavy": (code_heavy, False),
            "absent from a segment": ([absent], False)}


def as_f32(inputs, searcher) -> list:
    """``inputs`` over the same segments' ``dequantized()`` column and
    doc ids staged as f32 (here only: the segments stay quantized)."""
    from opensearch_tpu_torch.index.segment import pad_pow2

    avgdl = searcher.ctx.field_stats("body").avgdl
    out = []
    for inp, seg in zip(inputs, searcher.segments):
        pf = seg.postings["body"]
        p_pad = pad_pow2(len(pf.doc_ids))
        ids = np.full(p_pad, seg.n_docs, np.int32)
        ids[: len(pf.doc_ids)] = pf.doc_ids
        deq = np.zeros(p_pad, np.float32)
        deq[: len(pf.doc_ids)] = seg.quantized_table("body",
                                                     avgdl).dequantized()
        dev = inp.live.device
        out.append(inp._replace(doc_ids=torch.from_numpy(ids).to(dev),
                                impacts=torch.from_numpy(deq).to(dev),
                                quant=None))
    return out


def bound(inputs, k: int) -> tuple[float, float]:
    """(bytes, ms) the call must move: per active posting width / 8
    bytes of packed delta and its code or its exact f32 value, per
    segment one live byte a doc and the k results, total and max."""
    nbytes = 0.0
    for seg in inputs:
        q = seg.quant
        act = seg.active
        for (a, b), ex in zip(seg.rows[act], q.slot_exact[act]):
            nbytes += int(b - a) * (q.width / 8 + (
                4 if ex >= 0 else q.qvals.element_size()))
        nbytes += seg.live.shape[0] + 8 * k + 8
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


# -- launches outside the wrapper ----------------------------------------------

def k4_defines(tile: int, phases: bool = False) -> dict:
    """``csrc/quant_topk.cu``'s macros at tiles of ``tile`` docs (with the
    ``-DQUANT_PHASES`` marks)."""
    from opensearch_tpu_torch.ops import cuda_bm25

    return {**cuda_bm25.quant_defines(), "QUANT_TILE_DOCS": tile,
            **({"QUANT_PHASES": 1} if phases else {})}


def k4_library(tile: int, phases: bool = False):
    from opensearch_tpu_torch.ops import cuda_bm25, cuda_build

    def declare(lib):
        cuda_bm25._quant_declare(lib)
        if phases:
            lib.quant_phases.argtypes = [ctypes.c_void_p]
            lib.quant_phases.restype = ctypes.c_int

    return cuda_build.library("quant_topk", declare, k4_defines(tile, phases))


def retile(table: np.ndarray, n_seg: int, n_slots: int,
           tile: int) -> tuple[np.ndarray, int]:
    """A quantized ``segments_table`` (tiles of ``TILE_DOCS`` docs) laid
    out for tiles of ``tile`` docs: each segment's first tile and tile
    count, the work list and the zeros after it.  ``(table, blocks)``."""
    from opensearch_tpu_torch.ops import cuda_bm25

    w = cuda_bm25.QSEG_WORDS
    head = table[: n_seg * w].reshape(n_seg, w).copy()
    tiles = np.maximum(1, -(-head[:, 3] // tile))
    first = np.concatenate([[0], np.cumsum(tiles)])
    head[:, 4], head[:, 5] = first[:-1], tiles
    n_blocks = int(first[-1])
    seg_of = np.repeat(np.arange(n_seg, dtype=np.int64), tiles)
    tile_of = np.arange(n_blocks, dtype=np.int64) - first[:-1][seg_of]
    slots = table[n_seg * w: n_seg * w + cuda_bm25.QSLOT_WORDS * n_slots]
    return np.concatenate([head.ravel(), slots, (seg_of << 32) | tile_of,
                           np.zeros((3 * n_seg + 1) // 2, np.int64)]), n_blocks


def launch(lib, entry: str, inputs, k: int, tile: int):
    """One launch of ``lib.<entry>`` (``quant_topk_launch``, or the
    replaced route's ``term_bag_topk_quantized_launch``, which share one
    signature) over ``inputs``, all quantized with one code dtype, in a
    table of tiles of ``tile`` docs."""
    from opensearch_tpu_torch.ops import bm25, cuda_bm25, cuda_build

    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_float] + [ctypes.c_void_p] * 5 + [ctypes.c_int,
                                                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = inputs[0].live.device
    kp = cuda_bm25.k_padded(k)
    table, n_blocks, n_slots = cuda_bm25.segments_table(inputs)
    if tile != cuda_bm25.TILE_DOCS:
        table, n_blocks = retile(table, len(inputs), n_slots, tile)
    table_dev = torch.from_numpy(table).pin_memory().to(dev,
                                                        non_blocking=True)
    scratch = torch.empty(n_blocks * kp, dtype=torch.int64, device=dev)
    out = bm25.empty_topk(len(inputs), k, dev)
    p = cuda_bm25._ptr
    rc = fn(
        p(table_dev), len(inputs), n_slots, n_blocks, k, kp, -np.inf,
        p(out.vals), p(out.ids), p(out.totals), p(out.maxes), p(scratch),
        inputs[0].quant.qvals.element_size(),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    cuda_build.check(lib, rc, entry)
    return out._replace(keep=(table_dev, scratch))


def old_route(inputs, k: int):
    """One launch of K2's top-k kernel instantiated over ``QuantRows``
    (``csrc/bm25.cu`` ``term_bag_topk_quantized_launch``): the route K4's
    top-k entry took before it had its own kernel."""
    from opensearch_tpu_torch.ops import cuda_bm25

    return launch(cuda_bm25._library(), "term_bag_topk_quantized_launch",
                  inputs, k, cuda_bm25.TILE_DOCS)


# -- phases -----------------------------------------------------------------------

def phase_cycles(run, lib, blocks: int) -> dict:
    """SM cycles per block in each phase of one ``run()`` (a launch of a
    ``-DQUANT_PHASES`` build ``lib``): thread 0 of each block adds the
    cycles between its marks; the post and the merge are summed over all
    blocks (the merge runs in the last block of each segment); scatter
    also per scattered slot."""
    from opensearch_tpu_torch.ops import cuda_build

    out = (ctypes.c_ulonglong * 8)()
    for _ in range(2):          # the second run's sums, from zero
        run()
        torch.cuda.synchronize()
        cuda_build.check(lib, lib.quant_phases(
            ctypes.cast(out, ctypes.c_void_p)), "quant_phases")
    per_block = {n: int(out[i]) // blocks for i, n in enumerate(PHASES)}
    per_block["total"] = sum(per_block.values())
    slots = int(out[7])
    return {"blocks": blocks, "slots_scattered": slots,
            "scatter_per_slot": int(out[3]) // max(slots, 1),
            "cycles_per_block": per_block}


def print_ptxas(logs: dict, label: str) -> None:
    for name, text in logs.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                print(f"ptxas {name} {label}: {line.strip()}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_sweep: CUDA is not available", file=sys.stderr)
        return 1
    from opensearch_tpu_torch.mapping.mapper import DocumentMapper
    from opensearch_tpu_torch.ops import bm25, cuda_bm25, cuda_build
    from opensearch_tpu_torch.testing import corpus

    dev = torch.device("cuda")
    print_ptxas(cuda_build.build(["bm25"], {"bm25": cuda_bm25.defines()}),
                "")
    for tile in TILES:
        print_ptxas(cuda_build.build(["quant_topk"],
                                     {"quant_topk": k4_defines(tile)}),
                    f"tile {tile}")
    raw = corpus.build_raw_corpus(1_000_000, seed=42)
    mapper = DocumentMapper({"properties": {"body": {"type": "text"}}})
    shards = {dtype: quantized_shard(raw, mapper, dtype, dev)
              for dtype in ("int8", "int16")}
    del raw
    log = corpus.zipf_query_log(200, seed=7)
    bags = {dtype: pick_bags(searcher, log)
            for dtype, (_segs, searcher) in shards.items()}
    print(json.dumps({"bags": {dtype: {n: b for n, (b, _and) in got.items()}
                               for dtype, got in bags.items()}}), flush=True)
    inputs = {}
    for dtype, (_segs, searcher) in shards.items():
        for name, (terms, conj) in bags[dtype].items():
            extra = {"operator": "and"} if conj else {}
            inp = topk_inputs(searcher, terms, **extra)
            inputs[dtype, name] = (inp, as_f32(inp, searcher))
    if all(np.asarray(s.active).any()
           for s in inputs["int8", "absent from a segment"][0]):
        raise AssertionError("the absent term's bag has a slot in every "
                             "segment")
    k2 = cuda_bm25.term_bag_topk_segments_cuda
    k4 = cuda_bm25.term_bag_topk_quantized_cuda

    def same(got, ref):
        return all(a.tobytes() == b.tobytes()
                   for a, b in zip(got.numpy(), ref.numpy()))

    def routes(inp, f32, k):
        """(key, call, kernel name) of every route, K4 at each tile."""
        out = []
        for tile in TILES:
            if tile == cuda_bm25.TILE_DOCS:
                def new():
                    return k4(inp, k=k)
            else:
                def new(lib=k4_library(tile), tile=tile):
                    return launch(lib, "quant_topk_launch", inp, k, tile)
            out.append((f"k4_t{tile}_ms", new, NEW_KERNEL))
        return out + [("old_ms", lambda: old_route(inp, k), OLD_KERNEL),
                      ("k2_dequantized_ms", lambda: k2(f32, k=k),
                       K2_KERNEL)]

    for (dtype, name), (inp, f32) in inputs.items():
        for k in (*KS, cuda_bm25.K_MAX):
            ref = bm25.term_bag_topk_segments(inp, k=k)
            for key, fn, _kname in routes(inp, f32, k):
                if not same(fn(), ref):
                    raise AssertionError(f"{key[:-3]} {dtype} {name} k={k}: "
                                         "differs from the plain twin")
        for k in KS:
            nbytes, bms = bound(inp, k)
            lens = [s.rows[s.active, 1] - s.rows[s.active, 0] for s in inp]
            row = {"codes": dtype, "bag": name, "k": k,
                   "postings": int(sum(int(n.sum()) for n in lens)),
                   "exact_postings": int(sum(
                       int(n[s.quant.slot_exact[s.active] >= 0].sum())
                       for n, s in zip(lens, inp))),
                   "bound_bytes": nbytes, "bound_ms": bms}
            for _turn in range(2):
                for key, fn, kname in routes(inp, f32, k):
                    ms = kernel_ms(fn, kname)
                    row[key] = min(row.get(key, ms), ms)
            print(json.dumps(row), flush=True)
    for tile in TILES:
        lib = k4_library(tile, phases=True)
        for dtype in ("int8", "int16"):
            for name in PHASE_BAGS:
                inp = inputs[dtype, name][0]
                blocks = sum(max(1, -(-s.live.shape[0] // tile)) for s in inp)
                for k in KS:
                    def run(lib=lib, inp=inp, k=k, tile=tile):
                        return launch(lib, "quant_topk_launch", inp, k, tile)
                    print(json.dumps({"phases": {
                        "codes": dtype, "bag": name, "k": k, "tile": tile,
                        **phase_cycles(run, lib, blocks)}}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
