"""K8 and K9, the phrase and span kernels, at ``chip_smoke.py`` phase
14's shape on the card: device time per request, ms per request, the
host's time per request by part, and phrase latencies through the
searcher.

    python3 -m opensearch_tpu_torch.testing.k8_sweep [--device cpu --docs D --segments S]
    python3 opensearch_tpu_torch/testing/k8_sweep.py --turn [--split] [--root DIR] [--label NAME]

Builds the scale corpus (``testing/corpus.py``: 1,000,000 docs in 16
segments, with positions; ``--docs`` / ``--segments`` cut it for a
rehearsal on the CPU) and a ``ShardSearcher`` over it on the card.

- ``--turn``: each case of ``CASES`` (the phrase "t0 t0", the unordered
  span [t0, t1] slop 2, a 3-term phrase of the log and a
  ``match_phrase_prefix``, over the 16 segments and, for the first two,
  over one), run as the executor runs a request's positional work:
  the segments' prepared inputs made once, then ``dense_prepass`` and
  each segment's ``plan.eval``.  Per case: device ms of the K8 / K9
  kernels and of every kernel under ``torch.profiler`` (the lower of
  two windows), CUDA-event ms and host (enqueue) ms per request, K8 /
  K9 kernels a request, and a digest of the scores and matched masks
  (equal across trees when both answer alike).  Then ``P50_KINDS``
  through ``searcher.search``, each body twice: p50 of the first and of
  the second sight, and K8 / K9 launches a request.  ``--root`` puts
  DIR's ``opensearch_tpu_torch`` first on the path (by default this
  file's tree), so the same script times another tree (a parent commit
  unpacked by ``git archive`` into the gitignored ``build/archive/``):
  run parent, change, change, parent in one chip call.  With
  ``--split``, the host split below too.
- Otherwise: ``--turn``'s readings; on a tree with the request-wide
  kernels, "t0 t0" and [t0, t1] over the 16 segments again through
  libraries built with other ``VARIANTS`` of ``CHUNK`` / ``THREADS``
  (every variant built at once, one ``nvcc`` each; each checked against
  the default build's answer by digest) and the ``-DQUANT_PHASES`` split
  of their blocks' cycles (``csrc/phases.cuh``); then the host split of
  phase 14's
  first ``SPLIT_BODIES`` ``match_phrase`` bodies and of "t0 t0" over the
  16 segments, by part: compile, the plan's prepare (``_evaluated``
  without the prepared-inputs cache: a first sight), then the parts of
  the tree's positional route (this tree: the job table, its upload
  from the pinned arena, the output's memset, the launch, the views and
  the plans' evals; a tree with one launch per segment: the slot table
  and its pinned copy, the zeroing, the launch, the scoring ops), and
  the plan top-k with its read-back.  Host ms a request by part (no
  sync inside a part), then ms a request with a sync after the route.

Prints one JSON line per reading, and the card's name and power limit.
Needs CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REPS = 20
SPLIT_REPS = 10
SPLIT_BODIES = 10
P50_KINDS = {"phrase": 40, "phrase_t0": 10, "phrase_prefix": 10,
             "span_unordered": 10}
# (anchor positions a block owns, threads a block, blocks an SM should
# hold) of the variant builds (a slot window's tile: the larger of the
# positions and ``TILE_IDS``)
VARIANTS = ((1024, 256, 1), (1024, 256, 8), (512, 128, 12), (512, 128, 16),
            (2048, 512, 3), (2048, 256, 3))
PHASES = ("job", "entry window", "positions' wait", "thread setup",
          "windows and intersection", "merge walks", "counts", "writes")


def gpu_name_power(dev) -> str:
    if dev.type != "cuda":
        return "cpu (no device numbers)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def build(n_docs: int, n_segments: int, dev):
    """(segments, searcher) of the scale corpus with every segment's
    positions staged."""
    from opensearch_tpu_torch.mapping.mapper import DocumentMapper
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing import corpus

    raw = corpus.build_raw_corpus(n_docs, seed=42)
    segs = corpus.make_segments(raw, n_segments)
    mapper = DocumentMapper({"properties": {"body": {"type": "text"}}})
    searcher = ShardSearcher(segs, mapper, index_name="scale", device=dev)
    for seg in segs:
        seg.device(searcher.device).ensure_positions("body")
    sync(dev)
    return segs, searcher


def text(run) -> str:
    return " ".join(f"t{t}" for t in run)


def near(terms, slop: int, ordered: bool) -> dict:
    return {"span_near": {"clauses": [
        {"span_term": {"body": f"t{t}"}} for t in terms],
        "slop": int(slop), "in_order": ordered}}


def cases(n_docs: int) -> list:
    """(name, query, one segment only) of the timed cases."""
    from opensearch_tpu_torch.testing import corpus

    runs = corpus.phrase_query_log(200, seed=41, n_docs=n_docs)
    three = [r for r in runs if len(r) == 3][0]
    t0t0 = {"match_phrase": {"body": "t0 t0"}}
    span = near((0, 1), 2, False)
    return [("phrase t0 t0", t0t0, False), ("phrase t0 t0", t0t0, True),
            ("span unordered t0 t1 slop 2", span, False),
            ("span unordered t0 t1 slop 2", span, True),
            (f"phrase {text(three)}", {"match_phrase": {"body":
                                                        text(three)}},
             False),
            ("match_phrase_prefix t1 t",
             {"match_phrase_prefix": {"body": {"query": "t1 t",
                                               "max_expansions": 10}}},
             False)]


def p50_bodies(n_docs: int) -> dict:
    """Phase 14's kinds, cut to ``P50_KINDS``, from the same draws."""
    from opensearch_tpu_torch.testing import corpus

    runs = corpus.phrase_query_log(400, seed=45, n_docs=n_docs)
    short = [r for r in runs if len(r) <= 3]
    longer = [r for r in runs if len(r) >= 3]
    on_t0 = [r for r in corpus.phrase_query_log(
        400, seed=46, n_docs=n_docs, lengths=(2, 3)) if r[0] == 0]

    def body(q):
        return {"query": q, "size": 10, "_source": False}

    return {
        "phrase": [body({"match_phrase": {"body": text(r)}})
                   for r in short[:P50_KINDS["phrase"]]],
        "phrase_t0": [body({"match_phrase": {"body": text(r)}})
                      for r in on_t0[:P50_KINDS["phrase_t0"]]],
        "phrase_prefix": [body({"match_phrase_prefix": {"body": {
            "query": text(r), "max_expansions": 10}}})
            for r in short[100: 100 + P50_KINDS["phrase_prefix"]]],
        "span_unordered": [body(near((r[-1], r[0]), len(r) - 2, False))
                           for r in longer[20: 20 + P50_KINDS[
                               "span_unordered"]]],
    }


def counters():
    """The tree's K8 and K9 launch counters."""
    from opensearch_tpu_torch.ops import cuda_positions as cp
    if hasattr(cp, "phrase_scores_cuda"):
        return cp.phrase_scores_cuda, cp.span_scores_cuda
    return cp.phrase_freqs_cuda, cp.span_near_cuda


def request_work(searcher, query, segs):
    """``run()``: the positional work of ``query`` over ``segs`` as the
    executor runs it, the prepared inputs made once beforehand; it
    returns each segment's (scores, matched)."""
    from opensearch_tpu_torch.search import plan as P

    (plan, bind), ckey = searcher.compiled(query, with_key=True)
    needed = plan.arrays()
    items = [searcher._evaluated(plan, bind, needed, seg, ckey)
             for seg in segs if plan.can_match(bind, seg)]

    def run():
        P.dense_prepass(plan, [(A, dims, ins)
                               for _s, _d, dims, ins, A in items])
        return [plan.eval(A, dims, ins) for _s, _d, dims, ins, A in items]
    return run


def digest(outs) -> str:
    h = hashlib.sha256()
    for scores, matched in outs:
        h.update(scores.cpu().numpy().tobytes())
        h.update(matched.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def profile_ms(fn, reps: int, windows: int = 2, attempts: int = 4):
    """({"phrase": ms, "span": ms, "all": ms}: device ms a call of the
    kernels whose name holds ``phrase`` / ``span`` and of every kernel,
    {same: kernels a call}) under ``torch.profiler``, the lower of
    ``windows`` windows that show device events (the profiler drops a
    window's events at times); (None, None) when none does."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from opensearch_tpu_torch.testing.profile_scale import _is_device
    fn()
    readings = []
    for _ in range(attempts):
        if len(readings) == windows:
            break
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if _is_device(e)
                  and e.time_range.end > e.time_range.start]
        if not events:
            continue
        ms, n = {}, {}
        for key in ("phrase", "span", "all"):
            hit = [e for e in events if key == "all" or key in e.name]
            ms[key] = sum(e.time_range.end - e.time_range.start
                          for e in hit) / 1e3 / reps
            n[key] = len(hit) / reps
        readings.append((ms, n))
    if not readings:
        return None, None
    return min(readings, key=lambda r: r[0]["all"])


def event_ms(fn, reps: int = REPS) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def host_ms(fn, dev, reps: int = REPS) -> float:
    """Host ms per ``fn()`` (the enqueue, no sync inside the loop), after
    a warm-up call; the device drained before and after."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    el = time.perf_counter() - t0
    sync(dev)
    return el / reps * 1e3


def turn(segs, searcher, n_docs, dev, gpu, label) -> None:
    k8, k9 = counters()
    for name, query, one in cases(n_docs):
        run = request_work(searcher, query, segs[:1] if one else segs)
        k8.launches = k9.launches = 0
        outs = run()
        sync(dev)
        launched = {"k8": k8.launches, "k9": k9.launches}
        row = {"case": name, "label": label,
               "segments": 1 if one else len(segs), "digest": digest(outs),
               "launches_a_request": launched,
               "host_ms": host_ms(run, dev), "gpu": gpu}
        if dev.type == "cuda":
            dev_ms, kernels = profile_ms(run, REPS)
            row.update(device_ms=dev_ms, kernels_a_request=kernels,
                       ms=min(event_ms(run), event_ms(run)))
        print(json.dumps(row), flush=True)
    for kind, bodies in p50_bodies(n_docs).items():
        k8.launches = k9.launches = 0
        lat = ([], [])
        for sight in (0, 1):
            for b in bodies:
                t = time.perf_counter()
                searcher.search(b)
                lat[sight].append((time.perf_counter() - t) * 1e3)
        print(json.dumps({
            "kind": kind, "label": label, "n": len(bodies),
            "p50_first_ms": float(np.percentile(lat[0], 50)),
            "p50_second_ms": float(np.percentile(lat[1], 50)),
            "p99_first_ms": float(np.percentile(lat[0], 99)),
            "k8_a_request": k8.launches / (2 * len(bodies)),
            "k9_a_request": k9.launches / (2 * len(bodies)),
            "gpu": gpu}), flush=True)


# -- variant builds and the phase split ----------------------------------------

def variant_defines(chunk: int, threads: int, min_blocks: int,
                    phases: bool = False) -> dict:
    from opensearch_tpu_torch.ops import cuda_positions as cp
    return {**cp.defines(), "POS_CHUNK": chunk, "POS_THREADS": threads,
            "POS_MIN_BLOCKS": min_blocks,
            "POS_TILE_IDS": max(chunk, cp.TILE_IDS),
            **({"QUANT_PHASES": 1} if phases else {})}


class using:
    """Within the block, ``cuda_positions`` launches through a library
    built with ``variant_defines(chunk, threads, min_blocks, phases)`` and
    cuts its jobs into blocks of ``chunk`` positions."""

    def __init__(self, chunk: int, threads: int, min_blocks: int,
                 phases: bool = False):
        from opensearch_tpu_torch.ops import cuda_build
        from opensearch_tpu_torch.ops import cuda_positions as cp

        def declare(lib):
            cp._declare(lib)
            if phases:
                lib.quant_phases.argtypes = [ctypes.c_void_p]
                lib.quant_phases.restype = ctypes.c_int

        self.cp, self.chunk = cp, chunk
        self.lib = cuda_build.library(
            "positions", declare,
            variant_defines(chunk, threads, min_blocks, phases))

    def __enter__(self):
        self.saved = self.cp._library, self.cp.CHUNK
        self.cp._library = lambda: self.lib
        self.cp.CHUNK = self.chunk
        return self.lib

    def __exit__(self, *exc):
        self.cp._library, self.cp.CHUNK = self.saved


def variants(segs, searcher, n_docs, gpu, label) -> None:
    """The two heaviest cases over the 16 segments at each of
    ``VARIANTS`` beside the default build, then the phase split of each
    at the default shape."""
    from opensearch_tpu_torch.ops import cuda_build
    from opensearch_tpu_torch.ops import cuda_positions as cp

    default = (cp.CHUNK, cp.THREADS, cp.MIN_BLOCKS)
    shapes = (default, *(v for v in VARIANTS if v != default))
    logs = cuda_build.build_variants(
        [("positions", variant_defines(*v)) for v in shapes]
        + [("positions", variant_defines(*default, phases=True))])
    for (_name, defs), text in logs.items():
        d = dict(defs)
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                print(f"ptxas positions {d['POS_CHUNK']} x {d['POS_THREADS']}"
                      f" x {d['POS_MIN_BLOCKS']}"
                      f"{' phases' if 'QUANT_PHASES' in d else ''}: "
                      f"{line.strip()[-70:]}", flush=True)
    cases_ = [c for c in cases(n_docs) if not c[2]][:2]
    for name, query, _one in cases_:
        run = request_work(searcher, query, segs)
        want = digest(run())
        for chunk, threads, min_blocks in shapes:
            with using(chunk, threads, min_blocks):
                got = digest(run())
                dev_ms, kernels = profile_ms(run, REPS)
                ms = min(event_ms(run), event_ms(run))
            print(json.dumps({
                "variant": name, "label": label, "chunk": chunk,
                "threads": threads, "min_blocks": min_blocks,
                "equal": got == want,
                "device_ms": dev_ms, "kernels_a_request": kernels, "ms": ms,
                "gpu": gpu}), flush=True)
            if got != want:
                raise AssertionError(f"{name} at {chunk} x {threads}: "
                                     "another answer")
        with using(*default, phases=True) as lib:
            run()
            sync(searcher.device)
            out = (ctypes.c_ulonglong * 8)()
            lib.quant_phases(out)              # zero the sums
            for _ in range(REPS):
                run()
            sync(searcher.device)
            cuda_build.check(lib, lib.quant_phases(out), "quant_phases")
            blocks = cp.job_table(
                [leaf for _A, _i, leaf in positional_jobs(searcher, query,
                                                          segs)],
                "span" if "span" in name else "phrase").n_blocks
        cycles = {p: out[i] / REPS / max(blocks, 1)
                  for i, p in enumerate(PHASES)}
        total = sum(cycles.values()) or 1.0
        print(json.dumps({
            "phase_split": name, "label": label, "blocks": blocks,
            "cycles_a_block": cycles,
            "share": {p: c / total for p, c in cycles.items()},
            "gpu": gpu}), flush=True)


def positional_jobs(searcher, query, segs) -> list:
    """``(A, ins, PositionalLeaf)`` of each positional leaf of ``query``
    over ``segs``, as ``dense_prepass`` makes them."""
    (plan, bind), ckey = searcher.compiled(query, with_key=True)
    needed = plan.arrays()
    out = []
    for seg in segs:
        if not plan.can_match(bind, seg):
            continue
        _s, _d, dims, ins, A = searcher._evaluated(plan, bind, needed, seg,
                                                   ckey)
        out += [(A, i, leaf.positional_leaf(A, d, i))
                for leaf, d, i in plan.dense_leaves(dims, ins)]
    return out


# -- the host split of one request -------------------------------------------

class Parts:
    """Host ms by part, summed over calls."""

    def __init__(self):
        self.ms = {}

    def time(self, part, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        self.ms[part] = self.ms.get(part, 0.0) + (
            time.perf_counter() - t) * 1e3
        return out


def split_route_per_segment(parts, items, dev):
    """The route of a tree with one K8 launch per segment: each part of
    ``cuda_positions._launch`` and of ``plan._positional_scores``, segment
    after segment."""
    import ctypes

    import torch

    from opensearch_tpu_torch.ops import cuda_build
    from opensearch_tpu_torch.ops import cuda_positions as cp
    from opensearch_tpu_torch.search import plan as P

    entries = []
    for _s, _d, _dims, ins, A in items:
        slots, weight, avgdl = ins
        p = A["positions"]["body"]
        n_pad = A["live"].shape[0]

        def table():
            cp._columns(p["doc_ids"], p["pos_offsets"], p["positions"])
            cp.check_slots(slots, p["doc_ids"], p["pos_offsets"])
            return torch.from_numpy(cp.slot_table(slots)).pin_memory().to(
                dev, non_blocking=True)

        if dev.type != "cuda":       # a rehearsal: the plain version
            tf = parts.time("launch", P.phrase_ops.phrase_freqs,
                            p["doc_ids"], p["pos_offsets"], p["positions"],
                            slots, n_pad)
        else:
            tab = parts.time("slot table + pinned copy", table)
            tf = parts.time("zeroing", lambda: torch.zeros(
                n_pad, dtype=torch.float32, device=dev))

        def launch():
            lib = cp._library()
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.phrase_freqs_launch(
                ctypes.c_void_p(tab.data_ptr()), int(slots.rows.shape[0]),
                ctypes.c_void_p(p["doc_ids"].data_ptr()),
                ctypes.c_void_p(p["pos_offsets"].data_ptr()),
                ctypes.c_void_p(p["positions"].data_ptr()),
                ctypes.c_void_p(tf.data_ptr()), slots.n_anchor,
                ctypes.c_void_p(stream))
            cuda_build.check(lib, rc, "phrase_freqs_launch")

        if dev.type == "cuda" and slots.complete and slots.n_anchor:
            parts.time("launch", launch)
        scores, matched = parts.time(
            "scoring ops", P._positional_scores, tf, p, True, weight, avgdl)
        entries.append((scores, matched, A["live"]))
    return entries


def split_route_jobs(parts, plan, items, dev):
    """This tree's route: ``cuda_positions``' job table, its upload from
    the pinned arena, the output's memset, the launch, then the views
    and each segment's eval."""
    from opensearch_tpu_torch.ops import cuda_positions as cp

    jobs = parts.time("leaf walk", lambda: [
        (A, i, leaf.positional_leaf(A, d, i))
        for _s, _d, dims, ins, A in items
        for leaf, d, i in plan.dense_leaves(dims, ins)])
    leaves = [leaf for _A, _i, leaf in jobs]
    if dev.type != "cuda":           # a rehearsal: the plain version
        from opensearch_tpu_torch.ops.phrase import phrase_scores
        views = parts.time("launch", phrase_scores, leaves)
    else:
        jt = parts.time("job table", cp.job_table, leaves, "phrase")
        table = parts.time("upload (pinned arena)", cp.upload, jt, dev)
        out = parts.time("memset", cp.zeroed_output, jt, dev)
        parts.time("launch", cp.launch, "phrase", jt, table, out, dev)
        views = parts.time("views", cp.output_views, jt, out)
    for (A, i, _leaf), view in zip(jobs, views):
        A.setdefault("dense", {})[id(i)] = view
    return [parts.time("eval", plan.eval, A, dims, ins) + (A["live"],)
            for _s, _d, dims, ins, A in items]


def host_split(segs, searcher, n_docs, dev, gpu, label) -> None:
    from opensearch_tpu_torch.ops import bm25 as bm25_ops
    from opensearch_tpu_torch.ops import cuda_positions as cp

    bodies = [b["query"] for b in p50_bodies(n_docs)["phrase"]
              [:SPLIT_BODIES]]
    for name, queries in (("match_phrase", bodies),
                          ("t0 t0", [{"match_phrase": {"body": "t0 t0"}}])):
        parts = Parts()
        synced = []
        for rep in range(SPLIT_REPS + 1):
            if rep == 1:             # the first round warms up
                parts = Parts()
                synced = []
            for q in queries:
                sync(dev)
                t0 = time.perf_counter()
                (plan, bind), _ = parts.time(
                    "compile", searcher.compiled, q, True, True)
                needed = plan.arrays()
                items = parts.time("prepare", lambda: [
                    searcher._evaluated(plan, bind, needed, seg, None)
                    for seg in segs if plan.can_match(bind, seg)])
                if hasattr(cp, "job_table"):
                    entries = split_route_jobs(parts, plan, items, dev)
                else:
                    entries = split_route_per_segment(parts, items, dev)
                sync(dev)
                synced.append((time.perf_counter() - t0) * 1e3)

                def topk():
                    out = bm25_ops.plan_topk_segments_auto(
                        [bm25_ops.PlanScores(*e) for e in entries], k=10,
                        min_score=-np.inf)
                    return out.numpy()

                parts.time("plan top-k + read-back", topk)
        n = SPLIT_REPS * len(queries)
        print(json.dumps({
            "split": name, "label": label, "requests": n,
            "segments": len(items),
            "host_ms_a_request": {k: v / n for k, v in parts.ms.items()},
            "host_ms_total": sum(parts.ms.values()) / n,
            "through_route_synced_ms_p50": float(np.median(synced)),
            "gpu": gpu}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", help="tree whose opensearch_tpu_torch to time")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--turn", action="store_true",
                    help="only the turn's readings, for an A/B of two trees")
    ap.add_argument("--split", action="store_true",
                    help="with --turn, the host split by part too")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--segments", type=int, default=16)
    args = ap.parse_args(argv)
    root = args.root or os.path.join(os.path.dirname(__file__), "..", "..")
    sys.path.insert(0, os.path.abspath(root))
    import torch
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("k8_sweep: CUDA is not available", file=sys.stderr)
        return 1
    gpu = gpu_name_power(dev)
    t0 = time.monotonic()
    segs, searcher = build(args.docs, args.segments, dev)
    print(json.dumps({"corpus": args.docs, "segments": len(segs),
                      "built_s": time.monotonic() - t0,
                      "label": args.label}), flush=True)
    turn(segs, searcher, args.docs, dev, gpu, args.label)
    if not args.turn:
        from opensearch_tpu_torch.ops import cuda_positions as cp
        if dev.type == "cuda" and hasattr(cp, "job_table"):
            variants(segs, searcher, args.docs, gpu, args.label)
    if not args.turn or args.split:
        host_split(segs, searcher, args.docs, dev, gpu, args.label)
    print(gpu, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
