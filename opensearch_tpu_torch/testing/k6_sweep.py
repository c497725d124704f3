"""K6 and K7, the IVF and IVF-PQ kernels, at ``chip_smoke.py`` phase 13's
shape on the card: device time per kernel, the phase split, and sweeps
of the chunk size and of the probe's blocks per (query, segment).

    python3 -m opensearch_tpu_torch.testing.k6_sweep [--ab]
    python3 opensearch_tpu_torch/testing/k6_sweep.py --turn [--root DIR] [--label NAME]

Builds phase 13's corpus (``testing/ann.py``: GloVe-100's shape,
1,183,514 x 100 clustered vectors in 16 segments, nlist 271), trains
each segment's ``ivf`` and ``ivf_pq`` (m = 10) indexes on the card and
stages them as ``DeviceSegment.ann_staged`` does.  K6 runs in the
cosine space, K7 in l2, over the 16 segments in one call.

- ``--turn``: K6 and K7 at the default point (nprobe 33, k = 10, one
  query): device ms of each kernel under ``torch.profiler`` (the lower
  of two windows) and CUDA-event ms per call, checked byte for byte
  against the plain twins, and the phase split where the tree's
  ``csrc/ivf.cu`` has the marks.  ``--root`` puts DIR's
  ``opensearch_tpu_torch`` first on the path (by default this file's
  tree), so the same script times another tree (a parent commit
  unpacked by ``git archive`` into the gitignored ``build/archive/``):
  run parent, change, change, parent in one chip call to compare two
  trees on one card.
- ``--ab``: K6 and K7 at the default point, built with one setting of
  ``AB`` changed (``-DIVF_PDL=0``: plain stream launches, no
  programmatic dependent launch; ``-DIVF_SMALL_K=0``: every selection
  through topk.cuh), timed in turns with the default build (default,
  variant, variant, default), each checked byte for byte.
- Otherwise: every point of nprobe 8 / 33 / 271 x k = 10 / 100, each
  checked byte for byte against the plain twin and timed against its
  bound and the ``torch.topk(flat_v @ q, 10)`` yardstick (the probed
  rows gathered beforehand); then libraries built with K6's chunk rows
  (``CHUNKS``), its stage bytes (``STAGE_BYTES``), K7's chunk rows
  (``PQ_CHUNKS``) and the probe's blocks per (query, segment)
  (``PROBE_BLOCKS``) at nprobe 33, k = 10 (every variant built at
  once, one ``nvcc`` each); the ``--ab`` turns; the device time of an
  empty pair of kernels launched as the probe and the scan are (the
  floor two launches set), with and without a dependent launch; the
  ``-DQUANT_PHASES`` split of each kernel's block cycles
  (``csrc/phases.cuh``); and the wrappers' host time per call by part
  (checks, launch table, pinned upload, buffers, the launch).

Prints one JSON line per reading, and the card's name and power limit.
Needs CUDA; without it, exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP64_FLOPS_PER_S = 34e12         # fp64 outside the tensor cores
REPS = 20
NPROBES = (8, 33, 271)
KS = (10, 100)
CHUNKS = (128, 256, 512, 1024)
PQ_CHUNKS = (256, 512, 1024)
PROBE_BLOCKS = (1, 2, 4, 8)
STAGE_BYTES = (8_192, 16_384, 32_768)
KNOBS = {"IVF_CHUNK_ROWS": (CHUNKS, (False,)),
         "IVF_STAGE_BYTES": (STAGE_BYTES, (False,)),
         "IVF_PQ_CHUNK_ROWS": (PQ_CHUNKS, (True,)),
         "IVF_PROBE_BLOCKS": (PROBE_BLOCKS, (False, True))}
AB = {"IVF_PDL": 0, "IVF_SMALL_K": 0}
CHECK_QUERIES = 4
PHASES = ("probe: score", "probe: select", "lut build", "row / code load",
          "score", "tile select", "post and merge", "scan blocks with rows")


def gpu_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def ivf_bound(items, q, pq: bool) -> tuple:
    """(bytes, float64 flops) one K6 / K7 call must move and do for query
    ``q`` over ``items``: per segment its centroids and starts, the rows
    (K6: d floats; K7: m codes), ids and live bytes of the clusters this
    query probes (their real counts), K7's codebooks, the query and the
    hits."""
    from opensearch_tpu_torch.ops import ivf

    nbytes = q.numel() * 4
    flops = 0.0
    for it in items:
        st = it.index
        d = st.centroids.shape[1]
        p = ivf.probe(st.centroids, q, it.nprobe).cpu().numpy()
        rows = int((st.starts_host[p + 1] - st.starts_host[p]).sum())
        nbytes += st.nlist * (d * 4 + 4) + 4 + it.k * 8
        flops += 4.0 * d * st.nlist
        if pq:
            m = st.codes.shape[1]
            nbytes += st.codebooks.numel() * 4 + rows * (m + 4 + 1)
            flops += 3.0 * it.nprobe * m * ivf.PQ_CODEWORDS * (d // m) + \
                rows * m
        else:
            nbytes += rows * (d * 4 + 4 + 1)
            flops += 4.0 * d * rows
    return nbytes, flops


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP64_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernels_ms(fn, reps: int = REPS, windows: int = 2, attempts: int = 4):
    """({kernel: device ms per launch}, their sum, the mean span) of the
    kernels whose name holds ``ivf`` over ``reps`` calls of ``fn`` under
    ``torch.profiler``, after a warm-up call.  The span of a call runs
    from its first kernel's start to its last kernel's end on the card:
    a kernel launched as a programmatic dependent starts before the one
    it depends on ends, so its time overlaps that one's and the sum
    counts the overlap twice.  The lower of ``windows`` windows that show
    every call's kernels (the profiler drops a window's events at
    times); (None, None, None) when none of ``attempts`` does."""
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
        events = sorted(((e.time_range.start, e.time_range.end,
                          re.search(r"ivf\w*", e.name).group(0))
                         for e in prof.events()
                         if _is_device(e) and "ivf" in e.name),
                        key=lambda t: t[0])
        names = sorted({n for _s, _e, n in events})
        if not events:
            continue
        per = {n: sum(e - s for s, e, m in events if m == n) / 1e3
               / sum(m == n for _s, _e, m in events) for n in names}
        k = len(names)
        span = None  # only when no call lost an event
        if len(events) == reps * k:
            span = sum(max(e for _s, e, _n in events[i: i + k]) - events[i][0]
                       for i in range(0, len(events), k)) / 1e3 / reps
        readings.append((per, sum(per.values()), span))
    if not readings:
        return None, None, None
    return min(readings, key=lambda r: (r[2] is None, r[2] or r[1]))


def host_ms(fn, reps: int = 200) -> float:
    """Host milliseconds per ``fn()`` (the enqueue, no sync inside the
    loop), after a warm-up call; the device is drained before and
    after."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    el = time.perf_counter() - t0
    torch.cuda.synchronize()
    return el / reps * 1e3


def launches_ms(items, q, pq: bool, reps: int = REPS) -> float:
    """Device ms per call of K6 / K7 launched back to back, without the
    profiler: ``reps`` calls' tables, buffers and arguments prepared
    first (``cuda_ivf._launch_args``), then CUDA events around their
    launches alone, which the host issues faster than the card runs
    them: each call's span on the card, the gaps between its kernels
    included."""
    import torch

    from opensearch_tpu_torch.ops import cuda_ivf, ivf

    space = 0 if pq else cuda_ivf.SPACE_CODES["cosinesimil"]
    offs = ivf.k_offsets(items)
    out = (torch.empty((1, offs[-1]), device=q.device),
           torch.empty((1, offs[-1]), dtype=torch.int32, device=q.device))
    prepared = [cuda_ivf._launch_args(items, q, q.shape[1], pq, space, out,
                                      offs[:-1]) for _ in range(reps + 1)]
    lib = prepared[0][0]
    lib.ivf_search_launch(*prepared[0][1])      # warm-up
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _lib, args, _out, _keep in prepared[1:]:
        lib.ivf_search_launch(*args)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


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


def staged_corpus(dev, n_queries: int):
    """(flat staged indexes, PQ staged indexes, live masks, held-out
    queries f32 [n_queries, 100] on ``dev``) of phase 13's corpus."""
    import torch

    from opensearch_tpu_torch.testing import ann

    segs, held = ann.corpus_segments(ann.DOCS, n_queries)
    flat, pqs, live = [], [], []
    for seg in segs:
        dseg = seg.device(dev)
        live.append(dseg.live)
        flat.append(dseg.ann_staged(seg.ann_index(
            "vec", {"name": "ivf", "m": ann.M}, dev)))
        pqs.append(dseg.ann_staged(seg.ann_index(
            "vec", {"name": "ivf_pq", "m": ann.M}, dev)))
    torch.cuda.synchronize()
    return flat, pqs, live, torch.from_numpy(held).to(dev)


def calls(staged, live, nprobe: int, k: int, pq: bool):
    """(items, kernel(q), plain(q)) of one point."""
    from opensearch_tpu_torch.ops import cuda_ivf, ivf

    items = [ivf.IvfSegment(st, lv, min(nprobe, st.nlist),
                            min(k, min(nprobe, st.nlist) * st.c_pad))
             for st, lv in zip(staged, live)]
    if pq:
        return (items,
                lambda q: cuda_ivf.ivfpq_search_segments_cuda(items, q),
                lambda q: ivf.ivfpq_search_segments(items, q))
    return (items,
            lambda q: cuda_ivf.ivf_search_segments_cuda(
                items, q, space="cosinesimil"),
            lambda q: ivf.ivf_search_segments(items, q, space="cosinesimil"))


def check(kernel, plain, qs, what: str) -> None:
    """Byte-equal to the plain twin and run to run on every query."""
    import torch

    for i in range(qs.shape[0]):
        q = qs[i: i + 1]
        a, b, w = kernel(q), kernel(q), plain(q)
        for x, y in ((a, w), (a, b)):
            if not (torch.equal(x[0].view(torch.int32),
                                y[0].view(torch.int32))
                    and torch.equal(x[1], y[1])):
                raise AssertionError(f"{what}: not byte-equal (query {i})")


def reading(name, items, kernel, q, pq, gpu, **extra) -> dict:
    from opensearch_tpu_torch.ops import cuda_ivf

    per, dev_ms, span = kernels_ms(lambda: kernel(q))
    nbytes, flops = ivf_bound(items, q[0], pq)
    bms, by = bound_ms(nbytes, flops)
    return {"kernel": name, **extra, "device_ms": dev_ms,
            "span_ms": span,
            # the parent tree's wrapper has no _launch_args
            "launches_ms": (launches_ms(items, q, pq)
                            if hasattr(cuda_ivf, "_launch_args") else None),
            "per_kernel_device_ms": per,
            "ms": min(event_ms(lambda: kernel(q)),
                      event_ms(lambda: kernel(q))),
            "bound_ms": bms, "bound_by": by, "bound_bytes": nbytes,
            "bound_share": None if not span else bms / span, "gpu": gpu}


def yardstick_ms(flat, items, q) -> tuple:
    """(ms of ``torch.topk(flat_v @ q, 10)`` over each segment's probed
    rows, gathered beforehand; the probed rows)."""
    import torch

    from opensearch_tpu_torch.ops import ivf

    fvs = []
    for st, it in zip(flat, items):
        rows, _f = ivf._probed(st, ivf.probe(st.centroids, q[0], it.nprobe))
        fvs.append(st.rows[rows])
    return (event_ms(lambda: [torch.topk(fv @ q[0], 10) for fv in fvs]),
            sum(fv.shape[0] for fv in fvs))


def turn(flat, pqs, live, qs, gpu, label) -> None:
    for pq, staged in ((False, flat), (True, pqs)):
        name = "K7" if pq else "K6"
        items, kernel, plain = calls(staged, live, 33, 10, pq)
        check(kernel, plain, qs[:CHECK_QUERIES], f"{name} nprobe 33 k 10")
        print(json.dumps(reading(
            name, items, kernel, qs[:1], pq, gpu, label=label, nprobe=33,
            k=10, host_ms=host_ms(lambda: kernel(qs[:1])))), flush=True)


def host_split(flat, pqs, live, qs, gpu) -> None:
    """The wrapper's host time per call at the default point, by part:
    the checks (``_check``), ``launch_table``, the pinned upload, the
    rest of ``_launch_args`` (the buffers between the kernels, the
    arguments), the launch (``ivf_search_launch`` through ``ctypes``)
    and the rest of the call (the output buffers, counting); each timed
    alone over 200 calls (host clock, no sync inside the loop)."""
    from opensearch_tpu_torch.ops import cuda_ivf, ivf

    dev = qs.device
    q = qs[:1]
    for pq, staged in ((False, flat), (True, pqs)):
        items, kernel, _plain = calls(staged, live, 33, 10, pq)
        space = 0 if pq else cuda_ivf.SPACE_CODES["cosinesimil"]
        chunk = cuda_ivf._library().ivf_scan_chunk(
            int(pq), staged[0].codes.shape[1] if pq else 0)
        offs = ivf.k_offsets(items)
        out = kernel(q)
        table, *_rest = cuda_ivf.launch_table(items, 1, offs[:-1], False,
                                              chunk)

        def prepare():
            return cuda_ivf._launch_args(items, q, q.shape[1], pq, space,
                                         out, offs[:-1])

        def prepare_launch():
            lib, args, _out, _keep = prepare()
            lib.ivf_search_launch(*args)

        parts = {
            "checks": host_ms(lambda: cuda_ivf._check(items, q, pq, "k")),
            "launch_table": host_ms(lambda: cuda_ivf.launch_table(
                items, 1, offs[:-1], False, chunk)),
            "upload": host_ms(lambda: cuda_ivf._upload(table, dev))}
        prep = host_ms(prepare)
        parts["buffers and arguments"] = prep - parts["launch_table"] - \
            parts["upload"]
        parts["launch"] = host_ms(prepare_launch) - prep
        call = host_ms(lambda: kernel(q))
        parts["rest"] = call - parts["checks"] - prep - parts["launch"]
        print(json.dumps({"kernel": "K7" if pq else "K6",
                          "host_ms_per_call": call, "host_split_ms": parts,
                          "gpu": gpu}), flush=True)


def points(flat, pqs, live, qs, gpu) -> None:
    for pq, staged in ((False, flat), (True, pqs)):
        name = "K7" if pq else "K6"
        for nprobe in NPROBES:
            for k in KS:
                items, kernel, plain = calls(staged, live, nprobe, k, pq)
                check(kernel, plain, qs[:CHECK_QUERIES],
                      f"{name} nprobe {nprobe} k {k}")
                lib_ms, rows = yardstick_ms(flat, items, qs[:1])
                print(json.dumps(reading(
                    name, items, kernel, qs[:1], pq, gpu, nprobe=nprobe,
                    k=k, probed_rows=rows, library_ms=lib_ms)), flush=True)


def library(phases: bool = False, **overrides):
    """The K6 / K7 library built with ``cuda_ivf.defines()`` and
    ``overrides`` ({macro: value}); with ``phases``, ``-DQUANT_PHASES``
    (the marks and ``ivf_empty_pair``)."""
    from opensearch_tpu_torch.ops import cuda_build, cuda_ivf

    def declare(lib):
        cuda_ivf._declare(lib)
        if phases:
            lib.quant_phases.argtypes = [ctypes.c_void_p]
            lib.quant_phases.restype = ctypes.c_int
            i = ctypes.c_int
            lib.ivf_empty_pair.argtypes = [i, i, ctypes.c_void_p]
            lib.ivf_empty_pair.restype = i

    return cuda_build.library("ivf", declare,
                              variant_defines(phases, **overrides))


def variant_defines(phases: bool = False, **overrides) -> dict:
    from opensearch_tpu_torch.ops import cuda_ivf

    return {**cuda_ivf.defines(), **overrides,
            **({"QUANT_PHASES": 1} if phases else {})}


class using:
    """Within the block, the wrappers launch from ``lib``."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        from opensearch_tpu_torch.ops import cuda_ivf
        self.real = cuda_ivf._library
        cuda_ivf._library = lambda: self.lib
        return self.lib

    def __exit__(self, *exc):
        from opensearch_tpu_torch.ops import cuda_ivf
        cuda_ivf._library = self.real


def prebuild(variants) -> None:
    """Every library of ``variants`` ((phases, overrides) pairs) at once,
    one ``nvcc`` each."""
    from opensearch_tpu_torch.ops import cuda_build

    cuda_build.build_variants([("ivf", variant_defines(ph, **ov))
                               for ph, ov in variants])


def knob_sweep(flat, pqs, live, qs, gpu) -> None:
    """K6 / K7 built with each value of each knob of ``KNOBS`` (nprobe
    33, k = 10), the others at their defaults."""
    prebuild([(False, {knob: v}) for knob, (values, _k) in KNOBS.items()
              for v in values])
    for knob, (values, kinds) in KNOBS.items():
        for v in values:
            with using(library(**{knob: v})):
                for pq in kinds:
                    staged = pqs if pq else flat
                    name = "K7" if pq else "K6"
                    items, kernel, plain = calls(staged, live, 33, 10, pq)
                    check(kernel, plain, qs[:CHECK_QUERIES],
                          f"{name} {knob} {v}")
                    print(json.dumps(reading(name, items, kernel, qs[:1], pq,
                                             gpu, knob=knob, value=v)),
                          flush=True)


def ab(flat, pqs, live, qs, gpu) -> None:
    """K6 and K7 at the default point, the default build against each
    variant of ``AB`` in turns: default, variant, variant, default."""
    prebuild([(False, {})] + [(False, {k: v}) for k, v in AB.items()])
    for knob, v in AB.items():
        for label, over in (("default", {}), ("variant", {knob: v}),
                            ("variant", {knob: v}), ("default", {})):
            with using(library(**over)):
                for pq, staged in ((False, flat), (True, pqs)):
                    name = "K7" if pq else "K6"
                    items, kernel, plain = calls(staged, live, 33, 10, pq)
                    check(kernel, plain, qs[:CHECK_QUERIES],
                          f"{name} {knob} {over}")
                    print(json.dumps(reading(
                        name, items, kernel, qs[:1], pq, gpu, ab=knob,
                        label=label, value=over.get(knob))), flush=True)


def empty_pair(flat, pqs, gpu) -> None:
    """Device ms of an empty kernel pair launched as the probe and the
    scan are at the default point (nprobe 33: 16 probe clusters, the
    scan's grid of K6 and of K7), the second as a programmatic dependent
    launch and (``-DIVF_PDL=0``) as a plain one."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    prebuild([(True, {}), (True, {"IVF_PDL": 0})])
    for pdl in (1, 0):
        lib = library(phases=True, IVF_PDL=pdl)
        scan_blocks = {pq: sum(33 * max(1, -(-st.max_rows // lib.ivf_scan_chunk(
            int(pq), st.codes.shape[1] if pq else 0))) for st in staged)
            for pq, staged in ((False, flat), (True, pqs))}
        for pq in (False, True):
            def pair():
                lib_check(lib, lib.ivf_empty_pair(
                    16, scan_blocks[pq], ctypes.c_void_p(stream)))
            per, dev_ms, span = kernels_ms(pair)
            print(json.dumps({"kernel": "empty probe + scan pair",
                              "pdl": pdl, "probe_clusters": 16,
                              "scan_blocks": scan_blocks[pq],
                              "device_ms": dev_ms, "span_ms": span,
                              "per_kernel_device_ms": per,
                              "ms": event_ms(pair), "gpu": gpu}), flush=True)


def lib_check(lib, rc: int) -> None:
    from opensearch_tpu_torch.ops import cuda_build
    cuda_build.check(lib, rc, "ivf_empty_pair")


def phase_split(flat, pqs, live, qs, gpu, label=None) -> None:
    """Each phase's block cycles per call of a ``-DQUANT_PHASES`` build
    (thread 0 of every block of every kernel), nprobe 33, k = 10."""
    import torch

    lib = library(phases=True)
    with using(lib):
        buf = np.zeros(8, np.uint64)
        for pq, staged in ((False, flat), (True, pqs)):
            _items, kernel, _plain = calls(staged, live, 33, 10, pq)
            kernel(qs[:1])
            torch.cuda.synchronize()
            lib.quant_phases(buf.ctypes.data_as(ctypes.c_void_p))
            for _ in range(REPS):
                kernel(qs[:1])
            torch.cuda.synchronize()
            lib.quant_phases(buf.ctypes.data_as(ctypes.c_void_p))
            cycles = {p: float(c) / REPS for p, c in zip(PHASES, buf)}
            timed = sum(v for p, v in cycles.items() if p != PHASES[7])
            print(json.dumps({
                "kernel": "K7" if pq else "K6", "label": label,
                "phase_block_cycles_per_call": cycles,
                "phase_share": {p: v / (timed or 1.0) for p, v in
                                cycles.items() if p != PHASES[7]},
                "gpu": gpu}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", help="tree whose opensearch_tpu_torch to time")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--turn", action="store_true",
                    help="only the default point, for an A/B of two trees")
    ap.add_argument("--ab", action="store_true",
                    help="only the default build against the AB variants")
    args = ap.parse_args(argv)
    root = args.root or os.path.join(os.path.dirname(__file__), "..", "..")
    sys.path.insert(0, os.path.abspath(root))
    import torch
    if not torch.cuda.is_available():
        print("k6_sweep: CUDA is not available", file=sys.stderr)
        return 1
    gpu = gpu_name_power()
    dev = torch.device("cuda")
    flat, pqs, live, qs = staged_corpus(dev, CHECK_QUERIES)
    if args.turn:
        turn(flat, pqs, live, qs, gpu, args.label)
        from opensearch_tpu_torch.ops import cuda_build
        if "QPHASE" in (cuda_build.CSRC / "ivf.cu").read_text():
            phase_split(flat, pqs, live, qs, gpu, args.label)
        return 0
    if args.ab:
        ab(flat, pqs, live, qs, gpu)
        print(gpu, flush=True)
        return 0
    host_split(flat, pqs, live, qs, gpu)
    points(flat, pqs, live, qs, gpu)
    knob_sweep(flat, pqs, live, qs, gpu)
    ab(flat, pqs, live, qs, gpu)
    empty_pair(flat, pqs, gpu)
    phase_split(flat, pqs, live, qs, gpu)
    print(gpu, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
