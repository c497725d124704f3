"""K5, the bucket collector, against the kernel it replaced, over chunk
sizes, on the card; and where K5's time goes.

    python3 -m opensearch_tpu_torch.testing.k5_sweep

Stages the doc-value columns of ``chip_smoke.py``'s scale corpus
(``testing/corpus.py`` ``doc_value_columns``: 1M docs in 16 segments of
62,500, every doc live, 65,536 padded entries a segment) as
``DeviceSegment`` stages them, and takes the three shapes
``chip_smoke.py`` phase 2 times: a day ``date_histogram`` on ``ts`` with
a ``stats`` sub on ``fare`` (edges mode), ``terms`` on ``tag`` with
``fare`` and ``price`` subs (ordinal mode) and the single mode over
``fare`` (a ``stats``).  For each chunk size of ``CHUNKS``
(``csrc/aggs.cu`` rebuilt with that ``AGG_CHUNK``; ptxas' register and
spill lines are printed) K5 is checked against its plain version byte
for byte and timed in turns with the replaced kernel (``csrc/
aggs_old_route.cuh``, built only into this sweep's library with
``-DAGG_OLD_ROUTE``; no path of the port reaches it): replaced, K5, K5,
replaced.  Times are device milliseconds per call under
``torch.profiler`` (the kernels' own time, each kernel of K5 apart),
each the lower of two readings, and CUDA-event milliseconds per call.
Then K5 at the default chunk built with ``-DQUANT_PHASES``
(``csrc/phases.cuh``): each phase's share of the blocks' cycles (count:
load, sort, records; scan; reduce: partials, tree, nodes; merge).
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

from opensearch_tpu_torch.testing.profile_scale import (_device_self_us,
                                                        _is_device)

CHUNKS = (1024, 2048, 4096)
REPS = 10
N_DOCS = 1_000_000
N_SEGMENTS = 16
PHASES = ("count: load, buckets, validity", "count: sort", "count: records",
          "scan", "reduce: partials", "reduce: tree", "reduce: nodes",
          "merge")


def scale_columns(dev) -> list:
    """Per segment ``(matched, {column: staged dict})``: ``price``,
    ``ts``, ``fare`` (numeric: values, value_docs, offsets) and ``tag``
    (ordinal: ords, value_docs, n_ords), padded as ``DeviceSegment``
    pads them, every doc matched."""
    from opensearch_tpu_torch.index.segment import pad_pow2
    from opensearch_tpu_torch.testing import corpus

    cols = corpus.doc_value_columns(N_DOCS, seed=11)
    per = N_DOCS // N_SEGMENTS
    out = []
    for s in range(N_SEGMENTS):
        n_pad = pad_pow2(per + 1)
        v_pad = pad_pow2(per)

        def pad(a, fill):
            p = np.full(v_pad, fill, a.dtype)
            p[: len(a)] = a
            return torch.from_numpy(p).to(dev)

        docs = pad(np.arange(per, dtype=np.int32), per)
        offs = np.full(n_pad + 1, per, np.int32)
        offs[: per + 1] = np.arange(per + 1, dtype=np.int32)
        offs_t = torch.from_numpy(offs).to(dev)
        seg = {}
        for name in ("price", "ts", "fare"):
            seg[name] = {"values": pad(cols[name][s * per: (s + 1) * per], 0),
                         "value_docs": docs, "offsets": offs_t}
        codes = cols["tag"][s * per: (s + 1) * per]
        present = np.unique(codes)
        seg["tag"] = {"ords": pad(np.searchsorted(present, codes).astype(
            np.int32), -1), "value_docs": docs, "n_ords": len(present)}
        matched = torch.zeros(n_pad, dtype=torch.bool, device=dev)
        matched[:per] = True
        out.append((matched, seg))
    return out


def shapes(dev) -> dict:
    """{name: (segments, mode, edges, self_metric)} of the three timed
    shapes."""
    from opensearch_tpu_torch.ops.aggs import CollectSegment as CS
    from opensearch_tpu_torch.search.aggs import build_date_edges
    from opensearch_tpu_torch.testing import corpus

    views = scale_columns(dev)
    day = torch.from_numpy(build_date_edges(
        corpus.TS_START_MS, corpus.TS_START_MS + corpus.TS_SPAN_MS,
        calendar="day").astype(np.float64)).to(dev)
    return {
        "date_histogram": ([CS(m, c["ts"]["values"], c["ts"]["value_docs"],
                               day.shape[0] - 1, [c["fare"]])
                            for m, c in views], "edges", day, False),
        "terms": ([CS(m, c["tag"]["ords"], c["tag"]["value_docs"],
                      c["tag"]["n_ords"], [c["fare"], c["price"]])
                   for m, c in views], "ordinal", None, False),
        "single": ([CS(m, c["fare"]["values"], c["fare"]["value_docs"], 1)
                    for m, c in views], "single", None, True)}


# -- the replaced kernel (csrc/aggs_old_route.cuh), for this sweep only --

OLD_THREADS = 256
OLD_HEAD_WORDS = 8
OLD_TILE_MAX = 64
OLD_SMEM_MAX = 200 * 1024
_old_lib = None


def _old_library():
    global _old_lib
    if _old_lib is None:
        from opensearch_tpu_torch.ops import cuda_aggs, cuda_build

        def declare(lib):
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.agg_old_launch.argtypes = [p, i, i, i, i, i, i, ctypes.c_uint,
                                           i, i, i, p, i, i, p, p]
            lib.agg_old_launch.restype = i
            lib.agg_old_smem_bytes.argtypes = [i, i, i, i]
            lib.agg_old_smem_bytes.restype = ctypes.c_longlong
            cuda_aggs._declare(lib)

        _old_lib = cuda_build.library(
            "aggs", declare, {**cuda_aggs.defines(), "AGG_OLD_ROUTE": 1})
    return _old_lib


def old_route(segments, *, mode, edges=None, self_metric=False):
    """The replaced K5: one launch, one block per (segment, tile of up to
    64 buckets), every block streaming its segment's entries."""
    from opensearch_tpu_torch.ops.aggs import MODES, output_words
    from opensearch_tpu_torch.ops.cuda_aggs import _DTYPES

    lib = _old_library()
    dev = segments[0].matched.device
    n_subs = 1 if self_metric else len(segments[0].subs)
    offs = output_words(segments, n_subs)
    sub_f64, rows, work, longest = 0, [], [], 1
    for s, seg in enumerate(segments):
        n = seg.keys.shape[0]
        longest = max(longest, n)
        row = [seg.matched.data_ptr(), seg.keys.data_ptr(),
               seg.key_docs.data_ptr(), n, seg.n_buckets, seg.n_buckets_pad,
               offs[s], 0]
        for j, col in enumerate([] if self_metric else seg.subs):
            if col is None:
                row += [0, 0]
                continue
            if col["values"].dtype == torch.float64:
                sub_f64 |= 1 << j
            row += [col["values"].data_ptr(), col["offsets"].data_ptr()]
        if self_metric:
            row += [0, 0]
        rows += row
    levels = max(1, longest.bit_length())
    n_edges = edges.shape[0] if mode == "edges" else 0
    edges_smem = 0 < n_edges <= 8192
    tile = OLD_TILE_MAX
    while tile > 1 and lib.agg_old_smem_bytes(
            tile, n_subs, levels, n_edges if edges_smem else 0) > OLD_SMEM_MAX:
        tile //= 2
    for s, seg in enumerate(segments):
        work += [(s << 32) | t for t in range(-(-seg.n_buckets_pad // tile))]
    table = torch.from_numpy(np.array(rows + work, np.int64)).to(dev)
    out = torch.empty(offs[-1], dtype=torch.int64, device=dev)
    rc = lib.agg_old_launch(
        ctypes.c_void_p(table.data_ptr()), len(segments), len(work),
        OLD_HEAD_WORDS + 2 * n_subs, MODES.index(mode),
        _DTYPES[segments[0].keys.dtype], n_subs, sub_f64, int(self_metric),
        tile, levels, ctypes.c_void_p(edges.data_ptr() if n_edges else 0),
        n_edges, int(edges_smem), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"agg_old_launch: CUDA error {rc}")
    return out


# -- timing --

def kernel_ms(fn, reps: int = REPS) -> tuple:
    """(device ms per call of the kernels named ``agg_``, {kernel: ms per
    call}) under the profiler, over ``reps`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        if _is_device(e) and "agg_" in e.key:
            name = next((k for k in ("count", "scan", "reduce", "merge",
                                     "old") if f"agg_{k}" in e.key), e.key)
            per[name] = per.get(name, 0.0) + _device_self_us(e) / 1e3 / reps
    return sum(per.values()), per


def event_ms(fn, reps: int = REPS) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("k5_sweep: CUDA is not available", file=sys.stderr)
        return 1
    from opensearch_tpu_torch.ops import aggs as agg_ops
    from opensearch_tpu_torch.ops import cuda_aggs, cuda_build

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cases = shapes(dev)
    plain = {name: agg_ops.bucket_collect_plain(segs, mode=mode, edges=e,
                                                self_metric=sm)
             for name, (segs, mode, e, sm) in cases.items()}
    k5 = cuda_aggs.bucket_collect_cuda
    default = cuda_aggs.CHUNK
    try:
        for chunk in CHUNKS:
            cuda_aggs.CHUNK = chunk
            logs = cuda_build.build(["aggs"], {"aggs": cuda_aggs.defines()})
            for line in logs.get("aggs", "").splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas aggs chunk {chunk}: {line.strip()}")
            for name, (segs, mode, e, sm) in cases.items():
                def new(segs=segs, mode=mode, e=e, sm=sm):
                    return k5(segs, mode=mode, edges=e, self_metric=sm)

                def old(segs=segs, mode=mode, e=e, sm=sm):
                    return old_route(segs, mode=mode, edges=e,
                                     self_metric=sm)

                a, b, o = new(), new(), old()
                torch.cuda.synchronize()
                if not (torch.equal(a, plain[name]) and torch.equal(a, b)
                        and torch.equal(o, plain[name])):
                    raise AssertionError(f"chunk {chunk} {name}: differs "
                                         "from the plain version")
                calls0, kernels0 = k5.launches, k5.kernels
                o1, _ = kernel_ms(old)
                n1, per1 = kernel_ms(new)
                n2, per2 = kernel_ms(new)
                o2, _ = kernel_ms(old)
                per = per1 if n1 <= n2 else per2
                print(json.dumps({
                    "shape": name, "chunk": chunk,
                    "entries": sum(s.keys.numel() for s in segs),
                    "device_ms": min(n1, n2), "replaced_device_ms":
                    min(o1, o2), "per_kernel_ms": per,
                    "kernels_per_call": (k5.kernels - kernels0)
                    / (k5.launches - calls0),
                    "ms": min(event_ms(new), event_ms(new)),
                    "replaced_ms": min(event_ms(old), event_ms(old)),
                    "gpu": gpu}), flush=True)
        cuda_aggs.CHUNK = default
        phase_split(cases, gpu)
    finally:
        cuda_aggs.CHUNK = default
    return 0


def phase_split(cases, gpu) -> None:
    """Each phase's share of K5's block cycles at the default chunk (a
    ``-DQUANT_PHASES`` build; thread 0 of every block)."""
    from opensearch_tpu_torch.ops import cuda_aggs, cuda_build

    def declare(lib):
        cuda_aggs._declare(lib)
        lib.quant_phases.argtypes = [ctypes.c_void_p]
        lib.quant_phases.restype = ctypes.c_int

    lib = cuda_build.library("aggs", declare,
                             {**cuda_aggs.defines(), "QUANT_PHASES": 1})
    real = cuda_aggs._library
    cuda_aggs._library = lambda: lib
    try:
        buf = np.zeros(8, np.uint64)
        for name, (segs, mode, e, sm) in cases.items():
            cuda_aggs.bucket_collect_cuda(segs, mode=mode, edges=e,
                                          self_metric=sm)
            torch.cuda.synchronize()
            lib.quant_phases(buf.ctypes.data_as(ctypes.c_void_p))
            for _ in range(REPS):
                cuda_aggs.bucket_collect_cuda(segs, mode=mode, edges=e,
                                              self_metric=sm)
            torch.cuda.synchronize()
            lib.quant_phases(buf.ctypes.data_as(ctypes.c_void_p))
            total = float(buf.sum()) or 1.0
            print(json.dumps({
                "shape": name, "chunk": cuda_aggs.CHUNK,
                "phase_cycles_per_call": {p: float(c) / REPS for p, c in
                                          zip(PHASES, buf)},
                "phase_share": {p: float(c) / total for p, c in
                                zip(PHASES, buf)}, "gpu": gpu}), flush=True)
    finally:
        cuda_aggs._library = real


if __name__ == "__main__":
    sys.exit(main())
