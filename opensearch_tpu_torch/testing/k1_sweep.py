"""K1's two entries on the card: the scores entry and its chunk policy,
then the top-k entry against the route it replaced and its chunk size.

    python3 -m opensearch_tpu_torch.testing.k1_sweep

Scores entry (``knn_scores_segments_cuda``): checked byte for byte
against its plain version, then timed in turns -- device milliseconds
per call under ``torch.profiler``, each the lower of two readings -- at
three shapes (16 segments of 65,536 x 128 a call each, in turn, so none
is in L2 when its call comes; the 16 in one launch; one segment of
1,000,000 x 128), l2 with an ``exists`` mask, at
``SCORE_WAVES`` = 1, 2, 4 and 8 (the chunk it gives), beside
``vectors @ q`` per segment and the plain version.

Top-k entry: for each chunk size in ``CHUNKS`` (``csrc/knn.cu`` rebuilt with that
``KNN_CHUNK_ROWS``; ptxas' register and spill lines are printed), the
fused top-k launch -- every segment, whatever ``MERGE_MAX_CANDIDATES``
would route elsewhere -- is checked against its plain twin and timed at
two shapes: the 16 segments of 65,536 x 128 of the
scale phase, and one segment of 1,000,000 x 128 (a shard after a large
merge), each at k = 10, 100 and 256.  The route it replaced, the
scores entry (one launch over the segments) plus each segment's stable
sort, is timed at the same shapes.  Times are device milliseconds per
query under ``torch.profiler`` (the sum of every device kernel and copy
of the call; ``device_ms``), each the lower of two readings taken in
turns.  The 16-segment and 1M shapes repeat the same inputs, so L2 (50
MB) may still hold the tail of the previous call's rows.  Prints one JSON line per reading and the
card's name and power limit.  Needs CUDA; without it, exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from opensearch_tpu_torch.testing.profile_scale import (_device_self_us,
                                                        _is_device)

DIM = 128
CHUNKS = (1024, 2048, 4096)
KS = (10, 100, 256)
REPS = 10
WAVES = (1, 2, 4, 8)


def device_ms(fn, reps: int = REPS, attempts: int = 3):
    """Device milliseconds per ``fn()``: every CUDA kernel's and copy's
    own time under the profiler, over ``reps`` calls after a warm-up.
    The profiler sometimes drops a window's device events, in whole or
    in part: the first of ``attempts`` windows that holds ``reps`` times
    the events of a one-call window counts; None when none does."""
    from torch.profiler import ProfilerActivity, profile

    def window(n):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages() if _is_device(e)]
        return (sum(e.count for e in dev),
                sum(_device_self_us(e) for e in dev))

    fn()
    for _ in range(attempts):
        one, _us = window(1)
        count, total = window(reps)
        if one and count == one * reps:
            return total / 1e3 / reps
    return None


def keep_lower(row: dict, key: str, ms, per: int = 1) -> None:
    """``row[key]``: the lower of its readings, each ``ms / per``; a
    reading the profiler did not complete (None) is left out."""
    if ms is not None:
        ms /= per
        row[key] = min(row.get(key) or ms, ms)
    else:
        row.setdefault(key, None)


def scores_sweep(dev, gen) -> None:
    """The scores entry's check and its timings (module doc)."""
    from opensearch_tpu_torch.ops import cuda_knn, knn

    q = torch.randn(DIM, device=dev, generator=gen)

    def segment(n):
        return knn.KnnSegment(torch.randn(n, DIM, device=dev, generator=gen),
                              torch.rand(n, device=dev, generator=gen) > 0.05)

    sixteen = [segment(65_536) for _ in range(16)]
    # (segments, calls): "65536 per call" scores the sixteen 32 MiB
    # segments one call each, in turn, so L2 (50 MB) holds none of them
    # when its call comes (times below are per call)
    shapes = {"65536 per call": (sixteen, 16),
              "16x65536": (sixteen, 1),
              "1x1000000": ([segment(1_000_000)], 1)}

    def new(segs, calls=1):
        if calls > 1:
            return [out for s in segs for out in new([s])]
        return cuda_knn.knn_scores_segments_cuda(segs, q, fn="l2")

    default = cuda_knn.SCORE_WAVES
    try:
        for name, (segs, calls) in shapes.items():
            ref = knn.vector_scores_segments(segs, q, fn="l2")
            for waves in WAVES:
                cuda_knn.SCORE_WAVES = waves
                for a, b in zip(new(segs, calls), ref):
                    if not torch.equal(a.view(torch.int32),
                                       b.view(torch.int32)):
                        raise AssertionError(f"scores {name} waves {waves}: "
                                             "not byte-equal")
            rows = sum(s.vectors.shape[0] for s in segs) // calls
            row = {"entry": "scores", "shape": name, "fn": "l2",
                   "bound_ms": (rows * (DIM * 4 + 1 + 4) + DIM * 4)
                   / 3.35e12 * 1e3}
            for _turn in range(2):
                timed = {f"waves_{w}_ms": w for w in WAVES}
                for key, w in timed.items():
                    cuda_knn.SCORE_WAVES = w
                    row[f"chunk_rows_waves_{w}"] = cuda_knn.score_chunk_rows(
                        rows, DIM, torch.cuda.get_device_properties(
                            dev).multi_processor_count)
                    keep_lower(row, key, device_ms(lambda: new(segs, calls)),
                               calls)
                cuda_knn.SCORE_WAVES = default
                for key, fn in (
                        ("library_ms", lambda: [s.vectors @ q for s in segs]),
                        ("plain_ms", lambda: knn.vector_scores_segments(
                            segs, q, fn="l2"))):
                    # these take a call per segment already
                    keep_lower(row, key, device_ms(fn), calls)
            print(json.dumps(row), flush=True)
    finally:
        cuda_knn.SCORE_WAVES = default


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_sweep: CUDA is not available", file=sys.stderr)
        return 1
    from opensearch_tpu_torch.ops import cuda_build, cuda_knn, knn
    from opensearch_tpu_torch.ops.bm25 import topk
    from opensearch_tpu_torch.testing.parity import topk_mismatch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    scores_sweep(dev, gen)

    def segment(n):
        return knn.KnnSegment(
            torch.randn(n, DIM, device=dev, generator=gen),
            torch.rand(n, device=dev, generator=gen) > 0.05,
            torch.rand(n, device=dev, generator=gen) > 0.05)

    shapes = {"16x65536": [segment(65_536) for _ in range(16)],
              "1x1000000": [segment(1_000_000)]}
    q = torch.randn(DIM, device=dev, generator=gen)
    valid = {name: [s.exists & s.live for s in segs]
             for name, segs in shapes.items()}

    def sorted_route(name, k):
        segs = [knn.KnnSegment(s.vectors, m)
                for s, m in zip(shapes[name], valid[name])]
        return [topk(sc, k) for sc in cuda_knn.knn_scores_segments_cuda(
            segs, q, fn="l2")]

    def fused(name, k):
        return cuda_knn.knn_topk_segments_cuda(shapes[name], q, space="l2",
                                               k=k)

    default = cuda_knn.CHUNK_ROWS, cuda_knn.MERGE_MAX_CANDIDATES
    cuda_knn.MERGE_MAX_CANDIDATES = float("inf")
    try:
        for chunk in CHUNKS:
            cuda_knn.CHUNK_ROWS = chunk
            logs = cuda_build.build(["knn"], {"knn": cuda_knn.defines()})
            for line in logs.get("knn", "").splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas knn chunk {chunk}: {line.strip()}")
            for name, segs in shapes.items():
                for k in KS:
                    bad, _ = topk_mismatch(*(t.cpu().numpy() for t in (
                        fused(name, k)
                        + knn.knn_topk_segments(segs, q, space="l2", k=k))))
                    if bad:
                        raise AssertionError(f"chunk {chunk} {name} k={k}: "
                                             f"{bad}")
        for name in shapes:
            for k in KS:
                row = {"shape": name, "k": k}
                for turn in range(2):
                    for chunk in CHUNKS:
                        cuda_knn.CHUNK_ROWS = chunk
                        keep_lower(row, f"fused_{chunk}_ms",
                                   device_ms(lambda: fused(name, k)))
                    keep_lower(row, "sorted_route_ms",
                               device_ms(lambda: sorted_route(name, k)))
                print(json.dumps(row), flush=True)
    finally:
        cuda_knn.CHUNK_ROWS, cuda_knn.MERGE_MAX_CANDIDATES = default
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
