"""K1's top-k entry against the route it replaced, and its chunk size,
on the card.

    python3 -m opensearch_tpu_torch.testing.k1_sweep

For each chunk size in ``CHUNKS`` (``csrc/knn.cu`` rebuilt with that
``KNN_CHUNK_ROWS``; ptxas' register and spill lines are printed), the
fused top-k launch -- every segment, whatever ``MERGE_MAX_CANDIDATES``
would route elsewhere -- is checked against its plain twin and timed at
two shapes: the 16 segments of 65,536 x 128 of the
scale phase, and one segment of 1,000,000 x 128 (a shard after a large
merge), each at k = 10, 100 and 256.  The route it replaced, the
scores-only entry per segment plus the stable sort, is timed at the same
shapes.  Times are device milliseconds per query under ``torch.profiler``
(the sum of every device kernel and copy of the call), each the lower of
two readings taken in turns.  Prints one JSON line per reading and the
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


def device_ms(fn, reps: int = REPS) -> float:
    """Device milliseconds per ``fn()``: every CUDA kernel's and copy's
    own time under the profiler, over ``reps`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(_device_self_us(e) for e in prof.key_averages()
               if _is_device(e)) / 1e3 / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_sweep: CUDA is not available", file=sys.stderr)
        return 1
    from opensearch_tpu_torch.ops import cuda_build, cuda_knn, knn
    from opensearch_tpu_torch.ops.bm25 import topk
    from opensearch_tpu_torch.testing.parity import topk_mismatch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

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
        return [topk(cuda_knn.knn_scores_cuda(s.vectors, m, q, space="l2"), k)
                for s, m in zip(shapes[name], valid[name])]

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
                        ms = device_ms(lambda: fused(name, k))
                        key = f"fused_{chunk}_ms"
                        row[key] = min(row.get(key, ms), ms)
                    ms = device_ms(lambda: sorted_route(name, k))
                    row["sorted_route_ms"] = min(
                        row.get("sorted_route_ms", ms), ms)
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
