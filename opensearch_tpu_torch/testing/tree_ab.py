"""Per-request A/B of two trees of the port on one card: two worker
processes, one per tree, each build ``profile_scale``'s scale corpus and
answer the same requests in turns (A then B on even requests, B then A
on odd ones), so the host's drift, which moves a process's p50 by tens
of percent from one minute to the next on a shared host, falls on both
trees alike.

    python3 opensearch_tpu_torch/testing/tree_ab.py --a DIR --b DIR
        [--kinds match,bool] [--n N]
        [--device cpu --docs D --segments S]

``DIR`` is a checkout of the port (a parent commit unpacked by ``git
archive``, or this tree); each worker puts its ``DIR`` first on the
path.  The bodies are ``route_ab.py``'s kinds, made once here.  After 5
warm-up requests a kind in turns, each request is timed in its worker,
from the call to the host's read of its answer.  Prints one JSON line a
kind: each tree's p50 and mean ms, the paired differences ``b - a``
(median, quartiles, mean) and the share of requests B took longer; and
the card's name and power limit.  Needs CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import subprocess
import sys
import time

import numpy as np


def worker(root: str, device: str, docs: int, segments: int, conn) -> None:
    """Serve one tree's searcher: a body in, its host ms out; None ends."""
    sys.path.insert(0, os.path.abspath(root))
    from opensearch_tpu_torch.testing import profile_scale

    searcher = profile_scale.build_searcher(docs, segments, device)
    conn.send("ready")
    while True:
        body = conn.recv()
        if body is None:
            break
        t = time.perf_counter()
        searcher.search(body)
        conn.send((time.perf_counter() - t) * 1e3)
    conn.close()


def timed(conn, body) -> float:
    conn.send(body)
    return conn.recv()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--a", required=True)
    ap.add_argument("--b", required=True)
    ap.add_argument("--kinds", default="match,bool")
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--segments", type=int, default=16)
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, here)
    from opensearch_tpu_torch.testing import route_ab

    gpu = "cpu"
    if args.device == "cuda":
        gpu = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    kinds = [k for k in args.kinds.split(",") if k]
    all_bodies = route_ab.bodies(args.n + 5)
    ctx = mp.get_context("spawn")
    conns, procs = {}, []
    for side, root in (("a", args.a), ("b", args.b)):
        mine, theirs = ctx.Pipe()
        p = ctx.Process(target=worker, args=(root, args.device, args.docs,
                                             args.segments, theirs))
        p.start()
        conns[side] = mine
        procs.append(p)
    try:
        for conn in conns.values():
            if conn.recv() != "ready":
                raise RuntimeError("a worker did not start")
        for kind in kinds:
            qs = all_bodies[kind]
            lat = {"a": [], "b": []}
            for i, body in enumerate(qs):
                order = ("a", "b") if i % 2 == 0 else ("b", "a")
                for side in order:
                    ms = timed(conns[side], dict(body))
                    if i >= 5:
                        lat[side].append(ms)
            a, b = np.asarray(lat["a"]), np.asarray(lat["b"])
            d = b - a
            q1, q3 = np.percentile(d, [25, 75])
            print(json.dumps({
                "kind": kind, "a": args.a, "b": args.b, "gpu": gpu,
                "requests": len(d),
                "a_p50_ms": float(np.median(a)),
                "b_p50_ms": float(np.median(b)),
                "a_mean_ms": float(a.mean()), "b_mean_ms": float(b.mean()),
                "diff_median_ms": float(np.median(d)),
                "diff_q1_ms": float(q1), "diff_q3_ms": float(q3),
                "diff_mean_ms": float(d.mean()),
                "b_slower_share": float((d > 0).mean())}), flush=True)
    finally:
        for conn in conns.values():
            conn.send(None)
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.terminate()
    return 0


if __name__ == "__main__":
    sys.exit(main())
