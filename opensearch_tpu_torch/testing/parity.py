"""Comparison rules between two search responses (this package on two
devices, or this package against the JAX reference).

- BM25 hits compare byte for byte: the same ids in the same order with
  equal float scores, and equal totals.
- k-NN hits compare within ``RTOL``/``ATOL`` (no summation order is
  fixed by the reference): scores agree position by position, and an
  id present on one side only must score within the tolerance of the
  other side's last (k-th) score — a near-tie at the cut.
- Per-segment top-k arrays (``topk_mismatch``) compare by the same
  rule, row by row, with the -inf slots and their ids equal.
- Profiles (``profile_shape``) compare by what does not depend on the
  clock: the keys, the plan's type and description, and the segment
  decisions.
"""

from __future__ import annotations

import math

import numpy as np

from opensearch_tpu_torch.ops.knn import ATOL, RTOL


def hit_pairs(resp: dict) -> list:
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


def profile_shape(resp: dict, seg_ids: bool = True) -> list:
    """What a profile must share with the reference's: each shard
    section's id and keys, engine keys, query keys, breakdown keys, plan
    type and description, segment counts and per-segment decisions (with
    the segments' ids unless ``seg_ids`` is False: two nodes name their
    segments apart), and the coordinator block's keys (never the
    times)."""
    out = []
    for sec in resp["profile"]["shards"]:
        query = sec["searches"][0]["query"][0]
        out.append((sec["id"], sorted(sec), sorted(sec["engine"]),
                    sorted(query), sorted(query["breakdown"]),
                    query["type"], query["description"],
                    sec["engine"]["segments"],
                    [(r["segment"] if seg_ids else None, r["decision"])
                     for r in sec.get("segments", ())]))
    out.append(sorted(resp["profile"].get("coordinator", {})))
    return out


def bm25_mismatch(a: dict, b: dict):
    """None when the two responses agree byte for byte, else a message
    naming the first difference."""
    if a["hits"]["total"] != b["hits"]["total"]:
        return f"totals differ: {a['hits']['total']} vs {b['hits']['total']}"
    pa, pb = hit_pairs(a), hit_pairs(b)
    if len(pa) != len(pb):
        return f"hit counts differ: {len(pa)} vs {len(pb)}"
    for i, (x, y) in enumerate(zip(pa, pb)):
        if x != y:
            return f"first differing hit at index {i}: {x} vs {y}"
    return None


def _close(x: float, y: float, rtol: float, atol: float) -> bool:
    return abs(x - y) <= atol + rtol * abs(y)


def knn_mismatch(a: dict, b: dict, rtol: float = RTOL,
                 atol: float = ATOL):
    """None when the two k-NN responses agree within the tolerance (see
    the module doc), else a message naming the first difference."""
    if a["hits"]["total"] != b["hits"]["total"]:
        return f"totals differ: {a['hits']['total']} vs {b['hits']['total']}"
    pa, pb = hit_pairs(a), hit_pairs(b)
    if len(pa) != len(pb):
        return f"hit counts differ: {len(pa)} vs {len(pb)}"
    for i, ((ia, sa), (ib, sb)) in enumerate(zip(pa, pb)):
        if not (math.isfinite(sa) and math.isfinite(sb)):
            return f"non-finite score at index {i}: {sa} vs {sb}"
        if not _close(sa, sb, rtol, atol):
            return f"scores differ at index {i}: {sa} vs {sb}"
    ids_a = {i for i, _ in pa}
    ids_b = {i for i, _ in pb}
    for ids_x, px, py in ((ids_a - ids_b, pa, pb), (ids_b - ids_a, pb, pa)):
        for doc in ids_x:
            s = dict(px)[doc]
            if not _close(s, py[-1][1], rtol, atol):
                return (f"hit [{doc}] (score {s}) is missing on the other "
                        f"side, whose last score is {py[-1][1]}")
    return None


def topk_mismatch(vals_a, ids_a, vals_b, ids_b, rtol: float = RTOL,
                  atol: float = ATOL):
    """(None or a message naming the first difference, max abs error of
    the finite scores) between two per-segment top-k results, numpy
    ``vals`` f32 [S, k] and ``ids`` i32 [S, k]: -inf positions and the
    ids there equal; finite scores within the tolerance position by
    position; an id on one side only must score within the tolerance of
    the other side's k-th finite score."""
    if vals_a.shape != vals_b.shape or ids_a.shape != ids_b.shape:
        return f"shapes differ: {vals_a.shape} vs {vals_b.shape}", 0.0
    max_err = 0.0
    for s in range(vals_a.shape[0]):
        neg_a, neg_b = np.isneginf(vals_a[s]), np.isneginf(vals_b[s])
        if not np.array_equal(neg_a, neg_b):
            return f"row {s}: -inf positions differ", max_err
        if not np.array_equal(ids_a[s][neg_a], ids_b[s][neg_b]):
            return f"row {s}: ids at -inf differ", max_err
        a, b = vals_a[s][~neg_a], vals_b[s][~neg_b]
        if a.size == 0:
            continue
        max_err = max(max_err, float(np.abs(a - b).max()))
        for i, (x, y) in enumerate(zip(a, b)):
            if not _close(float(x), float(y), rtol, atol):
                return f"row {s}: scores differ at {i}: {x} vs {y}", max_err
        by_a = dict(zip(ids_a[s][~neg_a].tolist(), a.tolist()))
        by_b = dict(zip(ids_b[s][~neg_b].tolist(), b.tolist()))
        for only, scores, kth in ((by_a.keys() - by_b.keys(), by_a, b[-1]),
                                  (by_b.keys() - by_a.keys(), by_b, a[-1])):
            for doc in only:
                if not _close(scores[doc], float(kth), rtol, atol):
                    return (f"row {s}: id {doc} (score {scores[doc]}) on "
                            f"one side only, k-th score {kth}"), max_err
    return None, max_err
