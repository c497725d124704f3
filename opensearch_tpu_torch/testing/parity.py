"""Comparison rules between two search responses (this package on two
devices, or this package against the JAX reference).

- BM25 hits compare byte for byte: the same ids in the same order with
  equal float scores, and equal totals.
- k-NN hits compare within ``RTOL``/``ATOL`` (no summation order is
  fixed by the reference): scores agree position by position, and an
  id present on one side only must score within the tolerance of the
  other side's last (k-th) score — a near-tie at the cut.
"""

from __future__ import annotations

import math

from opensearch_tpu_torch.ops.knn import ATOL, RTOL


def hit_pairs(resp: dict) -> list:
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


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
