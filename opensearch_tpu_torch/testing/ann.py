"""BASELINE config 3, ANN search, at GloVe-100's shape: the corpus, the
mappings and the request bodies of ``chip_smoke.py`` phase 13 and of
``profile_scale --ann``.

GloVe-100 (ann-benchmarks ``glove-100-angular``: 1,183,514 train vectors
of 100 dims, angular distance) is not in the repository and cannot be
fetched, so the corpus has its shape and clustered synthetic values
(``corpus.clustered_vectors``, ``CENTERS`` centres), split into
``SEGMENTS`` segments with the ``price``, ``ts``, ``tag`` and ``fare``
columns of ``corpus.doc_value_columns``.  The field ``vec`` is mapped
as config 3 maps it: ``ivf_pq`` with ``m = M`` in the cosine space,
which probes the flat layout (K6), or, by a second mapper over the same
segments, in l2 (the ADC route, K7); exact mappers of both spaces give
the truth for recall.
"""

from __future__ import annotations

import numpy as np

DOCS = 1_183_514        # glove-100-angular's train split
DIM = 100
CENTERS = 4_096
SEGMENTS = 16           # ~73,970 rows each: default nlist 271, nprobe 33
M = 10                  # ivf_pq subspaces (10 dims each)


def corpus_segments(n_docs: int = DOCS, n_queries: int = 0,
                    seed: int = 61, n_segments: int = SEGMENTS,
                    centers: int = CENTERS) -> tuple:
    """(segments, held-out queries f32 [n_queries, DIM]): ``n_docs +
    n_queries`` clustered vectors drawn together, the last ``n_queries``
    held out as queries (fresh points of the same distribution)."""
    from opensearch_tpu_torch.testing import corpus

    allv = corpus.clustered_vectors(n_docs + n_queries, DIM, centers,
                                    seed=seed)
    segs = corpus.vector_segments(
        allv[:n_docs], n_segments, similarity="cosinesimil",
        columns=corpus.doc_value_columns(n_docs, seed=seed + 1))
    return segs, allv[n_docs:]


def mapper(space: str, method: bool):
    """``vec`` in ``space``: config 3's ``ivf_pq`` (``m = M``) when
    ``method``, else exact; the columns of ``corpus.COLUMNS_MAPPING``."""
    from opensearch_tpu_torch.mapping.mapper import DocumentMapper
    from opensearch_tpu_torch.testing.corpus import COLUMNS_MAPPING

    vec = {"type": "knn_vector", "dimension": DIM}
    if method:
        vec["method"] = {"name": "ivf_pq", "space_type": space,
                         "parameters": {"m": M}}
    else:
        vec["space_type"] = space
    return DocumentMapper({"properties": {"vec": vec, **COLUMNS_MAPPING}})


def body(q, k: int = 10, **extra) -> dict:
    """A ``knn`` request on ``vec`` for query vector ``q``."""
    return {"size": k, "query": {"knn": {"vec": {
        "vector": [float(x) for x in q], "k": k, **extra}}}}


# Cluster sizes of the skewed layouts (``skewed_arrays``): a cluster of
# exactly c_pad rows spanning several scan chunks, an empty cluster and
# one of one row; one cluster holding most of a segment; nlist 1; nlist
# below the probe's blocks per (query, segment); nlist 2,000 (a probe
# block's slice of centroids takes several passes), small clusters.
SKEWED = {"full_cluster": [1024, 700, 3, 0, 260, 1],
          "most_of_segment": [2900, 30, 20, 10, 1],
          "nlist_1": [900],
          "nlist_3": [300, 5, 40],
          "nlist_2000": [64 if c == 1000 else c * 7 % 13
                         for c in range(2000)]}
# Wide rows: K6's stages then hold fewer rows than one pass of the
# block's row groups, and K7's table pass reads a codebook subspace of
# 256 x 96 floats from device memory (m = 8), or, at m = M_MAX = 128,
# the scan takes smaller chunks so that its codes fit shared memory.
WIDE_D = 768
WIDE_MS = (8, 128)
TIE_STRIDE = 64       # duplicates straddle every multiple of this position


def skewed_arrays(sizes, d: int, m: int = 0, seed: int = 0) -> dict:
    """The numpy fields of an IVF (``m = 0``) or IVF-PQ index laid out by
    hand (``ops.ivf.ivf_index_from_arrays`` / ``ivfpq_index_from_arrays``,
    and the JAX package's search functions, take them): cluster c holds
    ``sizes[c]`` rows near its centroid, doc ids a permutation of the
    rows, ``c_pad`` the next power of two of the largest cluster.  In the
    largest cluster the 4 rows (and codes) around every multiple of
    ``TIE_STRIDE`` repeat one row, so tied scores straddle the boundary
    of any scan chunk of a multiple of that size."""
    from opensearch_tpu_torch.index.segment import pad_pow2

    rng = np.random.default_rng(seed)
    nlist, n = len(sizes), sum(sizes)
    c_pad = pad_pow2(max(max(sizes), 1))
    centroids = (rng.normal(size=(nlist, d)) * 3).astype(np.float32)
    grouped = np.zeros((nlist, c_pad, d), np.float32)
    ids = np.full((nlist, c_pad), -1, np.int32)
    valid = np.zeros((nlist, c_pad), bool)
    perm = rng.permutation(n).astype(np.int32)
    at = 0
    for c, size in enumerate(sizes):
        grouped[c, :size] = centroids[c] + rng.normal(size=(size, d)) * 0.5
        ids[c, :size] = perm[at: at + size]
        valid[c, :size] = True
        at += size
    big = int(np.argmax(sizes))
    out = {"centroids": centroids, "grouped": grouped, "grouped_ids": ids,
           "grouped_valid": valid}
    if m:
        out["codebooks"] = rng.normal(size=(m, 256, d // m)).astype(
            np.float32)
        out["grouped_codes"] = rng.integers(0, 256, size=(nlist, c_pad, m),
                                            dtype=np.uint8)
        del out["grouped"]
    for b in range(TIE_STRIDE, sizes[big] - 1, TIE_STRIDE):
        for name in ("grouped", "grouped_codes"):
            if name in out:
                out[name][big, b - 2: b + 2] = out[name][big, b - 2]
    return out


def skewed_index(sizes, d: int, m: int = 0, seed: int = 0):
    """``skewed_arrays`` as the port's ``IvfIndex`` / ``IvfPqIndex`` (on
    the CPU)."""
    from opensearch_tpu_torch.ops import ivf

    a = skewed_arrays(sizes, d, m, seed)
    if m:
        return ivf.ivfpq_index_from_arrays(
            a["centroids"], a["codebooks"], a["grouped_codes"],
            a["grouped_ids"], a["grouped_valid"])
    return ivf.ivf_index_from_arrays(a["centroids"], a["grouped"],
                                     a["grouped_ids"], a["grouped_valid"])
