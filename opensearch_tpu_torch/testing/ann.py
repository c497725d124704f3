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
