"""Seeded synthetic corpora for ``chip_smoke.py`` and the tests: this
package's own copies of the benchmark's corpus builders
(``bench.py`` ``build_raw_corpus`` / ``make_segments``) and of the
zipf query log (``opensearch_tpu/testing/workload.py``
``zipf_query_log``), with the same draws, a seeded log of phrases that
occur in the corpus (``phrase_query_log``), plus seeded generators of
float32 vectors (``random_vectors``; ``clustered_vectors`` for ANN) and
of doc-value columns (``doc_value_columns``: a
``price`` long, a ``ts`` date, a ``tag`` keyword with postings and
ordinals and a ``fare`` double, ``COLUMNS_MAPPING``; ``relevance_columns``:
a ``pickup`` geo_point and a ``min_terms`` long, ``RELEVANCE_MAPPING``).
Pure numpy; segments are this package's."""

from __future__ import annotations

from typing import Optional

import numpy as np

from opensearch_tpu_torch.index.segment import (GeoDV, NumericDV,
                                                OrdinalDV, PostingsField,
                                                Segment, VectorDV)

VOCAB_SIZE = 30_000
AVG_LEN = 40
PRICE_MAX = 10_000                # price: long, uniform over 0..PRICE_MAX
TS_START_MS = 1_704_067_200_000   # ts: date, 2024-01-01T00:00:00Z ...
TS_SPAN_MS = 365 * 86_400_000     # ... over 365 days, epoch millis
TAG_VALUES = 1_000                # tag: keyword, zipf over 1,000 values
# the mapping of the columns (with ``make_segments``' body and vectors)
COLUMNS_MAPPING = {"price": {"type": "long"}, "ts": {"type": "date"},
                   "tag": {"type": "keyword"}, "fare": {"type": "double"}}


def _draws(n_docs: int, seed: int) -> tuple:
    """(tokens per doc, the term ids of every token in doc order)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(AVG_LEN // 2, AVG_LEN * 3 // 2, size=n_docs)
    total = int(lens.sum())
    terms = (rng.zipf(1.3, size=total) - 1).clip(0, VOCAB_SIZE - 1).astype(np.int32)
    return lens, terms


def render_texts(n_docs: int, seed: int = 42) -> list[str]:
    """The docs of ``build_raw_corpus(n_docs, seed)`` as text, for the
    write path: the same draws, each token written ``t<term id>``, so
    the mapper's postings of these texts are that corpus's postings."""
    lens, terms = _draws(n_docs, seed)
    names = [f"t{t}" for t in range(VOCAB_SIZE)]
    words = [names[t] for t in terms.tolist()]
    ends = np.cumsum(lens).tolist()
    starts = [0] + ends[:-1]
    return [" ".join(words[a:b]) for a, b in zip(starts, ends)]


def build_raw_corpus(n_docs: int, seed: int = 42) -> dict:
    """Vectorized synthetic corpus -> raw CSR postings over a zipf
    (a = 1.3) vocabulary of ``VOCAB_SIZE`` terms, ``AVG_LEN`` tokens per
    doc on average, with each posting entry's positions (``pos_offsets``
    [P + 1], ``positions``: a token's index within its doc)."""
    lens, terms = _draws(n_docs, seed)
    doc_of = np.repeat(np.arange(n_docs, dtype=np.int32), lens)
    # a token's position is its index within its doc; the stable sort
    # keeps a (term, doc) pair's positions ascending
    starts = np.cumsum(lens) - lens
    pos_of = (np.arange(len(terms), dtype=np.int64)
              - np.repeat(starts, lens)).astype(np.int32)
    order = np.lexsort((doc_of, terms))
    st, sd = terms[order], doc_of[order]
    # unique (term, doc) pairs -> postings entries with tf counts
    key = st.astype(np.int64) * n_docs + sd
    uniq, counts = np.unique(key, return_counts=True)
    pos_offsets = np.zeros(len(counts) + 1, dtype=np.int32)
    pos_offsets[1:] = np.cumsum(counts)
    p_terms = (uniq // n_docs).astype(np.int32)
    p_docs = (uniq % n_docs).astype(np.int32)
    tfs = counts.astype(np.float32)
    present_terms, term_starts = np.unique(p_terms, return_index=True)
    offsets = np.zeros(VOCAB_SIZE + 1, dtype=np.int32)
    df = np.zeros(VOCAB_SIZE, dtype=np.int32)
    df[present_terms] = np.diff(np.append(term_starts, len(p_terms)))
    offsets[1:] = np.cumsum(df)
    return {"n_docs": n_docs, "offsets": offsets, "df": df,
            "doc_ids": p_docs, "tfs": tfs,
            "doc_lens": lens.astype(np.float32),
            "pos_offsets": pos_offsets, "positions": pos_of[order]}


def random_vectors(n: int, dim: int = 128, seed: int = 0) -> np.ndarray:
    """Seeded float32 vectors [n, dim], standard normal."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, dim), dtype=np.float32)


def clustered_vectors(n: int, dim: int, n_centers: int,
                      seed: int = 5) -> np.ndarray:
    """Seeded clustered float32 vectors [n, dim] (the construction of
    ``tests/test_ivf.py`` ``_corpus``, "GloVe-like local structure"):
    ``n_centers`` standard normal centres times 4, each vector a random
    centre plus standard normal noise."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, dim)).astype(np.float32) * 4
    assign = rng.integers(0, n_centers, size=n)
    x = centers[assign] + rng.normal(size=(n, dim)).astype(np.float32)
    return x.astype(np.float32)


def tag_name(code: int) -> str:
    """The ``tag`` keyword of value ``code``: fixed width, so the sorted
    term dictionary keeps the codes' order."""
    return f"tag{int(code):03d}"


def doc_value_columns(n_docs: int, seed: int = 11) -> dict:
    """Seeded single-valued columns of ``n_docs`` docs: ``price`` int64
    uniform over 0..``PRICE_MAX``, ``ts`` int64 epoch millis uniform over
    ``TS_SPAN_MS`` from ``TS_START_MS``, ``tag`` int32 codes zipf (a =
    1.3) over ``TAG_VALUES`` values (``tag_name`` spells them), ``fare``
    float64 lognormal (median ~10, a taxi fare's shape) rounded to
    cents."""
    rng = np.random.default_rng(seed)
    cols = {"price": rng.integers(0, PRICE_MAX + 1, size=n_docs,
                                  dtype=np.int64),
            "ts": TS_START_MS + rng.integers(0, TS_SPAN_MS, size=n_docs,
                                             dtype=np.int64),
            "tag": ((rng.zipf(1.3, size=n_docs) - 1)
                    .clip(0, TAG_VALUES - 1).astype(np.int32))}
    # drawn last, so the other columns stay what they were without it
    cols["fare"] = np.round(rng.lognormal(2.3, 0.6, size=n_docs), 2)
    return cols


# relevance_columns: the nyc_taxis workload's pickup box and Midtown
PICKUP_BOX = (40.50, 40.92, -74.26, -73.70)   # lat lo, lat hi, lon lo, hi
MIDTOWN = (40.758, -73.9855)
RELEVANCE_MAPPING = {"pickup": {"type": "geo_point"},
                     "min_terms": {"type": "long"}}


def relevance_columns(n_docs: int, seed: int = 16) -> dict:
    """Seeded columns of ``n_docs`` docs for the relevance and geo
    queries, drawn apart from ``doc_value_columns`` so its columns stay
    what they are: ``pickup`` (lat, lon) float64 pairs in the nyc_taxis
    workload's pickup box (``PICKUP_BOX``), 80% normal around Midtown
    (sigma 0.015 degrees, ~1.5 km, clipped to the box) and 20% uniform
    over the box, each rounded to 6 decimals; ``min_terms`` int64 uniform
    over 1..4 (``terms_set``'s per-doc minimum)."""
    rng = np.random.default_rng(seed)
    lat_lo, lat_hi, lon_lo, lon_hi = PICKUP_BOX
    near = rng.uniform(size=n_docs) < 0.8
    lats = np.where(near, rng.normal(MIDTOWN[0], 0.015, size=n_docs),
                    rng.uniform(lat_lo, lat_hi, size=n_docs))
    lons = np.where(near, rng.normal(MIDTOWN[1], 0.015, size=n_docs),
                    rng.uniform(lon_lo, lon_hi, size=n_docs))
    return {"pickup": (np.round(np.clip(lats, lat_lo, lat_hi), 6),
                       np.round(np.clip(lons, lon_lo, lon_hi), 6)),
            "min_terms": rng.integers(1, 5, size=n_docs, dtype=np.int64)}


def _long_column(values: np.ndarray, kind: str = "long") -> NumericDV:
    n = len(values)
    dtype = np.int64 if kind == "long" else np.float64
    return NumericDV(kind=kind, offsets=np.arange(n + 1, dtype=np.int32),
                     values=values.astype(dtype),
                     value_docs=np.arange(n, dtype=np.int32),
                     minv=values.astype(dtype),
                     maxv=values.astype(dtype),
                     exists=np.ones(n, dtype=bool))


def _double_column(values: np.ndarray) -> NumericDV:
    return _long_column(values, kind="double")


def _keyword_columns(codes: np.ndarray) -> tuple:
    """(postings, ordinals) of a single-valued keyword column, as the
    writer builds them for a keyword field: no norms, tf 1."""
    n = len(codes)
    present = np.unique(codes)
    terms = [tag_name(c) for c in present]
    ords = np.searchsorted(present, codes).astype(np.int32)
    order = np.argsort(ords, kind="stable")       # doc-ascending per term
    df = np.bincount(ords, minlength=len(terms)).astype(np.int32)
    offsets = np.zeros(len(terms) + 1, dtype=np.int32)
    offsets[1:] = np.cumsum(df)
    postings = PostingsField(
        terms={t: i for i, t in enumerate(terms)}, df=df, offsets=offsets,
        doc_ids=order.astype(np.int32), tfs=np.ones(n, dtype=np.float32),
        pos_offsets=np.arange(n + 1, dtype=np.int32),
        positions=np.zeros(n, dtype=np.int32),
        doc_lens=np.ones(n, dtype=np.float32), total_len=float(n),
        docs_with_field=n, has_norms=False,
        present=np.ones(n, dtype=bool))
    ordinal = OrdinalDV(
        ord_terms=terms, term_to_ord={t: i for i, t in enumerate(terms)},
        offsets=np.arange(n + 1, dtype=np.int32), ords=ords,
        value_docs=np.arange(n, dtype=np.int32), min_ord=ords.copy(),
        max_ord=ords.copy(), exists=np.ones(n, dtype=bool))
    return postings, ordinal


def make_segments(raw: dict, n_segments: int,
                  vectors: Optional[np.ndarray] = None,
                  vector_field: str = "vec",
                  similarity: str = "l2",
                  columns: Optional[dict] = None) -> list[Segment]:
    """Split the raw CSR corpus into ``n_segments`` doc-range segments
    with a ``body`` postings field and its positions (only terms present
    in a segment get a dictionary entry, so can-match can prune it; term
    ids in the sorted order of the terms, as the writer's), when
    ``vectors`` [n_docs, d] is given a vector field and, when
    ``columns`` (of ``doc_value_columns``) is given, the ``price`` and
    ``ts`` long columns, the ``tag`` keyword's postings and ordinals and,
    when the columns hold them, the ``fare`` double column, the
    ``pickup`` geo_point column and the ``min_terms`` long column (of
    ``relevance_columns``)."""
    n_docs = raw["n_docs"]
    n_segments = max(1, min(int(n_segments), n_docs))
    offsets, df = raw["offsets"], raw["df"]
    doc_ids, tfs, doc_lens = raw["doc_ids"], raw["tfs"], raw["doc_lens"]
    term_of = np.repeat(np.arange(VOCAB_SIZE, dtype=np.int32), df)
    pos_counts = np.diff(raw["pos_offsets"])
    # each term's rank in the sorted dictionary of every term's name: a
    # segment's term ids follow it, as the writer's do (prefix, wildcard
    # and range queries binary-search the sorted dictionary)
    names = np.array([f"t{t}" for t in range(VOCAB_SIZE)])
    rank = np.empty(VOCAB_SIZE, dtype=np.int64)
    rank[np.argsort(names)] = np.arange(VOCAB_SIZE)
    bounds = np.linspace(0, n_docs, n_segments + 1).astype(np.int64)
    segs = []
    for s in range(n_segments):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        n_local = hi - lo
        mask = (doc_ids >= lo) & (doc_ids < hi)
        seg_df = np.bincount(term_of[mask], minlength=VOCAB_SIZE)
        present = np.nonzero(seg_df)[0]
        present = present[np.argsort(rank[present])]
        local = np.zeros(VOCAB_SIZE, dtype=np.int64)
        local[present] = np.arange(len(present))
        # the segment's postings in its dictionary's order (stable: a
        # term's rows stay doc-ascending), each entry's positions with it
        perm = np.argsort(local[term_of[mask]], kind="stable")
        counts = pos_counts[mask]
        old_starts = np.cumsum(counts) - counts
        counts = counts[perm]
        seg_pos_offsets = np.zeros(len(perm) + 1, dtype=np.int32)
        seg_pos_offsets[1:] = np.cumsum(counts)
        gather = (np.repeat(old_starts[perm] - seg_pos_offsets[:-1], counts)
                  + np.arange(int(seg_pos_offsets[-1])))
        seg_positions = raw["positions"][np.repeat(mask, pos_counts)][gather]
        seg_df = seg_df[present].astype(np.int32)
        seg_offsets = np.zeros(len(present) + 1, dtype=np.int32)
        seg_offsets[1:] = np.cumsum(seg_df)
        local_lens = doc_lens[lo:hi]
        seg = Segment(f"bench_{s}", n_local)
        seg.doc_ids = [str(i) for i in range(lo, hi)]
        seg.id_to_local = {str(i): i - lo for i in range(lo, hi)}
        seg.sources = [b"{}"] * n_local
        seg.postings["body"] = PostingsField(
            terms={f"t{int(t)}": i for i, t in enumerate(present)},
            df=seg_df, offsets=seg_offsets,
            doc_ids=(doc_ids[mask] - lo).astype(np.int32)[perm],
            tfs=tfs[mask][perm],
            pos_offsets=seg_pos_offsets,
            positions=seg_positions,
            doc_lens=local_lens, total_len=float(local_lens.sum()),
            docs_with_field=n_local, has_norms=True,
            present=np.ones(n_local, dtype=bool))
        _add_fields(seg, lo, hi, vectors, vector_field, similarity, columns)
        segs.append(seg)
    return segs


def _add_fields(seg: Segment, lo: int, hi: int,
                vectors: Optional[np.ndarray], vector_field: str,
                similarity: str, columns: Optional[dict]) -> None:
    """Docs ``lo:hi``'s vectors and doc-value columns on ``seg``."""
    if vectors is not None:
        seg.vector_dv[vector_field] = VectorDV(
            values=np.ascontiguousarray(vectors[lo:hi], np.float32),
            exists=np.ones(hi - lo, dtype=bool),
            dim=int(vectors.shape[1]), similarity=similarity)
    if columns is not None:
        for name in ("price", "ts"):
            seg.numeric_dv[name] = _long_column(columns[name][lo:hi])
        seg.postings["tag"], seg.ordinal_dv["tag"] = _keyword_columns(
            columns["tag"][lo:hi])
        if "fare" in columns:
            seg.numeric_dv["fare"] = _double_column(columns["fare"][lo:hi])
        if "pickup" in columns:
            lats, lons = (a[lo:hi] for a in columns["pickup"])
            n = hi - lo
            seg.geo_dv["pickup"] = GeoDV(
                offsets=np.arange(n + 1, dtype=np.int32),
                lats=lats.astype(np.float32), lons=lons.astype(np.float32),
                value_docs=np.arange(n, dtype=np.int32),
                exists=np.ones(n, dtype=bool))
        if "min_terms" in columns:
            seg.numeric_dv["min_terms"] = _long_column(
                columns["min_terms"][lo:hi])


def vector_segments(vectors: np.ndarray, n_segments: int,
                    vector_field: str = "vec", similarity: str = "l2",
                    columns: Optional[dict] = None) -> list[Segment]:
    """``vectors`` [n_docs, d] split into ``n_segments`` doc-range
    segments holding a vector field (every doc has a vector) and, when
    ``columns`` (of ``doc_value_columns``) is given, the columns of
    ``make_segments``; no text field."""
    n_docs = vectors.shape[0]
    bounds = np.linspace(0, n_docs, max(1, n_segments) + 1).astype(np.int64)
    segs = []
    for s in range(len(bounds) - 1):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        seg = Segment(f"vectors_{s}", hi - lo)
        seg.doc_ids = [str(i) for i in range(lo, hi)]
        seg.id_to_local = {str(i): i - lo for i in range(lo, hi)}
        seg.sources = [b"{}"] * (hi - lo)
        _add_fields(seg, lo, hi, vectors, vector_field, similarity, columns)
        segs.append(seg)
    return segs


def zipf_query_log(n_queries: int, vocab_size: int = VOCAB_SIZE,
                   seed: int = 7, a: float = 1.3) -> list:
    """Seeded zipf query log: ``n_queries`` two-term BM25 queries over a
    ranked vocabulary, as (term id, term id) pairs."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n_queries):
        x, y = (rng.zipf(a, size=2) - 1).clip(0, vocab_size - 1)
        pairs.append((int(x), int(y)))
    return pairs


def phrase_query_log(n_queries: int, seed: int = 13,
                     n_docs: int = 1_000_000, corpus_seed: int = 42,
                     lengths: tuple = (2, 5)) -> list:
    """Seeded phrases of ``build_raw_corpus(n_docs, corpus_seed)``: each a
    run of ``lengths[0]``..``lengths[1]`` consecutive tokens of a drawn
    doc from a drawn offset, as a tuple of term ids, so each occurs in the
    corpus at least once.  A span query takes its clauses from the same
    runs (``span_clauses``)."""
    lens, terms = _draws(n_docs, corpus_seed)
    starts = np.cumsum(lens) - lens
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_queries):
        doc = int(rng.integers(0, n_docs))
        length = int(rng.integers(lengths[0], lengths[1] + 1))
        length = min(length, int(lens[doc]))
        off = int(rng.integers(0, int(lens[doc]) - length + 1))
        a = int(starts[doc]) + off
        out.append(tuple(int(t) for t in terms[a: a + length]))
    return out


def span_clauses(run: tuple, k: int) -> tuple:
    """``(clause terms, slop)`` of a span over a run of
    ``phrase_query_log``: its first ``k - 1`` tokens and its last, whose
    gap in the run is the slop an ordered span needs to match it."""
    k = max(1, min(k, len(run)))
    if k == 1:
        return run[:1], 0
    picked = run[: k - 1] + run[-1:]
    return picked, len(run) - k
