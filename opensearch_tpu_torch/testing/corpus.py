"""Seeded synthetic corpora for ``chip_smoke.py`` and the tests: this
package's own copies of the benchmark's corpus builders
(``bench.py`` ``build_raw_corpus`` / ``make_segments``) and of the
zipf query log (``opensearch_tpu/testing/workload.py``
``zipf_query_log``), with the same draws, plus a seeded generator of
float32 vectors and of doc-value columns (``doc_value_columns``: a
``price`` long, a ``ts`` date and a ``tag`` keyword with postings and
ordinals, ``COLUMNS_MAPPING``).  Pure numpy; segments are this
package's."""

from __future__ import annotations

from typing import Optional

import numpy as np

from opensearch_tpu_torch.index.segment import (NumericDV, OrdinalDV,
                                                PostingsField, Segment,
                                                VectorDV)

VOCAB_SIZE = 30_000
AVG_LEN = 40
PRICE_MAX = 10_000                # price: long, uniform over 0..PRICE_MAX
TS_START_MS = 1_704_067_200_000   # ts: date, 2024-01-01T00:00:00Z ...
TS_SPAN_MS = 365 * 86_400_000     # ... over 365 days, epoch millis
TAG_VALUES = 1_000                # tag: keyword, zipf over 1,000 values
# the mapping of the columns (with ``make_segments``' body and vectors)
COLUMNS_MAPPING = {"price": {"type": "long"}, "ts": {"type": "date"},
                   "tag": {"type": "keyword"}}


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
    doc on average."""
    lens, terms = _draws(n_docs, seed)
    doc_of = np.repeat(np.arange(n_docs, dtype=np.int32), lens)
    order = np.lexsort((doc_of, terms))
    st, sd = terms[order], doc_of[order]
    # unique (term, doc) pairs -> postings entries with tf counts
    key = st.astype(np.int64) * n_docs + sd
    uniq, counts = np.unique(key, return_counts=True)
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
            "doc_lens": lens.astype(np.float32)}


def random_vectors(n: int, dim: int = 128, seed: int = 0) -> np.ndarray:
    """Seeded float32 vectors [n, dim], standard normal."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, dim), dtype=np.float32)


def tag_name(code: int) -> str:
    """The ``tag`` keyword of value ``code``: fixed width, so the sorted
    term dictionary keeps the codes' order."""
    return f"tag{int(code):03d}"


def doc_value_columns(n_docs: int, seed: int = 11) -> dict:
    """Seeded single-valued columns of ``n_docs`` docs: ``price`` int64
    uniform over 0..``PRICE_MAX``, ``ts`` int64 epoch millis uniform over
    ``TS_SPAN_MS`` from ``TS_START_MS``, ``tag`` int32 codes zipf (a =
    1.3) over ``TAG_VALUES`` values (``tag_name`` spells them)."""
    rng = np.random.default_rng(seed)
    return {"price": rng.integers(0, PRICE_MAX + 1, size=n_docs,
                                  dtype=np.int64),
            "ts": TS_START_MS + rng.integers(0, TS_SPAN_MS, size=n_docs,
                                             dtype=np.int64),
            "tag": ((rng.zipf(1.3, size=n_docs) - 1)
                    .clip(0, TAG_VALUES - 1).astype(np.int32))}


def _long_column(values: np.ndarray) -> NumericDV:
    n = len(values)
    return NumericDV(kind="long", offsets=np.arange(n + 1, dtype=np.int32),
                     values=values.astype(np.int64),
                     value_docs=np.arange(n, dtype=np.int32),
                     minv=values.astype(np.int64),
                     maxv=values.astype(np.int64),
                     exists=np.ones(n, dtype=bool))


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
    with a ``body`` postings field (only terms present in a segment get
    a dictionary entry, so can-match can prune it), when ``vectors``
    [n_docs, d] is given a vector field and, when ``columns`` (of
    ``doc_value_columns``) is given, the ``price`` and ``ts`` long
    columns and the ``tag`` keyword's postings and ordinals."""
    n_docs = raw["n_docs"]
    n_segments = max(1, min(int(n_segments), n_docs))
    offsets, df = raw["offsets"], raw["df"]
    doc_ids, tfs, doc_lens = raw["doc_ids"], raw["tfs"], raw["doc_lens"]
    term_of = np.repeat(np.arange(VOCAB_SIZE, dtype=np.int32), df)
    bounds = np.linspace(0, n_docs, n_segments + 1).astype(np.int64)
    segs = []
    for s in range(n_segments):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        n_local = hi - lo
        mask = (doc_ids >= lo) & (doc_ids < hi)
        seg_df = np.bincount(term_of[mask],
                             minlength=VOCAB_SIZE).astype(np.int32)
        seg_offsets = np.zeros(VOCAB_SIZE + 1, dtype=np.int32)
        seg_offsets[1:] = np.cumsum(seg_df)
        local_lens = doc_lens[lo:hi]
        seg = Segment(f"bench_{s}", n_local)
        seg.doc_ids = [str(i) for i in range(lo, hi)]
        seg.id_to_local = {str(i): i - lo for i in range(lo, hi)}
        seg.sources = [b"{}"] * n_local
        seg.postings["body"] = PostingsField(
            terms={f"t{int(t)}": int(t)
                   for t in np.nonzero(seg_df)[0]}, df=seg_df,
            offsets=seg_offsets,
            doc_ids=(doc_ids[mask] - lo).astype(np.int32),
            tfs=tfs[mask],
            pos_offsets=np.zeros(int(mask.sum()) + 1, dtype=np.int32),
            positions=np.zeros(0, dtype=np.int32),
            doc_lens=local_lens, total_len=float(local_lens.sum()),
            docs_with_field=n_local, has_norms=True,
            present=np.ones(n_local, dtype=bool))
        if vectors is not None:
            seg.vector_dv[vector_field] = VectorDV(
                values=np.ascontiguousarray(vectors[lo:hi], np.float32),
                exists=np.ones(n_local, dtype=bool),
                dim=int(vectors.shape[1]), similarity=similarity)
        if columns is not None:
            for name in ("price", "ts"):
                seg.numeric_dv[name] = _long_column(columns[name][lo:hi])
            seg.postings["tag"], seg.ordinal_dv["tag"] = _keyword_columns(
                columns["tag"][lo:hi])
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
