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
a ``pickup`` geo_point and a ``min_terms`` long, ``RELEVANCE_MAPPING``),
and phase 17's corpora, each from its own seed: questions with answers
(``qa_draws``) as nested objects (``nested_segments``) and as parent and
child docs of a join field (``join_segments``), built directly in the
writer's layout, their JSON documents (``qa_documents``), and a
percolator's stored queries and candidate documents
(``percolator_queries``, ``percolator_documents``).
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


# -- phase 17: questions with answers, as nested objects and as parent /
# child docs of a join field, and a percolator index ----------------------

QA_USERS = 100_000                # answers.user: zipf over 100,000 users
QA_ANSWERS_MAX = 6                # 0-6 answers a question, 2 on average
QA_DATE_SPAN_MS = 30 * 86_400_000  # an answer within 30 days of its question
QA_BODY_LENS = (5, 16)            # an answer's body: 5-15 tokens
NESTED_MAPPING = {"tag": {"type": "keyword"}, "created": {"type": "date"},
                  "answers": {"type": "nested", "properties": {
                      "user": {"type": "keyword"},
                      "date": {"type": "date"}}}}
JOIN_MAPPING = {"qa": {"type": "join",
                       "relations": {"question": "answer"}},
                "tag": {"type": "keyword"}, "created": {"type": "date"},
                "user": {"type": "keyword"}, "date": {"type": "date"},
                "body": {"type": "text"}}
PERCOLATOR_MAPPING = {"query": {"type": "percolator"},
                      "body": {"type": "text"}, "ts": {"type": "date"}}


def user_name(code: int) -> str:
    """The ``user`` keyword of user ``code``: fixed width, so the sorted
    term dictionary keeps the codes' order."""
    return f"u{int(code):05d}"


def qa_draws(n_questions: int, seed: int = 21) -> dict:
    """Seeded questions and answers, in the shape of OpenSearch
    Benchmark's ``nested`` workload (StackOverflow questions with nested
    answers): per question a ``tag`` code (zipf, a = 1.3, over
    ``TAG_VALUES``), a ``created`` date (epoch millis over ``TS_SPAN_MS``
    from ``TS_START_MS``) and 0-6 answers (binomial(6, 1/3): 2 on
    average); per answer, in question order, a ``user`` code (zipf, a =
    1.3, over ``QA_USERS``), a ``date`` 1 ms to 30 days after its
    question's, and a ``body`` of 5-15 tokens of ``build_raw_corpus``'s
    vocabulary (zipf, a = 1.3, term ids; ``body_lens`` tokens each, in
    ``body_terms``)."""
    rng = np.random.default_rng(seed)
    tag = ((rng.zipf(1.3, size=n_questions) - 1)
           .clip(0, TAG_VALUES - 1).astype(np.int32))
    created = TS_START_MS + rng.integers(0, TS_SPAN_MS, size=n_questions,
                                         dtype=np.int64)
    n_answers = rng.binomial(QA_ANSWERS_MAX, 1 / 3,
                             size=n_questions).astype(np.int64)
    total = int(n_answers.sum())
    user = ((rng.zipf(1.3, size=total) - 1)
            .clip(0, QA_USERS - 1).astype(np.int32))
    date = (np.repeat(created, n_answers)
            + rng.integers(1, QA_DATE_SPAN_MS, size=total, dtype=np.int64))
    body_lens = rng.integers(*QA_BODY_LENS, size=total).astype(np.int64)
    body_terms = ((rng.zipf(1.3, size=int(body_lens.sum())) - 1)
                  .clip(0, VOCAB_SIZE - 1).astype(np.int32))
    return {"n_questions": n_questions, "tag": tag, "created": created,
            "n_answers": n_answers, "user": user, "date": date,
            "body_lens": body_lens, "body_terms": body_terms}


def qa_documents(draws: dict) -> tuple:
    """``(questions, answers)``: the draws as JSON documents, for the
    writer and over HTTP.  ``questions[i]`` is ``(id, nested document,
    join document)``; ``answers[j]`` ``(id, join document)`` (its nested
    object is the document's ``answers[k]``).  Question ids are ``str(i)``,
    answer ids ``a<j>``."""
    starts = np.cumsum(draws["n_answers"]) - draws["n_answers"]
    bstarts = np.cumsum(draws["body_lens"]) - draws["body_lens"]
    questions, answers = [], []
    for i in range(draws["n_questions"]):
        qid = str(i)
        base = {"tag": tag_name(draws["tag"][i]),
                "created": int(draws["created"][i])}
        objs = []
        for j in range(int(starts[i]), int(starts[i] + draws["n_answers"][i])):
            obj = {"user": user_name(draws["user"][j]),
                   "date": int(draws["date"][j])}
            objs.append(obj)
            lo = int(bstarts[j])
            body = " ".join(f"t{t}" for t in draws["body_terms"][
                lo: lo + int(draws["body_lens"][j])])
            answers.append((f"a{j}", {"qa": {"name": "answer",
                                             "parent": qid},
                                      **obj, "body": body}))
        nested = dict(base, answers=objs) if objs else dict(base)
        questions.append((qid, nested, {"qa": "question", **base}))
    return questions, answers


def _seg_shell(seg_id: str, ids: list) -> Segment:
    seg = Segment(seg_id, len(ids))
    seg.doc_ids = ids
    seg.id_to_local = {d: i for i, d in enumerate(ids)}
    seg.sources = [b"{}"] * len(ids)
    seg.seq_nos[:] = -1               # as the writer stores unsequenced docs
    return seg


def _sorted_names(codes: np.ndarray, name) -> tuple:
    """``(names, ords)``: the sorted distinct ``name(code)`` of ``codes``
    and each code's ordinal among them."""
    uniq, inv = np.unique(codes, return_inverse=True)
    names = np.array([name(c) for c in uniq.tolist()])
    by_name = np.argsort(names, kind="stable")
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[by_name] = np.arange(len(uniq))
    return names[by_name].tolist(), rank[inv].astype(np.int32)


def _keyword_subset(n: int, docs: np.ndarray, codes: np.ndarray,
                    name) -> tuple:
    """(postings, ordinals) of a keyword field that docs ``docs``
    (ascending) of ``n`` hold, one term each (``name(code)`` of
    ``codes``), as the writer builds them: no norms, tf 1, position
    0."""
    names, ords = _sorted_names(codes, name)
    order = np.argsort(ords, kind="stable")       # doc-ascending per term
    df = np.bincount(ords, minlength=len(names)).astype(np.int32)
    offsets = np.zeros(len(names) + 1, dtype=np.int32)
    offsets[1:] = np.cumsum(df)
    has = np.zeros(n, dtype=bool)
    has[docs] = True
    m = len(docs)
    postings = PostingsField(
        terms={t: i for i, t in enumerate(names)}, df=df, offsets=offsets,
        doc_ids=docs[order].astype(np.int32),
        tfs=np.ones(m, dtype=np.float32),
        pos_offsets=np.arange(m + 1, dtype=np.int32),
        positions=np.zeros(m, dtype=np.int32),
        doc_lens=np.ones(n, dtype=np.float32), total_len=float(n),
        docs_with_field=n, has_norms=False, present=has)
    return postings, _ordinal_subset(n, docs, ords, names)


def _ordinal_subset(n: int, docs: np.ndarray, ords: np.ndarray,
                    names: list) -> OrdinalDV:
    """A single-valued ordinal column that docs ``docs`` (ascending) of
    ``n`` hold, with ordinals ``ords`` into ``names`` (sorted)."""
    has = np.zeros(n, dtype=bool)
    has[docs] = True
    per_doc = np.full(n, -1, dtype=np.int32)
    per_doc[docs] = ords
    offsets = np.zeros(n + 1, dtype=np.int32)
    offsets[1:] = np.cumsum(has)
    return OrdinalDV(ord_terms=names,
                     term_to_ord={t: i for i, t in enumerate(names)},
                     offsets=offsets, ords=ords.astype(np.int32),
                     value_docs=docs.astype(np.int32), min_ord=per_doc,
                     max_ord=per_doc.copy(), exists=has)


def _long_subset(n: int, docs: np.ndarray, values: np.ndarray) -> NumericDV:
    """A single-valued long column that docs ``docs`` (ascending) of
    ``n`` hold."""
    from opensearch_tpu_torch.index.segment import (LONG_MISSING_MAX,
                                                    LONG_MISSING_MIN)
    has = np.zeros(n, dtype=bool)
    has[docs] = True
    minv = np.full(n, LONG_MISSING_MAX, dtype=np.int64)
    maxv = np.full(n, LONG_MISSING_MIN, dtype=np.int64)
    minv[docs] = maxv[docs] = values
    offsets = np.zeros(n + 1, dtype=np.int32)
    offsets[1:] = np.cumsum(has)
    return NumericDV(kind="long", offsets=offsets,
                     values=values.astype(np.int64),
                     value_docs=docs.astype(np.int32), minv=minv,
                     maxv=maxv, exists=has)


def _text_subset(n: int, docs: np.ndarray, lens: np.ndarray,
                 terms: np.ndarray) -> PostingsField:
    """A text field that docs ``docs`` (ascending) of ``n`` hold,
    ``lens[k]`` tokens each (term ids ``terms``, in doc order), as the
    writer builds it: the dictionary in the sorted order of the terms'
    names ``t<id>``, rows doc-ascending, each entry's positions
    ascending, norms."""
    doc_of = np.repeat(docs.astype(np.int64), lens)
    starts = np.cumsum(lens) - lens
    pos_of = (np.arange(len(terms), dtype=np.int64)
              - np.repeat(starts, lens)).astype(np.int32)
    present = np.unique(terms)
    names = np.array([f"t{t}" for t in present])
    by_name = np.argsort(names)
    rank = np.empty(len(present), dtype=np.int64)
    rank[by_name] = np.arange(len(present))
    trank = rank[np.searchsorted(present, terms)]
    order = np.lexsort((doc_of, trank))
    key = trank[order] * n + doc_of[order]
    uniq, counts = np.unique(key, return_counts=True)
    pos_offsets = np.zeros(len(counts) + 1, dtype=np.int32)
    pos_offsets[1:] = np.cumsum(counts)
    p_rank = uniq // n
    df = np.bincount(p_rank, minlength=len(present)).astype(np.int32)
    offsets = np.zeros(len(present) + 1, dtype=np.int32)
    offsets[1:] = np.cumsum(df)
    doc_lens = np.zeros(n, dtype=np.float32)
    doc_lens[docs] = lens
    has = np.zeros(n, dtype=bool)
    has[docs] = True
    return PostingsField(
        terms={str(names[i]): r for r, i in enumerate(by_name)},
        df=df, offsets=offsets, doc_ids=(uniq % n).astype(np.int32),
        tfs=counts.astype(np.float32), pos_offsets=pos_offsets,
        positions=pos_of[order], doc_lens=doc_lens,
        total_len=float(doc_lens[doc_lens > 0].sum()),
        docs_with_field=int((doc_lens > 0).sum()), has_norms=True,
        present=has)


def _question_bounds(draws: dict, n_segments: int) -> np.ndarray:
    n = draws["n_questions"]
    return np.linspace(0, n, max(1, min(int(n_segments), n)) + 1
                       ).astype(np.int64)


def nested_segments(draws: dict, n_segments: int) -> list[Segment]:
    """The questions of ``draws`` split into ``n_segments`` segments of
    ``NESTED_MAPPING``, laid out as the writer lays out their
    ``qa_documents`` nested documents: ``tag`` postings and ordinals,
    ``created`` long column, and the ``answers`` nested block (objects
    appended in doc order; ``answers.date`` float64 values,
    ``answers.user`` ordinals in sorted term order).  Sources are
    ``{}``."""
    from opensearch_tpu_torch.index.segment import NestedBlock

    bounds = _question_bounds(draws, n_segments)
    a_starts = np.concatenate([[0], np.cumsum(draws["n_answers"])])
    segs = []
    for s in range(len(bounds) - 1):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        n = hi - lo
        seg = _seg_shell(f"nested_{s}", [str(i) for i in range(lo, hi)])
        docs = np.arange(n, dtype=np.int64)
        seg.postings["tag"], seg.ordinal_dv["tag"] = _keyword_subset(
            n, docs, draws["tag"][lo:hi], tag_name)
        seg.numeric_dv["created"] = _long_subset(n, docs,
                                                 draws["created"][lo:hi])
        a_lo, a_hi = int(a_starts[lo]), int(a_starts[hi])
        if a_hi > a_lo:
            objs = np.arange(a_hi - a_lo, dtype=np.int32)
            block = NestedBlock(obj_to_doc=np.repeat(
                docs, draws["n_answers"][lo:hi]).astype(np.int32))
            names, ords = _sorted_names(draws["user"][a_lo:a_hi],
                                        user_name)
            block.ordinal["answers.user"] = (names, ords, objs)
            block.numeric["answers.date"] = (
                draws["date"][a_lo:a_hi].astype(np.float64), objs.copy())
            seg.nested["answers"] = block
        segs.append(seg)
    return segs


def join_segments(draws: dict, n_segments: int) -> list[Segment]:
    """The questions and answers of ``draws`` as parent and child docs of
    ``JOIN_MAPPING``'s ``qa`` join field, split into ``n_segments``
    segments by question with each question's answers in its segment,
    each question followed by its answers; laid out as the writer lays
    out their ``qa_documents`` join documents: ``qa#name`` and
    ``qa#parent`` ordinals, ``tag`` / ``created`` on questions, ``user``
    / ``date`` / ``body`` (positions, norms) on answers.  Sources are
    ``{}``."""
    bounds = _question_bounds(draws, n_segments)
    n_ans = draws["n_answers"]
    a_starts = np.concatenate([[0], np.cumsum(n_ans)])
    b_starts = np.concatenate([[0], np.cumsum(draws["body_lens"])])
    segs = []
    for s in range(len(bounds) - 1):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        a_lo, a_hi = int(a_starts[lo]), int(a_starts[hi])
        per_q = n_ans[lo:hi] + 1
        n = int(per_q.sum())
        q_docs = (np.cumsum(per_q) - per_q).astype(np.int64)
        is_q = np.zeros(n, dtype=bool)
        is_q[q_docs] = True
        a_docs = np.nonzero(~is_q)[0].astype(np.int64)
        ids = np.empty(n, dtype=object)
        ids[q_docs] = [str(i) for i in range(lo, hi)]
        ids[a_docs] = [f"a{j}" for j in range(a_lo, a_hi)]
        seg = _seg_shell(f"join_{s}", ids.tolist())
        names, name_ords = np.unique(np.where(is_q, "question", "answer"),
                                     return_inverse=True)
        seg.ordinal_dv["qa#name"] = _ordinal_subset(
            n, np.arange(n, dtype=np.int64), name_ords.astype(np.int32),
            names.tolist())
        seg.postings["tag"], seg.ordinal_dv["tag"] = _keyword_subset(
            n, q_docs, draws["tag"][lo:hi], tag_name)
        seg.numeric_dv["created"] = _long_subset(n, q_docs,
                                                 draws["created"][lo:hi])
        if a_hi > a_lo:
            names, ords = _sorted_names(
                np.repeat(np.arange(lo, hi), n_ans[lo:hi]), str)
            seg.ordinal_dv["qa#parent"] = _ordinal_subset(n, a_docs, ords,
                                                          names)
            seg.postings["user"], seg.ordinal_dv["user"] = _keyword_subset(
                n, a_docs, draws["user"][a_lo:a_hi], user_name)
            seg.numeric_dv["date"] = _long_subset(n, a_docs,
                                                  draws["date"][a_lo:a_hi])
            seg.postings["body"] = _text_subset(
                n, a_docs, draws["body_lens"][a_lo:a_hi],
                draws["body_terms"][int(b_starts[a_lo]):
                                    int(b_starts[a_hi])])
        segs.append(seg)
    return segs


def percolator_queries(n: int, seed: int = 23) -> list:
    """Seeded stored queries over ``body`` text, in the shape of OpenSearch
    Benchmark's ``percolator`` workload (short AOL-log queries): a
    ``match`` of 1-4 zipf terms (a = 1.3, ``build_raw_corpus``'s
    vocabulary), a ``match_phrase`` of 2-3 terms, or a ``bool`` of a
    ``match`` and a ``range`` on ``ts`` (a 30-day window), in turn with
    probabilities 0.6 / 0.2 / 0.2."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kind = rng.random()
        if kind < 0.6:
            k = int(rng.integers(1, 5))
        else:
            k = int(rng.integers(2, 4))
        words = " ".join(f"t{int(t)}" for t in (rng.zipf(1.3, size=k) - 1)
                         .clip(0, VOCAB_SIZE - 1))
        if kind < 0.6:
            out.append({"match": {"body": words}})
        elif kind < 0.8:
            out.append({"match_phrase": {"body": words}})
        else:
            lo = TS_START_MS + int(rng.integers(0, TS_SPAN_MS))
            out.append({"bool": {"must": [{"match": {"body": words}}],
                                 "filter": [{"range": {"ts": {
                                     "gte": lo,
                                     "lt": lo + 30 * 86_400_000}}}]}})
    return out


def percolator_documents(n: int, seed: int = 24) -> list:
    """Seeded candidate documents for ``percolate``: a ``body`` of
    ``build_raw_corpus``'s shape (20-60 zipf tokens) and a ``ts``."""
    lens, terms = _draws(n, seed)
    rng = np.random.default_rng(seed + 1)
    ends = np.cumsum(lens)
    return [{"body": " ".join(f"t{t}" for t in terms[e - ln: e]),
             "ts": TS_START_MS + int(rng.integers(0, TS_SPAN_MS))}
            for ln, e in zip(lens.tolist(), ends.tolist())]
