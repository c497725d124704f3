"""The parent-join queries (``has_child``, ``has_parent``,
``parent_id``) and ``percolate`` of the PyTorch port (on the CPU)
against the JAX package's, byte for byte; mirrors
``tests/test_parent_join.py`` and ``tests/test_percolator.py``.

The join corpora: ``test_parent_join.py``'s three questions and four
answers interleaved over three segments, and a seeded random graph (a
few hundred questions and answers over four segments, deletes applied).
The JAX package builds the segments and scores on its device path
(``HOST_SCORING = False``); the port gets them through
``segment_arrays`` / ``segment_from_arrays``.  Covered: every
``score_mode`` over BM25 and ``function_score`` child scores,
``min_children`` / ``max_children``, ``has_parent`` with and without
``score``, ``parent_id``, composition inside ``bool``, the plans' state
kept for a repeated body and recomputed by a new searcher, prepared
columns kept out of the searcher's cache, the 400s, and the randomized
oracle.  Percolate: stored queries matched by one and by several
documents, the mapper's isolation, malformed stored queries, the errors.
``opensearch_tpu_torch/testing/corpus.py``'s phase-17 corpora are held
to what ``SegmentWriter`` builds from the same documents.
"""

import json

import numpy as np
import pytest

from opensearch_tpu.common.errors import OpenSearchTpuError as JaxError
from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
from opensearch_tpu.ops import bm25 as jax_bm25
from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
from opensearch_tpu_torch.common.errors import (MapperParsingError,
                                                OpenSearchTpuError)
from opensearch_tpu_torch.index.segment import (SegmentWriter,
                                                segment_arrays,
                                                segment_from_arrays)
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.search import executor as texecutor
from opensearch_tpu_torch.search.executor import ShardSearcher

MAPPING = {"properties": {
    "my_join": {"type": "join", "relations": {"question": "answer"}},
    "body": {"type": "text"},
    "votes": {"type": "long"},
}}

PARENTS = [
    {"_id": "q1", "body": "how do tpus work", "my_join": "question"},
    {"_id": "q2", "body": "why is the sky blue", "my_join": "question"},
    {"_id": "q3", "body": "unanswered question", "my_join": "question"},
]
CHILDREN = [
    {"_id": "a1", "body": "systolic arrays", "votes": 3,
     "my_join": {"name": "answer", "parent": "q1"}},
    {"_id": "a2", "body": "matrix units work fast", "votes": 7,
     "my_join": {"name": "answer", "parent": "q1"}},
    {"_id": "a3", "body": "rayleigh scattering", "votes": 5,
     "my_join": {"name": "answer", "parent": "q2"}},
    {"_id": "a4", "body": "it just is", "votes": 1,
     "my_join": {"name": "answer", "parent": "q2"}},
]
WORDS = [f"w{i}" for i in range(12)]


def random_graph(seed: int) -> list:
    """Questions and answers: answers name a random question (some none,
    some several), bodies of zipf words, votes 1-9."""
    rng = np.random.default_rng(seed)
    docs = [{"_id": f"p{i}", "my_join": "question",
             "body": " ".join(WORDS[int(w) % 12] for w in
                              rng.zipf(1.5, size=int(rng.integers(1, 5))))}
            for i in range(90)]
    for i in range(260):
        par = f"p{int(rng.integers(0, 90))}"
        docs.append({"_id": f"c{i}",
                     "my_join": {"name": "answer", "parent": par},
                     "body": " ".join(WORDS[int(w) % 12] for w in rng.zipf(
                         1.3, size=int(rng.integers(1, 7)))),
                     "votes": int(rng.integers(1, 10))})
    order = rng.permutation(len(docs))
    return [docs[i] for i in order]


def build(writer, mapper, docs, n_segs):
    segs = []
    for si in range(n_segs):
        chunk = docs[si::n_segs]
        parsed = [mapper.parse(d["_id"],
                               {k: v for k, v in d.items() if k != "_id"})
                  for d in chunk]
        segs.append(writer.build(parsed, f"s{si}"))
    return segs


def shard_pair(docs, n_segs, mapping=MAPPING, deletes=0, seed=0):
    jsegs = build(JaxWriter(), JaxMapper(mapping), docs, n_segs)
    rng = np.random.default_rng(seed)
    for seg in jsegs:
        if deletes:
            seg.apply_deletes(rng.choice(seg.n_docs, size=deletes,
                                         replace=False))
    tsegs = [segment_from_arrays(*segment_arrays(s)) for s in jsegs]
    return (JaxSearcher(jsegs, JaxMapper(mapping)),
            ShardSearcher(tsegs, DocumentMapper(mapping), device="cpu"))


@pytest.fixture(scope="module")
def corpora():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bm25, "HOST_SCORING", False)
        yield {"small": shard_pair(PARENTS + CHILDREN, 3),
               "random": shard_pair(random_graph(17), 4, deletes=6,
                                    seed=17)}


def strip_took(resp: dict) -> str:
    return json.dumps({k: v for k, v in resp.items() if k != "took"})


def same(pair, body):
    jax_s, port_s = pair
    ref, got = jax_s.search(body), port_s.search(body)
    assert strip_took(got) == strip_took(ref), (body, got, ref)
    return got


def ids(resp):
    return sorted(h["_id"] for h in resp["hits"]["hits"])


VOTES = {"function_score": {"query": {"match_all": {}},
                            "functions": [{"field_value_factor":
                                           {"field": "votes"}}],
                            "boost_mode": "replace"}}


def has_child(query, **extra):
    return {"has_child": {"type": "answer", "query": query, **extra}}


BODIES = {
    **{f"has_child_{mode}": {"query": has_child(
        {"match": {"body": "w1 w3 work"}}, score_mode=mode)}
       for mode in ("none", "sum", "max", "min", "avg")},
    **{f"has_child_votes_{mode}": {"query": has_child(VOTES,
                                                      score_mode=mode)}
       for mode in ("sum", "max", "min", "avg")},
    "has_child_boost": {"query": has_child({"match": {"body": "w2"}},
                                           score_mode="avg", boost=1.7)},
    "has_child_match_all": {"query": has_child({"match_all": {}})},
    "min_children": {"query": has_child({"match_all": {}},
                                        min_children=3)},
    "max_children": {"query": has_child({"match": {"body": "w0"}},
                                        score_mode="sum", min_children=2,
                                        max_children=4)},
    "has_parent": {"query": {"has_parent": {
        "parent_type": "question", "query": {"match": {"body": "w1 sky"}}}}},
    "has_parent_score": {"query": {"has_parent": {
        "parent_type": "question", "score": True, "boost": 2.0,
        "query": {"match": {"body": "w1 sky"}}}}},
    "parent_id": {"query": {"parent_id": {"type": "answer", "id": "q1"}}},
    "parent_id_random": {"query": {"parent_id": {"type": "answer",
                                                 "id": "p3"}}},
    "parent_id_boost": {"query": {"parent_id": {"type": "answer",
                                                "id": "p7", "boost": 0.3}}},
    "in_bool": {"query": {"bool": {
        "must": [has_child({"match_all": {}})],
        "must_not": [{"term": {"_id": "q2"}}, {"term": {"_id": "p4"}}]}}},
    "bool_should_mix": {"query": {"bool": {"should": [
        {"match": {"body": "w2"}},
        has_child({"match": {"body": "w2"}}, score_mode="max"),
        {"has_parent": {"parent_type": "question", "score": True,
                        "query": {"match": {"body": "w2"}}}}]}}},
    "page": {"query": has_child({"match": {"body": "w1"}},
                                score_mode="sum"), "size": 5, "from": 3},
    "sorted": {"query": has_child({"match_all": {}}, score_mode="max"),
               "sort": [{"_score": "asc"}]},
    "count_only": {"query": {"has_parent": {
        "parent_type": "question", "query": {"match_all": {}}}},
        "size": 0},
}


@pytest.mark.parametrize("corpus", ["small", "random"])
@pytest.mark.parametrize("name", sorted(BODIES))
def test_join_matches_reference(corpora, corpus, name):
    same(corpora[corpus], {"size": 40, **BODIES[name]})


def test_join_oracle_small(corpora):
    """The reference test's expectations, on the port."""
    _jax_s, port_s = corpora["small"]
    resp = port_s.search({"query": has_child({"match": {"body": "work"}})})
    assert ids(resp) == ["q1"]
    for mode, expect in [("sum", {"q1": 3 + 7, "q2": 5 + 1}),
                         ("max", {"q1": 7, "q2": 5}),
                         ("min", {"q1": 3, "q2": 1}),
                         ("avg", {"q1": 5.0, "q2": 3.0})]:
        resp = port_s.search({"query": has_child(VOTES, score_mode=mode)})
        got = {h["_id"]: h["_score"] for h in resp["hits"]["hits"]}
        assert got == pytest.approx(expect), mode
    resp = port_s.search({"query": {"parent_id": {"type": "answer",
                                                  "id": "q1"}}})
    assert ids(resp) == ["a1", "a2"]


def test_join_oracle_randomized(corpora):
    """Random parent/child graph against a plain-Python oracle over the
    live docs."""
    _jax_s, port_s = corpora["random"]
    live = {seg.doc_ids[i] for seg in port_s.segments
            for i in range(seg.n_docs) if seg.live[i]}
    docs = [d for d in random_graph(17) if d["_id"] in live]
    children = [d for d in docs if isinstance(d["my_join"], dict)]
    questions = {d["_id"] for d in docs if d["my_join"] == "question"}
    for w in ("w0", "w2", "w5"):
        resp = port_s.search({"query": has_child(
            {"match": {"body": w}}), "size": 100})
        want = sorted({c["my_join"]["parent"] for c in children
                       if w in c["body"].split()} & questions)
        assert ids(resp) == want, w
        resp = port_s.search({"query": {"has_parent": {
            "parent_type": "question", "query": {"match": {"body": w}}}},
            "size": 300})
        hit_parents = {d["_id"] for d in docs
                       if d["my_join"] == "question"
                       and w in d["body"].split()}
        want = sorted(c["_id"] for c in children
                      if c["my_join"]["parent"] in hit_parents)
        assert ids(resp) == want, w


def test_join_state_kept_per_searcher(corpora):
    """A repeated body reuses the compiled plan and its computed state on
    the same searcher; a new searcher over segments with more deletes
    recomputes it.  The join plans' prepared columns stay out of the
    searcher's prepared cache (as knn's)."""
    jax_s, port_s = corpora["random"]
    body = {"query": has_child({"match": {"body": "w1"}},
                               score_mode="sum"), "size": 30}
    first = port_s.search(body)
    assert strip_took(port_s.search(body)) == strip_took(first)
    (plan, bind), key = port_s.compiled(body["query"], with_key=True)
    assert key is None and port_s.cached_plan(body["query"]) == (plan, bind)
    for query in (body["query"], {"knn": {"v": {"vector": [1.0],
                                                "k": 1}}}):
        ckey = texecutor._plan_key(query, True)
        assert ckey is not None and texecutor._prep_key(ckey) is None
    before = len(port_s._prep_cache)
    port_s.search(BODIES["has_parent"])
    port_s.search(BODIES["parent_id_random"])
    assert len(port_s._prep_cache) == before
    # a new searcher over the same segments after a delete
    top = first["hits"]["hits"][0]["_id"]
    tsegs = list(port_s.segments)
    jsegs = list(jax_s.segments)
    for segs in (tsegs, jsegs):
        seg = next(s for s in segs if top in s.id_to_local)
        seg.apply_deletes([seg.id_to_local[top]])
    try:
        again = same((JaxSearcher(jsegs, JaxMapper(MAPPING)),
                      ShardSearcher(tsegs, DocumentMapper(MAPPING),
                                    device="cpu")), body)
        assert top not in ids(again)
        # the old searcher's point in time still answers as before
        assert strip_took(port_s.search(body)) == strip_took(first)
    finally:
        for segs in (tsegs, jsegs):
            seg = next(s for s in segs if top in s.id_to_local)
            live = seg.live.copy()
            live[seg.id_to_local[top]] = True
            seg.live = live


@pytest.mark.parametrize("query", [
    {"has_child": {"type": "nope", "query": {"match_all": {}}}},
    {"has_parent": {"parent_type": "nope", "query": {"match_all": {}}}},
    {"parent_id": {"type": "question", "id": "q1"}},
], ids=["has_child", "has_parent", "parent_id"])
def test_join_errors_match_reference(corpora, query):
    jax_s, port_s = corpora["small"]
    with pytest.raises(JaxError) as ref:
        jax_s.search({"query": query})
    with pytest.raises(OpenSearchTpuError) as got:
        port_s.search({"query": query})
    assert type(got.value).__name__ == type(ref.value).__name__
    assert got.value.status == ref.value.status == 400
    assert str(got.value) == str(ref.value)


def test_join_mapper_validation():
    mapper = DocumentMapper(MAPPING)
    with pytest.raises(MapperParsingError):
        mapper.parse("x", {"my_join": {"name": "answer"}})  # no parent
    with pytest.raises(MapperParsingError):
        mapper.parse("x", {"my_join": "not_a_relation"})


def test_join_without_join_field_matches_nothing():
    jax_s, port_s = shard_pair(
        [{"_id": str(i), "body": f"w{i}"} for i in range(6)], 2,
        mapping={"properties": {"body": {"type": "text"}}})
    for query in (has_child({"match_all": {}}),
                  {"parent_id": {"type": "answer", "id": "1"}}):
        same((jax_s, port_s), {"query": query})


# -- percolate ---------------------------------------------------------------

PERC_MAPPING = {"properties": {
    "query": {"type": "percolator"},
    "title": {"type": "text"},
    "price": {"type": "long"},
}}

QUERIES = [
    {"query": {"match": {"title": "laptop"}}},
    {"query": {"bool": {"must": [{"match": {"title": "phone"}},
                                 {"range": {"price": {"lte": 500}}}]}}},
    {"query": {"range": {"price": {"gte": 1000}}}},
    {"query": {"match_phrase": {"title": "gaming laptop"}}},
    {"query": {"wildcard": {"title": "desk*"}}},
    {"title": "no stored query here"},
]


def perc_pair():
    docs = [{"_id": str(i), **q} for i, q in enumerate(QUERIES)]
    return shard_pair(docs, 2, mapping=PERC_MAPPING, deletes=0)


@pytest.fixture(scope="module")
def perc():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bm25, "HOST_SCORING", False)
        yield perc_pair()


@pytest.mark.parametrize("body", [
    {"document": {"title": "new laptop stand", "price": 30}},
    {"document": {"title": "budget phone", "price": 199}},
    {"document": {"title": "luxury phone", "price": 1200}},
    {"documents": [{"title": "boring desk"},
                   {"title": "gaming laptop", "price": 2000}]},
    {"document": {"title": "desktop", "price": 5}, "boost": 2.0},
    {"document": {"brand_new_field": 42, "title": "laptop"}},
    {"document": {"title": "nothing matches"}},
], ids=["laptop", "phone", "luxury", "two_docs", "wildcard_boost",
        "dynamic_field", "none"])
def test_percolate_matches_reference(perc, body):
    got = same(perc, {"query": {"percolate": {"field": "query", **body}},
                      "size": 10})
    if body.get("documents"):
        assert ids(got) == ["0", "2", "3", "4"]


def test_percolate_isolation_and_malformed(perc):
    """Candidate docs never mutate the live mapping; non-dict stored
    values never match; non-dict candidates are 400."""
    _jax_s, port_s = perc
    before = set(port_s.mapper.field_types())
    port_s.search({"query": {"percolate": {
        "field": "query",
        "document": {"brand_new_field": 42, "title": "laptop"}}},
        "size": 10})
    assert set(port_s.mapper.field_types()) == before


def test_percolate_deleted_stored_query(perc):
    """A deleted stored query stops matching for a new searcher."""
    jax_s, port_s = perc
    body = {"query": {"percolate": {"field": "query", "document": {
        "title": "laptop", "price": 3000}}}}
    tsegs, jsegs = list(port_s.segments), list(jax_s.segments)
    saved = [(s, s.live) for s in tsegs + jsegs]
    for segs in (tsegs, jsegs):
        seg = next(s for s in segs if "0" in s.id_to_local)
        seg.apply_deletes([seg.id_to_local["0"]])
    try:
        got = same((JaxSearcher(jsegs, JaxMapper(PERC_MAPPING)),
                    ShardSearcher(tsegs, DocumentMapper(PERC_MAPPING),
                                  device="cpu")), body)
        assert ids(got) == ["2"]
    finally:
        for seg, live in saved:
            seg.live = live


@pytest.mark.parametrize("query", [
    {"percolate": {"field": "title", "document": {"x": 1}}},
    {"percolate": {"field": "query"}},
    {"percolate": {"field": "query", "documents": ["nope"]}},
], ids=["not_percolator", "no_document", "non_dict"])
def test_percolate_errors_match_reference(perc, query):
    jax_s, port_s = perc
    with pytest.raises(JaxError) as ref:
        jax_s.search({"query": query})
    with pytest.raises(OpenSearchTpuError) as got:
        port_s.search({"query": query})
    assert type(got.value).__name__ == type(ref.value).__name__
    assert got.value.status == ref.value.status == 400


def test_percolator_field_validates_at_index_time():
    mapper = DocumentMapper(PERC_MAPPING)
    with pytest.raises(OpenSearchTpuError):
        mapper.parse("bad", {"query": {"no_such_query": {}}})
    with pytest.raises(OpenSearchTpuError):
        mapper.parse("multi", {"query": [
            {"match": {"title": "a"}}, {"match": {"title": "b"}}]})


# -- phase 17's corpora --------------------------------------------------------

def _layout_equal(built, written):
    """The segments' arrays equal but their sources (``{}`` in the
    corpus), as ``segment_arrays`` reads them."""
    for b, w in zip(built, written):
        arr_b, meta_b = segment_arrays(b)
        arr_w, meta_w = segment_arrays(w)
        meta_b.pop("sources"), meta_w.pop("sources")
        meta_b.pop("seg_id"), meta_w.pop("seg_id")
        assert meta_b == meta_w
        assert sorted(arr_b) == sorted(arr_w)
        for key in arr_b:
            assert arr_b[key].dtype == arr_w[key].dtype, key
            np.testing.assert_array_equal(arr_b[key], arr_w[key],
                                          err_msg=key)


@pytest.mark.parametrize("n_questions,n_segments", [(60, 2), (301, 3)])
def test_phase17_corpora_match_the_writer(n_questions, n_segments):
    """``nested_segments`` and ``join_segments`` build what
    ``SegmentWriter`` builds from ``qa_documents`` (dictionaries in the
    writer's sorted order, objects in doc order, each question followed
    by its answers); the percolator's stored queries parse."""
    from opensearch_tpu_torch.testing import corpus

    draws = corpus.qa_draws(n_questions, seed=5)
    questions, answers = corpus.qa_documents(draws)
    bounds = np.linspace(0, n_questions, n_segments + 1).astype(int)
    starts = np.concatenate([[0], np.cumsum(draws["n_answers"])])
    nmap = DocumentMapper({"properties": corpus.NESTED_MAPPING})
    jmap = DocumentMapper({"properties": corpus.JOIN_MAPPING})
    nested, joined = [], []
    for s in range(n_segments):
        lo, hi = bounds[s], bounds[s + 1]
        nested.append(SegmentWriter().build(
            [nmap.parse(qid, doc) for qid, doc, _j in questions[lo:hi]],
            f"n{s}"))
        docs = []
        for i in range(lo, hi):
            qid, _n, jdoc = questions[i]
            docs.append(jmap.parse(qid, jdoc))
            docs += [jmap.parse(aid, adoc) for aid, adoc
                     in answers[starts[i]: starts[i + 1]]]
        joined.append(SegmentWriter().build(docs, f"j{s}"))
    _layout_equal(corpus.nested_segments(draws, n_segments), nested)
    _layout_equal(corpus.join_segments(draws, n_segments), joined)
    pmap = DocumentMapper({"properties": corpus.PERCOLATOR_MAPPING})
    for i, q in enumerate(corpus.percolator_queries(50)):
        pmap.parse(str(i), {"query": q})
    assert len(corpus.percolator_documents(5)) == 5
