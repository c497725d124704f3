"""The positional full-text queries of the PyTorch port through
``ShardSearcher`` (on the CPU, through the plain versions of K8 / K9 and
K2) against the JAX package's, on the same docs: ``match_phrase``,
``multi_match`` (all four types), ``dis_max``, ``simple_query_string``,
``match_phrase_prefix``, ``match_bool_prefix`` (with ``fuzziness``
too), ``span_term``, ``span_near``, ``span_first``, ``span_or`` and
``intervals``.

Corpora: the docs of ``tests/test_span_intervals.py`` (and its
full-bucket and same-term layouts), of ``tests/test_query_tail.py``'s
``_tail_searcher`` and of ``tests/test_search.py``'s ``build_corpus``.
Answers must be equal byte for byte, as BM25 answers are: ids, float32
scores, totals and ``max_score``; ``count`` equal; an error of the same
type and status.  The JAX side scores on its device path
(``HOST_SCORING = False``).  One case sets ``QUANTIZED_MODE = "on"`` on
both codec modules: the port's positions then stage through
``ensure_postings`` on a quantized segment.
"""

import numpy as np
import pytest

from opensearch_tpu.common.errors import OpenSearchTpuError as JaxError
from opensearch_tpu.index import codec as jcodec
from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
from opensearch_tpu.ops import bm25 as jbm25
from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
from opensearch_tpu_torch.common.errors import OpenSearchTpuError
from opensearch_tpu_torch.index import codec as tcodec
from opensearch_tpu_torch.index.segment import SegmentWriter
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.search.executor import ShardSearcher
from opensearch_tpu_torch.testing.parity import bm25_mismatch

SPAN_DOCS = [
    "quick brown fox jumps over the lazy dog",
    "quick fox",
    "fox quick",
    "quick red sly brown fox",
    "the brown quick fox",
    "dog jumps",
    "quick brown cat and a slow fox",
]
TAIL_DOCS = ["quick brown fox", "quick brown foam", "brown quick fox",
             "slow green turtle"]
SEARCH_MAPPING = {"properties": {
    "title": {"type": "text"}, "body": {"type": "text"},
    "tags": {"type": "keyword"}, "price": {"type": "long"}}}
VOCAB = ("alpha bravo charlie delta echo foxtrot golf hotel india "
         "juliet kilo lima mike november oscar papa quebec romeo sierra "
         "tango").split()


def pair(mapping, sources, splits):
    """(JAX searcher, port searcher) over the same docs, one segment per
    run of ``splits`` (ids are the docs' indices)."""
    out = []
    for writer, mapper_cls, searcher_cls, kw in (
            (JaxWriter(), JaxMapper, JaxSearcher, {}),
            (SegmentWriter(), DocumentMapper, ShardSearcher,
             {"device": "cpu"})):
        mapper = mapper_cls(mapping)
        segs, i = [], 0
        for si, size in enumerate(splits):
            segs.append(writer.build(
                [mapper.parse(str(i + j), src)
                 for j, src in enumerate(sources[i: i + size])], f"s{si}"))
            i += size
        out.append(searcher_cls(segs, mapper, **kw))
    return out


def search_sources(n_docs=240, seed=7):
    """``tests/test_search.py`` ``build_corpus``'s draws (its text, tag and
    price columns)."""
    rng = np.random.default_rng(seed)
    tags = ["red", "green", "blue", "yellow", "purple"]
    out = []
    for _ in range(n_docs):
        src = {"title": " ".join(rng.choice(VOCAB, size=rng.integers(2, 6))),
               "body": " ".join(rng.choice(VOCAB, size=rng.integers(5, 30))),
               "tags": list(rng.choice(tags, size=rng.integers(1, 4),
                                       replace=False)),
               "price": int(rng.integers(0, 1000))}
        # the draws of its rating, ts and active columns, unmapped here
        rng.uniform(0, 5), rng.integers(1, 13), rng.integers(1, 28)
        rng.integers(0, 2)
        if rng.uniform() < 0.1:
            del src["price"]
        out.append(src)
    return out


@pytest.fixture(scope="module")
def corpora():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbm25, "HOST_SCORING", False)
        t = {"properties": {"t": {"type": "text"}}}
        body = {"properties": {"body": {"type": "text"}}}
        bucket = [{"t": "b b b"}] * 341 + [{"t": "b a"}]
        same = [{"t": s} for s in ("one fox here", "fox and fox",
                                   "fox then later a fox", "no animals")]
        yield {
            "span": pair(t, [{"t": s} for s in SPAN_DOCS], (4, 3)),
            "bucket": pair(t, bucket, (342,)),
            "same": pair(t, same, (4,)),
            "tail": pair(body, [{"body": s} for s in TAIL_DOCS], (2, 2)),
            "search": pair(SEARCH_MAPPING, search_sources(), (80, 80, 80)),
        }


def _near(a, b, slop, in_order):
    return {"span_near": {"clauses": [{"span_term": {"t": a}},
                                      {"span_term": {"t": b}}],
                          "slop": slop, "in_order": in_order}}


SPAN_BODIES = [
    {"span_term": {"t": "fox"}},
    *[_near("quick", "fox", s, o) for s, o in ((0, True), (1, True),
                                               (3, True), (100, True),
                                               (0, False), (2, False))],
    {"span_near": {"clauses": [{"span_term": {"t": w}}
                               for w in ("quick", "brown", "fox")],
                   "slop": 2, "in_order": True}},
    {"span_near": {"clauses": [{"span_term": {"t": "fox"}}],
                   "slop": 0}},
    {"span_first": {"match": {"span_term": {"t": "fox"}}, "end": 2}},
    {"span_first": {"match": {"span_term": {"t": "quick"}}, "end": 0}},
    {"span_or": {"clauses": [{"span_term": {"t": "dog"}},
                             {"span_term": {"t": "cat"}}]}},
    {"intervals": {"t": {"match": {"query": "quick fox", "ordered": True,
                                   "max_gaps": 0}}}},
    {"intervals": {"t": {"match": {"query": "quick fox", "ordered": True,
                                   "max_gaps": 3}}}},
    {"intervals": {"t": {"match": {"query": "quick fox"}}}},
    {"intervals": {"t": {"match": {"query": "fox quick", "max_gaps": 1,
                                   "mode": "unordered"}}}},
    {"intervals": {"t": {"any_of": {"intervals": [
        {"match": {"query": "lazy dog"}}, {"match": {"query": "cat"}}]}}}},
    {"intervals": {"t": {"all_of": {"ordered": True, "intervals": [
        {"match": {"query": "quick"}}, {"match": {"query": "fox"}}]}}}},
    {"intervals": {"t": {"all_of": {"intervals": [
        {"match": {"query": "quick"}}, {"match": {"query": "dog"}}]}}}},
    {"intervals": {"t": {"prefix": {"prefix": "qu"}}}},
    {"intervals": {"t": {"wildcard": {"pattern": "d*g"}}}},
    {"match_phrase": {"t": "quick brown"}},
    {"match_phrase": {"t": "brown fox"}},
    {"match_phrase": {"t": {"query": "quick fox", "boost": 2.5}}},
    {"match_phrase": {"t": "fox"}},
    {"multi_match": {"query": "quick fox", "fields": ["t"],
                     "type": "phrase"}},
    {"simple_query_string": {"query": '"quick fox" dog'}},
    {"simple_query_string": {"query": '"brown fox" -lazy',
                             "default_operator": "and"}},
    {"match_phrase_prefix": {"t": "quick br"}},
    {"match_bool_prefix": {"t": "quick br"}},
    {"dis_max": {"queries": [{"match": {"t": "quick fox"}},
                             {"match": {"t": "brown dog"}}],
                 "tie_breaker": 0.7, "boost": 1.3}},
]

TAIL_BODIES = [
    {"match_phrase_prefix": {"body": "quick brown fo"}},
    {"match_phrase_prefix": {"body": {"query": "quick brown fo",
                                      "max_expansions": 1}}},
    {"match_phrase_prefix": {"body": "brown zz"}},
    {"match_bool_prefix": {"body": "fox qui"}},
    {"match_bool_prefix": {"body": {"query": "fox qui", "operator": "and"}}},
    {"match_bool_prefix": {"body": {"query": "fox quick green",
                                    "minimum_should_match": 2}}},
    {"multi_match": {"query": "quick fo", "fields": ["body"],
                     "type": "bool_prefix"}},
]

SEARCH_BODIES = [
    {"match_phrase": {"body": "alpha bravo"}},
    {"match_phrase": {"title": "charlie delta echo"}},
    {"dis_max": {"queries": [{"match": {"title": "alpha"}},
                             {"match": {"body": "alpha"}}],
                 "tie_breaker": 0.3}},
    {"dis_max": {"queries": [{"match_phrase": {"body": "golf hotel"}},
                             {"match": {"title": "golf hotel"}}]}},
    {"multi_match": {"query": "alpha bravo", "fields": ["title^2", "body"]}},
    {"multi_match": {"query": "alpha bravo", "fields": ["title", "body"],
                     "type": "most_fields", "tie_breaker": 1.0}},
    {"multi_match": {"query": "kilo lima", "fields": ["*"],
                     "type": "phrase"}},
    {"multi_match": {"query": "echo foxtrot golf", "fields": ["title", "body"],
                     "operator": "and", "tie_breaker": 0.2}},
    {"multi_match": {"query": "mike nov", "fields": ["title", "body"],
                     "type": "bool_prefix"}},
    {"simple_query_string": {"query": '"india juliet" kilo -papa',
                             "fields": ["body", "title^3"]}},
    {"simple_query_string": {"query": "sierra tango"}},
    {"bool": {"must": [{"match_phrase": {"body": "oscar papa"}}],
              "filter": [{"range": {"price": {"gte": 200, "lt": 800}}}]}},
    {"bool": {"should": [{"match_phrase": {"body": "romeo sierra"}},
                         {"span_near": {"clauses": [
                             {"span_term": {"body": "quebec"}},
                             {"span_term": {"body": "romeo"}}],
                             "slop": 3, "in_order": False}}],
              "must_not": [{"term": {"tags": "red"}}]}},
    {"constant_score": {"filter": {"match_phrase": {"body": "delta echo"}},
                        "boost": 2.0}},
]


def check(pair_, body):
    jax_s, port_s = pair_
    ref, got = jax_s.search(body), port_s.search(body)
    bad = bm25_mismatch(got, ref)
    assert bad is None, (body, bad)
    assert got["hits"]["max_score"] == ref["hits"]["max_score"], body
    return got


def cases(name, bodies):
    return [pytest.param(name, b, id=f"{name}-{i}-{next(iter(b))}")
            for i, b in enumerate(bodies)]


@pytest.mark.parametrize("corpus_name,query", [
    *cases("span", SPAN_BODIES), *cases("tail", TAIL_BODIES),
    *cases("search", SEARCH_BODIES)])
def test_query_equals_reference(corpora, corpus_name, query):
    for extra in ({"size": 10}, {"size": 3, "from": 2}):
        check(corpora[corpus_name], {"query": query, **extra})


@pytest.mark.parametrize("corpus_name,query", [
    ("bucket", {"span_near": {"clauses": [{"span_term": {"t": "a"}},
                                          {"span_term": {"t": "b"}}],
                              "slop": 1000, "in_order": True}}),
    ("bucket", {"match_phrase": {"t": "b a"}}),
    ("bucket", {"match_phrase": {"t": "b b b"}}),
    ("same", {"span_near": {"clauses": [{"span_term": {"t": "fox"}},
                                        {"span_term": {"t": "fox"}}],
                            "slop": 1, "in_order": False}}),
    ("same", {"span_near": {"clauses": [{"span_term": {"t": "fox"}},
                                        {"span_term": {"t": "fox"}}],
                            "slop": 10, "in_order": False}}),
    ("same", {"span_near": {"clauses": [{"span_term": {"t": "fox"}},
                                        {"span_term": {"t": "fox"}}],
                            "slop": 10, "in_order": True}}),
], ids=["bucket-ordered", "bucket-phrase", "bucket-phrase3",
        "same-slop1", "same-slop10", "same-ordered"])
def test_layouts_equal_reference(corpora, corpus_name, query):
    resp = check(corpora[corpus_name], {"query": query, "size": 400})
    if corpus_name == "bucket" and "span_near" in query:
        assert resp["hits"]["hits"] == []


@pytest.mark.parametrize("query", [
    {"match_phrase": {"body": "alpha bravo"}},
    {"span_near": {"clauses": [{"span_term": {"body": "alpha"}},
                               {"span_term": {"body": "bravo"}}],
                   "slop": 2, "in_order": True}},
    {"multi_match": {"query": "charlie delta", "fields": ["title", "body"],
                     "type": "phrase"}},
    {"dis_max": {"queries": [{"match_phrase": {"body": "golf hotel"}},
                             {"match": {"title": "golf"}}]}},
    None,
], ids=["phrase", "span", "multi_match", "dis_max", "all"])
def test_count_equals_reference(corpora, query):
    jax_s, port_s = corpora["search"]
    assert port_s.count(query) == jax_s.count(query)


ERROR_BODIES = [
    ("span", {"span_near": {"clauses": [{"span_term": {"t": w}}
                                        for w in ("a", "b", "c")],
                            "in_order": False}}),
    ("span", {"span_near": {"clauses": [{"term": {"t": "a"}}]}}),
    ("span", {"span_near": {"clauses": [{"span_term": {"t": "a"}},
                                        {"span_term": {"u": "b"}}]}}),
    ("span", {"span_first": {"match": {"match": {"t": "fox"}}, "end": 2}}),
    ("span", {"match_phrase": {"t": {"query": "quick fox", "slop": 1}}}),
    ("span", {"match_phrase_prefix": {"t": {"query": "quick f",
                                            "slop": 2}}}),
    ("span", {"intervals": {"t": {"match": {"query": "a b c",
                                            "max_gaps": 1}}}}),
    ("span", {"intervals": {"t": {"match": {"query": "quick fox",
                                            "filter": {}}}}}),
    ("span", {"intervals": {"t": {"fuzzy": {"term": "quick"}}}}),
    ("span", {"intervals": {"t": {"all_of": {"max_gaps": 2, "intervals": [
        {"match": {"query": "quick brown"}},
        {"match": {"query": "fox"}}]}}}}),
    ("span", {"intervals": {"t": {"any_of": {"intervals": []}}}}),
    ("span", {"multi_match": {"query": "x", "fields": ["t"],
                              "type": "cross_fields"}}),
]


@pytest.mark.parametrize("corpus_name,query", ERROR_BODIES,
                         ids=[f"{i}-{next(iter(q))}"
                              for i, (_c, q) in enumerate(ERROR_BODIES)])
def test_errors_equal_reference(corpora, corpus_name, query):
    jax_s, port_s = corpora[corpus_name]
    with pytest.raises(JaxError) as ref:
        jax_s.search({"query": query})
    with pytest.raises(OpenSearchTpuError) as got:
        port_s.search({"query": query})
    assert type(got.value).__name__ == type(ref.value).__name__
    assert got.value.status == ref.value.status


def test_bool_prefix_with_fuzziness_is_not_ported(corpora):
    """Its term clauses are ``fuzzy`` queries.  This test held that the
    port answered 501 while fuzzy was not ported; it is ported now, so
    the body answers as the reference's, byte for byte."""
    for query in ({"match_bool_prefix": {"body": {
            "query": "fox qui", "fuzziness": 1}}},
            {"match_bool_prefix": {"body": {
                "query": "fax quick tortle", "fuzziness": "AUTO",
                "operator": "and"}}}):
        for extra in ({"size": 10}, {"size": 2, "from": 1}):
            check(corpora["tail"], {"query": query, **extra})


def test_quantized_segments_stage_positions(monkeypatch):
    """On quantized segments (both codec modules set to ``on``) phrase,
    span and dis_max answers equal the reference's; the port stages the
    positions through ``ensure_postings``, on the first such query
    only."""
    for mod in (jcodec, tcodec):
        monkeypatch.setattr(mod, "QUANTIZED_MODE", "on")
    monkeypatch.setattr(jbm25, "HOST_SCORING", False)
    jax_s, port_s = pair(SEARCH_MAPPING, search_sources(120, seed=3),
                         (70, 50))
    check((jax_s, port_s), {"query": {"match": {"body": "alpha bravo"}}})
    dsegs = [seg.device("cpu") for seg in port_s.segments]
    assert all(d.quantized_mode for d in dsegs)
    assert not any("positions" in d.postings["body"] for d in dsegs)
    before = [d.nbytes() for d in dsegs]
    for query in ({"match_phrase": {"body": "alpha bravo"}},
                  {"span_near": {"clauses": [
                      {"span_term": {"body": "charlie"}},
                      {"span_term": {"body": "delta"}}],
                      "slop": 4, "in_order": False}},
                  {"dis_max": {"queries": [
                      {"match_phrase": {"body": "echo golf"}},
                      {"match": {"body": "echo"}}], "tie_breaker": 0.5}}):
        check((jax_s, port_s), {"query": query, "size": 20})
    for d, b in zip(dsegs, before):
        p = d.postings["body"]
        assert {"doc_ids", "tfs", "pos_offsets", "positions",
                "doc_lens"} <= set(p)
        assert d.nbytes() > b
        assert "positions" not in d.postings["title"]


PREPASS_BODIES = {
    "match_phrase": ({"match_phrase": {"body": "alpha bravo"}}, 1, 0),
    "match_phrase_prefix": ({"match_phrase_prefix": {"body": {
        "query": "kilo l", "max_expansions": 10}}}, 1, 0),
    "multi_match_phrase": ({"multi_match": {
        "query": "charlie delta", "fields": ["title", "body"],
        "type": "phrase"}}, 1, 0),
    "bool_phrase_span": ({"bool": {
        "must": [{"match_phrase": {"body": "oscar papa"}}],
        "should": [{"span_near": {"clauses": [
            {"span_term": {"body": "quebec"}},
            {"span_term": {"body": "romeo"}}], "slop": 3,
            "in_order": False}}],
        "filter": [{"range": {"price": {"gte": 100}}}]}}, 1, 1),
    "span_near": ({"span_near": {"clauses": [
        {"span_term": {"body": "alpha"}}, {"span_term": {"body": "bravo"}}],
        "slop": 2, "in_order": True}}, 0, 1),
}


@pytest.mark.parametrize("name", sorted(PREPASS_BODIES))
def test_prepass_calls_each_entry_once(corpora, monkeypatch, name):
    """Over the 3-segment corpus every phrase and span leaf of a request
    goes through one call of its entry (K8's, K9's on the card) over
    every segment, for a search, a count and a top-k past the in-kernel
    k, and the answers still equal the reference's."""
    from opensearch_tpu_torch.search import plan as tplan

    calls = {"phrase": [], "span": []}
    for cls, kind in ((tplan.PhrasePlan, "phrase"),
                      (tplan.SpanNearPlan, "span")):
        entry = cls.scores_auto

        def counted(leaves, entry=entry, kind=kind):
            calls[kind].append(len(leaves))
            return entry(leaves)
        monkeypatch.setattr(cls, "scores_auto", staticmethod(counted))
    query, n_phrase, n_span = PREPASS_BODIES[name]
    jax_s, port_s = corpora["search"]
    assert len(port_s.segments) == 3
    for body in ({"query": query, "size": 10}, {"query": query, "size": 300},
                 None):
        calls["phrase"].clear()
        calls["span"].clear()
        if body is None:
            assert port_s.count(query) == jax_s.count(query)
        else:
            check((jax_s, port_s), body)
        assert len(calls["phrase"]) == n_phrase, (body, calls)
        assert len(calls["span"]) == n_span, (body, calls)
        assert all(n % 3 == 0 and n >= 3 for n in calls["phrase"]
                   + calls["span"]), calls
