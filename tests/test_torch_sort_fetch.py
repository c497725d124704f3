"""The result features of a search body in the PyTorch port (on the CPU)
against the JAX package's: field ``sort`` and ``search_after`` (ordered
on the searcher's device, ``search/sorting.py``), ``collapse``,
``rescore`` and the fetch options (``highlight``, ``explain``,
``docvalue_fields``, ``fields``, ``stored_fields``), through
``ShardSearcher.search`` / ``msearch``, the REST node and
``merge_hit_rows``.

The corpus is seeded numpy over four segments with deletes: multi-valued
and missing ``long``, ``double``, ``date``, ``date_nanos`` and keyword
fields, keyword dictionaries that differ from segment to segment (raw
ordinals do not compare across segments), ``fare`` values with -0.0
and 0.0, a long column holding the missing sentinels as real values,
and small value ranges so ties are common.  It is built with the JAX
package's writer and carried into the port (``segment_arrays``).  The
reference scores on its device path (``HOST_SCORING`` off).  Responses
compare byte for byte as JSON once ``took`` is removed, and through
``bm25_mismatch``.
"""

import functools
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
from opensearch_tpu.node import Node as JaxNode
from opensearch_tpu.ops import bm25 as jax_bm25
from opensearch_tpu.search import executor as jax_executor
from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
from opensearch_tpu_torch.index.segment import (LONG_MISSING_MAX,
                                                LONG_MISSING_MIN,
                                                SegmentWriter,
                                                segment_arrays,
                                                segment_from_arrays)
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.node import Node
from opensearch_tpu_torch.search import sorting
from opensearch_tpu_torch.search.executor import (ShardSearcher,
                                                  merge_hit_rows)
from opensearch_tpu_torch.testing.parity import (bm25_mismatch,
                                                 profile_shape)

MAPPING = {"properties": {
    "body": {"type": "text"},
    "title": {"type": "text", "analyzer": "english"},
    "tag": {"type": "keyword"},
    "price": {"type": "long"},
    "big": {"type": "long"},
    "n": {"type": "long"},
    "fare": {"type": "double"},
    "ts": {"type": "date"},
    "tn": {"type": "date_nanos"},
}}
SEG_SIZES = (70, 90, 60, 40)
# per segment band of keyword values: each segment's dictionary differs;
# "B" < "Z" < "a" < "é" in code point order
TAG_BANDS = [[f"k{i:02d}" for i in range(b, b + 9)] + ["B", "a"]
             for b in (0, 5, 12, 20)]
EXTRA_TAGS = ["Z", "é", "k03"]
WORDS = [f"w{i}" for i in range(14)]
# the largest long the mappers parse exactly (they go through a float);
# LONG_MISSING_MIN = -2**63 parses, so docs hold the missing sentinel
BIG_NEAR_MAX = 2**63 - 1024
TITLE_WORDS = ["quick", "foxes", "jumping", "lazy", "dogs", "sleeps",
               "brown", "clever"]


def corpus_docs(seed: int) -> list:
    rng = np.random.default_rng(seed)
    docs = []
    for si, size in enumerate(SEG_SIZES):
        for _ in range(size):
            i = len(docs)
            d = {"body": " ".join(
                WORDS[int(w) % len(WORDS)]
                for w in rng.zipf(1.5, size=int(rng.integers(2, 12))) - 1),
                "title": " ".join(rng.choice(TITLE_WORDS,
                                             size=int(rng.integers(2, 6)))),
                "n": i}
            if rng.random() < 0.8:
                pool = TAG_BANDS[si] + EXTRA_TAGS
                d["tag"] = [str(t) for t in rng.choice(
                    pool, size=int(rng.integers(1, 4)))]
            if rng.random() < 0.8:
                d["price"] = [int(v) for v in rng.integers(
                    -3, 4, size=int(rng.integers(1, 3)))]
            if rng.random() < 0.7:
                d["big"] = int(rng.choice([LONG_MISSING_MIN, BIG_NEAR_MAX,
                                           0, 5]))
            if rng.random() < 0.8:
                d["fare"] = [float(v) for v in rng.choice(
                    [-0.0, 0.0, 1.25, -2.5, 7.75, 3.0],
                    size=int(rng.integers(1, 3)))]
            if rng.random() < 0.8:
                d["ts"] = [f"2024-0{int(m)}-0{int(dd)}T00:00:00Z"
                           for m, dd in rng.integers(1, 4, size=(
                               int(rng.integers(1, 3)), 2))]
            if rng.random() < 0.7:
                d["tn"] = (f"2024-02-0{int(rng.integers(1, 4))}T00:00:00."
                           f"{int(rng.integers(0, 3)):03d}456789Z")
            docs.append(d)
    return docs


def build_pair(seed: int):
    """(JAX searcher, port searcher) over the same four segments with
    three deletes each."""
    docs = corpus_docs(seed)
    jmapper = JaxMapper(MAPPING)
    jsegs, i = [], 0
    for si, size in enumerate(SEG_SIZES):
        jsegs.append(JaxWriter().build(
            [jmapper.parse(str(i + j), docs[i + j]) for j in range(size)],
            f"seg{si}"))
        i += size
    rng = np.random.default_rng(seed + 1)
    for seg in jsegs:
        seg.apply_deletes(rng.choice(seg.n_docs, size=3, replace=False))
    tsegs = [segment_from_arrays(*segment_arrays(s)) for s in jsegs]
    return (JaxSearcher(jsegs, jmapper),
            ShardSearcher(tsegs, DocumentMapper(MAPPING), device="cpu"))


@pytest.fixture(scope="module", params=[3, 17])
def pair(request):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bm25, "HOST_SCORING", False)
        yield build_pair(request.param)


@pytest.fixture(scope="module")
def pair3():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bm25, "HOST_SCORING", False)
        yield build_pair(3)


def no_took(resp: dict) -> str:
    return json.dumps({k: v for k, v in resp.items() if k != "took"},
                      sort_keys=True)


def assert_same(got: dict, want: dict, body=None):
    assert bm25_mismatch(got, want) is None, (bm25_mismatch(got, want), body)
    assert no_took(got) == no_took(want), body


def parity(pair, body) -> dict:
    jax_s, port_s = pair
    want, got = jax_s.search(body), port_s.search(body)
    assert_same(got, want, body)
    return got


# -- field sort ---------------------------------------------------------------

MATCH = {"match": {"body": "w0 w1 w2"}}
SORT_BODIES = {
    # keyword order across segments whose dictionaries differ
    "tag_asc": {"sort": [{"tag": "asc"}], "size": 300},
    "tag_desc": {"sort": [{"tag": "desc"}], "size": 300},
    # a keyword None: first only under "_first", whatever the direction
    "tag_first_asc": {"sort": [{"tag": {"order": "asc",
                                        "missing": "_first"}}], "size": 300},
    "tag_first_desc": {"sort": [{"tag": {"order": "desc",
                                         "missing": "_first"}}],
                       "size": 300},
    "tag_custom_missing": {"sort": [{"tag": {"order": "asc",
                                             "missing": "k05"}}],
                           "size": 300},
    "tag_last_desc": {"sort": [{"tag": {"order": "desc",
                                        "missing": "_last"}}], "size": 300},
    # numeric: the sentinel, a custom missing number used as is
    "price_asc": {"sort": [{"price": "asc"}], "size": 300},
    "price_desc": {"sort": [{"price": {"order": "desc"}}], "size": 300},
    "price_first": {"sort": [{"price": {"order": "asc",
                                        "missing": "_first"}}],
                    "size": 300},
    "price_custom_missing": {"sort": [{"price": {"order": "desc",
                                                 "missing": 2}}],
                             "size": 300},
    # a real value equal to the sentinel ties with the missing docs
    "big_asc_first": {"sort": [{"big": {"order": "asc",
                                        "missing": "_first"}}],
                      "size": 300},
    "big_desc": {"sort": [{"big": "desc"}], "size": 300},
    "big_custom_missing": {"sort": [{"big": {"order": "asc",
                                             "missing": 5}}, "_doc"],
                           "size": 300},
    # -0.0 and 0.0 tie; ties fall to (segment, local) under desc too
    "fare_asc": {"sort": [{"fare": "asc"}], "size": 300},
    "fare_desc": {"sort": [{"fare": "desc"}], "size": 300},
    "fare_custom_missing": {"sort": [{"fare": {"order": "desc",
                                               "missing": -0.0}}],
                            "size": 300},
    # _doc compares segment-local ids before segment order
    "doc": {"sort": ["_doc"], "size": 300},
    "doc_desc": {"sort": [{"_doc": "desc"}], "size": 300},
    # dates, date_nanos sort values in nanos
    "ts_desc": {"sort": [{"ts": "desc"}], "size": 300},
    "tn_asc": {"sort": [{"tn": "asc"}], "size": 300},
    # several keys, _score among them
    "three_keys": {"sort": [{"tag": "asc"}, {"price": "desc"},
                            {"fare": "asc"}], "size": 300},
    "fare_score": {"query": MATCH, "sort": [{"fare": "asc"}, "_score"],
                   "size": 100},
    "score_asc": {"query": MATCH, "sort": [{"_score": "asc"}],
                  "size": 100},
    "score_tag": {"query": MATCH, "sort": ["_score", {"tag": "desc"}],
                  "size": 100},
    "score_desc_only": {"query": MATCH, "sort": [{"_score": "desc"}]},
    "string_clause": {"sort": "price", "size": 50},
    "dict_clause": {"sort": {"tag": "desc"}, "size": 50},
    "bool_range": {"query": {"bool": {
        "must": [{"match": {"body": "w1"}}],
        "filter": [{"range": {"price": {"gte": -1, "lte": 2}}}]}},
        "sort": [{"tag": "asc"}, {"price": "desc"}], "size": 40},
    "min_score": {"query": MATCH, "min_score": 0.5,
                  "sort": [{"price": "asc"}], "size": 40},
    "from_size": {"sort": [{"ts": "asc"}, {"n": "asc"}], "from": 25,
                  "size": 10},
    "size_zero": {"sort": [{"price": "asc"}], "size": 0},
    "untracked": {"query": MATCH, "sort": [{"price": "asc"}],
                  "track_total_hits": False},
    "timeout": {"sort": [{"fare": "desc"}], "timeout": "30s"},
    "no_match": {"query": {"match": {"body": "absent"}},
                 "sort": [{"nope": "asc"}]},
    "source_filter": {"sort": [{"tag": "asc"}], "_source": ["tag"],
                      "size": 5},
    # search_after: rows equal to the probe on every key are dropped
    "after_long": {"sort": [{"price": "asc"}], "search_after": [0],
                   "size": 300},
    "after_float_on_long": {"sort": [{"price": "desc"}],
                            "search_after": [0.5], "size": 300},
    "after_sentinel": {"sort": [{"big": {"order": "asc",
                                         "missing": "_first"}}],
                       "search_after": [LONG_MISSING_MIN], "size": 300},
    "after_beyond_long": {"sort": [{"big": "desc"}],
                          "search_after": [LONG_MISSING_MAX * 4],
                          "size": 300},
    "after_date_string": {"sort": [{"ts": "desc"}],
                          "search_after": ["2024-02-02T00:00:00Z"],
                          "size": 300},
    "after_keyword_present": {"sort": [{"tag": "asc"}],
                              "search_after": ["k07"], "size": 300},
    "after_keyword_absent": {"sort": [{"tag": "desc"}],
                             "search_after": ["k07x"], "size": 300},
    "after_keyword_none_first": {"sort": [{"tag": {"order": "asc",
                                                   "missing": "_first"}}],
                                 "search_after": [None], "size": 300},
    "after_keyword_none_last": {"sort": [{"tag": "desc"}],
                                "search_after": [None], "size": 300},
    "after_two_keys": {"sort": [{"tag": "asc"}, {"fare": "desc"}],
                       "search_after": ["k05", 0.0], "size": 300},
    "after_score": {"query": MATCH, "sort": ["_score", "_doc"],
                    "search_after": [1.0, 10], "size": 300},
    "after_neg_zero": {"sort": [{"fare": "asc"}],
                       "search_after": [-0.0], "size": 300},
}


# bodies that rightly answer no hit (nothing is after a None that sorts
# last)
NO_HITS = {"size_zero", "no_match", "after_keyword_none_last"}


@pytest.mark.parametrize("name", list(SORT_BODIES))
def test_sort_matches_reference(pair, name):
    got = parity(pair, SORT_BODIES[name])
    body = SORT_BODIES[name]
    assert bool(got["hits"]["hits"]) == (name not in NO_HITS), name
    assert got["hits"]["total"]["value"] > 0 or name == "no_match"
    if name not in NO_HITS:
        if "sort" in body and name != "score_desc_only":
            assert got["hits"]["max_score"] is None
            assert all(h["_score"] is None and "sort" in h
                       for h in got["hits"]["hits"])


def test_keyword_dictionaries_differ_across_segments(pair3):
    """The trap the rank table answers: segment ordinals of one term
    differ, so raw ordinals order wrongly."""
    _jax, port = pair3
    ords = [seg.ordinal_dv["tag"].term_to_ord.get("k07")
            for seg in port.segments]
    assert len(set(o for o in ords if o is not None)) > 1
    ranks = sorting.keyword_ranks(port, "tag")
    assert ranks.terms == sorted(ranks.terms)
    assert ranks.terms[:2] == ["B", "Z"] and ranks.terms[-1] == "é"
    for seg, table in zip(port.segments, ranks.tables):
        dv = seg.ordinal_dv["tag"]
        assert [ranks.terms[r] for r in table.tolist()] == dv.ord_terms


@pytest.mark.parametrize("sort", [
    [{"tag": "asc"}, {"n": "asc"}],
    [{"fare": "desc"}, {"n": "desc"}],
    [{"price": {"order": "asc", "missing": "_first"}}, {"n": "asc"}],
    [{"tag": {"order": "desc", "missing": "_first"}}, {"ts": "asc"},
     {"n": "asc"}],
], ids=["tag", "fare_desc", "price_first", "tag_ts"])
def test_search_after_pages_equal_one_deep_page(pair3, sort):
    """Pages of 7 chained by the last hit's sort values, on both
    packages, give the hits of one deep page (``n`` is unique)."""
    jax_s, port_s = pair3
    deep = parity(pair3, {"sort": sort, "size": 400})["hits"]["hits"]
    pages, after = [], None
    while True:
        body = {"sort": sort, "size": 7}
        if after is not None:
            body["search_after"] = after
        got = parity(pair3, body)
        hits = got["hits"]["hits"]
        assert got["hits"]["total"] == {"value": len(deep),
                                        "relation": "eq"}
        if not hits:
            break
        pages += hits
        after = hits[-1]["sort"]
    assert [(h["_id"], h["sort"]) for h in pages] == \
        [(h["_id"], h["sort"]) for h in deep]


def test_search_after_paging_with_ties_matches_reference(pair3):
    """Without a unique key, rows equal to the probe are skipped, on both
    sides alike."""
    after = None
    for _ in range(6):
        body = {"sort": [{"price": "asc"}], "size": 9}
        if after is not None:
            body["search_after"] = after
        hits = parity(pair3, body)["hits"]["hits"]
        if not hits:
            break
        after = hits[-1]["sort"]


# -- rescore ------------------------------------------------------------------

@pytest.mark.parametrize("window", [3, 30])
@pytest.mark.parametrize("mode", ["total", "multiply", "avg", "max", "min"])
def test_rescore_matches_reference(pair3, mode, window):
    body = {"query": {"match": {"body": "w0 w1 w3"}}, "size": 10,
            "rescore": {"window_size": window, "query": {
                "rescore_query": {"match": {"body": "w2 w4"}},
                "query_weight": 0.7, "rescore_query_weight": 1.3,
                "score_mode": mode}}}
    got = parity(pair3, body)
    assert len(got["hits"]["hits"]) == 10


@pytest.mark.parametrize("body", [
    {"query": {"match": {"body": "w0"}}, "from": 4, "size": 6,
     "rescore": [{"window_size": 12, "query": {
         "rescore_query": {"bool": {"should": [
             {"match": {"body": "w3"}}, {"term": {"tag": "k05"}}]}}}}]},
    {"query": {"match": {"body": "w1 w2"}},
     "rescore": {"window_size": 5, "query": {
         "rescore_query": {"match": {"body": "absent"}},
         "query_weight": 0.1, "rescore_query_weight": 10.0}}},
    {"query": {"match_all": {}}, "size": 8,
     "rescore": {"window_size": 20, "query": {
         "rescore_query": {"match_phrase": {"body": "w0 w1"}}}}},
    {"query": {"match": {"body": "w1"}}, "size": 5,
     "aggs": {"t": {"terms": {"field": "tag"}}},
     "rescore": {"window_size": 8, "query": {
         "rescore_query": {"match": {"body": "w0"}}}}},
], ids=["list_from", "matches_nothing", "phrase", "aggs"])
def test_rescore_forms_match_reference(pair3, body):
    parity(pair3, body)


# -- collapse -----------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    {"query": MATCH},
    {"sort": [{"ts": "desc"}, {"n": "asc"}]},
    {"query": MATCH, "aggs": {"p": {"max": {"field": "price"}}}},
    {"sort": [{"fare": "asc"}], "aggs": {"t": {"terms": {"field": "tag"}}}},
], ids=["score", "sort", "aggs", "sort_aggs"])
@pytest.mark.parametrize("field", ["tag", "price", "fare"])
def test_collapse_matches_reference(pair, field, extra):
    body = {"collapse": {"field": field}, "size": 12, **extra}
    got = parity(pair, body)
    keys = [h["fields"][field][0] for h in got["hits"]["hits"]]
    assert len(keys) == len(set(keys))
    assert got["hits"]["total"]["value"] > len(keys)


def test_collapse_search_after_and_from(pair3):
    parity(pair3, {"collapse": {"field": "tag"}, "sort": [{"tag": "asc"}],
                   "search_after": ["k03"], "from": 2, "size": 5})
    parity(pair3, {"collapse": {"field": "fare"}, "size": 0})
    parity(pair3, {"collapse": {"field": "price"}, "size": 50})


# -- fetch options (the cases of tests/test_fetch_phases.py) -------------------

FETCH_MAPPING = {"properties": {
    "title": {"type": "text"},
    "body": {"type": "text", "analyzer": "english"},
    "tags": {"type": "keyword"},
    "views": {"type": "long"},
    "ts": {"type": "date"},
}}
FETCH_DOCS = [
    {"title": "The quick brown fox",
     "body": "The quick brown fox jumps over the lazy dog. "
             "Foxes are quick and clever animals that jump high.",
     "tags": ["animal", "fast"], "views": 11,
     "ts": "2024-03-05T10:00:00Z"},
    {"title": "Lazy dogs sleeping",
     "body": "Dogs sleep all day long in the warm sun.",
     "tags": ["animal"], "views": 22, "ts": "2024-04-01T00:00:00Z"},
]


@pytest.fixture(scope="module")
def fetch_pair():
    jmapper = JaxMapper(FETCH_MAPPING)
    jseg = JaxWriter().build([jmapper.parse(str(i), d)
                              for i, d in enumerate(FETCH_DOCS)], "f0")
    mapper = DocumentMapper(FETCH_MAPPING)
    seg = SegmentWriter().build([mapper.parse(str(i), d)
                                 for i, d in enumerate(FETCH_DOCS)], "f0")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bm25, "HOST_SCORING", False)
        yield (JaxSearcher([jseg], jmapper),
               ShardSearcher([seg], mapper, device="cpu"))


FETCH_BODIES = {
    "highlight": {"query": {"match": {"body": "fox"}},
                  "highlight": {"fields": {"body": {}}}},
    "highlight_tags": {"query": {"match": {"body": "quick"}},
                       "highlight": {"pre_tags": ["<b>"],
                                     "post_tags": ["</b>"],
                                     "fields": {"body": {}, "title": {}}}},
    "require_field_match": {"query": {"match": {"body": "quick"}},
                            "highlight": {"require_field_match": False,
                                          "fields": {"title": {}}}},
    "highlight_phrase": {"query": {"match_phrase": {"body": "lazy dog"}},
                         "highlight": {"fields": {"body": {}}}},
    "highlight_prefix": {"query": {"prefix": {"title": "qui"}},
                         "highlight": {"fields": [{"title": {
                             "number_of_fragments": 0}}]}},
    "highlight_fragments": {"query": {"match": {"body": "quick dogs"}},
                            "highlight": {"fields": {"body": {
                                "fragment_size": 20,
                                "number_of_fragments": 2}}}},
    "explain": {"query": {"match": {"body": "fox quick"}},
                "explain": True},
    "explain_bool": {"query": {"bool": {
        "must": [{"match": {"body": "dogs"}}],
        "should": [{"term": {"tags": "animal"}}]}}, "explain": True},
    "docvalue_fields": {"query": {"match_all": {}},
                        "docvalue_fields": ["views", {"field": "ts"},
                                            {"field": "views",
                                             "format": "x"}, "tags",
                                            {"field": "ts",
                                             "format": "epoch_millis"}],
                        "fields": ["title", "vi*"],
                        "sort": [{"views": "asc"}]},
    "fields": {"query": {"match": {"title": "lazy"}},
               "fields": ["t*", {"field": "body"}, {"nope": 1}]},
    "stored_fields": {"query": {"match_all": {}},
                      "stored_fields": ["views"]},
    "stored_fields_source": {"query": {"match_all": {}},
                             "stored_fields": "_source"},
    "stored_fields_with_source": {"query": {"match_all": {}},
                                  "stored_fields": "x",
                                  "_source": ["title"]},
    "rescore_rerank": {"query": {"match": {"body": "quick sun"}},
                       "rescore": {"window_size": 5, "query": {
                           "rescore_query": {"match": {"body": "dogs"}},
                           "query_weight": 0.1,
                           "rescore_query_weight": 10.0,
                           "score_mode": "total"}}, "size": 5},
    "hybrid_fetch": {"query": {"hybrid": {"queries": [
        {"match": {"body": "fox"}}, {"match": {"title": "lazy"}}]}},
        "highlight": {"fields": {"body": {}, "title": {}}},
        "explain": True, "docvalue_fields": ["views"]},
    "collapse_views": {"query": {"match_all": {}},
                       "collapse": {"field": "views"}, "size": 10},
    "collapse_tags": {"query": {"match": {"body": "quick dogs"}},
                      "collapse": {"field": "tags"}, "size": 10,
                      "highlight": {"fields": {"body": {}}}},
}


@pytest.mark.parametrize("name", list(FETCH_BODIES))
def test_fetch_options_match_reference(fetch_pair, name):
    got = parity(fetch_pair, FETCH_BODIES[name])
    assert got["hits"]["hits"], name
    if name == "highlight":
        joined = " ".join(got["hits"]["hits"][0]["highlight"]["body"])
        assert "<em>fox</em>" in joined and "<em>Foxes</em>" in joined
    if name == "rescore_rerank":
        assert got["hits"]["hits"][0]["_id"] == "1"


def test_msearch_with_result_features_matches_reference(pair3, fetch_pair):
    bodies = [SORT_BODIES["tag_asc"], {"query": MATCH},
              {"collapse": {"field": "tag"}, "query": MATCH},
              SORT_BODIES["after_two_keys"],
              {"query": {"match": {"body": "w1"}}, "rescore": {
                  "window_size": 4, "query": {
                      "rescore_query": {"match": {"body": "w2"}}}}},
              {"query": {"match": {"body": "w2"}}, "stored_fields": []},
              {"query": {"match": {"body": "w3"}}, "explain": False}]
    jax_s, port_s = pair3
    for got, want, body in zip(port_s.msearch(bodies),
                               jax_s.msearch(bodies), bodies):
        assert_same(got, want, body)
    fbodies = [FETCH_BODIES["highlight"], {"query": {"match": {
        "body": "fox"}}}, FETCH_BODIES["docvalue_fields"]]
    jax_f, port_f = fetch_pair
    for got, want, body in zip(port_f.msearch(fbodies),
                               jax_f.msearch(fbodies), fbodies):
        assert_same(got, want, body)
    got = port_f.msearch(fbodies[:2])
    assert "highlight" in got[0]["hits"]["hits"][0]
    assert "highlight" not in got[1]["hits"]["hits"][0]


# -- errors -------------------------------------------------------------------

@pytest.mark.parametrize("body", [
    {"search_after": [1]},
    {"sort": ["price"], "search_after": 1},
    {"sort": ["price"], "search_after": [1, 2]},
    {"sort": ["price"], "rescore": {"query": {
        "rescore_query": {"match_all": {}}}}},
    {"collapse": {"field": "tag"}, "rescore": {"query": {
        "rescore_query": {"match_all": {}}}}},
    {"rescore": {"query": {}}},
    {"rescore": {"query": {"rescore_query": {"match_all": {}},
                           "score_mode": "median"}}},
    {"collapse": {}},
    {"collapse": {"field": "body"}},
    {"sort": [{"nope": "asc"}]},
    {"sort": [{"body": "asc"}]},
    {"sort": [{"tag": "asc", "price": "desc"}]},
    {"sort": [3]},
    {"query": {"hybrid": {"queries": [{"match_all": {}}]}},
     "sort": ["price"]},
], ids=["after_without_sort", "after_not_array", "after_length",
        "rescore_sort", "rescore_collapse", "rescore_no_query",
        "rescore_mode", "collapse_no_field", "collapse_text",
        "unmapped", "text_field", "two_fields_one_clause",
        "clause_type", "hybrid_sort"])
def test_errors_match_reference(pair3, body):
    jax_s, port_s = pair3
    with pytest.raises(Exception) as want:
        jax_s.search(body)
    with pytest.raises(Exception) as got:
        port_s.search(body)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    assert got.value.status == want.value.status == 400


# -- the device order against the comparator ----------------------------------

def comparator_rows(searcher, specs, flat_rows, scores):
    """Every row ``(seg, local)`` with its key tuple as the reference
    builds it from the host columns, sorted by ``sort_comparator``."""
    rows = []
    for si, local in flat_rows:
        seg = searcher.segments[si]
        keys = []
        for spec in specs:
            field, order = spec["field"], spec["order"]
            if field == "_score":
                keys.append(float(np.float64(scores[si][local])))
                continue
            if field == "_doc":
                keys.append(local)
                continue
            ft = searcher.mapper.field_type(field)
            if ft.dv_kind == "ordinal":
                dv = seg.ordinal_dv.get(field)
                if dv is None or not dv.exists[local]:
                    keys.append(None)
                else:
                    o = dv.min_ord[local] if order == "asc" \
                        else dv.max_ord[local]
                    keys.append(dv.ord_terms[o])
                continue
            dv = seg.numeric_dv.get(field)
            if dv is None or not dv.exists[local]:
                keys.append(sorting.missing_sentinel(ft.dv_kind, order,
                                                     spec["missing"]))
            else:
                v = (dv.minv if order == "asc" else dv.maxv)[local]
                keys.append(int(v) if ft.dv_kind == "long" else float(v))
        rows.append({"seg": si, "local": local, "sort": keys})
    return sorted(rows, key=functools.cmp_to_key(
        sorting.sort_comparator(specs)))


ADVERSARIAL_FIELDS = ["tag", "price", "big", "fare", "_score", "_doc"]


@pytest.mark.parametrize("case", range(12))
def test_device_order_equals_comparator(case):
    """``field_order`` on adversarial seeded keys (ties, ±0.0, sentinels
    as real values, keyword None, custom missing values) against the
    reference's comparator over the same rows, 1-3 clauses in both
    directions, and ``search_after`` against the comparator's filter."""
    rng = np.random.default_rng(100 + case)
    docs = corpus_docs(200 + case)
    mapper = DocumentMapper(MAPPING)
    segs, i = [], 0
    for si, size in enumerate(SEG_SIZES):
        segs.append(SegmentWriter().build(
            [mapper.parse(str(i + j), docs[i + j]) for j in range(size)],
            f"s{si}"))
        i += size
    searcher = ShardSearcher(segs, mapper, device="cpu")
    specs = []
    for field in rng.choice(ADVERSARIAL_FIELDS,
                            size=int(rng.integers(1, 4)), replace=False):
        order = str(rng.choice(["asc", "desc"]))
        missing = str(rng.choice(["_last", "_first", "custom"]))
        if missing == "custom":
            missing = {"tag": "k06", "fare": -0.0}.get(str(field), 1)
        specs.append({"field": str(field), "order": order,
                      "missing": missing})
    (plan, bind) = searcher.compiled({"match": {"body": "w0 w1 w2 w5"}})
    views = list(searcher._run_full(plan, bind, plan.arrays(), None))
    flat = sorting.matched_rows(searcher, views)
    ordered = sorting.field_order(searcher, views, flat, specs)
    got, _ = ordered.take()
    starts = sorting.segment_starts(searcher)[0]
    pairs = [(int(np.searchsorted(starts, f, side="right") - 1),
              int(f - starts[np.searchsorted(starts, f, side="right") - 1]))
             for f in flat.tolist()]
    scores = [s.numpy() for _seg, _d, s, _m in views]
    want = comparator_rows(searcher, specs, pairs, scores)
    assert len(got) == len(want) == ordered.total > 20
    assert [(r["seg"], r["local"]) for r in got] == \
        [(r["seg"], r["local"]) for r in want]
    # search_after: the comparator's filter against a probe at a row
    probe_row = want[int(rng.integers(0, len(want)))]
    probe = list(probe_row["sort"])
    after = sorting.field_order(searcher, views, flat, specs, probe)
    cmp = sorting.sort_comparator(specs)
    kept = [r for r in want if cmp(r, {"sort": probe, "seg": 2**31 - 1,
                                       "local": 2**31 - 1}) > 0]
    assert [(r["seg"], r["local"]) for r in after.take()[0]] == \
        [(r["seg"], r["local"]) for r in kept]
    assert after.total == ordered.total


def test_sort_keys_never_read_raw_ordinals():
    """Two segments whose one term has different ordinals: the rank
    table orders them by the term."""
    mapper = DocumentMapper({"properties": {"tag": {"type": "keyword"}}})
    a = SegmentWriter().build([mapper.parse("0", {"tag": "b"}),
                               mapper.parse("1", {"tag": "c"})], "a")
    b = SegmentWriter().build([mapper.parse("2", {"tag": "a"}),
                               mapper.parse("3", {"tag": "b"})], "b")
    searcher = ShardSearcher([a, b], mapper, device="cpu")
    for order, want in (("asc", ["2", "0", "3", "1"]),
                        ("desc", ["1", "0", "3", "2"])):
        got = searcher.search({"sort": [{"tag": order}]})
        assert [h["_id"] for h in got["hits"]["hits"]] == want
        assert got["hits"]["hits"][0]["sort"] in (["a"], ["c"])


def test_scan_rows_matches_reference(pair3):
    """Every matched row in result order on the device, and slices of it,
    as the reference's ``scan_rows`` materializes them."""
    jax_s, port_s = pair3
    for body, spec in (({"query": MATCH}, None),
                       ({"query": MATCH, "sort": [{"tag": "desc"}]}, None),
                       ({"query": MATCH}, {"id": 1, "max": 3}),
                       ({"sort": [{"fare": "asc"}, "_doc"]},
                        {"id": 0, "max": 2})):
        want_rows, want_total = jax_s.scan_rows(body, spec)
        ordered, total = port_s.scan_rows(body, spec)
        assert total == want_total == ordered.total
        rows, _ = ordered.take()
        assert json.dumps(rows) == json.dumps(
            [{k: sorting.sort_value(v) if k != "sort" else
              [sorting.sort_value(x) for x in v] for k, v in r.items()}
             for r in want_rows])
        assert ordered.take(5)[0] == rows[:5]
    for bad in ({"id": 0, "max": 1}, {"id": 3, "max": 3}):
        with pytest.raises(Exception) as want:
            jax_s.scan_rows({}, bad)
        with pytest.raises(Exception) as got:
            port_s.scan_rows({}, bad)
        assert str(got.value) == str(want.value)


def test_page_read_back_grows_with_k_not_matches(pair3):
    """A sorted page reads back its rows, not the matched set."""
    _jax, port = pair3
    sizes = {}
    for size in (1, 10, 100):
        port.read_back_bytes = 0
        port.search({"sort": [{"ts": "desc"}], "size": size})
        sizes[size] = port.read_back_bytes
    assert sizes[1] < sizes[10] < sizes[100] <= 16 + 100 * 3 * 8


# -- the coordinator merge ----------------------------------------------------

@pytest.mark.parametrize("sort", [
    None, [{"_score": "desc"}], [{"tag": "asc"}],
    [{"tag": {"order": "desc", "missing": "_first"}}, {"price": "asc"}],
    [{"fare": "desc"}],
], ids=["score", "score_desc", "tag", "tag_first_price", "fare_desc"])
def test_merge_hit_rows_matches_reference(sort):
    """Three sources' hits with ties, -0.0 / 0.0 and None sort values."""
    rng = np.random.default_rng(9)
    rows = []
    for src in range(3):
        for pos in range(12):
            tag = [None, "a", "b"][int(rng.integers(0, 3))]
            values = {"tag": tag, "price": int(rng.integers(0, 3)),
                      "fare": float(rng.choice([-0.0, 0.0, 1.5]))}
            hit = {"_id": f"{src}-{pos}",
                   "_score": float(rng.choice([1.0, 2.5, 0.0]))}
            if sort is not None and "_score" not in sort[0]:
                hit["sort"] = [values[next(iter(c))] for c in sort]
            rows.append((hit, src, pos))
    want = jax_executor.merge_hit_rows(list(rows), sort)
    assert merge_hit_rows(list(rows), sort) == want


# -- over HTTP, against the reference node -------------------------------------

STRIPPED = frozenset({"took", "uuid", "creation_date", "cluster_uuid"})


def call(node, method, path, body=None, ndjson=None):
    url = f"http://127.0.0.1:{node.port}{path}"
    data, headers = None, {}
    if ndjson is not None:
        data = ("\n".join(json.dumps(line) for line in ndjson)
                + "\n").encode()
        headers["Content-Type"] = "application/x-ndjson"
    elif body is not None:
        data = json.dumps(body).encode()
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            payload = resp.read()
            return resp.status, json.loads(payload) if payload else {}
    except urllib.error.HTTPError as e:
        payload = e.read()
        return e.code, json.loads(payload) if payload else {}


def strip(value):
    if isinstance(value, dict):
        return {k: strip(v) for k, v in value.items() if k not in STRIPPED}
    if isinstance(value, list):
        return [strip(v) for v in value]
    return value


def both(nodes, method, path, body=None, ndjson=None):
    ref, port = (call(n, method, path, body, ndjson) for n in nodes)
    assert ref[0] == port[0], (method, path, ref, port)
    assert strip(ref[1]) == strip(port[1]), (method, path, ref[1], port[1])
    return port


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bm25, "HOST_SCORING", False)
        ref = JaxNode(str(tmp_path_factory.mktemp("ref")), port=0).start()
        port = Node(str(tmp_path_factory.mktemp("port")), port=0,
                    device="cpu").start()
        try:
            docs = corpus_docs(5)
            for name, shards, lo, hi in (("s1", 1, 0, 150),
                                         ("s2", 2, 150, len(docs))):
                both((ref, port), "PUT", f"/{name}", {
                    "settings": {"number_of_shards": shards},
                    "mappings": MAPPING})
                lines = []
                for i in range(lo, hi):
                    lines += [{"index": {"_index": name, "_id": str(i)}},
                              docs[i]]
                both((ref, port), "POST", "/_bulk?refresh=true",
                     ndjson=lines)
            yield ref, port
        finally:
            ref.stop()
            port.stop()


@pytest.mark.parametrize("path,body", [
    ("/s1,s2/_search", {"sort": [{"tag": "asc"}, {"n": "desc"}],
                        "size": 15, "from": 3}),
    ("/s1,s2/_search", {"query": MATCH, "sort": [{"fare": "desc"},
                                                 "_score"], "size": 20}),
    ("/s2,s1/_search", {"sort": [{"ts": "asc"}, {"n": "asc"}],
                        "search_after": ["2024-02-02T00:00:00Z", 40]}),
    ("/s*/_search", {"sort": [{"price": {"order": "desc",
                                         "missing": "_first"}}],
                     "size": 30}),
    ("/s1/_search", {"collapse": {"field": "tag"}, "query": MATCH}),
    ("/s2/_search", {"query": {"match": {"title": "quick"}},
                     "highlight": {"fields": {"title": {}}},
                     "docvalue_fields": ["price", "ts"], "explain": True,
                     "size": 3}),
    ("/s1/_search", {"query": MATCH, "rescore": {
        "window_size": 7, "query": {
            "rescore_query": {"match": {"body": "w3"}},
            "score_mode": "max"}}}),
    ("/s1/_search", {"query": MATCH, "stored_fields": ["n"], "size": 2}),
], ids=["two_index_sort", "two_index_score_key", "two_index_after",
        "wildcard_missing_first", "collapse", "fetch", "rescore",
        "stored_fields"])
def test_http_search_matches_reference_node(nodes, path, body):
    status, resp = both(nodes, "POST", path, body)
    assert status == 200 and resp["hits"]["hits"], resp


def test_http_msearch_matches_reference_node(nodes):
    lines = [{"index": "s1"}, {"sort": [{"tag": "desc"}], "size": 4},
             {"index": "s2"}, {"query": MATCH, "collapse": {"field": "price"}},
             {"index": "s1"}, {"query": MATCH}]
    assert both(nodes, "POST", "/_msearch", ndjson=lines)[0] == 200


@pytest.mark.parametrize("body", [
    {"sort": ["price"], "from": 9995, "size": 10},
    {"docvalue_fields": [f"f{i}" for i in range(101)]},
    {"query": MATCH, "rescore": {"window_size": 10001, "query": {
        "rescore_query": {"match_all": {}}}}},
], ids=["result_window", "docvalue_fields", "rescore_window"])
def test_index_service_limits_answer_400(nodes, body):
    """``IndexService._check_search_limits`` guards the requests that now
    reach the searcher, with the reference's 400s."""
    status, resp = both(nodes, "POST", "/s1/_search", body)
    assert status == 400
    assert resp["error"]["type"] == "illegal_argument_exception"


def test_http_errors_match_reference_node(nodes):
    for body in ({"sort": ["price"], "rescore": {"query": {
            "rescore_query": {"match_all": {}}}}},
                 {"search_after": [1]},
                 {"collapse": {"field": "body"}}):
        assert both(nodes, "POST", "/s1/_search", body)[0] == 400
    # suggest is served now: the answer equals the reference node's
    status, resp = both(nodes, "POST", "/s1/_search", {"suggest": {"s": {
        "text": "w1", "term": {"field": "body"}}}})
    assert status == 200 and resp["suggest"]["s"][0]["text"] == "w1"
    # profile is served since the Profile API is ported (this check held
    # a 501): the hits and the profile's shape equal the reference's
    ref, port = (call(n, "POST", "/s1/_search", {"profile": True})
                 for n in nodes)
    assert ref[0] == port[0] == 200, (ref, port)
    assert ref[1]["hits"] == port[1]["hits"]
    assert profile_shape(ref[1], False) == profile_shape(port[1], False)
