"""The relevance-shaping queries of the PyTorch port through
``ShardSearcher`` on the CPU against the JAX package's, on the same docs:
``function_score`` (every function kind, ``field_value_factor``
modifier, ``score_mode``, ``boost_mode`` and decay, over numeric, date
and geo origins; ``max_boost``, ``min_score``, function filters),
``boosting``, ``terms_set``, ``distance_feature``, ``rank_feature`` and
``more_like_this``.

Corpora: ``tests/test_query_tail.py``'s docs (its cases are mirrored
here one by one) and a seeded corpus of a few hundred docs in three
segments with deletes, multi-valued numbers and points, and docs missing
each field.  Answers must be equal byte for byte (ids, float32 scores,
totals, ``max_score``), float32 results that the reference's XLA code
flushes to zero included, except the bodies marked ``ulp``: a float32
score script's ``Math.log`` / ``Math.pow`` (``rank_feature``'s log and
sigmoid curves, a ``script_score`` function), which XLA's float32
approximations and torch's round apart by a unit in the last place;
those hold to 2 float32 ulps (rtol 2.4e-7, ids equal but for
neighbours within it).  A script function's vector function is K1's
float64 sum, held as ``tests/test_torch_scripting.py`` holds
``script_score`` (rtol 1e-5).  The JAX side scores on its device path
(``HOST_SCORING = False``).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from opensearch_tpu.common.errors import OpenSearchTpuError as JaxError
from opensearch_tpu.ops import bm25 as jbm25
from opensearch_tpu_torch.common.errors import OpenSearchTpuError
from opensearch_tpu_torch.ops import bm25 as tbm25
from opensearch_tpu_torch.ops import knn as tknn
from opensearch_tpu_torch.search import executor as texecutor
from opensearch_tpu_torch.search import plan as tplan
from test_torch_multiterm import check, shard_pair

# the 2-float32-ulp tolerance of the transcendental kinds, were one to
# differ from the reference's XLA code in the last float64 bit
TRANSCENDENTAL_RTOL = 2.4e-7
VECTOR_RTOL = 1e-5

TAIL_MAPPING = {"properties": {
    "title": {"type": "text"}, "body": {"type": "text"},
    "tags": {"type": "keyword"}, "views": {"type": "long"},
    "score_f": {"type": "double"}, "required_matches": {"type": "long"},
    "published": {"type": "date"}, "loc": {"type": "geo_point"}}}
TAIL_DOCS = [
    {"title": "red fox", "body": "quick red fox jumps", "tags": ["animal"],
     "views": 100, "score_f": 2.0, "required_matches": 2,
     "published": "2024-01-01T00:00:00Z",
     "loc": {"lat": 40.7, "lon": -74.0}},
    {"title": "red dog", "body": "lazy red dog sleeps", "tags": ["animal"],
     "views": 50, "score_f": 1.0, "required_matches": 1,
     "published": "2024-06-01T00:00:00Z",
     "loc": {"lat": 40.8, "lon": -73.9}},
    {"title": "blue bird", "body": "blue bird sings red songs",
     "tags": ["animal", "sky"], "views": 10, "score_f": 4.0,
     "required_matches": 3, "published": "2023-01-01T00:00:00Z",
     "loc": {"lat": 51.5, "lon": -0.1}},
    {"title": "green tree", "body": "tall green tree", "tags": ["plant"],
     "views": 500, "score_f": 0.5, "required_matches": 1,
     "published": "2022-01-01T00:00:00Z", "loc": {"lat": 48.9, "lon": 2.3}},
]
FEATURE_MAPPING = {"properties": {"body": {"type": "text"},
                                  "loc": {"type": "geo_point"},
                                  "pagerank": {"type": "rank_feature"}}}
FEATURE_DOCS = [
    {"body": "quick brown fox", "loc": {"lat": 1, "lon": 1},
     "pagerank": 8.0},
    {"body": "quick brown foam", "loc": {"lat": 5, "lon": 5},
     "pagerank": 2.0},
    {"body": "brown quick fox", "loc": {"lat": 9, "lon": 9},
     "pagerank": 0.5},
    {"body": "slow green turtle", "loc": {"lat": 2, "lon": 8}},
]

DIM = 8
MAPPING = {"properties": {
    "body": {"type": "text"}, "title": {"type": "text"},
    "tag": {"type": "keyword"}, "views": {"type": "long"},
    "price": {"type": "double"}, "need": {"type": "long"},
    "ts": {"type": "date"}, "loc": {"type": "geo_point"},
    "rank": {"type": "rank_feature"},
    "vec": {"type": "knn_vector", "dimension": DIM, "space_type": "l2"}}}
VOCAB = [f"w{i}" for i in range(40)]
TAGS = ["red", "green", "blue", "gold"]
TS0 = 1_704_067_200_000
SPLITS = (140, 110, 90)


def loc_near(rng) -> dict:
    return {"lat": float(np.round(40.7 + rng.normal(0, 0.2), 6)),
            "lon": float(np.round(-74.0 + rng.normal(0, 0.2), 6))}


def sources(n_docs=sum(SPLITS), seed=31):
    """Seeded docs and extra points: zipf text, a tag, a multi-valued
    long, a double, the terms_set minimum (a long), a date, a point
    around (40.7, -74.0) (and 1-2 more on every fifth doc, given as
    ``shard_pair``'s ``points``), a positive feature and a vector; each
    field but ``body`` missing on some docs."""
    rng = np.random.default_rng(seed)
    out, points = [], {}
    for i in range(n_docs):
        w = (rng.zipf(1.3, size=int(rng.integers(3, 20))) - 1) % len(VOCAB)
        src = {"body": " ".join(VOCAB[j] for j in w),
               "title": " ".join(rng.choice(VOCAB, size=2)),
               "tag": TAGS[int(rng.integers(0, len(TAGS)))],
               "views": [int(v) for v in rng.integers(
                   0, 1000, size=int(rng.integers(1, 3)))],
               "price": float(np.round(rng.lognormal(2.0, 0.8), 2)),
               "need": int(rng.integers(1, 4)),
               "ts": int(TS0 + rng.integers(0, 365 * 86_400_000)),
               "loc": loc_near(rng),
               "rank": float(np.round(rng.uniform(0.1, 20.0), 3)),
               "vec": rng.standard_normal(DIM).astype(np.float32).tolist()}
        for f in ("views", "price", "need", "ts", "loc", "rank", "title"):
            if rng.uniform() < 0.1:
                del src[f]
        if i % 5 == 0 and "loc" in src:
            points[(i, "loc")] = [
                (p["lat"], p["lon"]) for p in
                (loc_near(rng) for _ in range(int(rng.integers(1, 3))))]
        out.append(src)
    return out, points


@pytest.fixture(scope="module")
def corpora():
    docs, points = sources()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbm25, "HOST_SCORING", False)
        yield {"tail": shard_pair(TAIL_MAPPING, TAIL_DOCS, (2, 2)),
               "feature": shard_pair(FEATURE_MAPPING, FEATURE_DOCS, (2, 2)),
               "main": shard_pair(MAPPING, docs, SPLITS, deletes=8,
                                  points=points)}


def ulp(body) -> tuple:
    """A body held to 2 float32 ulps (its scores go through float32
    ``Math.log`` / ``Math.pow``)."""
    return ("ulp", body)


def cases(name, bodies):
    out = []
    for i, b in enumerate(bodies):
        rtol, b = ((TRANSCENDENTAL_RTOL, b[1]) if isinstance(b, tuple)
                   else (0.0, b))
        out.append(pytest.param(name, b, rtol,
                                id=f"{name}-{i}-{next(iter(b))}"))
    return out


def fs(functions=None, query=None, **kw):
    body = {"query": query or {"match": {"body": "w1 w3"}}, **kw}
    if functions is not None:
        body["functions"] = functions
    return {"function_score": body}


MODIFIERS = ("none", "log", "log1p", "log2p", "ln", "ln1p", "ln2p",
             "square", "sqrt", "reciprocal")
SCORE_MODES = ("multiply", "sum", "avg", "first", "max", "min")
BOOST_MODES = ("multiply", "replace", "sum", "avg", "max", "min")
# a weight, a fvf with a filter, a decay, a random score with a filter
MIXED = [{"weight": 2.5},
         {"filter": {"term": {"tag": "red"}},
          "field_value_factor": {"field": "price", "modifier": "sqrt",
                                 "missing": 3.0}, "weight": 0.7},
         {"gauss": {"ts": {"origin": "2024-07-01T00:00:00Z",
                           "scale": "30d"}}},
         {"filter": {"range": {"views": {"gte": 300}}},
          "random_score": {"seed": 11}, "weight": 4.0}]
DECAYS = [
    {"views": {"origin": 500, "scale": 200}},
    {"views": {"origin": 500, "scale": 200, "offset": 50, "decay": 0.3}},
    {"price": {"origin": 7.5, "scale": 3.25, "decay": 0.8}},
    {"ts": {"origin": "2024-03-01T00:00:00Z", "scale": "20d",
            "offset": "2d"}},
    {"ts": {"origin": TS0 + 86_400_000 * 100, "scale": 864_000_000}},
    {"loc": {"origin": {"lat": 40.7, "lon": -74.0}, "scale": "5km"}},
    {"loc": {"origin": "40.8,-73.9", "scale": "2km", "offset": "1km",
             "decay": 0.25}},
    {"loc": {"origin": [-74.1, 40.6], "scale": "10000m"}},
]

MAIN_BODIES = [
    *[fs([{"field_value_factor": {"field": f, "factor": 1.3,
                                  "modifier": m, "missing": 0.5}}])
      for f in ("views", "price") for m in MODIFIERS],
    *[fs(MIXED, score_mode=m) for m in SCORE_MODES],
    *[fs([{"weight": 3.0}, {"field_value_factor": {"field": "price"}}],
         boost_mode=m, score_mode="sum") for m in BOOST_MODES],
    *[fs([{fn: decay}], boost_mode="replace") for fn in
      ("gauss", "exp", "linear") for decay in DECAYS],
    fs([{"gauss": DECAYS[0]}, {"exp": DECAYS[5]},
        {"linear": DECAYS[3], "weight": 2.0}], score_mode="avg"),
    fs([{"random_score": {}}], boost_mode="replace"),
    fs([{"random_score": {"seed": 7}}], boost_mode="sum", boost=1.5),
    fs([{"random_score": {"seed": 4294967000}}], boost_mode="replace"),
    fs([{"random_score": {"seed": 2.0 ** 33 + 3}}], boost_mode="replace"),
    fs([{"random_score": {"seed": -5}}], boost_mode="replace"),
    ulp(fs([{"script_score": {"script": {
        "source": "Math.log(2 + doc['views'].value) * params.a",
        "params": {"a": 1.5}}}}])),
    fs([{"script_score": {"script": {"source": "doc['tag'].value"}}}]),
    fs([{"script_score": {"script": {"source": "_score * 2 + 1"}}},
        {"weight": 0.5, "filter": {"term": {"tag": "blue"}}}],
       score_mode="sum", boost_mode="replace"),
    fs([{"field_value_factor": {"field": "views", "factor": 10}}],
       max_boost=3.0),
    fs([{"weight": 2.0}], min_score=2.0),
    fs([{"weight": 2.0, "filter": {"match": {"title": "w0"}}},
        {"weight": 5.0, "filter": {"terms": {"tag": ["gold", "red"]}}}],
       score_mode="first", boost=2.0),
    fs([{"exp": {"views": {"origin": 0, "scale": 100}},
         "filter": {"exists": {"field": "views"}}}],
       query={"bool": {"should": [{"match": {"body": "w2"}},
                                  {"term": {"tag": "green"}}]}},
       boost_mode="sum"),
    fs([], query={"match_all": {}}, boost=3.0),
    {"function_score": {"query": {"match": {"body": "w0"}},
                        "field_value_factor": {"field": "price",
                                               "modifier": "log1p"},
                        "boost_mode": "sum"}},
    {"function_score": {"gauss": {"loc": {"origin": "40.7,-74.0",
                                          "scale": "3km"}}}},
    {"boosting": {"positive": {"match": {"body": "w1 w4"}},
                  "negative": {"term": {"tag": "red"}},
                  "negative_boost": 0.3}},
    {"boosting": {"positive": {"bool": {"should": [
        {"match": {"body": "w2"}}, {"match": {"title": "w2"}}]}},
        "negative": {"range": {"views": {"lt": 300}}},
        "negative_boost": 1.5, "boost": 2.0}},
    {"terms_set": {"body": {"terms": ["w0", "w1", "w2", "w5"],
                            "minimum_should_match_field": "need"}}},
    {"terms_set": {"body": {"terms": ["w3", "w1"],
                            "minimum_should_match_field": "need",
                            "boost": 2.0}}},
    {"terms_set": {"body": {"terms": ["w0", "w1", "w9"],
                            "minimum_should_match_field": "price"}}},
    {"bool": {"must": [{"match": {"body": "w4"}}], "filter": [
        {"terms_set": {"body": {"terms": ["w0", "w1", "w2"],
                                "minimum_should_match_field": "need"}}}]}},
    {"distance_feature": {"field": "views", "origin": 400, "pivot": 50}},
    {"distance_feature": {"field": "price", "origin": 9.5, "pivot": 2.5,
                          "boost": 3.0}},
    {"distance_feature": {"field": "ts", "origin": "2024-05-01T00:00:00Z",
                          "pivot": "7d"}},
    {"distance_feature": {"field": "loc", "origin": [-74.0, 40.7],
                          "pivot": "1km"}},
    {"distance_feature": {"field": "loc", "origin": "40.9,-74.2",
                          "pivot": "12km"}},
    {"rank_feature": {"field": "rank"}},
    {"rank_feature": {"field": "rank", "saturation": {"pivot": 5.0}}},
    ulp({"rank_feature": {"field": "rank",
                          "log": {"scaling_factor": 2.0}}}),
    ulp({"rank_feature": {"field": "rank", "sigmoid": {"pivot": 3.0,
                                                       "exponent": 0.8}}}),
    {"bool": {"must": [{"match": {"body": "w1"}}],
              "should": [{"rank_feature": {"field": "rank",
                                           "boost": 2.0}}]}},
    {"more_like_this": {"fields": ["body"], "like": "w7 w8 w9 w7 w11",
                        "min_term_freq": 1, "min_doc_freq": 1}},
    {"more_like_this": {"fields": ["body", "title"],
                        "like": ["w3 w12", "w13"], "min_term_freq": 1,
                        "min_doc_freq": 2, "max_query_terms": 3,
                        "minimum_should_match": "50%"}},
    {"more_like_this": {"like": "w5 w6 w5", "min_term_freq": 2,
                        "min_doc_freq": 1}},
]

TAIL_BODIES = [
    # test_query_tail.py's cases, one by one
    {"boosting": {"positive": {"match": {"body": "red"}},
                  "negative": {"term": {"tags": "sky"}},
                  "negative_boost": 0.2}},
    {"terms_set": {"body": {
        "terms": ["red", "fox", "sleeps"],
        "minimum_should_match_field": "required_matches"}}},
    {"distance_feature": {"field": "published",
                          "origin": "2024-06-01T00:00:00Z",
                          "pivot": "30d"}},
    {"distance_feature": {"field": "loc",
                          "origin": {"lat": 40.7, "lon": -74.0},
                          "pivot": "100km"}},
    {"function_score": {"query": {"match": {"body": "red"}},
                        "field_value_factor": {"field": "score_f",
                                               "factor": 2.0,
                                               "modifier": "none"},
                        "boost_mode": "multiply"}},
    {"function_score": {"query": {"match": {"body": "red"}},
                        "functions": [{"filter": {"term": {"tags": "sky"}},
                                       "weight": 10.0}],
                        "boost_mode": "replace"}},
    {"function_score": {"query": {"match_all": {}},
                        "gauss": {"views": {"origin": 100, "scale": 100}},
                        "boost_mode": "replace"}},
    {"function_score": {"query": {"match_all": {}},
                        "random_score": {"seed": 42},
                        "boost_mode": "replace"}},
    {"function_score": {"query": {"match_all": {}},
                        "random_score": {"seed": 7},
                        "boost_mode": "replace"}},
    {"more_like_this": {"fields": ["body"], "like": [{"_id": "0"}],
                        "min_term_freq": 1, "min_doc_freq": 1,
                        "minimum_should_match": "1"}},
    {"more_like_this": {"fields": ["body"], "like": "red songs sings",
                        "min_term_freq": 1, "min_doc_freq": 1,
                        "minimum_should_match": "2"}},
    {"more_like_this": {"fields": ["body"], "like": [{"_id": "0"}],
                        "include": True, "min_term_freq": 1,
                        "min_doc_freq": 1, "minimum_should_match": "1"}},
    {"function_score": {"query": {"match_all": {}},
                        "functions": [{"weight": 3.0}, {"weight": 1.0}],
                        "score_mode": "avg", "boost_mode": "replace"}},
    {"more_like_this": {"fields": ["body"],
                        "like": [{"_id": "1"}, {"_id": "404"}, "sings"],
                        "min_term_freq": 1, "min_doc_freq": 1}},
    {"more_like_this": {"like": [{"_id": "2"}], "min_term_freq": 1,
                        "min_doc_freq": 1}},
    {"geo_distance": {"distance": "50km",
                      "loc": {"lat": 40.7, "lon": -74.0}}},
    {"geo_bounding_box": {"loc": {
        "top_left": {"lat": 52.0, "lon": -1.0},
        "bottom_right": {"lat": 48.0, "lon": 3.0}}}},
    {"query_string": {"query": "title:re*"}},
]

FEATURE_BODIES = [
    {"rank_feature": {"field": "pagerank", "saturation": {"pivot": 2.0}}},
    ulp({"rank_feature": {"field": "pagerank",
                          "log": {"scaling_factor": 1.0}}}),
    {"rank_feature": {"field": "pagerank"}},
    ulp({"rank_feature": {"field": "pagerank",
                          "sigmoid": {"pivot": 2.0, "exponent": 0.6}}}),
    {"geo_polygon": {"loc": {"points": [
        {"lat": 0, "lon": 0}, {"lat": 0, "lon": 7},
        {"lat": 7, "lon": 7}, {"lat": 7, "lon": 0}]}}},
    {"geo_polygon": {"loc": {"points": [
        {"lat": 0, "lon": 0}, {"lat": 10, "lon": 0},
        {"lat": 10, "lon": 3}, {"lat": 3, "lon": 3},
        {"lat": 3, "lon": 10}, {"lat": 0, "lon": 10}]}}},
    {"match_bool_prefix": {"body": {"query": "fox qui",
                                    "fuzziness": "AUTO"}}},
]


@pytest.mark.parametrize("corpus_name,query,rtol", [
    *cases("main", MAIN_BODIES), *cases("tail", TAIL_BODIES),
    *cases("feature", FEATURE_BODIES)])
def test_query_equals_reference(corpora, corpus_name, query, rtol):
    for extra in ({"size": 10}, {"size": 400}):
        check(corpora[corpus_name], {"query": query, **extra}, rtol=rtol)
    jax_s, port_s = corpora[corpus_name]
    assert port_s.count(query) == jax_s.count(query)


def test_script_function_vector_columns(corpora, monkeypatch):
    """A script function that calls a vector function takes its columns
    from one call of K1's scores entry (``vector_scores_segments_auto``)
    per distinct (function, field, query vector) over every segment, and
    its scores hold to the reference's within the script tolerance; the
    body stays out of the plan cache."""
    calls = []
    entry = tknn.vector_scores_segments_auto

    def counted(segs, q, fn):
        calls.append((fn, len(segs)))
        return entry(segs, q, fn=fn)
    monkeypatch.setattr(tknn, "vector_scores_segments_auto", counted)
    q = [0.5, -1.0, 0.25, 0.0, 1.5, -0.5, 0.75, 1.0]
    query = fs([{"script_score": {"script": {
        "source": "cosineSimilarity(params.q, doc['vec']) + 1.0",
        "params": {"q": q}}}},
        {"script_score": {"script": {
            "source": "dotProduct(params.q, doc['vec']) * 0 + "
                      "cosineSimilarity(params.q, doc['vec'])",
            "params": {"q": q}}}, "weight": 0.5},
        {"random_score": {"seed": 3}}], score_mode="sum")
    jax_s, port_s = corpora["main"]
    check(corpora["main"], {"query": query, "size": 30}, rtol=VECTOR_RTOL)
    assert sorted(calls) == [("cosineSimilarity", 3), ("dotProduct", 3)]
    assert texecutor._plan_key(query, True) is None


def test_prepass_launches_each_leaf_once(corpora, monkeypatch):
    """The child ``match`` of function_score and boosting and the term
    filters of its functions are dense leaves: one dense entry call per
    leaf a request over every segment."""
    calls = []
    entry = tbm25.term_bag_dense_auto

    def counted(bags, **kw):
        calls.append(len(bags))
        return entry(bags, **kw)
    monkeypatch.setattr(tbm25, "term_bag_dense_auto", counted)
    for query, n_leaves in (
            (fs([{"filter": {"term": {"tag": "red"}}, "weight": 2.0},
                 {"filter": {"match": {"title": "w1"}}, "weight": 3.0}]),
             3),
            ({"boosting": {"positive": {"match": {"body": "w1 w4"}},
                           "negative": {"term": {"tag": "red"}},
                           "negative_boost": 0.3}}, 2),
            ({"terms_set": {"body": {
                "terms": ["w0", "w1"],
                "minimum_should_match_field": "need"}}}, 1)):
        calls.clear()
        check(corpora["main"], {"query": query, "size": 20})
        assert calls == [3] * n_leaves, (query, calls)


def _xla_u32(x: float) -> int:
    return int(jax.jit(lambda v: v.astype(jnp.uint32))(
        jnp.asarray(np.float64(x))))


@pytest.mark.parametrize("x", [0.0, 3.7, 2.0 ** 32 - 1, 2.0 ** 32 - 0.5,
                               2.0 ** 32, 2.0 ** 32 + 5, 1e20, -1.0,
                               -2.0 ** 40, float("nan"), 4294967295.0 * 2])
def test_random_seed_conversion_equals_xla(x):
    """``random_score``'s seed plus a segment's crc32 salt can pass
    2^32: the float64 to uint32 conversion saturates as XLA's does."""
    assert tplan._u32_of_f64(x) == _xla_u32(x)


def test_random_score_overflow_seed(corpora):
    """A seed whose sum with every segment's salt passes 2^32 answers
    as the reference (the hash of the saturated seed)."""
    _jax_s, port_s = corpora["main"]
    seed = 2 ** 32 - 10
    assert all(seed + zlib.crc32(s.seg_id.encode()) > 2 ** 32
               for s in port_s.segments)
    check(corpora["main"], {"query": fs([{"random_score": {"seed": seed}}],
                                        boost_mode="replace"),
                            "size": 50})


ERROR_BODIES = [
    ("main", {"terms_set": {"body": {"terms": ["w1"],
                                     "minimum_should_match_field": "tag"}}}),
    ("main", {"distance_feature": {"field": "views", "origin": 1,
                                   "pivot": 0}}),
    ("main", {"distance_feature": {"field": "tag", "origin": 1,
                                   "pivot": 1}}),
    ("main", fs([{"field_value_factor": {"field": "tag"}}])),
    ("main", fs([{"gauss": {"views": {"origin": 1, "scale": 0}}}])),
    ("main", fs([{"gauss": {"views": {"origin": 1, "scale": 5,
                                      "decay": 1.5}}}])),
    ("main", fs([{"exp": {"views": {"origin": 1, "scale": 5},
                          "price": {"origin": 1, "scale": 5}}}])),
    ("main", fs([{"gauss": {"tag": {"origin": 1, "scale": 5}}}])),
    ("main", fs([{"bogus": {}}])),
    ("main", fs([{"weight": 1.0}], score_mode="median")),
    ("main", fs([{"weight": 1.0}], boost_mode="pow")),
    ("main", {"rank_feature": {"field": "tag"}}),
    ("main", {"rank_feature": {"field": "rank",
                               "saturation": {"pivot": -1}}}),
    ("main", {"rank_feature": {"field": "rank",
                               "sigmoid": {"pivot": 2.0}}}),
    ("main", {"rank_feature": {"field": "rank",
                               "sigmoid": {"pivot": "x", "exponent": 1}}}),
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
