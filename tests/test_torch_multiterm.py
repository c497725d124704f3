"""The multi-term queries of the PyTorch port (``ExpandTermsPlan``:
``wildcard``, ``regexp``, ``fuzzy``, ``match`` and ``match_bool_prefix``
with ``fuzziness``, the ``query_string`` wildcards and fuzzies) through
``ShardSearcher`` on the CPU against the JAX package's, on the same docs:
three segments of a few hundred docs with deletes, made from a seed with
numpy over a small alphabet so that patterns expand to many terms.
Answers must be equal byte for byte (ids, float32 scores, totals,
``max_score``; ``count`` equal; errors of the same type and status).
The JAX side scores on its device path (``HOST_SCORING = False``).

Also: the optimal-string-alignment test against the reference's on
random pairs, each distinct term tested once per request, the
constant-score bound, and the scale corpus's dictionaries (``testing/
corpus.py`` ``make_segments``) sorted with their term ids as the
writer's, which the dictionary walks rely on.
"""

import numpy as np
import pytest

from opensearch_tpu.common.errors import OpenSearchTpuError as JaxError
from opensearch_tpu.index import codec as jcodec
from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
from opensearch_tpu.ops import bm25 as jbm25
from opensearch_tpu.search import plan as jplan
from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
from opensearch_tpu_torch.common.errors import OpenSearchTpuError
from opensearch_tpu_torch.index import codec as tcodec
from opensearch_tpu_torch.index.segment import SegmentWriter
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.search import plan as tplan
from opensearch_tpu_torch.search.executor import ShardSearcher
from opensearch_tpu_torch.testing import corpus
from opensearch_tpu_torch.testing.parity import bm25_mismatch

MAPPING = {"properties": {"body": {"type": "text"},
                          "title": {"type": "text"},
                          "code": {"type": "keyword"},
                          "n": {"type": "long"}}}
ALPHABET = list("abcdeo")
SPLITS = (150, 120, 90)


def words(rng, n):
    """``n`` seeded words of 2-6 letters over ``ALPHABET``."""
    return ["".join(rng.choice(ALPHABET, size=int(rng.integers(2, 7))))
            for _ in range(n)]


def sources(n_docs=sum(SPLITS), seed=21):
    rng = np.random.default_rng(seed)
    vocab = words(rng, 160)
    out = []
    for _ in range(n_docs):
        src = {"body": " ".join(rng.choice(vocab,
                                           size=int(rng.integers(3, 12)))),
               "title": " ".join(rng.choice(vocab,
                                            size=int(rng.integers(1, 4)))),
               "code": str(rng.choice(vocab)).upper(),
               "n": int(rng.integers(0, 100))}
        if rng.uniform() < 0.1:
            del src["title"]
        out.append(src)
    return out


def shard_pair(mapping, docs, splits, deletes=0, seed=5, points=None):
    """(JAX searcher, port searcher) over the same docs, one segment per
    run of ``splits`` (ids are the docs' indices, segment ids ``s0``,
    ``s1``, ...), ``deletes`` seeded local deletes a segment applied to
    both.  ``points`` {(doc, geo field): [(lat, lon), ...]} adds points
    to the parsed docs (the mappers parse one point a field)."""
    rng = np.random.default_rng(seed)
    dels = [rng.choice(size, size=min(deletes, size), replace=False)
            for size in splits]
    out = []
    for writer, mapper_cls, searcher_cls, kw in (
            (JaxWriter(), JaxMapper, JaxSearcher, {}),
            (SegmentWriter(), DocumentMapper, ShardSearcher,
             {"device": "cpu"})):
        mapper = mapper_cls(mapping)
        segs, i = [], 0
        for si, size in enumerate(splits):
            parsed = [mapper.parse(str(i + j), src)
                      for j, src in enumerate(docs[i: i + size])]
            for (doc, field), pts in (points or {}).items():
                if i <= doc < i + size:
                    parsed[doc - i].geo_points.setdefault(field, []).extend(
                        pts)
            seg = writer.build(parsed, f"s{si}")
            if deletes:
                seg.apply_deletes(dels[si])
            segs.append(seg)
            i += size
        out.append(searcher_cls(segs, mapper, **kw))
    return out


def check(pair_, body, rtol=0.0):
    """The port's answer to ``body`` against the reference's: byte for
    byte, or with ``rtol`` scores within that relative tolerance and ids
    equal where neighbouring scores are farther apart."""
    jax_s, port_s = pair_
    ref, got = jax_s.search(body), port_s.search(body)
    if rtol == 0.0:
        bad = bm25_mismatch(got, ref)
        assert bad is None, (body, bad)
        assert got["hits"]["max_score"] == ref["hits"]["max_score"], body
        return got
    assert got["hits"]["total"] == ref["hits"]["total"], body
    ga, ra = got["hits"]["hits"], ref["hits"]["hits"]
    assert len(ga) == len(ra), body
    for i, (g, r) in enumerate(zip(ga, ra)):
        assert g["_score"] == pytest.approx(r["_score"], rel=rtol, abs=0), \
            (body, i)
        if g["_id"] != r["_id"]:
            assert g["_score"] == pytest.approx(ga[i ^ 1]["_score"],
                                                rel=2 * rtol), (body, i)
    return got


@pytest.fixture(scope="module")
def shards():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbm25, "HOST_SCORING", False)
        yield shard_pair(MAPPING, sources(), SPLITS, deletes=9)


MULTITERM_BODIES = [
    {"wildcard": {"body": "a*"}},
    {"wildcard": {"body": "ab*"}},
    {"wildcard": {"body": {"value": "*e", "boost": 2.5}}},
    {"wildcard": {"body": "a?o*"}},
    {"wildcard": {"body": "[ab]c*"}},
    {"wildcard": {"body": "*"}},
    {"wildcard": {"body": "zz*"}},
    {"wildcard": {"body": {"value": "AB*", "case_insensitive": True}}},
    {"wildcard": {"code": "AB*"}},
    {"wildcard": {"code": {"value": "ab*", "case_insensitive": True}}},
    {"wildcard": {"missing_field": "a*"}},
    {"regexp": {"body": "a.*"}},
    {"regexp": {"body": "[abc]{2}o?"}},
    {"regexp": {"body": {"value": "(ab|ba).*e", "boost": 0.5}}},
    {"regexp": {"body": "d"}},
    {"fuzzy": {"body": "abcd"}},
    {"fuzzy": {"body": {"value": "abcd", "fuzziness": 0}}},
    {"fuzzy": {"body": {"value": "abcd", "fuzziness": 1}}},
    {"fuzzy": {"body": {"value": "abcde", "fuzziness": 2}}},
    {"fuzzy": {"body": {"value": "bacd", "fuzziness": 1}}},
    {"fuzzy": {"body": {"value": "abcde", "fuzziness": 2,
                        "prefix_length": 2}}},
    {"fuzzy": {"body": {"value": "ab", "fuzziness": "AUTO"}}},
    {"fuzzy": {"body": {"value": "abcdeoa", "fuzziness": "AUTO"}}},
    {"match": {"body": {"query": "abcd ocea", "fuzziness": "AUTO"}}},
    {"match": {"body": {"query": "abcd ocea", "fuzziness": 1,
                        "operator": "and"}}},
    {"match": {"body": {"query": "abcd ocea deab", "fuzziness": 2,
                        "minimum_should_match": 2}}},
    {"match": {"title": {"query": "abc", "fuzziness": "AUTO",
                         "boost": 3.0}}},
    {"match_bool_prefix": {"body": {"query": "abcd oc", "fuzziness": 1}}},
    {"match_bool_prefix": {"body": {"query": "abcd deab e",
                                    "fuzziness": "AUTO",
                                    "operator": "and"}}},
    {"multi_match": {"query": "abcd ab", "fields": ["body", "title"],
                     "type": "bool_prefix", "fuzziness": 1}},
    {"query_string": {"query": "body:ab*"}},
    {"query_string": {"query": "body:AB* title:D?E*"}},
    {"query_string": {"query": "body:abcd~1 title:oc*"}},
    {"query_string": {"query": "ab* AND body:d?e*"}},
    {"bool": {"must": [{"wildcard": {"body": "a*"}}],
              "should": [{"match": {"body": "abc"}}],
              "must_not": [{"fuzzy": {"title": "oca"}}],
              "filter": [{"range": {"n": {"gte": 20}}}]}},
    {"constant_score": {"filter": {"regexp": {"title": "[de].*"}},
                        "boost": 4.0}},
    {"dis_max": {"queries": [{"wildcard": {"body": "e*"}},
                             {"fuzzy": {"title": "abo"}}],
                 "tie_breaker": 0.5}},
]


def cases(bodies):
    return [pytest.param(b, id=f"{i}-{next(iter(b))}")
            for i, b in enumerate(bodies)]


@pytest.mark.parametrize("query", cases(MULTITERM_BODIES))
def test_query_equals_reference(shards, query):
    for extra in ({"size": 10}, {"size": 400}):
        check(shards, {"query": query, **extra})
    jax_s, port_s = shards
    assert port_s.count(query) == jax_s.count(query)


def test_min_score_prunes_like_the_reference(shards):
    """A constant-score multi-term mask under ``min_score``: its bound
    is its boost, as the reference's."""
    for boost, ms in ((2.0, 1.5), (2.0, 2.5)):
        check(shards, {"query": {"wildcard": {"body": {
            "value": "a*", "boost": boost}}}, "min_score": ms})
    _jax_s, port_s = shards
    plan, bind = port_s.compiled({"wildcard": {"body": {"value": "a*",
                                                        "boost": 2.0}}})
    assert isinstance(plan, tplan.ExpandTermsPlan)
    assert plan.max_score_bound(bind, port_s.segments[0]) == \
        jplan._boost_bound(None, bind, None)


ERROR_BODIES = [
    {"regexp": {"body": "a(b"}},
    {"wildcard": {"n": "1*"}},
    {"fuzzy": {"body": {"value": "abc", "fuzziness": "two"}}},
]


@pytest.mark.parametrize("query", cases(ERROR_BODIES))
def test_errors_equal_reference(shards, query):
    jax_s, port_s = shards
    try:
        ref = jax_s.search({"query": query})
    except JaxError as exc:
        ref = exc
    except Exception as exc:  # noqa: BLE001 - the reference's own type
        ref = exc
    if isinstance(ref, dict):
        check(shards, {"query": query})
        return
    with pytest.raises(Exception) as got:
        port_s.search({"query": query})
    assert type(got.value).__name__ == type(ref).__name__
    if isinstance(ref, JaxError):
        assert isinstance(got.value, OpenSearchTpuError)
        assert got.value.status == ref.status


def test_quantized_segments(monkeypatch):
    """On quantized segments (both codec modules set to ``on``) the
    masks read the doc ids ``ensure_postings`` stages on demand."""
    for mod in (jcodec, tcodec):
        monkeypatch.setattr(mod, "QUANTIZED_MODE", "on")
    monkeypatch.setattr(jbm25, "HOST_SCORING", False)
    pair_ = shard_pair(MAPPING, sources(200, seed=4), (120, 80), deletes=5)
    dsegs = [seg.device("cpu") for seg in pair_[1].segments]
    assert all(d.quantized_mode for d in dsegs)
    for query in ({"wildcard": {"body": "a*"}},
                  {"fuzzy": {"body": {"value": "abcd", "fuzziness": 2}}},
                  {"match": {"body": {"query": "abc deo",
                                      "fuzziness": "AUTO"}}},
                  {"bool": {"must": [{"match": {"body": "abc"}}],
                            "filter": [{"regexp": {"body": "[ab].*"}}]}}):
        check(pair_, {"query": query, "size": 50})


def test_terms_tested_once_per_request(shards, monkeypatch):
    """Each distinct term of the segments' dictionaries is tested once
    for a fuzzy pattern; a repeated body (the plan cache's) tests none,
    and another body with the same pattern tests every term again: no
    verdict outlives its request."""
    calls = []
    edit = tplan._edit_distance_le

    def counted(a, b, k):
        calls.append(b)
        return edit(a, b, k)
    monkeypatch.setattr(tplan, "_edit_distance_le", counted)
    _jax_s, port_s = shards
    body = {"query": {"fuzzy": {"body": {"value": "odcba",
                                         "fuzziness": 2}}}}
    check(shards, body)
    distinct = set()
    for seg in port_s.segments:
        distinct |= set(seg.postings["body"].terms)
    assert sorted(calls) == sorted(distinct)
    calls.clear()
    check(shards, {**body, "size": 3})
    assert calls == []
    check(shards, {"query": {"bool": {"must": [body["query"]]}}})
    assert sorted(calls) == sorted(distinct)


def osa(a, b):
    """Optimal string alignment distance, the plain recurrence."""
    d = [[0] * (len(b) + 1) for _ in range(len(a) + 1)]
    for i in range(len(a) + 1):
        d[i][0] = i
    for j in range(len(b) + 1):
        d[0][j] = j
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            d[i][j] = min(d[i - 1][j] + 1, d[i][j - 1] + 1,
                          d[i - 1][j - 1] + cost)
            if i > 1 and j > 1 and a[i - 1] == b[j - 2] and \
                    a[i - 2] == b[j - 1]:
                d[i][j] = min(d[i][j], d[i - 2][j - 2] + 1)
    return d[len(a)][len(b)]


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_edit_distance_equals_reference(k):
    rng = np.random.default_rng(k)
    for _ in range(400):
        a, b = words(rng, 2)
        if rng.uniform() < 0.3:                 # a transposition
            i = int(rng.integers(0, max(1, len(a) - 1)))
            b = a[:i] + a[i + 1: i + 2] + a[i: i + 1] + a[i + 2:]
        got = tplan._edit_distance_le(a, b, k)
        assert got == jplan._edit_distance_le(a, b, k), (a, b, k)
        assert got == (osa(a, b) <= k), (a, b, k)


def test_scale_dictionaries_are_the_writers():
    """``make_segments`` builds each segment's dictionary as the writer
    does: the terms sorted, term ids in that order, and each term's rows
    and positions the writer's; so a prefix over the scale corpus finds
    every term that starts with it."""
    n = 600
    segs = corpus.make_segments(corpus.build_raw_corpus(n, seed=42), 2)
    mapper = DocumentMapper({"properties": {"body": {"type": "text"}}})
    texts = corpus.render_texts(n, seed=42)
    lo = 0
    for seg in segs:
        written = SegmentWriter().build(
            [mapper.parse(str(i), {"body": t})
             for i, t in enumerate(texts[lo: lo + seg.n_docs])], "w")
        a, b = seg.postings["body"], written.postings["body"]
        assert list(a.terms.items()) == list(b.terms.items())
        for col in ("df", "offsets", "doc_ids", "tfs", "pos_offsets",
                    "positions"):
            np.testing.assert_array_equal(getattr(a, col), getattr(b, col),
                                          err_msg=col)
        lo += seg.n_docs
    searcher = ShardSearcher(segs, mapper, device="cpu")
    for prefix in ("t1", "t12", "t3"):
        want = {t for seg in segs for t in seg.postings["body"].terms
                if t.startswith(prefix)}
        got = searcher.search({"query": {"prefix": {"body": prefix}},
                               "size": 0})["hits"]["total"]["value"]
        expect = sum(
            int(np.isin(np.arange(seg.n_docs), np.concatenate(
                [seg.postings["body"].doc_ids[
                    seg.postings["body"].offsets[tid]:
                    seg.postings["body"].offsets[tid + 1]]
                 for t, tid in seg.postings["body"].terms.items()
                 if t in want] or [np.zeros(0, np.int32)])).sum())
            for seg in segs)
        assert got == expect, prefix
