"""``nested`` queries of the PyTorch port (on the CPU) against the JAX
package's, on the same segments, byte for byte; mirrors
``tests/test_nested.py``.

Two corpora: ``test_nested.py``'s four posts in two segments, and a
seeded random one (three segments of 120-160 posts, each with 0-5
nested ``comments``: an ``author`` keyword, ``stars`` integer, ``text``
text and ``at`` date; deletes applied).  The JAX package builds the
segments, scores on its device path (``HOST_SCORING = False``), and the
port gets them through ``segment_arrays`` / ``segment_from_arrays``,
which carry the nested blocks; the port's own writer must build the same
arrays, nested blocks included.  Responses compare as JSON with ``took``
left out.  Covered: same-object semantics, term / terms / match /
ranges / dates / ``exists`` inside the objects, ``should`` beside
``must``, composition with outer clauses, ``ignore_unmapped``, the 400s,
the staged blocks' padding against the reference's, and persistence
through the store.
"""

import json

import numpy as np
import pytest

from opensearch_tpu.common.errors import OpenSearchTpuError as JaxError
from opensearch_tpu.index.engine import InternalEngine as JaxEngine
from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
from opensearch_tpu.ops import bm25 as jax_bm25
from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
from opensearch_tpu_torch.common.errors import OpenSearchTpuError
from opensearch_tpu_torch.index.engine import InternalEngine
from opensearch_tpu_torch.index.segment import (SegmentWriter,
                                                segment_arrays,
                                                segment_from_arrays)
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.search.executor import ShardSearcher

MAPPING = {"properties": {
    "title": {"type": "text"},
    "comments": {"type": "nested", "properties": {
        "author": {"type": "keyword"},
        "stars": {"type": "integer"},
        "text": {"type": "text"},
        "at": {"type": "date"},
    }},
}}

DOCS = [
    {"title": "post one", "comments": [
        {"author": "alice", "stars": 5, "text": "great work",
         "at": "2024-01-01T00:00:00Z"},
        {"author": "bob", "stars": 1, "text": "terrible mess",
         "at": "2024-02-01T00:00:00Z"},
    ]},
    {"title": "post two", "comments": [
        {"author": "alice", "stars": 1, "text": "not my thing",
         "at": "2024-03-01T00:00:00Z"},
        {"author": "bob", "stars": 5, "text": "great stuff",
         "at": "2024-04-01T00:00:00Z"},
    ]},
    {"title": "post three", "comments": [
        {"author": "carol", "stars": 3, "text": "average"},
    ]},
    {"title": "post four no comments"},
]

AUTHORS = ["alice", "bob", "carol", "dave", "erin", "frank"]
WORDS = ["great", "terrible", "average", "work", "mess", "stuff", "fine",
         "post", "thing", "odd"]
SEG_SIZES = (160, 120, 140)


def random_docs(seed: int) -> list:
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(sum(SEG_SIZES)):
        doc = {"title": " ".join(rng.choice(WORDS, size=int(
            rng.integers(1, 5))))}
        comments = []
        for _ in range(int(rng.integers(0, 6))):
            c = {"author": str(rng.choice(AUTHORS)),
                 "stars": int(rng.integers(1, 6)),
                 "text": " ".join(rng.choice(WORDS, size=int(
                     rng.integers(1, 4))))}
            if rng.random() < 0.8:
                c["at"] = f"2024-{int(rng.integers(1, 13)):02d}-01T00:00:00Z"
            comments.append(c)
        if comments:
            doc["comments"] = comments
        docs.append(doc)
    return docs


def build(writer, mapper, docs, sizes):
    segs, i = [], 0
    for si, size in enumerate(sizes):
        parsed = [mapper.parse(str(i + j), d)
                  for j, d in enumerate(docs[i: i + size])]
        segs.append(writer.build(parsed, f"n{si}"))
        i += size
    return segs


def assert_same_arrays(a, b):
    arr_a, meta_a = segment_arrays(a)
    arr_b, meta_b = segment_arrays(b)
    assert meta_a == meta_b
    assert sorted(arr_a) == sorted(arr_b)
    for key in arr_a:
        assert arr_a[key].dtype == arr_b[key].dtype, key
        np.testing.assert_array_equal(arr_a[key], arr_b[key], err_msg=key)


def shard_pair(docs, sizes, deletes: int = 0, seed: int = 0):
    """(JAX searcher, port searcher) over the same segments, with
    ``deletes`` random deletes a segment."""
    jsegs = build(JaxWriter(), JaxMapper(MAPPING), docs, sizes)
    rng = np.random.default_rng(seed + 1)
    for seg in jsegs:
        if deletes:
            seg.apply_deletes(rng.choice(seg.n_docs, size=deletes,
                                         replace=False))
    tsegs = [segment_from_arrays(*segment_arrays(s)) for s in jsegs]
    for j, t in zip(jsegs, tsegs):
        assert_same_arrays(j, t)
    return (JaxSearcher(jsegs, JaxMapper(MAPPING)),
            ShardSearcher(tsegs, DocumentMapper(MAPPING), device="cpu"))


@pytest.fixture(scope="module")
def corpora():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bm25, "HOST_SCORING", False)
        yield {"small": shard_pair(DOCS, (2, 2)),
               "random": shard_pair(random_docs(7), SEG_SIZES, deletes=9,
                                    seed=7)}


def strip_took(resp: dict) -> str:
    return json.dumps({k: v for k, v in resp.items() if k != "took"})


def same(pair, body):
    jax_s, port_s = pair
    ref, got = jax_s.search(body), port_s.search(body)
    assert strip_took(got) == strip_took(ref), (body, got, ref)
    return got


def nested(query, **extra):
    return {"nested": {"path": "comments", "query": query, **extra}}


def ids(resp):
    return sorted(h["_id"] for h in resp["hits"]["hits"])


ALICE_5 = {"bool": {"must": [{"term": {"comments.author": "alice"}},
                             {"term": {"comments.stars": 5}}]}}

BODIES = {
    "same_object": {"query": nested(ALICE_5)},
    "term": {"query": nested({"term": {"comments.author": "alice"}})},
    "terms_boost": {"query": nested({"terms": {
        "comments.author": ["bob", "carol"]}}, boost=2.5)},
    "relative_child": {"query": nested({"term": {"author": "carol"}})},
    "range": {"query": nested({"range": {"comments.stars": {"gte": 4}}})},
    "range_exclusive": {"query": nested({"range": {"comments.stars": {
        "gt": 1, "lt": 5}}})},
    "range_and_author": {"query": nested({"bool": {"must": [
        {"term": {"comments.author": "bob"}},
        {"range": {"comments.stars": {"lte": 2}}}]}})},
    "date_range": {"query": nested({"range": {"comments.at": {
        "gte": "2024-03-15T00:00:00Z"}}})},
    "date_match": {"query": nested({"match": {
        "comments.at": "2024-02-01T00:00:00Z"}})},
    "numeric_match": {"query": nested({"match": {"comments.stars": 3}})},
    "text_match": {"query": nested({"match": {"comments.text": "great"}})},
    "text_and_author": {"query": nested({"bool": {"must": [
        {"match": {"comments.text": "great"}},
        {"term": {"comments.author": "alice"}}]}})},
    "exists": {"query": nested({"exists": {"field": "comments.at"}})},
    "match_all_inner": {"query": nested({"match_all": {}},
                                        score_mode="max")},
    "should_optional": {"query": nested({"bool": {
        "must": [{"term": {"comments.author": "alice"}}],
        "should": [{"term": {"comments.stars": 5}}]}})},
    "should_required": {"query": nested({"bool": {
        "must": [{"term": {"comments.author": "alice"}}],
        "should": [{"term": {"comments.stars": 5}}],
        "minimum_should_match": 1}})},
    "should_only": {"query": nested({"bool": {"should": [
        {"term": {"comments.author": "dave"}},
        {"range": {"comments.stars": {"gte": 5}}}]}})},
    "must_not_inner": {"query": nested({"bool": {
        "must": [{"exists": {"field": "comments.author"}}],
        "must_not": [{"term": {"comments.author": "alice"}}]}})},
    "filter_in_outer_bool": {"query": {"bool": {
        "must": [{"match": {"title": "post great"}}],
        "filter": [nested({"term": {"comments.author": "carol"}})]}}},
    "must_not_outer": {"query": {"bool": {
        "must": [{"match": {"title": "post"}}],
        "must_not": [nested({"match": {"comments.text": "terrible"}})]}}},
    "should_scores_add": {"query": {"bool": {"should": [
        {"match": {"title": "great"}}, nested(ALICE_5, boost=3.0)]}}},
    "unmapped_ignored": {"query": {"nested": {
        "path": "nope", "ignore_unmapped": True,
        "query": {"match_all": {}}}}},
    "page": {"query": nested({"range": {"comments.stars": {"gte": 2}}}),
             "size": 7, "from": 5},
    "count_only": {"query": nested({"term": {"comments.author": "erin"}}),
                   "size": 0},
}


@pytest.mark.parametrize("corpus", ["small", "random"])
@pytest.mark.parametrize("name", sorted(BODIES))
def test_nested_matches_reference(corpora, corpus, name):
    body = {"size": 50, **BODIES[name]}
    got = same(corpora[corpus], body)
    if corpus == "random" and name not in ("unmapped_ignored",
                                           "count_only"):
        assert got["hits"]["total"]["value"] > 0, name


def test_same_object_semantics(corpora):
    """alice AND stars=5 must hold within ONE comment: doc 1 has
    alice(1) and bob(5), which a flattened index would match."""
    got = same(corpora["small"], {"query": nested(ALICE_5), "size": 10})
    assert ids(got) == ["0"]


def test_nested_counts_match_reference(corpora):
    jax_s, port_s = corpora["random"]
    for name in ("same_object", "exists", "must_not_outer"):
        q = BODIES[name]["query"]
        assert port_s.count(q) == jax_s.count(q)


@pytest.mark.parametrize("query", [
    {"nested": {"path": "title", "query": {"match_all": {}}}},
    {"nested": {"path": "nope", "query": {"match_all": {}}}},
    nested({"wildcard": {"comments.author": "a*"}}),
    nested({"term": {"comments.nope": "x"}}),
    nested({"range": {"comments.author": {"gte": "a"}}}),
], ids=["not_nested", "unknown_path", "inner_type", "unknown_child",
        "range_over_keyword"])
def test_nested_errors_match_reference(corpora, query):
    jax_s, port_s = corpora["small"]
    with pytest.raises(JaxError) as ref:
        jax_s.search({"query": query})
    with pytest.raises(OpenSearchTpuError) as got:
        port_s.search({"query": query})
    assert type(got.value).__name__ == type(ref.value).__name__
    assert got.value.status == ref.value.status == 400
    assert str(got.value) == str(ref.value)


def test_port_writer_builds_the_nested_blocks():
    """The port's ``SegmentWriter`` lays the nested blocks out as the
    reference's: objects appended in doc order, each child's ordinals in
    sorted term order; ``segment_arrays`` / ``segment_from_arrays`` carry
    them whole."""
    docs = random_docs(11)
    for j, t in zip(build(JaxWriter(), JaxMapper(MAPPING), docs, SEG_SIZES),
                    build(SegmentWriter(), DocumentMapper(MAPPING), docs,
                          SEG_SIZES)):
        assert_same_arrays(j, t)
        assert sorted(t.nested) == ["comments"]
        back = segment_from_arrays(*segment_arrays(j))
        for path, block in j.nested.items():
            mine = back.nested[path]
            np.testing.assert_array_equal(mine.obj_to_doc, block.obj_to_doc)
            assert sorted(mine.numeric) == sorted(block.numeric)
            assert sorted(mine.ordinal) == sorted(block.ordinal)
            for child, (terms, ords, objs) in block.ordinal.items():
                assert mine.ordinal[child][0] == list(terms)
                np.testing.assert_array_equal(mine.ordinal[child][1], ords)
                np.testing.assert_array_equal(mine.ordinal[child][2], objs)


def test_staged_blocks_match_reference(corpora):
    """``DeviceSegment.nested_staged`` pads as the reference's: n_obj_pad
    = pad_pow2(n_objs + 1), padding objects at the parent's dead slot,
    padded values at the dead object slot; cached per path; None for a
    path the segment lacks."""
    jax_s, port_s = corpora["random"]
    for jseg, tseg in zip(jax_s.segments, port_s.segments):
        ref = jseg.device().nested_staged("comments")
        dseg = tseg.device("cpu")
        got = dseg.nested_staged("comments")
        assert dseg.nested_staged("comments") is got
        assert got["n_obj_pad"] == ref["n_obj_pad"]
        for name in ("obj_to_doc", "obj_valid"):
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(ref[name]))
        for group in ("numeric", "ordinal"):
            assert sorted(got[group]) == sorted(ref[group])
            for child, col in ref[group].items():
                for name, arr in col.items():
                    mine = got[group][child][name]
                    if name == "v_pad":
                        assert mine == arr
                        continue
                    assert mine.numpy().dtype == np.asarray(arr).dtype
                    np.testing.assert_array_equal(mine.numpy(),
                                                  np.asarray(arr))
        assert dseg.nested_staged("nope") is None
        assert dseg.nested_bytes() > 0


def test_nested_survives_persistence(tmp_path):
    """Flush, close and reopen: the nested blocks round-trip through the
    port's store, and the answer equals the reference engine's."""
    body = {"query": nested(ALICE_5), "size": 10}
    out = []
    for engine_cls, mapper, kw in (
            (JaxEngine, JaxMapper(MAPPING), {}),
            (InternalEngine, DocumentMapper(MAPPING), {"device": "cpu"})):
        path = str(tmp_path / engine_cls.__module__.split(".")[0])
        eng = engine_cls(path, mapper, index_name="nst", **kw)
        for i, d in enumerate(DOCS):
            eng.index(str(i), d)
        eng.refresh()
        eng.flush()
        eng.close()
        eng2 = engine_cls(path, mapper, index_name="nst", **kw)
        resp = eng2.acquire_searcher().search(body)
        eng2.close()
        out.append(resp)
    assert strip_took(out[1]) == strip_took(out[0])
    assert ids(out[1]) == ["0"]
