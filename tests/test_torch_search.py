"""``ShardSearcher.search`` of the PyTorch port (on the CPU, through the
kernels' plain versions) against the JAX package's, on the same state.

One corpus of JSON docs is built with the JAX package's mapper and
``SegmentWriter`` and carried into the port with ``segment_arrays`` /
``segment_from_arrays`` (a search engine's "weights" are its segments);
the port's own writer must build identical arrays from the same docs.
The JAX side runs its device kernels (``HOST_SCORING = False``), as
``tests/test_impacts.py`` does.  BM25 hits, scores and totals compare
byte for byte; k-NN hits within rtol=1e-5, atol=1e-6 (see
``opensearch_tpu_torch/testing/parity.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
from opensearch_tpu.ops import bm25 as jax_bm25
from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
from opensearch_tpu_torch.common import torchenv
from opensearch_tpu_torch.index import codec
from opensearch_tpu_torch.index.segment import (PostingsField, Segment,
                                                SegmentWriter,
                                                segment_arrays,
                                                segment_from_arrays)
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.search.executor import ShardSearcher
from opensearch_tpu_torch.testing.parity import bm25_mismatch, knn_mismatch

DIM = 16
TAGS = ["red", "green", "blue", "gold"]
MAPPING = {"properties": {
    "body": {"type": "text"},
    "tag": {"type": "keyword"},
    "vec": {"type": "knn_vector", "dimension": DIM, "space_type": "l2"},
    "vec_cos": {"type": "knn_vector", "dimension": DIM,
                "space_type": "cosinesimil"},
    "vec_ip": {"type": "knn_vector", "dimension": DIM,
               "space_type": "innerproduct"},
}}
SEG_SIZES = (130, 110)


def json_docs(seed, n):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        words = (rng.zipf(1.4, size=int(rng.integers(4, 30))) - 1) % 60
        vec = rng.standard_normal(DIM).astype(np.float32).tolist()
        doc = {"body": " ".join(f"w{w}" for w in words),
               "tag": TAGS[int(rng.integers(0, len(TAGS)))],
               "vec": vec, "vec_cos": vec, "vec_ip": vec}
        if i % 17 == 5:
            del doc["vec"]                # some docs lack a vector
        docs.append(doc)
    return docs


def build(writer, mapper, docs):
    segs, i = [], 0
    for si, size in enumerate(SEG_SIZES):
        parsed = [mapper.parse(str(i + j), d)
                  for j, d in enumerate(docs[i: i + size])]
        segs.append(writer.build(parsed, f"seg{si}"))
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


@pytest.fixture(params=[3, 17, 92])
def pair(request, monkeypatch):
    """(seed, JAX searcher, port searcher) over the same state, with
    deletes applied."""
    monkeypatch.setattr(jax_bm25, "HOST_SCORING", False)
    seed = request.param
    docs = json_docs(seed, sum(SEG_SIZES))
    jsegs = build(JaxWriter(), JaxMapper(MAPPING), docs)
    rng = np.random.default_rng(seed + 1)
    for seg in jsegs:
        seg.apply_deletes(rng.choice(seg.n_docs, size=7, replace=False))
    tsegs = [segment_from_arrays(*segment_arrays(s)) for s in jsegs]
    for j, t in zip(jsegs, tsegs):
        assert_same_arrays(j, t)
    return (seed, JaxSearcher(jsegs, JaxMapper(MAPPING)),
            ShardSearcher(tsegs, DocumentMapper(MAPPING), device="cpu"))


@pytest.mark.parametrize("seed", [3, 92])
def test_port_writer_builds_the_reference_arrays(seed):
    docs = json_docs(seed, sum(SEG_SIZES))
    for j, t in zip(build(JaxWriter(), JaxMapper(MAPPING), docs),
                    build(SegmentWriter(), DocumentMapper(MAPPING), docs)):
        assert_same_arrays(j, t)


def bm25_bodies(rng):
    w = [f"w{int(x)}" for x in rng.integers(0, 12, size=8)]
    return [
        {"query": {"match": {"body": f"{w[0]} {w[1]} {w[2]}"}}},
        {"query": {"match": {"body": {"query": f"{w[3]} {w[4]}",
                                      "operator": "and"}}}},
        {"query": {"match": {"body": {
            "query": f"{w[0]} {w[5]} {w[6]} {w[7]}",
            "minimum_should_match": 2}}}},
        {"query": {"bool": {"must": [{"match": {"body": f"{w[1]} {w[2]}"}}],
                            "filter": [{"term": {"tag": "blue"}}]}}},
        {"query": {"constant_score": {"filter": {"term": {"tag": "red"}},
                                      "boost": 2.5}}},
        {"query": {"match_all": {}}, "from": 3},
    ]


def test_bm25_search_byte_exact(pair):
    seed, jax_s, port_s = pair
    rng = np.random.default_rng(seed + 2)
    for body in bm25_bodies(rng):
        body = {**body, "size": 25}
        ref, got = jax_s.search(body), port_s.search(body)
        assert ref["hits"]["hits"], body
        assert bm25_mismatch(got, ref) is None, (body, bm25_mismatch(got, ref))


def test_min_score_and_untracked_totals_byte_exact(pair):
    seed, jax_s, port_s = pair
    q = {"match": {"body": "w0 w1 w3"}}
    full = jax_s.search({"query": q, "size": 300})
    scores = [h["_score"] for h in full["hits"]["hits"]]
    cutoff = float(np.median(scores))
    body = {"query": q, "size": 300, "min_score": cutoff}
    ref, got = jax_s.search(body), port_s.search(body)
    assert 0 < ref["hits"]["total"]["value"] < len(scores)
    assert bm25_mismatch(got, ref) is None
    # track_total_hits=false: hits exact; totals may become a lower
    # bound (the k-th-score prune depends on what finished first)
    body = {"query": q, "size": 5, "track_total_hits": False}
    ref, got = jax_s.search(body), port_s.search(body)
    assert [(h["_id"], h["_score"]) for h in got["hits"]["hits"]] == \
        [(h["_id"], h["_score"]) for h in ref["hits"]["hits"]]
    exact = full["hits"]["total"]["value"]
    assert got["hits"]["total"]["value"] <= exact
    if got["hits"]["total"]["relation"] == "eq":
        assert got["hits"]["total"]["value"] == exact


def test_knn_search_within_tolerance(pair):
    seed, jax_s, port_s = pair
    rng = np.random.default_rng(seed + 3)
    for field in ("vec", "vec_cos", "vec_ip"):
        for filt in (None, {"term": {"tag": "green"}}):
            spec = {"vector": rng.standard_normal(DIM).tolist(), "k": 7}
            if filt is not None:
                spec["filter"] = filt
            body = {"query": {"knn": {field: spec}}, "size": 7}
            ref, got = jax_s.search(body), port_s.search(body)
            assert len(ref["hits"]["hits"]) == 7
            assert knn_mismatch(got, ref) is None, \
                (field, filt, knn_mismatch(got, ref))


def test_knn_search_k_beyond_a_segment_within_tolerance(pair):
    """k larger than the smaller segment's padded row count: that
    segment's top-k ends in (-inf, -1) slots, which never reach the
    hits; the merged hits still match the reference."""
    seed, jax_s, port_s = pair
    rng = np.random.default_rng(seed + 5)
    for field in ("vec", "vec_ip"):
        spec = {"vector": rng.standard_normal(DIM).tolist(), "k": 150}
        body = {"query": {"knn": {field: spec}}, "size": 150}
        ref, got = jax_s.search(body), port_s.search(body)
        assert len(ref["hits"]["hits"]) == 150
        assert knn_mismatch(got, ref) is None, (field,
                                                knn_mismatch(got, ref))


def test_knn_search_makes_one_topk_call_for_all_segments(pair,
                                                          monkeypatch):
    """The query compiler hands every segment to one top-k call (one K1
    launch on the card), with the filter as a per-segment mask."""
    from opensearch_tpu_torch.ops import knn as tknn
    _seed, _jax_s, port_s = pair
    calls = []
    real = tknn.knn_topk_segments_auto

    def spy(segments, query, **kw):
        calls.append((len(segments), [s.mask is not None for s in segments],
                      kw))
        return real(segments, query, **kw)

    monkeypatch.setattr(tknn, "knn_topk_segments_auto", spy)
    vec = np.random.default_rng(1).standard_normal(DIM).tolist()
    port_s.search({"query": {"knn": {"vec_cos": {"vector": vec, "k": 5}}}})
    port_s.search({"query": {"knn": {"vec": {
        "vector": vec, "k": 3, "filter": {"term": {"tag": "red"}}}}}})
    assert calls == [
        (len(SEG_SIZES), [False] * len(SEG_SIZES),
         {"space": "cosinesimil", "k": 5}),
        (len(SEG_SIZES), [True] * len(SEG_SIZES), {"space": "l2", "k": 3})]


def test_match_search_makes_one_topk_call_for_all_segments(pair,
                                                           monkeypatch):
    """A scored ``match`` / ``term`` hands every segment to one top-k
    call (one K2 launch on the card) at its ``from + size``; a ``bool``,
    a size above K_MAX and ``track_total_hits: false`` (whose k-th-score
    pruning needs results segment by segment) keep the per-segment
    programs.  Every answer equals the reference's."""
    from opensearch_tpu_torch.ops import bm25 as tbm25
    from opensearch_tpu_torch.ops.cuda_bm25 import K_MAX
    seed, jax_s, port_s = pair
    calls = []
    real = tbm25.term_bag_topk_segments_auto

    def spy(segments, **kw):
        calls.append((len(segments), kw["k"]))
        return real(segments, **kw)

    monkeypatch.setattr(tbm25, "term_bag_topk_segments_auto", spy)
    fused = [{"query": {"match": {"body": "w0 w1 w3"}}, "size": 7},
             {"query": {"match": {"body": "w1 w2"}}, "from": 4, "size": 3},
             {"query": {"match": {"body": {"query": "w0 w2",
                                           "operator": "and"}}}},
             {"query": {"term": {"tag": "blue"}}, "size": 40}]
    for body in fused:
        ref, got = jax_s.search(body), port_s.search(body)
        assert bm25_mismatch(got, ref) is None, body
    assert calls == [(len(SEG_SIZES), 7), (len(SEG_SIZES), 7),
                     (len(SEG_SIZES), 10), (len(SEG_SIZES), 40)]
    calls.clear()
    looped = [{"query": {"bool": {"must": [{"match": {"body": "w0 w1"}}]}}},
              {"query": {"match": {"body": "w0 w1"}}, "size": K_MAX + 1}]
    for body in looped:
        ref, got = jax_s.search(body), port_s.search(body)
        assert bm25_mismatch(got, ref) is None, body
    got = port_s.search({"query": {"match": {"body": "w0 w1"}}, "size": 5,
                         "track_total_hits": False})
    ref = jax_s.search({"query": {"match": {"body": "w0 w1"}}, "size": 5})
    assert [(h["_id"], h["_score"]) for h in got["hits"]["hits"]] == \
        [(h["_id"], h["_score"]) for h in ref["hits"]["hits"]]
    assert calls == []


def test_match_search_with_min_score_skips_segments_before_the_call(
        pair, monkeypatch):
    """The min_score bound skip happens on the host, before the top-k
    call: a segment whose best possible score is below min_score is not
    handed to it, and the answer still equals the reference's."""
    from opensearch_tpu_torch.ops import bm25 as tbm25
    from opensearch_tpu_torch.search import plan as tplan
    _seed, jax_s, port_s = pair
    seen = []
    real = tbm25.term_bag_topk_segments_auto

    def spy(segments, **kw):
        seen.append((len(segments), kw["min_score"]))
        return real(segments, **kw)

    monkeypatch.setattr(tbm25, "term_bag_topk_segments_auto", spy)
    q = {"match": {"body": "w0 w1"}}
    plan, bind = port_s.compiled(q)
    bounds = [plan.max_score_bound(bind, seg) for seg in port_s.segments]
    assert isinstance(plan, tplan.TermBagPlan)
    cut = (min(bounds) + max(bounds)) / 2
    body = {"query": q, "size": 20, "min_score": cut}
    ref, got = jax_s.search(body), port_s.search(body)
    assert bm25_mismatch(got, ref) is None
    kept = sum(b >= cut for b in bounds)
    assert seen == ([(kept, float(np.float32(cut)))] if kept else [])


def test_count_matches_reference(pair):
    _seed, jax_s, port_s = pair
    for q in ({"match": {"body": "w2 w4"}}, {"term": {"tag": "gold"}},
              None):
        assert port_s.count(q) == jax_s.count(q)


@pytest.mark.parametrize("body", [
    {"query": {"match_all": {}}, "aggs": {"t": {"terms": {"field": "tag"}}}},
    {"query": {"match_all": {}}, "sort": [{"tag": "asc"}]},
    {"query": {"match_all": {}}, "highlight": {"fields": {"body": {}}}},
    {"query": {"match_all": {}}, "profile": True},
    {"query": {"match": {"body": {"query": "w1", "fuzziness": 1}}}},
    {"query": {"match_phrase": {"body": "w1 w2"}}},
    {"query": {"range": {"tag": {"gte": "a"}}}},
    {"query": {"term": {"_id": "3"}}},
    {"query": {"hybrid": {"queries": [{"match_all": {}}]}}},
    {"query": {"match_all": {}},
     "suggest": {"s": {"text": "w1", "term": {"field": "body"}}}},
    {"query": {"nested": {"path": "parts",
                          "query": {"match": {"parts.name": "w1"}}}}},
], ids=["aggs", "sort", "highlight", "profile", "fuzziness", "phrase",
        "range", "ids", "hybrid", "suggest", "nested"])
def test_unported_features_raise_typed_error(body, monkeypatch):
    """Every case answers as the JAX package does, byte for byte (hits,
    sort values, highlights and suggestions included): ``range``,
    ``term`` on ``_id``, ``hybrid``, ``aggs``, ``match_phrase``,
    ``sort``, ``highlight``, ``fuzziness``, ``suggest`` and ``nested``,
    and since the Profile API is ported, ``profile``, whose response also
    has the reference's profile keys and segment decisions (this case
    held that it raised ``NotYetPortedError`` while it was not ported).
    The ``nested`` case maps ``parts`` as a nested path and gives the
    docs objects under it."""
    mapping, docs = MAPPING, json_docs(3, sum(SEG_SIZES))
    q = body["query"]
    if "nested" in q:
        mapping = {"properties": {**MAPPING["properties"], "parts": {
            "type": "nested", "properties": {"name": {"type": "keyword"}}}}}
        docs = [dict(d, parts=[{"name": w} for w in d["body"].split()[:3]])
                for d in docs]
    mapper = DocumentMapper(mapping)
    segs = build(SegmentWriter(), mapper, docs)
    searcher = ShardSearcher(segs, mapper, device="cpu")
    monkeypatch.setattr(jax_bm25, "HOST_SCORING", False)
    ref = JaxSearcher(build(JaxWriter(), JaxMapper(mapping), docs),
                      JaxMapper(mapping)).search(body)
    got = searcher.search(body)
    assert ref["hits"]["hits"], body
    assert bm25_mismatch(got, ref) is None, bm25_mismatch(got, ref)
    assert got["hits"] == ref["hits"]
    assert got.get("aggregations") == ref.get("aggregations")
    assert got.get("suggest") == ref.get("suggest")
    if "suggest" in body:
        assert got["suggest"]["s"][0]["text"] == "w1"
    if "profile" in body:
        def shape(resp):
            sec = resp["profile"]["shards"][0]
            query = sec["searches"][0]["query"][0]
            return (sorted(sec), sorted(sec["engine"]), sorted(query),
                    sorted(query["breakdown"]), query["type"],
                    query["description"], sec["engine"]["segments"],
                    [(r["segment"], r["decision"]) for r in sec["segments"]])
        assert shape(got) == shape(ref)


def test_msearch_and_ann_method_raise_typed_error():
    """An ``ann`` method (``ivf``) answers as the JAX package answers on
    the same four-doc segment, through ``search`` and ``msearch``.  (This
    test held that the method raised ``NotYetPortedError`` while ANN was
    not ported, and before that that ``msearch`` raised;
    ``test_msearch_match_all_returns_the_search_response`` checks
    msearch's other bodies.)"""
    mapping = {"properties": {"v": {"type": "knn_vector", "dimension": 2,
                                    "method": {"name": "ivf"}}}}
    docs = [(str(i), {"v": [float(i), 1.0]}) for i in range(4)]
    jmapper = JaxMapper(mapping)
    jseg = JaxWriter().build([jmapper.parse(i, d) for i, d in docs], "s")
    mapper = DocumentMapper(mapping)
    seg = SegmentWriter().build([mapper.parse(i, d) for i, d in docs], "s")
    searcher = ShardSearcher([seg], mapper, device="cpu")
    body = {"query": {"knn": {"v": {"vector": [1.0, 1.0], "k": 2}}}}
    want = JaxSearcher([jseg], jmapper).search(body)
    got = searcher.search(body)
    [batched] = searcher.msearch([body])
    for resp in (got, batched):
        assert [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]] == \
            [(h["_id"], h["_score"]) for h in want["hits"]["hits"]]
        assert resp["hits"]["total"] == want["hits"]["total"]
    assert [h["_id"] for h in got["hits"]["hits"]] == ["1", "0"]


def test_msearch_match_all_returns_the_search_response():
    """A ``match_all`` body, which does not batch, comes back from
    ``msearch`` as ``search`` returns it."""
    mapping = {"properties": {"v": {"type": "knn_vector", "dimension": 2,
                                    "method": {"name": "ivf"}}}}
    mapper = DocumentMapper(mapping)
    seg = SegmentWriter().build(
        [mapper.parse(str(i), {"v": [float(i), 1.0]}) for i in range(4)],
        "s")
    searcher = ShardSearcher([seg], mapper, device="cpu")
    body = {"query": {"match_all": {}}}
    [got] = searcher.msearch([body])
    want = searcher.search(body)
    got.pop("took")
    want.pop("took")
    assert got == want
    assert got["hits"]["total"]["value"] == 4


def quantized_size_segment():
    """A segment of QUANTIZED_MIN_DOCS docs whose ``body`` holds one term,
    ``w1``, in every 1,000th doc."""
    n = codec.QUANTIZED_MIN_DOCS
    seg = Segment("big", n)
    seg.doc_ids = [str(i) for i in range(n)]
    seg.sources = [b"{}"] * n
    docs = np.arange(0, n, 1000, dtype=np.int32)
    seg.postings["body"] = PostingsField(
        terms={"w1": 0}, df=np.array([len(docs)], np.int32),
        offsets=np.array([0, len(docs)], np.int32), doc_ids=docs,
        tfs=np.ones(len(docs), np.float32),
        pos_offsets=np.zeros(len(docs) + 1, np.int32),
        positions=np.zeros(0, np.int32),
        doc_lens=np.full(n, 3.0, np.float32), total_len=3.0 * n,
        docs_with_field=n, has_norms=True, present=np.ones(n, bool))
    return seg, docs


def reference_segment(seg):
    """The JAX package's ``Segment`` holding ``seg``'s docs and postings."""
    from opensearch_tpu.index.segment import PostingsField as JaxPostings
    from opensearch_tpu.index.segment import Segment as JaxSegment

    jseg = JaxSegment(seg.seg_id, seg.n_docs)
    jseg.doc_ids, jseg.sources = seg.doc_ids, seg.sources
    jseg.id_to_local = dict(seg.id_to_local)
    for name, pf in seg.postings.items():
        jseg.postings[name] = JaxPostings(**{
            f.name: getattr(pf, f.name) for f in dataclasses.fields(pf)})
    return jseg


def quantized_size_searchers(monkeypatch):
    """(JAX searcher, port searcher, docs) over ``quantized_size_segment``,
    the JAX side on its device lowering."""
    monkeypatch.setattr(jax_bm25, "HOST_SCORING", False)
    seg, docs = quantized_size_segment()
    mapping = {"properties": {"body": {"type": "text"}}}
    return (JaxSearcher([reference_segment(seg)], JaxMapper(mapping)),
            ShardSearcher([seg], DocumentMapper(mapping), device="cpu"),
            docs)


def test_quantized_size_segment_raises_instead_of_scoring_f32(monkeypatch):
    """The reference lowers segments with >= QUANTIZED_MIN_DOCS docs to
    its quantized kernels; so does the port (no f32 scoring and no
    refusal): scored bags read the quantized tables and answer as the
    reference does."""
    jax_s, searcher, docs = quantized_size_searchers(monkeypatch)
    seg = searcher.segments[0]
    assert codec.use_quantized(seg)
    body = {"query": {"match": {"body": "w1"}}}
    got = searcher.search(body)
    assert bm25_mismatch(got, jax_s.search(body)) is None
    assert got["hits"]["total"]["value"] == len(docs)
    dseg = seg.device("cpu")
    assert dseg.quantized_mode and set(dseg.postings["body"]) == {"offsets"}
    # filter context scores nothing, so it runs as the reference does
    assert searcher.count({"match": {"body": "w1"}}) == len(docs)


@pytest.mark.parametrize("body", [
    {"query": {"match": {"body": "w1"}}},
    {"query": {"term": {"body": "w1"}}, "size": 3},
    {"query": {"match": {"body": "w1"}}, "track_total_hits": False},
    {"query": {"match": {"body": "w1"}}, "size": 300},
], ids=["fused", "term", "untracked-totals", "beyond-k-max"])
def test_quantized_size_segment_raises_on_every_term_bag_route(body,
                                                               monkeypatch):
    """Through the one top-k call and the per-segment programs alike, a
    scored bag on a segment of QUANTIZED_MIN_DOCS docs is answered from
    the quantized tables, byte-equal to the reference (no refusal)."""
    jax_s, searcher, _docs = quantized_size_searchers(monkeypatch)
    got = searcher.search(dict(body))
    assert bm25_mismatch(got, jax_s.search(dict(body))) is None
    assert got["hits"]["hits"]


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(torchenv.DeviceUnavailableError):
        torchenv.default_device()
    with pytest.raises(torchenv.DeviceUnavailableError):
        torchenv.resolve_device("cuda")
    mapper = DocumentMapper(MAPPING)
    segs = build(SegmentWriter(), mapper, json_docs(3, 20))
    with pytest.raises(torchenv.DeviceUnavailableError):
        ShardSearcher(segs, mapper)
    assert torchenv.resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
