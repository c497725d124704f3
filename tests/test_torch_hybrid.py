"""The hybrid query, search pipelines and request timeouts of the PyTorch
port against the JAX package, on the CPU.

- ``search/pipeline.py``: ``normalize_scores`` and ``combine_scores``
  equal the reference's exactly; ``NormalizationConfig`` refuses what the
  reference refuses; ``SearchPipelineService`` reads the reference's
  persisted pipelines.
- ``ShardSearcher.search`` of ``hybrid`` queries, with the default
  processor and with ``_hybrid_pipeline`` configs, ``from`` / ``size`` /
  ``_source``, a ``timeout`` that does not expire and one that expires
  at once (a partial result with ``timed_out: true``), and the
  reference's 400 for ``sort``, ``aggs``, ``min_score`` and
  ``search_after``: responses equal byte for byte once ``took`` is
  stripped; hybrids with a ``knn`` sub-query: ids equal and scores
  within rtol 1e-5 / atol 1e-6.
- ``timeout`` on plain searches (term bags, filters, counts).
- Both nodes over HTTP: the four ``/_search/pipeline`` routes, a missing
  pipeline's 404, a refused pipeline's 400, and ``hybrid`` searches with
  and without ``?search_pipeline=``.
"""

import json
import math

import numpy as np
import pytest

from opensearch_tpu.common.errors import OpenSearchTpuError as JaxError
from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
from opensearch_tpu.node import Node as JaxNode
from opensearch_tpu.ops import bm25 as jbm25
from opensearch_tpu.search import pipeline as jpipe
from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
from opensearch_tpu_torch.common.errors import OpenSearchTpuError
from opensearch_tpu_torch.index.segment import (segment_arrays,
                                                segment_from_arrays)
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.node import Node
from opensearch_tpu_torch.search import pipeline as tpipe
from opensearch_tpu_torch.search.executor import (SearchDeadline,
                                                  ShardSearcher)
from opensearch_tpu_torch.testing.parity import knn_mismatch
from test_torch_rest import both as http_both
from test_torch_rest import call as http_call

DIM = 8
MAPPING = {"properties": {
    "body": {"type": "text"},
    "tag": {"type": "keyword"},
    "price": {"type": "long"},
    "vec": {"type": "knn_vector", "dimension": DIM, "space_type": "l2"},
}}
SEG_SIZES = (120, 80)
CONFS = [
    None,
    {"normalization": {"technique": "min_max"},
     "combination": {"technique": "arithmetic_mean",
                     "parameters": {"weights": [0.3, 0.7]}}},
    {"normalization": {"technique": "l2"},
     "combination": {"technique": "geometric_mean"}},
    {"normalization": {"technique": "min_max"},
     "combination": {"technique": "harmonic_mean",
                     "parameters": {"weights": [2, 1]}}},
]


def hybrid_docs(seed, n):
    rng = np.random.default_rng(seed)
    return [{"body": " ".join(f"w{int(w) % 30}" for w in
                              rng.zipf(1.4, size=int(rng.integers(3, 20)))),
             "tag": ["a", "b", "c", "d"][int(rng.integers(0, 4))],
             "price": int(rng.integers(0, 1000)),
             "vec": rng.normal(size=DIM).astype(np.float32).tolist()}
            for _ in range(n)]


@pytest.fixture(scope="module", params=[5, 55])
def pair(request):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbm25, "HOST_SCORING", False)
        docs = hybrid_docs(request.param, sum(SEG_SIZES))
        mapper, writer = JaxMapper(MAPPING), JaxWriter()
        jsegs, i = [], 0
        for si, size in enumerate(SEG_SIZES):
            jsegs.append(writer.build([mapper.parse(str(i + j), d) for j, d
                                       in enumerate(docs[i: i + size])],
                                      f"h{si}"))
            i += size
        jsegs[0].apply_deletes([1, 4, 9])
        tsegs = [segment_from_arrays(*segment_arrays(s)) for s in jsegs]
        yield (JaxSearcher(jsegs, mapper),
               ShardSearcher(tsegs, DocumentMapper(MAPPING), device="cpu"))


def strip_took(resp):
    resp = json.loads(json.dumps(resp))
    resp.pop("took", None)
    return resp


# -- the normalization processor -----------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_normalize_and_combine_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    for scores in (rng.random(7).astype(np.float64) * 10,
                   np.full(4, 2.5), np.zeros(3), np.zeros(0),
                   rng.normal(size=9)):
        for tech in ("min_max", "l2"):
            ref = jpipe.normalize_scores(scores.copy(), tech)
            got = tpipe.normalize_scores(scores.copy(), tech)
            assert np.asarray(got).tobytes() == np.asarray(ref).tobytes()
    for _ in range(20):
        per = rng.random(3).tolist()
        per[int(rng.integers(0, 3))] = 0.0
        w = (rng.random(3) + 0.1).tolist()
        for tech in ("arithmetic_mean", "geometric_mean", "harmonic_mean"):
            assert tpipe.combine_scores(per, w, tech) == \
                jpipe.combine_scores(per, w, tech)
    for tech in ("geometric_mean", "harmonic_mean"):
        assert tpipe.combine_scores([0.0, 0.0], [1, 1], tech) == 0.0
    for bad in (lambda m: m.normalize_scores(np.ones(2), "z_score"),
                lambda m: m.combine_scores([1.0], [1.0], "median")):
        with pytest.raises(JaxError) as ref:
            bad(jpipe)
        with pytest.raises(OpenSearchTpuError) as got:
            bad(tpipe)
        assert (type(got.value).__name__, str(got.value)) == \
            (type(ref.value).__name__, str(ref.value))


@pytest.mark.parametrize("body", [
    {"normalization": {"technique": "rrf"}},
    {"combination": {"technique": "max"}},
    {"combination": {"parameters": {"weights": [-1, 2]}}},
    {"combination": {"parameters": {"weights": "0.5"}}},
    {"combination": {"parameters": {"weights": [0, 0]}}},
])
def test_normalization_config_refuses_as_the_reference(body):
    with pytest.raises(JaxError) as ref:
        jpipe.NormalizationConfig(body)
    with pytest.raises(OpenSearchTpuError) as got:
        tpipe.NormalizationConfig(body)
    assert (type(got.value).__name__, str(got.value), got.value.status) == \
        (type(ref.value).__name__, str(ref.value), ref.value.status)


def test_pipeline_service_reads_the_reference_file(tmp_path):
    body = {"description": "d", "phase_results_processors": [
        {"normalization-processor": CONFS[1]}]}
    ref = jpipe.SearchPipelineService(str(tmp_path))
    assert ref.put("p", body) == {"acknowledged": True}
    port = tpipe.SearchPipelineService(str(tmp_path))
    assert port.get() == ref.get() and port.hybrid_conf("p") == CONFS[1]
    assert port.delete("p") == {"acknowledged": True}
    assert jpipe.SearchPipelineService(str(tmp_path)).get() == {}
    with pytest.raises(tpipe.PipelineMissingError) as exc:
        port.get("p")
    assert exc.value.status == 404


# -- hybrid searches -----------------------------------------------------------

def hybrid(*queries, **extra):
    return {"query": {"hybrid": {"queries": list(queries)}}, **extra}


BM25_HYBRIDS = [
    hybrid({"match": {"body": "w1 w2"}}, {"term": {"tag": "b"}}),
    hybrid({"match": {"body": "w0 w3 w5"}}, {"range": {"price": {
        "gte": 200, "lt": 600}}}, size=25),
    hybrid({"match": {"body": "w4"}}, {"match": {"body": "w1 w7"}},
           size=5, **{"from": 3}),
    hybrid({"match": {"body": "w2"}}, {"bool": {
        "must": [{"match": {"body": "w6"}}],
        "filter": [{"terms": {"tag": ["a", "c"]}}]}}, _source=False),
    hybrid({"match": {"body": "w1"}}, {"match": {"body": "w3"}},
           timeout="30s"),
    hybrid({"match": {"body": "nope"}}, {"match_none": {}}),
]


def test_bm25_hybrids_equal_the_reference(pair):
    jax_s, port_s = pair
    for conf in CONFS:
        for body in BM25_HYBRIDS:
            body = dict(body)
            if conf is not None:
                body["_hybrid_pipeline"] = conf
            ref, got = jax_s.search(dict(body)), port_s.search(dict(body))
            assert strip_took(got) == strip_took(ref), body
            assert ref["hits"]["hits"] or body["query"]["hybrid"][
                "queries"][0] == {"match": {"body": "nope"}}


def test_knn_hybrids_within_tolerance(pair):
    jax_s, port_s = pair
    rng = np.random.default_rng(9)
    for conf in (CONFS[1], None):
        for _ in range(4):
            vec = rng.normal(size=DIM).astype(np.float32).tolist()
            body = hybrid({"match": {"body": "w1 w2"}},
                          {"knn": {"vec": {"vector": vec, "k": 10}}},
                          size=10)
            if conf is not None:
                body["_hybrid_pipeline"] = conf
            ref, got = jax_s.search(dict(body)), port_s.search(dict(body))
            assert [h["_id"] for h in got["hits"]["hits"]] == \
                [h["_id"] for h in ref["hits"]["hits"]]
            assert knn_mismatch(got, ref) is None, knn_mismatch(got, ref)
            assert math.isclose(got["hits"]["max_score"],
                                ref["hits"]["max_score"], rel_tol=1e-5,
                                abs_tol=1e-6)


def test_expired_timeout_returns_the_partial_result(pair):
    jax_s, port_s = pair
    for body in (hybrid({"match": {"body": "w1"}}, {"term": {"tag": "a"}},
                        timeout="0ms"),
                 {"query": {"match": {"body": "w1 w2"}}, "timeout": "0ms"},
                 {"query": {"range": {"price": {"gte": 10}}},
                  "timeout": "0s", "size": 0},
                 {"query": {"bool": {"must": [{"match": {"body": "w1"}}],
                                     "filter": [{"exists": {
                                         "field": "price"}}]}},
                  "timeout": "0ms"}):
        ref, got = jax_s.search(dict(body)), port_s.search(dict(body))
        assert got["timed_out"] is True
        assert strip_took(got) == strip_took(ref), body
    for body in ({"query": {"match": {"body": "w1 w2"}}, "timeout": "1m"},
                 {"query": {"term": {"tag": "c"}}, "timeout": "-1",
                  "size": 50}):
        ref, got = jax_s.search(dict(body)), port_s.search(dict(body))
        assert got["timed_out"] is False and got["hits"]["hits"]
        assert strip_took(got) == strip_took(ref), body


def test_search_deadline():
    assert not SearchDeadline(None).expired()
    assert not SearchDeadline("-1").expired()
    assert SearchDeadline("0ms").expired()
    d = SearchDeadline("10m")
    assert not d.expired() and not d.timed_out
    d = SearchDeadline("1ms", t0=0.0)
    assert d.expired() and d.timed_out


@pytest.mark.parametrize("extra", [
    {"sort": [{"price": "asc"}]}, {"aggs": {"t": {"terms": {"field": "tag"}}}},
    {"min_score": 0.5}, {"search_after": [1]}])
def test_hybrid_refusals_answer_the_reference_400(pair, extra):
    jax_s, port_s = pair
    body = hybrid({"match": {"body": "w1"}}, {"term": {"tag": "a"}}, **extra)
    with pytest.raises(JaxError) as ref:
        jax_s.search(dict(body))
    with pytest.raises(OpenSearchTpuError) as got:
        port_s.search(dict(body))
    assert (type(got.value).__name__, str(got.value), got.value.status) == \
        (type(ref.value).__name__, str(ref.value), 400)


def test_nested_hybrid_is_refused_as_the_reference(pair):
    jax_s, port_s = pair
    body = {"query": {"bool": {"must": [
        {"hybrid": {"queries": [{"match_all": {}}]}}]}}}
    with pytest.raises(JaxError) as ref:
        jax_s.search(dict(body))
    with pytest.raises(OpenSearchTpuError) as got:
        port_s.search(dict(body))
    assert (str(got.value), got.value.status) == \
        (str(ref.value), ref.value.status)


def test_msearch_serves_hybrids_and_timeouts_sequentially(pair):
    jax_s, port_s = pair
    bodies = [BM25_HYBRIDS[0], {"query": {"match": {"body": "w1"}},
                                "timeout": "30s"},
              {"query": {"match": {"body": "w2 w3"}}}]
    got = port_s.msearch([dict(b) for b in bodies])
    for b, g in zip(bodies, got):
        assert strip_took(g) == strip_took(jax_s.search(dict(b)))


# -- both nodes over HTTP ------------------------------------------------------

@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbm25, "HOST_SCORING", False)
        ref = JaxNode(str(tmp_path_factory.mktemp("href")), port=0).start()
        port = Node(str(tmp_path_factory.mktemp("hport")), port=0,
                    device="cpu").start()
        try:
            yield ref, port
        finally:
            ref.stop()
            port.stop()


def test_pipeline_routes_equal_the_reference_node(nodes):
    pipe = {"description": "hybrid", "phase_results_processors": [
        {"normalization-processor": CONFS[1]}]}
    assert http_both(nodes, "GET", "/_search/pipeline") == (200, {})
    assert http_both(nodes, "PUT", "/_search/pipeline/p", pipe)[0] == 200
    assert http_both(nodes, "PUT", "/_search/pipeline/q", {
        "phase_results_processors": [{"normalization-processor": CONFS[2]}]
    })[0] == 200
    status, got = http_both(nodes, "GET", "/_search/pipeline")
    assert status == 200 and set(got) == {"p", "q"}
    assert http_both(nodes, "GET", "/_search/pipeline/p") == \
        (200, {"p": pipe})
    assert http_both(nodes, "DELETE", "/_search/pipeline/q")[0] == 200
    assert http_both(nodes, "GET", "/_search/pipeline/q")[0] == 404
    assert http_both(nodes, "DELETE", "/_search/pipeline/q")[0] == 404
    for bad in ({"phase_results_processors": [{"rerank": {}}]},
                {"phase_results_processors": [{"normalization-processor": {
                    "normalization": {"technique": "z"}}}]}):
        assert http_both(nodes, "PUT", "/_search/pipeline/bad", bad)[0] \
            == 400


def test_hybrid_over_http_equal_the_reference_node(nodes):
    http_both(nodes, "PUT", "/hyb", {"settings": {"number_of_shards": 2},
                                     "mappings": MAPPING})
    lines = []
    for i, doc in enumerate(hybrid_docs(8, 150)):
        lines += [{"index": {"_index": "hyb", "_id": str(i)}}, doc]
    status, resp = http_both(nodes, "POST", "/_bulk?refresh=true",
                             ndjson=lines)
    assert status == 200 and not resp["errors"]
    http_both(nodes, "PUT", "/_search/pipeline/w37", {
        "phase_results_processors": [{"normalization-processor": CONFS[1]}]})
    for body in BM25_HYBRIDS[:4]:
        for path in ("/hyb/_search", "/hyb/_search?search_pipeline=w37"):
            status, resp = http_both(nodes, "POST", path, body)
            assert status == 200, (path, body, resp)
    assert http_both(nodes, "POST", "/hyb/_search?search_pipeline=none",
                     BM25_HYBRIDS[0])[0] == 404
    assert http_both(nodes, "POST", "/hyb/_search", dict(
        BM25_HYBRIDS[0], sort=[{"price": "asc"}]))[0] == 400
    status, resp = http_both(nodes, "POST", "/hyb/_search", {
        "query": {"match": {"body": "w1"}}, "timeout": "30s"})
    assert status == 200 and resp["timed_out"] is False


def test_knn_hybrids_over_http_after_vectors_arrive_by_update(nodes):
    """A text index of 2 shards gains a ``vec`` field by ``PUT _mapping``
    and vectors on a third of its docs by ``_bulk`` ``update``; hybrids
    of a ``match`` and a ``knn`` by ``?search_pipeline=`` then answer as
    the reference node does (ids equal, scores within rtol 1e-5 /
    atol 1e-6)."""
    text = {"properties": {k: v for k, v in MAPPING["properties"].items()
                           if k != "vec"}}
    http_both(nodes, "PUT", "/late", {"settings": {"number_of_shards": 2},
                                      "mappings": text})
    docs = hybrid_docs(12, 160)
    lines = []
    for i, doc in enumerate(docs):
        lines += [{"index": {"_index": "late", "_id": str(i)}},
                  {k: v for k, v in doc.items() if k != "vec"}]
    assert not http_both(nodes, "POST", "/_bulk?refresh=true",
                         ndjson=lines)[1]["errors"]
    http_both(nodes, "PUT", "/late/_mapping",
              {"properties": {"vec": MAPPING["properties"]["vec"]}})
    lines = []
    for i in range(0, len(docs), 3):
        lines += [{"update": {"_index": "late", "_id": str(i)}},
                  {"doc": {"vec": docs[i]["vec"]}}]
    assert not http_both(nodes, "POST", "/_bulk?refresh=true",
                         ndjson=lines)[1]["errors"]
    http_both(nodes, "PUT", "/_search/pipeline/late", {
        "phase_results_processors": [{"normalization-processor": CONFS[1]}]})
    rng = np.random.default_rng(13)
    for path in ("/late/_search?search_pipeline=late", "/late/_search"):
        for _ in range(3):
            body = hybrid({"match": {"body": "w1 w2"}}, {"knn": {"vec": {
                "vector": rng.normal(size=DIM).astype(np.float32).tolist(),
                "k": 10}}}, size=10)
            (rs, ref), (gs, got) = (http_call(n, "POST", path, body)
                                    for n in nodes)
            assert rs == gs == 200, (ref, got)
            assert ref["hits"]["hits"]
            assert [h["_id"] for h in got["hits"]["hits"]] == \
                [h["_id"] for h in ref["hits"]["hits"]]
            assert knn_mismatch(got, ref) is None, knn_mismatch(got, ref)
