"""ANN ``knn`` (a ``knn_vector`` mapped with ``method: ivf | ivf_pq``)
through the port's ``ShardSearcher`` on the CPU against the JAX
package's, on the same segments and the same trained indexes.

Three segments with deletes are built by the JAX package's writer and
carried into the port (``segment_from_arrays``).  The JAX searcher
trains each segment's index on its first ANN query; the test plants
every trained index in the port segment's cache under the same key
(``ops/ivf.py`` ``ivf_index_from_arrays`` / ``ivfpq_index_from_arrays``),
so both packages search one structure.  Cases: ``ivf`` in three
spaces, ``ivf_pq`` in l2 (ADC) and in cosine (the flat layout, retrained
as ``ivf``, as the reference does), a ``method_parameters.nprobe``
override, k above the probed candidates, a ``filter`` (the exact
route), and one ``_search`` over HTTP through the port's node against
the reference's node.  Hits: ids equal in order; scores within rtol
1e-5 / atol 1e-6, and in l2 also within the reference's own float32
error (``tests/test_torch_ivf.py`` ``reference_l2_slack``).
"""

import json
import urllib.request

import numpy as np
import pytest

from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
from opensearch_tpu.node import Node as JaxNode
from opensearch_tpu.ops import bm25 as jax_bm25
from opensearch_tpu.ops.ivf import IvfPqIndex as JaxPq
from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
from opensearch_tpu_torch.index.segment import (segment_arrays,
                                                segment_from_arrays)
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.node import Node
from opensearch_tpu_torch.ops import ivf
from opensearch_tpu_torch.ops.knn import ATOL, RTOL
from opensearch_tpu_torch.search.executor import ShardSearcher
from opensearch_tpu_torch.testing.corpus import clustered_vectors

DIM = 16
NLIST = 8


def method(name, space=None, **params):
    out = {"name": name, "parameters": {"nlist": NLIST, "nprobe": 3,
                                        **params}}
    if space:
        out["space_type"] = space
    return out


MAPPING = {"properties": {
    "tag": {"type": "keyword"},
    "v_l2": {"type": "knn_vector", "dimension": DIM, "space_type": "l2",
             "method": method("ivf")},
    "v_cos": {"type": "knn_vector", "dimension": DIM,
              "method": method("ivf", "cosinesimil")},
    "v_ip": {"type": "knn_vector", "dimension": DIM,
             "space_type": "innerproduct", "method": method("ivf")},
    "v_pq": {"type": "knn_vector", "dimension": DIM, "space_type": "l2",
             "method": method("ivf_pq", m=4)},
    "v_pqcos": {"type": "knn_vector", "dimension": DIM,
                "method": method("ivf_pq", "cosinesimil", m=4)},
}}
FIELDS = ("v_l2", "v_cos", "v_ip", "v_pq", "v_pqcos")
SEG_SIZES = (260, 180, 300)


@pytest.fixture(scope="module")
def corpus():
    vecs = clustered_vectors(sum(SEG_SIZES), DIM, 12, seed=5)
    docs = []
    for i, v in enumerate(vecs):
        doc = {"tag": ("a", "b", "c")[i % 3]}
        if i % 19 != 4:                       # some docs lack the vectors
            doc.update({f: v.tolist() for f in FIELDS})
        docs.append(doc)
    return vecs, docs


@pytest.fixture(scope="module")
def pair(corpus):
    """(JAX searcher, port searcher, vectors) over the same segments."""
    vecs, docs = corpus
    mapper = JaxMapper(MAPPING)
    jsegs, i = [], 0
    for si, size in enumerate(SEG_SIZES):
        jsegs.append(JaxWriter().build(
            [mapper.parse(str(i + j), d)
             for j, d in enumerate(docs[i: i + size])], f"seg{si}"))
        i += size
    rng = np.random.default_rng(1)
    for seg in jsegs:
        seg.apply_deletes(rng.choice(seg.n_docs, size=11, replace=False))
    tsegs = [segment_from_arrays(*segment_arrays(s)) for s in jsegs]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bm25, "HOST_SCORING", False)
        yield (JaxSearcher(jsegs, mapper),
               ShardSearcher(tsegs, DocumentMapper(MAPPING), device="cpu"),
               vecs)


def plant(jax_s, port_s):
    """Every index the JAX segments trained, carried into the port
    segments' caches under the same keys."""
    for jseg, tseg in zip(jax_s.segments, port_s.segments):
        for key, idx in jseg._ann.items():
            if key in tseg._ann:
                continue
            if isinstance(idx, JaxPq):
                tseg._ann[key] = ivf.ivfpq_index_from_arrays(
                    idx.centroids, idx.codebooks, idx.grouped_codes,
                    idx.grouped_ids, idx.grouped_valid)
            else:
                tseg._ann[key] = ivf.ivf_index_from_arrays(
                    idx.centroids, idx.grouped, idx.grouped_ids,
                    idx.grouped_valid)


def l2_slack(vecs, q, hits):
    """``reference_l2_slack`` of each hit (its vector by ``_id``)."""
    out = []
    for h in hits:
        v = vecs[int(h["_id"])].astype(np.float64)
        qd = np.asarray(q, np.float64)
        terms = v @ v + 2 * abs(v @ qd) + qd @ qd
        out.append(h["_score"] ** 2 * 4 * 2.0 ** -23 * terms)
    return out


def assert_same_hits(got, want, slack=None):
    gh, wh = got["hits"]["hits"], want["hits"]["hits"]
    assert got["hits"]["total"] == want["hits"]["total"]
    assert [h["_id"] for h in gh] == [h["_id"] for h in wh]
    slack = slack or [0.0] * len(wh)
    for g, w, s in zip(gh, wh, slack):
        assert abs(g["_score"] - w["_score"]) <= \
            ATOL + RTOL * abs(w["_score"]) + s, (g, w)


def knn_body(field, q, k=10, **extra):
    return {"size": k, "query": {"knn": {field: {
        "vector": [float(x) for x in q], "k": k, **extra}}}}


def query_vectors(vecs, n, seed):
    rng = np.random.default_rng(seed)
    return [vecs[rng.integers(len(vecs))]
            + rng.normal(scale=0.2, size=DIM).astype(np.float32)
            for _ in range(n)]


def check(pair, field, body_of, n=6, seed=3):
    jax_s, port_s, vecs = pair
    for q in query_vectors(vecs, n, seed):
        body = body_of(field, q)
        want = jax_s.search(body)
        plant(jax_s, port_s)
        got = port_s.search(body)
        assert want["hits"]["hits"], body
        space = MAPPING["properties"][field].get("space_type", "cosinesimil")
        slack = l2_slack(vecs, q, want["hits"]["hits"]) \
            if space == "l2" and field != "v_pq" else None
        assert_same_hits(got, want, slack)


@pytest.mark.parametrize("field", FIELDS)
def test_ann_knn_equals_jax(pair, field):
    check(pair, field, knn_body)


@pytest.mark.parametrize("field", ["v_l2", "v_pq"])
def test_ann_nprobe_override_equals_jax(pair, field):
    for nprobe in (1, NLIST):
        check(pair, field, lambda f, q: knn_body(
            f, q, method_parameters={"nprobe": nprobe}), seed=nprobe)


@pytest.mark.parametrize("field", ["v_cos", "v_pq"])
def test_ann_k_above_the_probed_candidates_equals_jax(pair, field):
    """nprobe 1 probes one cluster a segment: fewer rows than k."""
    jax_s, port_s, vecs = pair
    check(pair, field, lambda f, q: knn_body(
        f, q, k=120, method_parameters={"nprobe": 1}), n=3)
    body = knn_body(field, vecs[0], k=120, method_parameters={"nprobe": 1})
    assert len(port_s.search(body)["hits"]["hits"]) < 120


def test_ann_with_a_filter_takes_the_exact_route(pair, monkeypatch):
    jax_s, port_s, vecs = pair
    calls = []
    monkeypatch.setattr(ivf, "ivf_search_segments_auto",
                        lambda *a, **kw: calls.append(a))
    for q in query_vectors(vecs, 4, seed=8):
        body = knn_body("v_l2", q, filter={"term": {"tag": "b"}})
        got, want = port_s.search(body), jax_s.search(body)
        assert_same_hits(got, want, l2_slack(vecs, q, want["hits"]["hits"]))
        assert {int(h["_id"]) % 3 for h in got["hits"]["hits"]} == {1}
    assert calls == []


def test_ann_searches_one_call_a_route_for_every_segment(pair, monkeypatch):
    """One flat (K6) call over the three segments for a cosine ivf_pq
    field; one PQ (K7) call for the l2 one."""
    jax_s, port_s, vecs = pair
    seen = []
    for name in ("ivf_search_segments_auto", "ivfpq_search_segments_auto"):
        real = getattr(ivf, name)

        def spy(segs, *a, _real=real, _name=name, **kw):
            seen.append((_name, len(segs)))
            return _real(segs, *a, **kw)

        monkeypatch.setattr(ivf, name, spy)
    q = vecs[10]
    jax_s.search(knn_body("v_pqcos", q))
    jax_s.search(knn_body("v_pq", q))
    plant(jax_s, port_s)
    port_s.search(knn_body("v_pqcos", q))
    port_s.search(knn_body("v_pq", q))
    assert seen == [("ivf_search_segments_auto", 3),
                    ("ivfpq_search_segments_auto", 3)]


def http(node, method_, path, body=None, ndjson=None):
    data, headers = None, {"Content-Type": "application/json"}
    if ndjson is not None:
        data = ("\n".join(json.dumps(x) for x in ndjson) + "\n").encode()
        headers["Content-Type"] = "application/x-ndjson"
    elif body is not None:
        data = json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{node.port}{path}", data=data, method=method_,
        headers=headers)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_ann_search_over_http_equals_the_reference_node(tmp_path,
                                                        monkeypatch):
    """An ``ann`` index (cosine ``ivf``, nprobe = nlist: every cluster
    probed) fed by ``_bulk``: the port's node answers ``_search`` as the
    reference's node does (each trains its own index)."""
    monkeypatch.setattr(jax_bm25, "HOST_SCORING", False)
    vecs = clustered_vectors(400, DIM, 10, seed=9)
    mapping = {"mappings": {"properties": {"v": {
        "type": "knn_vector", "dimension": DIM,
        "method": {"name": "ivf", "space_type": "cosinesimil",
                   "parameters": {"nlist": 6, "nprobe": 6}}}}}}
    bulk = []
    for i, v in enumerate(vecs):
        bulk += [{"index": {"_index": "ann", "_id": str(i)}},
                 {"v": v.tolist()}]
    body = knn_body("v", vecs[5] * 0.7 + vecs[6] * 0.3, k=10)
    answers = []
    for cls, kw in ((JaxNode, {}), (Node, {"device": "cpu"})):
        node = cls(str(tmp_path / cls.__module__), port=0, **kw).start()
        try:
            assert http(node, "PUT", "/ann", mapping)[0] == 200
            status, out = http(node, "POST", "/_bulk?refresh=true",
                               ndjson=bulk)
            assert status == 200 and not out["errors"]
            status, resp = http(node, "POST", "/ann/_search", body)
            assert status == 200
            answers.append(resp)
        finally:
            node.stop()
    want, got = answers
    assert len(got["hits"]["hits"]) == 10
    assert [h["_id"] for h in got["hits"]["hits"]] == \
        [h["_id"] for h in want["hits"]["hits"]]
    for g, w in zip(got["hits"]["hits"], want["hits"]["hits"]):
        assert abs(g["_score"] - w["_score"]) <= ATOL + RTOL * w["_score"]
