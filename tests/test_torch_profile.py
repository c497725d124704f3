"""The Profile API of the PyTorch port (``search/profile.py`` and its
probes in the executor, the batch and the continuous batcher) against
the JAX package, on the CPU.

Case for case from ``tests/test_profile.py`` (shape, cache attribution,
min_score pruning, byte-identical hits sequential and msearch-batched,
field sort) and ``tests/test_canmatch_profile.py`` (can-match decisions,
the profile's query section).  The reference scores on its device path
(``HOST_SCORING = False``, as ``tests/test_impacts.py`` runs it): the
port has no host scoring, so the reference's ``host_scoring=True`` case
is the one ``device`` case here.  Hits compare byte for byte; profiles by
their keys, segment decisions and ``describe`` strings, never their
times.  Beyond the reference's cases: the continuous batcher's ``queue``
phase, the ``describe`` strings of ``match``, ``term``, ``bool`` and
``knn``, ``xla_compiles`` (hand-kernel libraries built during a
request; 0 when warm), the segment records' sum, and ``_search`` /
``_msearch`` with ``profile`` over HTTP on one index and several.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
from opensearch_tpu.node import Node as JaxNode
from opensearch_tpu.ops import bm25 as jax_bm25
from opensearch_tpu.search.compiler import compile_query as jax_compile
from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
from opensearch_tpu.search.query_dsl import parse_query as jax_parse
from opensearch_tpu_torch.index.segment import SegmentWriter
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.node import Node
from opensearch_tpu_torch.search import engine as engine_mod
from opensearch_tpu_torch.search import profile as profile_mod
from opensearch_tpu_torch.search.compiler import compile_query
from opensearch_tpu_torch.search.executor import ShardSearcher
from opensearch_tpu_torch.search.profile import describe_plan
from opensearch_tpu_torch.search.query_dsl import parse_query
from opensearch_tpu_torch.testing.parity import profile_shape

PHASES = ("rewrite", "plan_cache", "compile", "prepare", "can_match",
          "dispatch", "reduce", "fetch")
DECISIONS = ("pruned_can_match", "pruned_min_score", "pruned_kth")


@pytest.fixture(autouse=True)
def _device_path(monkeypatch):
    monkeypatch.setattr(jax_bm25, "HOST_SCORING", False)


def zipf_docs(n_docs=60, vocab=40, seed=3):
    rng = np.random.default_rng(seed)
    return [{"body": " ".join(
        f"w{int(t)}" for t in (rng.zipf(1.4, size=12) - 1).clip(0, vocab))}
        for _ in range(n_docs)]


def build_pair(docs=None, seg_sizes=(20, 20, 20), mapping=None,
               index="profix"):
    """The reference's ``build_searcher``: a JAX searcher and a port
    searcher (on the CPU) over the same segments."""
    docs = zipf_docs() if docs is None else docs
    mapping = mapping or {"properties": {"body": {"type": "text"}}}
    out = []
    for mapper_cls, writer_cls, searcher_cls, kw in (
            (JaxMapper, JaxWriter, JaxSearcher, {}),
            (DocumentMapper, SegmentWriter, ShardSearcher,
             {"device": "cpu"})):
        mapper = mapper_cls(mapping)
        writer = writer_cls()
        segs, i = [], 0
        for si, size in enumerate(seg_sizes):
            batch = [mapper.parse(str(i + j), d)
                     for j, d in enumerate(docs[i: i + size])]
            segs.append(writer.build(batch, f"p{si}"))
            i += size
        out.append(searcher_cls(segs, mapper, index_name=index, **kw))
    return tuple(out)


Q = {"query": {"match": {"body": "w1 w2"}}, "size": 5}


def hits_bytes(resp) -> bytes:
    return json.dumps(resp["hits"], sort_keys=True).encode()


def section(resp) -> dict:
    return resp["profile"]["shards"][0]


def check_invariants(resp, total_segments):
    """The reference's invariants: the phase keys, the sections' sums,
    phases within ``took`` + 1 ms, scanned + pruned + not_reached =
    total, one record per scanned or pruned segment."""
    sec = section(resp)
    search = sec["searches"][0]
    query = search["query"][0]
    bd = query["breakdown"]
    for p in PHASES + ("queue",):
        assert p in bd and f"{p}_count" in bd, p
        assert bd[p] >= 0
    assert search["rewrite_time"] == bd["rewrite"]
    assert query["time_in_nanos"] == sum(
        bd[p] for p in ("rewrite", "plan_cache", "compile", "prepare",
                        "can_match", "dispatch"))
    assert search["collector"][0]["time_in_nanos"] == bd["reduce"]
    assert sum(bd[p] for p in PHASES + ("queue",)) <= \
        (resp["took"] + 1) * 1_000_000
    segsum = sec["engine"]["segments"]
    assert segsum["total"] == total_segments
    assert segsum["scanned"] + sum(segsum[k] for k in DECISIONS) \
        + segsum["not_reached"] == segsum["total"]
    assert len(sec.get("segments", ())) == segsum["scanned"] + sum(
        segsum[k] for k in DECISIONS)
    # the scanned segments' shares sum to the dispatch phase
    scanned_ns = sum(r["time_in_nanos"] for r in sec.get("segments", ())
                     if r["decision"] == "scanned")
    assert abs(scanned_ns - bd["dispatch"]) <= len(sec.get("segments",
                                                           ())) + 1


# -- tests/test_profile.py: response shape ---------------------------------

def test_breakdown_shape_and_consistency():
    jax_s, port_s = build_pair()
    ref = jax_s.search(dict(Q, profile=True))
    got = port_s.search(dict(Q, profile=True))
    assert len(got["profile"]["shards"]) == 1
    assert section(got)["id"] == "[profix][0]"
    check_invariants(got, 3)
    assert hits_bytes(got) == hits_bytes(ref)
    assert profile_shape(got) == profile_shape(ref)


def test_cache_attribution_hit_on_repeat():
    jax_s, port_s = build_pair()
    for s in (jax_s, port_s):
        first = s.search(dict(Q, profile=True))
        second = s.search(dict(Q, profile=True))
        e1, e2 = section(first)["engine"], section(second)["engine"]
        assert e1["plan_cache"] == "miss" and e2["plan_cache"] == "hit"
        bd2 = section(second)["searches"][0]["query"][0]["breakdown"]
        assert bd2["rewrite"] == 0 and bd2["compile"] == 0
        assert e1["request_cache"] == "bypass"
        assert e1["execution_path"] == "device"
        assert e1["query_type"] == "MatchQuery"
        assert e1["prepared_misses"] == 3 and e2["prepared_hits"] == 3


def test_min_score_pruning_attribution():
    jax_s, port_s = build_pair()
    body = {"query": {"match": {"body": "w1"}}, "min_score": 1e6,
            "profile": True, "size": 5}
    ref, got = jax_s.search(dict(body)), port_s.search(dict(body))
    segsum = section(got)["engine"]["segments"]
    assert segsum["pruned_min_score"] + segsum["pruned_can_match"] > 0
    assert got["hits"]["total"]["value"] == 0
    assert profile_shape(got) == profile_shape(ref)
    check_invariants(got, 3)


# -- byte-identical hits ----------------------------------------------------

@pytest.mark.parametrize("path", ["device"])
def test_hits_byte_identical_sequential(path):
    """The reference's ``host_scoring`` True / False cases: the port has
    no host scoring, so this is its one case, the device path (the
    reference on its device path too)."""
    jax_s, port_s = build_pair()
    plain = port_s.search(dict(Q))
    profiled = port_s.search(dict(Q, profile=True))
    assert hits_bytes(plain) == hits_bytes(profiled)
    assert hits_bytes(plain) == hits_bytes(jax_s.search(dict(Q)))
    assert "profile" not in plain
    assert section(profiled)["engine"]["execution_path"] == path


def test_hits_byte_identical_msearch_batched():
    jax_s, port_s = build_pair()
    bodies = [dict(Q), {"query": {"match": {"body": "w3"}}, "size": 5},
              {"query": {"match": {"body": "w1"}}, "size": 4}]
    profiled = port_s.msearch([dict(b, profile=True) for b in bodies])
    plain = port_s.msearch([dict(b) for b in bodies])
    ref = jax_s.msearch([dict(b, profile=True) for b in bodies])
    for p, pr, r in zip(plain, profiled, ref):
        assert hits_bytes(p) == hits_bytes(pr) == hits_bytes(r)
        assert "profile" in pr and "profile" not in p
        assert profile_shape(pr) == profile_shape(r)
    groups = [section(r)["engine"]["batch"] for r in profiled]
    assert groups[0] == groups[1]
    assert groups[0]["queries"] == 2
    assert sorted(groups[0]["positions"]) == [0, 1]
    assert groups[2]["queries"] == 1 and groups[2]["positions"] == [2]
    assert groups == [section(r)["engine"]["batch"] for r in ref]
    engine = section(profiled[0])["engine"]
    assert engine["execution_path"] == "device_batched"
    assert engine["plan_cache"] == "batched"
    assert engine["batch_prep_cache"] == "miss"
    again = port_s.msearch([dict(b, profile=True) for b in bodies])
    assert section(again[0])["engine"]["batch_prep_cache"] == "hit"
    for r in profiled:
        check_invariants(r, 3)


def test_field_sorted_profile_consistent():
    jax_s, port_s = build_pair()
    body = {"query": {"match": {"body": "w1"}},
            "sort": [{"_doc": "asc"}], "size": 5}
    plain = port_s.search(dict(body))
    profiled = port_s.search(dict(body, profile=True))
    assert hits_bytes(plain) == hits_bytes(profiled)
    assert hits_bytes(plain) == hits_bytes(jax_s.search(dict(body)))
    assert profile_shape(profiled) == profile_shape(
        jax_s.search(dict(body, profile=True)))
    check_invariants(profiled, 3)


@pytest.mark.parametrize("body", [
    {"query": {"match": {"body": "w1 w5"}}, "track_total_hits": False,
     "size": 3},
    {"query": {"bool": {"must": [{"match": {"body": "w1"}}],
                        "should": [{"match": {"body": "w2"}}]}},
     "size": 4},
    {"query": {"match": {"body": "w1"}}, "size": 0},
    {"query": {"match": {"body": "w2"}}, "size": 3,
     "aggs": {"f": {"filter": {"match": {"body": "w3"}}}}},
    {"query": {"match": {"body": "w2 w7"}}, "size": 300},
], ids=["kth", "bool", "size0", "aggs", "deep"])
def test_other_paths_profile_like_the_reference(body):
    """The per-segment program path (``track_total_hits: false``), the
    plan path, counts only, the aggs views and a page past K_MAX: the
    same hits, keys and segment decisions as the reference's."""
    jax_s, port_s = build_pair()
    ref = jax_s.search(dict(body, profile=True))
    got = port_s.search(dict(body, profile=True))
    plain = port_s.search(dict(body))
    assert hits_bytes(got) == hits_bytes(ref) == hits_bytes(plain)
    assert profile_shape(got) == profile_shape(ref)
    check_invariants(got, 3)


# -- describe strings -------------------------------------------------------

VEC_MAPPING = {"properties": {"body": {"type": "text"},
                              "tag": {"type": "keyword"},
                              "v": {"type": "knn_vector", "dimension": 3}}}


@pytest.mark.parametrize("query", [
    {"match": {"body": "w1 w2 w3"}},
    {"match": {"body": {"query": "w1 w2", "operator": "and"}}},
    {"term": {"tag": "t1"}},
    {"bool": {"must": [{"match": {"body": "w1"}}],
              "filter": [{"term": {"tag": "t2"}}],
              "should": [{"match": {"body": "w2"}}]}},
    {"knn": {"v": {"vector": [0.1, 0.2, 0.3], "k": 3}}},
], ids=["match", "match_and", "term", "bool", "knn"])
def test_describe_equals_the_reference(query):
    """``Plan.describe`` prints the port's plan as the reference prints
    its own: the plans of these four queries have the reference's fields
    (no plan of the port holds a tensor in a field; a tensor in a bind's
    ``terms`` / ``values`` would print as its values)."""
    rng = np.random.default_rng(5)
    docs = [{"body": d["body"], "tag": f"t{i % 3}",
             "v": [float(x) for x in rng.normal(size=3)]}
            for i, d in enumerate(zipf_docs(30, seed=9))]
    jax_s, port_s = build_pair(docs, (15, 15), VEC_MAPPING)
    rp, rb = jax_compile(jax_parse(query), jax_s.ctx)
    pp, pb = compile_query(parse_query(query), port_s.ctx)
    assert describe_plan(pp, pb) == describe_plan(rp, rb)
    body = {"query": query, "profile": True, "size": 3}
    ref, got = jax_s.search(dict(body)), port_s.search(dict(body))
    assert got["hits"]["total"] == ref["hits"]["total"]
    assert profile_shape(got) == profile_shape(ref)


def test_xla_compiles_counts_libraries_built_in_the_request(monkeypatch):
    """``xla_compiles`` is the delta of the hand-kernel libraries loaded
    (``ops/cuda_build.py``) over the request: 0 on a warm request, the
    count of libraries a cold one built."""
    from opensearch_tpu_torch.ops import cuda_build
    _jax_s, port_s = build_pair()
    warm = port_s.search(dict(Q, profile=True))
    assert section(warm)["engine"]["xla_compiles"] == 0
    real = port_s.compiled

    def compiled(*args, **kw):
        cuda_build._libs[("fake", ())] = object()   # a library built now
        return real(*args, **kw)

    monkeypatch.setattr(port_s, "compiled", compiled)
    try:
        cold = port_s.search(dict(Q, profile=True))
    finally:
        cuda_build._libs.pop(("fake", ()), None)
    assert section(cold)["engine"]["xla_compiles"] == 1
    assert profile_mod.xla_program_count() == len(cuda_build._libs)


# -- tests/test_canmatch_profile.py ------------------------------------------

CM_MAPPING = {"properties": {"t": {"type": "text"}, "ts": {"type": "long"}}}


def build_cm():
    docs = [{"t": f"seg{si} common word{si}_{i}", "ts": si * 1000 + i}
            for si in range(4) for i in range(10)]
    return build_pair(docs, (10, 10, 10, 10), CM_MAPPING, index="cm")


def test_can_match_range_prunes_segments():
    jax_s, port_s = build_cm()
    q = {"range": {"ts": {"gte": 2000, "lt": 3000}}}
    plan, bind = compile_query(parse_query(q), port_s.ctx, scored=False)
    assert [plan.can_match(bind, seg) for seg in port_s.segments] == \
        [False, False, True, False]
    body = {"query": q, "size": 50, "profile": True}
    got, ref = port_s.search(dict(body)), jax_s.search(dict(body))
    assert got["hits"]["total"]["value"] == 10
    assert all(h["_id"].startswith("2") for h in got["hits"]["hits"])
    assert hits_bytes(got) == hits_bytes(ref)
    assert profile_shape(got) == profile_shape(ref)


@pytest.mark.parametrize("query,want", [
    ({"match": {"t": "seg1"}}, [False, True, False, False]),
    ({"match": {"t": {"query": "seg0 seg1", "operator": "and"}}},
     [False, False, False, False]),
    ({"bool": {"must": [{"match": {"t": "common"}}],
               "filter": [{"range": {"ts": {"gte": 3000}}}]}},
     [False, False, False, True]),
    ({"match_phrase": {"t": "seg2 common"}}, [False, False, True, False]),
], ids=["term", "and", "bool_filter", "phrase"])
def test_can_match_terms_and_phrase(query, want):
    jax_s, port_s = build_cm()
    plan, bind = compile_query(parse_query(query), port_s.ctx)
    assert [plan.can_match(bind, seg) for seg in port_s.segments] == want
    body = {"query": query, "profile": True, "size": 20}
    got, ref = port_s.search(dict(body)), jax_s.search(dict(body))
    assert hits_bytes(got) == hits_bytes(ref)
    assert profile_shape(got) == profile_shape(ref)
    decisions = [r["decision"] == "scanned"
                 for r in section(got).get("segments", ())]
    assert decisions.count(True) == sum(want)


def test_profile_response_shape():
    jax_s, port_s = build_cm()
    body = {"query": {"match": {"t": "common"}}, "profile": True}
    q = section(port_s.search(dict(body)))["searches"][0]["query"][0]
    assert q["type"] == "TermBagPlan"
    assert q["time_in_nanos"] > 0
    assert "common" in q["description"]
    ref = section(jax_s.search(dict(body)))["searches"][0]["query"][0]
    assert (q["type"], q["description"]) == (ref["type"],
                                             ref["description"])


# -- the continuous batcher -------------------------------------------------

def test_continuous_batch_members_get_the_group_profile_and_a_queue(
        monkeypatch):
    """Concurrent profiled searches coalesce into one group: each member
    has the group's ``batch`` block (``continuous: true``), its own
    ``queue`` phase and the group's segment decisions, and hits equal to
    the sequential path's."""
    _jax_s, port_s = build_pair()
    monkeypatch.setattr(engine_mod, "BATCHER_WINDOW_MS", 200.0)
    batcher = engine_mod.ContinuousBatcher()
    bodies = [{"query": {"match": {"body": f"w{i} w{i + 1}"}}, "size": 5,
               "profile": True} for i in range(6)]
    for b in bodies:                  # the plans are cached first
        port_s.search({k: v for k, v in b.items() if k != "profile"})
    out = [None] * len(bodies)
    barrier = threading.Barrier(len(bodies))

    def run(i):
        barrier.wait()
        out[i] = batcher.execute(port_s, bodies[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert batcher.dispatches >= 1 and batcher.batched >= 2
    batched = 0
    for b, resp in zip(bodies, out):
        assert hits_bytes(resp) == hits_bytes(port_s.search(
            {k: v for k, v in b.items() if k != "profile"}))
        engine = section(resp)["engine"]
        check_invariants(resp, 3)
        if "batch" in engine:
            batched += 1
            assert engine["batch"]["continuous"] is True
            assert engine["execution_path"] == "device_batched"
            bd = section(resp)["searches"][0]["query"][0]["breakdown"]
            assert bd["queue_count"] == 1
    assert batched == batcher.batched


# -- over HTTP: one index and several -----------------------------------------

@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bm25, "HOST_SCORING", False)
        ref = JaxNode(str(tmp_path_factory.mktemp("ref")), port=0).start()
        port = Node(str(tmp_path_factory.mktemp("port")), port=0,
                    device="cpu").start()
        try:
            yield ref, port
        finally:
            ref.stop()
            port.stop()


def call(node, method, path, body=None, ndjson=None):
    data, headers = None, {"Content-Type": "application/json"}
    if ndjson is not None:
        data = ("\n".join(json.dumps(line) for line in ndjson)
                + "\n").encode()
        headers["Content-Type"] = "application/x-ndjson"
    elif body is not None:
        data = json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{node.port}{path}",
                                 data=data, method=method, headers=headers)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_profile_over_http_one_index_and_several(nodes):
    """``_search`` and ``_msearch`` with ``profile: true`` answer 200 on
    both nodes with equal hits and profiles of the same shape; across two
    indices the shard sections concatenate and the ``coordinator`` block
    counts the sources."""
    mapping = {"mappings": {"properties": {"body": {"type": "text"}}}}
    lines = []
    for index, seed in (("pa", 1), ("pb", 2)):
        for n in nodes:
            call(n, "PUT", f"/{index}", mapping)
        for i, d in enumerate(zipf_docs(30, seed=seed)):
            lines += [{"index": {"_index": index, "_id": str(i)}}, d]
    for n in nodes:
        call(n, "POST", "/_bulk?refresh=true", ndjson=lines)
    body = dict(Q, profile=True)
    for path in ("/pa/_search", "/pa,pb/_search"):
        (rs, ref), (ps, got) = (call(n, "POST", path, body) for n in nodes)
        assert rs == ps == 200
        assert ref["hits"] == got["hits"]
        assert profile_shape(ref, False) == profile_shape(got, False)
    assert got["profile"]["coordinator"]["sources"] == 2
    assert len(got["profile"]["shards"]) == 2
    ms = [{"index": "pa"}, body, {"index": "pa,pb"}, body,
          {"index": "pb"}, {"query": {"match": {"body": "w3"}}, "size": 3}]
    (rs, ref), (ps, got) = (call(n, "POST", "/_msearch", ndjson=ms)
                            for n in nodes)
    assert rs == ps == 200
    for a, b in zip(ref["responses"], got["responses"]):
        assert a["hits"] == b["hits"]
        if "profile" in a:
            assert profile_shape(a, False) == profile_shape(b, False)
        else:
            assert "profile" not in b
