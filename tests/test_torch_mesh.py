"""The mesh of the PyTorch port (``opensearch_tpu_torch/parallel/
dist_search.py``, ``ops/mesh.py``, the service's ``_mesh_search``,
``common/device_health.py``) against the JAX package's, on the CPU.

The JAX side runs on its 8 virtual CPU devices (``tests/conftest.py``);
the port on a mesh of ``[cpu] * S``.  Segments are built by the JAX
package's writer from a seeded corpus and carried across with
``segment_arrays`` / ``segment_from_arrays``; some shards hold two
segments, so the segment-major tie order is exercised.

- ``MeshSearcher.search`` over 8 and 4 shards on the reference's
  ``tests/test_dist_search.py`` queries: ids, ``_score`` bits,
  ``_shard``, totals and ``max_score`` equal to the reference's host
  scatter (which ``tests/test_dist_search.py`` holds equal to its mesh),
  and to the reference's MeshSearcher on two of them; a ``knn``: ids and
  ``_shard`` equal, scores within the port's k-NN tolerance (K1 sums in
  float64, the reference in float32); the empty and unmatched cases.
- ``mesh_merge_plain`` / ``sharded_topk_merge`` against ``lax.top_k`` on
  random sorted rows with ties and ``-inf`` padding: the indices equal.
- ``prepare_match_query`` + ``sharded_impact_topk``: scores and global
  ids equal, a term missing on some shards included.
- ``mesh_metric_aggs`` for ``sum``, ``avg``, ``min``, ``max``,
  ``value_count`` and ``stats`` on a long and a double field against the
  reference's searcher over every segment (the service's case below
  holds ``stats`` on the double to the reference's mesh): the long
  equal, the double's sums within rtol 1e-12 (K5 sums a segment
  pairwise, the reference in order).
- The service (``search.mesh: true``, 4 shards, ``torch.cuda.
  device_count`` patched to 8): hits, a ``size: 0`` metric agg, a
  ``terms`` agg with hits and a ``suggest`` equal the JAX service's mesh
  path.  ``_mesh_degrade`` in three cases (a mesh that cannot be built,
  an open ``mesh`` breaker, a device error in the collective), each
  counted and equal to the host scatter; a non-device error propagates,
  and so does a hand kernel's failed launch (``cuda_build.check``'s
  ``KernelLaunchError``: no host merge answers for K10 or K5); a refresh
  keeps the service's mesh and its new docs answer at once, and a
  request holds to the shard snapshots it took.
- ``is_device_error`` on torch's device faults and on what is not one.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
from jax import lax

from opensearch_tpu.common import device_health as jhealth
from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
from opensearch_tpu.indices import service as jsvc
from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
from opensearch_tpu.ops import bm25 as jbm25
from opensearch_tpu.parallel import dist_search as jds
from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
from opensearch_tpu.search.executor import merge_hit_rows as jmerge_hit_rows
from opensearch_tpu_torch.common import breakers as tbreakers
from opensearch_tpu_torch.common import errors as terrors
from opensearch_tpu_torch.common.device_health import (device_health,
                                                       is_device_error)
from opensearch_tpu_torch.common.telemetry import metrics
from opensearch_tpu_torch.index.segment import (segment_arrays,
                                                segment_from_arrays)
from opensearch_tpu_torch.indices import service as tsvc
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.ops import cuda_build
from opensearch_tpu_torch.ops.mesh import mesh_merge_plain
from opensearch_tpu_torch.parallel import dist_search as tds
from opensearch_tpu_torch.search.executor import ShardSearcher
from opensearch_tpu_torch.testing.parity import knn_mismatch

RTOL = 1e-12
VOCAB = ("alpha bravo charlie delta echo foxtrot golf hotel india juliet "
         "kilo lima").split()
MAPPING = {"properties": {
    "body": {"type": "text"}, "n": {"type": "long"},
    "p": {"type": "double"}, "tag": {"type": "keyword"},
    "vec": {"type": "knn_vector", "dimension": 4}}}

# tests/test_dist_search.py QUERIES, and a knn
QUERIES = [
    {"query": {"match": {"body": "alpha echo"}}, "size": 10},
    {"query": {"bool": {
        "must": [{"match": {"body": "alpha"}}],
        "filter": [{"range": {"n": {"gte": 20, "lte": 80}}}]}},
     "size": 15},
    {"query": {"bool": {
        "should": [{"match": {"body": "delta"}},
                   {"term": {"tag": "b"}}]}}, "size": 10, "from": 5},
    {"query": {"range": {"n": {"gte": 90}}}, "size": 20},
    {"query": {"constant_score": {
        "filter": {"term": {"tag": "a"}}, "boost": 2.0}}, "size": 10},
    {"query": {"knn": {"vec": {"vector": [0.5, -0.25, 1.0, 0.125],
                               "k": 12}}}, "size": 12},
]
QUERY_IDS = ["match", "bool_filter", "bool_should_from", "range",
             "constant_score", "knn"]


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    """The reference scores on its device path; breakers and counters
    start and end fresh."""
    monkeypatch.setattr(jbm25, "HOST_SCORING", False)
    device_health().reset()
    jhealth.device_health().reset()
    yield
    device_health().reset()
    jhealth.device_health().reset()


def shard_segments(n_shards: int, per: int, seed: int) -> list:
    """Per shard a list of JAX-built segments of ``per`` docs each (odd
    shards hold two), from a seeded corpus; ``p`` a double, ``vec``
    4-d."""
    rng = np.random.default_rng(seed)
    mapper = JaxMapper(MAPPING)
    writer = JaxWriter()
    shards, doc_no = [], 0
    for si in range(n_shards):
        segs = []
        for gi in range(1 + si % 2):
            parsed = []
            for _ in range(per):
                src = {"body": " ".join(rng.choice(
                           VOCAB, size=rng.integers(3, 12))),
                       "n": int(rng.integers(0, 100)),
                       "p": float(np.round(rng.normal(50.0, 30.0), 3)),
                       "tag": str(rng.choice(["a", "b", "c"])),
                       "vec": [float(x) for x in
                               np.round(rng.normal(size=4), 2)]}
                d = mapper.parse(str(doc_no), src)
                d.seq_no = doc_no
                parsed.append(d)
                doc_no += 1
            segs.append(writer.build(parsed, f"s{si}_seg{gi}"))
        shards.append(segs)
    return shards


def searcher_pair(shards: list) -> tuple:
    """(JAX shard searchers, port shard searchers on the CPU) over the
    same segments."""
    jm, tm = JaxMapper(MAPPING), DocumentMapper(MAPPING)
    js = [JaxSearcher(segs, jm, index_name="mesh_idx", shard_id=i)
          for i, segs in enumerate(shards)]
    ts = [ShardSearcher([segment_from_arrays(*segment_arrays(s))
                         for s in segs], tm, index_name="mesh_idx",
                        shard_id=i, device="cpu")
          for i, segs in enumerate(shards)]
    return js, ts


@pytest.fixture(scope="module")
def meshes():
    """{n_shards: (JAX shard searchers, JAX MeshSearcher, port
    MeshSearcher)} for 8 and 4 shards."""
    out = {}
    for n in (8, 4):
        js, ts = searcher_pair(shard_segments(n, 40, seed=3))
        out[n] = (js, jds.MeshSearcher(js),
                  tds.MeshSearcher(ts, [torch.device("cpu")] * n))
    return out


def reference_scatter(searchers, body) -> dict:
    """The reference's host scatter-gather over its shard searchers: each
    shard's top ``from + size``, merged in the coordinator's order
    (``merge_hit_rows``), each hit marked with its ``_shard`` as the
    mesh marks it.  ``tests/test_dist_search.py`` holds the reference's
    MeshSearcher equal to it; it costs the JAX package one program a
    shape, where its mesh compiles on every virtual device."""
    size, from_ = int(body.get("size", 10)), int(body.get("from", 0))
    sub = dict(body, size=from_ + size)
    sub["from"] = 0
    rows, total, max_score = [], 0, None
    for si, searcher in enumerate(searchers):
        r = searcher.search(sub)
        total += r["hits"]["total"]["value"]
        if r["hits"]["max_score"] is not None:
            max_score = max(max_score or -np.inf, r["hits"]["max_score"])
        rows += [(dict(h, _shard=si), si, pos)
                 for pos, h in enumerate(r["hits"]["hits"])]
    hits = jmerge_hit_rows(rows, None)[from_: from_ + size]
    return {"hits": {"total": {"value": total, "relation": "eq"},
                     "max_score": max_score if size or from_ else None,
                     "hits": hits}}


def strip_took(resp: dict) -> dict:
    return {k: v for k, v in resp.items() if k != "took"}


def score_bits(resp: dict) -> list:
    return [np.float32(h["_score"]).tobytes() for h in resp["hits"]["hits"]]


def same_hits(got: dict, ref: dict, body: dict) -> None:
    """Equal hits, totals and max_score (the ``_score`` bits too); a
    ``knn``'s scores within the port's k-NN tolerance instead (K1 sums in
    float64 and rounds once, the reference in float32), its hits in the
    same order."""
    if "knn" in body["query"]:
        assert knn_mismatch(got, ref) is None, knn_mismatch(got, ref)
        assert [(h["_id"], h["_shard"]) for h in got["hits"]["hits"]] == \
            [(h["_id"], h["_shard"]) for h in ref["hits"]["hits"]]
        return
    assert score_bits(got) == score_bits(ref)
    assert got["hits"] == ref["hits"]


@pytest.mark.parametrize("n_shards", [8, 4])
@pytest.mark.parametrize("body", QUERIES, ids=QUERY_IDS)
def test_mesh_search_equals_the_reference(meshes, n_shards, body):
    js, _ref_mesh, port_mesh = meshes[n_shards]
    got = port_mesh.search(body)
    assert got["hits"]["hits"], body
    assert got["_shards"] == {"total": n_shards, "successful": n_shards,
                              "skipped": 0, "failed": 0}
    same_hits(got, reference_scatter(js, body), body)


@pytest.mark.parametrize("body", [QUERIES[0], QUERIES[5]],
                         ids=["match", "knn"])
def test_mesh_search_equals_the_reference_mesh(meshes, body):
    _js, ref_mesh, port_mesh = meshes[4]
    ref, got = ref_mesh.search(body), port_mesh.search(body)
    same_hits(got, ref, body)
    assert strip_took(got)["_shards"] == strip_took(ref)["_shards"]


def test_mesh_search_empty_and_unmatched(meshes):
    js, _ref_mesh, port_mesh = meshes[4]
    for body in ({"query": {"match": {"body": "zzznope"}}},
                 {"query": {"match_all": {}}, "size": 0},
                 {"query": {"match": {"body": "alpha"}}, "size": 0}):
        got = port_mesh.search(body)
        assert got["hits"] == reference_scatter(js, body)["hits"], body
        assert got["hits"]["hits"] == [] and \
            got["hits"]["max_score"] is None
    got = port_mesh.search({"query": {"match": {"body": "zzznope"}}})
    assert got["hits"]["total"] == {"value": 0, "relation": "eq"}
    # a mesh whose shards hold no segment answers empty
    empty = tds.MeshSearcher(
        [ShardSearcher([], DocumentMapper(MAPPING), device="cpu")] * 2,
        [torch.device("cpu")] * 2)
    assert empty.search({"query": {"match_all": {}}})["hits"] == {
        "total": {"value": 0, "relation": "eq"}, "max_score": None,
        "hits": []}


def sorted_rows(rng, n_rows: int, w: int) -> np.ndarray:
    """Rows sorted descending, drawn from few values (ties within and
    across rows), each padded with a random run of -inf."""
    vals = rng.choice(np.float32([3.5, 2.0, 1.25, 1.0, 0.5, 0.0, -1.0]),
                      size=(n_rows, w))
    vals = -np.sort(-vals, axis=1)
    for r in range(n_rows):
        pad = int(rng.integers(0, w + 1))
        if pad:
            vals[r, w - pad:] = -np.inf
    return vals.astype(np.float32)


@pytest.mark.parametrize("n_rows,w,k", [(8, 10, 10), (4, 16, 40),
                                        (5, 7, 35), (1, 12, 5),
                                        (8, 3, 1)])
def test_mesh_merge_equals_lax_top_k(n_rows, w, k):
    rng = np.random.default_rng(n_rows * 100 + w * 10 + k)
    for _ in range(5):
        rows = sorted_rows(rng, n_rows, w)
        ref_v, ref_i = lax.top_k(jax.numpy.asarray(rows.reshape(-1)), k)
        got_v, got_i = mesh_merge_plain(torch.from_numpy(rows), k)
        assert got_i.tolist() == np.asarray(ref_i).tolist()
        assert got_v.numpy().tobytes() == np.asarray(ref_v).tobytes()
        merge = tds.sharded_topk_merge([torch.device("cpu")] * n_rows, k)
        per_shard = [torch.from_numpy(r) for r in rows]
        got_v2, got_i2 = merge(per_shard)
        assert got_i2.tolist() == got_i.tolist()
        assert got_v2.numpy().tobytes() == got_v.numpy().tobytes()


@pytest.mark.parametrize("terms,k", [(["alpha", "echo"], 10),
                                     (["juliet"], 5), (["lima", "zzz"], 7)])
def test_sharded_impact_topk_equals_the_reference(terms, k):
    shards = shard_segments(8, 12, seed=9)
    jsegs = [segs[0] for segs in shards]
    tsegs = [segment_from_arrays(*segment_arrays(s)) for s in jsegs]
    stacked, meta = jds.prepare_match_query(jsegs, "body", terms)
    tstacked, tmeta = tds.prepare_match_query(tsegs, "body", terms)
    assert tmeta == meta
    for key in stacked:
        assert tstacked[key].tobytes() == stacked[key].tobytes(), key
    mesh = jds.make_mesh(8)
    on_mesh = jds.put_on_mesh(stacked, mesh)
    names = ("offsets", "doc_ids", "impacts", "tids", "active", "idfs",
             "weights")
    ref_v, ref_g = jds.sharded_impact_topk(
        mesh, n_pad=meta["n_pad"], budget=meta["budget"], k=k)(
        *(on_mesh[n] for n in names))
    devices = tds.make_mesh(8, "cpu")
    ton = tds.put_on_mesh(tstacked, devices)
    got_v, got_g = tds.sharded_impact_topk(
        devices, n_pad=tmeta["n_pad"], budget=tmeta["budget"], k=k)(
        *(ton[n] for n in names))
    assert got_v.numpy().tobytes() == np.asarray(ref_v).tobytes()
    assert got_g.tolist() == np.asarray(ref_g).tolist()


METRIC_AGGS = {f"{f}_{kind}": {kind: {"field": f}}
               for f in ("n", "p") for kind in ("sum", "avg", "min", "max",
                                                "value_count", "stats")}
DOUBLE_AGGS = {name for name in METRIC_AGGS if name.startswith("p_")}


def close_aggs(got: dict, ref: dict, doubles: set) -> None:
    """Aggs equal, but the sums and averages of the aggs named in
    ``doubles`` (over a double field) within rtol 1e-12; counts, min and
    max equal."""
    assert list(got) == list(ref)
    for name, want in ref.items():
        assert list(got[name]) == list(want), name
        for key, value in want.items():
            have = got[name][key]
            if name in doubles and key in ("value", "sum", "avg") \
                    and value is not None:
                assert math.isclose(have, value, rel_tol=RTOL), (name, key)
            else:
                assert have == value, (name, key, have, value)


@pytest.mark.parametrize("query", [{"match": {"body": "alpha"}},
                                   {"range": {"n": {"gte": 150}}}],
                         ids=["match", "nothing"])
def test_mesh_metric_aggs_equal_the_reference(meshes, query):
    """Every metric kind on a long and a double field, against the
    reference's searcher over every segment (a metric does not depend on
    scoring statistics; the reference's own test holds its mesh to it)."""
    js, _ref_mesh, port_mesh = meshes[4]
    assert port_mesh.supports_mesh_aggs(METRIC_AGGS)
    body = {"size": 0, "query": query}
    everything = JaxSearcher([s for j in js for s in j.segments],
                             js[0].mapper)
    ref = everything.search({**body, "aggs": METRIC_AGGS})
    got = port_mesh.mesh_metric_aggs(body, METRIC_AGGS)
    assert got["hits"] == ref["hits"]
    close_aggs(got["aggregations"], ref["aggregations"], DOUBLE_AGGS)


@pytest.mark.parametrize("aggs", [
    {"t": {"terms": {"field": "n"}}},
    {"s": {"sum": {"field": "n"}, "aggs": {"x": {"max": {"field": "n"}}}}},
    {"s": {"sum": {"field": "tag"}}},
    {"s": {"sum": {}}},
    {"s": "sum"}], ids=["bucket", "sub_agg", "keyword", "no_field",
                        "not_object"])
def test_supports_mesh_aggs_refuses_as_the_reference(meshes, aggs):
    _js, ref_mesh, port_mesh = meshes[4]
    assert port_mesh.supports_mesh_aggs(aggs) is \
        ref_mesh.supports_mesh_aggs(aggs) is False


# -- the service --------------------------------------------------------------

SERVICE_MAPPING = {"properties": {
    "title": {"type": "text"}, "tag": {"type": "keyword"},
    "n": {"type": "long"}, "p": {"type": "double"}}}
WORDS = [f"w{i}" for i in range(12)] + ["quick", "brown", "fox"]


def service_ops(seed: int = 17, n: int = 160) -> list:
    rng = np.random.default_rng(seed)
    return [("index", f"d{i}", {
        "title": " ".join(rng.choice(WORDS, size=rng.integers(2, 8))),
        "tag": str(rng.choice(["red", "green", "blue"])),
        "n": int(rng.integers(0, 1000)),
        "p": float(np.round(rng.uniform(-5, 5), 4))}, {})
        for i in range(n)]


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    """(the JAX service, the port's) for an index of 4 shards with
    ``search.mesh: true``, fed the same docs (one segment a shard)."""
    root = tmp_path_factory.mktemp("mesh_services")
    ref_reg = jsvc.IndicesService(str(root / "jax"))
    port_reg = tsvc.IndicesService(str(root / "torch"), device="cpu")
    body = {"settings": {"number_of_shards": 4, "search.mesh": True},
            "mappings": SERVICE_MAPPING}
    ref = ref_reg.create("idx", {**body})
    port = port_reg.create("idx", {**body})
    ops = service_ops()
    ref.bulk(ops), port.bulk(ops)
    ref.refresh(), port.refresh()
    yield ref, port
    ref_reg.close(), port_reg.close()


@pytest.fixture
def eight_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)


SERVICE_BODIES = [
    {"query": {"match": {"title": "w1 w2 quick"}}, "size": 15},
    {"query": {"bool": {"must": [{"match": {"title": "w3"}}],
                        "filter": [{"range": {"n": {"lt": 600}}}]}},
     "size": 5, "from": 3},
    {"size": 0, "query": {"match": {"title": "w4"}},
     "aggs": {"s": {"stats": {"field": "p"}}}},
    {"query": {"match": {"title": "w5"}}, "size": 4,
     "aggs": {"t": {"terms": {"field": "tag"}}}},
    {"query": {"match": {"title": "fox"}}, "size": 3,
     "suggest": {"fix": {"text": "quikc brwn", "term": {"field": "title"}}}},
]


@pytest.mark.parametrize("body", SERVICE_BODIES,
                         ids=["hits", "bool_page", "metric_aggs",
                              "terms_with_hits", "suggest"])
def test_service_mesh_equals_the_reference(services, eight_cards, body):
    ref, port = services
    assert port._use_mesh(body) and ref._use_mesh(body)
    fb = metrics().counter("search.mesh.fallback").value
    want, got = ref.search(dict(body)), port.search(dict(body))
    assert metrics().counter("search.mesh.fallback").value == fb
    assert score_bits(got) == score_bits(want)
    if "s" in want.get("aggregations", {}):
        close_aggs(got["aggregations"], want["aggregations"], {"s"})
        want, got = strip_took(want), strip_took(got)
        want.pop("aggregations"), got.pop("aggregations")
    assert strip_took(got) == strip_took(want)


def without_shard(resp: dict) -> dict:
    """A response without ``took`` and the mesh-only per-hit ``_shard``."""
    out = strip_took(resp)
    out["hits"] = dict(resp["hits"], hits=[
        {k: v for k, v in h.items() if k != "_shard"}
        for h in resp["hits"]["hits"]])
    out.pop("_shards", None)
    return out


def _lose_the_mesh(monkeypatch):
    def refuse(n, device=None):
        raise ValueError(f"a mesh of {n} devices needs {n} CUDA cards, "
                         "1 visible")
    monkeypatch.setattr(tds, "make_mesh", refuse)


def _open_the_breaker(monkeypatch):
    health = device_health()
    health.set_failure_threshold(1)
    health.record_failure("mesh", RuntimeError("CUDA error: lost"))


def _fail_in_the_collective(monkeypatch):
    def oom(self, body=None, shards=None):
        raise torch.OutOfMemoryError("CUDA out of memory (mesh)")
    monkeypatch.setattr(tds.MeshSearcher, "search", oom)


@pytest.mark.parametrize("fault", [_lose_the_mesh, _open_the_breaker,
                                   _fail_in_the_collective],
                         ids=["mesh_cannot_build", "breaker_open",
                              "device_error"])
def test_mesh_degrades_to_the_counted_host_scatter(services, eight_cards,
                                                   monkeypatch, fault):
    _ref, port = services
    body = {"query": {"match": {"title": "w1 w7"}}, "size": 12}
    want = port._host_scatter_search(dict(body))
    mesh = port._mesh_search(dict(body))
    assert without_shard(mesh) == without_shard(want)
    port._mesh_searcher = None          # rebuilt by the next request
    fault(monkeypatch)
    health = device_health()
    fb = metrics().counter("search.mesh.fallback").value
    errors = metrics().counter("device.errors").value
    failures = health.stats()["breakers"]["mesh"]["failures"]
    got = port.search(dict(body))
    assert metrics().counter("search.mesh.fallback").value == fb + 1
    assert strip_took(got)["hits"] == strip_took(want)["hits"]
    assert all("_shard" not in h for h in got["hits"]["hits"])
    if fault is _open_the_breaker:
        assert health.breaker_states()["mesh"] == "open"
        assert health.stats()["breakers"]["mesh"]["failures"] == failures
    else:
        assert health.stats()["breakers"]["mesh"]["failures"] == \
            failures + 1
        assert metrics().counter("device.errors").value == errors + 1


def test_non_device_error_in_the_collective_propagates(services,
                                                       eight_cards,
                                                       monkeypatch):
    _ref, port = services

    def broken(self, body=None, shards=None):
        raise ValueError("a fault of the query, not of the device")
    monkeypatch.setattr(tds.MeshSearcher, "search", broken)
    fb = metrics().counter("search.mesh.fallback").value
    with pytest.raises(ValueError):
        port.search({"query": {"match": {"title": "w2"}}})
    assert metrics().counter("search.mesh.fallback").value == fb
    assert device_health().stats()["breakers"]["mesh"]["failures"] == 0


def _failed_launch(what: str):
    """A wrapper whose kernel does not launch: ``cuda_build.check`` on a
    launch that returned CUDA error 209."""
    lib = SimpleNamespace(error_string=lambda rc: b"no kernel image is "
                          b"available for execution on the device")

    def launch(*_args, **_kwargs):
        cuda_build.check(lib, 209, what)
    return launch


@pytest.mark.parametrize("kernel", ["mesh_merge", "bucket_collect"])
def test_kernel_launch_error_in_the_collective_propagates(services,
                                                          eight_cards,
                                                          monkeypatch,
                                                          kernel):
    """K10 (the merge) or K5 (the metric partials) failing to launch
    raises out of the mesh: neither the host scatter's merge nor its
    partials answer for a kernel that does not run."""
    _ref, port = services
    if kernel == "mesh_merge":
        monkeypatch.setattr(tds, "mesh_merge",
                            _failed_launch("mesh_merge_launch"))
        body = {"query": {"match": {"title": "w2 w5"}}, "size": 6}
    else:
        monkeypatch.setattr(tds.agg_ops, "bucket_collect",
                            _failed_launch("agg_launch"))
        # a body of its own: the request cache answers one seen before
        body = {"size": 0, "query": {"match": {"title": "w3 w6"}},
                "aggs": {"s": {"stats": {"field": "p"}}}}
    health = device_health()
    fb = metrics().counter("search.mesh.fallback").value
    failures = health.stats()["breakers"]["mesh"]["failures"]
    with pytest.raises(cuda_build.KernelLaunchError, match="CUDA error 209"):
        port.search(dict(body))
    assert metrics().counter("search.mesh.fallback").value == fb
    assert health.stats()["breakers"]["mesh"]["failures"] == failures


def test_a_request_keeps_its_shard_snapshots(tmp_path, eight_cards):
    """``search`` and ``mesh_metric_aggs`` run over the snapshots they
    are handed (the service's request takes them once), whatever
    ``update_shards`` swapped in since."""
    reg = tsvc.IndicesService(str(tmp_path), device="cpu")
    idx = reg.create("idx", {"settings": {"number_of_shards": 2,
                                          "search.mesh": True},
                             "mappings": SERVICE_MAPPING})
    ops = service_ops(seed=6, n=40)
    idx.bulk(ops[:20])
    idx.refresh()
    body = {"query": {"match": {"title": "w1 fox"}}, "size": 20}
    aggs = {"s": {"stats": {"field": "p"}}}
    first = idx.search(dict(body))
    first_aggs = idx.search({"size": 0, "aggs": aggs})
    mesh = idx._mesh_searcher
    old = list(mesh.shards)
    idx.bulk(ops[20:])
    idx.refresh()
    newer = idx.search(dict(body))
    assert idx._mesh_searcher is mesh and mesh.shards != old
    assert newer["hits"]["total"]["value"] > first["hits"]["total"]["value"]
    assert without_shard(mesh.search(dict(body), old)) == \
        without_shard(first)
    got = mesh.mesh_metric_aggs({"size": 0}, aggs, old)
    assert got["hits"]["total"] == first_aggs["hits"]["total"]
    assert got["aggregations"] == first_aggs["aggregations"]
    reg.close()


def test_mesh_survives_a_refresh(tmp_path, eight_cards):
    """The service keeps its mesh across a refresh (``update_shards``
    swaps the shard snapshots), the new docs answer at once, equal to the
    host scatter, and the searchers kept for the old snapshots go."""
    reg = tsvc.IndicesService(str(tmp_path), device="cpu")
    idx = reg.create("idx", {"settings": {"number_of_shards": 3,
                                          "search.mesh": True},
                             "mappings": SERVICE_MAPPING})
    ops = service_ops(seed=5, n=60)
    idx.bulk(ops[:40])
    idx.refresh()
    body = {"query": {"match": {"title": "w1 fox"}}, "size": 30}
    first = idx.search(dict(body))
    mesh = idx._mesh_searcher
    assert mesh is not None and len(mesh._on_mesh) == 3
    idx.bulk(ops[40:])
    idx.refresh()
    got = idx.search(dict(body))
    assert idx._mesh_searcher is mesh
    assert got["hits"]["total"]["value"] > first["hits"]["total"]["value"]
    assert without_shard(got)["hits"] == \
        without_shard(idx._host_scatter_search(dict(body)))["hits"]
    snapshots = [e.acquire_searcher() for _s, e in
                 sorted(idx.local_shards.items())]
    assert [kept[0] for _i, kept in sorted(mesh._on_mesh.items())] == \
        snapshots
    reg.close()
    assert idx._mesh_searcher is None


def test_breaker_closes_after_a_half_open_probe(services, eight_cards):
    _ref, port = services
    health = device_health()
    health.set_failure_threshold(1)
    health.set_open_interval_s(0)
    closes = metrics().counter("device.breaker.closes").value
    health.record_failure("mesh", RuntimeError("CUDA error: lost"))
    assert health.breaker_states()["mesh"] == "open"
    port.search({"query": {"match": {"title": "w2"}}})
    assert health.breaker_states()["mesh"] == "closed"
    assert metrics().counter("device.breaker.closes").value == closes + 1


@pytest.mark.parametrize("exc,want", [
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate"), True),
    (torch.AcceleratorError("CUDA error: an illegal memory access"), True),
    (RuntimeError("CUDA error: device-side assert triggered"), True),
    (cuda_build.KernelLaunchError("mesh_merge_launch: CUDA error 700: an "
                                  "illegal memory access was encountered"),
     False),
    (RuntimeError("CUDA error 700: an illegal memory access was "
                  "encountered"), True),
    (RuntimeError("NCCL error in: ProcessGroupNCCL.cpp"), True),
    (MemoryError(), True),
    (type("Injected", (Exception,), {"__device_fault__": True})("x"), True),
    (tbreakers.CircuitBreakingError("[fielddata] over"), False),
    (terrors.CircuitBreakingError("fielddata", 2, 1), False),
    (terrors.IllegalArgumentError("CUDA error in a client's text"), False),
    (ValueError("bad shape"), False),
    (RuntimeError("shape mismatch"), False)],
    ids=["oom", "accelerator", "device_assert", "kernel_launch",
         "cuda_runtime", "nccl",
         "memory", "marked", "breaker", "breaker_errors", "client",
         "value", "runtime"])
def test_is_device_error(exc, want):
    assert is_device_error(exc) is want


def test_make_mesh():
    assert tds.make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    assert torch.cuda.device_count() == 0
    with pytest.raises(Exception):
        tds.make_mesh(2, "cuda")
    with pytest.raises(ValueError):
        tds.MeshSearcher([object()] * 3, [torch.device("cpu")] * 2)
    # the mesh's merge kernel keeps its launch count on the wrapper
    from opensearch_tpu_torch.ops import cuda_mesh
    assert cuda_mesh.mesh_merge_cuda.launches == 0
    with pytest.raises(ValueError):
        cuda_mesh.mesh_merge_cuda(torch.zeros(2, 3), 2)
    assert cuda_build.library_path("mesh_merge").name.startswith(
        "libmesh_merge-")
