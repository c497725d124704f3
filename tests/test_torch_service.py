"""``IndicesService`` / ``IndexService`` of the PyTorch port
(``opensearch_tpu_torch/indices/service.py``, on the CPU) against the JAX
package's, on the same seeded op sequence.

- ``shard_id_for`` (murmur3 routing), ``deep_merge_doc`` and
  ``_parse_millis`` agree with the reference.
- One seeded sequence of bulk requests (index, create of an existing id,
  partial update, upsert, update of a missing id, delete, delete of a
  missing id), refreshes, flushes and force-merges goes through both
  registries, on a 1-shard and a 3-shard index: bulk item results equal;
  after every step ``search`` / ``msearch`` / ``count`` equal, BM25 byte
  for byte (the node-local searcher over every shard's segments, so
  index-wide statistics), with the reference on its device scoring path
  (``HOST_SCORING`` off, as ``tests/test_impacts.py`` runs it).  A
  shard's own engine searcher is not disturbed by the node searcher.
- A request-cache hit is byte-identical to the miss that filled it, and
  the weighted LRU ``Cache`` under it evicts, rejects and counts as the
  reference's does, charging its breaker its resident bytes.
- Both registries reload their indices after closing and reopening.
- Left-out features raise ``NotYetPortedError``: alias actions and an
  index created with aliases.  An index with ``search.mesh`` on a host
  with as many devices as shards (the reference's 8-device CPU mesh,
  stood in for by ``torch.cuda.device_count``) answers through the mesh
  (``tests/test_torch_mesh.py`` holds it to the reference).
"""

import json

import numpy as np
import pytest
import torch

from opensearch_tpu.common.device_ledger import device_ledger
from opensearch_tpu.indices import service as jsvc
from opensearch_tpu.ops import bm25 as jbm25
from opensearch_tpu_torch.common.errors import NotYetPortedError
from opensearch_tpu_torch.common.torchenv import DeviceUnavailableError
from opensearch_tpu_torch.indices import service as tsvc
from opensearch_tpu_torch.indices.request_cache import request_cache
from opensearch_tpu_torch.search.executor import ShardSearcher
from opensearch_tpu_torch.testing.parity import bm25_mismatch

MAPPING = {"properties": {"title": {"type": "text"},
                          "tag": {"type": "keyword"}}}
TAGS = ("red", "green", "blue")
WORDS = [f"w{i}" for i in range(30)]


@pytest.fixture(autouse=True)
def _reference_device_scoring(monkeypatch):
    """The reference scores on its device path (not the host shortcut),
    and its pager state starts and ends empty."""
    monkeypatch.setattr(jbm25, "HOST_SCORING", False)
    led = device_ledger()
    led.reset()
    yield
    led.reset()


# -- routing and the host helpers --------------------------------------------

@pytest.mark.parametrize("num_shards", [1, 2, 3, 5])
def test_shard_id_for_matches_reference(num_shards):
    rng = np.random.default_rng(num_shards)
    ids = [f"doc-{i}" for i in range(500)] + [
        "".join(chr(int(c)) for c in rng.integers(33, 0x4E00, size=k))
        for k in rng.integers(1, 12, size=500)]
    routings = [None, "user-7", "", "中文"]
    for i, doc in enumerate(ids):
        routing = routings[i % len(routings)]
        for r in (None, routing):
            assert tsvc.shard_id_for(doc, r, num_shards) == \
                jsvc.shard_id_for(doc, r, num_shards), (doc, r)
    assert len({tsvc.shard_id_for(d, None, num_shards)
                for d in ids}) == num_shards


@pytest.mark.parametrize("fn,args", [
    ("murmur3_32", (b"",)), ("murmur3_32", (b"abc", 7)),
    ("murmur3_32", ("doc-中".encode(),)),
    ("deep_merge_doc", ({"a": {"b": 1, "c": [1]}, "d": 2},
                        {"a": {"c": [2], "e": 3}, "d": {"x": 1}})),
    ("_parse_millis", ("1.5s",)), ("_parse_millis", ("2m",)),
    ("_parse_millis", (250,)), ("_parse_millis", ("bogus",)),
    ("_parse_millis", ("-1",))])
def test_host_helpers_match_reference(fn, args):
    assert getattr(tsvc, fn)(*args) == getattr(jsvc, fn)(*args)


# -- one seeded op sequence through both registries --------------------------

def bulk_ops(rng, n: int, next_id: int, live: list) -> tuple:
    """A bulk request of ``n`` items: new docs, plus updates, upserts,
    creates of existing ids and deletes (some of missing ids)."""
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.6 or not live:
            doc = f"d{next_id}"
            next_id += 1
            words = rng.zipf(1.3, size=int(rng.integers(2, 10))) - 1
            src = {"title": " ".join(WORDS[int(w) % 30] for w in words),
                   "tag": TAGS[int(rng.integers(3))]}
            action = "create" if rng.random() < 0.2 else "index"
            ops.append((action, doc, src, {}))
            live.append(doc)
        elif r < 0.7:
            doc = live[int(rng.integers(len(live)))]
            ops.append(("create", doc, {"title": "dup"}, {}))
        elif r < 0.8:
            doc = live[int(rng.integers(len(live)))]
            ops.append(("update", doc, {"doc": {
                "tag": TAGS[int(rng.integers(3))]}}, {}))
        elif r < 0.85:
            doc = f"u{int(rng.integers(20))}"
            spec = {"doc": {"tag": "red"}}
            if rng.random() < 0.7:
                spec["upsert"] = {"title": "w1 w2 w3", "tag": "green"}
            ops.append(("update", doc, spec, {}))
        elif r < 0.95:
            doc = live.pop(int(rng.integers(len(live))))
            ops.append(("delete", doc, None, {}))
        else:
            ops.append(("delete", f"missing{int(rng.integers(9))}", None,
                        {}))
    return ops, next_id


def queries(rng) -> list:
    w = [WORDS[int(x)] for x in rng.integers(0, 12, size=6)]
    return [
        {"query": {"match": {"title": f"{w[0]} {w[1]}"}}},
        {"query": {"match": {"title": {"query": f"{w[2]} {w[3]}",
                                       "operator": "and"}}}, "size": 20},
        {"query": {"bool": {"must": [{"match": {"title": w[4]}}],
                            "filter": [{"term": {"tag": "red"}}]}},
         "size": 15},
        {"query": {"term": {"tag": "blue"}}, "size": 30, "from": 3},
        {"query": {"match_all": {}}, "size": 0},
        {"query": {"match": {"title": w[5]}},
         "track_total_hits": False, "size": 5},
    ]


def strip_took(resp: dict) -> dict:
    return {k: v for k, v in resp.items() if k != "took"}


def untracked(resp: dict) -> dict:
    """A response without its total: under ``track_total_hits: false``
    the k-th-score prune makes the total a lower bound that depends on
    which segment programs finished first."""
    out = strip_took(resp)
    out["hits"] = {k: v for k, v in resp["hits"].items() if k != "total"}
    return out


def same_response(a: dict, b: dict, body: dict, exact: int):
    if body.get("track_total_hits") is False:
        assert untracked(a) == untracked(b), body
        for r in (a, b):
            total = r["hits"]["total"]
            assert total["value"] <= exact, body
            assert total["relation"] == "gte" or total["value"] == exact
    else:
        assert bm25_mismatch(a, b) is None, (body, bm25_mismatch(a, b))
        assert strip_took(a) == strip_took(b), body


def check_search(ref, port, rng):
    bodies = queries(rng)
    for body in bodies:
        q = body["query"]
        exact = ref.count(q)
        assert port.count(q) == exact, body
        same_response(ref.search(body), port.search(body), body, exact)
    ma, mb = ref.msearch(bodies), port.msearch(bodies)
    for body, a, b, c in zip(bodies, ma, mb, [port.search(b)
                                             for b in bodies]):
        same_response(a, b, body, ref.count(body["query"]))
        same_response(b, c, body, ref.count(body["query"]))


@pytest.mark.parametrize("shards", [1, 3])
def test_op_sequence_matches_the_reference_service(tmp_path, shards):
    ref_reg = jsvc.IndicesService(str(tmp_path / "jax" / "indices"))
    port_reg = tsvc.IndicesService(str(tmp_path / "torch" / "indices"),
                                   device="cpu")
    body = {"settings": {"number_of_shards": shards}, "mappings": MAPPING}
    ref, port = ref_reg.create("idx", dict(body)), \
        port_reg.create("idx", dict(body))
    rng = np.random.default_rng(11 + shards)
    next_id, live = 0, []
    outcomes: dict = {}
    for step in range(9):
        ops, next_id = bulk_ops(rng, 40, next_id, live)
        a, b = ref.bulk(ops), port.bulk(ops)
        assert a == b, step
        for item in a:
            (action, res), = item.items()
            key = (action, res.get("result") or res["error"]["type"])
            outcomes[key] = outcomes.get(key, 0) + 1
        assert ref.doc_count() == port.doc_count()
        step_kind = step % 4
        if step_kind == 0:
            ref.refresh(), port.refresh()
        elif step_kind == 1:
            ref.flush(), port.flush()
        elif step_kind == 2 and step > 5:
            ref.force_merge(1), port.force_merge(1)
        else:
            ref.refresh(), port.refresh()
        check_search(ref, port, rng)
    for doc in live[:40] + ["u3", "missing1"]:
        assert ref.get_doc(doc) == port.get_doc(doc), doc
    assert ref.stats()["docs"] == port.stats()["docs"]
    for key in (("index", "created"), ("create", "created"),
                ("create", "action_request_validation_exception"),
                ("update", "updated"), ("update", "document_missing_exception"),
                ("delete", "deleted"), ("delete", "not_found")):
        assert outcomes.get(key, 0) >= 2, (key, outcomes)
    ref_reg.close(), port_reg.close()


def test_node_searcher_leaves_the_shard_searchers_alone(tmp_path):
    """The node-local searcher scores a 3-shard index with index-wide
    statistics (equal to the reference's); each shard's own engine
    searcher keeps its per-shard statistics, before and after."""
    ref_reg = jsvc.IndicesService(str(tmp_path / "jax"))
    port_reg = tsvc.IndicesService(str(tmp_path / "torch"), device="cpu")
    body = {"settings": {"number_of_shards": 3}, "mappings": MAPPING}
    ref, port = ref_reg.create("idx", dict(body)), \
        port_reg.create("idx", dict(body))
    rng = np.random.default_rng(5)
    ops, _ = bulk_ops(rng, 150, 0, [])
    ref.bulk(ops), port.bulk(ops)
    ref.refresh(), port.refresh()
    q = {"query": {"match": {"title": "w0 w1 w2"}}, "size": 50}
    shard0 = port.engine_for(0)
    own = shard0.acquire_searcher().search(q)
    fresh = ShardSearcher(shard0.segments, port.mapper, index_name="idx",
                          device="cpu")
    assert strip_took(own) == strip_took(fresh.search(q))
    node = port.search(q)
    assert strip_took(node) == strip_took(ref.search(q))
    assert node["hits"]["total"]["value"] > own["hits"]["total"]["value"]
    assert strip_took(shard0.acquire_searcher().search(q)) == \
        strip_took(own)
    assert strip_took(own) == strip_took(
        ref.engine_for(0).acquire_searcher().search(q))
    ref_reg.close(), port_reg.close()


def test_request_cache_hit_is_byte_identical(tmp_path):
    reg = tsvc.IndicesService(str(tmp_path), device="cpu")
    svc = reg.create("idx", {"mappings": MAPPING})
    ops, _ = bulk_ops(np.random.default_rng(2), 60, 0, [])
    svc.bulk(ops)
    svc.refresh()
    body = {"query": {"term": {"tag": "red"}}, "size": 0}
    before = request_cache().stats_for_index("idx")
    miss = json.dumps(svc.search(body))
    hit = json.dumps(svc.search(body))
    after = request_cache().stats_for_index("idx")
    assert hit == miss
    assert after["miss_count"] - before["miss_count"] == 1
    assert after["hit_count"] - before["hit_count"] == 1
    # a hit-bearing request bypasses the cache by default; a refresh
    # moves the reader generation past the cached entry
    svc.search({"query": {"term": {"tag": "red"}}})
    assert request_cache().stats_for_index("idx")["hit_count"] == \
        after["hit_count"]
    svc.bulk([("index", "new", {"title": "w0", "tag": "red"}, {})])
    svc.refresh()
    fresh = svc.search(body)
    assert fresh["hits"]["total"]["value"] == \
        json.loads(miss)["hits"]["total"]["value"] + 1
    reg.close()


def test_indices_reload_after_reopen(tmp_path):
    paths = (str(tmp_path / "jax"), str(tmp_path / "torch"))
    regs = (jsvc.IndicesService(paths[0]),
            tsvc.IndicesService(paths[1], device="cpu"))
    rng = np.random.default_rng(8)
    ops, _ = bulk_ops(rng, 80, 0, [])
    for reg in regs:
        reg.create("one", {"mappings": MAPPING})
        reg.create("three", {"settings": {"number_of_shards": 3},
                             "mappings": MAPPING})
        reg.create("gone", {})
        for name in ("one", "three"):
            reg.get(name).bulk(ops)
        reg.get("one").flush()            # "three" recovers from its translog
        reg.delete("gone")
        reg.close()
    regs = (jsvc.IndicesService(paths[0]),
            tsvc.IndicesService(paths[1], device="cpu"))
    assert sorted(regs[0].indices) == sorted(regs[1].indices) == \
        ["one", "three"]
    for name in ("one", "three"):
        ref, port = regs[0].get(name), regs[1].get(name)
        assert port.num_shards == ref.num_shards
        assert port.get_mapping() == ref.get_mapping()
        ref.refresh(), port.refresh()
        check_search(ref, port, np.random.default_rng(9))
    regs[0].close(), regs[1].close()


def test_registry_without_device_asks_for_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        tsvc.IndicesService(str(tmp_path))
    reg = tsvc.IndicesService(str(tmp_path), device="cpu")
    svc = reg.create("idx", {})
    assert svc.device == torch.device("cpu")
    assert all(e.device == torch.device("cpu") for e in svc.shards)
    assert svc.searcher().device == torch.device("cpu")
    reg.close()


def test_left_out_features_raise_not_yet_ported(tmp_path, monkeypatch):
    reg = tsvc.IndicesService(str(tmp_path), device="cpu")
    reg.create("idx", {"mappings": MAPPING})
    with pytest.raises(NotYetPortedError):
        reg.update_aliases([{"add": {"index": "idx", "alias": "a"}}])
    with pytest.raises(NotYetPortedError):
        reg.create("aliased", {"aliases": {"a": {}}})
    for call in (lambda: reg.put_template("t", {"index_patterns": ["x*"]}),
                 lambda: reg.rollover("a"),
                 lambda: reg.resize("idx", "idx2", "shrink"),
                 lambda: reg.create_data_stream("ds")):
        with pytest.raises(NotYetPortedError):
            call()
    with pytest.raises(NotYetPortedError):
        reg.create("mounted", {"settings": {"remote_snapshot": {
            "repository": "r", "snapshot": "s", "index": "i"}}})
    mesh = reg.create("mesh", {"settings": {"number_of_shards": 2,
                                            "search.mesh": True},
                               "mappings": MAPPING})
    mesh.bulk([("index", str(i), {"title": f"w{i % 4}"}, {})
               for i in range(12)])
    mesh.refresh()
    body = {"query": {"match": {"title": "w1"}}}
    # fewer devices than shards: the node-local path, as in the reference
    assert mesh.search(body)["hits"]["total"]["value"] == 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    # as many devices as shards: the mesh answers (per-shard statistics,
    # each hit marked with its shard), equal to its host scatter
    got = mesh.search(body)
    assert got["hits"]["total"]["value"] == 3
    assert all("_shard" in h for h in got["hits"]["hits"])
    assert [(h["_id"], h["_score"]) for h in got["hits"]["hits"]] == \
        [(h["_id"], h["_score"])
         for h in mesh._host_scatter_search(body)["hits"]["hits"]]
    # aggregations (and their shard partials) are served now
    body = {"query": {"match_all": {}},
            "aggs": {"t": {"terms": {"field": "tag"}}}}
    assert reg.get("idx").search(body)["aggregations"] == {"t": {
        "doc_count_error_upper_bound": 0, "sum_other_doc_count": 0,
        "buckets": []}}
    assert reg.get("idx").search(body, agg_partials=True)[
        "aggregation_partials"]["t"]["t"] == "terms"
    reg.close()


def test_weighted_cache_matches_reference():
    """The port's ``common/cache.py`` ``Cache`` (under the shard request
    cache) evicts, replaces, rejects and counts as the reference's does
    on one seeded sequence of puts, gets and invalidations, and charges
    its breaker exactly its resident weight."""
    from opensearch_tpu.common import cache as jcache
    from opensearch_tpu_torch.common import cache as tcache
    from opensearch_tpu_torch.common.breakers import CircuitBreakerService

    removed = {"ref": [], "port": []}
    breaker = CircuitBreakerService().request
    ref = jcache.Cache("t", max_weight=600,
                       removal_listener=lambda k, v, r: removed["ref"]
                       .append((k, r)))
    port = tcache.Cache("t", max_weight=600, breaker=breaker,
                        removal_listener=lambda k, v, r: removed["port"]
                        .append((k, r)))
    rng = np.random.default_rng(4)
    for _ in range(400):
        key = f"k{int(rng.integers(30))}"
        r = rng.random()
        if r < 0.5:
            value = "x" * int(rng.integers(1, 400))
            assert ref.put(key, value) == port.put(key, value)
        elif r < 0.9:
            assert ref.get(key) == port.get(key)
        else:
            n = int(rng.integers(10))
            assert ref.invalidate_if(lambda k, v: k.endswith(str(n))) == \
                port.invalidate_if(lambda k, v: k.endswith(str(n)))
        assert ref.entries() == port.entries()
        assert breaker.used == sum(w for _k, _v, w in port.entries())
    assert ref.stats() == port.stats()
    assert removed["ref"] == removed["port"]
    assert port.stats()["evictions"] > 0 and port.stats()["rejections"] > 0
    for obj in (None, b"abc", "abc", 3, [1, "a"], {"a": (1, 2)},
                np.zeros(5, np.float32), torch.zeros(3)):
        assert tcache.estimate_weight(obj) == jcache.estimate_weight(
            np.asarray(obj) if isinstance(obj, torch.Tensor) else obj)
