"""The PyTorch port imports neither ``jax`` nor any module of the JAX
package ``opensearch_tpu`` (only the tests import both).

Checks: a subprocess that blocks those imports with a ``sys.meta_path``
hook, imports every module of ``opensearch_tpu_torch`` (the write path's
engine, store and translog, the serving node's indices service, REST
controller and HTTP server, the filter ops, the search pipelines, the
aggregations and K5's wrapper, the phrase and span ops and K8 / K9's
wrapper among them) and runs CPU searches (a ``match``, a ``knn``, a
filtered ``bool``, a ``match_phrase``, a ``span_near``, a ``hybrid`` and
one with ``aggs``: terms, histogram, metrics, a filter, percentiles and a
pipeline; an ANN ``knn`` on an ``ivf_pq`` field; a ``match`` over a
two-shard ``MeshSearcher``), one engine round
trip and one node on the CPU answering over HTTP (a search pipeline put
among its requests); a static scan of the port's sources and
``chip_smoke.py`` for imports that name them; and the node's entry point, ``python -m
opensearch_tpu_torch.node``, which serves with ``--device cpu`` and,
without ``--device`` on a machine without CUDA, refuses with
``DeviceUnavailableError`` instead of serving on the CPU.  The
module-name test
matches ``opensearch_tpu`` and ``opensearch_tpu.<sub>``, never the
``opensearch_tpu_torch`` prefix.
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "opensearch_tpu_torch")


def forbidden(name: str) -> bool:
    return any(name == top or name.startswith(top + ".")
               for top in ("jax", "jaxlib", "opensearch_tpu"))


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib", True),
    ("opensearch_tpu", True), ("opensearch_tpu.ops.bm25", True),
    ("opensearch_tpu_torch", False), ("opensearch_tpu_torch.ops", False),
    ("jaxtyping", False), ("torch", False)])
def test_forbidden_matches_module_names_not_prefixes(name, bad):
    assert forbidden(name) is bad


HOOKED = r'''
import importlib, pkgutil, sys

def forbidden(name):
    return any(name == top or name.startswith(top + ".")
               for top in ("jax", "jaxlib", "opensearch_tpu"))

for mod in [m for m in sys.modules if forbidden(m)]:
    del sys.modules[mod]

class Block:
    def find_spec(self, name, path=None, target=None):
        if forbidden(name):
            raise ImportError(f"blocked import of [{name}]")
        return None

sys.meta_path.insert(0, Block())

import opensearch_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    opensearch_tpu_torch.__path__, "opensearch_tpu_torch.")]
for name in names:
    importlib.import_module(name)

from opensearch_tpu_torch.index.segment import SegmentWriter
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.search.executor import ShardSearcher

mapper = DocumentMapper({"properties": {
    "body": {"type": "text"},
    "vec": {"type": "knn_vector", "dimension": 4}}})
docs = [mapper.parse(str(i), {"body": f"alpha w{i % 3}",
                              "vec": [float(i), 0.0, 1.0, 2.0]})
        for i in range(12)]
seg = SegmentWriter().build(docs, "s0")
searcher = ShardSearcher([seg], mapper, device="cpu")
resp = searcher.search({"query": {"match": {"body": "w1"}}})
assert resp["hits"]["total"]["value"] == 4, resp
resp = searcher.search({"query": {"knn": {"vec": {"vector": [3, 0, 1, 2],
                                                  "k": 2}}}})
assert resp["hits"]["hits"][0]["_id"] == "3", resp
for name in ("index.engine", "index.store", "index.translog", "node",
             "rest.controller", "rest.http_server", "indices.service",
             "indices.request_cache", "common.xcontent", "common.breakers",
             "version", "ops.filters", "search.pipeline",
             "common.settings", "ops.aggs", "ops.cuda_aggs", "search.aggs",
             "search.pipeline_aggs", "search.scripting", "ops.ivf",
             "ops.cuda_ivf", "ops.phrase", "ops.span",
             "ops.cuda_positions", "parallel.dist_search",
             "common.device_health", "common.telemetry", "ops.mesh",
             "ops.cuda_mesh"):
    assert "opensearch_tpu_torch." + name in names, name
from opensearch_tpu_torch.parallel.dist_search import MeshSearcher
msegs = [SegmentWriter().build(docs[i::2], f"m{i}") for i in range(2)]
mesh = MeshSearcher([ShardSearcher([s], mapper, shard_id=i, device="cpu")
                     for i, s in enumerate(msegs)])
resp = mesh.search({"query": {"match": {"body": "w1"}}})
assert resp["hits"]["total"]["value"] == 4, resp
assert {h["_shard"] for h in resp["hits"]["hits"]} == {0, 1}, resp
amapper = DocumentMapper({"properties": {"vec": {
    "type": "knn_vector", "dimension": 4,
    "method": {"name": "ivf_pq", "parameters": {"nlist": 2, "m": 2}}}}})
aseg = SegmentWriter().build(
    [amapper.parse(str(i), {"vec": [float(i), 0.0, 1.0, 2.0]})
     for i in range(12)], "a0")
resp = ShardSearcher([aseg], amapper, device="cpu").search(
    {"query": {"knn": {"vec": {"vector": [3, 0, 1, 2], "k": 2,
                               "method_parameters": {"nprobe": 2}}}}})
assert resp["hits"]["hits"][0]["_id"] == "3", resp
fmapper = DocumentMapper({"properties": {
    "body": {"type": "text"}, "price": {"type": "long"},
    "tag": {"type": "keyword"}}})
fseg = SegmentWriter().build(
    [fmapper.parse(str(i), {"body": f"alpha w{i % 3}", "price": i,
                            "tag": f"t{i % 4}"}) for i in range(12)], "f0")
fsearcher = ShardSearcher([fseg], fmapper, device="cpu")
resp = fsearcher.search({"query": {"bool": {
    "must": [{"match": {"body": "w1"}}],
    "filter": [{"range": {"price": {"gte": 4}}},
               {"terms": {"tag": ["t0", "t1", "t3"]}}]}}})
assert resp["hits"]["total"]["value"] == 2, resp
for q in ({"match_phrase": {"body": "alpha w1"}},
          {"span_near": {"clauses": [{"span_term": {"body": "alpha"}},
                                     {"span_term": {"body": "w1"}}],
                         "slop": 0, "in_order": True}}):
    resp = fsearcher.search({"query": q})
    assert resp["hits"]["total"]["value"] == 4, resp
resp = fsearcher.search({"query": {"hybrid": {"queries": [
    {"match": {"body": "w1"}}, {"range": {"price": {"lt": 3}}}]}},
    "_hybrid_pipeline": {"combination": {
        "technique": "arithmetic_mean",
        "parameters": {"weights": [0.3, 0.7]}}}, "timeout": "10s"})
assert len(resp["hits"]["hits"]) == 6 and not resp["timed_out"], resp
resp = fsearcher.search({"size": 2, "query": {"match": {"body": "alpha"}},
                         "aggs": {
    "t": {"terms": {"field": "tag"}, "aggs": {"s": {"sum": {"field": "price"}}}},
    "h": {"histogram": {"field": "price", "interval": 5},
          "aggs": {"m": {"max": {"field": "price"}},
                   "c": {"cumulative_sum": {"buckets_path": "m"}}}},
    "st": {"stats": {"field": "price"}},
    "f": {"filter": {"range": {"price": {"lt": 6}}}},
    "p": {"percentiles": {"field": "price", "percents": [50]}}}})
aggs = resp["aggregations"]
assert [b["doc_count"] for b in aggs["t"]["buckets"]] == [3, 3, 3, 3], aggs
assert aggs["st"]["sum"] == 66.0 and aggs["f"]["doc_count"] == 6, aggs
assert aggs["h"]["buckets"][-1]["c"]["value"] == 24.0, aggs

import tempfile
from opensearch_tpu_torch.index.engine import InternalEngine

with tempfile.TemporaryDirectory() as path:
    engine = InternalEngine(path, mapper, device="cpu")
    for i in range(6):
        engine.index(str(i), {"body": f"alpha w{i % 2}",
                              "vec": [float(i), 0.0, 1.0, 2.0]})
    engine.flush()
    engine.close()
    engine = InternalEngine(path, mapper, device="cpu")
    resp = engine.acquire_searcher().search(
        {"query": {"match": {"body": "w1"}}})
    assert resp["hits"]["total"]["value"] == 3, resp
    engine.close()
import json
import urllib.request
from opensearch_tpu_torch.node import Node

with tempfile.TemporaryDirectory() as path:
    node = Node(path, port=0, device="cpu").start()
    try:
        base = f"http://127.0.0.1:{node.port}"
        with urllib.request.urlopen(base + "/") as resp:
            assert json.loads(resp.read())["version"]["number"]
        bulk = (json.dumps({"index": {"_index": "i", "_id": "1"}}) + "\n"
                + json.dumps({"body": "alpha beta"}) + "\n").encode()
        req = urllib.request.Request(
            base + "/_bulk?refresh=true", data=bulk, method="POST",
            headers={"Content-Type": "application/x-ndjson"})
        with urllib.request.urlopen(req) as resp:
            assert not json.loads(resp.read())["errors"]
        with urllib.request.urlopen(base + "/i/_count") as resp:
            assert json.loads(resp.read())["count"] == 1
        req = urllib.request.Request(
            base + "/_search/pipeline/p", method="PUT",
            data=json.dumps({"phase_results_processors": [
                {"normalization-processor": {}}]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as resp:
            assert json.loads(resp.read())["acknowledged"]
    finally:
        node.stop()
bad = sorted(m for m in sys.modules if forbidden(m))
assert not bad, bad
print("IMPORTED", len(names))
'''


def test_port_imports_and_searches_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", HOOKED], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n = int(proc.stdout.split("IMPORTED")[-1])
    assert n >= 20            # every module of the port was imported


def _named_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            fname = getattr(fn, "id", None) or getattr(fn, "attr", None)
            if fname in ("__import__", "import_module") and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                yield node.lineno, node.args[0].value


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(PORT):
        files.extend(os.path.join(dirpath, n) for n in names
                     if n.endswith(".py"))
    return sorted(files)


def test_static_scan_finds_no_jax_or_reference_import():
    files = _port_sources()
    assert len(files) >= 20
    offenders = [f"{os.path.relpath(path, ROOT)}:{line}: {name}"
                 for path in files
                 for line, name in _named_imports(path)
                 if forbidden(name)]
    assert not offenders, offenders


def test_node_without_device_raises_without_cuda(tmp_path, monkeypatch):
    import torch

    from opensearch_tpu_torch.common.torchenv import DeviceUnavailableError
    from opensearch_tpu_torch.node import Node

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        Node(str(tmp_path / "data"), port=0)
    assert not (tmp_path / "data").exists()


def _node_cli(tmp_path, *args, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "opensearch_tpu_torch.node", "--port", "0",
         "--data-path", str(tmp_path / "data"), *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)


def test_node_cli_serves_on_the_cpu_when_asked(tmp_path):
    import json
    import re
    import signal
    import urllib.request

    proc = _node_cli(tmp_path, "--device", "cpu")
    try:
        line = proc.stdout.readline()
        m = re.search(r"http://127\.0\.0\.1:(\d+) .*device: cpu", line)
        assert m, line + proc.stderr.read()
        with urllib.request.urlopen(f"http://127.0.0.1:{m.group(1)}/",
                                    timeout=30) as resp:
            assert json.loads(resp.read())["cluster_name"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


def test_node_cli_without_device_refuses_without_cuda(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _node_cli(tmp_path, env=env)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0, out
    assert "DeviceUnavailableError" in err, err
    assert "listening" not in out
    assert not (tmp_path / "data").exists()
