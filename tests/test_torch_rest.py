"""The PyTorch port's serving node (``opensearch_tpu_torch/node.py``: the
REST controller, the HTTP server and ``IndicesService``, on the CPU)
against the JAX package's node, over real HTTP.

Both nodes listen on ``port=0`` and take the same script of requests,
modelled on ``tests/test_rest.py``: index lifecycle, document CRUD,
``_bulk`` with partial errors, ``_search`` (``size``, ``from``,
``track_total_hits``, ``rest_total_hits_as_int``, URI ``q``: a field,
no field and a quoted phrase),
multi-index ``_search``, ``_msearch`` with a per-request error,
``_count``, ``_refresh``, ``_flush``, ``_forcemerge``, error shapes and
persistence across a restart.  Statuses and bodies must be equal once
these fields are stripped: ``took`` (a time), ``uuid``,
``creation_date`` and ``cluster_uuid`` (drawn per node), and the ``_id``
a node draws for a document indexed without one.  The reference scores
on its device path (``HOST_SCORING`` off, as ``tests/test_impacts.py``
runs it), so BM25 scores compare byte for byte.

``_search`` with ``aggs`` (on one index and across indices), with
``sort``, and ``_msearch`` bodies with ``aggs`` answer as the
reference's.  Where the port does not serve a feature yet (a wildcard
``q``, the routes of unported handlers) it must answer 501 with
``not_yet_ported_exception``, while the reference answers; both nodes
have the same (method, path) routes; a path with no route answers 400
and a wrong method 405 on both.  The port's own HTTP edge: a missing
device answers 503 and a CUDA fault 500, a body over the
``in_flight_requests`` breaker 429 with ``Retry-After``, and keep-alive
responses go out without Nagle's delay.  ``common/xcontent.py`` encodes
and decodes JSON, YAML and CBOR, and fails, as the reference's does.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from opensearch_tpu.node import Node as JaxNode
from opensearch_tpu.ops import bm25 as jbm25
from opensearch_tpu_torch.common.torchenv import DeviceUnavailableError
from opensearch_tpu_torch.node import Node
from opensearch_tpu_torch.testing.parity import profile_shape

STRIPPED = frozenset({"took", "uuid", "creation_date", "cluster_uuid"})
MAPPING = {"properties": {"title": {"type": "text"},
                          "genre": {"type": "keyword"}}}
WORDS = [f"w{i}" for i in range(30)]


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbm25, "HOST_SCORING", False)
        ref = JaxNode(str(tmp_path_factory.mktemp("ref")), port=0).start()
        port = Node(str(tmp_path_factory.mktemp("port")), port=0,
                    device="cpu").start()
        try:
            yield ref, port
        finally:
            ref.stop()
            port.stop()


def call(node, method, path, body=None, ndjson=None):
    url = f"http://127.0.0.1:{node.port}{path}"
    data, headers = None, {}
    if ndjson is not None:
        data = ("\n".join(json.dumps(line) for line in ndjson)
                + "\n").encode()
        headers["Content-Type"] = "application/x-ndjson"
    elif isinstance(body, bytes):
        data = body
        headers["Content-Type"] = "application/json"
    elif body is not None:
        data = json.dumps(body).encode()
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            payload = resp.read()
            return resp.status, json.loads(payload) if payload else {}
    except urllib.error.HTTPError as e:
        payload = e.read()
        return e.code, json.loads(payload) if payload else {}


def strip(value, extra=frozenset()):
    if isinstance(value, dict):
        return {k: strip(v, extra) for k, v in value.items()
                if k not in STRIPPED and k not in extra}
    if isinstance(value, list):
        return [strip(v, extra) for v in value]
    return value


def both(nodes, method, path, body=None, ndjson=None, extra=frozenset()):
    """The same request to both nodes; returns the port's (status, body)
    after asserting it equals the reference's."""
    ref, port = (call(n, method, path, body, ndjson) for n in nodes)
    assert ref[0] == port[0], (method, path, ref, port)
    assert strip(ref[1], extra) == strip(port[1], extra), \
        (method, path, ref[1], port[1])
    return port


def not_ported(nodes, method, path, body=None, ndjson=None):
    """The reference answers; the port answers 501 with its own type."""
    ref, port = (call(n, method, path, body, ndjson) for n in nodes)
    assert ref[0] < 500, (method, path, ref)
    assert port[0] == 501, (method, path, port)
    assert port[1]["error"]["type"] == "not_yet_ported_exception", port
    assert port[1]["status"] == 501


def docs(seed: int, n: int, index: str) -> list:
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        words = rng.zipf(1.3, size=int(rng.integers(2, 9))) - 1
        lines += [{"index": {"_index": index, "_id": str(i)}},
                  {"title": " ".join(WORDS[int(w) % 30] for w in words),
                   "genre": ("a", "b", "c")[i % 3]}]
    return lines


# -- the surface ---------------------------------------------------------------

PORTED_HANDLERS = {
    "h_root", "h_cluster_health", "h_create_index", "h_delete_index",
    "h_get_index", "h_index_exists", "h_get_mapping", "h_put_mapping",
    "h_get_settings", "h_refresh", "h_flush", "h_forcemerge", "h_index_doc",
    "h_index_doc_auto", "h_create_doc", "h_get_doc", "h_doc_exists",
    "h_delete_doc", "h_update_doc", "h_bulk", "h_search", "h_msearch",
    "h_count", "h_get_pipelines", "h_get_pipeline", "h_put_pipeline",
    "h_delete_pipeline", "h_scroll_next", "h_scroll_clear",
    "h_scroll_clear_all", "h_pit_open", "h_pit_close"}


def test_routes_match_reference(nodes):
    ref, port = nodes
    patterns = [[(r.method, r.rx.pattern) for r in n.rest.routes]
                for n in (ref, port)]
    assert patterns[0] == patterns[1]
    handlers = [r.handler.__name__ for r in port.rest.routes]
    assert set(handlers) - {"h_not_ported"} == PORTED_HANDLERS
    # every ported route keeps the reference's handler
    for r_ref, r_port in zip(ref.rest.routes, port.rest.routes):
        if r_port.handler.__name__ != "h_not_ported":
            assert r_port.handler.__name__ == r_ref.handler.__name__


def test_root_and_health(nodes):
    status, body = both(nodes, "GET", "/")
    assert status == 200 and body["version"]["number"]
    both(nodes, "PUT", "/health1", {"settings": {"number_of_shards": 2}})
    for path in ("/_cluster/health", "/_cluster/health?level=indices",
                 "/_cluster/health?level=shards"):
        status, body = both(nodes, "GET", path)
        assert status == 200 and body["status"] == "green"


def test_index_lifecycle(nodes):
    status, _ = both(nodes, "PUT", "/books", {
        "settings": {"number_of_shards": 3}, "mappings": MAPPING})
    assert status == 200
    assert both(nodes, "HEAD", "/books")[0] == 200
    assert both(nodes, "PUT", "/books", {})[0] == 400
    assert both(nodes, "PUT", "/Bad_Name", {})[0] == 400
    both(nodes, "GET", "/books")
    both(nodes, "GET", "/books/_mapping")
    both(nodes, "GET", "/books/_settings")
    both(nodes, "PUT", "/books/_mapping",
         {"properties": {"year": {"type": "integer"}}})
    both(nodes, "GET", "/books/_mapping")
    both(nodes, "PUT", "/doomed", {})
    assert both(nodes, "DELETE", "/doomed")[0] == 200
    assert both(nodes, "HEAD", "/doomed")[0] == 404
    assert both(nodes, "GET", "/doomed")[0] == 404
    assert both(nodes, "DELETE", "/doomed")[0] == 404


def test_doc_crud(nodes):
    both(nodes, "PUT", "/crud", {"mappings": MAPPING})
    assert both(nodes, "PUT", "/crud/_doc/1", {"title": "w1 w2"})[0] == 201
    status, body = both(nodes, "PUT", "/crud/_doc/1", {"title": "w1 w3"})
    assert status == 200 and body["_version"] == 2
    both(nodes, "GET", "/crud/_doc/1")
    assert both(nodes, "HEAD", "/crud/_doc/1")[0] == 200
    assert both(nodes, "GET", "/crud/_doc/404")[0] == 404
    assert both(nodes, "PUT", "/crud/_create/1", {"title": "x"})[0] == 409
    assert both(nodes, "POST", "/crud/_doc", {"title": "auto"},
                extra={"_id"})[0] == 201
    both(nodes, "POST", "/crud/_update/1", {"doc": {"genre": "a"}})
    both(nodes, "POST", "/crud/_update/1", {"doc": {"genre": "a"}})  # noop
    both(nodes, "POST", "/crud/_update/1?_source=true",
         {"doc": {"genre": "b"}})
    both(nodes, "POST", "/crud/_update/2", {"doc": {"genre": "a"},
                                            "upsert": {"title": "up"}})
    both(nodes, "POST", "/crud/_update/3", {"doc": {"title": "dau"},
                                            "doc_as_upsert": True})
    assert both(nodes, "POST", "/crud/_update/9",
                {"doc": {"x": 1}})[0] == 404
    assert both(nodes, "PUT", "/crud/_doc/1?if_seq_no=0&if_primary_term=1",
                {"title": "stale"})[0] == 409
    both(nodes, "PUT", "/crud/_doc/r1?routing=u7&refresh=true",
         {"title": "routed"})
    both(nodes, "GET", "/crud/_doc/r1?routing=u7")
    assert both(nodes, "DELETE", "/crud/_doc/2")[0] == 200
    assert both(nodes, "DELETE", "/crud/_doc/2")[0] == 404
    both(nodes, "POST", "/crud/_refresh")
    # the doc indexed without an id is left out: its _id is drawn per node
    both(nodes, "GET", "/crud/_search", {"query": {"bool": {"must_not": [
        {"match": {"title": "auto"}}]}}, "size": 20})
    assert both(nodes, "PUT", "/crud/_doc/1?if_seq_no=x",
                {"title": "y"})[0] == 400


def test_bulk_with_partial_errors(nodes):
    both(nodes, "PUT", "/bulk", {"settings": {"number_of_shards": 2},
                                 "mappings": MAPPING})
    lines = docs(3, 50, "bulk") + [
        {"create": {"_index": "bulk", "_id": "3"}}, {"title": "dup"},
        {"index": {"_index": "bulk", "_id": "4", "op_type": "create"}},
        {"title": "dup"},
        {"update": {"_index": "bulk", "_id": "5"}}, {"doc": {"genre": "z"}},
        {"update": {"_index": "bulk", "_id": "u1"}},
        {"doc": {"genre": "z"}, "upsert": {"title": "w1 w2"}},
        {"update": {"_index": "bulk", "_id": "missing"}},
        {"doc": {"genre": "z"}},
        {"update": {"_index": "bulk", "_id": "6", "_source": True}},
        {"doc": {"genre": "y"}},
        {"delete": {"_index": "bulk", "_id": "7"}},
        {"delete": {"_index": "bulk", "_id": "nope"}},
        {"index": {"_index": "Bad", "_id": "1"}}, {"title": "x"},
        {"index": {"_index": "bulk", "_id": ""}}, {"title": "x"},
        {"index": {"_index": "bulk", "_id": "ra", "require_alias": True}},
        {"title": "x"},
        {"index": {"_index": "autocreated", "_id": "1"}}, {"title": "w1"}]
    status, body = both(nodes, "POST", "/_bulk?refresh=true", ndjson=lines)
    assert status == 200 and body["errors"]
    statuses = [next(iter(it.values()))["status"] for it in body["items"]]
    assert statuses.count(201) >= 50 and 400 in statuses and 404 in statuses
    both(nodes, "POST", "/bulk/_bulk", ndjson=[
        {"index": {"_id": "late"}}, {"title": "w9 w9"}])
    both(nodes, "GET", "/bulk/_doc/late")
    for bad in (b'{"index": {"_index": "bulk"}}\n', b"not json\n",
                b'{"frobnicate": {}}\n{}\n'):
        both(nodes, "POST", "/_bulk", bad)
    both(nodes, "POST", "/_refresh")
    both(nodes, "POST", "/bulk/_search", {"query": {"match": {
        "title": "w1 w2"}}, "size": 20})


def test_search_params(nodes):
    both(nodes, "PUT", "/srch", {"settings": {"number_of_shards": 3},
                                 "mappings": MAPPING})
    both(nodes, "POST", "/_bulk?refresh=true", ndjson=docs(5, 80, "srch"))
    for body in ({"query": {"match": {"title": "w1 w2"}}},
                 {"query": {"match": {"title": "w3"}}, "size": 3, "from": 2},
                 {"query": {"match": {"title": {"query": "w0 w1",
                                                "operator": "and"}}}},
                 {"query": {"bool": {"must": [{"match": {"title": "w1"}}],
                                     "filter": [{"term": {"genre": "a"}}]}}},
                 {"query": {"term": {"genre": "b"}}, "size": 5},
                 {"query": {"match_all": {}}, "size": 0},
                 {"query": {"match": {"title": "w0"}}, "size": 3,
                  "track_total_hits": False},
                 {"query": {"match": {"title": "w0"}},
                  "track_total_hits": 5},
                 {"query": {"match": {"title": "w2"}}, "_source": False},
                 {"query": {"match": {"title": "w2"}},
                  "_source": ["genre"]},
                 {"query": {"match": {"title": "w1"}}, "min_score": 0.5}):
        assert both(nodes, "POST", "/srch/_search", body)[0] == 200, body
    for path in ("/srch/_search?size=2&from=1",
                 "/srch/_search?size=2&rest_total_hits_as_int=true",
                 "/srch/_search?q=title:w1",
                 "/srch/_search?q=w2&df=title&size=4",
                 "/srch/_search?track_total_hits=false&size=2",
                 "/srch/_search?request_cache=true&size=0",
                 "/srch/_search?_source=false&size=1"):
        assert both(nodes, "GET", path)[0] == 200, path
    for path, body in (("/srch/_search", {"bogus": 1}),
                       ("/srch/_search?size=-1", None),
                       ("/srch/_search?request_cache=tru", None),
                       ("/srch/_search", {"size": 20000}),
                       ("/srch/_search", {"query": {"nope": {}}}),
                       ("/srch/_search", {"track_total_hits": 0}),
                       ("/srch/_search", b"{not json")):
        assert both(nodes, "POST", path, body)[0] == 400, (path, body)
    # URI q= with no field (a multi_match over every text field) and a
    # quoted one (a match_phrase), served since the phrase queries are
    for path in ("/srch/_search?q=w1%20w2",
                 "/srch/_search?q=title:%22w0%20w1%22&size=20",
                 "/srch/_count?q=title:%22w1%20w0%22"):
        status, body = both(nodes, "GET", path)
        assert status == 200, path
        assert body.get("count", body.get("hits", {}).get("total",
                                                          {}).get("value"))
    # a URI wildcard (a wildcard query) is served since the multi-term
    # queries are
    status, body = both(nodes, "GET", "/srch/_search?q=title:w1*")
    assert status == 200 and body["hits"]["hits"]
    # profile is served since the Profile API is ported (this case held
    # a 501): the hits and the profile's shape equal the reference's
    ref, port = (call(n, "POST", "/srch/_search",
                      {"query": {"match_all": {}}, "profile": True})
                 for n in nodes)
    assert ref[0] == port[0] == 200, (ref, port)
    assert ref[1]["hits"] == port[1]["hits"]
    assert profile_shape(ref[1], False) == profile_shape(port[1], False)
    # aggregations are served now, as the reference serves them
    assert both(nodes, "POST", "/srch/_search", {
        "query": {"match_all": {}},
        "aggs": {"g": {"terms": {"field": "genre"}}}})[0] == 200
    # sort is served now too, as the reference serves it
    assert both(nodes, "POST", "/srch/_search", {
        "query": {"match_all": {}}, "sort": [{"genre": "asc"}]})[0] == 200


def test_multi_index_search_and_count(nodes):
    both(nodes, "PUT", "/multi1", {"mappings": MAPPING})
    both(nodes, "PUT", "/multi2", {"settings": {"number_of_shards": 2},
                                   "mappings": MAPPING})
    both(nodes, "POST", "/_bulk?refresh=true",
         ndjson=docs(7, 30, "multi1") + docs(8, 25, "multi2"))
    for path in ("/multi1,multi2/_search", "/multi*/_search",
                 "/multi2,multi1/_search"):
        both(nodes, "POST", path, {"query": {"match": {"title": "w1"}},
                                   "size": 7, "from": 2})
    both(nodes, "GET", "/multi*/_search?size=3")
    both(nodes, "GET", "/nomatch*/_search")
    status, body = both(nodes, "GET", "/missing/_search")
    assert status == 404
    assert body["error"]["type"] == "index_not_found_exception"
    for path, body in (("/multi1/_count", None),
                       ("/multi1,multi2/_count",
                        {"query": {"match": {"title": "w2"}}}),
                       ("/multi1/_count?q=title:w3", None)):
        assert both(nodes, "POST", path, body)[0] == 200, path
    assert both(nodes, "POST", "/multi1/_count", {"size": 1})[0] == 400


AGG_MAPPING = {"properties": {"title": {"type": "text"},
                              "genre": {"type": "keyword"},
                              "n": {"type": "long"},
                              "day": {"type": "date"}}}
AGG_BODIES = [
    {"size": 0, "aggs": {"g": {"terms": {"field": "genre"},
                               "aggs": {"s": {"sum": {"field": "n"}},
                                        "m": {"max": {"field": "n"}}}}}},
    {"query": {"match": {"title": "w1 w2"}}, "size": 5,
     "aggs": {"h": {"histogram": {"field": "n", "interval": 7},
                    "aggs": {"st": {"stats": {"field": "n"}}}},
              "d": {"date_histogram": {"field": "day",
                                       "calendar_interval": "month"}}}},
    {"size": 0, "aggs": {"f": {"filter": {"term": {"genre": "a"}},
                               "aggs": {"a": {"avg": {"field": "n"}}}},
                         "c": {"cardinality": {"field": "genre"}},
                         "vc": {"value_count": {"field": "genre"}}}},
]


def agg_docs(seed: int, n: int, index: str) -> list:
    rng = np.random.default_rng(seed)
    lines = []
    for line in docs(seed, n, index):
        if "index" not in line:
            line = dict(line, n=int(rng.integers(0, 60)),
                        day=f"2024-{int(rng.integers(1, 5)):02d}-"
                            f"{int(rng.integers(1, 28)):02d}")
        lines.append(line)
    return lines


def test_aggs_over_http_equal_the_reference_node(nodes):
    """``_search`` with ``aggs`` on one index (2 shards), across indices
    (each answers its partials, the coordinator reduces them) and in
    ``_msearch`` bodies, byte for byte (the columns are long and date:
    every sum is exact)."""
    both(nodes, "PUT", "/agg1", {"settings": {"number_of_shards": 2},
                                 "mappings": AGG_MAPPING})
    both(nodes, "PUT", "/agg2", {"mappings": AGG_MAPPING})
    both(nodes, "POST", "/_bulk?refresh=true",
         ndjson=agg_docs(11, 70, "agg1") + agg_docs(12, 40, "agg2"))
    for body in AGG_BODIES:
        assert both(nodes, "POST", "/agg1/_search", body)[0] == 200
        status, resp = both(nodes, "POST", "/agg1,agg2/_search", body)
        assert status == 200 and resp["aggregations"]
    assert both(nodes, "POST", "/agg1/_search?request_cache=false",
                AGG_BODIES[0])[0] == 200
    lines = []
    for body in AGG_BODIES + [{"query": {"match": {"title": "w1"}},
                               "size": 3}]:
        lines += [{}, body]
    status, resp = both(nodes, "POST", "/agg1/_msearch", ndjson=lines)
    assert status == 200
    assert all("aggregations" in r for r in resp["responses"][:3])


def test_msearch_with_per_request_errors(nodes):
    both(nodes, "PUT", "/ms", {"settings": {"number_of_shards": 2},
                               "mappings": MAPPING})
    both(nodes, "POST", "/_bulk?refresh=true", ndjson=docs(9, 60, "ms"))
    lines = []
    for i in range(12):
        lines += [{}, {"query": {"match": {"title": f"w{i} w{i + 1}"}},
                       "size": 5}]
    lines += [{"index": "missing"}, {"query": {"match_all": {}}},
              {}, {"query": {"term": {"genre": "a"}}, "size": 3},
              {"index": "ms,multi1"}, {"query": {"match": {"title": "w1"}}}]
    status, body = both(nodes, "POST", "/ms/_msearch", ndjson=lines)
    assert status == 200
    assert [r["status"] for r in body["responses"]].count(404) == 1
    both(nodes, "POST", "/ms/_msearch?rest_total_hits_as_int=true",
         ndjson=lines[:6])
    both(nodes, "POST", "/_msearch", ndjson=[{"index": "ms"}, {
        "query": {"match": {"title": "w2"}}}])
    assert both(nodes, "POST", "/_msearch",
                ndjson=[{}, {"query": {}}])[0] == 400
    assert both(nodes, "POST", "/ms/_msearch", ndjson=[{}])[0] == 400


def test_refresh_flush_forcemerge(nodes):
    both(nodes, "PUT", "/life", {"settings": {"number_of_shards": 2},
                                 "mappings": MAPPING})
    q = {"query": {"match": {"title": "w0 w1 w4"}}, "size": 15}
    for batch in range(3):
        lines = docs(20 + batch, 30, "life")
        for line in lines[::2]:
            line["index"]["_id"] += f"-{batch}"
        both(nodes, "POST", "/_bulk", ndjson=lines)
        both(nodes, "POST", "/life/_refresh")
        both(nodes, "POST", "/life/_search", q)
    both(nodes, "DELETE", "/life/_doc/3-0")
    both(nodes, "POST", "/life/_flush")
    both(nodes, "POST", "/life/_forcemerge?max_num_segments=1")
    both(nodes, "POST", "/life/_search", q)
    both(nodes, "GET", "/life/_count")


def test_error_shapes(nodes):
    assert both(nodes, "GET", "/nothing/here/at/all")[0] == 400
    assert both(nodes, "DELETE", "/_cluster/health")[0] == 405
    assert both(nodes, "GET", "/missing/_doc/1")[0] == 404
    assert both(nodes, "PUT", "/books/_doc/1", b"[1, 2]")[0] == 400
    not_ported(nodes, "GET", "/_cat/indices?format=json")
    not_ported(nodes, "GET", "/_nodes/stats")
    not_ported(nodes, "POST", "/_aliases", {"actions": [
        {"add": {"index": "books", "alias": "b"}}]})
    not_ported(nodes, "GET", "/books/_stats")


def test_port_dispatch_maps_device_errors(nodes, monkeypatch):
    """A missing device is a 503; a CUDA fault reaching the REST boundary
    is a 500, never answered from the CPU."""
    _ref, port = nodes
    both(nodes, "PUT", "/dev", {"mappings": MAPPING})
    svc = port.indices.get("dev")

    def no_device(body=None, **kw):
        raise DeviceUnavailableError("CUDA is not available")

    def cuda_fault(body=None, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    for fault, want in ((no_device, 503), (cuda_fault, 500)):
        monkeypatch.setattr(svc, "search", fault)
        status, body = call(port, "POST", "/dev/_search", {})
        assert status == want and body["status"] == want, body


def test_keep_alive_responses_are_not_held_back(nodes):
    """Responses on one keep-alive connection go out at once: the port's
    handler writes without Nagle's delay, which would hold each body
    back for the client's delayed ACK of its headers (~40 ms)."""
    import http.client
    import time

    _ref, port = nodes
    conn = http.client.HTTPConnection("127.0.0.1", port.port, timeout=60)
    try:
        t0 = time.monotonic()
        for _ in range(20):
            conn.request("GET", "/")
            resp = conn.getresponse()
            assert resp.status == 200 and json.loads(resp.read())["name"]
        assert time.monotonic() - t0 < 0.4
    finally:
        conn.close()


def test_in_flight_breaker_refuses_a_large_body(nodes, monkeypatch):
    """A body larger than the ``in_flight_requests`` breaker's room is
    refused with 429 and ``Retry-After`` before it is read; the bytes of
    an admitted body are released after the request."""
    from opensearch_tpu_torch.common.breakers import breaker_service

    _ref, port = nodes
    breaker = breaker_service().in_flight
    monkeypatch.setattr(breaker, "limit", 64)
    tripped = breaker.stats()["tripped"]
    req = urllib.request.Request(
        f"http://127.0.0.1:{port.port}/x/_search", method="POST",
        data=json.dumps({"query": {"match": {"title": "w" * 100}}}).encode(),
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=60)
    assert err.value.code == 429
    assert err.value.headers["Retry-After"] == "1"
    body = json.loads(err.value.read())
    assert body["error"]["type"] == "circuit_breaking_exception"
    assert breaker.stats()["tripped"] == tripped + 1
    assert call(port, "GET", "/_cluster/health")[0] == 200
    assert breaker.used == 0


@pytest.mark.parametrize("payload", [
    {"a": [1, -2, 3.5, None, True, False], "b": {"c": "中文", "d": {}}},
    [], "text", 2 ** 40])
@pytest.mark.parametrize("fmt", ["", "json", "yaml", "cbor"])
def test_xcontent_matches_reference(payload, fmt):
    from opensearch_tpu.common import xcontent as jx
    from opensearch_tpu_torch.common import xcontent as tx

    data, ctype = tx.to_bytes(payload, "", fmt)
    assert (data, ctype) == jx.to_bytes(payload, "", fmt)
    assert tx.from_bytes(data, ctype) == jx.from_bytes(data, ctype) == \
        payload


@pytest.mark.parametrize("call_", [
    lambda x: x.from_bytes(b"{}", "application/smile"),
    lambda x: x.to_bytes({}, "application/smile"),
    lambda x: x.from_bytes(b"{", ""),
    lambda x: x.from_bytes(b"\xa1\x01", "application/cbor"),
    lambda x: x.from_bytes(b"\xbf", "application/cbor")])
def test_xcontent_errors_match_reference(call_):
    from opensearch_tpu.common import xcontent as jx
    from opensearch_tpu_torch.common import xcontent as tx

    errors = []
    for x in (jx, tx):
        with pytest.raises(Exception) as err:
            call_(x)
        errors.append((type(err.value).__name__, err.value.status,
                       str(err.value)))
    assert errors[0] == errors[1]


def test_persistence_across_restart(tmp_path):
    paths = (str(tmp_path / "ref"), str(tmp_path / "port"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbm25, "HOST_SCORING", False)

        def start():
            return (JaxNode(paths[0], port=0).start(),
                    Node(paths[1], port=0, device="cpu").start())

        pair = start()
        try:
            both(pair, "PUT", "/keep", {"settings": {"number_of_shards": 2},
                                        "mappings": MAPPING})
            both(pair, "PUT", "/gone", {})
            both(pair, "POST", "/_bulk", ndjson=docs(31, 40, "keep"))
            both(pair, "POST", "/keep/_flush")
            both(pair, "POST", "/_bulk", ndjson=docs(32, 10, "keep")[:12])
            both(pair, "DELETE", "/gone")
        finally:
            for n in pair:
                n.stop()
            for n in pair:
                n.stop()                      # idempotent
        pair = start()
        try:
            assert both(pair, "HEAD", "/gone")[0] == 404
            both(pair, "GET", "/keep")
            both(pair, "GET", "/keep/_count")
            both(pair, "GET", "/keep/_doc/3")
            both(pair, "POST", "/keep/_search", {
                "query": {"match": {"title": "w1 w2"}}, "size": 20})
        finally:
            for n in pair:
                n.stop()
