"""The reader contexts (scroll, sliced scroll, point in time), the
suggesters and the body keys the searcher ignores, on the PyTorch port's
node (on the CPU) against the JAX package's node, over real HTTP; mirrors
``tests/test_scroll_pit.py`` and the suggester cases of
``tests/test_suggest_rankeval.py``.

Both nodes take the same requests.  Scroll and PIT ids are ``uuid4``
hex, drawn per node: each node's own id is followed, and responses
compare with ``_scroll_id`` / ``pit_id`` masked and ``took`` left out.
The reference scores on its device path (``HOST_SCORING = False``), so
scores compare byte for byte.  Also held: keepalive expiry on an
injected clock (``ReaderContextRegistry`` of both packages), the request
breaker's charge of a scroll (96 bytes a row, so it trips at the
reference's sizes), and ``merge_suggest`` over two indices.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from opensearch_tpu.common.breakers import breaker_service as jax_breakers
from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
from opensearch_tpu.node import Node as JaxNode
from opensearch_tpu.ops import bm25 as jbm25
from opensearch_tpu.search import contexts as jax_contexts
from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
from opensearch_tpu_torch.common.breakers import breaker_service
from opensearch_tpu_torch.index.segment import SegmentWriter
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.node import Node
from opensearch_tpu_torch.search import contexts as port_contexts
from opensearch_tpu_torch.search.executor import ShardSearcher
from opensearch_tpu_torch.testing.parity import profile_shape

N_DOCS = 41
MASKED = frozenset({"took", "_scroll_id", "pit_id"})
WORDS = ["common", "rare", "fox", "quick", "brown", "bear", "fish",
         "quantum", "hunting", "history"]
TITLES = ["the quick brown fox", "quickly running foxes",
          "brown bears fishing", "quantum computing basics",
          "fox hunting history"]


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbm25, "HOST_SCORING", False)
        ref = JaxNode(str(tmp_path_factory.mktemp("ref")), port=0).start()
        port = Node(str(tmp_path_factory.mktemp("port")), port=0,
                    device="cpu").start()
        rng = np.random.default_rng(5)
        lines = []
        for i in range(N_DOCS):
            msg = " ".join(rng.choice(WORDS, size=int(rng.integers(2, 7))))
            lines += [{"index": {"_index": "corpus", "_id": str(i)}},
                      {"msg": msg, "n": int(rng.integers(0, 15)),
                       "tag": ("a", "b", "c")[i % 3]}]
        requests = [
            ("PUT", "/corpus", {"settings": {"number_of_shards": 2},
                                "mappings": {"properties": {
                                    "msg": {"type": "text"},
                                    "n": {"type": "long"},
                                    "tag": {"type": "keyword"}}}}),
            ("POST", "/_bulk", lines),
            ("PUT", "/books", {"mappings": {"properties": {
                "title": {"type": "text"}, "sug": {"type": "completion"}}}}),
            ("PUT", "/books2", {"mappings": {"properties": {
                "title": {"type": "text"}, "sug": {"type": "completion"}}}}),
        ]
        for i, t in enumerate(TITLES):
            requests.append(("PUT", f"/books/_doc/{i}", {
                "title": t, "sug": {"input": [t.split()[1]],
                                    "weight": 3 + i}}))
        requests += [("PUT", "/books2/_doc/x", {
            "title": "quack brown foxes", "sug": {"input": ["quack"],
                                                  "weight": 4}}),
                     ("POST", "/_refresh", None)]
        for n in (ref, port):
            for method, path, body in requests:
                if path == "/_bulk":
                    status, _ = call(n, method, path, ndjson=body)
                else:
                    status, _ = call(n, method, path, body)
                assert status in (200, 201), (path, status)
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


def mask(value):
    if isinstance(value, dict):
        return {k: ("<id>" if k in MASKED - {"took"} else mask(v))
                for k, v in value.items() if k != "took"}
    if isinstance(value, list):
        return [mask(v) for v in value]
    return value


def both(nodes, method, path, body=None, ndjson=None):
    """The same request to both nodes; returns (ref, port) responses
    after asserting them equal with the ids masked."""
    ref, port = (call(n, method, path, body, ndjson) for n in nodes)
    assert ref[0] == port[0], (method, path, ref, port)
    assert json.dumps(mask(ref[1])) == json.dumps(mask(port[1])), \
        (method, path, ref[1], port[1])
    return ref[1], port[1]


def drain(nodes, first):
    """Follow each node's own scroll id to the end, page by page, holding
    every page equal; returns (the port's ids, pages, the last ids)."""
    ref, port = first
    ids = [h["_id"] for h in port["hits"]["hits"]]
    pages = 1
    sids = (ref["_scroll_id"], port["_scroll_id"])
    while True:
        outs = [call(n, "POST", "/_search/scroll",
                     {"scroll": "1m", "scroll_id": sid})
                for n, sid in zip(nodes, sids)]
        assert outs[0][0] == outs[1][0] == 200, outs
        assert json.dumps(mask(outs[0][1])) == json.dumps(mask(outs[1][1]))
        hits = outs[1][1]["hits"]["hits"]
        if not hits:
            return ids, pages, sids
        ids.extend(h["_id"] for h in hits)
        pages += 1
        sids = (outs[0][1]["_scroll_id"], outs[1][1]["_scroll_id"])


@pytest.mark.parametrize("body", [
    {"query": {"match_all": {}}, "size": 7},
    {"query": {"match_all": {}}, "size": 10, "sort": [{"n": "desc"}]},
    {"query": {"match": {"msg": "fox quick"}}, "size": 6},
    {"query": {"term": {"tag": "b"}}, "size": 4, "_source": ["n"],
     "sort": [{"tag": "asc"}, {"n": "asc"}]},
    {"query": {"range": {"n": {"gte": 5}}}, "size": 9,
     "min_score": 0.5},
], ids=["match_all", "sorted", "scored", "keyword_sort", "min_score"])
def test_scroll_matches_reference(nodes, body):
    first = both(nodes, "POST", "/corpus/_search?scroll=1m", body)
    ids, pages, sids = drain(nodes, first)
    assert len(ids) == len(set(ids)) == first[1]["hits"]["total"]["value"]
    ref, port = (call(n, "DELETE", "/_search/scroll", {"scroll_id": [sid]})
                 for n, sid in zip(nodes, sids))
    assert ref == port == (200, {"succeeded": True, "num_freed": 1})
    ref, port = (call(n, "POST", "/_search/scroll",
                      {"scroll": "1m", "scroll_id": sid})
                 for n, sid in zip(nodes, sids))
    assert ref[0] == port[0] == 404


def test_scroll_full_export(nodes):
    first = both(nodes, "POST", "/corpus/_search?scroll=1m",
                 {"query": {"match_all": {}}, "size": 7})
    ids, pages, _sids = drain(nodes, first)
    assert sorted(ids, key=int) == [str(i) for i in range(N_DOCS)]
    assert pages == 6                    # 7 * 5 + 6, then empty


def test_sliced_scroll_partitions(nodes):
    all_ids = []
    for slice_id in range(3):
        first = both(nodes, "POST", "/corpus/_search?scroll=1m", {
            "query": {"match_all": {}}, "size": 4,
            "slice": {"id": slice_id, "max": 3}})
        ids, _p, _s = drain(nodes, first)
        assert ids, f"slice {slice_id} empty"
        assert len(ids) == first[1]["hits"]["total"]["value"]
        all_ids.extend(ids)
    assert len(all_ids) == len(set(all_ids)) == N_DOCS
    for spec in ({"id": 5, "max": 3}, {"id": 0, "max": 1}):
        status = both(nodes, "POST", "/corpus/_search?scroll=1m", {
            "query": {"match_all": {}}, "slice": spec})
        assert status[1]["status"] == 400


def test_scroll_is_point_in_time(nodes):
    first = both(nodes, "POST", "/corpus/_search?scroll=1m",
                 {"query": {"match_all": {}}, "size": 5,
                  "sort": [{"n": "asc"}]})
    both(nodes, "DELETE", "/corpus/_doc/3")
    both(nodes, "POST", "/corpus/_refresh")
    try:
        ids, _pages, _sids = drain(nodes, first)
        assert "3" in ids and len(ids) == N_DOCS
        ref, port = both(nodes, "POST", "/corpus/_search",
                         {"query": {"match_all": {}}, "size": 0})
        assert port["hits"]["total"]["value"] == N_DOCS - 1
    finally:
        both(nodes, "PUT", "/corpus/_doc/3?refresh=true",
             {"msg": "common fox", "n": 3, "tag": "a"})


@pytest.mark.parametrize("path,body", [
    ("/corpus/_search?scroll=1m", {"size": 0}),
    ("/corpus/_search?scroll=1m", {"from": 2}),
    ("/corpus/_search?scroll=1m", {"size": 10001}),
    ("/corpus/_search?scroll=1m&request_cache=true", {}),
    ("/corpus,books/_search?scroll=1m", {}),
    ("/corpus/_search?scroll=soon", {}),
    ("/corpus/_search?scroll=2d", {}),
    ("/_search/scroll", {}),
    ("/_search/scroll", {"scroll_id": "nope"}),
], ids=["size0", "from", "batch", "request_cache", "two_indices",
        "bad_keepalive", "keepalive_too_long", "no_id", "unknown_id"])
def test_scroll_errors_match_reference(nodes, path, body):
    ref, port = (call(n, "POST", path, body) for n in nodes)
    assert ref[0] == port[0] and ref[0] in (400, 404), (ref, port)
    assert ref[1]["error"]["type"] == port[1]["error"]["type"]


def test_clear_scroll_forms(nodes):
    opened = [both(nodes, "POST", "/corpus/_search?scroll=1m",
                   {"size": 3}) for _ in range(3)]
    ref, port = (call(n, "DELETE", f"/_search/scroll/{o[i]['_scroll_id']}")
                 for i, (n, o) in enumerate(zip(nodes, [opened[0]] * 2)))
    assert ref == port == (200, {"succeeded": True, "num_freed": 1})
    ref, port = (call(n, "DELETE", "/_search/scroll", {"scroll_id": "x,y"})
                 for n in nodes)
    assert ref == port and ref[0] == 404
    ref, port = (call(n, "DELETE", "/_search/scroll/_all") for n in nodes)
    assert ref == port and ref[1]["num_freed"] >= 2
    # a PIT id is not a scroll, and a scroll id is not a PIT
    pits = [call(n, "POST", "/corpus/_search/point_in_time?keep_alive=1m")
            [1]["pit_id"] for n in nodes]
    ref, port = (call(n, "POST", "/_search/scroll", {"scroll_id": pit})
                 for n, pit in zip(nodes, pits))
    assert ref[0] == port[0] == 400
    for n, pit in zip(nodes, pits):
        call(n, "DELETE", "/_search/point_in_time", {"pit_id": pit})


def test_pit_isolation_and_search_after(nodes):
    ref, port = both(nodes, "POST",
                     "/corpus/_search/point_in_time?keep_alive=1m")
    pits = (ref["pit_id"], port["pit_id"])
    both(nodes, "PUT", "/corpus/_doc/new", {"msg": "common fresh", "n": 99})
    both(nodes, "DELETE", "/corpus/_doc/7")
    both(nodes, "POST", "/corpus/_refresh")
    try:
        def pit_search(body):
            outs = [call(n, "POST", "/_search", {"pit": {"id": pit}, **body})
                    for n, pit in zip(nodes, pits)]
            assert outs[0][0] == outs[1][0] == 200, outs
            assert json.dumps(mask(outs[0][1])) == \
                json.dumps(mask(outs[1][1]))
            assert outs[1][1]["pit_id"] == pits[1]
            return outs[1][1]

        resp = pit_search({"query": {"match_all": {}}, "size": 100})
        assert resp["hits"]["total"]["value"] == N_DOCS
        resp = pit_search({"query": {"match": {"msg": "common"}},
                           "size": 5, "aggs": {"t": {"terms": {
                               "field": "tag"}}}})
        seen, after = [], None
        while True:
            body = {"query": {"match_all": {}}, "size": 8,
                    "sort": [{"n": "asc"}, {"tag": "desc"}]}
            if after is not None:
                body["search_after"] = after
            hits = pit_search(body)["hits"]["hits"]
            if not hits:
                break
            seen.extend(h["_id"] for h in hits)
            after = hits[-1]["sort"]
        assert len(set(seen)) <= N_DOCS and "new" not in seen
        ref, port = both(nodes, "POST", "/corpus/_search",
                         {"query": {"match_all": {}}, "size": 0})
        assert port["hits"]["total"]["value"] == N_DOCS
    finally:
        both(nodes, "DELETE", "/corpus/_doc/new")
        both(nodes, "PUT", "/corpus/_doc/7?refresh=true",
             {"msg": "common rare", "n": 7, "tag": "b"})
    ref, port = (call(n, "DELETE", "/_search/point_in_time",
                      {"pit_id": [pit]}) for n, pit in zip(nodes, pits))
    assert ref == port == (200, {"succeeded": True, "num_freed": 1})
    ref, port = (call(n, "POST", "/_search", {"pit": {"id": pit}})
                 for n, pit in zip(nodes, pits))
    assert ref[0] == port[0] == 404


@pytest.mark.parametrize("method,path,body", [
    ("POST", "/corpus,books/_search/point_in_time", None),
    ("POST", "/_search", {"pit": {"keep_alive": "1m"}}),
    ("POST", "/corpus/_search/point_in_time?keep_alive=xyz", None),
], ids=["two_indices", "no_id", "bad_keepalive"])
def test_pit_errors_match_reference(nodes, method, path, body):
    ref, port = (call(n, method, path, body) for n in nodes)
    assert ref[0] == port[0] == 400, (ref, port)
    assert ref[1]["error"]["type"] == port[1]["error"]["type"]


@pytest.mark.parametrize("registry", [jax_contexts, port_contexts],
                         ids=["reference", "port"])
def test_registry_keepalive_expiry(registry):
    clock = [0.0]
    reg = registry.ReaderContextRegistry(now_fn=lambda: clock[0])
    cid = reg.open(object(), keepalive_ms=1000)
    assert reg.get(cid) is not None          # touch resets the lease
    clock[0] = 0.9
    assert reg.get(cid) is not None          # 0.9s after touch: alive
    clock[0] = 2.0
    with pytest.raises(registry.SearchContextMissingError):
        reg.get(cid)
    assert reg.count() == 0
    small = registry.ReaderContextRegistry(now_fn=lambda: clock[0],
                                           max_open=1)
    small.open(object(), keepalive_ms=1000)
    with pytest.raises(Exception) as exc:
        small.open(object(), keepalive_ms=1000)
    assert exc.value.status == 400
    assert registry.parse_keepalive("90s") == 90_000
    assert registry.parse_keepalive(None, default_ms=5) == 5


def test_scroll_charges_the_request_breaker(nodes, monkeypatch):
    """An open scroll holds 96 bytes a row against the request breaker
    until it is cleared, and a breaker too small for the cursor answers
    429, at the reference's sizes."""
    breakers = (jax_breakers().request, breaker_service().request)
    before = [b.used for b in breakers]
    ref, port = both(nodes, "POST", "/corpus/_search?scroll=1m",
                     {"query": {"match_all": {}}, "size": 2})
    rows = port["hits"]["total"]["value"]
    assert [b.used - u for b, u in zip(breakers, before)] == [rows * 96] * 2
    for n, sid in zip(nodes, (ref["_scroll_id"], port["_scroll_id"])):
        call(n, "DELETE", "/_search/scroll", {"scroll_id": sid})
    assert [b.used for b in breakers] == before
    for b in breakers:
        monkeypatch.setattr(b, "limit", b.used + rows * 96 - 1)
    outs = [call(n, "POST", "/corpus/_search?scroll=1m",
                 {"query": {"match_all": {}}}) for n in nodes]
    assert outs[0][0] == outs[1][0] == 429, outs
    assert [b.used for b in breakers] == before


@pytest.mark.parametrize("extra", [
    {"post_filter": {"term": {"tag": "a"}}},
    {"track_scores": True},
    {"terminate_after": 3},
    {"version": True},
    {"seq_no_primary_term": True},
    {"indices_boost": [{"corpus": 2.0}]},
    {"script_fields": {"x": {"script": {"source": "1"}}}},
    {"slice": {"id": 0, "max": 2}},
    {"profile": False},
], ids=["post_filter", "track_scores", "terminate_after", "version",
        "seq_no_primary_term", "indices_boost", "script_fields", "slice",
        "profile_false"])
def test_ignored_body_keys_match_reference(nodes, extra):
    """The searcher ignores the keys it does not read, as the
    reference's does; over _search and _msearch."""
    body = {"query": {"match": {"msg": "fox common"}}, "size": 5, **extra}
    ref, port = both(nodes, "POST", "/corpus/_search", body)
    assert port["hits"]["hits"]
    both(nodes, "POST", "/_msearch",
         ndjson=[{"index": "corpus"}, body, {"index": "corpus"},
                 {"query": {"match": {"msg": "rare"}}}])


def test_profile_stays_not_ported(nodes):
    """``profile`` is served since the Profile API is ported (this test
    held that the port answered 501): over ``_search`` and ``_msearch``
    the hits and the profile's shape equal the reference node's."""
    # a body neither node has seen: the caches' attribution agrees too
    body = {"query": {"match_all": {"boost": 1.5}}, "profile": True}
    ref, port = (call(n, "POST", "/corpus/_search", body) for n in nodes)
    assert ref[0] == port[0] == 200, (ref, port)
    assert ref[1]["hits"] == port[1]["hits"]
    assert profile_shape(ref[1], False) == profile_shape(port[1], False)
    lines = [{"index": "corpus"}, body,
             {"index": "corpus"}, {"query": {"match": {"msg": "fox"}},
                                   "profile": True}]
    ref, port = (call(n, "POST", "/_msearch", ndjson=lines) for n in nodes)
    assert ref[0] == port[0] == 200, (ref, port)
    for a, b in zip(ref[1]["responses"], port[1]["responses"]):
        assert a["hits"] == b["hits"]
        assert profile_shape(a, False) == profile_shape(b, False)


# -- suggest -----------------------------------------------------------------

@pytest.mark.parametrize("path,body", [
    ("/books/_search", {"size": 0, "suggest": {"fix": {
        "text": "quik browm", "term": {"field": "title"}}}}),
    ("/books/_search", {"size": 0, "suggest": {"s": {
        "text": "fox", "term": {"field": "title"}}}}),
    ("/books/_search", {"suggest": {"text": "quik fix", "a": {
        "term": {"field": "title", "suggest_mode": "always",
                 "max_edits": 1, "size": 2}},
        "b": {"term": {"field": "title", "suggest_mode": "popular",
                       "prefix_length": 0}}}}),
    ("/books/_search", {"size": 0, "suggest": {"fix": {
        "text": "quik brown fix", "phrase": {
            "field": "title", "max_errors": 2,
            "highlight": {"pre_tag": "<em>", "post_tag": "</em>"}}}}}),
    ("/books/_search", {"query": {"match": {"title": "fox"}},
                        "suggest": {"c": {"prefix": "qu", "completion": {
                            "field": "sug"}}}}),
    ("/books,books2/_search", {"size": 0, "suggest": {
        "fix": {"text": "quik browm", "term": {"field": "title"}},
        "c": {"prefix": "qu", "completion": {"field": "sug",
                                             "size": 3}}}}),
    ("/books/_search", {"suggest": {"s": {"text": "x", "term": {}}}}),
    ("/books/_search", {"suggest": {"s": {"term": {"field": "title"}}}}),
    ("/books/_search", {"suggest": {"s": {"text": "x", "term": {
        "field": "title", "max_edits": 3}}}}),
    ("/books/_search", {"suggest": {"s": {"text": "x", "other": {}}}}),
], ids=["term", "term_in_vocab", "term_modes", "phrase_highlight",
        "completion", "two_indices", "no_field", "no_text", "max_edits",
        "unknown_kind"])
def test_suggest_matches_reference(nodes, path, body):
    ref, port = both(nodes, "POST", path, body)
    if "error" not in port and "suggest" in body:
        assert port["suggest"]


def test_completion_matches_reference():
    """The completion suggester on writer-built segments: weights per
    input, ``skip_duplicates``, ``size``, across two segments."""
    mapping = {"properties": {"sug": {"type": "completion"},
                              "title": {"type": "keyword"}}}
    docs = [("1", {"sug": {"input": ["trial", "trying"], "weight": 10},
                   "title": "a"}),
            ("2", {"sug": {"input": ["tried"], "weight": 5}, "title": "b"}),
            ("3", {"sug": "trick", "title": "c"}),
            ("4", {"sug": [{"input": ["trill"], "weight": 0},
                           {"input": ["other"], "weight": 99}]})]
    searchers = []
    for writer, mapper_cls, searcher_cls, kw in (
            (JaxWriter, JaxMapper, JaxSearcher, {}),
            (SegmentWriter, DocumentMapper, ShardSearcher,
             {"device": "cpu"})):
        mapper = mapper_cls(mapping)
        segs = [writer().build([mapper.parse(i, s) for i, s in docs[k::2]],
                               f"s{k}") for k in range(2)]
        searchers.append(searcher_cls(segs, mapper, **kw))
    for spec in ({"field": "sug"}, {"field": "sug", "skip_duplicates": True},
                 {"field": "sug", "size": 2}):
        body = {"suggest": {"c": {"prefix": "tri", "completion": spec}}}
        ref, got = (s.search(body) for s in searchers)
        assert json.dumps(got["suggest"]) == json.dumps(ref["suggest"])
