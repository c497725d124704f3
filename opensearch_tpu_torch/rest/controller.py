"""REST route table + handlers: the API surface (the port of the JAX
package's ``rest/controller.py``).

Analog of ``rest/RestController.java:250`` (dispatch) and the
``rest/action/**`` handler classes, driven by the same path shapes the
rest-api-spec JSON contract defines.  Transport-agnostic: the HTTP server
calls ``dispatch(method, path, params, body)`` and gets (status, dict).

The route table is the reference's, whole, so the port answers the same
(method, path) pairs.  These handlers are ported: the root and cluster
health; index create, delete, get and exists; mappings and settings;
refresh, flush and force-merge; document index, create, get, exists,
delete and update; ``_bulk``, ``_search``, ``_msearch`` and ``_count``
with the multi-index merge; the four ``/_search/pipeline`` routes and
``?search_pipeline=`` (the named pipeline's normalization-processor
config, handed to a ``hybrid`` query as ``_hybrid_pipeline``).  Every
other route answers 501 through one handler (``h_not_ported``), so a
client tells "not ported" from the 400 of a path with no route.  Inside
the ported handlers, ingest pipelines, point in time, scroll and
cross-cluster search raise ``NotYetPortedError`` (501) too.

``dispatch`` keeps route matching with percent-decoded path parameters,
405 against 400 for a path without a route of that method,
``rest_total_hits_as_int``, and the error mapping: an
``OpenSearchTpuError`` answers its own status and body (``Retry-After``
on a 429; ``DeviceUnavailableError`` is a 503), ``TimeoutError`` and
``ConnectionError`` 503, anything else 500 (a CUDA fault included: it is
not answered from the CPU).  It leaves out the reference's task
registration, tracer spans, search admission, identity, query insights
and QoS ticks (ROADMAP Queue A item 9).
"""

from __future__ import annotations

import json
import logging
import re
import time
from typing import Callable, Optional
from urllib.parse import unquote

from opensearch_tpu_torch.common.errors import (
    DocumentMissingError,
    IllegalArgumentError,
    IndexNotFoundError,
    NotYetPortedError,
    OpenSearchTpuError,
    ParsingError,
    ValidationError,
    VersionConflictError,
)
from opensearch_tpu_torch.common.xcontent import from_bytes
from opensearch_tpu_torch.indices.service import deep_merge_doc
from opensearch_tpu_torch.search.executor import merge_hit_rows
from opensearch_tpu_torch.search.fetch import filter_source
from opensearch_tpu_torch.version import __version__ as VERSION

_log = logging.getLogger("opensearch_tpu_torch.rest")


class RestRequest:
    def __init__(self, method: str, path: str, params: dict,
                 body: Optional[bytes], content_type: str = ""):
        self.method = method
        self.path = path
        self.params = params or {}
        self.raw_body = body or b""
        self.content_type = content_type
        self.path_params: dict[str, str] = {}

    def json(self, default=None):
        """Structured body, negotiated by Content-Type (JSON default;
        YAML/CBOR via x-content, ref libs/x-content XContentType)."""
        if not self.raw_body:
            return default
        return from_bytes(self.raw_body, self.content_type)

    def param(self, name: str, default=None):
        return self.params.get(name, self.path_params.get(name, default))

    def int_param(self, name: str):
        """Integer query param, or None when absent — garbage is a
        typed 400 (the reference's number_format_exception), never a
        raw ValueError 500."""
        v = self.param(name)
        if v is None:
            return None
        try:
            return int(v)
        except (TypeError, ValueError):
            raise IllegalArgumentError(
                f"[{name}] must be an integer, got [{v}]")


def _total_hits_as_int(resp: dict):
    """?rest_total_hits_as_int=true: render hits.total as the pre-7.0
    integer (RestSearchAction.TOTAL_HITS_AS_INT_PARAM), including per
    sub-response in _msearch."""
    hits = resp.get("hits")
    if isinstance(hits, dict) and isinstance(hits.get("total"), dict):
        hits["total"] = hits["total"].get("value", 0)
    for sub in resp.get("responses") or []:
        if isinstance(sub, dict):
            _total_hits_as_int(sub)


class Route:
    def __init__(self, method: str, pattern: str, handler: Callable):
        self.method = method
        parts = []
        self.names: list[str] = []
        for seg in pattern.strip("/").split("/"):
            if seg.startswith("{"):
                self.names.append(seg[1:-1])
                parts.append(r"([^/]+)")
            else:
                parts.append(re.escape(seg))
        self.rx = re.compile("^/" + "/".join(parts) + "$")
        self.handler = handler


class RestController:
    def __init__(self, node):
        self.node = node
        self.routes: list[Route] = []
        self._register_all()

    def register(self, method: str, pattern: str, handler: Callable):
        self.routes.append(Route(method, pattern, handler))

    def dispatch(self, method: str, path: str, params: dict,
                 body: Optional[bytes], content_type: str = "",
                 response_headers: Optional[dict] = None
                 ) -> tuple[int, dict]:
        """``response_headers``: optional out-channel the HTTP layer
        passes so error mappings can attach headers (Retry-After on a
        429) without changing the return shape."""
        req = RestRequest(method, path, params, body, content_type)
        try:
            for route in self.routes:
                if route.method != method:
                    continue
                m = route.rx.match(path.rstrip("/") or "/")
                if m:
                    # percent-decode captured segments: /index/_doc/中文
                    # arrives as %E4%B8%AD%E6%96%87 (RestRequest.java
                    # decodes the same way)
                    req.path_params = dict(zip(
                        route.names, (unquote(g) for g in m.groups())))
                    status, resp = route.handler(req)
                    if params.get("rest_total_hits_as_int") == "true" \
                            and isinstance(resp, dict):
                        _total_hits_as_int(resp)
                    return status, resp
            # method-mismatch vs not-found distinction
            if any(r.rx.match(path.rstrip("/") or "/") for r in self.routes):
                return 405, {"error": f"Incorrect HTTP method for uri [{path}]"
                                      f" and method [{method}]", "status": 405}
            return 400, {"error": {
                "type": "illegal_argument_exception",
                "reason": f"no handler found for uri [{path}] and method "
                          f"[{method}]"}, "status": 400}
        except OpenSearchTpuError as e:
            if e.status == 429 and response_headers is not None:
                # every 429 carries the hint: a hintless 429 leaves
                # clients guessing
                response_headers["Retry-After"] = str(
                    int(getattr(e, "retry_after_seconds", 1)))
            return e.status, e.to_xcontent()
        except (TimeoutError, ConnectionError) as e:
            # stdlib-level transport failures: retryable, 503
            return 503, {"error": {"type": "node_disconnected_exception",
                                   "reason": f"{type(e).__name__}: {e}"},
                         "status": 503}
        except Exception as e:  # noqa: BLE001 — the REST boundary
            _log.exception("unhandled error serving [%s %s]", method, path)
            return 500, {"error": {"type": "internal_server_error",
                                   "reason": f"{type(e).__name__}: {e}"},
                         "status": 500}

    def h_not_ported(self, req):
        """Every route of the reference whose handler is not ported."""
        raise NotYetPortedError(
            f"[{req.method} {req.path}] is not ported to the torch package "
            "yet")

    # ------------------------------------------------------------------

    def _register_all(self):
        r = self.register
        n = self.h_not_ported
        r("GET", "/", self.h_root)
        r("GET", "/_cluster/health", self.h_cluster_health)
        r("GET", "/_cluster/state", n)
        r("GET", "/_cluster/stats", n)
        r("GET", "/_nodes", n)
        r("GET", "/_nodes/stats", n)
        r("GET", "/_nodes/trace", n)
        r("GET", "/_nodes/hot_threads", n)
        r("GET", "/_nodes/flight_recorder", n)
        r("GET", "/_insights/top_queries", n)
        r("GET", "/_metrics", n)
        r("GET", "/_cluster/settings", n)
        r("PUT", "/_cluster/settings", n)
        r("GET", "/_cat/indices", n)
        r("GET", "/_cat/health", n)
        r("GET", "/_cat/count", n)
        r("GET", "/_cat/count/{index}", n)
        r("GET", "/_cat/shards", n)
        r("GET", "/_cat/nodes", n)
        r("GET", "/_cat/aliases", n)
        r("GET", "/_cat/templates", n)
        r("GET", "/_cat/segments", n)
        r("GET", "/_cat/recovery", n)
        r("GET", "/_cat/recovery/{index}", n)
        r("GET", "/_cat/repositories", n)
        r("GET", "/_cat/snapshots/{repo}", n)
        r("GET", "/_cat/tasks", n)
        r("GET", "/_cat/thread_pool", n)
        r("GET", "/_cat/pending_tasks", n)
        r("GET", "/_cat/plugins", n)
        r("GET", "/_cat/cluster_manager", n)
        r("GET", "/_cat/master", n)
        r("GET", "/_cat/nodeattrs", n)
        r("GET", "/_cat/allocation", n)
        r("GET", "/_cat/fielddata", n)
        r("POST", "/_aliases", n)
        r("GET", "/_alias", n)
        r("GET", "/_alias/{name}", n)
        r("HEAD", "/_alias/{name}", n)
        r("GET", "/{index}/_alias", n)
        r("PUT", "/{index}/_alias/{name}", n)
        r("POST", "/{index}/_alias/{name}", n)
        r("DELETE", "/{index}/_alias/{name}", n)
        r("POST", "/{index}/_rollover", n)
        r("POST", "/{index}/_rollover/{target}", n)
        r("PUT", "/{index}/_shrink/{target}", n)
        r("POST", "/{index}/_shrink/{target}", n)
        r("PUT", "/{index}/_split/{target}", n)
        r("POST", "/{index}/_split/{target}", n)
        r("PUT", "/{index}/_clone/{target}", n)
        r("POST", "/{index}/_clone/{target}", n)
        r("GET", "/{index}/_recovery", n)
        r("GET", "/_recovery", n)
        r("PUT", "/_data_stream/{name}", n)
        r("GET", "/_data_stream", n)
        r("GET", "/_data_stream/{name}", n)
        r("DELETE", "/_data_stream/{name}", n)
        r("POST", "/_cluster/reroute", n)
        r("PUT", "/_index_template/{name}", n)
        r("POST", "/_index_template/{name}", n)
        r("GET", "/_index_template", n)
        r("GET", "/_index_template/{name}", n)
        r("DELETE", "/_index_template/{name}", n)
        r("GET", "/_rank_eval", n)
        r("POST", "/_rank_eval", n)
        r("GET", "/{index}/_rank_eval", n)
        r("POST", "/{index}/_rank_eval", n)
        r("POST", "/_reindex", n)
        r("POST", "/{index}/_update_by_query", n)
        r("POST", "/{index}/_delete_by_query", n)
        r("GET", "/_field_caps", n)
        r("POST", "/_field_caps", n)
        r("GET", "/{index}/_field_caps", n)
        r("POST", "/{index}/_field_caps", n)
        r("GET", "/{index}/_termvectors/{id}", n)
        r("POST", "/{index}/_termvectors/{id}", n)
        r("PUT", "/_ingest/pipeline/{id}", n)
        r("GET", "/_ingest/pipeline", n)
        r("GET", "/_ingest/pipeline/{id}", n)
        r("DELETE", "/_ingest/pipeline/{id}", n)
        r("POST", "/_ingest/pipeline/{id}/_simulate", n)
        r("POST", "/_ingest/pipeline/_simulate", n)
        r("GET", "/_analyze", n)
        r("POST", "/_analyze", n)
        r("GET", "/{index}/_analyze", n)
        r("POST", "/{index}/_analyze", n)
        r("POST", "/_bulk", self.h_bulk)
        r("PUT", "/_bulk", self.h_bulk)
        r("POST", "/{index}/_bulk", self.h_bulk)
        r("PUT", "/{index}/_bulk", self.h_bulk)
        r("GET", "/_search", self.h_search)
        r("POST", "/_search", self.h_search)
        r("GET", "/_msearch", self.h_msearch)
        r("POST", "/_msearch", self.h_msearch)
        r("GET", "/_search/scroll", n)
        r("POST", "/_search/scroll", n)
        r("GET", "/_search/scroll/{scroll_id}", n)
        r("POST", "/_search/scroll/{scroll_id}", n)
        r("DELETE", "/_search/scroll/_all", n)
        r("DELETE", "/_search/scroll", n)
        r("DELETE", "/_search/scroll/{scroll_id}", n)
        r("DELETE", "/_search/point_in_time", n)
        r("GET", "/_search/pipeline", self.h_get_pipelines)
        r("GET", "/_search/pipeline/{id}", self.h_get_pipeline)
        r("PUT", "/_search/pipeline/{id}", self.h_put_pipeline)
        r("DELETE", "/_search/pipeline/{id}", self.h_delete_pipeline)
        r("GET", "/_count", self.h_count)
        r("POST", "/_count", self.h_count)
        r("GET", "/_mapping", n)
        r("GET", "/_refresh", self.h_refresh)
        r("POST", "/_refresh", self.h_refresh)
        r("GET", "/_security/user", n)
        r("PUT", "/_security/user/{username}", n)
        r("DELETE", "/_security/user/{username}", n)
        r("GET", "/_tasks", n)
        r("GET", "/_persistent_tasks", n)
        r("GET", "/_tasks/{task_id}", n)
        r("POST", "/_tasks/{task_id}/_cancel", n)
        r("POST", "/_tasks/_cancel", n)
        r("POST", "/_remotestore/_restore", n)
        r("GET", "/_snapshot", n)
        r("PUT", "/_snapshot/{repo}", n)
        r("POST", "/_snapshot/{repo}", n)
        r("GET", "/_snapshot/{repo}", n)
        r("DELETE", "/_snapshot/{repo}", n)
        r("PUT", "/_snapshot/{repo}/{snapshot}", n)
        r("POST", "/_snapshot/{repo}/{snapshot}", n)
        r("GET", "/_snapshot/{repo}/{snapshot}", n)
        r("DELETE", "/_snapshot/{repo}/{snapshot}", n)
        r("POST", "/_snapshot/{repo}/{snapshot}/_restore", n)

        r("PUT", "/{index}", self.h_create_index)
        r("DELETE", "/{index}", self.h_delete_index)
        r("GET", "/{index}", self.h_get_index)
        r("HEAD", "/{index}", self.h_index_exists)
        r("GET", "/{index}/_mapping", self.h_get_mapping)
        r("PUT", "/{index}/_mapping", self.h_put_mapping)
        r("GET", "/{index}/_settings", self.h_get_settings)
        r("PUT", "/{index}/_settings", n)
        r("GET", "/{index}/_stats", n)
        r("POST", "/{index}/_refresh", self.h_refresh)
        r("GET", "/{index}/_refresh", self.h_refresh)
        r("POST", "/_cache/clear", n)
        r("POST", "/{index}/_cache/clear", n)
        r("POST", "/{index}/_flush", self.h_flush)
        r("POST", "/{index}/_forcemerge", self.h_forcemerge)
        r("GET", "/{index}/_count", self.h_count)
        r("POST", "/{index}/_count", self.h_count)
        r("GET", "/{index}/_search", self.h_search)
        r("POST", "/{index}/_search", self.h_search)
        r("GET", "/{index}/_msearch", self.h_msearch)
        r("POST", "/{index}/_msearch", self.h_msearch)
        r("POST", "/{index}/_search/point_in_time", n)
        r("POST", "/{index}/_doc", self.h_index_doc_auto)
        r("PUT", "/{index}/_doc/{id}", self.h_index_doc)
        r("POST", "/{index}/_doc/{id}", self.h_index_doc)
        r("GET", "/{index}/_doc/{id}", self.h_get_doc)
        r("HEAD", "/{index}/_doc/{id}", self.h_doc_exists)
        r("DELETE", "/{index}/_doc/{id}", self.h_delete_doc)
        r("GET", "/{index}/_source/{id}", n)
        r("PUT", "/{index}/_create/{id}", self.h_create_doc)
        r("POST", "/{index}/_create/{id}", self.h_create_doc)
        r("POST", "/{index}/_update/{id}", self.h_update_doc)
        r("POST", "/_mget", n)
        r("POST", "/{index}/_mget", n)
        r("GET", "/{index}/_mget", n)

    # -- info / cluster ----------------------------------------------------

    def h_root(self, req):
        return 200, {
            "name": self.node.name,
            "cluster_name": self.node.cluster_name,
            "cluster_uuid": self.node.cluster_uuid,
            "version": {"number": VERSION,
                        "distribution": "opensearch-tpu"},
            "tagline": "The OpenSearch Project: https://opensearch.org/",
        }

    def h_cluster_health(self, req):
        indices = self.node.indices.indices
        unassigned = sum(s.num_replicas * s.num_shards
                         for s in indices.values())
        active = sum(s.num_shards for s in indices.values())
        status = "yellow" if unassigned else "green"
        # a shard copy that failed store verification (corruption marker
        # on disk) makes the cluster red
        corrupted = {name: sorted(svc.corrupted_shards())
                     for name, svc in indices.items()
                     if svc.corrupted_shards()}
        if corrupted:
            status = "red"
        extra = ({"corrupted_shards": sum(len(v)
                                          for v in corrupted.values())}
                 if corrupted else {})
        return 200, {
            **extra,
            "cluster_name": self.node.cluster_name,
            "status": status,
            "timed_out": False,
            "discovered_master": True,
            "discovered_cluster_manager": True,
            "number_of_nodes": 1,
            "number_of_data_nodes": 1,
            "active_primary_shards": active,
            "active_shards": active,
            "relocating_shards": 0,
            "initializing_shards": 0,
            "unassigned_shards": unassigned,
            "delayed_unassigned_shards": 0,
            "number_of_pending_tasks": 0,
            "number_of_in_flight_fetch": 0,
            "task_max_waiting_in_queue_millis": 0,
            "active_shards_percent_as_number": 100.0,
            **self._health_indices_level(req, indices),
        }

    def _health_indices_level(self, req, indices) -> dict:
        """?level=indices|shards adds the per-index (and per-shard)
        breakdown (ClusterHealthResponse levels)."""
        level = req.param("level", "cluster")
        if level not in ("indices", "shards"):
            return {}
        out = {}
        for name, svc in indices.items():
            st = "yellow" if svc.num_replicas else "green"
            entry = {
                "status": st,
                "number_of_shards": svc.num_shards,
                "number_of_replicas": svc.num_replicas,
                "active_primary_shards": svc.num_shards,
                "active_shards": svc.num_shards,
                "relocating_shards": 0,
                "initializing_shards": 0,
                "unassigned_shards": svc.num_replicas * svc.num_shards,
            }
            if level == "shards":
                entry["shards"] = {
                    str(i): {"status": st, "primary_active": True,
                             "active_shards": 1, "relocating_shards": 0,
                             "initializing_shards": 0,
                             "unassigned_shards": svc.num_replicas}
                    for i in range(svc.num_shards)}
            out[name] = entry
        return {"indices": out}

    # -- index admin -------------------------------------------------------

    def h_create_index(self, req):
        name = req.path_params["index"]
        self.node.indices.create(name, req.json({}))
        return 200, {"acknowledged": True, "shards_acknowledged": True,
                     "index": name}

    def h_delete_index(self, req):
        for svc in self.node.indices.resolve(req.path_params["index"]):
            self.node.indices.delete(svc.name)
        return 200, {"acknowledged": True}

    def h_get_index(self, req):
        svc = self.node.indices.get(req.path_params["index"])
        # no index has an alias here: aliases are not ported
        return 200, {svc.name: {"aliases": {}, **svc.get_mapping(),
                                **svc.get_settings()}}

    def h_index_exists(self, req):
        if self.node.indices.exists(req.path_params["index"]):
            return 200, {}
        return 404, {}

    def h_get_mapping(self, req):
        svc = self.node.indices.get(req.path_params["index"])
        return 200, {svc.name: svc.get_mapping()}

    def h_put_mapping(self, req):
        svc = self.node.indices.get(req.path_params["index"])
        svc.put_mapping(req.json({}))
        return 200, {"acknowledged": True}

    def h_get_settings(self, req):
        svc = self.node.indices.get(req.path_params["index"])
        return 200, {svc.name: svc.get_settings()}

    def h_refresh(self, req):
        services = self._target_indices(req)
        for svc in services:
            svc.refresh()
        n = sum(s.num_shards for s in services)
        return 200, {"_shards": {"total": n, "successful": n, "failed": 0}}

    def h_flush(self, req):
        svc = self.node.indices.get(req.path_params["index"])
        svc.flush()
        return 200, {"_shards": {"total": svc.num_shards,
                                 "successful": svc.num_shards, "failed": 0}}

    def h_forcemerge(self, req):
        svc = self.node.indices.get(req.path_params["index"])
        svc.force_merge(int(req.param("max_num_segments", 1)))
        return 200, {"_shards": {"total": svc.num_shards,
                                 "successful": svc.num_shards, "failed": 0}}

    # -- documents ---------------------------------------------------------

    @staticmethod
    def _refuse_pipeline(req, svc=None):
        """Ingest pipelines are not ported: a write that a pipeline would
        transform (``?pipeline=``, or the index's ``default_pipeline``
        unless ``?pipeline=_none``) raises before anything is written."""
        pid = req.param("pipeline")
        if not pid and svc is not None:
            pid = svc.settings.get("default_pipeline")
        if pid and pid != "_none":
            raise NotYetPortedError(
                "ingest pipelines are not ported to the torch package yet")

    @staticmethod
    def _bulk_source_param(req):
        """URL-level _source/_source_includes/_source_excludes default
        for bulk update items."""
        if req.param("_source") is not None:
            return req.param("_source")
        inc = req.param("_source_includes")
        exc = req.param("_source_excludes")
        if inc or exc:
            spec = {}
            if inc:
                spec["includes"] = inc.split(",")
            if exc:
                spec["excludes"] = exc.split(",")
            return spec
        return None

    def _maybe_refresh(self, svc, req, doc_id=None) -> bool:
        refresh = req.param("refresh")
        if refresh is not None and str(refresh).lower() in ("", "true",
                                                            "wait_for"):
            if doc_id is not None:
                # a single-doc write refreshes only its owning shard
                svc.refresh_doc_shard(str(doc_id), req.param("routing"))
            else:
                svc.refresh()
            # wait_for reports forced_refresh=false (the write merely
            # waited); an explicit refresh reports true
            return str(refresh).lower() != "wait_for"
        return False

    def h_index_doc(self, req, doc_id=None, op_type=None):
        name = req.path_params["index"]
        svc = self.node.indices.get_or_create(name)
        doc_id = doc_id or req.path_params.get("id")
        if doc_id is not None and len(str(doc_id).encode("utf-8")) > 512:
            raise ValidationError(
                f"id is too long, must be no longer than 512 bytes but "
                f"was: {len(str(doc_id).encode('utf-8'))}")
        source = req.json()
        if not isinstance(source, dict):
            raise ParsingError("request body is required and must be a JSON "
                               "object")
        self._refuse_pipeline(req, svc)
        kw = {}
        if req.param("if_seq_no") is not None:
            kw["if_seq_no"] = req.int_param("if_seq_no")
        if req.param("if_primary_term") is not None:
            kw["if_primary_term"] = req.int_param("if_primary_term")
        if req.param("version") is not None:
            kw["version"] = req.int_param("version")
            kw["version_type"] = req.param("version_type", "internal")
        if ((op_type or req.param("op_type")) == "create"
                and kw.get("version_type", "internal") != "internal"):
            raise ValidationError(
                "Validation Failed: 1: create operations only support "
                "internal versioning. use index instead;")
        if (op_type or req.param("op_type")) == "create" and doc_id is not None:
            if svc.get_doc(doc_id, req.param("routing")) is not None:
                raise VersionConflictError(doc_id, "document to be absent",
                                           "exists")
        r = svc.index_doc(doc_id, source, routing=req.param("routing"), **kw)
        forced = self._maybe_refresh(svc, req, doc_id=r.doc_id)
        status = 201 if r.result == "created" else 200
        out = {"_index": svc.name, "_id": r.doc_id,
               "_version": r.version, "_seq_no": r.seq_no,
               "_primary_term": r.primary_term, "result": r.result,
               "_shards": {"total": 1, "successful": 1, "failed": 0}}
        if forced:
            out["forced_refresh"] = True
        return status, out

    def h_index_doc_auto(self, req):
        return self.h_index_doc(req, doc_id=None)

    def h_create_doc(self, req):
        return self.h_index_doc(req, op_type="create")

    def h_get_doc(self, req):
        name = req.path_params["index"]
        svc = self._single_index(name)
        doc = svc.get_doc(req.path_params["id"], req.param("routing"),
                          realtime=req.param("realtime", "true") != "false")
        if doc is None:
            return 404, {"_index": name, "_id": req.path_params["id"],
                         "found": False}
        if req.param("version") is not None \
                and req.int_param("version") != doc["_version"]:
            raise VersionConflictError(req.path_params["id"],
                                       req.param("version"),
                                       doc["_version"])
        return 200, {"_index": name, **doc}

    def h_doc_exists(self, req):
        svc = self._single_index(req.path_params["index"])
        doc = svc.get_doc(req.path_params["id"], req.param("routing"))
        return (200, {}) if doc is not None else (404, {})

    def h_delete_doc(self, req):
        name = req.path_params["index"]
        svc = self._single_index(name)
        kw = {}
        if req.param("if_seq_no") is not None:
            kw["if_seq_no"] = req.int_param("if_seq_no")
        if req.param("if_primary_term") is not None:
            kw["if_primary_term"] = req.int_param("if_primary_term")
        if req.param("version") is not None:
            kw["version"] = req.int_param("version")
            kw["version_type"] = req.param("version_type", "internal")
        r = svc.delete_doc(req.path_params["id"],
                           routing=req.param("routing"), **kw)
        forced = self._maybe_refresh(svc, req, doc_id=r.doc_id)
        if r.result == "not_found":
            return 404, {"_index": name, "_id": r.doc_id,
                         "result": "not_found",
                         "_shards": {"total": 1, "successful": 1,
                                     "failed": 0}}
        out = {"_index": name, "_id": r.doc_id, "_version": r.version,
               "_seq_no": r.seq_no, "_primary_term": r.primary_term,
               "result": "deleted",
               "_shards": {"total": 1, "successful": 1, "failed": 0}}
        if forced:
            out["forced_refresh"] = True
        return 200, out

    def h_update_doc(self, req):
        name = req.path_params["index"]
        svc = self.node.indices.get_or_create(name)
        body = req.json({})
        doc_id = req.path_params["id"]
        cur = svc.get_doc(doc_id, req.param("routing"))
        created = cur is None
        kw = {}
        if req.param("if_seq_no") is not None:
            kw["if_seq_no"] = req.int_param("if_seq_no")
        if req.param("if_primary_term") is not None:
            kw["if_primary_term"] = req.int_param("if_primary_term")
        if kw and cur is None and "upsert" not in body \
                and not body.get("doc_as_upsert"):
            # CAS on a missing doc is document_missing, not a conflict
            raise DocumentMissingError(name, doc_id)
        if kw and cur is not None:
            # CAS params check against the CURRENT doc before any noop
            # short-circuit (UpdateHelper applies them to the write)
            cur_seq = cur["_seq_no"]
            cur_term = cur.get("_primary_term", 1)
            if kw.get("if_seq_no") is not None \
                    and kw["if_seq_no"] != cur_seq:
                raise VersionConflictError(
                    doc_id, f"seq_no [{kw['if_seq_no']}]",
                    f"seq_no [{cur_seq}]")
            if kw.get("if_primary_term") is not None \
                    and kw["if_primary_term"] != cur_term:
                raise VersionConflictError(
                    doc_id, f"primary_term [{kw['if_primary_term']}]",
                    f"primary_term [{cur_term}]")
        if cur is None:
            if "upsert" in body:
                merged = body["upsert"]
            elif body.get("doc_as_upsert") and "doc" in body:
                merged = body["doc"]
            else:
                raise DocumentMissingError(name, doc_id)
        else:
            if "doc" not in body:
                raise ValidationError("[_update] requires a [doc] or "
                                      "[upsert] section")
            if "_source" not in cur:
                raise ValidationError(
                    f"[{name}][{doc_id}]: source is missing — partial "
                    "updates require [_source] to be enabled")
            merged = deep_merge_doc(cur["_source"], body["doc"])
            # detect_noop (default true): an update that changes nothing
            # neither bumps the version nor writes (UpdateHelper.java)
            if merged == cur["_source"] and body.get("detect_noop", True):
                out = {"_index": name, "_id": doc_id,
                       "_version": cur["_version"],
                       "_seq_no": cur["_seq_no"],
                       "result": "noop",
                       "_shards": {"total": 0, "successful": 0,
                                   "failed": 0}}
                self._update_get_section(req, out, cur)
                return 200, out
        r = svc.index_doc(doc_id, merged, routing=req.param("routing"), **kw)
        forced = self._maybe_refresh(svc, req, doc_id=r.doc_id)
        out = {"_index": name, "_id": r.doc_id, "_version": r.version,
               "_seq_no": r.seq_no, "_primary_term": r.primary_term,
               "result": "created" if created else "updated",
               "_shards": {"total": 1, "successful": 1, "failed": 0}}
        if forced:
            out["forced_refresh"] = True
        self._update_get_section(
            req, out, svc.get_doc(doc_id, req.param("routing")))
        return 200, out

    @staticmethod
    def _update_get_section(req, out, doc):
        """?_source=... on _update returns the post-update doc inline
        (UpdateResponse.getGetResult)."""
        spec = req.param("_source")
        if spec is None or doc is None:
            return
        if spec in ("", "true", "false"):
            spec = spec != "false"
        else:
            spec = spec.split(",")
        src = filter_source(doc.get("_source"), spec)
        get = {"found": True, "_seq_no": doc["_seq_no"],
               "_primary_term": doc.get("_primary_term", 1)}
        if src is not None:
            get["_source"] = src
        out["get"] = get

    # -- bulk --------------------------------------------------------------

    def h_bulk(self, req):
        default_index = req.path_params.get("index")
        lines = req.raw_body.split(b"\n")
        ops_by_index: dict[str, list] = {}
        order: list[tuple[str, int]] = []
        i = 0
        while i < len(lines):
            line = lines[i].strip()
            i += 1
            if not line:
                continue
            try:
                action_line = json.loads(line)
            except json.JSONDecodeError as e:
                raise ParsingError(f"malformed action/metadata line: {e}")
            if len(action_line) != 1:
                raise ParsingError("action/metadata line must contain a "
                                   "single action")
            action, meta = next(iter(action_line.items()))
            if action not in ("index", "create", "delete", "update"):
                raise ParsingError(f"unknown bulk action [{action}]")
            if action == "index" and meta.get("op_type") == "create":
                action = "create"    # renders as a create item, with
                # create's already-exists conflict semantics
            if meta.get("pipeline") not in (None, "_none"):
                raise NotYetPortedError(
                    "ingest pipelines are not ported to the torch package "
                    "yet")
            name = meta.get("_index", default_index)
            if name is None:
                raise ValidationError("bulk item requires _index")
            source = None
            if action != "delete":
                if i >= len(lines):
                    raise ParsingError("bulk request ends with an action "
                                       "line and no source")
                try:
                    source = json.loads(lines[i])
                except json.JSONDecodeError as e:
                    raise ParsingError(f"malformed bulk source line: {e}")
                i += 1
            if meta.get("require_alias",
                        req.param("require_alias") == "true"):
                # no name is an alias here: aliases are not ported
                bucket = ops_by_index.setdefault("\x00err", [])
                order.append(("\x00err", len(bucket)))
                bucket.append({action: {
                    "_index": name, "_id": meta.get("_id"), "status": 404,
                    "error": {"type": "index_not_found_exception",
                              "reason": f"no such index [{name}] and "
                                        "[require_alias] request flag is "
                                        f"[true] and [{name}] is not an "
                                        "alias"}}})
                continue
            bucket = ops_by_index.setdefault(name, [])
            order.append((name, len(bucket)))
            bucket.append((action, meta.get("_id"), source,
                           {"routing": meta.get("routing",
                                                meta.get("_routing")),
                            "if_seq_no": meta.get("if_seq_no"),
                            "if_primary_term": meta.get(
                                "if_primary_term"),
                            "_source": meta.get(
                                "_source", self._bulk_source_param(req))}))
        for name in ops_by_index:
            self._refuse_pipeline(req, self.node.indices.indices.get(name))
        results_by_index = {}
        t0 = time.monotonic()
        for name, ops in ops_by_index.items():
            if name == "\x00err":     # pre-cooked require_alias failures
                results_by_index[name] = ops
                continue
            try:
                svc = self.node.indices.get_or_create(name)
            except OpenSearchTpuError as e:
                # unresolvable write target (e.g. an invalid index name):
                # item-level errors, never a request failure
                results_by_index[name] = [{action: {
                    "_index": name, "_id": doc_id, "status": 400,
                    "error": {"type": "illegal_argument_exception",
                              "reason": e.reason}}}
                    for action, doc_id, _s, _kw in ops]
                continue
            results_by_index[name] = svc.bulk(ops)
            if req.param("refresh") in ("", "true", "wait_for"):
                svc.refresh()
        items = [results_by_index[name][j] for name, j in order]
        errors = any(next(iter(it.values())).get("error") for it in items)
        took = int((time.monotonic() - t0) * 1000)
        return 200, {"took": took, "errors": errors, "items": items}

    # -- search ------------------------------------------------------------

    def _target_indices(self, req) -> list:
        expr = req.path_params.get("index")
        if expr is None:
            return list(self.node.indices.indices.values())
        return self.node.indices.resolve(expr)

    def _target_indices_filtered(self, req) -> list:
        """[(svc, alias_filter|None)] for search-style requests."""
        expr = req.path_params.get("index")
        if expr is None:
            return [(s, None)
                    for s in self.node.indices.indices.values()]
        return self.node.indices.resolve_with_filters(expr)

    @staticmethod
    def _apply_alias_filter(body: dict, flt) -> dict:
        """AND an alias filter into the request query (the reference
        applies alias filters inside QueryShardContext)."""
        if flt is None:
            return body
        out = dict(body)
        q = body.get("query")
        out["query"] = {"bool": {"must": [q] if q else [],
                                 "filter": [flt]}}
        return out

    def _single_index(self, name: str):
        """Exactly-one-index resolution for doc-level APIs."""
        svcs = self.node.indices.resolve(name)
        if len(svcs) != 1:
            raise ValidationError(
                f"[{name}] resolves to {len(svcs)} indices — doc "
                "operations require exactly one")
        return svcs[0]

    def h_msearch(self, req):
        """NDJSON multi-search (RestMultiSearchAction analog): alternating
        header/body lines; header may name an index, else the URL index
        applies.  Same-index runs batch through ``IndexService.msearch``
        (one K3 launch per query group on CUDA, search/batch.py)."""
        lines = [ln for ln in req.raw_body.split(b"\n") if ln.strip()]
        if len(lines) % 2 != 0:
            raise ValidationError(
                "_msearch body must be alternating header/body NDJSON lines")
        default_index = req.path_params.get("index")
        requests = []            # (index_name, body)
        for i in range(0, len(lines), 2):
            try:
                header = json.loads(lines[i])
                body = json.loads(lines[i + 1])
            except json.JSONDecodeError as e:
                raise ParsingError(f"invalid _msearch NDJSON: {e}") from e
            index = header.get("index") or default_index
            if index is None:
                raise ValidationError(
                    "_msearch header must name an [index] when the URL "
                    "does not")
            requests.append((index, body))
        # group per index expression so same-index bursts batch; errors
        # are PER sub-request (the _msearch contract: one bad body never
        # fails its neighbours)
        responses: list = [None] * len(requests)
        by_index: dict[str, list[int]] = {}
        for pos, (index, _b) in enumerate(requests):
            by_index.setdefault(index, []).append(pos)

        def err_of(e):
            err = {"error": {"type": e.error_type, "reason": e.reason},
                   "status": e.status}
            if e.status == 429:
                # sub-responses can't carry headers (the envelope is
                # 200), so the Retry-After hint rides in the body
                err["error"]["retry_after_seconds"] = int(
                    getattr(e, "retry_after_seconds", 1))
            return err

        for index, positions in by_index.items():
            try:
                svcs = self.node.indices.resolve(index)
                if not svcs:
                    raise IndexNotFoundError(index)
            except OpenSearchTpuError as e:
                for p in positions:
                    responses[p] = err_of(e)
                continue
            bodies = [requests[p][1] for p in positions]
            results = None
            if len(svcs) == 1:
                try:
                    results = svcs[0].msearch(bodies)
                except OpenSearchTpuError:
                    results = None       # retry body-by-body below
            if results is not None:
                for p, r in zip(positions, results):
                    r["status"] = 200
                    responses[p] = r
                continue
            for p, body in zip(positions, bodies):
                try:
                    r = (svcs[0].search(body) if len(svcs) == 1
                         else self._multi_index_search(
                             [(s, None) for s in svcs], body))
                    r["status"] = 200
                    responses[p] = r
                except OpenSearchTpuError as e:
                    responses[p] = err_of(e)
        return 200, {"took": max((r.get("took", 0) for r in responses),
                                 default=0),
                     "responses": responses}

    _SEARCH_BODY_KEYS = frozenset({
        "query", "size", "from", "sort", "aggs", "aggregations",
        "_source", "min_score", "search_after", "highlight", "explain",
        "docvalue_fields", "fields", "script_fields", "rescore",
        "collapse", "suggest", "profile", "track_total_hits",
        "track_scores", "scroll", "slice", "pit", "timeout",
        "terminate_after", "version", "seq_no_primary_term",
        "indices_boost", "stored_fields", "post_filter",
        "_hybrid_pipeline", "allow_partial_search_results"})

    def h_search(self, req):
        body = req.json({}) or {}
        unknown = set(body) - self._SEARCH_BODY_KEYS
        if unknown:
            # the reference 400s on unknown top-level search keys
            # (SearchSourceBuilder's strict parser); a known key the
            # port does not serve is a 501 from the searcher
            raise ParsingError(
                f"unknown key for a search request: "
                f"[{sorted(unknown)[0]}]")
        # URI-search support: ?q= runs through query_string with its df/
        # operator/lenient params (RestSearchAction.parseSearchSource)
        q = req.param("q")
        if q:
            qs = {"query": q}
            if req.param("df"):
                qs["default_field"] = req.param("df")
            if req.param("default_operator"):
                qs["default_operator"] = req.param("default_operator")
            if req.param("analyze_wildcard") is not None:
                qs["analyze_wildcard"] = (req.param("analyze_wildcard")
                                          == "true")
            if req.param("lenient") is not None:
                qs["lenient"] = req.param("lenient") == "true"
            body.setdefault("query", {"query_string": qs})
        if req.param("size") is not None:
            body["size"] = int(req.param("size"))
        if req.param("from") is not None:
            body["from"] = int(req.param("from"))
        if req.param("allow_partial_search_results") is not None:
            body["allow_partial_search_results"] = \
                str(req.param("allow_partial_search_results")).lower() \
                != "false"
        src_spec = self._bulk_source_param(req)
        if src_spec is not None:
            body["_source"] = src_spec     # URL params override the body
        if req.param("track_total_hits") is not None \
                and "track_total_hits" not in body:
            raw_tth = req.param("track_total_hits")
            body["track_total_hits"] = (int(raw_tth)
                                        if raw_tth.lstrip("-").isdigit()
                                        else raw_tth != "false")
        if req.param("docvalue_fields") and "docvalue_fields" not in body:
            body["docvalue_fields"] = \
                req.param("docvalue_fields").split(",")
        tth0 = body.get("track_total_hits")
        if (isinstance(tth0, int) and not isinstance(tth0, bool)
                and tth0 <= 0 and tth0 != -1):
            raise IllegalArgumentError(
                "[track_total_hits] parameter must be positive or "
                f"equals to -1, got {tth0}")
        if (req.param("rest_total_hits_as_int") == "true"
                and isinstance(tth0, int)
                and not isinstance(tth0, bool)):
            raise IllegalArgumentError(
                "[rest_total_hits_as_int] cannot be used if the tracking "
                f"of total hits is not accurate, got {tth0}")
        resp_status, resp = self._h_search_inner(req, body)
        tth = body.get("track_total_hits")
        if isinstance(resp, dict):
            hits = resp.get("hits")
            if tth is False and isinstance(hits, dict):
                if req.param("rest_total_hits_as_int") == "true":
                    # the int rendering of an untracked total is -1
                    hits["total"] = {"value": -1, "relation": "eq"}
                else:
                    hits.pop("total", None)
            elif (isinstance(tth, int) and not isinstance(tth, bool)
                  and isinstance(hits, dict)
                  and isinstance(hits.get("total"), dict)
                  and hits["total"]["value"] > tth):
                # tracking cap: report the cap with relation gte
                hits["total"] = {"value": tth, "relation": "gte"}
        return resp_status, resp

    def _h_search_inner(self, req, body):
        # search pipeline: resolve the normalization-processor config the
        # hybrid combination should use (neural-search's hook)
        pid = req.param("search_pipeline")
        if pid:
            conf = self.node.search_pipelines.hybrid_conf(pid)
            if conf is not None:
                body["_hybrid_pipeline"] = conf
        # request-cache directive: strict boolean (a typo like
        # request_cache=tru must 400, not silently disable caching —
        # RestRequest.paramAsBoolean semantics)
        rc = req.param("request_cache")
        if rc is not None:
            if str(rc).lower() not in ("true", "false"):
                raise IllegalArgumentError(
                    f"Failed to parse value [{rc}] of parameter "
                    "[request_cache] as only [true] or [false] are "
                    "allowed.")
            body["request_cache"] = str(rc).lower() == "true"
        if "request_cache" in body and \
                not isinstance(body["request_cache"], bool):
            raise IllegalArgumentError(
                "[request_cache] must be a boolean")
        if body.get("pit"):
            raise NotYetPortedError(
                "point in time is not ported to the torch package yet")
        expr = req.path_params.get("index")
        if expr and ":" in expr:
            raise NotYetPortedError(
                "cross-cluster search is not ported to the torch package "
                "yet")
        if req.param("scroll") or body.get("scroll"):
            raise NotYetPortedError(
                "scroll is not ported to the torch package yet")
        from_ = int(body.get("from", 0) or 0)
        size_ = int(body.get("size", 10)
                    if body.get("size") is not None else 10)
        if from_ < 0:
            raise IllegalArgumentError(f"[from] parameter cannot be "
                                       f"negative, found [{from_}]")
        if size_ < 0:
            raise IllegalArgumentError(f"[size] parameter cannot be "
                                       f"negative, found [{size_}]")
        # per-index window/field-count limits apply in IndexService.search
        targets = self._target_indices_filtered(req)
        if not targets:
            # allow_no_indices=true default: empty result, not an error
            return 200, {"took": 0, "timed_out": False,
                         "_shards": {"total": 0, "successful": 0,
                                     "skipped": 0, "failed": 0},
                         "hits": {"total": {"value": 0, "relation": "eq"},
                                  "max_score": None, "hits": []}}
        if len(targets) == 1:
            svc, flt = targets[0]
            return 200, svc.search(self._apply_alias_filter(body, flt))
        return 200, self._multi_index_search(targets, body)

    def _merge_responses(self, responses, body, from_, size) -> dict:
        """The coordinator merge (SearchPhaseController.merge analog) of
        the multi-index path."""
        rows = []
        for resp_idx, resp in enumerate(responses):
            for pos, h in enumerate(resp["hits"]["hits"]):
                rows.append((h, resp_idx, pos))
        all_hits = merge_hit_rows(rows, body.get("sort"))
        total = sum(r["hits"]["total"]["value"] for r in responses)
        scores = [r["hits"]["max_score"] for r in responses
                  if r["hits"]["max_score"] is not None]
        shards = sum(r.get("_shards", {}).get("total", 1)
                     for r in responses)
        return {
            "took": max((r["took"] for r in responses), default=0),
            # partial-results flag survives the coordinator reduce
            "timed_out": any(r.get("timed_out") for r in responses),
            "_shards": {"total": shards, "successful": shards,
                        "skipped": 0, "failed": 0},
            "hits": {"total": {"value": total, "relation": "eq"},
                     "max_score": max(scores) if scores else None,
                     "hits": all_hits[from_: from_ + size]},
        }

    def _multi_index_search(self, services, body):
        """Coordinator merge over several indices (scores are per-index,
        like cross-index query_then_fetch in the reference).  ``aggs`` and
        ``suggest`` answer 501 from the shard, as on one index."""
        size = int(body.get("size", 10))
        from_ = int(body.get("from", 0))
        sub = dict(body)
        sub["from"] = 0
        sub["size"] = from_ + size
        responses = [svc.search(self._apply_alias_filter(sub, flt))
                     for svc, flt in services]
        return self._merge_responses(responses, body, from_, size)

    # -- search pipelines --------------------------------------------------

    def h_get_pipelines(self, req):
        return 200, self.node.search_pipelines.get()

    def h_get_pipeline(self, req):
        return 200, self.node.search_pipelines.get(req.path_params["id"])

    def h_put_pipeline(self, req):
        return 200, self.node.search_pipelines.put(
            req.path_params["id"], req.json({}) or {})

    def h_delete_pipeline(self, req):
        return 200, self.node.search_pipelines.delete(
            req.path_params["id"])

    def h_count(self, req):
        body = req.json({}) or {}
        unknown = set(body) - {"query"}
        if unknown:
            raise ParsingError(
                f"request does not support {sorted(unknown)}")
        q = req.param("q")
        if q and "query" not in body:
            qs = {"query": q}
            if req.param("df"):
                qs["default_field"] = req.param("df")
            if req.param("analyze_wildcard") is not None:
                qs["analyze_wildcard"] = (req.param("analyze_wildcard")
                                          == "true")
            if req.param("lenient") is not None:
                qs["lenient"] = req.param("lenient") == "true"
            if req.param("default_operator"):
                qs["default_operator"] = req.param("default_operator")
            body["query"] = {"query_string": qs}
        services = self._target_indices_filtered(req)
        total = sum(
            svc.count(self._apply_alias_filter(
                {"query": body.get("query")}, flt)["query"])
            for svc, flt in services)
        n_shards = sum(svc.num_shards for svc, _f in services)
        return 200, {"count": total,
                     "_shards": {"total": n_shards,
                                 "successful": n_shards, "skipped": 0,
                                 "failed": 0}}
