"""Per-node index registry: index lifecycle, shard routing, document and
search entry points (the port of the JAX package's
``indices/service.py``).

Analog of ``indices/IndicesService.java`` + ``index/IndexService.java`` +
``cluster/routing/OperationRouting.java``: an index is N shard engines;
writes route by murmur3(_id or routing) mod num_shards; node-local search
runs over ALL shards' segments in one ``ShardSearcher``, which makes the
scoring statistics (avgdl, df) index-wide and reuses the segment merge as
the shard merge.

Every index serves on the registry's ``device``: ``cuda`` unless the
caller asks for ``"cpu"``; without CUDA a registry that did not ask for
the CPU raises ``DeviceUnavailableError`` when it is built.  The device
is resolved once and handed to every shard's ``InternalEngine`` and to
the node-local searcher.

An index with ``search.mesh`` on, at least two shards and at least as
many CUDA cards (``_use_mesh``, as the reference decides) searches its
shards as one device scatter-gather (``_mesh_search``,
``parallel/dist_search.py`` ``MeshSearcher``; an index serving on the
CPU builds a mesh of CPU entries): per-shard scoring statistics, the
shards' top-k lists merged on the first mesh device by K10.  A mesh that cannot be built, an
open ``mesh`` device breaker or a device error inside the collective
demote the request to the host scatter (``_mesh_degrade``, counted in
``search.mesh.fallback``), which still runs every shard's own searcher
on the device and merges on the host; nothing is scored on the CPU in
their place.

Not ported yet (each raises ``NotYetPortedError`` where the reference
would run it; ROADMAP Queue A): aliases, index templates, rollover,
resize and data streams; searchable-snapshot mounts and the remote
store.  Left out with no counterpart yet: indexing pressure, the search
and indexing slow logs, query insights (the mesh's ``insights.emit``
records among them), the device-degraded partial response and the
cluster-mode shard set (``local_shard_ids``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import uuid
from typing import Optional

import torch

from opensearch_tpu_torch.common.errors import (
    ClusterBlockException,
    DocumentMissingError,
    IllegalArgumentError,
    IndexAlreadyExistsError,
    IndexNotFoundError,
    NotYetPortedError,
    OpenSearchTpuError,
    ShardNotFoundError,
    ValidationError,
    VersionConflictError,
)
from opensearch_tpu_torch.common.device_health import (device_health,
                                                      is_device_error)
from opensearch_tpu_torch.common.telemetry import metrics
from opensearch_tpu_torch.common.torchenv import resolve_device
from opensearch_tpu_torch.index.engine import InternalEngine, OpResult
from opensearch_tpu_torch.index.store import CODECS, find_corruption_markers
from opensearch_tpu_torch.indices.request_cache import request_cache
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.search.engine import query_engine
from opensearch_tpu_torch.search.executor import ShardSearcher
from opensearch_tpu_torch.search.fetch import filter_source


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """murmur3 x86 32-bit (the reference's Murmur3HashFunction routing
    hash family; the JAX package's function, so both packages route a
    document to the same shard)."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed
    length = len(data)
    rounded = length & ~3
    for i in range(0, rounded, 4):
        k = int.from_bytes(data[i: i + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    k = 0
    tail = data[rounded:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= length
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


_INDEX_NAME_FORBIDDEN = set('\\/*?"<>| ,#:')


def deep_merge_doc(base: dict, patch: dict) -> dict:
    """Recursive partial-document merge for _update: nested objects merge
    key-by-key, everything else (incl. arrays) replaces
    (XContentHelper.update / UpdateHelper semantics)."""
    out = dict(base)
    for k, v in patch.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge_doc(out[k], v)
        else:
            out[k] = v
    return out


def _parse_millis(v) -> int:
    """Time expression -> ms ("500ms", "1.5s", "1m", "1d", bare
    number=ms); -1 disables (the slow-log convention).  Unparseable
    values log a warning once and disable rather than failing queries."""
    if isinstance(v, (int, float)):
        return int(v)
    s = str(v).strip().lower()
    for suffix, mult in (("ms", 1), ("s", 1000), ("m", 60_000),
                         ("h", 3_600_000), ("d", 86_400_000)):
        if s.endswith(suffix):
            try:
                return int(float(s[: -len(suffix)]) * mult)
            except ValueError:
                break
    try:
        return int(float(s))
    except ValueError:
        import logging
        logging.getLogger("opensearch_tpu_torch.settings").warning(
            "unparseable time value [%s]; threshold disabled", v)
        return -1


def shard_id_for(doc_id: str, routing: Optional[str], num_shards: int) -> int:
    """THE routing decision: every layer must agree on it, so it lives in
    exactly one place."""
    key = (routing if routing is not None else str(doc_id)).encode()
    return murmur3_32(key) % num_shards


def _check_ported_settings(name: str, settings: dict):
    """An index whose data lives in a blob repository (a searchable-
    snapshot mount, or the remote store) is not served by this package
    yet."""
    if settings.get("remote_snapshot"):
        raise NotYetPortedError(
            f"index [{name}]: searchable-snapshot mounts are not ported to "
            "the torch package yet")
    rs = settings.get("remote_store") or {}
    if isinstance(rs, dict) and rs.get("enabled") in (True, "true"):
        raise NotYetPortedError(
            f"index [{name}]: the remote store is not ported to the torch "
            "package yet")


class IndexService:
    """One index: mapper + N shard engines + the node-local searcher,
    serving on ``device``."""

    def __init__(self, name: str, data_path: str, settings: dict,
                 mappings: Optional[dict], persist_meta=None, device=None):
        self.device = resolve_device(device)
        _check_ported_settings(name, settings)
        self.name = name
        self.data_path = data_path
        self.settings = settings
        self._persist_meta = persist_meta
        self.num_shards = int(settings.get("number_of_shards", 1))
        self.num_replicas = int(settings.get("number_of_replicas", 0))
        if self.num_shards < 1:
            raise IllegalArgumentError(
                f"number_of_shards must be >= 1, got {self.num_shards}")
        self.creation_date = int(time.time() * 1000)  # wall-clock: timestamp
        self.uuid = uuid.uuid4().hex[:22]
        self.mapper = DocumentMapper(mappings or {})
        self._durability = settings.get("translog", {}).get("durability",
                                                            "request")
        # index.codec (ref index/codec/CodecService.java:46): default vs
        # best_compression, fixed at index creation like the reference
        self._codec = str(settings.get("codec", "default"))
        if self._codec not in CODECS:
            raise IllegalArgumentError(
                f"unknown value for [index.codec]: [{self._codec}] — "
                f"supported: {list(CODECS)}")
        self.local_shards: dict[int, InternalEngine] = {
            s: self._open_shard(s) for s in range(self.num_shards)}
        self._lock = threading.RLock()
        self._searcher: Optional[ShardSearcher] = None
        # the mesh over the shards' searchers (``_mesh_search``), kept
        # across refreshes (``update_shards``), dropped on close
        self._mesh_searcher = None
        # search-visibility generation: bumped whenever the searchable
        # segment set may have changed (refresh / merge / mapping change).
        # The request cache keys on it, so stale entries stop matching the
        # moment anything moves (IndicesRequestCache's reader-generation
        # key).
        self._reader_gen = 0

    def _open_shard(self, shard_id: int) -> InternalEngine:
        return InternalEngine(os.path.join(self.data_path, str(shard_id)),
                              self.mapper, index_name=self.name,
                              shard_id=shard_id,
                              durability=self._durability,
                              codec=self._codec, device=self.device)

    @property
    def shards(self) -> list[InternalEngine]:
        return list(self.local_shards.values())

    def corrupted_shards(self) -> dict:
        """shard_id -> corruption markers/verdicts for local copies that
        failed store verification (the red-status evidence
        ``_cluster/health`` surfaces)."""
        out = {}
        for sid, engine in sorted(self.local_shards.items()):
            markers = find_corruption_markers(
                os.path.join(engine.data_path, "segments"))
            if engine.corruption is not None and not markers:
                markers = [{"reason": str(engine.corruption)}]
            if markers:
                out[sid] = markers
        return out

    # -- routing ----------------------------------------------------------

    def route_shard(self, doc_id: str, routing: Optional[str] = None) -> int:
        return shard_id_for(doc_id, routing, self.num_shards)

    def engine_for(self, shard_id: int) -> InternalEngine:
        engine = self.local_shards.get(shard_id)
        if engine is None:
            raise ShardNotFoundError(
                f"shard [{self.name}][{shard_id}] is not on this node")
        return engine

    def route(self, doc_id: str, routing: Optional[str] = None) -> InternalEngine:
        return self.engine_for(self.route_shard(doc_id, routing))

    # -- document ops -----------------------------------------------------

    def _check_write_block(self):
        blocked = self.settings.get(
            "index.blocks.write",
            (self.settings.get("blocks") or {}).get("write", False))
        if str(blocked).lower() == "true":
            raise ClusterBlockException(
                f"index [{self.name}] blocked by: [FORBIDDEN/8/index "
                "write (api)]")

    def index_doc(self, doc_id: Optional[str], source: dict,
                  routing: Optional[str] = None, **kw) -> OpResult:
        """Index one document and sync the translog before acking (one
        ``ensure_synced`` per document, as the reference does)."""
        self._check_write_block()
        if doc_id is None:
            doc_id = uuid.uuid4().hex[:20]
        engine = self.route(str(doc_id), routing)
        result = engine.index(str(doc_id), source, routing=routing, **kw)
        engine.ensure_synced()
        return result

    def delete_doc(self, doc_id: str, routing: Optional[str] = None,
                   **kw) -> OpResult:
        self._check_write_block()
        engine = self.route(doc_id, routing)
        result = engine.delete(str(doc_id), **kw)
        engine.ensure_synced()
        return result

    def get_doc(self, doc_id: str, routing: Optional[str] = None,
                realtime: bool = True) -> Optional[dict]:
        return self.route(doc_id, routing).get(str(doc_id), realtime=realtime)

    def bulk(self, ops: list[tuple]) -> list[dict]:
        """ops: [(action, doc_id, source, params)] — per-item results, errors
        reported per item like TransportShardBulkAction (never aborts the
        batch)."""
        results = []
        for action, doc_id, source, params in ops:
            try:
                if doc_id == "":
                    raise IllegalArgumentError(
                        "if _id is specified it must not be empty")
                if action in ("index", "create"):
                    if action == "create" and doc_id is not None:
                        existing = self.get_doc(doc_id,
                                                params.get("routing"))
                        if existing is not None:
                            raise ValidationError(
                                f"[{doc_id}]: version conflict, document "
                                "already exists")
                    cas = {k: int(params[k])
                           for k in ("if_seq_no", "if_primary_term")
                           if params.get(k) is not None}
                    r = self.index_doc(doc_id, source,
                                       routing=params.get("routing"), **cas)
                    results.append({action: {
                        "_index": self.name, "_id": r.doc_id,
                        "_version": r.version, "_seq_no": r.seq_no,
                        "_primary_term": r.primary_term,
                        "result": r.result,
                        "status": 201 if r.result == "created" else 200}})
                elif action == "delete":
                    r = self.delete_doc(doc_id, routing=params.get("routing"))
                    results.append({"delete": {
                        "_index": self.name, "_id": r.doc_id,
                        "_version": r.version, "_seq_no": r.seq_no,
                        "_primary_term": r.primary_term,
                        "result": r.result,
                        "status": 404 if r.result == "not_found" else 200}})
                elif action == "update":
                    results.append(self._bulk_update(doc_id, source, params))
                else:
                    raise ValidationError(f"unknown bulk action [{action}]")
            except OpenSearchTpuError as e:
                results.append({action: {
                    "_index": self.name, "_id": doc_id, "status": e.status,
                    "error": e.to_xcontent()["error"]}})
        return results

    def _bulk_update(self, doc_id, source, params) -> dict:
        """One bulk ``update`` item: a partial-doc merge or an upsert."""
        cur = self.get_doc(doc_id, params.get("routing"))
        if params.get("if_seq_no") is not None:
            cur_seq = cur["_seq_no"] if cur is not None else -1
            if int(params["if_seq_no"]) != cur_seq:
                raise VersionConflictError(
                    doc_id, f"seq_no [{params['if_seq_no']}]",
                    f"seq_no [{cur_seq}]")
        if params.get("if_primary_term") is not None:
            cur_term = (cur.get("_primary_term", 1)
                        if cur is not None else 0)
            if int(params["if_primary_term"]) != cur_term:
                raise VersionConflictError(
                    doc_id, f"primary_term [{params['if_primary_term']}]",
                    f"primary_term [{cur_term}]")
        if cur is not None and "_source" not in cur:
            raise IllegalArgumentError(
                f"[{doc_id}]: source is missing — partial "
                "updates require [_source] to be enabled")
        if cur is None:
            if "upsert" not in source:
                raise DocumentMissingError(self.name, doc_id)
            merged = source["upsert"]
        else:
            merged = deep_merge_doc(cur["_source"], source.get("doc", {}))
        r = self.index_doc(doc_id, merged, routing=params.get("routing"))
        src_spec = params.get("_source")
        if src_spec is None and isinstance(source, dict):
            src_spec = source.get("_source")
        if src_spec:
            spec = src_spec
            if spec in ("true", "false"):
                spec = spec == "true"
            elif not isinstance(spec, bool):
                spec = spec.split(",") if isinstance(spec, str) else spec
            return {"update": {
                "_index": self.name, "_id": r.doc_id,
                "_version": r.version, "_seq_no": r.seq_no,
                "result": "updated", "status": 200,
                "get": {"found": True,
                        "_source": filter_source(merged, spec)}}}
        return {"update": {
            "_index": self.name, "_id": r.doc_id,
            "_version": r.version, "result": "updated", "status": 200}}

    # -- search -----------------------------------------------------------

    def _dirty(self):
        """Drop the cached node-local searcher and bump the reader
        generation.  A searcher a request still holds keeps its own
        point-in-time view: searchers are never changed in place."""
        with self._lock:
            self._searcher = None
            self._reader_gen += 1
        # eager cleanup: the generation bump already makes the old
        # entries unreachable; dropping them keeps memory accounting true
        request_cache().invalidate_service(self.uuid)

    def refresh(self):
        for engine in self.shards:
            engine.refresh()
        self._dirty()

    def refresh_doc_shard(self, doc_id: str, routing: Optional[str] = None):
        """?refresh=true on a single-document write refreshes ONLY the
        owning shard (RestActions write-refresh semantics: other shards'
        pending ops stay invisible)."""
        self.route(doc_id, routing).refresh()
        self._dirty()

    def save_meta(self):
        """Persist the CURRENT mapping (incl. dynamically-added fields):
        after a flush the translog can no longer re-derive them on
        replay."""
        if self._persist_meta is not None:
            self._persist_meta(self.name, self.settings,
                               self.mapper.to_mapping())

    def flush(self):
        """Flush every shard under the index lock (the reference's local
        flush; its remote-store upload is not ported)."""
        with self._lock:
            self.save_meta()
            for _sid, engine in sorted(self.local_shards.items()):
                engine.flush()

    def force_merge(self, max_num_segments: int = 1):
        self._check_write_block()
        for engine in self.shards:
            engine.force_merge(max_num_segments)
        self._dirty()

    def searcher(self) -> ShardSearcher:
        """Node-local search view: every shard's segments under one
        searcher on the index's device (index-wide statistics; the segment
        merge is the shard merge).  Cached between refreshes: NRT
        visibility changes only at refresh."""
        with self._lock:
            if self._searcher is None:
                segs = []
                for engine in self.shards:
                    segs.extend(engine.acquire_searcher().segments)
                self._searcher = ShardSearcher(segs, self.mapper,
                                               index_name=self.name,
                                               device=self.device)
            return self._searcher

    def update_settings(self, flat: dict):
        """Apply a dynamic settings update; static settings reject
        (IndexScopedSettings.NOT_DYNAMIC check)."""
        for key, value in flat.items():
            bare = key[6:] if key.startswith("index.") else key
            if bare in ("number_of_shards", "routing_partition_size"):
                raise IllegalArgumentError(
                    f"final [{key}] setting: this setting is not "
                    "updateable")
            if bare == "number_of_replicas":
                self.num_replicas = int(value)
            self.settings[f"index.{bare}"] = value
        if self._persist_meta is not None:
            self._persist_meta(self.name, self.settings,
                               self.get_mapping().get("mappings"))

    def index_setting(self, key: str, default):
        """Per-index setting lookup accepting the dotted, bare, and
        nested-object key forms the create body may use."""
        v = self.settings.get(f"index.{key}", self.settings.get(key))
        if v is None:
            for root in (self.settings.get("index"), self.settings):
                node = root
                for part in key.split("."):
                    node = (node.get(part)
                            if isinstance(node, dict) else None)
                    if node is None:
                        break
                if node is not None:
                    v = node
                    break
        return default if v is None else v

    def _check_search_limits(self, body: dict):
        """Per-index request-size guards (IndexSettings.MAX_* family)."""
        mrw = int(self.index_setting("max_result_window", 10000))
        window = int(body.get("from", 0) or 0) + int(
            body.get("size", 10) if body.get("size") is not None else 10)
        if window > mrw:
            raise IllegalArgumentError(
                f"Result window is too large, from + size must be less "
                f"than or equal to: [{mrw}] but was [{window}]. See the "
                "scroll api for a more efficient way to request large "
                "data sets.")
        dvf = body.get("docvalue_fields") or []
        max_dvf = int(self.index_setting("max_docvalue_fields_search", 100))
        if len(dvf) > max_dvf:
            raise IllegalArgumentError(
                f"Trying to retrieve too many docvalue_fields. Must be "
                f"less than or equal to: [{max_dvf}] but was "
                f"[{len(dvf)}]. This limit can be set by changing the "
                "[index.max_docvalue_fields_search] index level setting.")
        sf = body.get("script_fields") or {}
        max_sf = int(self.index_setting("max_script_fields", 32))
        if len(sf) > max_sf:
            raise IllegalArgumentError(
                f"Trying to retrieve too many script_fields. Must be "
                f"less than or equal to: [{max_sf}] but was [{len(sf)}]. "
                "This limit can be set by changing the "
                "[index.max_script_fields] index level setting.")
        max_tc = int(self.index_setting("max_terms_count", 65536))

        def check_terms(node):
            if isinstance(node, dict):
                tq = node.get("terms")
                if isinstance(tq, dict):
                    for vals in tq.values():
                        if isinstance(vals, list) and len(vals) > max_tc:
                            raise IllegalArgumentError(
                                f"The number of terms [{len(vals)}] "
                                "used in the Terms Query request has "
                                "exceeded the allowed maximum of "
                                f"[{max_tc}]. This maximum can be set "
                                "by changing the [index.max_terms_count] "
                                "index level setting.")
                for v in node.values():
                    check_terms(v)
            elif isinstance(node, list):
                for v in node:
                    check_terms(v)
        if body.get("query") is not None:
            check_terms(body["query"])
        rescore = body.get("rescore")
        if rescore:
            spec = rescore[0] if isinstance(rescore, list) else rescore
            window = int(spec.get("window_size", 10))
            max_rw = int(self.index_setting("max_rescore_window", 10000))
            if window > max_rw:
                raise IllegalArgumentError(
                    f"Rescore window [{window}] is too large. It must "
                    f"be less than [{max_rw}]. This prevents allocating "
                    "massive heaps for storing the results to be "
                    "rescored. This limit can be set by changing the "
                    "[index.max_rescore_window] index level setting.")

    def search(self, body: Optional[dict] = None, *,
               agg_partials: bool = False) -> dict:
        body = dict(body or {})
        # request-level cache directive (the ?request_cache= param; the
        # REST layer validated it) must not leak into execution or the
        # cache key
        explicit_cache = body.pop("request_cache", None)
        self._check_search_limits(body)
        if self.should_cache_request(body, explicit_cache, agg_partials):
            resp, _hit = request_cache().get_or_compute(
                index=self.name, svc_uuid=self.uuid, shard_key="_local",
                reader_gen=self._reader_gen, body=body,
                compute=lambda: self._execute_search(body, agg_partials))
            return resp
        return self._execute_search(body, agg_partials)

    def _execute_search(self, body: dict, agg_partials: bool) -> dict:
        # ONE engine entry: the continuous batcher and the kernels are
        # decisions inside QueryEngine.execute (search/engine.py)
        resp = query_engine().execute(self.searcher(), body,
                                      agg_partials=agg_partials,
                                      service=self)
        resp["_shards"] = {"total": self.num_shards,
                           "successful": self.num_shards,
                           "skipped": 0, "failed": 0}
        return resp

    def should_cache_request(self, body: dict, explicit,
                             agg_partials: bool = False) -> bool:
        """IndicesRequestCache admission policy (the reference's
        canCache): profile/PIT never cache; an explicit request-level
        ``request_cache`` wins over the ``index.requests.cache.enable``
        index setting; by default only hit-less (size=0) requests cache,
        like the reference."""
        if agg_partials:
            return False
        if body.get("profile") or body.get("pit"):
            return False
        if explicit is not None:
            return bool(explicit)
        enabled = str(self.index_setting(
            "requests.cache.enable", True)).lower() != "false"
        size = int(body.get("size", 10)
                   if body.get("size") is not None else 10)
        return enabled and size == 0

    def _use_mesh(self, body: dict) -> bool:
        """True when the request goes through the device scatter-gather
        (``_mesh_search``), as the reference decides: the index opted in
        (``search.mesh``), it has at least two shards and as many CUDA
        devices, and the request is a scored top-k without sort, profile
        or hybrid.  Per-shard scoring statistics (query_then_fetch), as
        the cluster path, against the node-local searcher's index-wide
        ones."""
        flag = self.settings.get("search.mesh")
        if flag in (None, False, "false"):
            return False
        if len(self.local_shards) < 2:
            return False
        if body.get("sort") is not None:
            return False
        if body.get("profile"):
            return False
        q = body.get("query")
        if isinstance(q, dict) and "hybrid" in q:
            return False
        return torch.cuda.device_count() >= len(self.local_shards)

    def _mesh_degrade(self, body: dict) -> dict:
        """Demote a mesh request to the counted host scatter: a mesh that
        cannot be built (too few devices), an open ``mesh`` breaker, or a
        device error inside the collective.  The request degrades (the
        same per-shard statistics, the coordinator's merge order), never
        fails."""
        metrics().counter("search.mesh.fallback").inc()
        return self._host_scatter_search(body)

    def _mesh_search(self, body: dict) -> dict:
        """The device scatter-gather of the index's shards (module
        docstring); ``_mesh_degrade`` where the mesh cannot serve."""
        from opensearch_tpu_torch.parallel import dist_search
        from opensearch_tpu_torch.search.aggs import reduce_aggs
        from opensearch_tpu_torch.search.suggest import merge_suggest

        health = device_health()
        if not health.allow("mesh"):
            # don't retry a failing collective every request: demote until
            # a half-open probe closes the breaker
            return self._mesh_degrade(body)
        try:
            with self._lock:
                shards = [self.local_shards[s].acquire_searcher()
                          for s in sorted(self.local_shards)]
                if (self._mesh_searcher is None
                        or len(self._mesh_searcher.shards) != len(shards)):
                    self._mesh_searcher = dist_search.MeshSearcher(
                        shards, dist_search.make_mesh(len(shards),
                                                      self.device))
                else:
                    self._mesh_searcher.update_shards(shards)
                ms = self._mesh_searcher
        except Exception as exc:
            # a mesh that cannot be built is a mesh fault, not a query's
            with self._lock:
                self._mesh_searcher = None
            health.record_failure("mesh", exc)
            return self._mesh_degrade(body)

        def collective(fn):
            """One mesh collective over this request's ``shards``; a
            device error is counted and returns None (the caller
            demotes), any other error propagates: a hand kernel's failed
            launch (``KernelLaunchError``) among them, so no demotion
            answers for a kernel that does not run."""
            try:
                out = fn()
            except Exception as exc:
                if not is_device_error(exc):
                    raise
                health.record_failure("mesh", exc)
                return None
            health.record_success("mesh")
            return out

        aggs_json = body.get("aggs") or body.get("aggregations")
        if not aggs_json and not body.get("suggest"):
            resp = collective(lambda: ms.search(body, shards))
            if resp is None:
                return self._mesh_degrade(body)
            return resp
        if (aggs_json and not body.get("suggest")
                and int(body.get("size", 10)) == 0
                and body.get("min_score") is None
                and ms.supports_mesh_aggs(aggs_json)):
            resp = collective(lambda: ms.mesh_metric_aggs(body, aggs_json,
                                                          shards))
            if resp is None:
                return self._mesh_degrade(body)
            return resp
        # the scored merge on the mesh, the aggregations' and suggesters'
        # shard partials collected by each shard's searcher and reduced as
        # the coordinator does; size 0 skips the mesh pass (the collect
        # already counts the totals)
        collect_body = {"size": 0}
        if aggs_json:
            collect_body["aggs"] = aggs_json
        if body.get("suggest"):
            collect_body["suggest"] = body["suggest"]
        for key in ("query", "min_score"):
            if body.get(key) is not None:
                collect_body[key] = body[key]
        size0 = int(body.get("size", 10)) == 0
        shard_resps = [s.search(collect_body, agg_partials=True)
                       for s in shards]
        partials = [r.get("aggregation_partials") or {} for r in shard_resps]
        if size0:
            total = sum(r["hits"]["total"]["value"] for r in shard_resps)
            resp = {"took": max((r["took"] for r in shard_resps), default=0),
                    "timed_out": False,
                    "hits": {"total": {"value": total, "relation": "eq"},
                             "max_score": None, "hits": []}}
        else:
            resp = collective(lambda: ms.search(
                {k: v for k, v in body.items()
                 if k not in ("aggs", "aggregations", "suggest")},
                shards))
            if resp is None:
                return self._mesh_degrade(body)
        if aggs_json:
            resp["aggregations"] = reduce_aggs(aggs_json, partials)
        if body.get("suggest"):
            resp["suggest"] = merge_suggest(
                [r.get("suggest") for r in shard_resps])
        return resp

    def _host_scatter_search(self, body: dict) -> dict:
        """The mesh's fallback: the same scatter-gather with the merge on
        the host (``parallel/dist_search.py`` ``host_scatter``) over the
        shards' current searchers, on the index's device."""
        from opensearch_tpu_torch.parallel.dist_search import host_scatter

        with self._lock:
            searchers = [self.local_shards[s].acquire_searcher()
                         for s in sorted(self.local_shards)]
        return host_scatter(searchers, body)

    def msearch(self, bodies: list) -> list[dict]:
        """Batched multi-search over the node-local searcher (scored term
        bags share one K3 launch per group on CUDA, search/batch.py)."""
        results = query_engine().msearch(self.searcher(), bodies)
        for r in results:
            r["_shards"] = {"total": self.num_shards,
                            "successful": self.num_shards,
                            "skipped": 0, "failed": 0}
        return results

    def count(self, query: Optional[dict] = None) -> int:
        return query_engine().count(self.searcher(), query)

    def doc_count(self) -> int:
        return sum(e.doc_count() for e in self.shards)

    def stats(self) -> dict:
        return {
            "docs": {"count": self.doc_count()},
            "shards": {"total": self.num_shards},
            "segments": {"count": sum(len(e.segments) for e in self.shards)},
            "request_cache": request_cache().stats_for_index(self.name),
        }

    def put_mapping(self, mapping: dict):
        self._check_write_block()
        self.mapper.merge(mapping)
        self.save_meta()
        # a mapping change can alter how cached requests would compile
        self._dirty()

    def get_mapping(self) -> dict:
        return {"mappings": self.mapper.to_mapping()}

    def get_settings(self) -> dict:
        return {"settings": {"index": {
            "number_of_shards": str(self.num_shards),
            "number_of_replicas": str(self.num_replicas),
            "uuid": self.uuid,
            "creation_date": str(self.creation_date),
        }}}

    def close(self):
        """Close every shard engine and drop the node-local searcher: the
        device bytes staged for this index are released once no request
        holds a searcher over its segments."""
        for engine in self.shards:
            engine.close()
        with self._lock:
            self._searcher = None
            self._mesh_searcher = None
        request_cache().invalidate_service(self.uuid)


class IndicesService:
    """Node-level registry (IndicesService.java analog) with on-disk
    metadata so indices survive restarts.  ``device`` is resolved once
    (``cuda`` unless the caller asks for ``"cpu"``) and every index serves
    on it."""

    auto_create = True          # action.auto_create_index (dynamic)

    # the reference's registry files this package does not read yet
    _UNPORTED_FILES = {"_aliases.json": "aliases",
                       "_index_templates.json": "index templates",
                       "_data_streams.json": "data streams"}

    def __init__(self, data_path: str, device=None):
        self.device = resolve_device(device)
        self.data_path = data_path
        os.makedirs(data_path, exist_ok=True)
        self._lock = threading.RLock()
        self.indices: dict[str, IndexService] = {}
        self._load()

    def _meta_path(self, name: str) -> str:
        return os.path.join(self.data_path, name, "index_meta.json")

    def _persist_meta(self, name: str, settings: dict, mappings: dict):
        tmp = self._meta_path(name) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"settings": settings, "mappings": mappings}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._meta_path(name))

    def _load(self):
        for fname, what in self._UNPORTED_FILES.items():
            path = os.path.join(self.data_path, fname)
            if os.path.exists(path):
                with open(path) as f:
                    if json.load(f):
                        raise NotYetPortedError(
                            f"[{path}] holds {what}, which are not ported "
                            "to the torch package yet")
        for name in sorted(os.listdir(self.data_path)):
            meta_path = self._meta_path(name)
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    meta = json.load(f)
                self.indices[name] = IndexService(
                    name, os.path.join(self.data_path, name),
                    meta.get("settings", {}), meta.get("mappings"),
                    persist_meta=self._persist_meta, device=self.device)

    @staticmethod
    def validate_name(name: str):
        """Reference rules (MetadataCreateIndexService.validateIndexName):
        lowercase, no reserved characters, must not start with _ - +,
        not '.'/'..', < 255 bytes.  Any unicode satisfying those is
        legal (e.g. CJK names)."""
        bad = (not name or name != name.lower() or name in (".", "..")
               or name[0] in "_-+"
               or any(c in _INDEX_NAME_FORBIDDEN for c in name)
               or len(name.encode("utf-8")) > 255)
        if bad:
            raise ValidationError(
                f"invalid index name [{name}]: must be lowercase, must "
                "not contain [\\/*?\"<>|, #:] or spaces, and must not "
                "start with [_-+]")

    def _register(self, name: str, settings: dict,
                  mappings: Optional[dict]) -> IndexService:
        """Open + persist + register (call with the registry lock
        held)."""
        if name in self.indices:
            raise IndexAlreadyExistsError(name)
        self.validate_name(name)
        if "index" in settings:       # accept {"settings": {"index": {...}}}
            inner = settings.pop("index")
            settings.update(inner)
        path = os.path.join(self.data_path, name)
        os.makedirs(path, exist_ok=True)
        svc = IndexService(name, path, settings, mappings,
                           persist_meta=self._persist_meta,
                           device=self.device)
        self._persist_meta(name, settings, mappings or {})
        self.indices[name] = svc
        return svc

    def create(self, name: str, body: Optional[dict] = None) -> IndexService:
        body = body or {}
        if body.get("aliases"):
            raise NotYetPortedError(
                "aliases are not ported to the torch package yet")
        with self._lock:
            return self._register(name, dict(body.get("settings", {})),
                                  body.get("mappings"))

    def get(self, name: str) -> IndexService:
        svc = self.indices.get(name)
        if svc is None:
            raise IndexNotFoundError(name)
        return svc

    def get_or_create(self, name: str) -> IndexService:
        """Auto-create on first write (action.auto_create_index default)."""
        with self._lock:
            if name in self.indices:
                return self.indices[name]
            if not self.auto_create:
                raise IndexNotFoundError(name)
            return self.create(name)

    def exists(self, name: str) -> bool:
        return name in self.indices

    def delete(self, name: str):
        with self._lock:
            svc = self.get(name)
            svc.close()
            del self.indices[name]
            shutil.rmtree(os.path.join(self.data_path, name),
                          ignore_errors=True)

    def resolve(self, expr: str) -> list[IndexService]:
        """Index expression: name, comma list, * / _all wildcards (the
        reference's IndexNameExpressionResolver with no aliases)."""
        return [svc for svc, _f in self.resolve_with_filters(expr)]

    def resolve_with_filters(self, expr: str) -> list[tuple]:
        """[(IndexService, alias_filter)]; the filter is always None here:
        only an alias carries one, and aliases are not ported."""
        if expr in ("_all", "*", ""):
            return [(s, None) for s in self.indices.values()]
        order: list[str] = []
        for part in expr.split(","):
            if "*" in part:
                rx = re.compile("^" + re.escape(part).replace(r"\*", ".*")
                                + "$")
                names = [n for n in self.indices if rx.match(n)]
            else:
                names = [self.get(part).name]
            order.extend(n for n in names if n not in order)
        return [(self.indices[name], None) for name in order]

    # -- not ported yet: aliases, templates, rollover, resize, data streams

    @staticmethod
    def _not_ported(what: str):
        raise NotYetPortedError(
            f"{what} is not ported to the torch package yet")

    def update_aliases(self, actions: list) -> dict:
        self._not_ported("[_aliases]")

    def put_template(self, name: str, body: dict) -> dict:
        self._not_ported("[_index_template]")

    def rollover(self, target: str, body: Optional[dict] = None,
                 dry_run: bool = False) -> dict:
        self._not_ported("[_rollover]")

    def resize(self, source: str, target: str, mode: str,
               body: Optional[dict] = None) -> dict:
        self._not_ported(f"[_{mode}]")

    def create_data_stream(self, name: str) -> dict:
        self._not_ported("[_data_stream]")

    def close(self):
        for svc in self.indices.values():
            svc.close()
