"""Exception hierarchy, analog of OpenSearchException and friends
(reference: server/src/main/java/org/opensearch/OpenSearchException.java).

Every exception carries an HTTP status so the REST layer can serialize it the
way the reference's RestController does (rest/RestController.java:250) —
``{"error": {"type": ..., "reason": ...}, "status": N}``.
"""

from __future__ import annotations


class OpenSearchTpuError(Exception):
    status = 500

    def __init__(self, reason: str = "", **metadata):
        super().__init__(reason)
        self.reason = reason
        self.metadata = metadata

    #: explicit wire name when the reference's differs from the derived one
    wire_name: str | None = None

    @property
    def error_type(self) -> str:
        # CamelCase -> snake_case with the reference's `_exception` suffix
        # (OpenSearchException.getExceptionName) — clients and the YAML
        # conformance suites match on these exact strings.
        if self.wire_name is not None:
            return self.wire_name
        name = type(self).__name__
        out = []
        for i, ch in enumerate(name):
            if ch.isupper() and i > 0:
                out.append("_")
            out.append(ch.lower())
        s = "".join(out)
        if s.endswith("_error"):
            s = s[: -len("_error")] + "_exception"
        return s

    def to_xcontent(self) -> dict:
        return {
            "error": {
                "root_cause": [{"type": self.error_type,
                                "reason": self.reason}],
                "type": self.error_type,
                "reason": self.reason,
                **({"metadata": self.metadata} if self.metadata else {}),
            },
            "status": self.status,
        }


class ResourceNotFoundError(OpenSearchTpuError):
    status = 404


class IndexNotFoundError(ResourceNotFoundError):
    wire_name = "index_not_found_exception"

    def __init__(self, index: str):
        super().__init__(f"no such index [{index}]", index=index)


class DocumentMissingError(ResourceNotFoundError):
    def __init__(self, index: str, doc_id: str):
        super().__init__(f"[{doc_id}]: document missing", index=index)


class ResourceAlreadyExistsError(OpenSearchTpuError):
    status = 400


class IndexAlreadyExistsError(ResourceAlreadyExistsError):
    wire_name = "resource_already_exists_exception"

    def __init__(self, index: str):
        super().__init__(f"index [{index}] already exists", index=index)


class ValidationError(OpenSearchTpuError):
    """Bad request payloads (action/ValidateActions analog)."""

    wire_name = "action_request_validation_exception"
    status = 400


class ParsingError(ValidationError):
    """Malformed query DSL / mapping / settings JSON
    (core/common/ParsingException analog)."""

    wire_name = None                 # derived: parsing_exception


class MapperParsingError(ValidationError):
    """Document does not fit the mapping
    (index/mapper/MapperParsingException analog)."""

    wire_name = None                 # derived: mapper_parsing_exception


class StrictDynamicMappingError(MapperParsingError):
    """Unmapped field under ``dynamic: strict``
    (index/mapper/StrictDynamicMappingException analog)."""

    def __init__(self, path: str):
        super().__init__(
            f"mapping set to strict, dynamic introduction of [{path}] is not allowed"
        )


class IllegalArgumentError(ValidationError):
    wire_name = None                 # derived: illegal_argument_exception


class VersionConflictError(OpenSearchTpuError):
    """Optimistic concurrency failure (index/engine/VersionConflictEngineException)."""

    wire_name = "version_conflict_engine_exception"
    status = 409

    def __init__(self, doc_id: str, expected, actual):
        super().__init__(
            f"[{doc_id}]: version conflict, required [{expected}], current [{actual}]"
        )


class PrimaryFencedError(OpenSearchTpuError):
    """The node executing a write no longer holds the primary slot at the
    current primary term — a replica fenced its replication op, or the
    routing entry moved on before the ack (index/shard/ShardNotInPrimaryMode
    / the reference's isPrimaryMode fencing).

    503, not 409: the WRITE may well succeed against the new primary — the
    coordinator/client should re-route and retry, never treat the fence as
    a document-level conflict.  Critically this is raised INSTEAD of an
    ack: an op that was fenced is not durable and must not be reported as
    such."""

    status = 503


class CircuitBreakingError(OpenSearchTpuError):
    """Memory budget exceeded (common/breaker/CircuitBreakingException)."""

    status = 429

    def __init__(self, breaker: str, wanted: int, limit: int):
        super().__init__(
            f"[{breaker}] data for would be [{wanted}] bytes, larger than limit [{limit}]",
            breaker=breaker,
            bytes_wanted=wanted,
            limit=limit,
        )


class ClusterBlockException(OpenSearchTpuError):
    """Operation rejected by an index-level block, e.g. writes to a
    searchable-snapshot index (cluster/block/ClusterBlockException)."""

    status = 403


class TaskCancelledError(OpenSearchTpuError):
    status = 400


class EngineClosedError(OpenSearchTpuError):
    status = 500


class ShardNotFoundError(ResourceNotFoundError):
    pass


class NodeDisconnectedError(OpenSearchTpuError):
    """Transport-level peer failure (transport/NodeDisconnectedException).

    503, not 500: the condition is transient from the caller's side —
    retry against another copy / later — and the REST layer surfaces it
    as service-unavailable with the error type intact."""

    status = 503


class NoShardAvailableError(OpenSearchTpuError):
    """Every copy of a shard failed (NoShardAvailableActionException)."""

    wire_name = "no_shard_available_action_exception"
    status = 503


class NodeDuressError(OpenSearchTpuError):
    """Coordinator-side load shed: every in-sync copy of the shard
    reported duress, so the query phase fails fast into
    ``_shards.failures[]`` instead of queueing onto a collapsing node
    (429-class — the client should back off and retry)."""

    wire_name = "node_duress_exception"
    status = 429
    retry_after_seconds = 1


class SearchPhaseExecutionError(OpenSearchTpuError):
    """Shard failures the coordinator could not paper over — raised when
    partial results are disallowed (``allow_partial_search_results:
    false``) or no shard answered at all
    (action/search/SearchPhaseExecutionException)."""

    wire_name = "search_phase_execution_exception"
    status = 503

    def __init__(self, phase: str, reason: str,
                 shard_failures: "list[dict] | None" = None):
        super().__init__(reason)
        self.phase = phase
        self.shard_failures = shard_failures or []

    def to_xcontent(self) -> dict:
        out = super().to_xcontent()
        out["error"]["phase"] = self.phase
        out["error"]["failed_shards"] = self.shard_failures
        return out


class NotYetPortedError(IllegalArgumentError):
    """A feature the JAX package serves but this package does not yet:
    raised instead of computing something else silently (HTTP 501)."""

    status = 501
