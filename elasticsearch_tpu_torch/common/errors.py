"""Error taxonomy.

The reference maps exceptions to HTTP status codes via
``ElasticsearchException.status()`` (core/ElasticsearchException.java); each
error here carries its REST status so the REST layer
(a REST layer) can serialize ES-compatible error bodies.
"""

from __future__ import annotations


class ElasticsearchTpuError(Exception):
    """Base class; mirrors core/ElasticsearchException.java."""

    status = 500
    error_type = "exception"

    def __init__(self, message: str, index: str | None = None, shard: int | None = None):
        super().__init__(message)
        self.message = message
        self.index = index
        self.shard = shard

    def to_xcontent(self) -> dict:
        body: dict = {"type": self.error_type, "reason": self.message}
        if self.index is not None:
            body["index"] = self.index
        if self.shard is not None:
            body["shard"] = self.shard
        return body


class IllegalArgumentError(ElasticsearchTpuError):
    status = 400
    error_type = "illegal_argument_exception"


class IndexNotFoundError(ElasticsearchTpuError):
    status = 404
    error_type = "index_not_found_exception"

    def __init__(self, index: str):
        super().__init__(f"no such index [{index}]", index=index)


class IndexAlreadyExistsError(ElasticsearchTpuError):
    status = 400
    error_type = "index_already_exists_exception"

    def __init__(self, index: str):
        super().__init__(f"already exists [{index}]", index=index)


class DocumentMissingError(ElasticsearchTpuError):
    status = 404
    error_type = "document_missing_exception"

    def __init__(self, index: str, doc_id: str):
        super().__init__(f"[{doc_id}]: document missing", index=index)
        self.doc_id = doc_id


class VersionConflictError(ElasticsearchTpuError):
    """Optimistic-concurrency failure (reference: VersionConflictEngineException,
    raised from InternalEngine.innerIndex version check,
    core/index/engine/InternalEngine.java:359)."""

    status = 409
    error_type = "version_conflict_engine_exception"

    def __init__(self, index: str, doc_id: str, current: int, expected: int):
        super().__init__(
            f"[{doc_id}]: version conflict, current [{current}], provided [{expected}]",
            index=index,
        )
        self.doc_id = doc_id
        self.current_version = current
        self.expected_version = expected


class MapperParsingError(ElasticsearchTpuError):
    status = 400
    error_type = "mapper_parsing_exception"


class NotPortedError(IllegalArgumentError):
    """A feature of the JAX package that this PyTorch port does not
    serve yet (ROADMAP queue A lists what is still to come)."""
    error_type = "not_ported_exception"


class QueryParsingError(ElasticsearchTpuError):
    status = 400
    error_type = "query_parsing_exception"


class RoutingMissingError(ElasticsearchTpuError):
    """A _parent-mapped type requires routing/parent on every doc op
    (reference: RoutingMissingException, 400)."""
    status = 400
    error_type = "routing_missing_exception"


class AlreadyExpiredError(ElasticsearchTpuError):
    """Doc's ttl (counted from its _timestamp) elapsed before indexing
    (reference: AlreadyExpiredException)."""
    status = 400
    error_type = "already_expired_exception"


class IndexClosedError(ElasticsearchTpuError):
    """Operation explicitly targeting a closed index (ref:
    indices/IndexClosedException.java → RestStatus.FORBIDDEN)."""
    status = 403
    error_type = "index_closed_exception"


class ShardNotFoundError(ElasticsearchTpuError):
    status = 404
    error_type = "shard_not_found_exception"


class EngineClosedError(ElasticsearchTpuError):
    status = 409
    error_type = "engine_closed_exception"


class TranslogCorruptedError(ElasticsearchTpuError):
    """Checksum/frame failure replaying the WAL (reference:
    TranslogCorruptedException, core/index/translog/)."""

    status = 500
    error_type = "translog_corrupted_exception"


class SearchContextMissingError(ElasticsearchTpuError):
    """Scroll id refers to an expired/freed context (reference:
    SearchContextMissingException; contexts registry
    core/search/SearchService.java:533-558)."""

    status = 404
    error_type = "search_context_missing_exception"


class TaskCancelledError(ElasticsearchTpuError):
    """A cancellable task observed its cancellation flag at a checkpoint
    (reference: TaskCancelledException, core/tasks/ — cooperative
    cancellation; crosses the transport by class name so the coordinator
    sees the child's cancellation as what it is, not a generic 500)."""

    status = 400
    error_type = "task_cancelled_exception"


class CircuitBreakingError(ElasticsearchTpuError):
    """Memory circuit breaker tripped (reference:
    core/common/breaker/CircuitBreakingException.java)."""

    status = 429
    error_type = "circuit_breaking_exception"

    def __init__(self, message: str, bytes_wanted: int = 0, bytes_limit: int = 0):
        super().__init__(message)
        self.bytes_wanted = bytes_wanted
        self.bytes_limit = bytes_limit


class UnavailableShardsError(ElasticsearchTpuError):
    """No active copy of the target shard (reference:
    UnavailableShardsException, raised by TransportReplicationAction when
    the primary never becomes active within the timeout)."""

    status = 503
    error_type = "unavailable_shards_exception"


class MasterNotDiscoveredError(ElasticsearchTpuError):
    """No elected master to forward a metadata operation to (reference:
    MasterNotDiscoveredException, TransportMasterNodeAction.java:50)."""

    status = 503
    error_type = "master_not_discovered_exception"


class ClusterBlockError(ElasticsearchTpuError):
    """Operation refused by a cluster-level block (reference:
    ClusterBlockException, core/cluster/block/ClusterBlocks.java — e.g. the
    discovery no-master block rejects writes on a node that lost its
    quorum, `discovery.zen.no_master_block`)."""

    status = 503
    error_type = "cluster_block_exception"


def _all_subclasses(cls) -> list:
    out = []
    for sub in cls.__subclasses__():
        out.append(sub)
        out.extend(_all_subclasses(sub))
    return out


def reconstruct_error(py_class_name: str, reason: str) -> ElasticsearchTpuError:
    """Rebuild a local error instance from a remote failure that crossed
    the transport as (class name, reason) — the analog of the reference's
    RemoteTransportException.unwrapCause() so callers (and the REST layer)
    see the original status/type regardless of which node raised it."""
    cls = next((c for c in _all_subclasses(ElasticsearchTpuError)
                if c.__name__ == py_class_name), ElasticsearchTpuError)
    err = cls.__new__(cls)
    Exception.__init__(err, reason)
    err.message = reason
    err.index = None
    err.shard = None
    return err


class TypeMissingError(ElasticsearchTpuError):
    """Requested mapping type absent (reference: TypeMissingException)."""

    status = 404
    error_type = "type_missing_exception"
