"""Common runtime substrate (reference layer 1: core/common/).

Typed settings, error taxonomy, versioning, hashing.
"""

from elasticsearch_tpu_torch.common.settings import Settings, Setting
from elasticsearch_tpu_torch.common.errors import (
    ElasticsearchTpuError,
    IndexNotFoundError,
    IndexAlreadyExistsError,
    DocumentMissingError,
    VersionConflictError,
    MapperParsingError,
    QueryParsingError,
    IllegalArgumentError,
    ShardNotFoundError,
    EngineClosedError,
    TranslogCorruptedError,
    SearchContextMissingError,
)

__all__ = [
    "Settings",
    "Setting",
    "ElasticsearchTpuError",
    "IndexNotFoundError",
    "IndexAlreadyExistsError",
    "DocumentMissingError",
    "VersionConflictError",
    "MapperParsingError",
    "QueryParsingError",
    "IllegalArgumentError",
    "ShardNotFoundError",
    "EngineClosedError",
    "TranslogCorruptedError",
    "SearchContextMissingError",
]
