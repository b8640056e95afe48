from elasticsearch_tpu_torch.mapping.mapper import (
    MapperService,
    DocumentMapper,
    FieldMapper,
    ParsedDocument,
    ParsedField,
)

__all__ = [
    "MapperService",
    "DocumentMapper",
    "FieldMapper",
    "ParsedDocument",
    "ParsedField",
]
