"""Packaged retrieval pipelines: the standalone BM25 program."""

from elasticsearch_tpu_torch.models.bm25 import BM25Retriever, PackedTextIndex

__all__ = ["BM25Retriever", "PackedTextIndex"]
