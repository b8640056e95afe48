from elasticsearch_tpu_torch.search.query_dsl import parse_query

__all__ = ["parse_query"]
