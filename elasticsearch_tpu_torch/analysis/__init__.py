from elasticsearch_tpu_torch.analysis.analyzers import (
    AnalysisRegistry,
    Analyzer,
    Token,
    standard_tokenizer,
    whitespace_tokenizer,
)

__all__ = [
    "AnalysisRegistry",
    "Analyzer",
    "Token",
    "standard_tokenizer",
    "whitespace_tokenizer",
]
