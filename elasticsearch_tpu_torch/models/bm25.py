"""BM25Retriever — the standalone lexical scoring pipeline.

Counterpart of ``elasticsearch_tpu/models/bm25.py``, the form of the
engine's match-query path that ``__graft_entry__.entry()`` exposes: a packed
text index (forward impact layout, index/segment.py) and one batched
BM25 + top-k pass — kernel K1 scores the whole batch in one launch and
kernel K2 selects each query's top-k in one launch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from elasticsearch_tpu_torch.analysis.analyzers import Analyzer, BUILTIN_ANALYZERS
from elasticsearch_tpu_torch.common.device import resolve_device
from elasticsearch_tpu_torch.index.device_reader import pads_trail
from elasticsearch_tpu_torch.ops import lexical, topk as topk_ops
from elasticsearch_tpu_torch.ops.similarity import BM25Params, idf as bm25_idf


@dataclass
class PackedTextIndex:
    """One field's forward impact index in packed (device-ready) form."""
    terms: dict[str, int]            # term → id
    uterms: np.ndarray               # [Np, U] int32
    utf: np.ndarray                  # [Np, U] float32
    doc_len: np.ndarray              # [Np] int32
    live: np.ndarray                 # [Np] bool
    df: np.ndarray                   # [V] int32
    num_docs: int
    total_tokens: int

    @property
    def avgdl(self) -> float:
        return self.total_tokens / max(self.num_docs, 1)

    @staticmethod
    def from_texts(texts: list[str], analyzer: Analyzer | None = None,
                   pad_docs: int | None = None,
                   max_unique: int | None = None) -> "PackedTextIndex":
        analyzer = analyzer or BUILTIN_ANALYZERS["english"]
        vocab: dict[str, int] = {}
        doc_counts = []
        doc_lens = []
        for text in texts:
            counts: dict[int, int] = {}
            toks = analyzer.terms(text)
            for t in toks:
                tid = vocab.setdefault(t, len(vocab))
                counts[tid] = counts.get(tid, 0) + 1
            doc_counts.append(counts)
            doc_lens.append(len(toks))
        n = len(texts)
        np_docs = pad_docs or n
        u = max_unique or max((len(c) for c in doc_counts), default=1)
        uterms = np.full((np_docs, u), -1, np.int32)
        utf = np.zeros((np_docs, u), np.float32)
        df = np.zeros(max(len(vocab), 1), np.int32)
        for i, counts in enumerate(doc_counts):
            for j, (tid, tf) in enumerate(sorted(counts.items())[:u]):
                uterms[i, j] = tid
                utf[i, j] = tf
                df[tid] += 1
        doc_len = np.zeros(np_docs, np.int32)
        doc_len[:n] = doc_lens
        live = np.zeros(np_docs, bool)
        live[:n] = True
        return PackedTextIndex(terms=vocab, uterms=uterms, utf=utf,
                               doc_len=doc_len, live=live, df=df, num_docs=n,
                               total_tokens=int(sum(doc_lens)))


def bm25_topk_batch(uterms, utf, doc_len, live, qtids, qidf, avgdl,
                    k: int, k1: float = 1.2, b: float = 0.75,
                    trailing_pad: bool = False):
    """Q queries → top-k (scores, doc ids): one K1 launch, one K2 launch.

    uterms/utf: [N, U]; doc_len/live: [N]; qtids/qidf: [Q, T]; avgdl: a
    float. Returns (top_scores [Q, k], top_docs [Q, k])."""
    n_queries = qtids.shape[0]
    dev = uterms.device
    scores, _ = lexical.bm25_match_batch(
        uterms, utf, doc_len, qtids, qidf,
        torch.ones(qtids.shape, dtype=torch.float32, device=dev), k1, b,
        torch.full((n_queries,), float(np.float32(avgdl)),
                   dtype=torch.float32, device=dev),
        trailing_pad=trailing_pad, want_nmatch=False)
    return topk_ops.top_k(scores, live[None, :] & (scores > 0), k)


class BM25Retriever:
    def __init__(self, index: PackedTextIndex,
                 analyzer: Analyzer | None = None,
                 params: BM25Params = BM25Params(), device=None):
        self.index = index
        self.analyzer = analyzer or BUILTIN_ANALYZERS["english"]
        self.params = params
        self.device = resolve_device(device)
        put = lambda a: torch.from_numpy(    # noqa: E731
            np.ascontiguousarray(a)).to(self.device)
        self.d_uterms = put(index.uterms)
        self.d_utf = put(index.utf)
        self.d_doc_len = put(index.doc_len)
        self.d_live = put(index.live)
        self.trailing_pad = pads_trail(self.d_uterms)

    def encode_queries(self, queries: list[str], pad_terms: int | None = None):
        """Analyze + resolve term ids and idf → packed [Q, T] arrays."""
        per_q = [self.analyzer.terms(q) for q in queries]
        t = pad_terms or max((len(x) for x in per_q), default=1)
        qtids = np.full((len(queries), t), -1, np.int32)
        qidf = np.zeros((len(queries), t), np.float32)
        n = self.index.num_docs
        for i, terms in enumerate(per_q):
            for j, term in enumerate(terms[:t]):
                tid = self.index.terms.get(term, -1)
                qtids[i, j] = tid
                if tid >= 0:
                    qidf[i, j] = bm25_idf(float(self.index.df[tid]), n)
        return qtids, qidf

    def search(self, queries: list[str], k: int = 10):
        qtids, qidf = self.encode_queries(queries)
        scores, docs = self.search_packed(
            torch.from_numpy(qtids).to(self.device),
            torch.from_numpy(qidf).to(self.device), k)
        return scores.cpu().numpy(), docs.cpu().numpy()

    def search_packed(self, qtids, qidf, k: int = 10):
        """Pre-encoded query path (no host analysis)."""
        return bm25_topk_batch(
            self.d_uterms, self.d_utf, self.d_doc_len, self.d_live,
            qtids, qidf, self.index.avgdl, k, self.params.k1, self.params.b,
            trailing_pad=self.trailing_pad)
