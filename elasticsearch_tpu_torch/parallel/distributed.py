"""Distributed BM25 over a mesh's process group.

Counterpart of ``elasticsearch_tpu/parallel/distributed.py``: the
scatter-gather data plane of a packed text index cut into shards — the
global term statistics (the DFS round: ``psum`` of doc counts, token counts
and per-term df), BM25 and a top-k per shard, ``psum`` of the match counts,
``all_gather`` of the shards' candidates and a re-top-k — with no host
round trip between the shards.

The JAX package runs it as one ``shard_map`` program with one shard a
device. Here each rank of the mesh's group holds a contiguous block of
``spd = shards // mesh shard axis`` shards on its device (on one card all
of them) and runs its block eagerly: per shard one kernel K1 launch scores
the batch and counts each doc's matching terms (its ``nmatch``, the
reference's ``count_one``), one K2 launch keeps the shard's top-k; then the
group's ``psum`` and ``all_gather`` (:class:`parallel.mesh.Mesh`) and one K2
launch over the gathered candidates, positions as ids, so ties keep the
shard-major order of ``lax.top_k``. Global doc ids are ``shard · Np +
row``, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from elasticsearch_tpu_torch.index.device_reader import pads_trail
from elasticsearch_tpu_torch.ops import lexical, topk as topk_ops
from elasticsearch_tpu_torch.parallel.mesh import Mesh


def _local_bm25_topk(uterms, utf, doc_len, live, qtids, qidf, avgdl,
                     k: int, k1: float, b: float, doc_base: int,
                     trailing_pad: bool = False):
    """One shard: score the batch (K1, with each doc's matching-term count)
    and keep its top-k (K2) → (scores [Q, k], docs [Q, k] global ids,
    matched docs [Q] i32)."""
    n_queries = qtids.shape[0]
    scores, nmatch = lexical.bm25_match_batch(
        uterms, utf, doc_len, qtids, qidf,
        torch.ones(qtids.shape, dtype=torch.float32, device=uterms.device),
        k1, b, avgdl.expand(n_queries).contiguous(),
        trailing_pad=trailing_pad, want_nmatch=True)
    top_s, top_d = topk_ops.top_k(scores, live[None, :] & (scores > 0), k,
                                  doc_base=doc_base)
    hits = ((nmatch > 0) & live[None, :]).sum(dim=1, dtype=torch.int32)
    return top_s, top_d, hits


def distributed_bm25_step(mesh: Mesh, k: int, k1: float = 1.2,
                          b: float = 0.75):
    """The distributed query step for a mesh and k.

    Returns ``step(uterms, utf, doc_len, live, qtids, qdf, num_docs,
    total_tokens, trailing_pad=False) -> (scores [Q, k], docs [Q, k],
    total_hits [Q])`` over this rank's block of ``spd`` shards:
      uterms/utf: [spd, Np, U]; doc_len/live: [spd, Np];
      qtids: [spd, Q, T] per-shard term ids; qdf: [spd, Q, T] shard-local
      df, summed over every shard in the group → the global idf;
      num_docs / total_tokens: [spd] per-shard counts (summed likewise).
    """
    def step(uterms, utf, doc_len, live, qtids, qdf, num_docs, total_tokens,
             trailing_pad: bool = False):
        spd, n_rows = uterms.shape[0], uterms.shape[1]
        # ---- DFS: global collection statistics over the group -------------
        n_total = mesh.psum(num_docs.sum(dtype=torch.int32))
        toks_total = mesh.psum(total_tokens.to(torch.float32).sum())
        df_total = mesh.psum(qdf.sum(dim=0))                      # [Q, T]
        avgdl = toks_total / torch.clamp(n_total, min=1).to(torch.float32)
        nf = n_total.to(torch.float32)
        qidf = torch.where(
            df_total > 0,
            torch.log1p((nf - df_total + 0.5) / (df_total + 0.5)),
            torch.zeros_like(df_total))
        # ---- query phase: every local shard, scoring + top-k --------------
        base = mesh.shard_index() * spd
        local_s, local_d, hits = [], [], None
        for li in range(spd):
            ts, td, h = _local_bm25_topk(
                uterms[li], utf[li], doc_len[li], live[li], qtids[li], qidf,
                avgdl.reshape(1), k, k1, b, (base + li) * n_rows,
                trailing_pad)
            local_s.append(ts)
            local_d.append(td)
            hits = h if hits is None else hits + h
        total_hits = mesh.psum(hits)
        # ---- reduce: all_gather over the group + re-top-k ------------------
        all_s = mesh.all_gather(torch.stack(local_s))     # [S_m, spd, Q, k]
        all_d = mesh.all_gather(torch.stack(local_d))
        n_q = qtids.shape[1]
        flat_s = all_s.reshape(-1, n_q, k).permute(1, 0, 2).reshape(n_q, -1)
        flat_d = all_d.reshape(-1, n_q, k).permute(1, 0, 2).reshape(n_q, -1)
        top_s, pos, _ = topk_ops.select_top_k(flat_s.contiguous(), k)
        top_d = torch.where(
            pos >= 0, torch.gather(flat_d, 1, pos.clamp(min=0).long()), -1)
        return top_s, top_d, total_hits

    return step


class DistributedBM25:
    """Host-side wrapper: packs this rank's block of per-shard indexes
    onto its device and drives the distributed step (the coordinator role,
    minus all its RPCs)."""

    def __init__(self, mesh: Mesh, shard_indexes, analyzer=None,
                 k1: float = 1.2, b: float = 0.75):
        from elasticsearch_tpu_torch.analysis.analyzers import (
            BUILTIN_ANALYZERS)
        self.mesh = mesh
        self.analyzer = analyzer or BUILTIN_ANALYZERS["english"]
        self.k1, self.b = k1, b
        self.shards = list(shard_indexes)        # list[PackedTextIndex], len S
        s = len(self.shards)
        s_mesh = mesh.shape["shard"]
        if s == 0 or s % s_mesh:
            raise ValueError(f"{s} shards != mesh shard axis {s_mesh}")
        self.spd = s // s_mesh
        np_docs = max(sh.uterms.shape[0] for sh in self.shards)
        u = max(sh.uterms.shape[1] for sh in self.shards)

        def pad(a, rows, cols=None, fill=0):
            out_shape = (rows,) if cols is None else (rows, cols)
            out = np.full(out_shape, fill, a.dtype)
            out[tuple(slice(0, d) for d in a.shape)] = a
            return out

        lo = mesh.shard_index() * self.spd
        local = self.shards[lo:lo + self.spd]
        dev = mesh.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        self.np_docs = np_docs
        self.d_uterms = put(np.stack([pad(sh.uterms, np_docs, u, -1)
                                      for sh in local]))
        self.d_utf = put(np.stack([pad(sh.utf, np_docs, u, 0)
                                   for sh in local]))
        self.d_doc_len = put(np.stack([pad(sh.doc_len, np_docs, fill=0)
                                       for sh in local]))
        self.d_live = put(np.stack([pad(sh.live, np_docs, fill=False)
                                    for sh in local]))
        self.d_num_docs = put(np.asarray([sh.num_docs for sh in local],
                                         np.int32))
        # float32, not int32: a shard past ~2.1B tokens would wrap an int32
        # sum and invert BM25's length normalization
        self.d_total_tokens = put(np.asarray([sh.total_tokens
                                              for sh in local], np.float32))
        self.trailing_pad = all(pads_trail(t) for t in self.d_uterms)
        self._steps: dict[int, callable] = {}

    def device_bytes(self) -> int:
        """Bytes of this rank's shard columns on its device."""
        return sum(t.numel() * t.element_size() for t in (
            self.d_uterms, self.d_utf, self.d_doc_len, self.d_live,
            self.d_num_docs, self.d_total_tokens))

    def encode_queries(self, queries: list[str],
                       pad_terms: int | None = None):
        """→ qtids [S, Q, T] per-shard ids, qdf [S, Q, T] shard-local df."""
        per_q = [self.analyzer.terms(q) for q in queries]
        t = pad_terms or max((len(x) for x in per_q), default=1)
        s = len(self.shards)
        qtids = np.full((s, len(queries), t), -1, np.int32)
        qdf = np.zeros((s, len(queries), t), np.float32)
        for si, sh in enumerate(self.shards):
            for i, terms in enumerate(per_q):
                for j, term in enumerate(terms[:t]):
                    tid = sh.terms.get(term, -1)
                    qtids[si, i, j] = tid
                    if tid >= 0:
                        qdf[si, i, j] = sh.df[tid]
        return qtids, qdf

    def step_for(self, k: int):
        if k not in self._steps:
            self._steps[k] = distributed_bm25_step(self.mesh, k, self.k1,
                                                   self.b)
        return self._steps[k]

    def search(self, queries: list[str], k: int = 10):
        """→ (scores [Q, k] f32, docs [Q, k] global ids, totals [Q]) as
        numpy arrays."""
        qtids, qdf = self.encode_queries(queries)
        lo = self.mesh.shard_index() * self.spd
        dev = self.mesh.device
        step = self.step_for(k)
        scores, docs, totals = step(
            self.d_uterms, self.d_utf, self.d_doc_len, self.d_live,
            torch.from_numpy(qtids[lo:lo + self.spd]).to(dev),
            torch.from_numpy(qdf[lo:lo + self.spd]).to(dev),
            self.d_num_docs, self.d_total_tokens, self.trailing_pad)
        return (scores.cpu().numpy(), docs.cpu().numpy(),
                totals.cpu().numpy())

    def resolve(self, global_doc: int) -> tuple[int, int]:
        """global doc id → (shard, local doc)."""
        return divmod(int(global_doc), self.np_docs)
