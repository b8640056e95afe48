"""The port's CUDA kernels against their plain PyTorch versions, on the card.

K1 (BM25 scan) must be bit-identical to its plain version; K2 (stable
top-k) must return the same ids and scores, ties included. These tests need
an NVIDIA GPU and nvcc (the kernels have no CPU mode) and skip elsewhere.
On a machine with a card, run them without the JAX test bootstrap:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops import lexical, topk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _segment(rng, n, u, vocab):
    uterms = np.full((n, u), -1, np.int32)
    utf = np.zeros((n, u), np.float32)
    counts = rng.integers(0, u + 1, size=n)
    for i, c in enumerate(counts):
        uterms[i, :c] = np.sort(rng.choice(vocab, size=c, replace=False))
        utf[i, :c] = rng.integers(1, 9, size=c)
    doc_len = (utf.sum(axis=1) + rng.integers(0, 4, size=n)).astype(np.int32)
    doc_len[::97] = 0
    return uterms, utf, doc_len


@pytest.mark.parametrize("n_terms,trailing_pad,b", [(4, True, 0.75),
                                                    (11, False, 0.75),
                                                    (3, True, 1.0)])
def test_bm25_scan_bit_identical_to_plain(cuda, n_terms, trailing_pad, b):
    rng = np.random.default_rng(n_terms)
    vocab = 300
    uterms, utf, doc_len = _segment(rng, 5000, 24, vocab)
    n_queries = 9
    qtids = rng.integers(-1, vocab, size=(n_queries, n_terms)).astype(
        np.int32)
    qtids[0, -1] = qtids[0, 0]                    # repeated term
    qidf = rng.uniform(0.0, 5.0, size=qtids.shape).astype(np.float32)
    qweight = rng.uniform(0.5, 2.0, size=qtids.shape).astype(np.float32)
    avgdl = rng.uniform(1.0, 40.0, size=n_queries).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda)
            for a in (uterms, utf, doc_len, qtids, qidf, qweight)]
    avg = torch.from_numpy(avgdl).to(cuda)
    before = lexical.BM25_SCAN.launches
    got_s, got_n = lexical.bm25_match_batch(*args, 1.2, b, avg,
                                            trailing_pad=trailing_pad)
    torch.cuda.synchronize()
    assert lexical.BM25_SCAN.launches == before + 1
    want_s, want_n = lexical.bm25_match_batch_plain(*args, 1.2, b, avg)
    assert torch.equal(got_n, want_n)
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))


def _scan_inputs(rng, n, u, n_queries, n_terms, vocab):
    """A segment whose first rows are all pads and next rows have no pad,
    and a batch with a repeated and an absent (-1) query term."""
    uterms, utf, doc_len = _segment(rng, n, u, vocab)
    uterms[:3] = -1
    utf[:3] = 0.0
    for i in range(3, min(6, n)):
        uterms[i] = np.sort(rng.choice(vocab, size=u, replace=False))
        utf[i] = rng.integers(1, 9, size=u)
    qtids = rng.integers(-1, vocab, size=(n_queries, n_terms)).astype(
        np.int32)
    qtids[0, -1] = qtids[0, 0]
    qtids[-1, 0] = -1
    qidf = rng.uniform(0.0, 5.0, size=qtids.shape).astype(np.float32)
    qweight = rng.uniform(0.5, 2.0, size=qtids.shape).astype(np.float32)
    avgdl = rng.uniform(1.0, 40.0, size=n_queries).astype(np.float32)
    return uterms, utf, doc_len, qtids, qidf, qweight, avgdl


@pytest.mark.parametrize(
    "n,u,n_queries,n_terms,trailing_pad,b,want_nmatch",
    [(130, 45, 65, 4, True, 0.75, True),      # N, U off the tile; B = 65
     (130, 45, 65, 4, True, 0.75, False),
     (257, 1, 1, 1, True, 0.75, True),        # U = 1, B = 1, T = 1
     (300, 40, 64, 40, True, 0.75, True),     # T = 40: query groups
     (300, 40, 64, 40, False, 1.0, False),
     (200, 33, 3, 600, False, 0.75, True),    # T past one table: chunks
     (1000, 64, 64, 4, True, 1.0, False)])    # b = 1 with dl = 0 rows
def test_bm25_scan_edge_shapes_bit_identical(cuda, n, u, n_queries, n_terms,
                                             trailing_pad, b, want_nmatch):
    rng = np.random.default_rng(n * 7 + n_terms)
    vocab = max(2 * u, 3 * n_terms, 50)
    arrays = _scan_inputs(rng, n, u, n_queries, n_terms, vocab)
    if trailing_pad:
        assert not ((arrays[0][:, 1:] >= 0) & (arrays[0][:, :-1] < 0)).any()
    else:                                   # pads in mid-row
        arrays[0][6::5, 0] = -1
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in arrays[:6]]
    avg = torch.from_numpy(arrays[6]).to(cuda)
    before = lexical.BM25_SCAN.launches
    got_s, got_n = lexical.bm25_match_batch(
        *args, 1.2, b, avg, trailing_pad=trailing_pad,
        want_nmatch=want_nmatch)
    torch.cuda.synchronize()
    assert lexical.BM25_SCAN.launches == before + 1
    want_s, want_n = lexical.bm25_match_batch_plain(
        *args, 1.2, b, avg, want_nmatch=want_nmatch)
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))
    if want_nmatch:
        assert torch.equal(got_n, want_n)
    else:
        assert got_n is None and want_n is None


@pytest.mark.parametrize("rows,m,k,levels", [(3, 1, 5, 2), (4, 100, 10, 3),
                                             (2, 70000, 1000, 0),
                                             (2, 70000, 1000, 5),
                                             (1, 20000, 10000, 0),
                                             (3, 3000, 4000, 4)])
def test_stable_topk_matches_plain(cuda, rows, m, k, levels):
    """levels 0: continuous scores; otherwise scores rounded to `levels`
    values, so almost every entry ties."""
    rng = np.random.default_rng(m + k)
    scores = rng.standard_normal((rows, m)).astype(np.float32)
    if levels:
        scores = np.round(scores * levels / 3).astype(np.float32)
    scores[rng.random((rows, m)) < 0.05] = -np.inf
    mask = rng.random((rows, m)) < 0.8
    s, msk = torch.from_numpy(scores).to(cuda), torch.from_numpy(mask).to(cuda)
    before = topk.TOPK.launches
    got = topk.select_top_k(s, k, mask=msk)
    torch.cuda.synchronize()
    assert topk.TOPK.launches == before + 1
    want = topk.select_top_k_plain(s, k, mask=msk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _chunked_case(case, rng):
    """(scores, mask, ids, k) for one K2 case around its chunk size."""
    c = topk.CHUNK
    if case in ("below", "at", "above", "odd"):
        m = {"below": c - 1, "at": c, "above": c + 1, "odd": 2 * c + 3}[case]
        scores = np.round(rng.standard_normal((3, m)) * 2).astype(np.float32)
        return scores, rng.random((3, m)) < 0.7, None, 1000
    if case == "masked_chunks":             # chunks 1 and 3 wholly masked
        m = 5 * c
        scores = rng.standard_normal((2, m)).astype(np.float32)
        mask = rng.random((2, m)) < 0.5
        mask[:, c:2 * c] = False
        mask[:, 3 * c:4 * c] = False
        return scores, mask, None, 1000
    if case == "tied_run_across_chunks":    # position order across chunks
        m = 3 * c
        scores = np.full((2, m), 0.5, np.float32)
        scores[:, c - 300:c + 2000] = 1.0
        mask = np.ones((2, m), bool)
        mask[1, c + 10:c + 20] = False
        return scores, mask, None, 1000
    if case == "all_tied":
        return np.ones((2, 3 * c), np.float32), None, None, 4000
    if case == "tied_past_the_list":        # the row's bin outgrows its list
        return np.ones((1, 40 * c), np.float32), None, None, 1000
    if case == "few_eligible":              # fewer than k, spread thin
        m = 4 * c
        scores = rng.standard_normal((2, m)).astype(np.float32)
        return scores, rng.random((2, m)) < 0.003, None, 1000
    if case == "max_k":
        m = 40000
        scores = np.round(rng.standard_normal((2, m)) * 3).astype(np.float32)
        return scores, rng.random((2, m)) < 0.9, None, topk.MAX_K
    if case == "signed_zeros":              # -0 ties +0, position asc
        m = 2 * c + 100
        scores = np.where(rng.random((2, m)) < 0.5, 0.0, -0.0).astype(
            np.float32)
        scores[:, ::1000] = 1.0
        return scores, None, None, 2000
    if case == "ids_with_holes":
        m = 3 * c
        scores = np.round(rng.standard_normal((2, m)) * 2).astype(np.float32)
        ids = rng.permutation(10 ** 7)[:2 * m].reshape(2, m).astype(np.int32)
        ids[rng.random((2, m)) < 0.2] = -1
        return scores, None, ids, 1000
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "below", "at", "above", "odd", "masked_chunks", "tied_run_across_chunks",
    "all_tied", "tied_past_the_list", "few_eligible", "max_k", "signed_zeros",
    "ids_with_holes"])
def test_stable_topk_chunked_rows_match_plain(cuda, case):
    """Rows around and past K2's chunk size, ties across chunk boundaries."""
    rng = np.random.default_rng(len(case))
    scores, mask, ids, k = _chunked_case(case, rng)
    s, msk, i = (None if a is None else torch.from_numpy(a).to(cuda)
                 for a in (scores, mask, ids))
    before = topk.TOPK.launches
    got = topk.select_top_k(s, k, mask=msk, ids=i)
    torch.cuda.synchronize()
    assert topk.TOPK.launches == before + 1
    want = topk.select_top_k_plain(s, k, mask=msk, ids=i)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the signs of tied zeros come back as stored
    assert torch.equal(torch.signbit(got[0]), torch.signbit(want[0]))


def test_stable_topk_explicit_ids_match_plain(cuda):
    rng = np.random.default_rng(3)
    scores = np.round(rng.standard_normal((5, 2000)) * 2).astype(np.float32)
    ids = rng.permutation(10 ** 6)[:10000].reshape(5, 2000).astype(np.int32)
    ids[rng.random((5, 2000)) < 0.2] = -1
    s = torch.from_numpy(scores).to(cuda)
    i = torch.from_numpy(ids).to(cuda)
    got = topk.select_top_k(s, 1000, ids=i)
    want = topk.select_top_k_plain(s, 1000, ids=i)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kernels_refuse_what_they_do_not_take(cuda):
    s = torch.zeros((2, 8), device=cuda)
    with pytest.raises(TypeError):
        topk.select_top_k(s, 3, ids=torch.zeros((2, 8), dtype=torch.int64,
                                                 device=cuda))
    with pytest.raises(ValueError):
        topk.select_top_k(s[:, ::2], 3)
    with pytest.raises(ValueError):
        topk.select_top_k(s, 3, mask=torch.ones((2, 8), dtype=torch.bool))


def test_main_path_on_the_card_matches_the_cpu(cuda, tmp_path):
    """query_phase_batch on the card (K1, K2) returns what the plain
    versions return on the CPU, and both kernels were launched."""
    from elasticsearch_tpu_torch.index.device_reader import device_reader_for
    from elasticsearch_tpu_torch.index.engine import Engine
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.search.phase import (
        ShardSearcher, parse_search_request)
    rng = np.random.default_rng(9)
    words = [f"w{i}" for i in range(50)]
    ms = MapperService()
    ms.merge("_doc", {"properties": {"body": {"type": "text"}}})
    eng = Engine(tmp_path / "e", ms)
    for i in range(400):
        eng.index(str(i), {"body": " ".join(
            rng.choice(words, size=int(rng.integers(1, 20))))})
        if i == 200:
            eng.refresh()
    eng.refresh()
    reqs = [parse_search_request({"query": {"match": {
        "body": " ".join(rng.choice(words, size=3))}}, "size": 50})
        for _ in range(16)]
    on_cpu = ShardSearcher(0, device_reader_for(eng, device="cpu"), ms)
    want = on_cpu.query_phase_batch(reqs)
    on_card = ShardSearcher(0, device_reader_for(eng, device=cuda), ms)
    k1, k2 = lexical.BM25_SCAN.launches, topk.TOPK.launches
    got = on_card.query_phase_batch(reqs)
    assert lexical.BM25_SCAN.launches == k1 + 2     # one per segment
    assert topk.TOPK.launches == k2 + 3             # per segment + merge
    for g, w in zip(got, want):
        assert g.total == w.total
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        np.testing.assert_array_equal(g.scores, w.scores)


def test_main_path_counting_plan_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A match with minimum_should_match reads K1's nmatch on the card."""
    from elasticsearch_tpu_torch.index.device_reader import device_reader_for
    from elasticsearch_tpu_torch.index.engine import Engine
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.search.phase import (
        ShardSearcher, parse_search_request)
    rng = np.random.default_rng(10)
    words = [f"w{i}" for i in range(30)]
    ms = MapperService()
    ms.merge("_doc", {"properties": {"body": {"type": "text"}}})
    eng = Engine(tmp_path / "e", ms)
    for i in range(300):
        eng.index(str(i), {"body": " ".join(
            rng.choice(words, size=int(rng.integers(1, 15))))})
    eng.refresh()
    reqs = [parse_search_request({"query": {"match": {"body": {
        "query": " ".join(rng.choice(words, size=4)),
        "minimum_should_match": 2}}}, "size": 20}) for _ in range(8)]
    want = ShardSearcher(0, device_reader_for(eng, device="cpu"),
                         ms).query_phase_batch(reqs)
    got = ShardSearcher(0, device_reader_for(eng, device=cuda),
                        ms).query_phase_batch(reqs)
    assert any(w.total for w in want)
    for g, w in zip(got, want):
        assert g.total == w.total
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        np.testing.assert_array_equal(g.scores, w.scores)
