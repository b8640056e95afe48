"""The port's CUDA kernels against their plain PyTorch versions, on the card.

K1 (BM25 scan), K3 (exact-phrase scan), K6 (quantized-impact scan) and K7
(block-max sweep: top-k and block counters) must be bit-identical to their
plain versions; K2 (stable top-k, also at k past one block's sort) must
return the same ids and scores, ties included; K8 (aggregation bucket
counts) must give equal counts. K4 (int8 cosine) and K5 (MaxSim, f32 and
int8 tokens) sum their dot products in another order than the plain
versions' matrix products, so they agree within 1e-5 absolute (unit
vectors; K5 adds 1e-6 relative for sums of up to 150 token maxima). K9
(masked double-double stats) must give the plain version's count and
extrema bit for bit and its f32 sums within 1e-6 relative (a tree against
torch's reduction order), the same bits on every run. K10 (the
percolator's match reduction) and K11 (sloppy-phrase scan) must be
bit-identical to their plain versions (NaN as NaN). These tests need
an NVIDIA GPU and nvcc (the kernels have no CPU mode) and skip elsewhere.
On a machine with a card, run them without the JAX test bootstrap:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.index.segment import (
    TextFieldColumn, build_impact_column, quantize_vectors)
from elasticsearch_tpu_torch.ops import (
    aggs_ops, blockmax, lexical, maxsim, percolate, phrase, topk, vector)

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
        return scores, rng.random((2, m)) < 0.9, None, topk.CHUNK
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


def _phrase_inputs(rng, n, length, n_queries, deltas, vocab=7):
    """Positions over a small vocabulary (phrases recur and overlap), ragged
    rows, -1 holes inside rows, empty rows, full rows; a batch with a
    repeated term, an absent term, and a phrase that runs past row ends."""
    lens = rng.integers(0, length + 1, size=n)
    lens[:2] = 0
    lens[2:5] = length
    tokens = np.full((n, length), -1, np.int32)
    for i, ln in enumerate(lens):
        tokens[i, :ln] = rng.integers(0, vocab, size=ln)
        if ln > 4 and i % 3 == 0:
            tokens[i, rng.integers(1, ln - 1)] = -1
    tokens[5, :6] = [1, 1, 1, 1, 0, 1]
    doc_len = (tokens >= 0).sum(axis=1).astype(np.int32)
    doc_len[7] = 0
    t = len(deltas)
    qtids = rng.integers(0, vocab, size=(n_queries, t)).astype(np.int32)
    qtids[0, :] = 1
    qtids[1, -1] = -1
    qtids[2, :] = tokens[3, length - t:length] if t <= length else 1
    sum_idf = rng.uniform(0.5, 8.0, size=n_queries).astype(np.float32)
    avgdl = rng.uniform(1.0, 30.0, size=n_queries).astype(np.float32)
    avgdl[1] = avgdl[0]
    return tokens, doc_len, qtids, sum_idf, avgdl


@pytest.mark.parametrize("n,length,n_queries,deltas,b", [
    (1001, 24, 3, (0,), 0.75),
    (1001, 24, 3, (0, 1, 3, 4, 6), 0.75),
    (4099, 40, 64, (0, 1), 1.0),
    (333, 20, 70, (0, 2), 0.3),             # two query groups
    (517, 300, 9, (0, 1), 0.75),            # rows past the staged window
    (64, 8, 5, (0, 9), 0.75),               # a gap wider than every row
])
def test_phrase_scan_bit_identical_to_plain(cuda, n, length, n_queries,
                                            deltas, b):
    rng = np.random.default_rng(n + len(deltas))
    tokens, doc_len, qtids, sum_idf, avgdl = _phrase_inputs(
        rng, n, length, n_queries, deltas)
    tk, dl, qt, si, av = (torch.from_numpy(a).to(cuda) for a in (
        tokens, doc_len, qtids, sum_idf, avgdl))
    extent = phrase.token_extent(tk)
    before = phrase.PHRASE_SCAN.launches
    got_s, got_m = phrase.phrase_score_batch(tk, dl, qt, deltas, si, 1.2, b,
                                             av, extent=extent)
    torch.cuda.synchronize()
    assert phrase.PHRASE_SCAN.launches == before + 1
    want_s, want_m = phrase.phrase_score_batch_plain(tk, dl, qt, list(deltas),
                                                     si, 1.2, b, av)
    assert torch.equal(got_m, want_m)
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))
    assert bool(want_m.any()) == (max(deltas) < length)


def test_phrase_scan_refuses_what_it_does_not_take(cuda):
    tk = torch.zeros((16, 8), dtype=torch.int32, device=cuda)
    dl = torch.ones(16, dtype=torch.int32, device=cuda)
    one = torch.ones(1, device=cuda)
    qt = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    ext = phrase.token_extent(tk)
    with pytest.raises(ValueError):          # a negative delta
        phrase.phrase_score_batch(tk, dl, qt, (0, -1), one, 1.2, 0.75, one,
                                  extent=ext)
    with pytest.raises(TypeError):
        phrase.phrase_score_batch(tk.long(), dl, qt, (0, 1), one, 1.2, 0.75,
                                  one, extent=ext)
    with pytest.raises(ValueError):
        phrase.phrase_score_batch(tk[:, ::2], dl, qt, (0, 1), one, 1.2, 0.75,
                                  one, extent=ext)
    with pytest.raises(ValueError):          # an extent of another shape
        phrase.phrase_score_batch(tk, dl, qt, (0, 1), one, 1.2, 0.75, one,
                                  extent=ext[:8])


def test_configs_2_and_3_on_the_card_match_the_cpu(cuda, tmp_path):
    """bool + match_phrase (K1, K3, K2) and function_score (K1, K2) through
    query_phase_batch on the card return what the plain versions return on
    the CPU."""
    from elasticsearch_tpu_torch.index.device_reader import DeviceReader
    from elasticsearch_tpu_torch.index.engine import Engine
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.search.phase import (
        ShardSearcher, parse_search_request)
    rng = np.random.default_rng(12)
    words = [f"w{i}" for i in range(12)]
    ms = MapperService()
    ms.merge("_doc", {"properties": {"body": {"type": "text"},
                                     "rank": {"type": "double"}}})
    eng = Engine(tmp_path / "e", ms)
    for i in range(400):
        eng.index(str(i), {"body": " ".join(
            rng.choice(words, size=int(rng.integers(1, 20)))),
            "rank": float(rng.uniform(0, 100))})
        if i == 200:
            eng.refresh()
    eng.refresh()
    phrase_reqs = [parse_search_request({"query": {"bool": {
        "must": [{"match": {"body": " ".join(rng.choice(words, size=2))}}],
        "should": [{"match_phrase": {
            "body": " ".join(rng.choice(words, size=2))}}]}}, "size": 50})
        for _ in range(16)]
    fs_reqs = [parse_search_request({"query": {"function_score": {
        "query": {"match": {"body": " ".join(rng.choice(words, size=4))}},
        "functions": [{"field_value_factor": {
            "field": "rank", "modifier": "log1p", "factor": 1.0}},
            {"gauss": {"rank": {"origin": 50, "scale": 20}}}],
        "score_mode": "multiply", "boost_mode": "multiply"}}, "size": 50})
        for _ in range(16)]
    view = eng.acquire_searcher()
    on_cpu = ShardSearcher(0, DeviceReader(view, device="cpu"), ms)
    on_card = ShardSearcher(0, DeviceReader(view, device=cuda), ms)
    want_phrase = on_cpu.query_phase_batch(phrase_reqs)
    want_fs = on_cpu.query_phase_batch(fs_reqs)
    k1, k3 = lexical.BM25_SCAN.launches, phrase.PHRASE_SCAN.launches
    got = on_card.query_phase_batch(phrase_reqs)
    assert lexical.BM25_SCAN.launches == k1 + 2
    assert phrase.PHRASE_SCAN.launches == k3 + 2
    assert any(w.total for w in want_phrase)
    for g, w in zip(got, want_phrase):
        assert g.total == w.total
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        np.testing.assert_array_equal(g.scores, w.scores)
    got = on_card.query_phase_batch(fs_reqs)
    assert lexical.BM25_SCAN.launches == k1 + 4
    assert phrase.PHRASE_SCAN.launches == k3 + 2
    for g, w in zip(got, want_fs):
        # log10 and exp on the card and on the CPU may differ by an ulp
        assert g.total == w.total
        np.testing.assert_allclose(g.scores, w.scores, rtol=1e-6, atol=0)
        assert set(g.doc_ids[:40].tolist()) <= set(w.doc_ids.tolist())


def _unit(rng, shape):
    v = rng.standard_normal(shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("b,n,d", [(64, 20000, 768), (3, 100003, 100),
                                   (65, 300, 16), (1, 7, 5)])
def test_int8_cosine_matches_plain(cuda, b, n, d):
    """K4 against its plain version, exists holes every fifth row, scale and
    offset from quantize_vectors over the padded column."""
    rng = np.random.default_rng(b + n)
    vecs = _unit(rng, (n, d))
    vecs[-2:] = 0.0                               # padding rows
    qcol = quantize_vectors(vecs, d)
    exists = np.ones(n, bool)
    exists[::5] = False
    qv = torch.from_numpy(qcol.qvecs).to(cuda)
    ex = torch.from_numpy(exists).to(cuda)
    qs = torch.from_numpy(rng.standard_normal((b, d)).astype(
        np.float32)).to(cuda)
    before = vector.INT8_COSINE.launches
    got = vector.cosine_scores_int8_batch(qv, qcol.scale, qcol.offset, ex, qs)
    torch.cuda.synchronize()
    assert vector.INT8_COSINE.launches == before + 1
    qn = vector.l2_normalize(qs)
    want = vector.cosine_scores_int8_batch_plain(
        qv, qcol.scale, qcol.offset, ex, qn, qn.sum(dim=-1))
    assert bool((got[:, ~ex] == 0).all())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _maxsim_inputs(rng, cuda, b, n, t, qt, d):
    toks = _unit(rng, (n, t, d))
    lens = rng.integers(0, t + 1, size=n).astype(np.int32)
    lens[:3] = 0
    lens[3] = t
    toks[np.arange(t)[None, :] >= lens[:, None]] = 0.0
    qs = _unit(rng, (b, qt, d))
    qmask = np.ones((b, qt), bool)
    qmask[0, -1] = False                          # a padded query token
    qs[0, -1] = 0.0
    if b > 1 and qt > 1:
        qmask[1, 0] = False                       # a hole in front
    return (toks, torch.from_numpy(lens).to(cuda),
            torch.from_numpy(qs).to(cuda), torch.from_numpy(qmask).to(cuda))


MAXSIM_SHAPES = [(4, 1000, 32, 32, 128), (3, 10007, 5, 3, 100),
                 (2, 300, 200, 150, 24), (5, 257, 1, 1, 7),
                 (64, 4096, 32, 32, 128)]


@pytest.mark.parametrize("b,n,t,qt,d", MAXSIM_SHAPES)
def test_maxsim_f32_matches_plain(cuda, b, n, t, qt, d):
    rng = np.random.default_rng(n + t)
    toks, lens, qs, qmask = _maxsim_inputs(rng, cuda, b, n, t, qt, d)
    tk = torch.from_numpy(toks).to(cuda)
    before = (maxsim.MAXSIM.launches, maxsim.MAXSIM_INT8.launches)
    got = maxsim.maxsim_scores_batch_body(tk, lens, qs, qmask)
    torch.cuda.synchronize()
    # the f32 instantiation ran, and not the int8 one
    assert (maxsim.MAXSIM.launches, maxsim.MAXSIM_INT8.launches) == (
        before[0] + 1, before[1])
    want = maxsim.maxsim_scores_batch_body_plain(tk, lens, qs, qmask)
    assert bool((got[:, :3] == 0).all())          # docs without tokens
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("b,n,t,qt,d", MAXSIM_SHAPES)
def test_maxsim_int8_matches_plain(cuda, b, n, t, qt, d):
    rng = np.random.default_rng(n + t + 1)
    toks, lens, qs, qmask = _maxsim_inputs(rng, cuda, b, n, t, qt, d)
    qcol = quantize_vectors(toks, d)
    tk = torch.from_numpy(qcol.qvecs).to(cuda)
    before = (maxsim.MAXSIM.launches, maxsim.MAXSIM_INT8.launches)
    got = maxsim.maxsim_scores_int8_batch_body(tk, qcol.scale, qcol.offset,
                                               lens, qs, qmask)
    torch.cuda.synchronize()
    # the int8 instantiation ran, and not the f32 one
    assert (maxsim.MAXSIM.launches, maxsim.MAXSIM_INT8.launches) == (
        before[0], before[1] + 1)
    want = maxsim.maxsim_scores_int8_batch_body_plain(
        tk, qcol.scale, qcol.offset, lens, qs, qmask, qs.sum(dim=2))
    assert bool((got[:, :3] == 0).all())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


def test_vector_kernels_refuse_what_they_do_not_take(cuda):
    qv = torch.zeros((8, 4), dtype=torch.int8, device=cuda)
    ex = torch.ones(8, dtype=torch.bool, device=cuda)
    qs = torch.ones((2, 4), device=cuda)
    with pytest.raises(TypeError):
        vector.cosine_scores_int8_batch(qv.float(), 1.0, 0.0, ex, qs)
    with pytest.raises(ValueError):
        vector.cosine_scores_int8_batch(qv, 1.0, 0.0, ex[:5], qs)
    toks = torch.zeros((8, 3, 4), device=cuda)
    lens = torch.ones(8, dtype=torch.int32, device=cuda)
    qt = torch.ones((2, 2, 4), device=cuda)
    qm = torch.ones((2, 2), dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        maxsim.maxsim_scores_batch_body(toks, lens.long(), qt, qm)
    with pytest.raises(ValueError):
        maxsim.maxsim_scores_batch_body(toks[:, :, :3], lens, qt, qm)
    with pytest.raises(ValueError):
        maxsim.maxsim_scores_batch_body(toks[:, ::2], lens, qt, qm)


def test_knn_lane_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Top-level knn (f32: torch.matmul, int8: K4), hybrid RRF and MaxSim
    (K5, f32 and int8) through query_phase_batch on the card return what
    the plain versions return on the CPU."""
    from elasticsearch_tpu_torch.index.device_reader import DeviceReader
    from elasticsearch_tpu_torch.index.engine import Engine
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.search import segment_exec
    from elasticsearch_tpu_torch.search.phase import (
        ShardSearcher, parse_search_request)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    rng = np.random.default_rng(21)
    ms = MapperService()
    ms.merge("_doc", {"properties": {
        "body": {"type": "text"}, "vec": {"type": "dense_vector", "dims": 48},
        "tok": {"type": "rank_vectors", "dims": 32, "max_tokens": 16}}})
    eng = Engine(tmp_path / "e", ms)
    for i in range(600):
        d = {"body": " ".join(f"w{x}" for x in rng.integers(0, 10, 6))}
        if i % 6:
            d["vec"] = rng.standard_normal(48).tolist()
            d["tok"] = rng.standard_normal(
                (int(rng.integers(1, 12)), 32)).tolist()
        eng.index(str(i), d)
        if i == 300:
            eng.refresh()
    eng.refresh()
    segment_exec.configure_knn_plane("card_int8",
                                     {"index.knn.quantization": "int8"})
    view = eng.acquire_searcher()
    batches = {
        "dense": [{"knn": {"field": "vec", "k": 20, "num_candidates": 40,
                           "query_vector": rng.standard_normal(48).tolist()},
                   "size": 20} for _ in range(8)],
        "hybrid": [{"query": {"match": {"body": "w1 w2"}},
                    "knn": {"field": "vec", "k": 20, "num_candidates": 40,
                            "query_vector": rng.standard_normal(48).tolist()},
                    "size": 30} for _ in range(8)],
        "maxsim": [{"knn": {"field": "tok", "k": 20, "num_candidates": 40,
                            "query_vector": rng.standard_normal(
                                (5, 32)).tolist()}, "size": 20}
                   for _ in range(8)],
    }
    for index in ("", "card_int8"):
        on_cpu = ShardSearcher(0, DeviceReader(view, device="cpu"), ms,
                               index_name=index)
        on_card = ShardSearcher(0, DeviceReader(view, device=cuda), ms,
                                index_name=index)
        for name, bodies in batches.items():
            reqs = [parse_search_request(b) for b in bodies]
            want = on_cpu.query_phase_batch(reqs)
            k4, k5, k5i = (vector.INT8_COSINE.launches,
                           maxsim.MAXSIM.launches,
                           maxsim.MAXSIM_INT8.launches)
            got = on_card.query_phase_batch(reqs)
            int8 = index == "card_int8"
            assert vector.INT8_COSINE.launches == k4 + (
                2 if int8 and name != "maxsim" else 0)
            assert maxsim.MAXSIM.launches == k5 + (
                2 if name == "maxsim" and not int8 else 0)
            assert maxsim.MAXSIM_INT8.launches == k5i + (
                2 if name == "maxsim" and int8 else 0)
            for g, w in zip(got, want):
                assert g.total == w.total
                if name == "hybrid":
                    np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
                    np.testing.assert_array_equal(g.scores, w.scores)
                else:
                    np.testing.assert_allclose(g.scores, w.scores, rtol=0,
                                               atol=1e-5)
                    assert set(g.doc_ids[:15].tolist()) <= \
                        set(w.doc_ids.tolist())


def _impact_segment(rng, n, u, vocab, bits, block_rows):
    """One segment's impact column (built as the lane builds it) with a term
    (id 0) whose impacts quantize to 0 (df = n: idf ~ 0), dead rows, and
    its (uterms, qimp, live, block_max) as card tensors."""
    uterms, utf, doc_len = _segment(rng, n, u, vocab)
    df = np.zeros(vocab, np.int64)
    np.add.at(df, uterms[uterms >= 0], 1)
    df[0] = n
    col = TextFieldColumn(terms=[str(i) for i in range(vocab)],
                          tokens=np.zeros((1, 1), np.int32), uterms=uterms,
                          utf=utf, doc_len=doc_len, df=df,
                          total_tokens=int(doc_len.sum()))
    icol = build_impact_column(col, df=df, doc_count=n,
                               avgdl=float(doc_len.mean()), bits=bits,
                               block_rows=block_rows)
    live = rng.random(n) > 0.05
    return icol, [torch.from_numpy(a).to(cuda_dev())
                  for a in (uterms, icol.qimp, live, icol.block_max)]


def cuda_dev():
    return torch.device("cuda", torch.cuda.current_device())


def _impact_queries(rng, b, t, vocab):
    qtids = rng.integers(0, vocab, size=(b, t)).astype(np.int32)
    qtids[0, 0] = 0                          # the zero-quantized term
    if t > 1:
        qtids[-1, -1] = -1
        qtids[1 % b, 1] = qtids[1 % b, 0]    # a repeated term
    return torch.from_numpy(qtids).to(cuda_dev())


@pytest.mark.parametrize("bits,trailing_pad", [(8, True), (16, False),
                                               (16, True)])
def test_impact_scan_bit_identical_to_plain(cuda, bits, trailing_pad):
    """K6 at an odd shape: B = 3, N = 100,003, T = 5, a cursor on one
    query, dead rows and a term quantized to 0."""
    rng = np.random.default_rng(bits)
    n, vocab = 100_003, 300
    _, (uterms, qimp, live, _) = _impact_segment(rng, n, 24, vocab, bits,
                                                 1 << 30)
    qtids = _impact_queries(rng, 3, 5, vocab)
    sb = torch.tensor([0.37, 1.5, 0.02], device=cuda)
    cs = torch.tensor([float("inf"), 30.0, float("inf")], device=cuda)
    cd = torch.tensor([-1, 5000, -1], dtype=torch.int32, device=cuda)
    before = blockmax.IMPACT_SCAN.launches
    got_s, got_v = blockmax.impact_scores_batch(
        uterms, qimp, qtids, sb, live, cs, cd, 7, trailing_pad=trailing_pad)
    torch.cuda.synchronize()
    assert blockmax.IMPACT_SCAN.launches == before + 1
    want_s, want_v = blockmax.impact_scores_batch_plain(
        uterms, qimp, qtids, sb, live, cs, cd, 7)
    assert torch.equal(got_v, want_v)
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))
    assert bool(want_v.any()) and bool((want_s[0][want_v[0]] >= 0).all())


def _sweep_case(rng, bits, k, carry_in, vocab=200):
    """Two segments' sweeps on the card and in the plain version; the
    second segment takes the first one's carry."""
    n, r = 8192, 256
    b = 4
    qtids = _impact_queries(rng, b, 3, vocab)
    sb = torch.tensor([0.5, 1.0, 2.0, 0.125], device=cuda_dev())
    cs = torch.full((b,), float("inf"), device=cuda_dev())
    cd = torch.full((b,), -1, dtype=torch.int32, device=cuda_dev())
    got = want = carry_in
    before = blockmax.BLOCKMAX_SWEEP.launches
    for base in (0, n):
        icol, (uterms, qimp, live, bmx) = _impact_segment(
            rng, n, 24, vocab, bits, r)
        ub_i = blockmax.block_bounds(bmx, qtids)
        ub_f, order = blockmax.sweep_order(ub_i, sb)
        args = (uterms, qimp, live, ub_i, ub_f, order, qtids, sb, cs, cd, k,
                base)
        got = blockmax.blockmax_sweep(got, *args, trailing_pad=True)
        want = blockmax.blockmax_sweep_plain(want, *args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert blockmax.BLOCKMAX_SWEEP.launches == before + 2
    return got


@pytest.mark.parametrize("bits,k,vocab", [(8, 1, 200), (16, 10, 200),
                                          (16, 1000, 200), (8, 1000, 5000)])
def test_blockmax_sweep_matches_plain(cuda, bits, k, vocab):
    """K7 against its plain version: top-k, scored, skipped and matched
    equal; k = 1, 10 and 1000, over a vocabulary of 5000 above every
    query's matches; a carry from a first segment into the second."""
    rng = np.random.default_rng(100 + k)
    out = _sweep_case(rng, bits, k, blockmax.pruned_carry_init(4, k, cuda),
                      vocab)
    assert (out[2] + out[3] == 2 * 32).all()
    if vocab == 5000:
        assert (out[1][:, -1] == -1).all()       # fewer matches than k


@pytest.mark.parametrize("b,u,trailing_pad", [(1, 24, True), (3, 150, True),
                                              (40, 150, False),
                                              (140, 100, True)])
def test_blockmax_sweep_any_cluster_size(cuda, b, u, trailing_pad):
    """K7 at batch sizes that give a query a cluster of 8, 8, 4 and 1
    thread blocks on an H100's 132 SMs (one or two 2048-row slices a thread
    block), rows longer than 64 cells (their later windows), with and
    without the first-pad stop: equal to its plain version."""
    rng = np.random.default_rng(b)
    n, r, k, vocab = 16384, 4096, 10, 400
    _, (uterms, qimp, live, bmx) = _impact_segment(rng, n, u, vocab, 16, r)
    qtids = _impact_queries(rng, b, 3, vocab)
    sb = torch.from_numpy(rng.uniform(0.1, 2.0, b).astype(np.float32)).to(
        cuda)
    cs = torch.full((b,), float("inf"), device=cuda)
    cd = torch.full((b,), -1, dtype=torch.int32, device=cuda)
    ub_i = blockmax.block_bounds(bmx, qtids)
    ub_f, order = blockmax.sweep_order(ub_i, sb)
    args = (uterms, qimp, live, ub_i, ub_f, order, qtids, sb, cs, cd, k, 0)
    carry = blockmax.pruned_carry_init(b, k, cuda)
    got = blockmax.blockmax_sweep(carry, *args, trailing_pad=trailing_pad)
    want = blockmax.blockmax_sweep_plain(carry, *args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert int(want[2].sum()) > 0 and int(want[4].sum()) > 0


def test_blockmax_sweep_skips_every_block_under_a_high_carry(cuda):
    rng = np.random.default_rng(7)
    k = 3
    high = (torch.full((4, k), 1e9, device=cuda),
            torch.arange(4 * k, dtype=torch.int32, device=cuda).view(4, k),
            torch.zeros(4, dtype=torch.int32, device=cuda),
            torch.zeros(4, dtype=torch.int32, device=cuda),
            torch.zeros(4, dtype=torch.int32, device=cuda))
    out = _sweep_case(rng, 16, k, high)
    assert out[2].tolist() == [0] * 4 and out[3].tolist() == [64] * 4
    assert torch.equal(out[1], high[1])


def test_impact_kernels_refuse_what_they_do_not_take(cuda):
    rng = np.random.default_rng(3)
    _, (uterms, qimp, live, bmx) = _impact_segment(rng, 1024, 8, 50, 16, 64)
    qtids = _impact_queries(rng, 2, 2, 50)
    one = torch.ones(2, device=cuda)
    cd = torch.full((2,), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        blockmax.impact_scores_batch(uterms, qimp.to(torch.int32), qtids,
                                     one, live, one, cd)
    with pytest.raises(ValueError):
        blockmax.impact_scores_batch(uterms, qimp, qtids, one, live[:-1],
                                     one, cd)
    with pytest.raises(ValueError):
        blockmax.impact_scores_batch(uterms, qimp, torch.zeros(
            (2, 128), dtype=torch.int32, device=cuda), one, live, one, cd)
    ub_i = blockmax.block_bounds(bmx, qtids)
    ub_f, order = blockmax.sweep_order(ub_i, one)
    carry = blockmax.pruned_carry_init(2, 4, cuda)
    with pytest.raises(ValueError):
        blockmax.blockmax_sweep(carry, uterms[:1000], qimp[:1000],
                                live[:1000], ub_i, ub_f, order, qtids, one,
                                one, cd, 4)
    with pytest.raises(TypeError):
        blockmax.blockmax_sweep(carry, uterms, qimp, live, ub_i, ub_f,
                                order.long(), qtids, one, one, cd, 4)


def test_impact_lane_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The impact lane's eager arm (K6 + K2), pruned arm (K7) and rescore
    arm through query_phase_batch on the card return, bit for bit, what
    the plain versions return on the CPU."""
    from elasticsearch_tpu_torch.index.device_reader import DeviceReader
    from elasticsearch_tpu_torch.index.engine import Engine
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.search import segment_exec
    from elasticsearch_tpu_torch.search.phase import (
        ShardSearcher, parse_search_request)
    rng = np.random.default_rng(31)
    ms = MapperService()
    ms.merge("_doc", {"properties": {"body": {"type": "text"}}})
    eng = Engine(tmp_path / "e", ms)
    for i in range(3000):
        eng.index(str(i), {"body": " ".join(
            f"w{min(int(x), 60)}" for x in rng.zipf(1.3, 9))})
        if i == 1500:
            eng.refresh()
    eng.refresh()
    eng.delete("7")
    eng.refresh()
    view = eng.acquire_searcher()
    rescore = {"window_size": 24, "query": {
        "rescore_query": {"match": {"body": "w3 w4"}},
        "query_weight": 0.7, "rescore_query_weight": 1.5,
        "score_mode": "total"}}
    bodies = [{"query": {"match": {"body": " ".join(
        f"w{x}" for x in rng.integers(1, 40, 3))}}, "size": 20}
        for _ in range(8)]
    batches = {"eager": bodies,
               "pruned": [dict(b, track_total_hits=False) for b in bodies],
               "rescore": [dict(b, rescore=rescore) for b in bodies]}
    for bits in (8, 16):
        name = f"card_impact{bits}"
        segment_exec.configure_impact_plane(name, {
            "index.search.impact_plane": True,
            "index.search.impact.bits": bits,
            "index.search.impact.block_rows": 128})
        on_cpu = ShardSearcher(0, DeviceReader(view, device="cpu"), ms,
                               index_name=name)
        on_card = ShardSearcher(0, DeviceReader(view, device=cuda), ms,
                                index_name=name)
        for arm, batch in batches.items():
            want = on_cpu.query_phase_batch(
                [parse_search_request(b) for b in batch])
            k6, k7 = (blockmax.IMPACT_SCAN.launches,
                      blockmax.BLOCKMAX_SWEEP.launches)
            got = on_card.query_phase_batch(
                [parse_search_request(b) for b in batch])
            assert blockmax.IMPACT_SCAN.launches == k6 + (
                0 if arm == "pruned" else 2)
            assert blockmax.BLOCKMAX_SWEEP.launches == k7 + (
                2 if arm == "pruned" else 0)
            for g, w in zip(got, want):
                assert g.total == w.total
                np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
                np.testing.assert_array_equal(g.scores.view(np.int32),
                                              w.scores.view(np.int32))


# ---------------------------------------------------------------------------
# K2 past one block's k, K8 and K9
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,levels,with_ids", [(20000, 0, False),
                                               (65536, 0, False),
                                               (20000, 3, False),
                                               (65536, 2, True),
                                               (40000, 0, True)])
def test_stable_topk_large_k_matches_plain(cuda, k, levels, with_ids):
    """k above topk.CHUNK over 2^20-entry rows: K2 selects the k best
    candidates, sorts them in tiles and merges the tiles; tie-heavy scores
    and explicit ids too, and a row with fewer eligible entries than k."""
    rng = np.random.default_rng(k + levels)
    m = 1 << 20
    scores = rng.standard_normal((2, m)).astype(np.float32)
    if levels:
        scores = np.round(scores * levels).astype(np.float32)
    mask = rng.random((2, m)) < 0.9
    mask[1, : m - k // 2] = False              # row 1: fewer than k
    ids = rng.permutation(1 << 24)[:2 * m].reshape(2, m).astype(np.int32) \
        if with_ids else None
    s, msk = torch.from_numpy(scores).to(cuda), torch.from_numpy(mask).to(cuda)
    i = None if ids is None else torch.from_numpy(ids).to(cuda)
    before = topk.TOPK.launches
    got = topk.select_top_k(s, k, mask=msk, ids=i)
    torch.cuda.synchronize()
    assert topk.TOPK.launches == before + 1
    want = topk.select_top_k_plain(s, k, mask=msk, ids=i)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("m,k,merge", [(262144, 20100, False),
                                       (20100, 20100, True),
                                       (20100 + 3, 20100, True)])
def test_stable_topk_deep_page_shapes_match_plain(cuda, m, k, merge):
    """The deep page's K2 calls: a shard segment's [1, 262,144] scores under
    its mask at k = 20,100, and the shard's merge of those 20,100 candidates
    (explicit ids, m = k: one full chunk and one of 3,716 entries), on
    BM25-like scores with ties."""
    rng = np.random.default_rng(m + k)
    scores = np.round(rng.random((1, m)) ** 3 * 20 * 4096) / 4096
    scores = scores.astype(np.float32)
    mask = ids = None
    if merge:
        ids = rng.permutation(1 << 20)[:m].reshape(1, m).astype(np.int32)
        ids[0, rng.random(m) < 0.05] = -1            # padding slots
    else:
        mask = torch.from_numpy(rng.random((1, m)) < 0.5).to(cuda)
    s = torch.from_numpy(scores).to(cuda)
    i = None if ids is None else torch.from_numpy(ids).to(cuda)
    got = topk.select_top_k(s, k, mask=mask, ids=i)
    want = topk.select_top_k_plain(s, k, mask=mask, ids=i)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kernel", ["stable_topk", "bm25_scan"])
def test_kernels_launch_from_many_threads_at_once(cuda, kernel):
    """Shards call the kernels from several threads at once, with shapes
    that take different shared memory (K2: a row split over chunks and a
    one-chunk row; K1: batches of 1 and 64 queries). Every launch must run
    and equal the plain version: no thread may lower a limit another
    thread's launch needs."""
    from concurrent.futures import ThreadPoolExecutor
    rng = np.random.default_rng(7)
    if kernel == "stable_topk":
        cases = []
        for m in (262144, 10, 3000):
            s = torch.from_numpy(rng.random((1, m)).astype(np.float32)).to(
                cuda)
            mask = torch.from_numpy(rng.random((1, m)) < 0.5).to(cuda)
            cases.append(((s, 10), {"mask": mask}))
        run, plain = topk.select_top_k, topk.select_top_k_plain
    else:
        vocab = 300
        uterms, utf, doc_len = _segment(rng, 20000, 24, vocab)
        cols = [torch.from_numpy(a).to(cuda) for a in (uterms, utf, doc_len)]
        cases = []
        for b, t in ((1, 4), (64, 4), (9, 11)):
            q = [torch.from_numpy(a).to(cuda) for a in (
                rng.integers(0, vocab, (b, t)).astype(np.int32),
                rng.uniform(0.1, 5.0, (b, t)).astype(np.float32),
                np.ones((b, t), np.float32),
                rng.uniform(1.0, 40.0, b).astype(np.float32))]
            cases.append(((*cols, *q[:3], 1.2, 0.75, q[3]), {}))
        run, plain = lexical.bm25_match_batch, lexical.bm25_match_batch_plain
    want = [plain(*a, **kw) for a, kw in cases]

    def worker(i):
        for j in range(40):
            c = (i + j) % len(cases)
            got = run(*cases[c][0], **cases[c][1])
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want[c]))
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(worker, range(8)))


def _agg_columns(cuda, n, seed, num_ords=16, k=1, dates=False):
    rng = np.random.default_rng(seed)
    ords = rng.integers(-1, num_ords, (n, k)).astype(np.int32)
    if dates:       # epoch millis, a third exactly on an hour's edge
        values = 1.5e12 + rng.integers(0, 48, n) * 3_600_000.0 + np.where(
            rng.random(n) < 0.3, 0.0, rng.integers(1, 3_600_000, n))
    else:
        values = rng.random(n) * 100.0
    hi = values.astype(np.float32)
    lo = (values - hi.astype(np.float64)).astype(np.float32)
    exists = rng.random(n) < 0.95
    mask = rng.random(n) < 0.6
    t = lambda a: torch.from_numpy(a).to(cuda)   # noqa: E731
    return {"ords": t(ords), "hi": t(hi), "lo": t(lo), "exists": t(exists),
            "mask": t(mask), "values": values}


@pytest.mark.parametrize("n,num_ords,k", [(262144, 16, 1), (100003, 16, 1),
                                          (100003, 50000, 2), (7, 3, 3)])
def test_agg_counts_ordinal_matches_plain(cuda, n, num_ords, k):
    """Ordinal mode: a shared-memory histogram, and a 50,000-ord vocabulary
    past it (global atomics)."""
    c = _agg_columns(cuda, n, n + k, num_ords, k)
    before = aggs_ops.AGG_COUNTS.launches
    got = aggs_ops.ord_counts(c["ords"], c["mask"], num_ords)
    torch.cuda.synchronize()
    assert aggs_ops.AGG_COUNTS.launches == before + 1
    assert torch.equal(got, aggs_ops.ord_value_counts(c["ords"], c["mask"],
                                                       num_ords))
    empty = torch.zeros_like(c["mask"])
    assert int(aggs_ops.ord_counts(c["ords"], empty, num_ords).sum()) == 0


@pytest.mark.parametrize("n,dates,interval,nb", [
    (262144, False, 5.0, 20), (100003, False, 0.37, 271),
    (100003, True, 3_600_000.0, 48), (100003, True, 1000.0, 10000)])
def test_agg_counts_histogram_matches_plain(cuda, n, dates, interval, nb):
    """dd-histogram mode, bucket index rounded as XLA's f32 ops: the rank
    histogram at interval 5, an interval no power of two divides, and
    epoch-millis dates at 1h with docs exactly on bucket edges (and 1 s
    buckets up to the 10,000 the device path takes)."""
    c = _agg_columns(cuda, n, n + nb, dates=dates)
    vals = c["values"]
    base = float(np.floor(vals.min() / interval) * interval)
    bhi = np.float32(base)
    blo = np.float32(base - np.float64(bhi))
    args = (c["hi"], c["lo"], c["exists"], c["mask"], float(bhi), float(blo),
            interval, nb)
    got = aggs_ops.dd_histogram_counts(*args)
    torch.cuda.synchronize()
    want = aggs_ops.histogram_counts_dd(*args)
    assert torch.equal(got, want)
    assert int(got.sum()) > 0


def test_agg_counts_ranges_matches_plain(cuda):
    """Ranges mode: bench-style ranges, a `to: 0` range, overlaps, an upper
    bound on a stored value, an empty mask."""
    c = _agg_columns(cuda, 100003, 3)
    v = float(c["values"][11])
    bounds = [(-np.inf, 25.0), (25.0, 75.0), (75.0, np.inf), (-np.inf, 0.0),
              (10.0, v), (v, 90.0), (-np.inf, np.inf)]
    dd, strict = aggs_ops.range_bounds_dd(bounds)
    dd, strict = torch.from_numpy(dd).to(cuda), torch.from_numpy(strict).to(
        cuda)
    for mask in (c["mask"], torch.zeros_like(c["mask"])):
        args = (c["hi"], c["lo"], c["exists"], mask, dd, strict)
        got = aggs_ops.dd_range_counts(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, aggs_ops.dd_range_counts_plain(*args))


def _assert_stats_equal(got, want):
    g, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(g[:5], w[:5])
    np.testing.assert_allclose(g[5:], w[5:], rtol=1e-6)


@pytest.mark.parametrize("n,dates", [(262144, False), (100003, True),
                                     (1, False)])
def test_agg_stats_matches_plain_and_repeats_its_bits(cuda, n, dates):
    c = _agg_columns(cuda, n, n, dates=dates)
    args = (c["hi"], c["lo"], c["exists"], c["mask"])
    before = aggs_ops.AGG_STATS.launches
    got = aggs_ops.dd_stats(*args)
    again = aggs_ops.dd_stats(*args)
    torch.cuda.synchronize()
    assert aggs_ops.AGG_STATS.launches == before + 2
    assert torch.equal(got, again)
    _assert_stats_equal(got, aggs_ops.dd_stats_plain(*args))
    empty = (c["hi"], c["lo"], c["exists"], torch.zeros_like(c["mask"]))
    _assert_stats_equal(aggs_ops.dd_stats(*empty),
                        aggs_ops.dd_stats_plain(*empty))
    count = aggs_ops.dd_stats(None, None, c["exists"], c["mask"])
    assert count[0] == (c["exists"] & c["mask"]).sum()


def test_agg_stats_orders_signed_zeros_and_nan_as_plain(cuda):
    hi = torch.tensor([0.0, -0.0, 3.5, -0.0, 2.0] * 300, device=cuda)
    lo = torch.zeros_like(hi)
    lo[1] = 1e-9
    ex = torch.ones(hi.shape, dtype=torch.bool, device=cuda)
    got = aggs_ops.dd_stats(hi, lo, ex, ex)
    _assert_stats_equal(got, aggs_ops.dd_stats_plain(hi, lo, ex, ex))
    hi[7] = float("nan")
    g = aggs_ops.dd_stats(hi, lo, ex, ex).cpu().numpy()
    w = aggs_ops.dd_stats_plain(hi, lo, ex, ex).cpu().numpy()
    assert np.isnan(g[[1, 3]]).all() and np.isnan(w[[1, 3]]).all()
    assert (g[2], g[4]) == (w[2], w[4]) == (np.inf, -np.inf)


def test_agg_kernels_refuse_what_they_do_not_take(cuda):
    c = _agg_columns(cuda, 100, 1)
    with pytest.raises(TypeError):
        aggs_ops.ord_counts(c["ords"].to(torch.int64), c["mask"], 16)
    with pytest.raises(ValueError):
        aggs_ops.dd_stats(c["hi"][:50], c["lo"], c["exists"], c["mask"])
    with pytest.raises(ValueError):
        aggs_ops.dd_histogram_counts(c["hi"], c["lo"], c["exists"],
                                     c["mask"].cpu(), 0.0, 0.0, 1.0, 4)
    with pytest.raises(ValueError):
        aggs_ops.dd_range_counts(
            c["hi"], c["lo"], c["exists"], c["mask"],
            torch.zeros((2, 3), device=cuda),
            torch.zeros(2, dtype=torch.uint8, device=cuda))


def test_aggregations_on_the_card_match_the_cpu(cuda, tmp_path):
    """query_phase with the device-eligible aggregations on the card (K8,
    K9 launched, no host collector, no host mask) gives the CPU's partials:
    counts and extrema equal, sums within 1e-5 relative."""
    from elasticsearch_tpu_torch.index.device_reader import device_reader_for
    from elasticsearch_tpu_torch.index.engine import Engine
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.search import aggregations
    from elasticsearch_tpu_torch.search.phase import (
        ShardSearcher, parse_search_request)
    rng = np.random.default_rng(4)
    ms = MapperService()
    ms.merge("_doc", {"properties": {"body": {"type": "text"},
                                     "cat": {"type": "keyword"},
                                     "rank": {"type": "double"},
                                     "when": {"type": "date"}}})
    eng = Engine(tmp_path / "e", ms)
    for i in range(500):
        eng.index(str(i), {
            "body": " ".join(rng.choice(["a", "b", "c", "d"],
                                        size=int(rng.integers(1, 5)))),
            "cat": f"cat{int(rng.integers(0, 16)):02d}",
            "rank": float(rng.random() * 100.0),
            "when": 1_500_000_000_000 + int(rng.integers(0, 20)) * 3_600_000})
        if i == 250:
            eng.refresh()
    eng.refresh()
    body = {"query": {"match": {"body": "a b"}}, "size": 10, "aggs": {
        "tg": {"terms": {"field": "cat", "size": 8}},
        "xs": {"extended_stats": {"field": "rank"}},
        "hi": {"histogram": {"field": "rank", "interval": 5}},
        "rg": {"range": {"field": "rank", "ranges": [
            {"to": 25}, {"from": 25, "to": 75}, {"from": 75}]}},
        "vc": {"value_count": {"field": "cat"}},
        "dh": {"date_histogram": {"field": "when", "interval": "1h"}}}}
    want = ShardSearcher(0, device_reader_for(eng, device="cpu"),
                         ms).query_phase(parse_search_request(body))
    card = ShardSearcher(0, device_reader_for(eng, device=cuda), ms)
    before = (aggs_ops.AGG_COUNTS.launches, aggs_ops.AGG_STATS.launches,
              aggregations.DEVICE_AGG_STATS["host_fallbacks"])
    got = card.query_phase(parse_search_request(body))
    assert aggs_ops.AGG_COUNTS.launches > before[0]
    assert aggs_ops.AGG_STATS.launches > before[1]
    assert aggregations.DEVICE_AGG_STATS["host_fallbacks"] == before[2]
    assert got.total == want.total
    np.testing.assert_array_equal(got.doc_ids, want.doc_ids)
    for name, part in want.agg_partials.items():
        g = got.agg_partials[name]
        if name == "xs":
            for key in ("count", "min", "max"):
                assert g[key] == part[key]
            for key in ("sum", "sum_sq"):
                assert g[key] == pytest.approx(part[key], rel=1e-5)
        else:
            assert g == part, name


# ---------------------------------------------------------------------------
# the percolator's kernels and shapes (K10, K11; K1, K3 at B = 4096 x N = 128;
# K7 past k = 1024)
# ---------------------------------------------------------------------------

def _bits_equal(got, want):
    """Equal f32 tensors bit for bit, any NaN against any NaN."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


def _percolate_lanes(rng, cuda, shapes):
    """Lanes of (scores, mask, live) with empty rows, rows that match only
    dead rows, rows matching only at -0.0, NaN among the matches and NaN
    outside them."""
    out = []
    for b, n in shapes:
        scores = rng.normal(size=(b, n)).astype(np.float32) * 4
        mask = rng.random((b, n)) < 0.3
        live = rng.random(n) < 0.9
        if b >= 5:
            mask[0] = False
            mask[1] = ~live
            alive = np.flatnonzero(live)[:2]
            mask[2] = False
            mask[2, alive] = True
            scores[2, alive] = -0.0
            scores[3, alive[0]] = np.nan
            mask[3, alive[0]] = True
            scores[4] = np.nan
            mask[4] = False
        out.append(tuple(torch.from_numpy(a).to(cuda)
                         for a in (scores, mask, live)))
    return out


def test_percolate_reduce_bit_identical_to_plain(cuda):
    """K10 over ragged lanes in one launch: up to B = 10,000 at Np = 128,
    wider and odd row widths (a scalar path), a lane of no rows."""
    rng = np.random.default_rng(10)
    lanes = _percolate_lanes(rng, cuda, [(10000, 128), (1, 128), (37, 256),
                                         (0, 128), (6, 7), (300, 130),
                                         (5, 1)])
    before = percolate.PERCOLATE_REDUCE.launches
    got = percolate.percolate_reduce(lanes)
    torch.cuda.synchronize()
    assert percolate.PERCOLATE_REDUCE.launches == before + 1
    want = percolate.percolate_reduce_plain(lanes)
    assert got.shape == want.shape == (sum(s.shape[0] for s, _, _ in lanes),
                                       2)
    _bits_equal(got, want)
    assert int(torch.isnan(want[:, 1]).sum()) >= 1
    with pytest.raises(ValueError):
        percolate.percolate_reduce([(lanes[0][0], lanes[0][1][:, :64],
                                     lanes[0][2])])
    with pytest.raises(TypeError):
        percolate.percolate_reduce([(lanes[0][0].double(), lanes[0][1],
                                     lanes[0][2])])


@pytest.mark.parametrize("n,length,n_queries,deltas,slop", [
    (1001, 24, 3, (0, 1), 1),
    (4099, 40, 64, (0, 1, 2), 2),
    (333, 20, 70, (0, 2), 3),               # two query groups
    (517, 300, 9, (0, 1), 2),               # rows past the staged window
    (64, 8, 5, (0, 9), 1),                  # a gap wider than every row
    (2000, 50, 16, (0, 1, 3, 4), 6),
    (128, 16, 1024, (0, 1), 2),             # a percolate lane's shape
])
def test_sloppy_phrase_scan_bit_identical_to_plain(cuda, n, length,
                                                   n_queries, deltas, slop):
    rng = np.random.default_rng(n + slop)
    tokens, doc_len, qtids, _, avgdl = _phrase_inputs(
        rng, n, length, n_queries, deltas)
    idfs = rng.uniform(0.1, 4.0, size=qtids.shape).astype(np.float32)
    tk, dl, qt, idf, av = (torch.from_numpy(a).to(cuda) for a in (
        tokens, doc_len, qtids, idfs, avgdl))
    before = phrase.SLOPPY_PHRASE_SCAN.launches
    got_s, got_m = phrase.sloppy_phrase_score_batch(
        tk, dl, qt, deltas, slop, idf, 1.2, 0.75, av,
        extent=phrase.token_extent(tk))
    torch.cuda.synchronize()
    assert phrase.SLOPPY_PHRASE_SCAN.launches == before + 1
    want_s, want_m = phrase.sloppy_phrase_score_batch_plain(
        tk, dl, qt, list(deltas), slop, idf, 1.2, 0.75, av)
    assert torch.equal(got_m, want_m)
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))
    assert bool(want_m.any()) == (max(deltas) < length)


def test_bm25_and_phrase_scans_at_the_percolator_shape(cuda):
    """K1 and K3 at B = 4,096 queries x N = 128 rows (a percolate lane:
    64 query groups on grid y, one run of rows a warp) against their plain
    versions, bit for bit."""
    rng = np.random.default_rng(4096)
    vocab = 300
    uterms, utf, doc_len = _segment(rng, 128, 24, vocab)
    b, t = 4096, 2
    q = [torch.from_numpy(a).to(cuda) for a in (
        rng.integers(0, vocab, (b, t)).astype(np.int32),
        rng.uniform(0.1, 5.0, (b, t)).astype(np.float32),
        np.ones((b, t), np.float32),
        rng.uniform(1.0, 40.0, b).astype(np.float32))]
    cols = [torch.from_numpy(a).to(cuda) for a in (uterms, utf, doc_len)]
    got = lexical.bm25_match_batch(*cols, *q[:3], 1.2, 0.75, q[3],
                                   want_nmatch=True)
    want = lexical.bm25_match_batch_plain(*cols, *q[:3], 1.2, 0.75, q[3],
                                          want_nmatch=True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert bool((want[0] > 0).any())
    tokens, doc_len, qtids, sum_idf, avgdl = _phrase_inputs(
        rng, 128, 16, b, (0, 1))
    tk, dl, qt, si, av = (torch.from_numpy(a).to(cuda) for a in (
        tokens, doc_len, qtids, sum_idf, avgdl))
    got_s, got_m = phrase.phrase_score_batch(tk, dl, qt, (0, 1), si, 1.2,
                                             0.75, av,
                                             extent=phrase.token_extent(tk))
    want_s, want_m = phrase.phrase_score_batch_plain(tk, dl, qt, [0, 1], si,
                                                     1.2, 0.75, av)
    torch.cuda.synchronize()
    assert torch.equal(got_m, want_m) and bool(want_m.any())
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))


@pytest.mark.parametrize("k", [1025, 5000, 13000])
def test_blockmax_sweep_past_1024_equals_the_eager_arm(cuda, k):
    """K7 at k past the old cap of 1024, in shared memory (1,025 and 5,000)
    and in global scratch (13,000 > K7_SMEM_K): over two segments with the
    carry threaded, its top-k is the eager arm's (K6 + K2) bit for bit, and
    equal to its plain version."""
    rng = np.random.default_rng(k)
    b, n, r, vocab = 3, 8192, 256, 40
    qtids = _impact_queries(rng, b, 3, vocab)
    sb = torch.tensor([0.5, 1.0, 2.0], device=cuda)
    cs = torch.full((b,), float("inf"), device=cuda)
    cd = torch.full((b,), -1, dtype=torch.int32, device=cuda)
    got = want = blockmax.pruned_carry_init(b, k, cuda)
    eager_s, eager_d = [], []
    for base in (0, n):
        _, (uterms, qimp, live, bmx) = _impact_segment(rng, n, 24, vocab,
                                                       16, r)
        got = blockmax.pruned_segment_topk(got, uterms, qimp, live, bmx,
                                           qtids, sb, k, base, cs, cd,
                                           trailing_pad=True)
        ub_i = blockmax.block_bounds(bmx, qtids)
        ub_f, order = blockmax.sweep_order(ub_i, sb)
        want = blockmax.blockmax_sweep_plain(
            want, uterms, qimp, live, ub_i, ub_f, order, qtids, sb, cs, cd,
            k, base)
        ts, td, _ = blockmax.eager_segment_topk(uterms, qimp, live, qtids,
                                                sb, k, base, cs, cd,
                                                trailing_pad=True)
        eager_s.append(ts)
        eager_d.append(torch.where(td >= 0, td + base, -1))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    m_s, m_d = blockmax.topk_flat_by_doc(torch.cat(eager_s, 1),
                                         torch.cat(eager_d, 1), k)
    assert torch.equal(got[0].view(torch.int32), m_s.view(torch.int32))
    assert torch.equal(got[1], m_d)
    assert int((got[1] >= 0).sum(dim=1).max()) > 1024


def test_percolator_on_the_card_matches_the_cpu(cuda):
    """The registry on the card (K1, K3, K11 in the lanes, one K10 launch
    and one device→host copy a call) answers as the plain versions on the
    CPU: the same ids and totals, scores within 1e-6."""
    import types
    from elasticsearch_tpu_torch.search import percolator
    rng = np.random.default_rng(5)
    vocab = [f"v{i}" for i in range(30)]
    percs = {}
    for i in range(600):
        w, w2 = vocab[int(rng.integers(0, 30))], vocab[(i * 7) % 30]
        qq = ({"match": {"body": f"{w} {w2}"}},
              {"match_phrase": {"body": f"{w} {w2}"}},
              {"match_phrase": {"body": {"query": f"{w} {w2}",
                                         "slop": 1 + i % 3}}},
              {"term": {"cat": w}},
              {"range": {"rank": {"gte": int(rng.integers(0, 90))}}})[i % 5]
        percs[f"q{i}"] = {"query": qq, "group": f"g{i % 4}"}
    meta = types.SimpleNamespace(
        name="card_perc", uuid="u", settings={}, version=1, percolators=percs,
        mappings={"_doc": {"properties": {
            "body": {"type": "text", "analyzer": "whitespace"},
            "cat": {"type": "keyword"}, "rank": {"type": "double"},
            "group": {"type": "keyword"}}}})
    items = [{"doc": {"body": " ".join(vocab[int(j)] for j in
                                       rng.integers(0, 30, 8)),
                      "cat": vocab[int(rng.integers(0, 30))],
                      "rank": float(rng.integers(0, 100))},
              "score": True} for _ in range(6)]
    want = percolator.percolate_many(meta, items, device="cpu")
    before = percolate.PERCOLATE_REDUCE.launches
    sloppy = phrase.SLOPPY_PHRASE_SCAN.launches
    got = percolator.percolate_many(meta, items, device=cuda)
    assert percolate.PERCOLATE_REDUCE.launches == before + 1
    assert phrase.SLOPPY_PHRASE_SCAN.launches > sloppy
    for g, w in zip(got, want):
        assert g["total"] == w["total"] > 0
        assert [m["_id"] for m in g["matches"]] == \
            [m["_id"] for m in w["matches"]]
        np.testing.assert_allclose([m["_score"] for m in g["matches"]],
                                   [m["_score"] for m in w["matches"]],
                                   rtol=1e-6)
