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
percolator's match reduction), K11 (sloppy-phrase scan) and K12 (the
script evaluator, over scripts that use every opcode) must be
bit-identical to their plain versions (NaN as NaN), and so must K13 (span
programs), K14 (flat span_near, in order and unordered) and K15 (the
classic and LM-Dirichlet instantiations of K1's scan, K1's own BM25 results
unchanged beside them); K16 (term-set membership) must give equal masks.
K17 (the geo_point filters, every mode, and the decay's distances) and K18
(geo_shape relations, each relation) must equal their plain versions bit
for bit, and so must K19 (the nested query's child → parent reduce, every
score_mode, NaN and ±0.0 among the child scores), which launches once a
nested clause a segment. K20 (the collective plane's lexicographic
selection) must give its plain version's positions bit for bit (±0.0, NaN,
±inf, ties, a cursor, k past M); the row-batched K8 and K9 entries must
give each row the bits of a one-row launch and of their plain versions
(the row-batched K9's plain version adds in the kernel's order); and the
collective plane on a
one-rank NCCL mesh must match the plane on the CPU.
These tests need
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
    aggs_ops, blockmax, lexical, maxsim, percolate, phrase, script_ops, spans,
    topk, vector)
from elasticsearch_tpu_torch.search import scripts

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


@pytest.mark.parametrize("kernel", ["stable_topk", "bm25_scan",
                                    "script_eval", "sim_scan",
                                    "term_set_scan", "span_near_scan",
                                    "span_program"])
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
    elif kernel == "script_eval":
        # a short program, one past the shared-memory stage and a deep one
        cases = [(_script_case(cuda, src, 3, 5001), {})
                 for src in (SCRIPT_GRAMMAR[0], LONG_SCRIPT, DEEP_SCRIPT)]
        run = script_ops.script_eval
        plain = script_ops.script_eval_plain
    elif kernel in ("sim_scan", "term_set_scan", "span_near_scan",
                    "span_program"):
        cases, run, plain = _new_kernel_cases(cuda, kernel, rng)
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
            if kernel == "script_eval":
                _script_bits_equal(got, want[c])
                continue
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


#: scripts that between them use every opcode of K12
SCRIPT_GRAMMAR = [
    "doc['a'].value * 2 + 1 - doc['b'].value / 3",
    "doc['a'].value % -2.5 + min(doc['a'].value, doc['b'].value, 40)",
    "max(doc['a'].value, -doc['a'].value) + abs(doc['b'].value)",
    "floor(doc['a'].value) + ceil(doc['b'].value) + doc['a'].value ** 3",
    "doc['a'].value ** -2 + doc['b'].value ** 0.5 "
    "+ pow(doc['b'].value, 1.5)",
    "log(doc['b'].value + 1) * _score + ln(2) + log10(doc['b'].value)",
    "sqrt(doc['b'].value) + exp(-doc['b'].value / 50) + 1/3 * _score",
    "sigmoid(doc['b'].value) + sigmoid(doc['b'].value, 2, 3) "
    "+ saturation(doc['b'].value, 10)",
    "(doc['a'].value if doc['a'].value > params.t else _score) "
    "+ params.w * 2",
    "1 < doc['a'].value < 30 and doc['b'].value >= 5 or doc['a'].empty",
    "not doc['a'].value or not 0",
    "doc['a'].value == doc['a'].value and True",
    "doc['a'].value != doc['b'].value",
    "doc['a'].value <= doc['b'].value",
    "(doc['a'].empty + 7) % 3 + (doc['a'].empty - 3) % -2 "
    "+ (doc['a'].empty + 1) % 0",
    "(doc['a'].empty + 2) ** (doc['a'].empty + 1) + doc['a'].empty ** 2 "
    "+ abs(-3) * (doc['b'].empty + 0)",
    "-(doc['a'].empty + 0) + 2147483647 + min(doc['a'].empty, 2) "
    "+ max(doc['a'].empty + 0, 1)",
    "(doc['a'].empty + 1) > 1 or (doc['a'].empty + 1) < 2 "
    "or (doc['a'].empty + 1) <= 0 or (doc['a'].empty + 1) >= 3 "
    "or (doc['a'].empty + 1) == 1 or (doc['a'].empty + 1) != 2",
    "max(doc['a'].empty, doc['b'].empty) + min(doc['a'].empty, "
    "doc['b'].empty) + doc['a'].empty * doc['b'].empty",
    "1 if doc['a'].empty else 2.5",
    "doc['a'].empty if doc['a'].value else 3",
    "cosineSimilarity(params.qv, 'v') + 1.0",
    "dotProduct(params.qv, 'v') * 0.5 + _score",
    "doc['a'].value / 0 + doc['a'].value * 1e40 + doc['a'].value % 0",
    "(doc['a'].empty + 1) / 2",
    "log(2 + doc['a'].value) * params.w",
]
#: 500 parenthesized 60-term products: past K12's shared-memory stage
LONG_SCRIPT = " + ".join(
    "(" + " * ".join(["doc['b'].value"] * 60) + ")" for _ in range(500))
#: a stack deeper than 32
DEEP_SCRIPT = "+".join(["(doc['a'].value"] * 40) + ")" * 40
SCRIPT_PARAMS = {"t": 10.0, "w": 1.5, "qv": [0.0] * 16}
#: a bucket pipeline's per-row names, every kind of per-row value
PIPELINE_SCRIPT = "log(a) * b + min(b, 2) + (c and a > 0)"


def _script_bits_equal(got, want):
    assert got.dtype == want.dtype
    if got.dtype == torch.float32:
        _bits_equal(got, want)
    else:
        assert torch.equal(got, want)


def _script_inputs(cuda, b, n, seed=12):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-40.0, 40.0, n).astype(np.float32)
    special = [np.nan, np.inf, -np.inf, -0.0, 0.0, 2.0][:n]
    a[:len(special)] = special
    bcol = rng.uniform(0.5, 100.0, n).astype(np.float32)
    bcol[n // 2] = -0.0
    vecs = rng.standard_normal((n, 16)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    t = lambda x: torch.from_numpy(x).to(cuda)   # noqa: E731
    return {"a": (t(a), t(rng.random(n) > 0.2)),
            "b": (t(bcol), t(rng.random(n) > 0.1)),
            "score": t(rng.uniform(0.0, 12.0, (b, n)).astype(np.float32)),
            "vecs": t(vecs), "vexists": t(rng.random(n) > 0.1),
            "qv": t(rng.standard_normal((b, 16)).astype(np.float32))}


def _script_case(cuda, source, b, n):
    """→ the arguments of script_eval for ``source`` over seeded inputs."""
    inp = _script_inputs(cuda, b, n)
    prog = scripts.compile_script(source).lower("query", SCRIPT_PARAMS)
    cols = [inp[f] for f in prog.columns]
    prods = []
    for cosine, _, _ in prog.products:
        q = inp["qv"]
        if cosine:
            q = q / torch.sqrt((q * q).sum(dim=-1, keepdim=True) + 1e-12)
        prods.append((torch.matmul(q, inp["vecs"].T).contiguous(),
                      inp["vexists"]))
    params = torch.tensor([[10.0 + i, 1.5 - i] for i in range(b)],
                          dtype=torch.float32, device=cuda)
    params = params[:, [["t", "w"].index(k) for k in prog.params]]
    return (prog.code, cols, inp["score"], prods, params.contiguous(),
            torch.zeros((0, n), dtype=torch.int32, device=cuda), b, n)


@pytest.mark.parametrize("b,n", [(1, 1), (3, 1001), (64, 4099),
                                 (64, 1 << 16)])
def test_script_eval_bit_identical_to_plain(cuda, b, n):
    """Every script of the grammar, the long and the deep one, at odd N and
    B in {1, 3, 64}: one launch each, bit-identical to the plain version
    (NaN as NaN, -0.0 kept)."""
    opcodes = set()
    for source in SCRIPT_GRAMMAR + [LONG_SCRIPT, DEEP_SCRIPT]:
        if source is LONG_SCRIPT and b * n > 300_000:
            continue              # 60,000 ops a cell: seconds at this size
        args = _script_case(cuda, source, b, n)
        opcodes |= {int(o) for o in args[0].ops[:, 0]}
        before = script_ops.SCRIPT_EVAL.launches
        got = script_ops.script_eval(*args)
        torch.cuda.synchronize()
        assert script_ops.SCRIPT_EVAL.launches == before + 1
        want = script_ops.script_eval_plain(*args)
        assert got.dtype == want.dtype and got.shape == (b, n)
        _script_bits_equal(got, want)
    prog = scripts.compile_script(PIPELINE_SCRIPT).lower(
        "pipeline", {}, {"a": 2.0, "b": 3, "c": True})
    rows = [{"a": 0.5 + i, "b": i - 3, "c": bool(i % 2)} for i in range(n)]
    words = torch.from_numpy(prog.row_words(rows)).to(cuda)
    args = (prog.code, [], None, [], None, words, 1, n)
    opcodes |= {int(o) for o in prog.code.ops[:, 0]}
    _script_bits_equal(script_ops.script_eval(*args),
                       script_ops.script_eval_plain(*args))
    every = {v for k, v in vars(script_ops).items()
             if k.isupper() and isinstance(v, int)}
    assert every <= opcodes


def test_script_eval_refuses_what_it_does_not_take(cuda):
    code, cols, score, prods, params, rows, b, n = _script_case(
        cuda, SCRIPT_GRAMMAR[8], 3, 100)
    with pytest.raises(ValueError):
        script_ops.script_eval(code, cols, score[:, :50], prods, params,
                               rows, b, n)
    with pytest.raises(TypeError):
        script_ops.script_eval(code, cols, score.double(), prods, params,
                               rows, b, n)
    with pytest.raises(ValueError):
        script_ops.script_eval(code, [], score, prods, params, rows, b, n)


# ---------------------------------------------------------------------------
# K13-K16: the query leaves
# ---------------------------------------------------------------------------

def _sim_inputs(rng, cuda, n, u, b, t, vocab=300):
    uterms, utf, doc_len = _segment(rng, n, u, vocab)
    qtids = rng.integers(-1, vocab, size=(b, t)).astype(np.int32)
    qtids[0, -1] = qtids[0, 0]                    # a repeated term
    qtids[-1, 0] = uterms[np.argmax(uterms[:, 0] >= 0), 0]   # a sure hit
    qa = rng.uniform(0.0, 4.0, size=(b, t)).astype(np.float32)
    qa[0, 0] = 0.0                                # LM: P(t|C) at the floor
    qw = rng.uniform(0.5, 2.0, size=(b, t)).astype(np.float32)
    mu = rng.uniform(100.0, 3000.0, size=b).astype(np.float32)
    return [torch.from_numpy(a).to(cuda)
            for a in (uterms, utf, doc_len, qtids, qa / 50.0, qw, mu, qa)]


@pytest.mark.parametrize("sim", [lexical.SIM_CLASSIC,
                                 lexical.SIM_LM_DIRICHLET])
@pytest.mark.parametrize("n,u,b,t,trailing_pad", [
    (5000, 24, 9, 4, True), (1001, 40, 64, 3, False), (333, 7, 70, 11, True),
    (8, 1, 1, 1, True)])
def test_sim_scan_bit_identical_to_plain(cuda, sim, n, u, b, t,
                                         trailing_pad):
    rng = np.random.default_rng(n + b + sim)
    ut, utf, dl, qt, frac, qw, mu, idf = _sim_inputs(rng, cuda, n, u, b, t)
    qa = idf if sim == lexical.SIM_CLASSIC else frac
    before = lexical.SIM_SCAN.launches
    got_s, got_n = lexical.sim_match_batch(sim, ut, utf, dl, qt, qa, qw, mu,
                                           trailing_pad=trailing_pad)
    torch.cuda.synchronize()
    assert lexical.SIM_SCAN.launches == before + 1
    if sim == lexical.SIM_CLASSIC:
        want_s, want_n = lexical.classic_match_batch_plain(ut, utf, dl, qt,
                                                           qa, qw)
    else:
        want_s, want_n = lexical.lm_dirichlet_match_batch_plain(
            ut, utf, dl, qt, qa, qw, mu)
    assert torch.equal(got_n, want_n)
    assert bool((want_n > 0).any())
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))


def test_bm25_instantiation_unchanged_beside_the_similarities(cuda):
    """K1's BM25 results are the plain version's bit for bit before and
    after K15's instantiations run from the same library."""
    rng = np.random.default_rng(15)
    ut, utf, dl, qt, frac, qw, mu, idf = _sim_inputs(rng, cuda, 20000, 24,
                                                     64, 4)
    avg = torch.full((64,), 17.5, device=cuda)
    want = lexical.bm25_match_batch_plain(ut, utf, dl, qt, idf, qw, 1.2,
                                          0.75, avg)
    for sim, qa in ((lexical.SIM_CLASSIC, idf),
                    (lexical.SIM_LM_DIRICHLET, frac), (None, None)):
        got = lexical.bm25_match_batch(ut, utf, dl, qt, idf, qw, 1.2, 0.75,
                                       avg)
        torch.cuda.synchronize()
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])
        if sim is not None:
            lexical.sim_match_batch(sim, ut, utf, dl, qt, qa, qw, mu)


def _set_tids(rng, b, t, vocab):
    """Power-of-two padded sets of 1..t ids, some sets empty, one shared by
    every query."""
    tids = np.full((b, t), -1, np.int32)
    for i in range(b):
        k = int(rng.integers(0, min(t, vocab) + 1))
        tids[i, :k] = rng.choice(vocab, size=k, replace=False)
    tids[-1, 0] = min(5, vocab - 1)
    return tids


@pytest.mark.parametrize("n,u,b,t,vocab,trailing_pad", [
    (20000, 24, 64, 16, 300, True), (4099, 40, 70, 128, 3000, False),
    (1001, 7, 3, 1024, 50000, True), (9, 1, 1, 1, 10, True),
    (262144, 24, 64, 1024, 60000, True)])
def test_term_set_scan_equals_plain(cuda, n, u, b, t, vocab, trailing_pad):
    rng = np.random.default_rng(n + t)
    uterms, _, _ = _segment(rng, n, u, vocab)
    ut = torch.from_numpy(uterms).to(cuda)
    qt = torch.from_numpy(_set_tids(rng, b, t, vocab)).to(cuda)
    before = lexical.TERM_SET_SCAN.launches
    got = lexical.term_set_scan(ut, qt, trailing_pad=trailing_pad)
    torch.cuda.synchronize()
    assert lexical.TERM_SET_SCAN.launches == before + 1
    want = lexical.term_set_scan_plain(ut, qt)
    assert torch.equal(got, want)
    assert bool(want.any())
    keys, bits = lexical.term_set_index(qt)
    assert bool((keys[1:] > keys[:-1]).all())
    assert bits.shape == (keys.shape[0], (b + 63) // 64)


@pytest.mark.parametrize("n,length,n_queries,t,slop,in_order", [
    (1001, 24, 3, 2, 1, False), (4099, 40, 64, 3, 3, False),
    (4099, 40, 64, 3, 2, True), (333, 20, 70, 2, 0, True),
    (517, 300, 9, 4, 2, False), (64, 8, 5, 3, 5, True),
    (2000, 224, 64, 3, 3, False), (128, 16, 1024, 2, 1, True)])
def test_span_near_scan_bit_identical_to_plain(cuda, n, length, n_queries, t,
                                               slop, in_order):
    rng = np.random.default_rng(n + t + slop)
    tokens, doc_len, qtids, sum_idf, avgdl = _phrase_inputs(
        rng, n, length, n_queries, list(range(t)), vocab=5)
    tk, dl, qt, idf, av = (torch.from_numpy(a).to(cuda) for a in (
        tokens, doc_len, qtids, sum_idf, avgdl))
    before = phrase.SPAN_NEAR_SCAN.launches
    got_s, got_m = phrase.span_near_score_batch(
        tk, dl, qt, slop, in_order, idf, 1.2, 0.75, av,
        extent=phrase.token_extent(tk))
    torch.cuda.synchronize()
    assert phrase.SPAN_NEAR_SCAN.launches == before + 1
    want_s, want_m = phrase.span_near_score_batch_plain(
        tk, dl, qt, slop, in_order, idf, 1.2, 0.75, av)
    assert torch.equal(got_m, want_m)
    assert bool(want_m.any())
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))


#: span programs over fields a and b (ops/spans.py opcodes), every opcode
SPAN_PROGRAMS = {
    "near_or_not_first": ((spans.OP_TERM, 0, 0, 0),
                          (spans.OP_TERM_SET, 1, 0, 0),
                          (spans.OP_NEAR, 2, 2, 0), (spans.OP_TERM, 0, 1, 0),
                          (spans.OP_OR, 2, 0, 0), (spans.OP_TERM, 0, 2, 0),
                          (spans.OP_NOT, 1, 1, 0), (spans.OP_FIRST, 12, 0, 0)),
    "containing": ((spans.OP_TERM, 0, 0, 0), (spans.OP_TERM, 0, 1, 0),
                   (spans.OP_NEAR, 2, 3, 1), (spans.OP_TERM, 1, 2, 0),
                   (spans.OP_CONTAINING, 0, 0, 0)),
    "within": ((spans.OP_TERM_SET, 0, 0, 0), (spans.OP_TERM, 0, 1, 0),
               (spans.OP_NEAR, 2, 4, 0), (spans.OP_TERM, 0, 2, 0),
               (spans.OP_WITHIN, 0, 0, 0)),
    "nested_near": ((spans.OP_TERM, 0, 0, 0), (spans.OP_TERM, 0, 1, 0),
                    (spans.OP_NEAR, 2, 1, 0), (spans.OP_TERM, 1, 2, 0),
                    (spans.OP_TERM_SET, 1, 0, 0), (spans.OP_OR, 2, 0, 0),
                    (spans.OP_NEAR, 2, 2, 1)),
    "three_way": ((spans.OP_TERM, 0, 0, 0), (spans.OP_TERM, 0, 1, 0),
                  (spans.OP_TERM_SET, 0, 0, 0), (spans.OP_NEAR, 3, 3, 1),
                  (spans.OP_TERM, 0, 2, 0), (spans.OP_NOT, 0, 2, 0)),
}


def _span_program_case(cuda, rng, name, n, la, lb, b, set_t):
    tokens = []
    for length in (la, lb):
        tk, _, _, _, _ = _phrase_inputs(rng, n, length, 3, [0], vocab=4)
        tokens.append(tk)
    code = SPAN_PROGRAMS[name]
    prog = spans.SpanProgram(code=code, fields=("a", "b"), n_terms=3,
                             n_sets=1, depth=spans.program_depth(code))
    tids = rng.integers(-1, 4, size=(b, 3)).astype(np.int32)
    sets = _set_tids(rng, b, set_t, 4)
    doc_len = (tokens[0] >= 0).sum(axis=1).astype(np.int32)
    sum_idf = rng.uniform(0.5, 8.0, size=b).astype(np.float32)
    avgdl = rng.uniform(1.0, 30.0, size=b).astype(np.float32)
    tk = [torch.from_numpy(t).to(cuda) for t in tokens]
    ext = [phrase.token_extent(t) for t in tk]
    dl, qt, st, idf, av = (torch.from_numpy(a).to(cuda) for a in (
        doc_len, tids, sets, sum_idf, avgdl))
    return (prog, tk, ext, dl, qt, [st], idf, 1.2, 0.75, av)


@pytest.mark.parametrize("name", list(SPAN_PROGRAMS))
@pytest.mark.parametrize("n,la,lb,b,set_t", [
    (4099, 24, 40, 64, 4), (333, 20, 7, 70, 1), (1001, 224, 224, 9, 16),
    (640, 300, 33, 9, 2)])
def test_span_program_bit_identical_to_plain(cuda, name, n, la, lb, b,
                                             set_t):
    rng = np.random.default_rng(n + b)
    args = _span_program_case(cuda, rng, name, n, la, lb, b, set_t)
    before = spans.SPAN_PROGRAM.launches
    got_s, got_m = spans.span_program_score_batch(*args)
    torch.cuda.synchronize()
    assert spans.SPAN_PROGRAM.launches == before + 1
    prog, tk, _ext, dl, qt, st, idf, k1, b_, av = args
    want_s, want_m = spans.span_program_score_batch_plain(
        prog, tk, dl, qt, st, idf, k1, b_, av)
    assert torch.equal(got_m, want_m)
    assert bool(want_m.any())
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))


def test_leaf_kernels_refuse_what_they_do_not_take(cuda):
    rng = np.random.default_rng(3)
    ut, utf, dl, qt, frac, qw, mu, idf = _sim_inputs(rng, cuda, 100, 8, 2, 2)
    with pytest.raises(TypeError):
        lexical.sim_match_batch(lexical.SIM_CLASSIC, ut, utf, dl, qt,
                                idf.double(), qw)
    with pytest.raises(ValueError):
        lexical.sim_match_batch(lexical.SIM_LM_DIRICHLET, ut, utf, dl, qt,
                                frac, qw, None)
    with pytest.raises(ValueError):
        lexical.term_set_scan(ut, qt[0])
    args = list(_span_program_case(cuda, rng, "containing", 100, 8, 8, 2, 2))
    args[4] = args[4][:, :2]                      # a term slot missing
    with pytest.raises(ValueError):
        spans.span_program_score_batch(*args)


def _new_kernel_cases(cuda, kernel, rng):
    """(cases, run, plain) of K13-K16 for the many-threads test: shapes
    that take different shared memory and grids."""
    if kernel == "sim_scan":
        cases = []
        for b, t, sim in ((1, 4, 1), (64, 4, 2), (9, 11, 1)):
            ut, utf, dl, qt, frac, qw, mu, idf = _sim_inputs(
                rng, cuda, 20000, 24, b, t)
            cases.append(((sim, ut, utf, dl, qt,
                           idf if sim == 1 else frac, qw, mu), {}))

        def plain(sim, ut, utf, dl, qt, qa, qw, mu):
            if sim == lexical.SIM_CLASSIC:
                return lexical.classic_match_batch_plain(ut, utf, dl, qt, qa,
                                                         qw)
            return lexical.lm_dirichlet_match_batch_plain(ut, utf, dl, qt,
                                                          qa, qw, mu)
        return cases, lexical.sim_match_batch, plain
    if kernel == "term_set_scan":
        uterms, _, _ = _segment(rng, 20000, 24, 3000)
        ut = torch.from_numpy(uterms).to(cuda)
        cases = [((ut, torch.from_numpy(_set_tids(rng, b, t, 3000)).to(
            cuda)), {}) for b, t in ((1, 8), (64, 1024), (70, 16))]
        return cases, lexical.term_set_scan, lexical.term_set_scan_plain
    if kernel == "span_near_scan":
        cases = []
        for n_q, t, slop, in_order, length in ((3, 2, 1, True, 24),
                                               (64, 3, 3, False, 224),
                                               (70, 2, 2, True, 40)):
            tokens, dl, qt, idf, av = _phrase_inputs(
                rng, 3000, length, n_q, list(range(t)), vocab=5)
            tk, dl, qt, idf, av = (torch.from_numpy(a).to(cuda) for a in (
                tokens, dl, qt, idf, av))
            cases.append(((tk, dl, qt, slop, in_order, idf, 1.2, 0.75, av),
                          {"extent": phrase.token_extent(tk)}))

        def plain(*a, extent):
            return phrase.span_near_score_batch_plain(*a)
        return cases, phrase.span_near_score_batch, plain
    cases = [(_span_program_case(cuda, rng, name, 2000, la, lb, b, 4), {})
             for name, la, lb, b in (("containing", 24, 40, 1),
                                     ("near_or_not_first", 224, 224, 64),
                                     ("three_way", 300, 20, 70))]

    def plain(prog, tk, ext, dl, qt, st, idf, k1, b, av):
        return spans.span_program_score_batch_plain(prog, tk, dl, qt, st,
                                                    idf, k1, b, av)
    return cases, spans.span_program_score_batch, plain


# ---------------------------------------------------------------------------
# K17 geo_point_filter and K18 shape_relation
# ---------------------------------------------------------------------------

def _geo_points(rng, n, cuda):
    """Points clustered around (55, 7) and on the dateline, a tenth without
    a value; a few exactly on the test boxes' edges and rings' vertices."""
    lat = np.where(rng.random(n) < 0.8, 55.0, 0.0) + rng.normal(0, 2, n)
    lon = np.where(lat > 30, 7.0, 179.5) + rng.normal(0, 2, n)
    lon = (lon + 180.0) % 360.0 - 180.0
    lat[:6] = [61.0, 48.0, 55.0, 49.0, 60.0, 55.0]
    lon[:6] = [-0.1, 15.0, 15.0, -0.1, 14.0, 7.0]
    ex = rng.random(n) > 0.1
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (
        lat.astype(np.float32), lon.astype(np.float32), ex))


def _geo_same(got, want, what):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if got.dtype == torch.float32:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            what
    else:
        assert torch.equal(got, want), what


def _ring(rng, b, e, center=(55.0, 7.0), radius=4.0):
    """[b, e + 1] closed star-shaped rings (lats, lons), the first with a
    horizontal edge."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, (b, e)), axis=1)
    r = rng.uniform(0.3, 1.0, (b, e)) * radius
    lats = center[0] + r * np.sin(ang)
    lons = center[1] + r * np.cos(ang)
    lats[0, 1] = lats[0, 0]
    lats = np.concatenate([lats, lats[:, :1]], axis=1)
    lons = np.concatenate([lons, lons[:, :1]], axis=1)
    return lats.astype(np.float32), lons.astype(np.float32)


@pytest.mark.parametrize("mode,b,extra", [
    ("distance", 3, None), ("distance", 70, None),
    ("distance_range", 5, None), ("boxes", 4, 1), ("boxes", 70, 9),
    ("polygon", 3, 6), ("polygon", 13, 1000), ("polygon", 2, 7000),
    ("distance_out", 65, None)])
def test_geo_point_filter_bit_identical_to_plain(cuda, mode, b, extra):
    from elasticsearch_tpu_torch.ops import filters
    rng = np.random.default_rng(b)
    n = 100_003
    lat, lon, ex = _geo_points(rng, n, cuda)
    code = {"distance": filters.GEO_DISTANCE,
            "distance_range": filters.GEO_DISTANCE_RANGE,
            "boxes": filters.GEO_BOXES, "polygon": filters.GEO_POLYGON,
            "distance_out": filters.GEO_DISTANCE_OUT}[mode]
    q = np.stack([55.0 + rng.uniform(-1, 1, b), 7.0 + rng.uniform(-1, 1, b)],
                 axis=1)
    rl = ro = None
    if mode == "distance":
        params = np.concatenate([q, rng.uniform(1e3, 5e5, (b, 1))], axis=1)
    elif mode == "distance_range":
        bounds = rng.uniform(5e4, 4e5, (b, 4))
        bounds[rng.random((b, 4)) < 0.4] = -1.0
        params = np.concatenate([q, bounds], axis=1)
    elif mode == "boxes":
        boxes = np.stack([q[:, None, 0] + rng.uniform(0, 3, (b, extra)),
                          q[:, None, 1] - rng.uniform(0, 4, (b, extra)),
                          q[:, None, 0] - rng.uniform(0, 3, (b, extra)),
                          q[:, None, 1] + rng.uniform(0, 4, (b, extra))],
                         axis=2)
        boxes[0, 0] = [61.0, -0.1, 48.0, 15.0]          # points on edges
        boxes[-1, -1] = [3.0, 170.0, -3.0, -170.0]      # the dateline
        params = boxes.reshape(b, -1)
    elif mode == "polygon":
        rl, ro = (torch.from_numpy(a).to(cuda) for a in _ring(rng, b, extra))
        params = np.zeros((b, 0))
    else:
        params = q
    params = torch.from_numpy(params.astype(np.float32)).to(cuda)
    got = filters.geo_point_filter(lat, lon, ex, code, params, rl, ro)
    want = filters.geo_point_filter_plain(lat, lon, ex, code, params, rl, ro)
    _geo_same(got, want, f"K17 {mode} B={b}")
    if mode != "distance_out":
        assert bool(got.any())
    # an empty batch
    empty = filters.geo_point_filter(lat, lon, ex, code, params[:0],
                                     None if rl is None else rl[:0],
                                     None if ro is None else ro[:0])
    assert empty.shape == (0, n)


def _shape_rows(rng, n, cuda, wide=False):
    """Doc shape rows of every type, translated around (55, 7); a point
    on an envelope's edge line far away (a collinear case), a zero-length
    edge, and with ``wide`` a 40-vertex ring (two passes of a warp)."""
    from elasticsearch_tpu_torch.utils.geoshape import parse_shape_rings
    templates = [
        {"type": "polygon", "coordinates": [[[-0.5, -0.4], [0.6, -0.5],
                                             [0.7, 0.3], [-0.6, 0.4],
                                             [-0.5, -0.4]]]},
        {"type": "polygon", "coordinates": [
            [[-1, -1], [1, -1], [1, 1], [-1, 1], [-1, -1]],
            [[-0.3, -0.3], [0.3, -0.3], [0.3, 0.3], [-0.3, 0.3],
             [-0.3, -0.3]]]},
        {"type": "linestring", "coordinates": [[-0.8, 0.1], [0.3, -0.2],
                                               [0.3, -0.2], [0.9, 0.3]]},
        {"type": "point", "coordinates": [0.05, -0.05]},
        {"type": "multipolygon", "coordinates": [
            [[[-0.9, -0.9], [-0.5, -0.9], [-0.5, -0.5], [-0.9, -0.9]]],
            [[[0.4, 0.4], [0.9, 0.4], [0.9, 0.9], [0.4, 0.9], [0.4, 0.4]]]]},
    ]
    if wide:
        a = np.linspace(0, 2 * np.pi, 40)
        templates.append({"type": "linestring", "coordinates": [
            [float(np.cos(t)), float(np.sin(t)) * 0.7] for t in a]})
    rows = []
    for i in range(n):
        if i % 10 == 9:
            rows.append(None)
            continue
        t = templates[i % len(templates)]
        dlat, dlon = 55.0 + rng.normal(0, 2), 7.0 + rng.normal(0, 2)

        def move(c):
            if isinstance(c[0], (int, float)):
                return [c[0] + dlon, c[1] + dlat]
            return [move(x) for x in c]
        rows.append(parse_shape_rings({**t, "coordinates":
                                       move(t["coordinates"])}))
    rows[0] = parse_shape_rings({"type": "point",
                                 "coordinates": [100.0, 56.0]})
    v = max(len(r[0]) for r in rows if r is not None)
    lats = np.zeros((n, v), np.float32)
    lons = np.zeros((n, v), np.float32)
    rid = np.full((n, v), -1, np.int32)
    area = np.zeros((n, v), bool)
    nv = np.zeros(n, np.int32)
    ex = np.zeros(n, bool)
    for i, r in enumerate(rows):
        if r is None:
            continue
        lats[i, :len(r[0])], lons[i, :len(r[1])] = r[0], r[1]
        rid[i, :len(r[2])], area[i, :len(r[3])] = r[2], r[3]
        nv[i], ex[i] = len(r[0]) - 1, True
    return tuple(torch.from_numpy(a).to(cuda)
                 for a in (lats, lons, nv, ex, rid, area))


def _query_shape(kind, rng, b, cuda):
    from elasticsearch_tpu_torch.utils.geoshape import parse_shape_rings
    if kind == "envelope":       # its top edge on the line of row 0's point
        shape = {"type": "envelope", "coordinates": [[6.0, 56.0],
                                                     [8.5, 54.2]]}
    elif kind == "circle":
        shape = {"type": "circle", "coordinates": [7.2, 55.1],
                 "radius": "90km"}
    elif kind == "hole":
        shape = {"type": "polygon", "coordinates": [
            [[5.5, 53.8], [9.0, 53.8], [8.6, 56.5], [5.8, 56.2],
             [5.5, 53.8]],
            [[6.8, 54.8], [7.6, 54.8], [7.6, 55.4], [6.8, 55.4],
             [6.8, 54.8]]]}
    else:                        # a 3,100-vertex ring: read from global
        a = np.linspace(0, 2 * np.pi, 3100)
        shape = {"type": "polygon", "coordinates": [[
            [7.0 + 2 * float(np.cos(t)), 55.0 + float(np.sin(t))]
            for t in a]]}
    ql, qo, qr, qa = parse_shape_rings(shape)
    off = rng.uniform(-1, 1, (b, 2))
    off[0] = 0.0
    lats = np.asarray(ql)[None, :] + off[:, :1]
    lons = np.asarray(qo)[None, :] + off[:, 1:]
    return (torch.from_numpy(lats.astype(np.float32)).to(cuda),
            torch.from_numpy(lons.astype(np.float32)).to(cuda),
            np.asarray(qr, np.int32), np.asarray(qa, bool))


@pytest.mark.parametrize("relation", ["intersects", "disjoint", "within",
                                      "contains"])
@pytest.mark.parametrize("kind,n,b,wide", [
    ("envelope", 20_003, 3, False), ("circle", 20_003, 70, True),
    ("hole", 5_000, 5, True), ("long", 2_000, 2, False)])
def test_shape_relation_bit_identical_to_plain(cuda, relation, kind, n, b,
                                               wide):
    from elasticsearch_tpu_torch.ops import geoshape
    rng = np.random.default_rng(n + b)
    doc = _shape_rows(rng, n, cuda, wide)
    ql, qo, qr, qa = _query_shape(kind, rng, b, cuda)
    got = geoshape.shape_relation(*doc, ql, qo, qr, qa, relation)
    want = geoshape.shape_relation_plain(*doc, ql, qo, qr, qa, relation)
    _geo_same(got, want, f"K18 {relation} {kind} B={b}")
    if relation in ("intersects", "disjoint"):
        assert bool(got.any())


def test_geo_kernels_refuse_what_they_do_not_take(cuda):
    from elasticsearch_tpu_torch.ops import filters, geoshape
    rng = np.random.default_rng(5)
    lat, lon, ex = _geo_points(rng, 1000, cuda)
    params = torch.zeros((2, 3), device=cuda)
    with pytest.raises(TypeError):
        filters.geo_point_filter(lat.double(), lon, ex, filters.GEO_DISTANCE,
                                 params)
    with pytest.raises(ValueError):
        filters.geo_point_filter(lat, lon, ex, filters.GEO_DISTANCE_RANGE,
                                 params)
    with pytest.raises(ValueError):
        filters.geo_point_filter(lat, lon, ex, filters.GEO_BOXES, params)
    doc = _shape_rows(rng, 100, cuda)
    ql, qo, qr, qa = _query_shape("envelope", rng, 2, cuda)
    with pytest.raises(ValueError):
        geoshape.shape_relation(*doc, ql, qo, qr[:-1], qa[:-1], "within")
    with pytest.raises(TypeError):
        geoshape.shape_relation(*doc, ql.double(), qo, qr, qa, "within")
    with pytest.raises(ValueError):
        geoshape.shape_relation(*doc, ql, qo, qr, qa, "touches")


def _nested_inputs(rng, counts, b, dev, nan=False):
    """Child scores and mask [b, Nc] (a padding tail of 3 rows), live [Nc]
    and the CSR offsets of ``counts`` children a parent."""
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    nc = int(offsets[-1]) + 3
    scores = rng.uniform(-3, 5, (b, nc)).astype(np.float32)
    scores[:, ::7] = 0.0
    scores[:, 3::11] = -0.0
    if nan:
        scores[:, 5::13] = np.nan
    mask = rng.random((b, nc)) < 0.7
    live = rng.random(nc) < 0.9
    live[-3:] = False
    boost = rng.uniform(0.5, 3, b).astype(np.float32)
    boost[0] = 1.0
    return [torch.from_numpy(a).to(dev) for a in (scores, mask, live,
                                                    offsets, boost)]


@pytest.mark.parametrize("mode", ["none", "max", "min", "sum", "avg"])
@pytest.mark.parametrize("n,b,shape", [(1, 1, "one"), (5000, 65, "ragged"),
                                       (3001, 3, "heavy"),
                                       (4099, 7, "dead")])
def test_nested_reduce_bit_identical_to_plain(cuda, mode, n, b, shape):
    from elasticsearch_tpu_torch.ops import nested
    rng = np.random.default_rng(n + b)
    counts = rng.choice([0, 0, 1, 1, 2, 3, 9], n)
    if shape == "heavy":
        counts[n // 2] = 1000              # one parent with 1,000 children
    args = _nested_inputs(rng, counts, b, cuda, nan=shape != "one")
    if shape == "dead":
        args[2][:] = False                 # every child dead
    before = nested.NESTED_REDUCE.launches
    got = nested.nested_reduce(*args, mode)
    want = nested.nested_reduce_plain(*args, mode)
    torch.cuda.synchronize()
    assert nested.NESTED_REDUCE.launches == before + 1
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    if shape == "dead":
        assert not bool(got[1].any())
    else:
        assert bool(got[1].any())


def test_nested_reduce_refuses_what_it_does_not_take(cuda):
    from elasticsearch_tpu_torch.ops import nested
    rng = np.random.default_rng(2)
    s, m, live, off, boost = _nested_inputs(rng, np.ones(10, int), 2, cuda)
    with pytest.raises(TypeError):
        nested.nested_reduce(s.double(), m, live, off, boost, "sum")
    with pytest.raises(TypeError):
        nested.nested_reduce(s, m, live, off.long(), boost, "sum")
    with pytest.raises(ValueError):
        nested.nested_reduce(s, m[:1], live, off, boost, "sum")
    with pytest.raises(ValueError):
        nested.nested_reduce(s, m, live, off, boost, "total")
    e = nested.nested_reduce(s[:0], m[:0], live, off, boost[:0], "max")
    assert e[0].shape == (0, 10) and e[1].shape == (0, 10)


def test_nested_query_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A nested query through query_phase_batch on the card: one K19 launch
    a nested clause a segment holding the path (a segment without it
    launches none), the same ids and totals as the CPU, scores within
    1e-6."""
    from elasticsearch_tpu_torch.index.device_reader import device_reader_for
    from elasticsearch_tpu_torch.index.engine import Engine
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.ops import nested
    from elasticsearch_tpu_torch.search.phase import (
        ShardSearcher, parse_search_request)
    rng = np.random.default_rng(9)
    words = [f"w{i}" for i in range(12)]
    ms = MapperService()
    ms.merge("_doc", {"properties": {
        "body": {"type": "text", "analyzer": "whitespace"},
        "a": {"type": "nested", "properties": {
            "u": {"type": "keyword"},
            "t": {"type": "text", "analyzer": "whitespace"}}}}})
    eng = Engine(tmp_path / "e", ms)
    for i in range(300):
        d = {"body": " ".join(rng.choice(words, 4))}
        if i >= 40:                  # the first segment holds no objects
            d["a"] = [{"u": f"u{int(rng.integers(0, 5))}",
                       "t": " ".join(rng.choice(words, 3))}
                      for _ in range(int(rng.integers(0, 5)))]
        eng.index(str(i), d)
        if i in (39, 150):
            eng.refresh()
    eng.refresh()
    eng.delete("160")
    eng.refresh()
    bodies = [{"query": {"bool": {
        "must": [{"match": {"body": words[i]}}],
        "should": [{"nested": {"path": "a", "score_mode": mode, "query": {
            "match": {"a.t": f"{words[i + 1]} {words[i + 2]}"}}}}],
        "filter": [{"nested": {"path": "a", "score_mode": "none",
                               "query": {"term": {"a.u": "u1"}}}}]}},
        "size": 50} for i, mode in enumerate(["max", "sum", "avg", "min"])]
    host = ShardSearcher(0, device_reader_for(eng, device="cpu"), ms)
    card = ShardSearcher(0, device_reader_for(eng, device=cuda), ms)
    assert [bool(s.nested) for s in card.reader.segments] == \
        [False, True, True]
    for body in bodies:
        req = parse_search_request(body)
        want = host.query_phase_batch([req])[0]
        before = nested.NESTED_REDUCE.launches
        got = card.query_phase_batch([req])[0]
        torch.cuda.synchronize()
        # two nested clauses on each of the two segments with the path
        assert nested.NESTED_REDUCE.launches == before + 4
        assert got.total == want.total > 0
        np.testing.assert_array_equal(got.doc_ids, want.doc_ids)
        np.testing.assert_allclose(got.scores, want.scores, rtol=1e-6)


# ---------------------------------------------------------------------------
# the collective plane: K20 sort_select, the row-batched K8 / K9, the plane
# ---------------------------------------------------------------------------

SORT_SPECIAL = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.0, -1.0],
                        np.float32)


def _sort_case(rng, b, m, n_keys, ties, wide):
    """n_keys key rows (per-(row, entry) [B, M] when ``wide`` or on even
    keys, else per-doc columns [M]) with ±0.0, NaN, ±inf and ties."""
    keys = []
    for i in range(n_keys):
        shape = (b, m) if wide or i % 2 == 0 else (m,)
        v = rng.integers(0, ties, shape).astype(np.float32) if ties \
            else rng.standard_normal(shape).astype(np.float32)
        pick = rng.random(shape) < 0.2
        keys.append(np.where(pick, rng.choice(SORT_SPECIAL, shape),
                             v).astype(np.float32))
    return keys


@pytest.mark.parametrize("b,m,n_keys,k,ties,wide,neg,density,cursor", [
    (3, 100_003, 4, 1024, 0, False, (1, 2), 0.7, True),
    (2, 5000, 2, 8000, 3, False, (), 0.5, False),        # k > M
    (4, 2048, 2, 2048, 0, False, (0,), 0.9, False),      # one tile exactly
    (65, 3000, 4, 100, 1, False, (), 0.3, True),         # an all-tie column
    (1, 1, 2, 4, 0, False, (), 1.0, False),
    (2, 70_000, 6, 40_000, 5, False, (3,), 0.8, True),   # deep k
    (8, 8 * 1024, 4, 1024, 0, True, (), 0.6, False),     # the merge's shape
    (3, 4100, 0, 50, 0, False, (), 0.4, False),          # the mask alone
])
def test_sort_select_bit_identical_to_plain(cuda, b, m, n_keys, k, ties,
                                            wide, neg, density, cursor):
    rng = np.random.default_rng(m + n_keys)
    keys = [torch.from_numpy(x).to(cuda)
            for x in _sort_case(rng, b, m, n_keys, ties, wide)]
    mask = torch.from_numpy(rng.random((b, m)) < density).to(cuda)
    mask[0, : m // 2] = False
    if b > 2:
        mask[2] = False                              # an empty row
    cur = None
    if cursor:
        cur = torch.stack([torch.stack([
            (-1 if i in neg else 1) * (key[bi, m // 3] if key.dim() == 2
                                       else key[m // 3])
            for i, key in enumerate(keys)]) for bi in range(b)]).contiguous()
    before = topk.SORT_SELECT.launches
    got = topk.sort_select(keys, k, mask=mask, cursor=cur, neg=neg)
    want = topk.sort_select_plain(keys, k, mask=mask, cursor=cur, neg=neg)
    torch.cuda.synchronize()
    assert topk.SORT_SELECT.launches == before + 1
    assert got.shape == (b, min(k, m)) and got.dtype == torch.int32
    assert torch.equal(got, want)


def test_sort_select_refuses_what_it_does_not_take(cuda):
    col = torch.zeros(100, device=cuda)
    with pytest.raises(TypeError):
        topk.sort_select([col.double()], 5, rows=2)
    with pytest.raises(ValueError):
        topk.sort_select([col, torch.zeros(3, 99, device=cuda)], 5)
    with pytest.raises(ValueError):
        topk.sort_select([col], 5, mask=torch.ones(2, 100, dtype=torch.bool,
                                                     device=cuda)[:, ::1].t())
    with pytest.raises(ValueError):
        topk.sort_select([col] * 17, 5, rows=2)


@pytest.mark.parametrize("n,b,vocab", [(262_144, 64, 16), (100_003, 5, 50_000),
                                       (300, 1, 7)])
def test_row_batched_agg_kernels_equal_per_row_launches(cuda, n, b, vocab):
    """The row-batched K8 (ordinal, dd-histogram) and K9 entries: each row
    the bits of a one-row launch and of the plain versions (K9's plain
    version adds its f32 sums in the kernel's order)."""
    rng = np.random.default_rng(n)
    ords = torch.from_numpy(rng.integers(-1, vocab, (n, 2)).astype(
        np.int32)).to(cuda)
    mask = torch.from_numpy(rng.random((b, n)) < 0.4).to(cuda)
    mask[-1] = False
    vals = rng.uniform(-50.0, 150.0, n)
    vals[:3] = [0.0, -0.0, 1e6 + 0.5]
    from elasticsearch_tpu_torch.index.device_reader import dd_split
    hi_np, lo_np = dd_split(vals)
    hi, lo = torch.from_numpy(hi_np).to(cuda), torch.from_numpy(lo_np).to(cuda)
    exists = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    before = (aggs_ops.AGG_COUNTS_ROWS.launches,
              aggs_ops.AGG_STATS_ROWS.launches)
    got = aggs_ops.ord_counts_rows(ords, mask, vocab)
    h_args = (-55.0, 0.0, 5.0, 32)
    got_h = aggs_ops.dd_histogram_counts_rows(hi, lo, exists, mask, *h_args)
    got_s = aggs_ops.dd_stats_rows(hi, lo, exists, mask)
    torch.cuda.synchronize()
    assert (aggs_ops.AGG_COUNTS_ROWS.launches,
            aggs_ops.AGG_STATS_ROWS.launches) == (before[0] + 2,
                                                  before[1] + 1)
    for r in range(b):
        assert torch.equal(got[r], aggs_ops.ord_counts(ords, mask[r], vocab))
        assert torch.equal(got_h[r], aggs_ops.dd_histogram_counts(
            hi, lo, exists, mask[r], *h_args))
        assert torch.equal(got_s[r], aggs_ops.dd_stats(hi, lo, exists,
                                                       mask[r]))
    assert torch.equal(got, aggs_ops.ord_counts_rows_plain(ords, mask, vocab))
    assert torch.equal(got_h, aggs_ops.histogram_counts_dd_rows_plain(
        hi, lo, exists, mask, *h_args))
    # the plain version adds the sums in the kernel's order
    assert torch.equal(got_s, aggs_ops.dd_stats_rows_plain(hi, lo, exists,
                                                          mask))


def test_collective_plane_on_the_card_matches_the_cpu(cuda, tmp_path):
    """MeshEngineSearcher on a mesh of one NCCL rank on the card against
    the same searcher on a CPU mesh of one gloo rank: score order, a field
    sort with a cursor, aggregations. Totals, ids and sort values equal,
    scores within 1e-6; K20 and the row-batched K8 / K9 launched."""
    from elasticsearch_tpu_torch.index.engine import Engine
    from elasticsearch_tpu_torch.mapping import MapperService
    from elasticsearch_tpu_torch.parallel import make_mesh
    from elasticsearch_tpu_torch.parallel import mesh_engine as me
    rng = np.random.default_rng(13)
    ms = MapperService()
    ms.merge("_doc", {"properties": {
        "t": {"type": "text", "analyzer": "whitespace"},
        "n": {"type": "long"}, "cat": {"type": "keyword"}}})
    engines = [Engine(tmp_path / f"s{i}", ms) for i in range(4)]
    for i in range(400):
        d = {"t": " ".join(f"w{int(x)}" for x in rng.zipf(1.6, 6) if x < 25)
             or "w1"}
        if i % 7:
            d["n"] = int(rng.integers(0, 60))
        if i % 5:
            d["cat"] = f"c{int(rng.integers(0, 9))}"
        engines[i % 4].index(str(i), d)
        if i == 250:
            engines[0].refresh()
    for i in (5, 77):
        engines[i % 4].delete(str(i))
    for e in engines:
        e.refresh()
    batches = [
        [{"query": {"match": {"t": f"w{i} w{i + 2}"}}, "size": 30}
         for i in range(4)],
        [{"query": {"match": {"t": f"w{i}"}}, "size": 20,
          "sort": [{"cat": "asc"}, {"n": {"order": "desc",
                                          "missing": "_first"}}],
          "search_after": ["c3", 30]} for i in range(4)],
        [{"query": {"match": {"t": f"w{i} w1"}}, "size": 5, "aggs": {
            "by": {"terms": {"field": "cat"}},
            "h": {"histogram": {"field": "n", "interval": 7}},
            "s": {"stats": {"field": "n"}}}} for i in range(4)],
    ]
    try:
        host = me.MeshEngineSearcher(make_mesh(device="cpu"), engines, ms)
        mesh = make_mesh(device=cuda)
        card = me.MeshEngineSearcher(mesh, engines, ms)
        before = (topk.SORT_SELECT.launches,
                  aggs_ops.AGG_COUNTS_ROWS.launches,
                  aggs_ops.AGG_STATS_ROWS.launches)
        for bodies in batches:
            for gs in (True, False):
                want = host.search_batch(bodies, global_stats=gs)
                got = card.search_batch(bodies, global_stats=gs)
                for w, g in zip(want, got):
                    assert g["total"] == w["total"]
                    np.testing.assert_array_equal(g["shard_totals"],
                                                  w["shard_totals"])
                    np.testing.assert_array_equal(g["doc_ids"], w["doc_ids"])
                    np.testing.assert_allclose(g["scores"], w["scores"],
                                               rtol=1e-6)
                    assert g.get("sort_values") == w.get("sort_values")
                    if "aggregations" in w:
                        ga, wa = g["aggregations"], w["aggregations"]
                        assert ga["by"] == wa["by"] and ga["h"] == wa["h"]
                        for key in ("count", "min", "max"):
                            assert ga["s"][key] == wa["s"][key]
                        assert ga["s"]["sum"] == pytest.approx(
                            wa["s"]["sum"], rel=1e-6)
        torch.cuda.synchronize()
        after = (topk.SORT_SELECT.launches,
                 aggs_ops.AGG_COUNTS_ROWS.launches,
                 aggs_ops.AGG_STATS_ROWS.launches)
        assert all(a > b_ for a, b_ in zip(after, before))
        assert card.device_bytes() > 0
        mesh.close()
    finally:
        for e in engines:
            e.close()
        me.clear_block_cache()
