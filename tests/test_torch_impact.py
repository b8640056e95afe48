"""The impact lane's modules through the port against the JAX package, on the
CPU: the host column build (8 and 16 bits, a block table over budget), the
carry of a JAX-built column, the quantized scoring, the block bounds, the
eager and pruned segment top-k (a carry across two segments, k = 1, k above
the matches, every block skipped), the rescore gather and the window combine
in all five score modes.

The tolerance is bit-equality of every score, id and counter: the lane sums
integers and rounds once, in one f32 multiply, in the same order in both
packages. The inputs are made with numpy from a seed; a row's slots hold
unique terms, as the segment builder writes them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.segment import (
    TextFieldColumn as JaxTextFieldColumn,
    build_impact_column as jax_build_impact_column)
from elasticsearch_tpu.ops import blockmax as jbm
from elasticsearch_tpu_torch.index import carry
from elasticsearch_tpu_torch.index.segment import (
    Segment, TextFieldColumn, build_impact_column)
from elasticsearch_tpu_torch.ops import blockmax as pbm
from elasticsearch_tpu_torch.search import segment_exec

VOCAB = 40
U = 12


def _text_arrays(seed, n, np_rows=None):
    """A text field's arrays: n real rows of sorted unique term ids (some
    rows empty), -1 pads after, padded to ``np_rows`` rows."""
    rng = np.random.default_rng(seed)
    np_rows = np_rows or n
    uterms = np.full((np_rows, U), -1, np.int32)
    utf = np.zeros((np_rows, U), np.float32)
    for i in range(n):
        c = int(rng.integers(0, U + 1))
        uterms[i, :c] = np.sort(rng.choice(VOCAB, size=c, replace=False))
        utf[i, :c] = rng.integers(1, 6, size=c)
    uterms[5] = -1
    utf[5] = 0.0
    doc_len = (utf.sum(axis=1) + (uterms >= 0).any(axis=1)).astype(np.int32)
    df = np.zeros(VOCAB, np.int64)
    np.add.at(df, uterms[uterms >= 0], 1)
    return uterms, utf, doc_len, df


def _columns(seed, n, np_rows=None):
    uterms, utf, doc_len, df = _text_arrays(seed, n, np_rows)
    kw = dict(terms=[f"w{i:02d}" for i in range(VOCAB)],
              tokens=np.zeros((1, 1), np.int32), uterms=uterms, utf=utf,
              doc_len=doc_len, df=df, total_tokens=int(doc_len.sum()))
    return JaxTextFieldColumn(**kw), TextFieldColumn(**kw), df


def _icol_fields(icol):
    return (icol.scale, icol.bits, icol.block_rows, icol.doc_count,
            icol.avgdl, icol.k1, icol.b, icol.quant_gen)


@pytest.mark.parametrize("bits,block_rows,budget", [
    (8, 16, 1 << 26), (16, 32, 1 << 26), (8, 16, 100)])
def test_build_impact_column_bit_equal(bits, block_rows, budget):
    jcol, pcol, df = _columns(bits, 200, 256)
    kw = dict(df=df * 2, doc_count=420, avgdl=7.25, k1=1.1, b=0.7, bits=bits,
              block_rows=block_rows, block_budget=budget)
    want = jax_build_impact_column(jcol, **kw)
    got = build_impact_column(pcol, **kw)
    assert got.qimp.dtype == want.qimp.dtype
    np.testing.assert_array_equal(got.qimp, want.qimp)
    assert _icol_fields(got) == _icol_fields(want)
    if budget == 100:
        assert got.block_max is None and want.block_max is None
    else:
        np.testing.assert_array_equal(got.block_max, want.block_max)
    assert got.bound_per_term == want.bound_per_term


def test_carry_of_a_jax_built_column_is_what_the_lane_scores():
    jcol, pcol, df = _columns(3, 200, 256)
    want = jax_build_impact_column(jcol, df=df, doc_count=200, avgdl=6.5,
                                   bits=16, block_rows=32, quant_gen=2)
    icol = carry.impact_column_from_arrays(
        qimp=want.qimp, block_max=want.block_max, scale=want.scale,
        bits=want.bits, block_rows=want.block_rows,
        doc_count=want.doc_count, avgdl=want.avgdl, k1=want.k1, b=want.b,
        quant_gen=want.quant_gen)
    np.testing.assert_array_equal(icol.qimp, want.qimp)
    np.testing.assert_array_equal(icol.block_max, want.block_max)
    assert _icol_fields(icol) == _icol_fields(want)
    seg = Segment.from_packed_text(
        0, "body", terms=pcol.terms, tokens=None, uterms=pcol.uterms,
        utf=pcol.utf, doc_len=pcol.doc_len, df=df, num_docs=200,
        ids=[str(i) for i in range(256)])
    carry.install_impact_column(seg, "body", icol, block_rows=32)

    class _Reader:          # the pack's reader, as far as the build reads it
        segments = []

    class _DSeg:
        pass
    dseg = _DSeg()
    dseg.seg = seg
    cfg = segment_exec.ImpactPlaneConfig(bits=16, block_rows=32)
    got = segment_exec._host_impact_column(
        _Reader(), dseg, "body", cfg, want.k1, want.b, 200, 6.5)
    assert got is icol
    with pytest.raises(ValueError):
        carry.install_impact_column(seg, "body", carry.impact_column_from_arrays(
            qimp=want.qimp[:8], block_max=None, scale=1.0, bits=16,
            block_rows=32, doc_count=1, avgdl=1.0, k1=1.2, b=0.75),
            block_rows=32)


def _impact_inputs(seed, n, bits, b, t):
    """A segment's (uterms, qimp, live) and a batch's term ids with a pad
    (-1), a term absent from the segment's rows and a repeated term."""
    uterms, _, _, _ = _text_arrays(seed, n)
    rng = np.random.default_rng(seed + 100)
    qmax = (1 << bits) - 1
    qimp = np.where(uterms >= 0, rng.integers(0, qmax + 1, uterms.shape),
                    0).astype(np.uint8 if bits == 8 else np.uint16)
    qimp[uterms == 7] = 0                   # a term quantized to 0 everywhere
    live = rng.random(n) > 0.1
    qtids = rng.integers(0, VOCAB, size=(b, t)).astype(np.int32)
    qtids[0, -1] = -1
    qtids[1, 0] = qtids[1, -1]
    qtids[2, 0] = 7
    qtids[3, :] = VOCAB + 5                 # no row holds it
    return uterms, qimp, live, qtids


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("bits", [8, 16])
def test_impact_scores_and_bounds_bit_equal(bits):
    uterms, qimp, live, qtids = _impact_inputs(bits, 192, bits, 5, 11)
    for q in range(qtids.shape[0]):
        jq, jh = jbm.impact_scores(jnp.asarray(uterms), jnp.asarray(qimp),
                                   jnp.asarray(qtids[q]))
        pq, ph = pbm.impact_scores(_t(uterms), _t(qimp), _t(qtids[q]))
        np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    # the batched plain version: scores, the live mask and a cursor
    sb = np.float32([0.37, 1.5, 0.0, 2.25, 0.11])
    cs = np.float32([np.inf, 400.0, np.inf, np.inf, 90.0])
    cd = np.int32([-1, 17, -1, -1, 60])
    got_s, got_v = pbm.impact_scores_batch(
        _t(uterms), _t(qimp), _t(qtids), _t(sb), _t(live), _t(cs), _t(cd),
        doc_base=10)
    for q in range(qtids.shape[0]):
        ts, td, cnt = jbm.eager_segment_topk(
            jnp.asarray(uterms), jnp.asarray(qimp), jnp.asarray(live),
            jnp.asarray(qtids[q]), jnp.float32(sb[q]), 192, 10,
            jnp.float32(cs[q]), jnp.int32(cd[q]))
        assert int(got_v[q].sum()) == int(cnt)
        order = np.asarray(td)[np.asarray(td) >= 0]        # local ids
        np.testing.assert_array_equal(
            got_s[q].numpy()[order].view(np.int32),
            np.asarray(ts)[:len(order)].view(np.int32))
    # block bounds: [NB, V] tables, 12 blocks of 16 rows; a segment's term
    # ids are in its dictionary or -1
    bm = jax_build_impact_column(
        _columns(bits, 192)[0], df=np.full(VOCAB, 3), doc_count=192,
        avgdl=6.0, bits=bits, block_rows=16).block_max
    qtids = np.where(qtids < VOCAB, qtids, -1).astype(np.int32)
    got = pbm.block_bounds(_t(bm), _t(qtids)).numpy()
    for q in range(qtids.shape[0]):
        np.testing.assert_array_equal(
            got[q], np.asarray(jbm.block_bounds(jnp.asarray(bm),
                                                jnp.asarray(qtids[q]))))


def test_term_caps_are_refused():
    uterms, qimp, live, qtids = _impact_inputs(1, 64, 16, 4, 3)
    wide = np.zeros((1, 128), np.int32)
    one = torch.ones(1)
    with pytest.raises(ValueError, match="cap 127"):
        pbm.impact_scores_batch(_t(uterms), _t(qimp), _t(wide), one,
                                _t(live), one, torch.zeros(1, dtype=torch.int32))


def _segments(bits, n_rows=128, block_rows=16):
    """Two segments' (uterms, qimp, live, block_max) and their bases."""
    segs = []
    for i, base in enumerate((0, n_rows)):
        jcol, _, df = _columns(20 + i, n_rows - 9, n_rows)
        icol = jax_build_impact_column(jcol, df=df + 1, doc_count=2 * n_rows,
                                       avgdl=6.0, bits=bits,
                                       block_rows=block_rows)
        live = np.random.default_rng(i).random(n_rows) > 0.05
        live[n_rows - 9:] = False
        segs.append((jcol.uterms, icol.qimp, live, icol.block_max, base,
                     np.float32(icol.scale)))
    return segs


def _jax_pruned(k):
    """The JAX sweep over a batch, under lax.map as run_impact_pruned runs
    it, one segment a call (doc_base traced, so both segments share one
    program)."""
    def run(carry, ut, qi, lv, bmx, qts, sbs, base, cs, cd):
        def per_query(args):
            c, qt, sb, c1, c2 = args
            return jbm.pruned_segment_topk(c, ut, qi, lv, bmx, qt, sb, k,
                                           base, c1, c2)
        return jax.lax.map(per_query, (carry, qts, sbs, cs, cd))
    return jax.jit(run)


@pytest.mark.parametrize("bits,k", [(8, 5), (16, 1), (16, 200)])
def test_eager_and_pruned_segment_topk_bit_equal(bits, k):
    segs = _segments(bits)
    b = 6
    rng = np.random.default_rng(bits + k)
    qtids = rng.integers(0, VOCAB, size=(b, 3)).astype(np.int32)
    qtids[1, 2] = -1
    qtids[2] = 7                      # impacts of 0 on many rows
    boosts = np.float32([1.0, 2.5, 1.0, 0.3, 1.0, 0.0])
    cs = np.float32([np.inf] * 5 + [np.inf])
    cd = np.int32([-1] * b)
    jrun = _jax_pruned(k)
    jc = tuple(jnp.broadcast_to(x, (b,) + x.shape)
               for x in jbm.pruned_carry_init(k))
    pc = pbm.pruned_carry_init(b, k, "cpu")
    eager_s, eager_d, eager_n = [], [], 0
    for ut, qi, lv, bmx, base, scale in segs:
        sbs = (np.float32(scale) * boosts).astype(np.float32)
        jc = jrun(jc, jnp.asarray(ut), jnp.asarray(qi), jnp.asarray(lv),
                  jnp.asarray(bmx), jnp.asarray(qtids), jnp.asarray(sbs),
                  jnp.int32(base), jnp.asarray(cs), jnp.asarray(cd))
        pc = pbm.pruned_segment_topk(pc, _t(ut), _t(qi), _t(lv), _t(bmx),
                                     _t(qtids), _t(sbs), k, base, _t(cs),
                                     _t(cd))
        for got, want in zip(pc, jc):
            np.testing.assert_array_equal(got.numpy().view(np.int32),
                                          np.asarray(want).view(np.int32))
        ts, td, cnt = pbm.eager_segment_topk(_t(ut), _t(qi), _t(lv),
                                             _t(qtids), _t(sbs), k, base,
                                             _t(cs), _t(cd))
        for q in range(b):
            jts, jtd, jcnt = jbm.eager_segment_topk(
                jnp.asarray(ut), jnp.asarray(qi), jnp.asarray(lv),
                jnp.asarray(qtids[q]), jnp.float32(sbs[q]), k, 0,
                jnp.float32(cs[q]), jnp.int32(cd[q]))
            np.testing.assert_array_equal(ts[q].numpy().view(np.int32),
                                          np.asarray(jts).view(np.int32))
            np.testing.assert_array_equal(td[q].numpy(), np.asarray(jtd))
            assert int(cnt[q]) == int(jcnt)
        eager_s.append(ts)
        eager_d.append(torch.where(td >= 0, td + base, -1))
        eager_n = eager_n + cnt
    # the sweep's top-k is the eager arm's, and its counters add up
    m_s, m_d = pbm.topk_flat_by_doc(torch.cat(eager_s, 1),
                                    torch.cat(eager_d, 1), k)
    assert torch.equal(pc[0].view(torch.int32), m_s.view(torch.int32))
    assert torch.equal(pc[1], m_d)
    assert (pc[2] + pc[3] == 2 * (128 // 16)).all()


def test_sweep_skips_every_block_under_a_high_carry():
    ut, qi, lv, bmx, base, scale = _segments(8)[0]
    qtids = np.int32([[1, 2, 3], [4, 5, -1]])
    sbs = np.float32([scale, scale])
    # a carry whose k-th score no block can reach
    carry_in = (torch.full((2, 3), 1e9), torch.tensor([[1, 2, 3]] * 2,
                                                      dtype=torch.int32),
                torch.zeros(2, dtype=torch.int32),
                torch.zeros(2, dtype=torch.int32),
                torch.zeros(2, dtype=torch.int32))
    ub_i = pbm.block_bounds(_t(bmx), _t(qtids))
    ub_f, order = pbm.sweep_order(ub_i, _t(sbs))
    cs, cd = torch.full((2,), float("inf")), torch.full((2,), -1,
                                                         dtype=torch.int32)
    out = pbm.blockmax_sweep(carry_in, _t(ut), _t(qi), _t(lv), ub_i, ub_f,
                             order, _t(qtids), _t(sbs), cs, cd, 3, base)
    assert out[2].tolist() == [0, 0] and out[3].tolist() == [8, 8]
    assert torch.equal(out[0], carry_in[0]) and torch.equal(out[1],
                                                            carry_in[1])
    assert carry_in[3].tolist() == [0, 0]          # the input is unchanged
    # k past the shared-memory top-k (any k is served): the same skips
    k = pbm.K7_SMEM_K + 1
    high = (torch.full((2, k), 1e9),
            torch.arange(2 * k, dtype=torch.int32).view(2, k),
            *carry_in[2:])
    out = pbm.blockmax_sweep(high, _t(ut), _t(qi), _t(lv), ub_i, ub_f,
                             order, _t(qtids), _t(sbs), cs, cd, k, base)
    assert out[2].tolist() == [0, 0] and out[3].tolist() == [8, 8]
    assert torch.equal(out[1], high[1])


@pytest.mark.parametrize("bits", [8, 16])
def test_rescore_gather_bit_equal(bits):
    segs = _segments(bits)
    rng = np.random.default_rng(bits)
    docs = rng.integers(-1, 256, size=(3, 10)).astype(np.int32)
    qtids = rng.integers(0, VOCAB, size=(3, 2)).astype(np.int32)
    for ut, qi, _, _, base, _ in segs:
        got_q, got_h = pbm.rescore_gather(_t(ut), _t(qi), _t(docs),
                                          _t(qtids), base)
        for q in range(3):
            jq, jh = jbm.rescore_gather(jnp.asarray(ut), jnp.asarray(qi),
                                        jnp.asarray(docs[q]),
                                        jnp.asarray(qtids[q]), base)
            np.testing.assert_array_equal(got_q[q].numpy(), np.asarray(jq))
            np.testing.assert_array_equal(got_h[q].numpy(), np.asarray(jh))


@pytest.mark.parametrize("mode", ["total", "multiply", "avg", "max", "min"])
def test_rescore_window_bit_equal(mode):
    rng = np.random.default_rng(len(mode))
    b, k = 5, 12
    scores = -np.sort(-rng.random((b, k)).astype(np.float32) * 9, axis=1)
    scores[:, 4:6] = scores[:, 3:4]                  # ties in the window
    docs = np.stack([rng.permutation(50)[:k] for _ in range(b)]).astype(
        np.int32)
    docs[1, 8:] = -1
    scores[1, 8:] = -np.inf
    docs[2, :] = -1
    scores[2, :] = -np.inf
    sec = (rng.random((b, k)) * 5).astype(np.float32)
    sec[0, 2] = 0.0
    hit = rng.random((b, k)) > 0.4
    window = np.int32([6, 20, 4, 0, 12])
    qw = np.float32([1.0, 0.7, 1.3, 2.0, -1.0])
    rw = np.float32([1.5, 1.0, 0.2, 3.0, 1.0])
    got_s, got_d = pbm.rescore_window(_t(scores), _t(docs), _t(sec),
                                      _t(hit), _t(window), _t(qw), _t(rw),
                                      mode)
    for q in range(b):
        js, jd = jbm.rescore_window(
            jnp.asarray(scores[q]), jnp.asarray(docs[q]), jnp.asarray(sec[q]),
            jnp.asarray(hit[q]), jnp.int32(window[q]), jnp.float32(qw[q]),
            jnp.float32(rw[q]), mode)
        np.testing.assert_array_equal(got_s[q].numpy().view(np.int32),
                                      np.asarray(js).view(np.int32))
        np.testing.assert_array_equal(got_d[q].numpy(), np.asarray(jd))
