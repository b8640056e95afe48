"""The port's bool algebra, filters and term mask against the JAX package's
``ops/boolean``, ``ops/filters`` and ``ops/lexical.term_filter``.

Both packages get the same numpy inputs; the port runs a batch ([B, N],
per-query constants [B]) and the reference one query at a time. Masks must
be equal and scores bit-identical: the port keeps the reference's order of
the float adds (musts, then shoulds, each in clause order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import boolean as jax_boolean
from elasticsearch_tpu.ops import filters as jax_filters
from elasticsearch_tpu.ops import lexical as jax_lexical
from elasticsearch_tpu.index.device_reader import dd_split as jax_dd_split
from elasticsearch_tpu.search.execute import _resolve_msm as jax_resolve_msm
from elasticsearch_tpu_torch.index.device_reader import dd_split
from elasticsearch_tpu_torch.ops import boolean, filters, lexical
from elasticsearch_tpu_torch.search.execute import _resolve_msm

B, N = 4, 64


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _clauses(rng, count):
    """``count`` (scores [B, N], mask [B, N]) clause results; scores off
    the mask are nonzero, as an emit's may be."""
    out = []
    for _ in range(count):
        s = rng.uniform(0.0, 9.0, size=(B, N)).astype(np.float32)
        m = rng.random((B, N)) < 0.6
        out.append((s, m))
    return out


@pytest.mark.parametrize("n_must,n_should,n_not,n_filter,msm", [
    (0, 3, 0, 0, 1),
    (2, 3, 1, 1, 2),
    (1, 2, 0, 0, 0),
    (0, 4, 1, 0, -1),
    (1, 4, 0, 1, "50%"),
    (0, 3, 0, 0, "-34%"),
    (2, 0, 2, 1, 0),
])
def test_combine_bool_matches_jax(n_must, n_should, n_not, n_filter, msm):
    rng = np.random.default_rng(n_must * 10 + n_should)
    must, should = _clauses(rng, n_must), _clauses(rng, n_should)
    must_not = [rng.random((B, N)) < 0.2 for _ in range(n_not)]
    filt = [rng.random(N) < 0.8 for _ in range(n_filter)]   # [N]: broadcasts
    want_msm = jax_resolve_msm(msm, n_should)
    assert _resolve_msm(msm, n_should) == want_msm
    # per-query thresholds differ inside the batch
    msms = np.array([want_msm, max(want_msm - 1, 0), want_msm + 1,
                     want_msm], np.int32)
    got_s, got_m = boolean.combine_bool(
        (B, N), [(_t(s), _t(m)) for s, m in must],
        [(_t(s), _t(m)) for s, m in should], [_t(m) for m in must_not],
        [_t(m) for m in filt], _t(msms))
    for q in range(B):
        want_s, want_m = jax_boolean.combine_bool(
            N, [(jnp.asarray(s[q]), jnp.asarray(m[q])) for s, m in must],
            [(jnp.asarray(s[q]), jnp.asarray(m[q])) for s, m in should],
            [jnp.asarray(m[q]) for m in must_not],
            [jnp.asarray(m) for m in filt], int(msms[q]))
        np.testing.assert_array_equal(got_m[q].numpy(), np.asarray(want_m))
        np.testing.assert_array_equal(got_s[q].numpy(), np.asarray(want_s))


def test_constant_score_matches_jax():
    rng = np.random.default_rng(3)
    mask = rng.random(N) < 0.5
    boosts = np.array([1.0, 2.5, 0.0, 7.25], np.float32)
    got_s, got_m = boolean.constant_score(_t(mask), _t(boosts))
    assert got_s.shape == got_m.shape == (B, N)
    for q in range(B):
        want_s, want_m = jax_boolean.constant_score(jnp.asarray(mask),
                                                    float(boosts[q]))
        np.testing.assert_array_equal(got_s[q].numpy(), np.asarray(want_s))
        np.testing.assert_array_equal(got_m[q].numpy(), np.asarray(want_m))


def test_keyword_filters_match_jax():
    rng = np.random.default_rng(5)
    ords = rng.integers(-1, 12, size=(N, 3)).astype(np.int32)
    qord = np.array([4, -1, 11, 0], np.int32)
    qords = rng.integers(-1, 12, size=(B, 5)).astype(np.int32)
    lo = np.array([0, 3, 7, 12], np.int32)
    hi = np.array([12, 3, 9, 12], np.int32)
    got_t = filters.keyword_term(_t(ords), _t(qord))
    got_ts = filters.keyword_terms(_t(ords), _t(qords))
    got_r = filters.keyword_ord_range(_t(ords), _t(lo), _t(hi))
    for q in range(B):
        j = jnp.asarray(ords)
        np.testing.assert_array_equal(got_t[q].numpy(), np.asarray(
            jax_filters.keyword_term(j, jnp.int32(qord[q]))))
        np.testing.assert_array_equal(got_ts[q].numpy(), np.asarray(
            jax_filters.keyword_terms(j, jnp.asarray(qords[q]))))
        np.testing.assert_array_equal(got_r[q].numpy(), np.asarray(
            jax_filters.keyword_ord_range(j, jnp.int32(lo[q]),
                                          jnp.int32(hi[q]))))
    exists = (ords >= 0).any(axis=1)
    np.testing.assert_array_equal(filters.field_exists(_t(exists)).numpy(),
                                  np.asarray(jax_filters.field_exists(
                                      jnp.asarray(exists))))


def test_numeric_filters_match_jax_with_infinite_and_strict_bounds():
    rng = np.random.default_rng(9)
    values = rng.uniform(-50.0, 50.0, size=N)
    values[:4] = [0.0, 5e-324, 1e300, -1e300]
    values[4:8] = values[8:12]                      # ties with other rows
    exists = rng.random(N) < 0.9
    hi, lo = dd_split(values)
    jhi, jlo = jax_dd_split(values)
    np.testing.assert_array_equal(hi, jhi)
    np.testing.assert_array_equal(lo, jlo)
    bounds = [(-np.inf, np.inf, 0, 0), (0.0, 10.0, 1, 0),
              (float(values[8]), float(values[8]), 0, 0),
              (-20.0, float(values[9]), 0, 1)]
    g = [dd_split(bd[0]) for bd in bounds]
    lq = [dd_split(bd[1]) for bd in bounds]
    col = (_t(hi), _t(lo), _t(exists))
    arr = lambda xs: _t(np.array(xs, np.float32))   # noqa: E731
    got = filters.numeric_range(
        *col, arr([x[0] for x in g]), arr([x[1] for x in g]),
        arr([x[0] for x in lq]), arr([x[1] for x in lq]),
        lo_strict=arr([bd[2] for bd in bounds]),
        hi_strict=arr([bd[3] for bd in bounds]))
    got_term = filters.numeric_term(*col, arr([x[0] for x in lq]),
                                    arr([x[1] for x in lq]))
    jcol = (jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(exists))
    for q, bd in enumerate(bounds):
        want = jax_filters.numeric_range(
            *jcol, jnp.float32(g[q][0]), jnp.float32(g[q][1]),
            jnp.float32(lq[q][0]), jnp.float32(lq[q][1]),
            lo_strict=jnp.float32(bd[2]), hi_strict=jnp.float32(bd[3]))
        np.testing.assert_array_equal(got[q].numpy(), np.asarray(want))
        np.testing.assert_array_equal(got_term[q].numpy(), np.asarray(
            jax_filters.numeric_term(*jcol, jnp.float32(lq[q][0]),
                                     jnp.float32(lq[q][1]))))
    assert got[0].numpy().tolist() == exists.tolist()   # ±inf: every value


def test_text_exists_and_term_filter_match_jax():
    rng = np.random.default_rng(2)
    uterms = np.sort(rng.integers(-1, 20, size=(N, 6)), axis=1)[:, ::-1]
    uterms = np.ascontiguousarray(uterms, np.int32)
    doc_len = rng.integers(0, 4, size=N).astype(np.int32)
    qtid = np.array([3, -1, 19, 0], np.int32)
    got = lexical.term_filter(_t(uterms), _t(qtid))
    for q in range(B):
        np.testing.assert_array_equal(got[q].numpy(), np.asarray(
            jax_lexical.term_filter(jnp.asarray(uterms), jnp.int32(qtid[q]))))
    np.testing.assert_array_equal(
        filters.text_field_exists(_t(doc_len)).numpy(),
        np.asarray(jax_filters.text_field_exists(jnp.asarray(doc_len))))

