"""The collective plane's kernels' plain versions against the JAX bodies.

* K20 ``sort_select``'s plain version against the reference's
  ``mesh_engine._stable_order`` fed as the JAX plane feeds it (the key rows
  broadcast to [B, M], the search_after compare folded into the mask,
  invalid entries' keys +inf): random keys holding ±0.0, NaN, ±inf and
  heavy ties, per-doc columns beside per-(row, entry) keys, desc
  negation, a cursor, an empty mask, k above M. Positions bit-identical.
* The row-batched K8 (ordinal and dd-histogram) and K9 entries' plain
  versions against ``jax.vmap`` of the reference's ``ord_value_counts`` /
  ``histogram_counts_dd`` and the plane's masked metric partials
  (mesh_engine.py:1523-1544): counts and extrema exact, sums within rtol
  1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import aggs_ops as jax_aggs
from elasticsearch_tpu.parallel.mesh_engine import _stable_order
from elasticsearch_tpu_torch.index.device_reader import dd_split
from elasticsearch_tpu_torch.ops import aggs_ops, topk

SPECIAL = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.0, -1.0],
                   np.float32)


def _keys(rng, b, m, n_keys, ties, special):
    """n_keys key rows: even ones [B, M], odd ones per-doc columns [M]."""
    out = []
    for i in range(n_keys):
        shape = (b, m) if i % 2 == 0 else (m,)
        v = rng.integers(0, ties, shape).astype(np.float32) if ties \
            else rng.standard_normal(shape).astype(np.float32)
        if special:
            pick = rng.random(shape) < 0.3
            v = np.where(pick, rng.choice(SPECIAL, shape), v)
        out.append(v.astype(np.float32))
    return out


def _reference(keys, k, mask, cursor, neg, b, m):
    """The JAX plane's per-shard selection (mesh_engine.py:1607-1671)."""
    raw = [jnp.broadcast_to(-jnp.asarray(x) if i in neg else jnp.asarray(x),
                            (b, m)) for i, x in enumerate(keys)]
    msk = jnp.asarray(mask)
    if cursor is not None:
        cur = jnp.asarray(cursor)
        gt = jnp.zeros_like(msk)
        eq = jnp.ones_like(msk)
        for i, arr in enumerate(raw):
            c = cur[:, i][:, None]
            gt = gt | (eq & (arr > c))
            eq = eq & (arr == c)
        msk = msk & gt
    inval = jnp.where(msk, 0.0, 1.0).astype(jnp.float32)
    ordered = [inval] + [jnp.where(inval > 0, jnp.inf, arr) for arr in raw]
    return np.asarray(_stable_order(ordered, min(k, m)))


CASES = [
    # (B, M, key rows, k, ties, specials, negated, mask density, cursor)
    (3, 50, 2, 10, 0, True, (), 0.7, False),
    (4, 64, 4, 64, 3, True, (1, 2), 0.5, False),
    (2, 37, 4, 100, 2, True, (0,), 0.9, True),
    (5, 200, 2, 17, 4, False, (1,), 0.6, True),
    (2, 30, 6, 5, 2, True, (0, 3, 4), 1.0, True),
    (3, 25, 2, 8, 3, True, (), 0.0, False),
    (1, 1, 2, 4, 0, True, (), 1.0, False),
    (4, 300, 0, 20, 0, False, (), 0.4, False),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_sort_select_plain_matches_stable_order(case):
    b, m, n_keys, k, ties, special, neg, density, with_cursor = CASES[case]
    rng = np.random.default_rng(100 + case)
    keys = _keys(rng, b, m, n_keys, ties, special)
    mask = rng.random((b, m)) < density
    cursor = None
    if with_cursor:
        # cursors drawn from the keys themselves (ties at the cursor)
        cursor = np.stack([np.asarray([
            (-1 if i in neg else 1) * (x[bi, m // 2] if x.ndim == 2
                                       else x[m // 2])
            for i, x in enumerate(keys)], np.float32) for bi in range(b)])
    want = _reference(keys, k, mask, cursor, neg, b, m)
    got = topk.sort_select(
        [torch.from_numpy(x) for x in keys], k, mask=torch.from_numpy(mask),
        cursor=None if cursor is None else torch.from_numpy(cursor),
        neg=neg, rows=b)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_sort_select_refusals():
    col = torch.zeros(5)
    with pytest.raises(ValueError):
        topk.sort_select([col], 0, rows=1)
    with pytest.raises(ValueError):
        topk.sort_select([col], 3)                 # no row axis anywhere
    with pytest.raises(ValueError):
        topk.sort_select([col, torch.zeros(2, 4)], 3)
    with pytest.raises(ValueError):
        topk.sort_select([col] * 17, 3, rows=1)


def test_row_batched_counts_match_vmapped_reference():
    rng = np.random.default_rng(7)
    b, n, k_ords, vocab = 6, 300, 2, 13
    ords = rng.integers(-1, vocab + 2, (n, k_ords)).astype(np.int32)
    mask = rng.random((b, n)) < 0.5
    mask[2] = False
    want = np.asarray(jax.vmap(lambda m: jax_aggs.ord_value_counts(
        jnp.asarray(ords), m, vocab))(jnp.asarray(mask)))
    got = aggs_ops.ord_counts_rows(torch.from_numpy(ords),
                                   torch.from_numpy(mask), vocab)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    vals = np.concatenate([rng.integers(0, 100, n - 10) * 1.5,
                           [0.0, -0.0, 1e15 + 0.5, -3.25, 99.999999,
                            5.0, 10.0, 4.999999999, np.nan, 7.0]])
    hi, lo = dd_split(vals)
    exists = rng.random(n) < 0.9
    base = -5.0
    bh, bl = dd_split(np.float64(base))
    args = (float(bh), float(bl), 5.0, 30)
    want = np.asarray(jax.vmap(lambda m: jax_aggs.histogram_counts_dd(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(exists), m,
        *args))(jnp.asarray(mask)))
    got = aggs_ops.dd_histogram_counts_rows(
        torch.from_numpy(hi), torch.from_numpy(lo), torch.from_numpy(exists),
        torch.from_numpy(mask), *args)
    assert np.array_equal(got.numpy(), want)


def test_row_batched_stats_match_plane_partials():
    """K9's row-batched plain version against the JAX plane's masked
    partials (sums of hi and lo, count, lexicographic dd extrema)."""
    rng = np.random.default_rng(9)
    b, n = 5, 400
    vals = rng.standard_normal(n) * 1e3 + 0.123456789
    vals[:4] = [0.0, -0.0, 1e12 + 0.25, -7.5]
    hi, lo = dd_split(vals)
    exists = rng.random(n) < 0.85
    mask = rng.random((b, n)) < 0.6
    mask[1] = False
    mask[3, 2:] = False                 # only ±0.0 left
    m = jnp.asarray(mask) & jnp.asarray(exists)[None, :]
    jh, jl = jnp.asarray(hi)[None, :], jnp.asarray(lo)[None, :]
    mn_hi = jnp.where(m, jh, jnp.inf).min(axis=1)
    mx_hi = jnp.where(m, jh, -jnp.inf).max(axis=1)
    want = {
        "sum_hi": np.asarray(jnp.where(m, jh, 0.0).sum(axis=1)),
        "sum_lo": np.asarray(jnp.where(m, jl, 0.0).sum(axis=1)),
        "count": np.asarray(m.sum(axis=1)),
        "min_hi": np.asarray(mn_hi),
        "min_lo": np.asarray(jnp.where(m & (jh == mn_hi[:, None]), jl,
                                       jnp.inf).min(axis=1)),
        "max_hi": np.asarray(mx_hi),
        "max_lo": np.asarray(jnp.where(m & (jh == mx_hi[:, None]), jl,
                                       -jnp.inf).max(axis=1)),
    }
    got = aggs_ops.dd_stats_rows(torch.from_numpy(hi), torch.from_numpy(lo),
                                 torch.from_numpy(exists),
                                 torch.from_numpy(mask)).numpy()
    assert got.shape == (b, 8) and got.dtype == np.float64
    fields = dict(zip(aggs_ops.STATS_FIELDS, got.T))
    assert np.array_equal(fields["count"], want["count"])
    for key in ("min_hi", "min_lo", "max_hi", "max_lo"):
        # a zero extremum is +0.0 in the port; -0.0 == +0.0 compares equal
        assert np.array_equal(fields[key], want[key].astype(np.float64)), key
    for key in ("sum_hi", "sum_lo"):
        np.testing.assert_allclose(fields[key], want[key], rtol=1e-6,
                                   atol=1e-30)
