"""The port's function_score ops against the JAX package's
``ops/functionscore``.

Both packages get the same numpy inputs; the port runs a batch (per-query
parameters [B], factors [B, N]) and the reference one query at a time
under ``jax.jit``. Where the op order pins the result (no modifier,
square, reciprocal, linear decay, every score_mode and boost_mode,
random_score) it must be bit-identical. ``log10``, ``ln``, ``log1p``,
``exp`` and ``sqrt`` are computed by XLA's own approximations on one side
and by the C library's on the other, which may differ by an ulp or two of
the result, so those agree to 4 ulp (rtol 4.8e-7); and XLA on the CPU
flushes subnormal results to zero, so they may also differ by less than
the smallest normal f32 (atol 1.18e-38, where a gauss decay underflows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import functionscore as jax_fs
from elasticsearch_tpu.utils.hashing import murmur3_hash32 as jax_murmur3
from elasticsearch_tpu_torch.ops import functionscore as fs
from elasticsearch_tpu_torch.utils.murmur3 import murmur3_hash32

B, N = 3, 257
TRANSCENDENTAL_RTOL = 4.8e-7    # 4 ulp of f32: log/exp approximations differ
SUBNORMAL_ATOL = float(np.finfo(np.float32).tiny)   # XLA flushes to zero


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _column(rng):
    values = rng.uniform(0.0, 100.0, size=N).astype(np.float32)
    values[:3] = [0.0, 1e-3, 99.99]
    exists = rng.random(N) < 0.85
    return values, exists


def _close(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=TRANSCENDENTAL_RTOL,
                                   atol=SUBNORMAL_ATOL)


@pytest.mark.parametrize("modifier,exact", [
    ("none", True), ("log", False), ("log1p", False), ("log2p", False),
    ("ln", False), ("ln1p", False), ("ln2p", False), ("square", True),
    ("sqrt", False), ("reciprocal", True)])
@pytest.mark.parametrize("with_missing", [False, True])
def test_field_value_factor_matches_jax(modifier, exact, with_missing):
    rng = np.random.default_rng(len(modifier))
    values, exists = _column(rng)
    factor = np.array([1.0, 2.5, 0.3], np.float32)
    missing = np.array([1.0, 0.5, 3.0], np.float32)
    got = fs.field_value_factor(
        _t(values), _t(exists), factor=_t(factor), modifier=modifier,
        missing=_t(missing) if with_missing else None).numpy()
    fn = jax.jit(lambda v, e, f, m: jax_fs.field_value_factor(
        v, e, factor=f, modifier=modifier, missing=m if with_missing
        else None))
    for q in range(B):
        want = np.asarray(fn(jnp.asarray(values), jnp.asarray(exists),
                             factor[q], missing[q]))
        _close(got[q], want, exact)


@pytest.mark.parametrize("kind,exact", [("gauss", False), ("exp", False),
                                        ("linear", True)])
def test_decay_matches_jax(kind, exact):
    rng = np.random.default_rng(11)
    values, exists = _column(rng)
    origin = np.array([50.0, 0.0, 12.5], np.float32)
    scale = np.array([10.0, 40.0, 3.0], np.float32)
    offset = np.array([0.0, 5.0, 1.0], np.float32)
    decay = np.array([0.5, 0.25, 0.9], np.float32)
    got = fs.decay(_t(values), _t(exists), _t(origin), _t(scale),
                   _t(offset), _t(decay), kind).numpy()
    fn = jax.jit(lambda v, e, o, s, f, d: jax_fs.decay(v, e, o, s, f, d,
                                                       kind))
    for q in range(B):
        want = np.asarray(fn(jnp.asarray(values), jnp.asarray(exists),
                             origin[q], scale[q], offset[q], decay[q]))
        _close(got[q], want, exact)


@pytest.mark.parametrize("seed", [0, 42, 123456789, -7])
def test_random_score_is_bit_identical(seed):
    assert murmur3_hash32(str(seed)) == jax_murmur3(str(seed))
    bases = np.array([0, 1 << 20, (1 << 32) - 100], np.int64)
    got = fs.random_score(N, seed, _t(bases)).numpy()
    for q in range(B):
        want = np.asarray(jax.jit(
            lambda base: jax_fs.random_score(N, seed, base))(
                np.uint32(bases[q])))
        np.testing.assert_array_equal(got[q], want)


@pytest.mark.parametrize("score_mode", ["first", "multiply", "sum", "avg",
                                        "max", "min"])
def test_combine_functions_matches_jax(score_mode):
    rng = np.random.default_rng(len(score_mode))
    factors = [rng.uniform(0.0, 4.0, size=(B, N)).astype(np.float32)
               for _ in range(3)]
    factors[1][:, 5] = np.inf
    masks = [rng.random((B, N)) < p for p in (0.5, 0.3, 0.7)]
    masks[2][:, :9] = False
    masks[0][:, :9] = False                  # docs no function matched
    masks[1][:, :9] = False
    weights = [np.array([1.0, 2.0, 0.5], np.float32),
               np.array([3.0, 1.0, 1.0], np.float32),
               np.array([0.25, 4.0, 2.0], np.float32)]
    got = fs.combine_functions([_t(f) for f in factors],
                               [_t(m) for m in masks], score_mode,
                               weights=[_t(w) for w in weights]).numpy()
    for q in range(B):
        want = np.asarray(jax.jit(lambda fs_, ms_, ws_: jax_fs.
                                  combine_functions(fs_, ms_, score_mode,
                                                    weights=ws_))(
            [jnp.asarray(f[q]) for f in factors],
            [jnp.asarray(m[q]) for m in masks],
            [jnp.float32(w[q]) for w in weights]))
        np.testing.assert_array_equal(got[q], want)


@pytest.mark.parametrize("boost_mode", ["multiply", "replace", "sum", "avg",
                                        "max", "min"])
@pytest.mark.parametrize("with_max_boost", [False, True])
def test_apply_boost_mode_matches_jax(boost_mode, with_max_boost):
    rng = np.random.default_rng(len(boost_mode))
    scores = rng.uniform(0.0, 20.0, size=(B, N)).astype(np.float32)
    factor = rng.uniform(0.0, 5.0, size=(B, N)).astype(np.float32)
    max_boost = np.array([2.0, 10.0, 0.5], np.float32)
    got = fs.apply_boost_mode(_t(scores), _t(factor), boost_mode,
                              _t(max_boost) if with_max_boost else None)
    for q in range(B):
        want = jax.jit(lambda s, f, mb: jax_fs.apply_boost_mode(
            s, f, boost_mode, mb if with_max_boost else None))(
            jnp.asarray(scores[q]), jnp.asarray(factor[q]), max_boost[q])
        np.testing.assert_array_equal(got[q].numpy(), np.asarray(want))


def test_weight_factor_matches_jax():
    w = np.array([1.0, 0.25, 3.5], np.float32)
    got = fs.weight_factor(N, _t(w))
    assert got.shape == (B, N)
    for q in range(B):
        np.testing.assert_array_equal(got[q].numpy(), np.asarray(
            jax_fs.weight_factor(N, jnp.float32(w[q]))))
