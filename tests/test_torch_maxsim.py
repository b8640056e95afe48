"""The port's MaxSim bodies against the JAX package's, on the CPU: the
batched f32 and int8 bodies (K5's plain versions on a CPU tensor) and the
single-query bodies, with docs without tokens, query-token holes and token
counts that are not a multiple of the reference's 16-token scan block.

Tolerance: 1e-5 absolute — a score is a sum of up to 8 token maxima, each a
cosine of unit vectors that the two packages sum in other orders (a few f32
ulps), and the reference sums the maxima in XLA's order where the port sums
them in ascending token order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.segment import (
    quantize_vectors as jax_quantize_vectors)
from elasticsearch_tpu.ops import maxsim as jax_maxsim
from elasticsearch_tpu_torch.index.segment import quantize_vectors
from elasticsearch_tpu_torch.ops import maxsim

ATOL = 1e-5


def _unit(rng, shape):
    v = rng.standard_normal(shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _inputs(seed, b, n, t, qt, d):
    """Tokens zeroed past each doc's count (some counts 0), and queries with
    a padded last token and a hole in front."""
    rng = np.random.default_rng(seed)
    toks = _unit(rng, (n, t, d))
    lens = rng.integers(0, t + 1, size=n).astype(np.int32)
    lens[:4] = 0
    lens[4] = t
    toks[np.arange(t)[None, :] >= lens[:, None]] = 0.0
    qs = _unit(rng, (b, qt, d))
    qmask = np.ones((b, qt), bool)
    qmask[0, -1] = False
    qs[0, -1] = 0.0
    if b > 1:
        qmask[1, 0] = False
    return toks, lens, qs, qmask


SHAPES = [(3, 200, 8, 4, 16), (2, 150, 20, 5, 12), (4, 64, 1, 1, 8),
          (1, 90, 33, 8, 24)]


@pytest.mark.parametrize("b,n,t,qt,d", SHAPES)
def test_maxsim_f32_matches_jax(b, n, t, qt, d):
    toks, lens, qs, qmask = _inputs(b + n, b, n, t, qt, d)
    got = maxsim.maxsim_scores_batch_body(*map(torch.from_numpy,
                                               (toks, lens, qs, qmask)))
    want = jax_maxsim.maxsim_scores_batch_body(*map(jnp.asarray,
                                                    (toks, lens, qs, qmask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert bool((got[:, :4] == 0).all())
    one = maxsim.maxsim_scores_body(torch.from_numpy(toks),
                                    torch.from_numpy(lens),
                                    torch.from_numpy(qs[0]),
                                    torch.from_numpy(qmask[0]))
    want_one = jax_maxsim.maxsim_scores_body(
        jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(qs[0]),
        jnp.asarray(qmask[0]))
    np.testing.assert_allclose(one.numpy(), np.asarray(want_one), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("b,n,t,qt,d", SHAPES)
def test_maxsim_int8_matches_jax(b, n, t, qt, d):
    """Quantized over the whole padded [N, T, D] array (padding tokens
    included), as the lane quantizes it."""
    toks, lens, qs, qmask = _inputs(b + n + 1, b, n, t, qt, d)
    qcol = quantize_vectors(toks, d)
    jcol = jax_quantize_vectors(toks, d)
    np.testing.assert_array_equal(qcol.qvecs, jcol.qvecs)
    got = maxsim.maxsim_scores_int8_batch_body(
        torch.from_numpy(qcol.qvecs), qcol.scale, qcol.offset,
        torch.from_numpy(lens), torch.from_numpy(qs),
        torch.from_numpy(qmask))
    want = jax_maxsim.maxsim_scores_int8_batch_body(
        jnp.asarray(jcol.qvecs), jnp.float32(jcol.scale),
        jnp.float32(jcol.offset), jnp.asarray(lens), jnp.asarray(qs),
        jnp.asarray(qmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert bool((got[:, :4] == 0).all())
    one = maxsim.maxsim_scores_int8_body(
        torch.from_numpy(qcol.qvecs), qcol.scale, qcol.offset,
        torch.from_numpy(lens), torch.from_numpy(qs[1 % b]),
        torch.from_numpy(qmask[1 % b]))
    want_one = jax_maxsim.maxsim_scores_int8_body(
        jnp.asarray(jcol.qvecs), jnp.float32(jcol.scale),
        jnp.float32(jcol.offset), jnp.asarray(lens), jnp.asarray(qs[1 % b]),
        jnp.asarray(qmask[1 % b]))
    np.testing.assert_allclose(one.numpy(), np.asarray(want_one), rtol=0,
                               atol=ATOL)


def test_plain_chunks_do_not_change_the_result(monkeypatch):
    """The plain versions walk the docs in chunks (so they run at the card's
    shapes); the chunk size changes nothing."""
    toks, lens, qs, qmask = _inputs(5, 3, 100, 8, 4, 16)
    args = tuple(map(torch.from_numpy, (toks, lens, qs, qmask)))
    whole = maxsim.maxsim_scores_batch_body_plain(*args)
    monkeypatch.setattr(maxsim, "PLAIN_CHUNK_DOCS", 7)
    assert torch.equal(maxsim.maxsim_scores_batch_body_plain(*args), whole)
