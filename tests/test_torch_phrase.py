"""The port's exact-phrase scoring against the JAX package's ``ops/phrase``.

Both packages get the same numpy inputs. Phrase frequencies and masks must
be equal; scores agree to 2 ulp (rtol 2.4e-7), since XLA on the CPU may fuse
the reference's element-wise chain where eager PyTorch rounds each
operation. The batched plain version (K3's CPU body) is held against the
reference's ``phrase_score`` under a loop over the batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import phrase as jax_phrase
from elasticsearch_tpu_torch.common.errors import NotPortedError
from elasticsearch_tpu_torch.ops import phrase

RTOL = 2.4e-7   # 2 ulp of f32


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tokens(rng, n=90, length=24, vocab=6):
    """A position matrix over a small vocabulary (so phrases recur and
    overlap), ragged rows, -1 holes inside some rows, empty rows, and one
    row that fills every position."""
    lens = rng.integers(0, length + 1, size=n)
    lens[0], lens[1] = 0, length
    tokens = np.full((n, length), -1, np.int32)
    for i, ln in enumerate(lens):
        tokens[i, :ln] = rng.integers(0, vocab, size=ln)
        if ln > 4 and i % 3 == 0:
            tokens[i, rng.integers(1, ln - 1)] = -1        # a hole
    tokens[2, :6] = [1, 1, 1, 1, 0, 1]                    # overlapping runs
    doc_len = (tokens >= 0).sum(axis=1).astype(np.int32)
    doc_len[5] = 0                                         # hand-packed row
    return tokens, doc_len


def _batch(rng, b, deltas, vocab=6):
    qtids = rng.integers(0, vocab, size=(b, len(deltas))).astype(np.int32)
    qtids[0, :] = 1                                        # a repeated term
    if b > 1:
        qtids[1, -1] = -1                                  # an absent term
    sum_idf = rng.uniform(0.5, 8.0, size=b).astype(np.float32)
    avgdl = rng.uniform(1.0, 30.0, size=b).astype(np.float32)
    return qtids, sum_idf, avgdl


@pytest.mark.parametrize("deltas,k1,b", [
    ((0, 1), 1.2, 0.75),
    ((0,), 1.2, 0.75),
    ((0, 2, 3), 2.0, 0.3),
    ((0, 1, 3, 4, 6), 0.9, 1.0),
    ((0, 30), 1.2, 0.75),              # runs past every row's end
])
def test_phrase_score_batch_plain_matches_jax_loop(deltas, k1, b):
    rng = np.random.default_rng(len(deltas) * 7 + int(10 * b))
    tokens, doc_len = _tokens(rng)
    qtids, sum_idf, avgdl = _batch(rng, 6, deltas)
    fn = jax.jit(lambda tk, dl, qt, s, a: jax_phrase.phrase_score(
        tk, dl, [qt[i] for i in range(len(deltas))], list(deltas), s, k1, b,
        a)) if max(deltas) < tokens.shape[1] else None
    got_s, got_m = phrase.phrase_score_batch(
        _t(tokens), _t(doc_len), _t(qtids), deltas, _t(sum_idf), k1, b,
        _t(avgdl), extent=phrase.token_extent(_t(tokens)))
    assert got_s.shape == got_m.shape == (6, tokens.shape[0])
    for q in range(6):
        freq = phrase.phrase_freq(_t(tokens), _t(qtids[q]), list(deltas))
        if fn is None:
            # the reference's shift cannot express a delta beyond the row:
            # such a phrase matches nothing
            assert not got_m[q].any() and not got_s[q].any()
            assert not freq.any()
            continue
        want_s, want_m = fn(jnp.asarray(tokens), jnp.asarray(doc_len),
                            jnp.asarray(qtids[q]), sum_idf[q], avgdl[q])
        want_f = jax.jit(lambda tk, qt: jax_phrase.phrase_freq(
            tk, [qt[i] for i in range(len(deltas))], list(deltas)))(
            jnp.asarray(tokens), jnp.asarray(qtids[q]))
        np.testing.assert_array_equal(freq.numpy(), np.asarray(want_f))
        np.testing.assert_array_equal(got_m[q].numpy(), np.asarray(want_m))
        np.testing.assert_allclose(got_s[q].numpy(), np.asarray(want_s),
                                   rtol=RTOL, atol=0)
        # the one-query form is the batch's row
        one_s, one_m = phrase.phrase_score(
            _t(tokens), _t(doc_len), _t(qtids[q]), list(deltas),
            _t(sum_idf[q]), k1, b, _t(avgdl[q]))
        assert torch.equal(one_m, got_m[q]) and torch.equal(one_s, got_s[q])


def test_phrase_freq_counts_overlaps_holes_and_absent_terms():
    tokens = np.array([[1, 1, 1, -1, 1, 1],
                       [2, 1, -1, 1, 2, -1],
                       [-1, -1, -1, -1, -1, -1]], np.int32)
    t = _t(tokens)
    # "a a" in "a a a" counts twice; a hole breaks a run
    assert phrase.phrase_freq(t, _t(np.array([1, 1], np.int32)),
                              [0, 1]).tolist() == [3.0, 0.0, 0.0]
    # a gap of one position (a removed stopword) may span a hole
    assert phrase.phrase_freq(t, _t(np.array([1, 1], np.int32)),
                              [0, 2]).tolist() == [2.0, 1.0, 0.0]
    # an absent term (-1) matches nowhere, not even at holes
    assert phrase.phrase_freq(t, _t(np.array([2, -1], np.int32)),
                              [0, 1]).tolist() == [0.0, 0.0, 0.0]


def test_token_extent_keeps_holes_inside_rows():
    tokens = np.array([[3, -1, 4, -1, -1],
                       [-1, -1, -1, -1, -1],
                       [1, 2, 3, 4, 5],
                       [-1, -1, -1, -1, 9]], np.int32)
    assert phrase.token_extent(_t(tokens), rows=3).tolist() == [3, 0, 5, 5]


def test_over_cap_and_sloppy_phrases_are_refused():
    tokens, doc_len = _tokens(np.random.default_rng(0), n=8)
    deltas = list(range(phrase.MAX_TERMS + 1))
    qtids = np.zeros((1, len(deltas)), np.int32)
    with pytest.raises(NotPortedError):
        phrase.phrase_score_batch(_t(tokens), _t(doc_len), _t(qtids), deltas,
                                  torch.ones(1), 1.2, 0.75, torch.ones(1),
                                  extent=phrase.token_extent(_t(tokens)))
    with pytest.raises(NotPortedError):
        phrase.sloppy_phrase_score_batch(
            _t(tokens), _t(doc_len), _t(qtids), deltas, 1,
            torch.ones(qtids.shape), 1.2, 0.75, torch.ones(1),
            extent=phrase.token_extent(_t(tokens)))
    with pytest.raises(NotPortedError):
        phrase.span_near_freq_unordered()
