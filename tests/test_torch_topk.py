"""The port's stable top-k and merge against the JAX package's
``ops/topk.py`` — results must be exactly equal, ties included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import topk as jax_topk
from elasticsearch_tpu_torch.ops import topk


def _tie_heavy(rng, shape, levels=4):
    """Scores rounded to a few values, so most entries tie."""
    return (rng.integers(0, levels, size=shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("n,k,doc_base", [(50, 10, 0), (50, 64, 7),
                                          (200, 200, 1000), (1, 3, 0)])
def test_top_k_matches_jax(n, k, doc_base):
    rng = np.random.default_rng(n * 31 + k)
    scores = _tie_heavy(rng, (n,))
    scores[rng.random(n) < 0.1] = -np.inf
    mask = rng.random(n) < 0.7
    want_s, want_d = jax_topk.top_k(jnp.asarray(scores), jnp.asarray(mask),
                                    k, doc_base)
    got_s, got_d = topk.top_k(torch.from_numpy(scores),
                              torch.from_numpy(mask), k, doc_base)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


def test_top_k_batched_rows_match_per_row_jax():
    rng = np.random.default_rng(11)
    scores = _tie_heavy(rng, (5, 80), levels=3)
    mask = rng.random((5, 80)) < 0.5
    got_s, got_d = topk.top_k(torch.from_numpy(scores),
                              torch.from_numpy(mask), 12)
    for r in range(5):
        want_s, want_d = jax_topk.top_k(jnp.asarray(scores[r]),
                                        jnp.asarray(mask[r]), 12)
        np.testing.assert_array_equal(got_s[r].numpy(), np.asarray(want_s))
        np.testing.assert_array_equal(got_d[r].numpy(), np.asarray(want_d))


@pytest.mark.parametrize("seed,k", [(0, 6), (1, 20), (2, 40)])
def test_merge_matches_jax(seed, k):
    """Per-segment rankings in (score desc, doc asc) order with -inf/-1
    padding, merged with segment bases."""
    rng = np.random.default_rng(seed)
    b, bases = 4, (0, 128, 256)
    scores_list, docs_list = [], []
    for _ in bases:
        s = _tie_heavy(rng, (b, 8))
        d = np.tile(np.arange(8, dtype=np.int32), (b, 1))
        order = np.lexsort((d, -s), axis=1)
        s = np.take_along_axis(s, order, 1)
        d = np.take_along_axis(d, order, 1)
        pad = rng.random((b, 8)) < 0.25
        s[pad] = -np.inf
        d[pad] = -1
        scores_list.append(s)
        docs_list.append(d)
    want_s, want_d = jax_topk.merge_top_k_batch_body(
        [jnp.asarray(s) for s in scores_list],
        [jnp.asarray(d) for d in docs_list], k, bases)
    got_s, got_d = topk.merge_top_k_batch_body(
        [torch.from_numpy(s) for s in scores_list],
        [torch.from_numpy(d) for d in docs_list], k, bases)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


def test_select_top_k_counts_eligible_entries():
    scores = torch.tensor([[1.0, float("-inf"), 2.0, 2.0, float("nan")]])
    ids = torch.tensor([[4, 5, -1, 7, 8]], dtype=torch.int32)
    ts, ti, count = topk.select_top_k(scores, 3, ids=ids)
    assert count.tolist() == [2]
    assert ti.tolist() == [[7, 4, -1]]
    assert ts[0, :2].tolist() == [2.0, 1.0] and ts[0, 2] == float("-inf")


def test_select_top_k_rejects_k_out_of_range():
    """k takes any value from 1 up (a k past the row pads)."""
    for k in (0, -1):
        with pytest.raises(ValueError):
            topk.select_top_k(torch.zeros((1, 4)), k)
    ts, ti, _ = topk.select_top_k(torch.zeros((1, 4)), topk.CHUNK + 1)
    assert ts.shape == ti.shape == (1, topk.CHUNK + 1)


def test_pack_unpack_round_trip_matches_jax():
    rng = np.random.default_rng(5)
    ts = rng.standard_normal((3, 7)).astype(np.float32)
    td = rng.integers(-1, 1 << 20, size=(3, 7)).astype(np.int32)
    counts = rng.integers(0, 1 << 20, size=3).astype(np.int32)
    want = np.asarray(jax_topk.pack_batch_result_body(
        jnp.asarray(ts), jnp.asarray(td), jnp.asarray(counts)))
    got = topk.pack_batch_result_body(torch.from_numpy(ts),
                                      torch.from_numpy(td),
                                      torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(got, want)
    s, d, c = topk.unpack_batch_result(got, 7)
    np.testing.assert_array_equal(s, ts)
    np.testing.assert_array_equal(d, td)
    np.testing.assert_array_equal(c, counts)
    got_counts = topk.count_matches(torch.from_numpy(td >= 0)).numpy()
    for r in range(3):
        assert got_counts[r] == int(jax_topk.count_matches(
            jnp.asarray(td[r] >= 0)))
