"""The port's span algebra (``ops/spans.py``) and flat span_near bodies
(``ops/phrase.py``) against the JAX package, on the CPU.

Every function of the reference's ``ops/spans.py`` gets the same seeded
token matrices or random min-end maps (each span ends after it starts, as
every map the algebra makes does): the results are integers and must be
equal. That includes the port's O(L) ``containing_ends``, ``within_ends``
and ``not_ends`` against the reference's shift loops and prefix sums. Then
K13's plain version (a lowered program run one query at a time) against
the JAX bodies composed as the JAX resolver composes them, and K14's plain
version (``sloppy_phrase_count``, ``span_near_freq_unordered`` and
``freq_score``) against the JAX bodies: counts and masks equal, scores
within 2 ulp (XLA may fuse ``freq_score``'s chain where eager PyTorch
rounds each operation).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import phrase as jax_phrase
from elasticsearch_tpu.ops import spans as jax_spans
from elasticsearch_tpu_torch.ops import phrase, spans

RTOL = 2.4e-7   # 2 ulp of f32
K1, B = 1.2, 0.75
INF = 1 << 30


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tokens(rng, n=60, length=18, vocab=5):
    """Ragged rows over a small vocabulary, -1 holes, an empty row."""
    tokens = np.full((n, length), -1, np.int32)
    for i, ln in enumerate(rng.integers(0, length + 1, size=n)):
        tokens[i, :ln] = rng.integers(0, vocab, size=ln)
        if ln > 3 and i % 4 == 0:
            tokens[i, rng.integers(1, ln - 1)] = -1
    tokens[0] = -1
    return tokens


def _ends(rng, n=50, length=16, p_span=0.3, max_w=5):
    """A random min-end map: a span at a start with probability
    ``p_span``, ending 1 to ``max_w`` positions after it (within the row)."""
    pos = np.arange(length)[None, :]
    width = rng.integers(1, max_w + 1, size=(n, length))
    ends = np.minimum(pos + width, length).astype(np.int32)
    ends[rng.random((n, length)) >= p_span] = INF
    return ends


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_leaf_bodies_match_jax(seed):
    rng = np.random.default_rng(seed)
    tokens = _tokens(rng)
    jt = jnp.asarray(tokens)
    for tid in (0, 3, -1, 9):
        _eq(spans.term_ends(_t(tokens), torch.tensor(tid, dtype=torch.int32)),
            jax_spans.term_ends(jt, jnp.int32(tid)))
    for tids in ([1, 4, -1, -1], [2], [-1, -1], list(range(-1, 6)) + [-1]):
        _eq(spans.term_set_ends(_t(tokens), torch.tensor(tids,
                                                         dtype=torch.int32)),
            jax_spans.term_set_ends(jt, jnp.asarray(tids, jnp.int32)))
    e = _ends(rng, length=10)
    _eq(spans.pad_ends(_t(e), 16), jax_spans.pad_ends(jnp.asarray(e), 16))
    _eq(spans.pad_ends(_t(e), 10), jax_spans.pad_ends(jnp.asarray(e), 10))


@pytest.mark.parametrize("seed", range(4))
def test_combinators_match_jax(seed):
    rng = np.random.default_rng(10 + seed)
    maps = [_ends(rng, p_span=p, max_w=w)
            for p, w in ((0.3, 1), (0.2, 4), (0.5, 2), (0.1, 6))]
    jm = [jnp.asarray(m) for m in maps]
    tm = [_t(m) for m in maps]
    _eq(spans.or_ends(tm[:3]), jax_spans.or_ends(jm[:3]))
    for end in (0, 3, 9, 40):
        _eq(spans.first_ends(tm[1], end), jax_spans.first_ends(jm[1], end))
    _eq(spans._first_start_from(tm[2]), jax_spans._first_start_from(jm[2]))
    for slop in (0, 1, 3):
        for k in (2, 3):
            _eq(spans.near_unordered_ends(tm[:k], slop),
                jax_spans.near_unordered_ends(jm[:k], slop))
            _eq(spans.near_ordered_ends(tm[1:1 + k], slop),
                jax_spans.near_ordered_ends(jm[1:1 + k], slop))
    _eq(spans.coverage(tm[3]), jax_spans.coverage(jm[3]))
    for pre, post in ((0, 0), (1, 0), (0, 2), (3, 1), (20, 20)):
        for inc, exc in ((0, 1), (1, 3), (2, 0)):
            _eq(spans.not_ends(tm[inc], tm[exc], pre, post),
                jax_spans.not_ends(jm[inc], jm[exc], pre, post))
    for big, little in ((1, 0), (3, 2), (1, 3), (0, 0)):
        # the O(L) scans against the reference's loops over every shift
        _eq(spans.containing_ends(tm[big], tm[little]),
            jax_spans.containing_ends(jm[big], jm[little]))
        _eq(spans.within_ends(tm[little], tm[big]),
            jax_spans.within_ends(jm[little], jm[big]))
    for m, j in zip(tm, jm):
        _eq(spans.span_freq(m), jax_spans.span_freq(j))


def test_program_width_bookkeeping():
    code = ((spans.OP_TERM, 0, 0, 0), (spans.OP_TERM_SET, 1, 0, 0),
            (spans.OP_NEAR, 2, 1, 0), (spans.OP_TERM, 0, 1, 0),
            (spans.OP_NOT, 0, 0, 0), (spans.OP_FIRST, 4, 0, 0))
    assert spans.program_depth(code) == 2
    assert spans.op_widths(code, [7, 12]) == [7, 12, 12, 7, 12, 12]
    with pytest.raises(ValueError):
        spans.program_depth(code[:2])


def _jterm(m, tid):
    return jax_spans.term_ends(m, jnp.int32(tid))


def _jpad(maps):
    width = max(m.shape[1] for m in maps)
    return [jax_spans.pad_ends(m, width) for m in maps]


#: (program over fields a (L 14) and b (L 20), the same tree composed from
#: the JAX bodies as the JAX resolver composes it: (a, b, tids, set) → map)
PROGRAMS = {
    "near_or_not_first": (
        ((spans.OP_TERM, 0, 0, 0), (spans.OP_TERM_SET, 1, 0, 0),
         (spans.OP_NEAR, 2, 2, 0), (spans.OP_TERM, 0, 1, 0),
         (spans.OP_OR, 2, 0, 0), (spans.OP_TERM, 0, 2, 0),
         (spans.OP_NOT, 1, 0, 0), (spans.OP_FIRST, 12, 0, 0)),
        lambda a, b, t, s: jax_spans.first_ends(jax_spans.not_ends(
            *_jpad([jax_spans.or_ends(_jpad([
                jax_spans.near_unordered_ends(_jpad([
                    _jterm(a, t[0]), jax_spans.term_set_ends(b, s)]), 2),
                _jterm(a, t[1])])), _jterm(a, t[2])]), 1, 0), 12)),
    "containing": (
        ((spans.OP_TERM, 0, 0, 0), (spans.OP_TERM, 0, 1, 0),
         (spans.OP_NEAR, 2, 3, 1), (spans.OP_TERM, 1, 2, 0),
         (spans.OP_CONTAINING, 0, 0, 0)),
        lambda a, b, t, s: jax_spans.containing_ends(*_jpad([
            jax_spans.near_ordered_ends([_jterm(a, t[0]), _jterm(a, t[1])],
                                        3), _jterm(b, t[2])]))),
    "within": (
        ((spans.OP_TERM_SET, 0, 0, 0), (spans.OP_TERM, 0, 1, 0),
         (spans.OP_NEAR, 2, 4, 0), (spans.OP_TERM, 0, 2, 0),
         (spans.OP_WITHIN, 0, 0, 0)),
        lambda a, b, t, s: jax_spans.within_ends(
            _jterm(a, t[2]), jax_spans.near_unordered_ends(
                [jax_spans.term_set_ends(a, s), _jterm(a, t[1])], 4))),
    "nested_near": (
        ((spans.OP_TERM, 0, 0, 0), (spans.OP_TERM, 0, 1, 0),
         (spans.OP_NEAR, 2, 1, 0), (spans.OP_TERM, 1, 2, 0),
         (spans.OP_TERM_SET, 1, 0, 0), (spans.OP_OR, 2, 0, 0),
         (spans.OP_NEAR, 2, 2, 1)),
        lambda a, b, t, s: jax_spans.near_ordered_ends(_jpad([
            jax_spans.near_unordered_ends([_jterm(a, t[0]), _jterm(a, t[1])],
                                          1),
            jax_spans.or_ends([_jterm(b, t[2]),
                               jax_spans.term_set_ends(b, s)])]), 2)),
}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program_plain_matches_jax(name):
    """K13's plain version on lowered programs over two token matrices of
    different widths, against the JAX bodies composed as the JAX resolver
    composes them; scores through freq_score."""
    rng = np.random.default_rng(21)
    a = _tokens(rng, n=80, length=14, vocab=4)
    b = _tokens(rng, n=80, length=20, vocab=4)
    code, jax_tree = PROGRAMS[name]
    prog = spans.SpanProgram(code=code, fields=("a", "b"), n_terms=3,
                             n_sets=1, depth=spans.program_depth(code))
    tids = np.array([[1, 2, 0], [3, 3, 1], [0, -1, 2], [2, 0, 3]], np.int32)
    sets = np.array([[2, 3, -1, -1], [0, -1, -1, -1], [1, 2, 3, -1],
                     [-1, -1, -1, -1]], np.int32)
    doc_len = (a >= 0).sum(axis=1).astype(np.int32)
    sum_idf = np.array([1.5, 0.7, 2.25, 1.0], np.float32)
    avgdl = np.full(4, doc_len.mean(), np.float32)
    scores, mask = spans.span_program_score_batch(
        prog, [_t(a), _t(b)], [None, None], _t(doc_len), _t(tids),
        [_t(sets)], _t(sum_idf), K1, B, _t(avgdl))
    assert mask.any()
    for q in range(4):
        freq = jax_spans.span_freq(jax_tree(jnp.asarray(a), jnp.asarray(b),
                                            tids[q], jnp.asarray(sets[q])))
        ws, wm = jax_phrase.freq_score(freq, jnp.asarray(doc_len),
                                       sum_idf[q], K1, B, avgdl[q])
        np.testing.assert_array_equal(mask[q].numpy(), np.asarray(wm))
        np.testing.assert_allclose(scores[q].numpy(), np.asarray(ws),
                                   rtol=RTOL)


@pytest.mark.parametrize("slop", [0, 1, 3])
def test_span_near_bodies_match_jax(slop):
    rng = np.random.default_rng(30 + slop)
    tokens = _tokens(rng)
    jt = jnp.asarray(tokens)
    doc_len = (tokens >= 0).sum(axis=1).astype(np.int32)
    cases = ([1, 2], [3, 1, 4], [2, 2], [0, -1, 3], [4, 0, 1, 2])
    for qt in cases:
        jq = [jnp.int32(t) for t in qt]
        q = torch.tensor(qt, dtype=torch.int32)
        _eq(phrase.sloppy_phrase_count(_t(tokens), q, list(range(len(qt))),
                                       slop),
            jax_phrase.sloppy_phrase_count(jt, jq, list(range(len(qt))),
                                           slop))
        _eq(phrase.span_near_freq_unordered(_t(tokens), q, slop),
            jax_phrase.span_near_freq_unordered(jt, jq, slop))
    for in_order in (True, False):
        qtids = np.array([c + [0] * (3 - len(c)) for c in cases[:3]],
                         np.int32)
        sum_idf = np.array([1.0, 2.5, 0.3], np.float32)
        avgdl = np.full(3, doc_len.mean(), np.float32)
        scores, mask = phrase.span_near_score_batch(
            _t(tokens), _t(doc_len), _t(qtids), slop, in_order,
            _t(sum_idf), K1, B, _t(avgdl),
            extent=phrase.token_extent(_t(tokens)))
        for i in range(3):
            jq = [jnp.int32(t) for t in qtids[i]]
            freq = jax_phrase.sloppy_phrase_count(jt, jq, [0, 1, 2], slop) \
                if in_order else \
                jax_phrase.span_near_freq_unordered(jt, jq, slop)
            ws, wm = jax_phrase.freq_score(freq, jnp.asarray(doc_len),
                                           sum_idf[i], K1, B, avgdl[i])
            np.testing.assert_array_equal(mask[i].numpy(), np.asarray(wm))
            np.testing.assert_allclose(scores[i].numpy(), np.asarray(ws),
                                       rtol=RTOL)
