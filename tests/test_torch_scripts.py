"""The script engine of the port against the JAX package's, on the CPU.

Every script of a list that covers the grammar goes through the JAX walker
(``elasticsearch_tpu.search.scripts``), the port's walker and the port's
lowered program run by K12's plain version, over the same numpy inputs: a
column with NaN, ±inf, -0.0 and missing values, a second column, the query
scores and params. Types must be equal (bool, int32, f32, or a Python value),
and values equal where the script uses only compares, selects and single
arithmetic ops (eager jnp rounds each op alone, as torch does). Scripts
through ``log``/``log10``/``exp``/``sqrt``/``pow`` agree to 1e-6 relative: XLA's
CPU approximations and the C library's differ by an ulp on up to a third of
inputs. The same bad scripts raise the same errors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.errors import (
    IllegalArgumentError as JaxIllegalArgumentError,
    QueryParsingError as JaxQueryParsingError)
from elasticsearch_tpu.search import scripts as jax_scripts
from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, QueryParsingError)
from elasticsearch_tpu_torch.ops import script_ops
from elasticsearch_tpu_torch.search import scripts

TRANSCENDENTAL_RTOL = 1e-6
N = 64

#: (source, exact): exact scripts use no libm function
SCRIPTS = [
    ("doc['r'].value * 2 + 1", True),
    ("doc['r'].value - doc['s'].value / 3", True),
    ("doc['r'].value % 3", True),
    ("-doc['r'].value % -2.5", True),
    ("doc['r'].value ** 2", True),
    ("doc['r'].value ** 3", True),
    ("doc['r'].value ** -2", True),
    ("doc['r'].value ** 0", True),
    ("doc['s'].value ** 0.5", False),
    ("2 ** doc['s'].value", False),
    ("pow(doc['s'].value, 1.5)", False),
    ("pow(2, 3) + doc['r'].value", True),
    ("log(doc['s'].value + 1) * _score", False),
    ("ln(doc['s'].value) + log10(doc['s'].value)", False),
    ("sqrt(doc['s'].value) + exp(-doc['s'].value / 50)", False),
    ("log(2 + doc['r'].value) * params.w", False),
    ("log(2) * doc['r'].value", False),
    ("1/3 * _score", True),
    ("2 * 3 + 1 / 4 - 5 % 3 + 2 ** -1 + _score", True),
    ("abs(doc['r'].value) + floor(doc['s'].value) - ceil(doc['r'].value)",
     True),
    ("abs(-3) + floor(2) + ceil(doc['r'].empty)", True),
    ("min(doc['r'].value, doc['s'].value, 40)", True),
    ("max(doc['r'].value, -doc['r'].value)", True),
    ("min(doc['r'].value, 0.0) + max(-0.0, doc['r'].value)", True),
    ("max(3)", True),
    ("min(1, 2)", True),
    ("min(doc['r'].empty, 2)", True),
    ("max(doc['r'].empty, doc['r'].empty)", True),
    ("sigmoid(doc['s'].value)", False),
    ("sigmoid(doc['s'].value, 2, 3)", True),
    ("saturation(doc['s'].value, 10)", True),
    ("doc['r'].value > 1", True),
    ("1 < doc['r'].value < 30", True),
    ("doc['r'].value == doc['r'].value", True),
    ("doc['r'].value != 0 and doc['s'].value >= 5", True),
    ("doc['r'].value or doc['r'].empty", True),
    ("not doc['r'].value", True),
    ("not 0", True),
    ("1 < 2 < 3", True),
    ("doc['r'].empty", True),
    ("doc['r'].empty + 1", True),
    ("doc['r'].empty + 1.5", True),
    ("doc['r'].empty + doc['r'].empty", True),
    ("doc['r'].empty * doc['r'].empty", True),
    ("(doc['r'].empty + 1) / 2", True),
    ("(doc['r'].empty + 7) % 3", True),
    ("(doc['r'].empty + 1) % 0", True),
    ("(doc['r'].empty - 3) % -2", True),
    ("doc['r'].empty ** 2", True),
    ("(doc['r'].empty + 2) ** (doc['r'].empty + 1)", True),
    ("-(doc['r'].empty + 0)", True),
    ("2147483647 + (doc['r'].empty + 0)", True),
    ("(1 < 2) + doc['r'].empty", True),
    ("doc['r'].value if doc['r'].value > 10 else doc['s'].value", True),
    ("1 if doc['r'].empty else 2.5", True),
    ("doc['r'].empty if doc['r'].value else 3", True),
    ("1 if True else 2", True),
    ("_score if doc['r'].value else 0", True),
    ("doc['r'].value / 0", True),
    ("doc['r'].value % 0", True),
    ("doc['r'].value * 1e40", True),
    ("params.k + params.w * _score", True),
    ("params['k'] * 2 if params.flag else 0", True),
    ("doc['missing'].value + doc['missing'].empty", True),
    ("3", True),
    ("1 / 3", True),
    ("True", True),
    ("params.flag + 1", True),
    ("params.mode == 'a'", True),
]

#: (source, error class name in both packages)
BAD = [
    ("foo(1)", "QueryParsingError"),
    ("round(1.5)", "QueryParsingError"),
    ("params.zz + 1", "IllegalArgumentError"),
    ("x + 1", "QueryParsingError"),
    ("lambda: 1", "QueryParsingError"),
    ("[1]", "QueryParsingError"),
    ("doc[x]", "QueryParsingError"),
    ("doc['r'].foo", "QueryParsingError"),
    ("doc['r'] + 1", "TypeError"),
    ("1 // 2", "QueryParsingError"),
    ("~doc['r'].value", "QueryParsingError"),
    ("1 is 1", "QueryParsingError"),
    ("None", "QueryParsingError"),
    ("1 +", "QueryParsingError"),
    ("-doc['r'].empty", "TypeError"),
    ("doc['r'].empty - doc['r'].empty", "TypeError"),
    ("(doc['r'].empty + 1) ** -1", "TypeError"),
    ("min()", "TypeError"),
    ("log(1, 2)", "TypeError"),
    ("doc['r'].value + 2 ** 40", "OverflowError"),
    ("1 / 0", "ZeroDivisionError"),
    ("cosineSimilarity(params.w)", "QueryParsingError"),
    ("cosineSimilarity(params.w, x)", "QueryParsingError"),
    ("obj.attr(1)", "QueryParsingError"),
]


def _inputs(seed=11):
    rng = np.random.default_rng(seed)
    r = rng.uniform(-40.0, 40.0, N).astype(np.float32)
    r[:6] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 2.0]
    r_exists = rng.random(N) > 0.2
    r_exists[:6] = True
    s = rng.uniform(0.5, 100.0, N).astype(np.float32)
    s_exists = rng.random(N) > 0.1
    score = rng.uniform(0.0, 12.0, N).astype(np.float32)
    return {"r": (r, r_exists), "s": (s, s_exists)}, score


COLUMNS, SCORE = _inputs()
PARAMS = {"w": 1.5, "k": 3.0, "flag": True, "mode": "a"}


def _jax_params():
    return {k: (jnp.asarray(v, jnp.float32)
                if isinstance(v, float) else v) for k, v in PARAMS.items()}


def _jax_eval(source):
    def gn(f):
        if f not in COLUMNS:
            return jnp.zeros(N, jnp.float32), jnp.zeros(N, bool)
        v, e = COLUMNS[f]
        return jnp.asarray(v), jnp.asarray(e)
    ctx = jax_scripts.ScriptContext(gn, None, jnp.asarray(SCORE),
                                    _jax_params())
    return jax_scripts.compile_script(source).evaluate(ctx)


def _torch_column(f):
    if f not in COLUMNS:
        return torch.zeros(N), torch.zeros(N, dtype=torch.bool)
    v, e = COLUMNS[f]
    return torch.from_numpy(v.copy()), torch.from_numpy(e.copy())


def _walker_eval(source):
    params = {k: (torch.tensor(v, dtype=torch.float32)
                  if isinstance(v, float) else v) for k, v in PARAMS.items()}
    ctx = scripts.ScriptContext(_torch_column, None,
                                torch.from_numpy(SCORE.copy()), params)
    return scripts.compile_script(source).evaluate(ctx)


def _program_eval(source, batch=1):
    prog = scripts.compile_script(source).lower("query", PARAMS)
    cols = [_torch_column(f) for f in prog.columns]
    params = torch.tensor([[PARAMS[k] for k in prog.params]] * batch,
                          dtype=torch.float32)
    score = torch.from_numpy(np.tile(SCORE, (batch, 1)))
    return prog, script_ops.script_eval(
        prog.code, cols, score, [], params,
        torch.zeros((0, N), dtype=torch.int32), batch, N)


def _assert_close(got, want, exact, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    if exact:
        np.testing.assert_array_equal(got, want, what)
        ok = np.isfinite(want) & (want == 0)
        np.testing.assert_array_equal(np.signbit(got[ok]),
                                      np.signbit(want[ok]), what)
    else:
        np.testing.assert_allclose(got, want, rtol=TRANSCENDENTAL_RTOL,
                                   atol=0, err_msg=what)


def _kind(v):
    if isinstance(v, torch.Tensor):
        return {torch.bool: "bool", torch.int32: "int32",
                torch.float32: "float32"}[v.dtype]
    if hasattr(v, "dtype") and hasattr(v, "shape"):
        return str(v.dtype)
    return type(v).__name__


@pytest.mark.parametrize("source,exact", SCRIPTS)
def test_walker_and_program_match_the_jax_walker(source, exact):
    want = _jax_eval(source)
    got = _walker_eval(source)
    assert _kind(got) == _kind(want), source
    if isinstance(want, (str, bool, int, float)):
        assert got == want
    else:
        _assert_close(np.broadcast_to(got.numpy(), np.shape(want)), want,
                      exact, f"walker: {source}")
    # the lowered program, as script_score runs it: f32 over [B, N]
    prog, out = _program_eval(source, batch=3)
    assert out.dtype == torch.float32 and out.shape == (3, N)
    want32 = np.broadcast_to(np.asarray(jnp.asarray(want, jnp.float32)), (N,))
    for b in range(3):
        _assert_close(out[b].numpy(), want32, exact, f"program: {source}")


@pytest.mark.parametrize("source,error", BAD)
def test_bad_scripts_raise_alike(source, error):
    classes = {"QueryParsingError": (JaxQueryParsingError,
                                     QueryParsingError),
               "IllegalArgumentError": (JaxIllegalArgumentError,
                                        IllegalArgumentError)}
    jax_cls, port_cls = classes.get(error, (None, None))
    with pytest.raises(Exception) as jexc:
        _jax_eval(source)
    assert type(jexc.value).__name__ == error
    if jax_cls is not None:
        assert isinstance(jexc.value, jax_cls)
    for run in (_walker_eval, lambda s: _program_eval(s)[1]):
        with pytest.raises(Exception) as exc:
            run(source)
        assert type(exc.value).__name__ == error, (source, exc.value)
        if port_cls is not None:
            assert isinstance(exc.value, port_cls)
            assert str(exc.value) == str(jexc.value)


def test_vector_functions_match_the_jax_walker():
    """cosineSimilarity and dotProduct over normalized rows, with missing
    vectors: the dot products and the query's norm sum in another order
    than XLA's, so values agree to 1e-6 absolute (a product of unit vectors
    near 0 has no relative bound) and 1e-6 relative."""
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((N, 16)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    exists = rng.random(N) > 0.2
    qv = rng.standard_normal(16).astype(np.float32)
    for source in ("cosineSimilarity(params.qv, 'v') + 1.0",
                   "dotProduct(params.qv, 'v') * 2 + doc['r'].value"):
        def jgn(f):
            v, e = COLUMNS[f]
            return jnp.asarray(v), jnp.asarray(e)
        want = jax_scripts.compile_script(source).evaluate(
            jax_scripts.ScriptContext(
                jgn, lambda f: (jnp.asarray(vecs), jnp.asarray(exists)),
                jnp.asarray(SCORE), {"qv": jnp.asarray(qv)}))
        got = scripts.compile_script(source).evaluate(scripts.ScriptContext(
            _torch_column, lambda f: (torch.from_numpy(vecs),
                                      torch.from_numpy(exists)),
            torch.from_numpy(SCORE), {"qv": torch.from_numpy(qv)}))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6, err_msg=source)


def test_vector_fields_and_uses_vectors():
    assert not scripts.compile_script("doc['n'].value * 2").uses_vectors()
    assert scripts.compile_script(
        "cosineSimilarity(params.qv, 'v') + 1").vector_fields() == {"v"}
    assert scripts.compile_script(
        "dotProduct(params.qv, 'v')").uses_vectors()
    assert scripts.compile_script(
        "dotProduct(params.qv, params.f)").vector_fields() is None


def test_lowering_is_cached_by_param_kinds():
    cs = scripts.compile_script("doc['r'].value * params.w")
    a = cs.lower("query", {"w": 1.5})
    assert cs.lower("query", {"w": 7.0}) is a
    assert a.params == ["w"] and a.columns == ["r"]
    b = cs.lower("host", {"w": 1.5})
    assert b is not a and b.params == []


def test_program_has_a_static_depth_and_deep_scripts_lower():
    source = "+".join(["(doc['r'].value"] * 40) + ")" * 40
    prog = scripts.compile_script(source.replace("+(", "+(1+")).lower(
        "query", {})
    assert prog.code.depth > 32
    _, out = _program_eval(source.replace("+(", "+(1+"))
    assert out.shape == (1, N)


def test_pipeline_rows_fold_on_the_host():
    """Bare names are per-row host values: Python arithmetic on the host,
    the jnp part (a call) one program over all rows."""
    cs = scripts.compile_script("log(a) * b + a / b")
    rows = [{"a": 2.0, "b": 3}, {"a": 5.5, "b": 7}]
    prog = cs.lower("pipeline", {}, rows[0])
    assert prog.code is not None and len(prog.rowvals) == 3
    words = torch.from_numpy(prog.row_words(rows))
    out = script_ops.script_eval(prog.code, [], None, [], None, words, 1, 2)
    for i, row in enumerate(rows):
        want = jax_scripts._eval(jax_scripts.compile_script(
            "log(a) * b + a / b")._tree.body, jax_scripts.ScriptContext(
                None, None, None, {}, row))
        _assert_close(out[0, i].numpy(), np.asarray(want), False, "rows")
    host = scripts.compile_script("a / b").lower("pipeline", {}, rows[0])
    assert host.code is None and host.host.value == 2.0 / 3
