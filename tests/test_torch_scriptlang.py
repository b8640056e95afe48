"""GroovyLite through the port against the JAX package's copy, on the CPU:
the sources and bindings of ``tests/test_scriptlang.py`` (read from its own
parametrize lists), run through both interpreters. Outputs must be equal,
and a script that raises must raise the same error class with the same
message in both — the op budget included."""

import pytest

import test_scriptlang
from elasticsearch_tpu.search import scriptlang as jax_scriptlang
from elasticsearch_tpu_torch.search import scriptlang


LANGUAGE = [src for src, _ in test_scriptlang.test_language.pytestmark[0]
            .args[1]]
SANDBOX = test_scriptlang.test_sandbox_rejects.pytestmark[0].args[1]
#: (source, bindings): the rest of test_scriptlang's direct runs, and
#: scripts over a doc-values-like binding and params
MORE = [
    ("while (true) { }", {}),
    ("[1,2].each { }", {}),
    ("[1,2].each(1)", {}),
    ("def t = 0; for (x in params.xs) { t += x * params.k }; t",
     {"params": {"xs": [1, 2.5, -3], "k": 2}}),
    ("def m = [:]; for (x in params.xs) { m[x] = x * x }; m",
     {"params": {"xs": [1, 2, 3]}}),
    ("params.s.toUpperCase() + params.s.length()",
     {"params": {"s": "abc"}}),
    ("1 / 0", {}),
    ("def x = undefinedName; x", {}),
]


def _outcome(module, src, bindings):
    try:
        return ("ok", module.compile_groovylite(src).run(dict(bindings)))
    except Exception as e:                     # noqa: BLE001 — compared
        return ("error", type(e).__name__, str(e))


@pytest.mark.parametrize("src,bindings",
                         [(s, {}) for s in LANGUAGE]
                         + [(s, {"x": {}}) for s in SANDBOX] + MORE)
def test_groovylite_matches_jax(src, bindings):
    got = _outcome(scriptlang, src, bindings)
    want = _outcome(jax_scriptlang, src, bindings)
    assert got == want


def test_op_budget_is_the_same():
    assert scriptlang.ScriptException.__name__ == "ScriptException"
    with pytest.raises(scriptlang.ScriptException, match="budget"):
        scriptlang.compile_groovylite("while (true) { }").run({})
    for name in dir(jax_scriptlang):
        if name.isupper() and isinstance(getattr(jax_scriptlang, name), int):
            assert getattr(scriptlang, name) == getattr(jax_scriptlang, name)
