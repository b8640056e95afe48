"""Script engine registry — the ScriptService engines map
(core/script/ScriptService.java:227: one ScriptEngineService per lang,
plugins register more through the normal SPI).

An engine is ``compile(source) -> compiled`` where ``compiled.run
(bindings) -> value``; bindings carry ``doc`` (per-hit doc values view),
``params``, and context-specific extras (``_score``, ``ctx`` for
updates, agg ``state``). The registry holds only the per-hit
interpreters — groovy/groovylite built-in, plus whatever plugins add
(plugin_pack/lang_python registers "python"); the vectorized expression
engine and mustache templates have their own batch/render calling
conventions and are dispatched by their callers directly.

A copy of ``elasticsearch_tpu/search/script_engines.py`` with its imports
rewritten. The plugin engines (``plugin_pack``) are not ported: a ``lang``
none registered raises as the reference does.
"""

from __future__ import annotations

ENGINES: dict = {}


def register_engine(lang: str, compile_fn) -> None:
    ENGINES[lang] = compile_fn


def resolve_engine(lang: str | None):
    """Explicit lang → its engine, RAISING when not installed (a silent
    GroovyLite fallback would interpret the script under the wrong
    language's semantics); None → the GroovyLite default."""
    from elasticsearch_tpu_torch.common.errors import QueryParsingError
    from elasticsearch_tpu_torch.search.scriptlang import compile_groovylite
    if lang is None:
        return compile_groovylite
    fn = ENGINES.get(str(lang))
    if fn is None:
        raise QueryParsingError(
            f"script lang [{lang}] is not installed")
    return fn


def _register_builtins() -> None:
    from elasticsearch_tpu_torch.search.scriptlang import compile_groovylite
    ENGINES.setdefault("groovy", compile_groovylite)
    ENGINES.setdefault("groovylite", compile_groovylite)


_register_builtins()
