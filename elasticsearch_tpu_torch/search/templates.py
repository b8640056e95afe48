"""Search templates — parameterized request bodies.

A copy of ``elasticsearch_tpu/search/templates.py`` with its imports
rewritten.

Reference: core/script/Template.java:54 + mustache rendering
(core/script/mustache/MustacheScriptEngineService.java), used by
`parseTemplate` (core/search/SearchService.java:576) and the
/_search/template REST API. Stored scripts/templates live in cluster
state here (the reference stores them in a hidden .scripts index —
metadata storage gives the same durability with the machinery we already
replicate; see search/percolator.py for the same reasoning).

The template language is the mustache subset search templates actually
use: `{{var}}` substitution (dotted paths), `{{#var}}...{{/var}}`
conditional sections, and `{{^var}}...{{/var}}` inverted sections
(defaults). JSON-aware: a `{{var}}` standing alone inside quotes renders
as the JSON value; `{{#toJson}}var{{/toJson}}` embeds structures.
"""

from __future__ import annotations

import json
import re

from elasticsearch_tpu_torch.common.errors import IllegalArgumentError


def _lookup(params: dict, path: str):
    node = params
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


_SECTION = re.compile(r"\{\{([#^])([\w.]+)\}\}(.*?)\{\{/\2\}\}", re.S)
_TOJSON = re.compile(r"\{\{#toJson\}\}([\w.]+)\{\{/toJson\}\}")
_QUOTED_VAR = re.compile(r'"\{\{([\w.]+)\}\}"')
_VAR = re.compile(r"\{\{([\w.]+)\}\}")


def render_template(source: str, params: dict) -> str:
    """Mustache-subset render of a template string with `params`."""
    params = params or {}

    def do_section(m: re.Match) -> str:
        kind, name, body = m.group(1), m.group(2), m.group(3)
        val = _lookup(params, name)
        truthy = bool(val) and val not in (0, "")
        if kind == "#":
            return render_template(body, params) if truthy else ""
        return render_template(body, params) if not truthy else ""

    out = _SECTION.sub(do_section, source)
    out = _TOJSON.sub(lambda m: json.dumps(_lookup(params, m.group(1))), out)

    def quoted(m: re.Match) -> str:
        val = _lookup(params, m.group(1))
        if val is None:
            return "null"
        return json.dumps(val)

    out = _QUOTED_VAR.sub(quoted, out)
    out = _VAR.sub(lambda m: str(_lookup(params, m.group(1)) or ""), out)
    return out


def render_search_template(spec: dict, stored_lookup) -> dict:
    """{"inline"/"source"/"id"/"file", "params"} → rendered search body.
    `stored_lookup(id)` resolves stored templates (cluster state)."""
    params = spec.get("params", {})
    source = spec.get("inline", spec.get("source", spec.get("template")))
    if isinstance(source, dict) and "id" in source and \
            not any(k in source for k in ("query", "inline", "source")):
        # {"template": {"id": ...}} names a stored template, it is not an
        # inline body (RestSearchTemplateAction id form)
        spec = {**spec, "id": source["id"]}
        source = None
    if source is None and "id" in spec:
        source = stored_lookup(spec["id"])
        if source is None:
            raise IllegalArgumentError(
                f"stored template [{spec['id']}] not found")
    if source is None:
        raise IllegalArgumentError(
            "search template needs inline/source or id")
    if isinstance(source, dict):
        source = json.dumps(source)
    rendered = render_template(source, params)
    try:
        return json.loads(rendered)
    except json.JSONDecodeError as e:
        raise IllegalArgumentError(
            f"template rendered to invalid JSON: {e}") from None
