"""Script engine: a safe expression language over doc values, lowered to a
postfix program that kernel K12 runs.

Counterpart of ``elasticsearch_tpu/search/scripts.py`` (the reference's
ScriptService + lang-expression plugin, core/script/ScriptService.java:227;
the engine BASELINE.json's configs 3 and 4 name for script_score). The
grammar is the same: Python expression syntax restricted to arithmetic and
comparison, the math functions and the ES bindings:

    doc['field'].value        → the field's doc-values column (0 if missing)
    doc['field'].empty        → the field's missing mask
    _score                    → the query score
    params.x / params['x']    → request-supplied constants
    cosineSimilarity(params.qv, 'field')   → vector similarity (+ dotProduct)
    log/ln/log10/sqrt/abs/exp/floor/ceil/min/max/pow/sigmoid/saturation

One walk of the tree (:func:`_walk`) gives a value its jnp semantics: a
``BinOp``, ``USub`` or compare of two Python values is computed in Python
(f64 or int, as the reference's walker does), and a value that meets an
array, or goes through a ``_FUNCS`` call, ``not``, ``and``/``or``, a chained
compare or a conditional, is an array whose dtype (bool, int32 or f32) the
promotion of its operands decides. Two backends share that walk:

* :class:`_TensorBackend` evaluates on torch tensors — the walker,
  :meth:`CompiledScript.evaluate`, the counterpart of the reference's
  ``_eval``, which the tests hold the lowered program against;
* :class:`_LowerBackend` emits code — :meth:`CompiledScript.lower` flattens
  the tree to a :class:`ScriptProgram`: the postfix ops with a static type on
  every value (``ops/script_ops.py``), the column, product and param slots it
  reads, and the Python parts computed on the host: folded into constants,
  or, where they read a bucket pipeline's per-row names, recomputed for each
  row into a per-row input.

Calls are never folded: ``log(2)`` is a jnp array in the reference, computed
on the device there and here.
"""

from __future__ import annotations

import ast as _pyast
import operator
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, QueryParsingError)
from elasticsearch_tpu_torch.ops import script_ops as so

_ALLOWED_BINOPS = {
    _pyast.Add: "add", _pyast.Sub: "sub", _pyast.Mult: "mul",
    _pyast.Div: "div", _pyast.Mod: "mod", _pyast.Pow: "pow",
}
_PY_BINOPS = {"add": operator.add, "sub": operator.sub,
              "mul": operator.mul, "div": operator.truediv,
              "mod": operator.mod, "pow": operator.pow}
_ALLOWED_CMPOPS = {
    _pyast.Gt: "gt", _pyast.GtE: "ge", _pyast.Lt: "lt", _pyast.LtE: "le",
    _pyast.Eq: "eq", _pyast.NotEq: "ne",
}
_PY_CMPOPS = {"gt": operator.gt, "ge": operator.ge, "lt": operator.lt,
              "le": operator.le, "eq": operator.eq, "ne": operator.ne}

#: the reference's _FUNCS, by name: the unary math functions → their f32 op
_UNARY_F32 = {"log": so.F_LOG, "ln": so.F_LOG, "log10": so.F_LOG10,
              "sqrt": so.F_SQRT, "exp": so.F_EXP}
_FUNCS = set(_UNARY_F32) | {"abs", "floor", "ceil", "min", "max", "pow",
                            "sigmoid", "saturation"}

_F_BIN = {"add": so.F_ADD, "sub": so.F_SUB, "mul": so.F_MUL,
          "div": so.F_DIV, "mod": so.F_MOD}
_I_BIN = {"add": so.I_ADD, "sub": so.I_SUB, "mul": so.I_MUL,
          "mod": so.I_MOD}
_B_BIN = {"add": so.B_OR, "mul": so.B_AND}
_F_CMP = {"lt": so.F_LT, "le": so.F_LE, "gt": so.F_GT, "ge": so.F_GE,
          "eq": so.F_EQ, "ne": so.F_NE}
_I_CMP = {"lt": so.I_LT, "le": so.I_LE, "gt": so.I_GT, "ge": so.I_GE,
          "eq": so.I_EQ, "ne": so.I_NE}
_KINDS = ("bool", "i32", "f32")
_CATEGORY = {"pybool": 0, "bool": 0, "pyint": 1, "i32": 1, "pyfloat": 2,
             "f32": 2}
_CONVERT = {("bool", "i32"): so.B2I, ("bool", "f32"): so.B2F,
            ("i32", "f32"): so.I2F}
_LOAD_CONST = {"f32": so.LD_CONST_F, "i32": so.LD_CONST_I,
               "bool": so.LD_CONST_B}
_LOAD_ROW = {"f32": so.LD_ROW_F, "i32": so.LD_ROW_I, "bool": so.LD_ROW_B}
_I32_MAX = 2 ** 31


class ScriptContext:
    """Per-segment evaluation context handed to :meth:`CompiledScript.
    evaluate` (the walker): ``get_numeric_column(field) → ([N] f32, [N]
    bool)``, ``get_vector_column(field) → ([N, D] f32, [N] bool)``, the query
    scores ``[N]`` f32, the params, and bare-name ``variables`` (a bucket
    pipeline's buckets_path values), resolved before ``_score``. Constants
    go to ``device`` (the scores' device when None, else the CPU)."""

    def __init__(self, get_numeric_column, get_vector_column, scores,
                 params: dict, variables: dict | None = None, device=None):
        self.get_numeric_column = get_numeric_column
        self.get_vector_column = get_vector_column
        self.scores = scores
        self.params = params
        self.variables = variables or {}
        if device is None:
            device = scores.device if isinstance(scores, torch.Tensor) \
                else torch.device("cpu")
        self.device = torch.device(device)


class _DocField:
    def __init__(self, field: str):
        self.field = field


def _py_kind(v) -> str:
    if isinstance(v, (bool, np.bool_)):
        return "pybool"
    if isinstance(v, (int, np.integer)):
        return "pyint"
    if isinstance(v, (float, np.floating)):
        return "pyfloat"
    return "other"


def _promote(ka: str, kb: str) -> str:
    """jnp's promotion of two operands (a Python value weak) → the array
    dtype they meet in: the higher of bool < int32 < f32."""
    try:
        return _KINDS[max(_CATEGORY[ka], _CATEGORY[kb])]
    except KeyError:
        raise TypeError(f"script operand types [{ka}] and [{kb}] do not "
                        f"combine") from None


def _host_word(v, kind: str):
    """A Python value converted as jnp converts it into a ``kind`` array:
    → a numpy scalar (bool as int32 0/1). A Python int outside int32 raises
    OverflowError as jnp does."""
    pk = _py_kind(v)
    if pk == "other":
        raise TypeError(f"script value of type [{type(v).__name__}] cannot "
                        f"be used as a number")
    if pk == "pyint" and not -_I32_MAX <= int(v) < _I32_MAX:
        raise OverflowError(f"script integer [{v}] is outside int32")
    if kind == "f32":
        with np.errstate(over="ignore"):
            return np.float32(v)
    if kind == "i32":
        return np.int32(int(v))
    return np.int32(bool(v))


def host_array(v) -> np.generic:
    """A Python result as ``jnp.asarray`` makes it (its own kind: bool,
    int32 or f32), for a caller that reads it back as a number."""
    kind = _py_kind(v)
    if kind == "other":
        raise TypeError(f"script value of type [{type(v).__name__}] cannot "
                        f"be used as a number")
    word = _host_word(v, {"pybool": "bool", "pyint": "i32",
                          "pyfloat": "f32"}[kind])
    return np.bool_(word) if kind == "pybool" else word


# ---------------------------------------------------------------- semantics
# Each helper takes a backend `be` and values it made; a value is either a
# host value (be.is_host) or an array of kind be.kind(v) in _KINDS.

def _kind(be, v) -> str:
    return _py_kind(be.py(v)) if be.is_host(v) else be.kind(v)


def _to(be, v, kind: str):
    """v as an array of ``kind`` (upward conversion only)."""
    if be.is_host(v):
        return be.const(v, kind)
    k = be.kind(v)
    if k == kind:
        return v
    return be.op(_CONVERT[(k, kind)], 0, [v], kind)


def _as_array(be, v):
    """A host value as the array jnp makes of it (its own kind)."""
    if not be.is_host(v):
        return v
    k = _py_kind(be.py(v))
    if k == "other":
        raise TypeError(f"script value of type [{type(be.py(v)).__name__}] "
                        f"cannot be used as a number")
    return be.const(v, {"pybool": "bool", "pyint": "i32",
                        "pyfloat": "f32"}[k])


def _to_bool(be, v):
    """jnp's truth of an array: ``!= 0`` (NaN is true)."""
    v = _as_array(be, v)
    k = be.kind(v)
    if k == "bool":
        return v
    return be.op(so.I2B if k == "i32" else so.F2B, 0, [v], "bool")


def _binop(be, name: str, a, b):
    if be.is_host(a) and be.is_host(b):
        return be.host_op(_PY_BINOPS[name], a, b)
    if name == "pow":
        return _power(be, a, b)
    kind = _promote(_kind(be, a), _kind(be, b))
    if name == "div":
        kind = "f32"
    elif name == "mod" and kind == "bool":
        kind = "i32"
    elif name == "sub" and kind == "bool":
        raise TypeError("sub does not accept dtype bool")
    table = {"f32": _F_BIN, "i32": _I_BIN, "bool": _B_BIN}[kind]
    return be.op(table[name], 0, [_to(be, a, kind), _to(be, b, kind)], kind)


def _power(be, a, b):
    """jnp.power: a Python-int exponent is lax.integer_pow on the base
    promoted to a number; otherwise int ** int is jnp's six-round binary
    exponentiation and anything else f32 powf."""
    if be.is_host(b) and _py_kind(be.py(b)) in ("pyint", "pybool"):
        n = int(be.py(b))
        kind = "f32" if _kind(be, a) in ("pyfloat", "f32") else "i32"
        if kind == "i32" and n < 0:
            raise TypeError(f"Integers cannot be raised to negative powers, "
                            f"got integer_pow(int32, {n})")
        return be.op(so.F_IPOW if kind == "f32" else so.I_IPOW, n,
                     [_to(be, a, kind)], kind)
    kind = "i32" if _promote(_kind(be, a), _kind(be, b)) != "f32" else "f32"
    return be.op(so.F_POW if kind == "f32" else so.I_POW, 0,
                 [_to(be, a, kind), _to(be, b, kind)], kind)


def _compare(be, name: str, a, b):
    if be.is_host(a) and be.is_host(b):
        return be.host_op(_PY_CMPOPS[name], a, b)
    kind = _promote(_kind(be, a), _kind(be, b))
    kind = "i32" if kind == "bool" else kind
    table = _F_CMP if kind == "f32" else _I_CMP
    return be.op(table[name], 0, [_to(be, a, kind), _to(be, b, kind)],
                 "bool")


def _neg(be, a):
    if be.is_host(a):
        return be.host_op(operator.neg, a)
    kind = be.kind(a)
    if kind == "bool":
        raise TypeError("neg does not accept dtype bool")
    return be.op(so.F_NEG if kind == "f32" else so.I_NEG, 0, [a], kind)


def _logic(be, opcode: int, a, b):
    return be.op(opcode, 0, [_to_bool(be, a), _to_bool(be, b)], "bool")


def _where(be, cond, a, b):
    kind = _promote(_kind(be, a), _kind(be, b))
    return be.op(so.SELECT, 0, [_to_bool(be, cond), _to(be, a, kind),
                                _to(be, b, kind)], kind)


def _minmax(be, is_min: bool, a, b):
    kind = _promote(_kind(be, a), _kind(be, b))
    opcode = {"bool": (so.B_OR, so.B_AND), "i32": (so.I_MAX, so.I_MIN),
              "f32": (so.F_MAX, so.F_MIN)}[kind][is_min]
    return be.op(opcode, 0, [_to(be, a, kind), _to(be, b, kind)], kind)


def _call(be, fname: str, args: list):
    if fname in _UNARY_F32 or fname in ("abs", "floor", "ceil"):
        if len(args) != 1:
            raise TypeError(f"{fname}() takes 1 positional argument but "
                            f"{len(args)} were given")
        x = _as_array(be, args[0])
        if fname in _UNARY_F32:
            return be.op(_UNARY_F32[fname], 0, [_to(be, x, "f32")], "f32")
        kind = be.kind(x)
        if kind == "bool" or (kind == "i32" and fname != "abs"):
            return x
        opcode = {"abs": (so.I_ABS, so.F_ABS), "floor": (None, so.F_FLOOR),
                  "ceil": (None, so.F_CEIL)}[fname][kind == "f32"]
        return be.op(opcode, 0, [x], kind)
    if fname in ("min", "max"):
        if not args:
            raise TypeError("reduce() of empty iterable with no initial "
                            "value")
        out = args[0]
        for v in args[1:]:
            out = _minmax(be, fname == "min", out, v)
        return out
    if fname == "pow":
        if len(args) != 2:
            raise TypeError(f"pow() takes 2 positional arguments but "
                            f"{len(args)} were given")
        return _power(be, _as_array(be, args[0]), args[1])
    if fname == "sigmoid":
        if not 1 <= len(args) <= 3:
            raise TypeError(f"sigmoid() takes from 1 to 3 positional "
                            f"arguments but {len(args)} were given")
        x, k, a = (list(args) + [be.host(1.0), be.host(1.0)])[:3]
        xa = _binop(be, "pow", x, a)
        return _binop(be, "div", xa, _binop(
            be, "add", _binop(be, "pow", x, a), _binop(be, "pow", k, a)))
    if fname == "saturation":
        if len(args) != 2:
            raise TypeError(f"saturation() takes 2 positional arguments but "
                            f"{len(args)} were given")
        x, k = args
        return _binop(be, "div", x, _binop(be, "add", x, k))
    raise QueryParsingError(f"unknown script function [{fname}]")


def _walk(node: _pyast.AST, be) -> Any:  # noqa: C901
    """The reference's ``_eval``, over a backend."""
    if isinstance(node, _pyast.Constant):
        if isinstance(node.value, (int, float, str)):
            return be.host(node.value)
        raise QueryParsingError(f"script constant not allowed: {node.value!r}")
    if isinstance(node, _pyast.Name):
        if node.id in be.variables:
            return be.variable(node.id)
        if node.id == "_score":
            return be.score()
        raise QueryParsingError(f"unknown script variable [{node.id}]")
    if isinstance(node, _pyast.BinOp):
        name = _ALLOWED_BINOPS.get(type(node.op))
        if name is None:
            raise QueryParsingError("operator not allowed in script")
        return _binop(be, name, _walk(node.left, be), _walk(node.right, be))
    if isinstance(node, _pyast.UnaryOp):
        if isinstance(node.op, _pyast.USub):
            return _neg(be, _walk(node.operand, be))
        if isinstance(node.op, _pyast.Not):
            return be.op(so.B_NOT, 0, [_to_bool(be, _walk(node.operand,
                                                          be))], "bool")
        raise QueryParsingError("unary operator not allowed in script")
    if isinstance(node, _pyast.Compare):
        left = _walk(node.left, be)
        result = None
        for cmp_op, comp in zip(node.ops, node.comparators):
            name = _ALLOWED_CMPOPS.get(type(cmp_op))
            if name is None:
                raise QueryParsingError("comparison not allowed in script")
            right = _walk(comp, be)
            piece = _compare(be, name, left, right)
            result = piece if result is None else \
                _logic(be, so.B_AND, result, piece)
            left = right
        return result
    if isinstance(node, _pyast.BoolOp):
        opcode = so.B_AND if isinstance(node.op, _pyast.And) else so.B_OR
        out = _walk(node.values[0], be)
        for v in node.values[1:]:
            out = _logic(be, opcode, out, _walk(v, be))
        return out
    if isinstance(node, _pyast.IfExp):
        cond = _walk(node.test, be)
        return _where(be, cond, _walk(node.body, be), _walk(node.orelse, be))
    if isinstance(node, _pyast.Subscript):
        base = node.value
        key_node = node.slice
        if isinstance(key_node, _pyast.Constant):
            key = key_node.value
        else:
            raise QueryParsingError("subscript must be a literal")
        if isinstance(base, _pyast.Name) and base.id == "doc":
            return be.host(_DocField(str(key)))
        if isinstance(base, _pyast.Name) and base.id == "params":
            return be.param(str(key))
        raise QueryParsingError("only doc[...] / params[...] subscripts allowed")
    if isinstance(node, _pyast.Attribute):
        if isinstance(node.value, _pyast.Name) and node.value.id == "params":
            return be.param(node.attr)
        base = _walk(node.value, be)
        doc = be.py(base) if be.is_host(base) else None
        if isinstance(doc, _DocField) and node.attr == "value":
            return be.column(doc.field)
        if isinstance(doc, _DocField) and node.attr == "empty":
            return be.empty(doc.field)
        raise QueryParsingError(f"unknown attribute [{node.attr}]")
    if isinstance(node, _pyast.Call):
        if not isinstance(node.func, _pyast.Name):
            raise QueryParsingError("only plain function calls allowed")
        fname = node.func.id
        if fname in ("cosineSimilarity", "dotProduct"):
            if len(node.args) != 2:
                raise QueryParsingError(
                    f"{fname} expects (query_vector, 'field')")
            qv = _walk(node.args[0], be)
            fld = node.args[1]
            if not (isinstance(fld, _pyast.Constant)
                    and isinstance(fld.value, str)):
                raise QueryParsingError(
                    f"{fname} field must be a string literal")
            return be.product(fname == "cosineSimilarity", qv, fld.value)
        if fname not in _FUNCS:
            raise QueryParsingError(f"unknown script function [{fname}]")
        return _call(be, fname, [_walk(a, be) for a in node.args])
    raise QueryParsingError(
        f"script syntax not allowed: {type(node).__name__}")


def _param(params: dict, key: str):
    if key not in params:
        raise IllegalArgumentError(f"missing script param [{key}]")
    return params[key]


# ------------------------------------------------------------ the walker

class _TensorBackend:
    """Evaluates on torch tensors: host values stay Python objects, arrays
    are tensors (``[N]`` or 0-d) of bool, int32 or f32, each op the plain
    version's (``script_ops.apply_op``)."""

    def __init__(self, ctx: ScriptContext):
        self.ctx = ctx
        self.variables = ctx.variables

    def is_host(self, v) -> bool:
        return not isinstance(v, torch.Tensor)

    @staticmethod
    def py(v):
        return v

    def kind(self, v) -> str:
        return {torch.bool: "bool", torch.int32: "i32",
                torch.float32: "f32"}[v.dtype]

    def host(self, value):
        return value

    def host_op(self, fn, *args):
        return fn(*args)

    def const(self, v, kind: str):
        word = _host_word(v, kind)
        t = torch.tensor(word, device=self.ctx.device)
        return t != 0 if kind == "bool" else t

    def op(self, opcode: int, arg: int, operands, kind: str):
        return so.apply_op(opcode, arg, operands)

    def variable(self, name: str):
        return self.variables[name]

    def score(self):
        return self.ctx.scores

    def param(self, key: str):
        return _param(self.ctx.params, key)

    def column(self, fld: str):
        col, exists = self.ctx.get_numeric_column(fld)
        return torch.where(exists, col.to(torch.float32), torch.zeros(
            (), dtype=torch.float32, device=col.device))

    def empty(self, fld: str):
        return ~self.ctx.get_numeric_column(fld)[1]

    def product(self, cosine: bool, qv, fld: str):
        vecs, exists = self.ctx.get_vector_column(fld)
        q = torch.as_tensor(qv, dtype=torch.float32, device=vecs.device)
        if cosine:
            q = q / torch.sqrt((q * q).sum() + 1e-12)
        return torch.where(exists, vecs @ q, torch.zeros(
            (), dtype=torch.float32, device=vecs.device))


# ------------------------------------------------------------- lowering

@dataclass
class _Host:
    """A Python value during lowering: its value for the representative row
    and, when it reads a per-row name, how to recompute it for any row."""
    value: Any
    fn: Callable | None = None


@dataclass
class _Frag:
    """A lowered array value: its postfix code, kind and stack depth."""
    code: tuple
    kind: str
    depth: int


@dataclass
class VectorParam:
    """A list-valued script_score param: a per-query f32 vector, read only by
    cosineSimilarity / dotProduct."""
    key: str


@dataclass
class ScriptProgram:
    """A script lowered for one context: ``code`` (None when the whole result
    is a host value, then ``host``), the numeric fields of its column slots,
    its product slots ``(cosine, query, field)`` (``query`` a
    :class:`VectorParam` or a host list), the param keys of its per-query
    param columns, and its per-row host values ``(fn(variables), kind)``."""
    code: so.ScriptCode | None
    host: Any = None
    columns: list = field(default_factory=list)
    products: list = field(default_factory=list)
    params: list = field(default_factory=list)
    rowvals: list = field(default_factory=list)

    def row_words(self, rows: list[dict]) -> np.ndarray:
        """The per-row host values of ``rows`` (each a variables dict) as
        int32 words ``[H, len(rows)]``."""
        out = np.zeros((len(self.rowvals), len(rows)), np.int32)
        for h, (fn, kind) in enumerate(self.rowvals):
            for r, variables in enumerate(rows):
                out[h, r] = np.asarray(_host_word(fn(variables), kind)).view(
                    np.int32)
        return out

    def row_kinds(self, variables: dict) -> tuple:
        """The Python kinds of one row's per-row host values: rows whose
        kinds equal the representative's share this program."""
        return tuple(_py_kind(fn(variables)) for fn, _ in self.rowvals)


def slot_columns(prog: ScriptProgram, seg, rows=None) -> list:
    """The ``(values f32, exists bool)`` of each column slot of ``prog`` in a
    device segment (its numeric columns' f32 ``hi``), at ``rows`` (an int64
    index tensor) or whole; a field the segment lacks reads as missing."""
    n = seg.padded_docs if rows is None else len(rows)
    dev = seg.live.device
    out = []
    for fld in prog.columns:
        col = seg.numeric.get(fld)
        if col is None:
            out.append((torch.zeros(n, dtype=torch.float32, device=dev),
                        torch.zeros(n, dtype=torch.bool, device=dev)))
        elif rows is None:
            out.append((col.hi, col.exists))
        else:
            out.append((col.hi[rows], col.exists[rows]))
    return out


class _LowerBackend:
    """Emits postfix code. ``mode``: "query" (script_score: numeric params
    are per-query f32 columns, list params per-query vectors, ``_score`` the
    query score), "host" (script_fields, scripted_metric: params are the
    request's Python values and ``_score`` a zero array), or "pipeline"
    (params empty, ``variables`` per-row host values, ``_score`` None)."""

    def __init__(self, mode: str, params: dict, variables: dict):
        self.mode = mode
        self.params = params
        self.variables = variables or {}
        self.consts: list[int] = []
        self.prog = ScriptProgram(code=None)
        self.uses_score = False

    def is_host(self, v) -> bool:
        return isinstance(v, _Host)

    @staticmethod
    def py(v):
        return v.value

    def kind(self, v) -> str:
        return v.kind

    def host(self, value):
        return _Host(value)

    def host_op(self, fn, *args):
        value = fn(*(a.value for a in args))
        if all(a.fn is None for a in args):
            return _Host(value)
        fns = [a.fn or (lambda vs, _x=a.value: _x) for a in args]
        return _Host(value, lambda vs: fn(*(f(vs) for f in fns)))

    def _load(self, opcode: int, arg: int, kind: str) -> _Frag:
        return _Frag(((opcode, arg),), kind, 1)

    def const(self, v: _Host, kind: str):
        if v.fn is None:
            word = np.asarray(_host_word(v.value, kind)).view(np.int32)
            self.consts.append(int(word))
            return self._load(_LOAD_CONST[kind], len(self.consts) - 1, kind)
        _host_word(v.value, kind)       # the representative row converts
        self.prog.rowvals.append((v.fn, kind))
        return self._load(_LOAD_ROW[kind], len(self.prog.rowvals) - 1, kind)

    def op(self, opcode: int, arg: int, operands, kind: str) -> _Frag:
        code, depth = (), 0
        for i, f in enumerate(operands):
            code += f.code
            depth = max(depth, i + f.depth)
        return _Frag(code + ((opcode, arg),), kind, max(depth, 1))

    def variable(self, name: str):
        return _Host(self.variables[name], lambda vs, _n=name: vs[_n])

    def score(self):
        if self.mode == "query":
            self.uses_score = True
            return self._load(so.LD_SCORE, 0, "f32")
        if self.mode == "host":
            return self.const(_Host(0.0), "f32")
        raise TypeError("_score is not bound in a bucket pipeline")

    def param(self, key: str):
        v = _param(self.params, key)
        if self.mode != "query":
            return _Host(v)
        if isinstance(v, bool) or not isinstance(v, (int, float, list,
                                                     tuple)):
            return _Host(v)
        if isinstance(v, (list, tuple)):
            return _Host(VectorParam(key))
        if key not in self.prog.params:
            self.prog.params.append(key)
        return self._load(so.LD_PARAM, self.prog.params.index(key), "f32")

    def _slot(self, items: list, item) -> int:
        if item not in items:
            items.append(item)
        return items.index(item)

    def column(self, fld: str):
        return self._load(so.LD_COL, self._slot(self.prog.columns, fld),
                          "f32")

    def empty(self, fld: str):
        return self._load(so.LD_EMPTY, self._slot(self.prog.columns, fld),
                          "bool")

    def product(self, cosine: bool, qv, fld: str):
        if not self.is_host(qv) or qv.fn is not None:
            raise TypeError("a vector function's query must be a list param")
        query = qv.value
        if not isinstance(query, VectorParam):
            query = tuple(float(x) for x in query)
        slot = self._slot(self.prog.products, (cosine, query, fld))
        return self._load(so.LD_PROD, slot, "f32")

    def finish(self, out, to_f32: bool) -> ScriptProgram:
        prog = self.prog
        if self.is_host(out) and not to_f32:
            prog.host = out
            return prog
        if to_f32:
            out = _to(self, _as_array(self, out), "f32")
        prog.code = so.ScriptCode(
            ops=np.asarray(out.code, np.int32).reshape(-1, 2),
            consts=np.asarray(self.consts, np.int32).view(np.uint32),
            out=out.kind, depth=out.depth, n_cols=len(prog.columns),
            n_prods=len(prog.products), n_params=len(prog.params),
            n_rows=len(prog.rowvals), uses_score=self.uses_score)
        return prog


class CompiledScript:
    def __init__(self, source: str):
        self.source = source
        try:
            tree = _pyast.parse(source, mode="eval")
        except SyntaxError as e:
            raise QueryParsingError(f"script compile error: {e}") from None
        self._tree = tree
        self._lowered: dict = {}
        self._vector_fields = _vector_fields(tree)

    def evaluate(self, ctx: ScriptContext):
        """The walker: the script's value over the context's tensors (a
        Python value when the whole script is host arithmetic)."""
        return _walk(self._tree.body, _TensorBackend(ctx))

    def lower(self, mode: str, params: dict,
              variables: dict | None = None) -> ScriptProgram:
        """→ the :class:`ScriptProgram` of this script in ``mode`` ("query",
        "host" or "pipeline", see :class:`_LowerBackend`). ``params`` are the
        request's; in "query" mode only their kinds (and the values of bool
        and string ones) shape the program. ``variables`` are a
        representative row's bare names. A "query" program ends in f32 as
        ``jnp.asarray(out, f32)`` does. Errors raise as the reference's
        walker raises them. Cached unless it reads per-row names."""
        key = None
        if not variables:
            key = (mode, tuple(sorted(
                (k, _param_key(mode, v)) for k, v in params.items())))
            hit = self._lowered.get(key)
            if hit is not None:
                return hit
        be = _LowerBackend(mode, params, variables)
        prog = be.finish(_walk(self._tree.body, be), to_f32=mode == "query")
        if key is not None:
            self._lowered[key] = prog
        return prog

    def vector_fields(self) -> set | None:
        """Plan-time scan: the vector fields this script's accessors
        (cosineSimilarity / dotProduct) read, so a numeric-only script
        never puts a vector matrix on the device. → the (possibly empty) set
        of constant field names, or None when a field argument is not a
        literal (the caller must assume every vector column). Scanned once,
        at compile."""
        return self._vector_fields

    def uses_vectors(self) -> bool:
        fields = self.vector_fields()
        return fields is None or bool(fields)


def _vector_fields(tree) -> set | None:
    out: set = set()
    for node in _pyast.walk(tree):
        if isinstance(node, _pyast.Call) and \
                isinstance(node.func, _pyast.Name) and \
                node.func.id in ("cosineSimilarity", "dotProduct"):
            if len(node.args) == 2 and \
                    isinstance(node.args[1], _pyast.Constant) and \
                    isinstance(node.args[1].value, str):
                out.add(node.args[1].value)
            else:
                return None
    return out


def _param_key(mode: str, v):
    """What of a param shapes the lowered program: in "query" mode a number
    is a per-query column and a list a per-query vector (their values do not
    matter); anything else is folded in by value."""
    if mode == "query" and not isinstance(v, bool):
        if isinstance(v, (int, float)):
            return "num"
        if isinstance(v, (list, tuple)):
            return ("vec", len(v))
    return (type(v).__name__, repr(v))


_SCRIPT_CACHE: dict[str, CompiledScript] = {}


def compile_script(source: str) -> CompiledScript:
    """Compile+cache (reference: ScriptService compilation cache,
    core/script/ScriptService.java:269-310)."""
    cs = _SCRIPT_CACHE.get(source)
    if cs is None:
        cs = CompiledScript(source)
        _SCRIPT_CACHE[source] = cs
    return cs
