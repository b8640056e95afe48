"""GroovyLite — the general-purpose script language (lang-groovy analog).

A copy of ``elasticsearch_tpu/search/scriptlang.py`` with its imports
rewritten: a pure host interpreter, op budget included.

Plays the role of the reference's default script engine
(core/script/ScriptService.java:227; plugins/lang-groovy): a brace-syntax
imperative language with local variables, conditionals, loops, list/map
literals and method calls, interpreted per document / per invocation on
the host. The vectorized expression engine (scripts.py) stays the fast
path for arithmetic score/agg expressions; this engine exists for the
scripts expressions cannot express — update scripts that branch, scripted
metrics with loops and state, script fields building collections.

Surface syntax (the Groovy/Painless common subset the reference's docs
and test suites actually use):

    def total = 0;
    for (x in ctx._source.values) { if (x > 0) { total += x } }
    ctx._source.total = total;
    if (total == 0) { ctx.op = 'none' }

Sandboxing, by construction rather than by filter:
  * the parser only builds nodes the interpreter knows — there is no
    escape into Python eval;
  * names resolve against script-local scopes and the caller-provided
    bindings only; no builtins, no imports, no dunder access;
  * methods dispatch through closed per-type tables (list/map/str/num);
  * every interpreter step debits an op budget — runaway loops raise
    instead of hanging a shard (the reference counts loop iterations in
    compiled Groovy the same way).
"""

from __future__ import annotations

import math
import re

from elasticsearch_tpu_torch.common.errors import (
    ElasticsearchTpuError, QueryParsingError)


class ScriptException(ElasticsearchTpuError):
    status = 400
    error_type = "script_exception"


DEFAULT_OP_BUDGET = 500_000

# ---- tokenizer -------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|//[^\n]*|/\*.*?\*/)
  | (?P<num>\d+\.\d+(?:[eE][+-]?\d+)?|\d+[lLfFdD]?)
  | (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
  | (?P<name>[A-Za-z_$][A-Za-z0-9_$]*)
  | (?P<op>\+\+|--|\*\*|==|!=|<=|>=|&&|\|\||\+=|-=|\*=|/=|%=|\?:
        |[-+*/%<>=!?:.,;(){}\[\]])
""", re.VERBOSE | re.DOTALL)

_KEYWORDS = {"def", "if", "else", "for", "while", "in", "return", "break",
             "continue", "true", "false", "null", "new", "int", "long",
             "double", "float", "boolean", "String", "var"}


def _tokenize(src: str) -> list[tuple[str, str]]:
    out, pos = [], 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise ScriptException(
                f"unexpected character {src[pos]!r} at {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "name" and text in _KEYWORDS:
            kind = text
        out.append((kind, text))
    out.append(("eof", ""))
    return out


# ---- parser ---------------------------------------------------------------
# AST: plain tuples ("kind", ...) — the interpreter owns the vocabulary.

_BIN_PRECEDENCE = {
    "||": 1, "&&": 2,
    "==": 3, "!=": 3,
    "<": 4, "<=": 4, ">": 4, ">=": 4, "in": 4,
    "+": 5, "-": 5,
    "*": 6, "/": 6, "%": 6,
    "**": 7,
}


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self, k: int = 0):
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, text: str) -> bool:
        if self.peek()[1] == text and self.peek()[0] != "str":
            self.next()
            return True
        return False

    def expect(self, text: str):
        if not self.accept(text):
            raise ScriptException(
                f"expected {text!r}, found {self.peek()[1]!r}")

    # -- statements ----------------------------------------------------------

    def program(self):
        stmts = []
        while self.peek()[0] != "eof":
            before = self.i
            stmts.append(self.statement())
            if self.i == before:                 # e.g. a stray '}'
                raise ScriptException(
                    f"unexpected token {self.peek()[1]!r}")
        return ("block", stmts)

    def block(self):
        if self.accept("{"):
            stmts = []
            while not self.accept("}"):
                stmts.append(self.statement())
            return ("block", stmts)
        return self.statement()

    def statement(self):   # noqa: C901 — one dispatch table, flat cases
        while self.peek() == ("op", ";"):        # empty statement(s)
            self.next()
        kind, text = self.peek()
        if kind == "eof" or text == "}":
            return ("block", [])
        if kind in ("def", "var", "int", "long", "double", "float",
                    "boolean", "String"):
            self.next()
            name = self.next()[1]
            value = ("null",)
            if self.accept("="):
                value = self.expr()
            self.accept(";")
            return ("declare", name, value)
        if kind == "if":
            self.next()
            self.expect("(")
            cond = self.expr()
            self.expect(")")
            then = self.block()
            otherwise = None
            if self.accept("else"):
                otherwise = self.block()
            return ("if", cond, then, otherwise)
        if kind == "while":
            self.next()
            self.expect("(")
            cond = self.expr()
            self.expect(")")
            return ("while", cond, self.block())
        if kind == "for":
            return self._for()
        if kind == "return":
            self.next()
            value = ("null",)
            if self.peek()[1] not in (";", "}") or self.peek()[0] == "str":
                value = self.expr()
            self.accept(";")
            return ("return", value)
        if kind == "break":
            self.next()
            self.accept(";")
            return ("break",)
        if kind == "continue":
            self.next()
            self.accept(";")
            return ("continue",)
        stmt = self.simple()
        self.accept(";")
        return stmt

    def _for(self):
        self.next()
        self.expect("(")
        # for (x in expr)  |  for (def x in expr)  |  for (init; cond; step)
        save = self.i
        for kw in ("def", "var", "int", "long", "double"):
            self.accept(kw)
        if self.peek()[0] == "name" and self.peek(1)[1] == "in":
            var = self.next()[1]
            self.next()                          # 'in'
            seq = self.expr()
            self.expect(")")
            return ("foreach", var, seq, self.block())
        self.i = save
        init = None if self.peek()[1] == ";" else self.statement()
        self.accept(";")
        cond = ("true",) if self.peek()[1] == ";" else self.expr()
        self.expect(";")
        step = None if self.peek()[1] == ")" else self.simple()
        self.expect(")")
        return ("cfor", init, cond, step, self.block())

    def simple(self):
        """assignment / aug-assignment / ++ / -- / bare expression."""
        target = self.expr()
        kind, text = self.peek()
        if text in ("=", "+=", "-=", "*=", "/=", "%=") and kind == "op":
            self.next()
            value = self.expr()
            self._check_assignable(target)
            return ("assign", text, target, value)
        if text in ("++", "--"):
            self.next()
            self._check_assignable(target)
            one = ("num", 1)
            return ("assign", "+=" if text == "++" else "-=", target, one)
        return ("exprstmt", target)

    @staticmethod
    def _check_assignable(target):
        if target[0] not in ("name", "getattr", "getitem"):
            raise ScriptException(
                f"cannot assign to {target[0]} expression")

    # -- expressions (Pratt) -------------------------------------------------

    def expr(self, min_prec: int = 0):
        """Precedence climbing; ternary/elvis bind loosest and only at the
        top level (parenthesize to nest them inside operands)."""
        left = self.unary()
        while True:
            kind, text = self.peek()
            if min_prec == 0 and kind == "op" and text == "?":
                self.next()
                then = self.expr()
                self.expect(":")
                left = ("ternary", left, then, self.expr())
                continue
            if min_prec == 0 and text == "?:":
                self.next()
                left = ("elvis", left, self.expr())
                continue
            if kind == "str" or text not in _BIN_PRECEDENCE or \
                    _BIN_PRECEDENCE[text] < min_prec:
                return left
            self.next()
            prec = _BIN_PRECEDENCE[text]
            # left-assoc: recurse one level tighter ('**' right-assoc)
            right = self.expr(prec if text == "**" else prec + 1)
            left = ("binop", text, left, right)

    def unary(self):
        kind, text = self.peek()
        if text == "!" and kind == "op":
            self.next()
            return ("not", self.unary())
        if text == "-" and kind == "op":
            self.next()
            return ("neg", self.unary())
        if text == "+" and kind == "op":
            self.next()
            return self.unary()
        return self.postfix()

    def postfix(self):
        node = self.atom()
        while True:
            if self.accept("."):
                name = self.next()[1]
                if self.accept("("):
                    args = self._args()
                    node = ("method", node, name, args)
                else:
                    node = ("getattr", node, name)
            elif self.accept("["):
                index = self.expr()
                self.expect("]")
                node = ("getitem", node, index)
            elif self.peek()[1] == "(" and node[0] == "name":
                self.next()
                node = ("call", node[1], self._args())
            else:
                return node

    def _args(self):
        args = []
        if self.accept(")"):
            return args
        args.append(self.expr())
        while self.accept(","):
            args.append(self.expr())
        self.expect(")")
        return args

    def atom(self):   # noqa: C901 — flat literal dispatch
        kind, text = self.next()
        if kind == "num":
            clean = text.rstrip("lLfFdD")
            return ("num", float(clean) if "." in clean or "e" in clean
                    or "E" in clean else int(clean))
        if kind == "str":
            body = text[1:-1]
            return ("str", re.sub(
                r"\\(.)", lambda m: {"n": "\n", "t": "\t"}.get(
                    m.group(1), m.group(1)), body))
        if kind == "true":
            return ("true",)
        if kind == "false":
            return ("false",)
        if kind == "null":
            return ("null",)
        if kind == "new":
            tname = self.next()[1]
            self.expect("(")
            args = self._args()
            return ("new", tname, args)
        if kind == "name":
            return ("name", text)
        if text == "(":
            e = self.expr()
            self.expect(")")
            return e
        if text == "[":
            return self._bracket_literal()
        raise ScriptException(f"unexpected token {text!r}")

    def _bracket_literal(self):
        """[a, b] list  |  [k: v, ...] map  |  [:] empty map."""
        if self.accept(":"):
            self.expect("]")
            return ("map", [])
        if self.accept("]"):
            return ("list", [])
        first = self.expr()
        if self.accept(":"):
            pairs = [(first, self.expr())]
            while self.accept(","):
                k = self.expr()
                self.expect(":")
                pairs.append((k, self.expr()))
            self.expect("]")
            return ("map", pairs)
        items = [first]
        while self.accept(","):
            items.append(self.expr())
        self.expect("]")
        return ("list", items)


# ---- interpreter -----------------------------------------------------------

class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class _Return(Exception):
    def __init__(self, value):
        self.value = value


_LIST_METHODS = {
    "add": lambda L, *a: (L.insert(int(a[0]), a[1])
                          if len(a) == 2 else L.append(a[0])),
    "addAll": lambda L, other: L.extend(other),
    "size": lambda L: len(L),
    "isEmpty": lambda L: len(L) == 0,
    "contains": lambda L, x: x in L,
    "get": lambda L, i: L[int(i)],
    "indexOf": lambda L, x: L.index(x) if x in L else -1,
    "remove": lambda L, i: L.pop(int(i)),
    "clear": lambda L: L.clear(),
    "sort": lambda L: L.sort(),
    "sum": lambda L: sum(L),
    "each": None,                    # rejected with a clear message below
}

_MAP_METHODS = {
    "put": lambda M, k, v: M.__setitem__(k, v),
    "get": lambda M, k, *d: M.get(k, d[0] if d else None),
    "getOrDefault": lambda M, k, d: M.get(k, d),
    "containsKey": lambda M, k: k in M,
    "containsValue": lambda M, v: v in M.values(),
    "remove": lambda M, k: M.pop(k, None),
    "size": lambda M: len(M),
    "isEmpty": lambda M: len(M) == 0,
    "keySet": lambda M: list(M.keys()),
    "values": lambda M: list(M.values()),
    "clear": lambda M: M.clear(),
}

_STR_METHODS = {
    "length": lambda s: len(s),
    "size": lambda s: len(s),
    "contains": lambda s, x: x in s,
    "startsWith": lambda s, p: s.startswith(p),
    "endsWith": lambda s, p: s.endswith(p),
    "indexOf": lambda s, x: s.find(x),
    "substring": lambda s, a, *b: s[int(a):int(b[0]) if b else None],
    "toLowerCase": lambda s: s.lower(),
    "toUpperCase": lambda s: s.upper(),
    "trim": lambda s: s.strip(),
    "split": lambda s, sep: s.split(sep),
    "replace": lambda s, a, b: s.replace(a, b),
    "equals": lambda s, o: s == o,
    "isEmpty": lambda s: len(s) == 0,
}

_NUM_METHODS = {
    "intValue": lambda x: int(x),
    "longValue": lambda x: int(x),
    "doubleValue": lambda x: float(x),
    "floatValue": lambda x: float(x),
    "toString": lambda x: str(x),
}

_MATH = {
    "max": max, "min": min, "abs": abs, "floor": math.floor,
    "ceil": math.ceil, "sqrt": math.sqrt, "log": math.log,
    "log10": math.log10, "exp": math.exp, "pow": pow, "round": round,
    "random": None,                  # nondeterministic — rejected
    "PI": math.pi, "E": math.e,
}

_FREE_FUNCS = {
    "max": max, "min": min, "abs": abs, "sqrt": math.sqrt,
    "log": math.log, "log10": math.log10, "exp": math.exp, "pow": pow,
    "floor": math.floor, "ceil": math.ceil, "round": round,
}

_NEWABLE = {
    "ArrayList": list, "HashMap": dict, "LinkedList": list,
    "HashSet": list, "StringBuilder": str, "LinkedHashMap": dict,
}


class CompiledGroovyLite:
    def __init__(self, source: str):
        self.source = source
        try:
            self.tree = _Parser(_tokenize(source)).program()
        except ScriptException:
            raise
        except Exception as e:       # noqa: BLE001 — uniform compile error
            raise ScriptException(f"compile error: {e}") from e

    def run(self, bindings: dict, op_budget: int = DEFAULT_OP_BUDGET):
        """Execute with the given top-level bindings (ctx/params/doc/…).
        → the script's return value (or the last statement's value)."""
        interp = _Interp(bindings, op_budget)
        try:
            return interp.exec_block(self.tree, {})
        except _Return as r:
            return r.value
        except ScriptException:
            raise
        except (_Break, _Continue):
            raise ScriptException("break/continue outside loop")
        except ZeroDivisionError:
            raise ScriptException("division by zero") from None
        except (TypeError, ValueError, KeyError, IndexError,
                AttributeError) as e:
            raise ScriptException(f"runtime error: {e}") from e


class _Interp:
    def __init__(self, bindings: dict, op_budget: int):
        self.bindings = bindings
        self.budget = op_budget

    def _tick(self):
        self.budget -= 1
        if self.budget <= 0:
            raise ScriptException("script exceeded its operation budget")

    # -- statements ----------------------------------------------------------

    def exec_block(self, node, scope) -> object:
        last = None
        for stmt in node[1]:
            last = self.exec_stmt(stmt, scope)
        return last

    def exec_stmt(self, node, scope):   # noqa: C901 — flat dispatch
        self._tick()
        kind = node[0]
        if kind == "block":
            # blocks do NOT open a new scope (Groovy locals declared in a
            # loop body stay visible after it; tests rely on this)
            return self.exec_block(node, scope)
        if kind == "declare":
            scope[node[1]] = self.eval(node[2], scope)
            return None
        if kind == "assign":
            return self._assign(node, scope)
        if kind == "exprstmt":
            return self.eval(node[1], scope)
        if kind == "if":
            if _truthy(self.eval(node[1], scope)):
                return self.exec_stmt(node[2], scope)
            if node[3] is not None:
                return self.exec_stmt(node[3], scope)
            return None
        if kind == "while":
            while _truthy(self.eval(node[1], scope)):
                self._tick()
                try:
                    self.exec_stmt(node[2], scope)
                except _Break:
                    break
                except _Continue:
                    continue
            return None
        if kind == "foreach":
            seq = self.eval(node[2], scope)
            if isinstance(seq, dict):
                seq = list(seq.keys())
            for item in list(seq):
                self._tick()
                scope[node[1]] = item
                try:
                    self.exec_stmt(node[3], scope)
                except _Break:
                    break
                except _Continue:
                    continue
            return None
        if kind == "cfor":
            if node[1] is not None:
                self.exec_stmt(node[1], scope)
            while _truthy(self.eval(node[2], scope)):
                self._tick()
                try:
                    self.exec_stmt(node[4], scope)
                except _Break:
                    break
                except _Continue:
                    pass
                if node[3] is not None:
                    self.exec_stmt(node[3], scope)
            return None
        if kind == "return":
            raise _Return(self.eval(node[1], scope))
        if kind == "break":
            raise _Break()
        if kind == "continue":
            raise _Continue()
        raise ScriptException(f"unknown statement {kind}")

    def _assign(self, node, scope):
        _, op, target, value_node = node
        value = self.eval(value_node, scope)
        if op != "=":
            current = self.eval(target, scope)
            if current is None:
                # `ctx._source.views += 1` on a missing field seeds the
                # type's zero (the update-script counter idiom; the old
                # regex evaluator behaved this way too)
                current = "" if isinstance(value, str) else \
                    [] if isinstance(value, list) else 0
            value = _binop(op[0], current, value)
        tk = target[0]
        if tk == "name":
            name = target[1]
            if name in scope:
                scope[name] = value
            elif name in self.bindings and not isinstance(
                    self.bindings[name], (dict, list)):
                self.bindings[name] = value
            else:
                scope[name] = value
        elif tk == "getattr":
            obj = self.eval(target[1], scope)
            if not isinstance(obj, dict):
                raise ScriptException(
                    f"cannot set property on {type(obj).__name__}")
            obj[target[2]] = value
        elif tk == "getitem":
            obj = self.eval(target[1], scope)
            key = self.eval(target[2], scope)
            if isinstance(obj, list):
                obj[int(key)] = value
            elif isinstance(obj, dict):
                obj[key] = value
            else:
                raise ScriptException(
                    f"cannot index-assign {type(obj).__name__}")
        return value

    # -- expressions ---------------------------------------------------------

    def eval(self, node, scope):   # noqa: C901 — flat dispatch
        self._tick()
        kind = node[0]
        if kind in ("num", "str"):
            return node[1]
        if kind == "true":
            return True
        if kind == "false":
            return False
        if kind == "null":
            return None
        if kind == "name":
            return self._lookup(node[1], scope)
        if kind == "binop":
            op = node[1]
            if op == "&&":
                return _truthy(self.eval(node[2], scope)) and \
                    _truthy(self.eval(node[3], scope))
            if op == "||":
                return _truthy(self.eval(node[2], scope)) or \
                    _truthy(self.eval(node[3], scope))
            return _binop(op, self.eval(node[2], scope),
                          self.eval(node[3], scope))
        if kind == "not":
            return not _truthy(self.eval(node[1], scope))
        if kind == "neg":
            return -self.eval(node[1], scope)
        if kind == "ternary":
            return self.eval(node[2], scope) \
                if _truthy(self.eval(node[1], scope)) \
                else self.eval(node[3], scope)
        if kind == "elvis":
            v = self.eval(node[1], scope)
            # Groovy truth: 0 / empty collections fall through to the
            # default, exactly as `a ?: b` behaves in the reference
            return v if _truthy(v) else self.eval(node[2], scope)
        if kind == "list":
            return [self.eval(e, scope) for e in node[1]]
        if kind == "map":
            return {self._map_key(k, scope): self.eval(v, scope)
                    for k, v in node[1]}
        if kind == "getattr":
            return self._getattr(self.eval(node[1], scope), node[2])
        if kind == "getitem":
            obj = self.eval(node[1], scope)
            key = self.eval(node[2], scope)
            if isinstance(obj, list):
                return obj[int(key)]
            if isinstance(obj, dict):
                return obj.get(key)
            if isinstance(obj, str):
                return obj[int(key)]
            if hasattr(obj, "__scriptlang_getitem__"):
                return obj.__scriptlang_getitem__(key)
            raise ScriptException(f"cannot index {type(obj).__name__}")
        if kind == "method":
            return self._method(node, scope)
        if kind == "call":
            fn = _FREE_FUNCS.get(node[1])
            if fn is None:
                raise ScriptException(f"unknown function [{node[1]}]")
            return fn(*[self.eval(a, scope) for a in node[2]])
        if kind == "new":
            ctor = _NEWABLE.get(node[1])
            if ctor is None:
                raise ScriptException(f"cannot instantiate [{node[1]}]")
            args = [self.eval(a, scope) for a in node[2]]
            return ctor(args[0]) if args else ctor()
        raise ScriptException(f"unknown expression {kind}")

    def _map_key(self, k, scope):
        # Groovy map literals treat bare names as string keys
        if k[0] == "name":
            return k[1]
        return self.eval(k, scope)

    def _lookup(self, name: str, scope):
        if name in scope:
            return scope[name]
        if name in self.bindings:
            return self.bindings[name]
        if name == "Math":
            return _MATH
        raise ScriptException(f"unknown variable [{name}]")

    def _getattr(self, obj, name: str):
        if name.startswith("__"):
            raise ScriptException(f"forbidden property [{name}]")
        if isinstance(obj, dict):
            return obj.get(name)
        if hasattr(obj, "__scriptlang_getattr__"):
            return obj.__scriptlang_getattr__(name)
        if isinstance(obj, str) and name == "length":
            return len(obj)
        raise ScriptException(
            f"no property [{name}] on {type(obj).__name__}")

    def _method(self, node, scope):
        obj = self.eval(node[1], scope)
        name = node[3 - 1]  # node = ("method", obj, name, args)
        args = [self.eval(a, scope) for a in node[3]]
        if name.startswith("__"):
            raise ScriptException(f"forbidden method [{name}]")
        if obj is _MATH:
            fn = _MATH.get(name)
            if not callable(fn):
                raise ScriptException(f"unknown Math method [{name}]")
            return fn(*args)
        table = None
        if isinstance(obj, list):
            table = _LIST_METHODS
        elif isinstance(obj, dict):
            table = _MAP_METHODS
        elif isinstance(obj, str):
            table = _STR_METHODS
        elif isinstance(obj, (int, float)):
            table = _NUM_METHODS
        elif hasattr(obj, "__scriptlang_method__"):
            return obj.__scriptlang_method__(name, args)
        if table is None or name not in table:
            raise ScriptException(
                f"no method [{name}] on {type(obj).__name__}")
        fn = table[name]
        if fn is None:
            raise ScriptException(
                f"[{name}] requires closures, which GroovyLite does not "
                "support — use a for loop")
        return fn(obj, *args)


def _truthy(v) -> bool:
    # Groovy truth: null/false/empty-ish are false
    if v is None or v is False:
        return False
    if isinstance(v, (str, list, dict)):
        return len(v) > 0
    return bool(v)


def _binop(op: str, a, b):   # noqa: C901 — operator table
    if op == "+":
        if isinstance(a, str) or isinstance(b, str):
            return _to_str(a) + _to_str(b)
        if isinstance(a, list):
            return a + (b if isinstance(b, list) else [b])
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        return a / b
    if op == "%":
        return a % b
    if op == "**":
        return a ** b
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    if op == "in":
        return a in b
    raise ScriptException(f"unknown operator {op}")


def _to_str(v) -> str:
    if v is None:
        return "null"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


# The `doc` binding lives in aggregations.py (_AggDocValues): it reads
# the columnar segments directly and handles .keyword subfield fallback.

_COMPILE_CACHE: dict[str, CompiledGroovyLite] = {}


def compile_groovylite(source: str) -> CompiledGroovyLite:
    c = _COMPILE_CACHE.get(source)
    if c is None:
        if len(_COMPILE_CACHE) > 512:
            _COMPILE_CACHE.clear()
        c = CompiledGroovyLite(source)
        _COMPILE_CACHE[source] = c
    return c
