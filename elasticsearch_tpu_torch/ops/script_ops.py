"""The script expression evaluator: a postfix program over doc values.

Counterpart of the JAX package's ``search/scripts.py:_eval`` as
``execute.py:_script_factor`` runs it inside each fused program (the
lang-expression engine BASELINE's configs 3 and 4 name for
``script_score``). ``search/scripts.py`` lowers a script's tree to a flat
postfix program whose every value has a static type — bool, int32 or f32,
as jnp's promotion gives it — and this module runs that program over a
whole batch: out ``[B, N]`` for B queries and N rows.

On a CUDA tensor :func:`script_eval` is kernel K12 (``csrc/script_eval.cu``,
counter :data:`SCRIPT_EVAL`); on a CPU tensor it is
:func:`script_eval_plain`, which runs each opcode as one eager torch op on
whole tensors, in the program's order. Every opcode rounds once, as eager
torch does, and the kernel takes the same route op for op (the same libm
function, the same compose for ``min``/``max``/``%``/``**``), so the two are
bit-identical on one card.

The program's inputs:

* column slots — a numeric field's f32 values and exists mask ``[N]``
  (``doc['f'].value`` reads ``where(exists, value, 0)``, ``.empty`` reads
  ``~exists``);
* ``_score`` ``[B, N]`` f32, where the program reads it;
* product slots — a ``cosineSimilarity`` / ``dotProduct`` ``[B, N]`` f32
  (one ``torch.matmul`` a segment, outside the kernel) with the vector
  field's exists mask ``[N]``;
* per-query params ``[B, P]`` f32;
* per-row host values ``[H, N]`` (32-bit words, typed by their load op):
  values the host computed in Python for each row, the bucket pipelines'
  bare names.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from elasticsearch_tpu_torch.ops import cuda_build

SCRIPT_EVAL = cuda_build.CudaKernel(
    "script_eval", "script_eval.cu", "script_eval_launch",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
     ctypes.c_int])

# ---------------------------------------------------------------- opcodes
# Each op is (opcode, arg). Loads push; the rest pop their operands (the
# left one deeper) and push one result. The numbers are csrc/script_eval.cu's.
LD_CONST_F, LD_CONST_I, LD_CONST_B = 0, 1, 2     # arg: constant index
LD_COL, LD_EMPTY = 3, 4                           # arg: column slot
LD_SCORE = 5
LD_PARAM = 6                                      # arg: param column
LD_PROD = 7                                       # arg: product slot
LD_ROW_F, LD_ROW_I, LD_ROW_B = 8, 9, 10           # arg: host-value row
B2I, B2F, I2F, F2B, I2B = 11, 12, 13, 14, 15
F_ADD, F_SUB, F_MUL, F_DIV, F_MOD, F_POW, F_MIN, F_MAX = range(16, 24)
F_NEG, F_ABS, F_FLOOR, F_CEIL, F_LOG, F_LOG10, F_SQRT, F_EXP = range(24, 32)
F_IPOW = 32                                        # arg: the int exponent
F_LT, F_LE, F_GT, F_GE, F_EQ, F_NE = range(33, 39)
I_ADD, I_SUB, I_MUL, I_MOD, I_POW, I_MIN, I_MAX = range(40, 47)
I_NEG, I_ABS = 47, 48
I_IPOW = 49                                        # arg: exponent >= 0
I_LT, I_LE, I_GT, I_GE, I_EQ, I_NE = range(50, 56)
B_AND, B_OR, B_NOT = 56, 57, 58
SELECT = 59                                        # (cond, a, b)

@dataclass
class ScriptCode:
    """A lowered program: ``ops`` int32 ``[n, 2]``, ``consts`` 32-bit words
    (read by the typed ``LD_CONST_*``), the result's kind (``"bool"``,
    ``"i32"`` or ``"f32"``), the deepest stack it reaches, and how many
    inputs of each kind it reads."""
    ops: np.ndarray
    consts: np.ndarray
    out: str
    depth: int
    n_cols: int = 0
    n_prods: int = 0
    n_params: int = 0
    n_rows: int = 0
    uses_score: bool = False


# ------------------------------------------------------------ plain version

def _fmin(a, b):
    """jnp.minimum: a NaN operand gives NaN; of two zeros, -0.0."""
    return torch.where(torch.isnan(a), a, torch.where(
        torch.isnan(b), b, torch.where(a < b, a, torch.where(
            b < a, b, torch.where(torch.signbit(a), a, b)))))


def _fmax(a, b):
    """jnp.maximum: a NaN operand gives NaN; of two zeros, +0.0."""
    return torch.where(torch.isnan(a), a, torch.where(
        torch.isnan(b), b, torch.where(a > b, a, torch.where(
            b > a, b, torch.where(torch.signbit(a), b, a)))))


def _fmod(a, b):
    """Python's ``%`` on f32 (jnp.remainder): fmod, then the divisor added
    where the remainder's sign differs from it; a zero keeps fmod's sign."""
    m = torch.fmod(a, b)
    return torch.where((m != 0) & ((b < 0) != (m < 0)), m + b, m)


def _imod(a, b):
    """jnp.remainder on int32: a zero divisor gives 0 (jnp divides by 1);
    -1 gives 0 without the trap of INT_MIN % -1."""
    one = torch.ones((), dtype=torch.int32, device=b.device)
    b = torch.where((b == 0) | (b == -1), one, b)
    m = torch.fmod(a, b)
    return torch.where((m != 0) & ((b < 0) != (m < 0)), m + b, m)


def _ipow(x, n: int):
    """lax.integer_pow: binary exponentiation, ``acc * x`` then ``x * x``;
    a negative exponent divides 1 by the result (f32 only)."""
    if n == 0:
        return torch.ones_like(x)
    recip = n < 0
    n = -n if recip else n
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    if recip:
        return torch.ones((), dtype=acc.dtype, device=acc.device) / acc
    return acc


def _pow_int_int(x, y):
    """jnp.power on int32 base and exponent arrays: six rounds of binary
    exponentiation on the exponent's low bits, its shift logical."""
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    one = torch.ones((), dtype=torch.int32, device=x.device)
    acc = torch.where((x == 0) & (y != 0), zero, one)
    for _ in range(6):
        acc = torch.where((y & 1) != 0, acc * x, acc)
        x = x * x
        y = (y >> 1) & 0x7FFFFFFF
    return acc


_UNARY = {
    B2I: lambda a: a.to(torch.int32), B2F: lambda a: a.to(torch.float32),
    I2F: lambda a: a.to(torch.float32), F2B: lambda a: a != 0,
    I2B: lambda a: a != 0, F_NEG: torch.neg, F_ABS: torch.abs,
    F_FLOOR: torch.floor, F_CEIL: torch.ceil, F_LOG: torch.log,
    F_LOG10: torch.log10, F_SQRT: torch.sqrt, F_EXP: torch.exp,
    I_NEG: torch.neg, I_ABS: torch.abs, B_NOT: torch.logical_not,
}
_BINARY = {
    F_ADD: torch.add, F_SUB: torch.sub, F_MUL: torch.mul, F_DIV: torch.div,
    F_MOD: _fmod, F_POW: torch.pow, F_MIN: _fmin, F_MAX: _fmax,
    F_LT: torch.lt, F_LE: torch.le, F_GT: torch.gt, F_GE: torch.ge,
    F_EQ: torch.eq, F_NE: torch.ne,
    I_ADD: torch.add, I_SUB: torch.sub, I_MUL: torch.mul, I_MOD: _imod,
    I_POW: _pow_int_int, I_MIN: torch.minimum, I_MAX: torch.maximum,
    I_LT: torch.lt, I_LE: torch.le, I_GT: torch.gt, I_GE: torch.ge,
    I_EQ: torch.eq, I_NE: torch.ne,
    B_AND: torch.logical_and, B_OR: torch.logical_or,
}


def apply_op(op: int, arg: int, operands: list) -> torch.Tensor:
    """One non-load opcode on its operands (tensors of its input kind), as
    the plain version and the walker of ``search/scripts.py`` run it."""
    if op in _UNARY:
        return _UNARY[op](operands[0])
    if op == F_IPOW or op == I_IPOW:
        return _ipow(operands[0], arg)
    if op == SELECT:
        c, a, b = operands
        return torch.where(c, a, b)
    a, b = operands
    return _BINARY[op](a, b)


def script_eval_plain(code: ScriptCode, columns, score, products, params,
                      rowvals, batch: int, n: int) -> torch.Tensor:
    """K12's plain version: each opcode one eager torch op on whole tensors
    (a column ``[1, N]``, a per-query value ``[B, 1]`` or ``[B, N]``, a
    constant 0-d on the inputs' device). → ``[batch, n]`` of the program's
    result kind. Arguments as :func:`script_eval`."""
    dev = _device_of(columns, score, products, params, rowvals)
    consts = torch.from_numpy(code.consts.view(np.int32).copy()).to(dev)
    stack: list[torch.Tensor] = []
    for op, arg in code.ops.tolist():
        if op in (LD_CONST_F, LD_CONST_I, LD_CONST_B):
            stack.append(_typed(consts[arg], op - LD_CONST_F))
        elif op == LD_COL:
            vals, exists = columns[arg]
            stack.append(torch.where(exists, vals, torch.zeros(
                (), dtype=torch.float32, device=dev))[None, :])
        elif op == LD_EMPTY:
            stack.append(~columns[arg][1][None, :])
        elif op == LD_SCORE:
            stack.append(score)
        elif op == LD_PARAM:
            stack.append(params[:, arg:arg + 1])
        elif op == LD_PROD:
            prod, exists = products[arg]
            stack.append(torch.where(exists[None, :], prod, torch.zeros(
                (), dtype=torch.float32, device=dev)))
        elif op in (LD_ROW_F, LD_ROW_I, LD_ROW_B):
            stack.append(_typed(rowvals[arg][None, :], op - LD_ROW_F))
        else:
            arity = 3 if op == SELECT else 2 if op in _BINARY else 1
            operands = stack[-arity:]
            del stack[-arity:]
            stack.append(apply_op(op, arg, operands))
    (out,) = stack
    return out.expand(batch, n).contiguous()


def _typed(words: torch.Tensor, kind: int) -> torch.Tensor:
    """int32 words read as f32 (kind 0), int32 (1) or bool (2)."""
    if kind == 0:
        return words.view(torch.float32)
    return words != 0 if kind == 2 else words


def _device_of(columns, score, products, params, rowvals) -> torch.device:
    for t in ([c[0] for c in columns] + [score]
              + [p[0] for p in products] + [params, rowvals]):
        if t is not None:
            return t.device
    raise ValueError("script_eval: a program reads at least one input "
                     "tensor; pass `rowvals` for a constant one")


# ------------------------------------------------------------------ wrapper

def script_eval(code: ScriptCode, columns, score, products, params,
                rowvals, batch: int, n: int) -> torch.Tensor:
    """Run ``code`` over ``batch`` queries × ``n`` rows → ``[batch, n]`` of
    its result kind (bool, int32 or f32).

    ``columns``: one ``(values [n] f32, exists [n] bool)`` a column slot;
    ``score``: ``[batch, n]`` f32 or None; ``products``: one ``(product
    [batch, n] f32, exists [n] bool)`` a product slot; ``params``:
    ``[batch, P]`` f32 or None; ``rowvals``: ``[H, n]`` int32 words or None
    (a program that reads no input passes an empty ``[0, n]`` one so the
    device is known). A CPU device runs :func:`script_eval_plain`; a CUDA
    device launches K12 once."""
    dev = _device_of(columns, score, products, params, rowvals)
    if dev.type == "cpu":
        return script_eval_plain(code, columns, score, products, params,
                                 rowvals, batch, n)
    return _script_eval_cuda(code, columns, score, products, params,
                             rowvals, batch, n, dev)


def _script_eval_cuda(code, columns, score, products, params, rowvals,
                      batch, n, dev) -> torch.Tensor:
    name = "script_eval"
    if len(columns) != code.n_cols or len(products) != code.n_prods:
        raise ValueError(f"{name}: the program reads {code.n_cols} columns "
                         f"and {code.n_prods} products, got {len(columns)} "
                         f"and {len(products)}")
    for i, (vals, exists) in enumerate(columns):
        cuda_build.check_dtype(name, f"column {i}", vals, torch.float32)
        cuda_build.check_dtype(name, f"column {i} exists", exists,
                               torch.bool)
        if vals.shape != (n,) or exists.shape != (n,):
            raise ValueError(f"{name}: column {i} must be [{n}]")
        cuda_build.check_cuda(name, dev, vals=vals, exists=exists)
    for i, (prod, exists) in enumerate(products):
        cuda_build.check_dtype(name, f"product {i}", prod, torch.float32)
        cuda_build.check_dtype(name, f"product {i} exists", exists,
                               torch.bool)
        if prod.shape != (batch, n) or exists.shape != (n,):
            raise ValueError(f"{name}: product {i} must be [{batch}, {n}]")
        cuda_build.check_cuda(name, dev, prod=prod, exists=exists)
    if code.uses_score:
        cuda_build.check_dtype(name, "score", score, torch.float32)
        if score is None or score.shape != (batch, n):
            raise ValueError(f"{name}: score must be [{batch}, {n}]")
    else:
        score = None
    if code.n_params:
        cuda_build.check_dtype(name, "params", params, torch.float32)
        if params is None or params.shape != (batch, code.n_params):
            raise ValueError(f"{name}: params must be "
                             f"[{batch}, {code.n_params}]")
    else:
        params = None
    if code.n_rows:
        cuda_build.check_dtype(name, "rowvals", rowvals, torch.int32)
        if rowvals is None or rowvals.shape != (code.n_rows, n):
            raise ValueError(f"{name}: rowvals must be "
                             f"[{code.n_rows}, {n}]")
    else:
        rowvals = None
    cuda_build.check_cuda(name, dev, score=score, params=params,
                          rowvals=rowvals)
    out = torch.empty((batch, n), dtype=torch.int32, device=dev)
    if batch and n:
        blob = _blob(code, columns, products, dev)
        SCRIPT_EVAL.launch(
            dev, blob.data_ptr(), code.n_cols, code.n_prods,
            len(code.ops), len(code.consts), cuda_build.ptr(score),
            cuda_build.ptr(params), code.n_params, cuda_build.ptr(rowvals),
            out.data_ptr(), batch, n, code.depth)
    if code.out == "f32":
        return out.view(torch.float32)
    return out != 0 if code.out == "bool" else out


def _blob(code: ScriptCode, columns, products, dev) -> torch.Tensor:
    """One int64 table a launch, in one host→device copy: the columns'
    value and exists pointers, the products' and their exists pointers,
    then the ops (opcode in the high word) and the constants."""
    words = ([c[0].data_ptr() for c in columns]
             + [c[1].data_ptr() for c in columns]
             + [p[0].data_ptr() for p in products]
             + [p[1].data_ptr() for p in products])
    ops = code.ops.astype(np.int64)
    packed = (ops[:, 0] << 32) | (ops[:, 1] & 0xFFFFFFFF)
    host = np.concatenate([np.asarray(words, np.int64), packed,
                           code.consts.astype(np.int64)])
    return torch.from_numpy(host).to(dev)


def script_eval_bytes(code: ScriptCode, batch: int, n: int) -> int:
    """The bytes K12 must move: each column's values and exists read once,
    the score and the products where the program reads them, the params and
    host values, and the ``[batch, n]`` 4-byte result written once."""
    return (code.n_cols * n * 5 + (batch * n * 4 if code.uses_score else 0)
            + code.n_prods * (batch * n * 4 + n) + batch * code.n_params * 4
            + code.n_rows * n * 4 + batch * n * 4)
