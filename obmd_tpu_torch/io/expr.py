"""LAMMPS equal- and atom-style variable expressions.

The port's own copy of the JAX package's expression engine: a
precedence-climbing (Pratt) parser of variable.cpp's grammar and an
evaluator over pluggable backends.

  * operator precedence per variable.cpp:130-138 —
      ||  ^|            (1)
      &&                (2)
      == !=             (3)
      <  <=  >  >=      (4)
      +  -              (5)
      *  /  %           (6)
      ^                 (7, power)
      unary -  !        (8)
    every binary operator is LEFT-associative (variable.cpp:2394), `^`
    included (2^3^2 == 64), and unary minus binds tighter than `^`
    (-2^2 == 4);
  * `%` is C fmod (variable.cpp:2426): -5 % 3 == -2;
  * comparisons and logicals give 1.0 / 0.0 (variable.cpp:2437-2515);
  * LAMMPS' error messages ("Invalid syntax in variable formula", "Divide
    by zero in variable formula", ...).

Math functions (variable.cpp:3573-3581): sqrt exp ln log (= log10) abs sin
cos tan asin acos atan atan2 ceil floor round pow, and the MIN / MAX
aliases existing decks use.

A formula is parsed once per `variable` command and evaluated on one of
three backends: host floats (thermo and feedback scalars), numpy arrays
(atom-style variables), or 0-dim torch tensors on a run's device
(`torch_backend`: a time-dependent fix parameter evaluated at the stage's
device-side simulation time, with no host synchronisation).
"""
from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional, Tuple


class ExprError(ValueError):
    """LAMMPS-style variable formula error."""


_TWO_CHAR = ("==", "!=", "<=", ">=", "&&", "||", "^|")
_ONE_CHAR = "+-*/^%<>!(),"

_PREC = {"||": 1, "^|": 1, "&&": 2, "==": 3, "!=": 3,
         "<": 4, "<=": 4, ">": 4, ">=": 4,
         "+": 5, "-": 5, "*": 6, "/": 6, "%": 6, "^": 7}

_NUM_RE = re.compile(r"(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")
_NAME_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def _tokenize(s: str) -> List[Tuple[str, object]]:
    toks: List[Tuple[str, object]] = []
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c.isspace():
            i += 1
            continue
        two = s[i:i + 2]
        if two in _TWO_CHAR:
            toks.append(("op", two))
            i += 2
            continue
        m = _NUM_RE.match(s, i)
        if m:
            toks.append(("num", float(m.group(0))))
            i = m.end()
            continue
        m = _NAME_RE.match(s, i)
        if m:
            toks.append(("name", m.group(0)))
            i = m.end()
            continue
        if c in _ONE_CHAR:
            toks.append(("op", c))
            i += 1
            continue
        raise ExprError(
            f"Invalid syntax in variable formula: unexpected '{c}'")
    toks.append(("end", None))
    return toks


class _Parser:
    def __init__(self, toks):
        self.toks = toks
        self.pos = 0

    def peek(self):
        return self.toks[self.pos]

    def next(self):
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def expect_op(self, op):
        k, v = self.next()
        if k != "op" or v != op:
            raise ExprError(
                f"Invalid syntax in variable formula: expected '{op}'")

    def parse(self):
        node = self.parse_bin(1)
        k, _ = self.peek()
        if k != "end":
            raise ExprError("Invalid syntax in variable formula: "
                            "trailing tokens")
        return node

    def parse_bin(self, min_prec: int):
        lhs = self.parse_unary()
        while True:
            k, v = self.peek()
            if k != "op" or v not in _PREC or _PREC[v] < min_prec:
                return lhs
            self.next()
            # left-assoc everywhere (variable.cpp:2394 reduces on >=)
            rhs = self.parse_bin(_PREC[v] + 1)
            lhs = ("bin", v, lhs, rhs)

    def parse_unary(self):
        k, v = self.peek()
        if k == "op" and v == "-":
            self.next()
            return ("neg", self.parse_unary())
        if k == "op" and v == "!":
            self.next()
            return ("not", self.parse_unary())
        return self.parse_atom()

    def parse_atom(self):
        k, v = self.next()
        if k == "num":
            return ("num", v)
        if k == "op" and v == "(":
            node = self.parse_bin(1)
            self.expect_op(")")
            return node
        if k == "name":
            nk, nv = self.peek()
            if nk == "op" and nv == "(":
                self.next()
                args = []
                pk, pv = self.peek()
                if not (pk == "op" and pv == ")"):
                    args.append(self.parse_bin(1))
                    while True:
                        pk, pv = self.peek()
                        if pk == "op" and pv == ",":
                            self.next()
                            args.append(self.parse_bin(1))
                        else:
                            break
                self.expect_op(")")
                return ("call", v, args)
            if v.startswith("v_"):
                return ("var", v[2:])
            return ("name", v)
        raise ExprError("Invalid syntax in variable formula")


def parse(expr: str):
    """Parse an equal/atom-style formula into an AST (parsed once per
    `variable` command; evaluate with eval_ast per sample)."""
    return _Parser(_tokenize(expr)).parse()


def names_in(ast) -> set:
    """All bare names referenced (time/step/x/vx/...)."""
    out = set()

    def walk(n):
        if n[0] == "name":
            out.add(n[1])
        elif n[0] == "var":
            pass
        elif n[0] in ("neg", "not"):
            walk(n[1])
        elif n[0] == "bin":
            walk(n[2])
            walk(n[3])
        elif n[0] == "call":
            for a in n[2]:
                walk(a)
    walk(ast)
    return out


def var_refs(ast) -> set:
    """All v_name references."""
    out = set()

    def walk(n):
        if n[0] == "var":
            out.add(n[1])
        elif n[0] in ("neg", "not"):
            walk(n[1])
        elif n[0] == "bin":
            walk(n[2])
            walk(n[3])
        elif n[0] == "call":
            for a in n[2]:
                walk(a)
    walk(ast)
    return out


# --------------------------------------------------------------------------
# backends
# --------------------------------------------------------------------------

def _mk_backend(m, asnum, fmod, checked: bool):
    """m: module with sin/cos/...; asnum: bool -> 1.0/0.0 (elementwise for
    arrays); checked: raise LAMMPS-style domain errors (host only — array
    and tensor backends do not branch on values)."""
    funcs: Dict[str, Callable] = {
        "sqrt": m.sqrt, "exp": m.exp, "ln": m.log,
        "abs": abs if m is math else m.abs,
        "sin": m.sin, "cos": m.cos, "tan": m.tan,
        "asin": m.asin, "acos": m.acos, "atan": m.atan,
        "atan2": m.atan2, "ceil": m.ceil, "floor": m.floor,
        "log": m.log10,
        "round": round if m is math else m.round,
        "pow": (math.pow if m is math
                else (lambda a, b: m.power(a, b)
                      if hasattr(m, "power") else a ** b)),
        # engine extensions kept for existing decks
        "MIN": min if m is math else m.minimum,
        "MAX": max if m is math else m.maximum,
    }
    return {"funcs": funcs, "asnum": asnum, "fmod": fmod,
            "checked": checked}


_HOST = None
_NUMPY = None
_TORCH: Dict[tuple, dict] = {}


def host_backend():
    global _HOST
    if _HOST is None:
        _HOST = _mk_backend(math, lambda b: 1.0 if b else 0.0,
                            math.fmod, checked=True)
    return _HOST


def numpy_backend():
    global _NUMPY
    if _NUMPY is None:
        import numpy as np
        _NUMPY = _mk_backend(
            np, lambda b: np.where(b, 1.0, 0.0),
            np.fmod, checked=False)
        _NUMPY["funcs"]["round"] = np.round
    return _NUMPY


def torch_backend(dtype=None, device="cpu"):
    """Evaluation on 0-dim tensors of `dtype` (float32 by default) on
    `device`: every number of the formula, and every bare number a
    function is handed, becomes such a tensor (a cached constant, so an
    evaluation copies nothing to the device); comparisons select 1.0 or
    0.0 with torch.where, `%` is torch.fmod, `round` torch.round (half to
    even).  Nothing here reads a value back to the host."""
    import torch

    from ..geometry import const
    dtype = dtype or torch.float32
    dev = torch.device(device)
    key = (dtype, dev)
    if key in _TORCH:
        return _TORCH[key]

    def num(v):
        if isinstance(v, torch.Tensor):
            return v
        return const((float(v),), dtype, dev).reshape(())

    def tensors(fn):
        return lambda *args: fn(*(num(a) for a in args))

    one, zero = num(1.0), num(0.0)
    b = _mk_backend(torch, lambda c: torch.where(num(c) != 0, one, zero),
                    tensors(torch.fmod), checked=False)
    b["funcs"] = {k: tensors(f) for k, f in b["funcs"].items()}
    b["num"] = num
    _TORCH[key] = b
    return b


def eval_ast(ast, env: Dict[str, object], backend,
             resolve_var: Optional[Callable[[str], object]] = None):
    """Evaluate a parsed formula.

    env: bare-name bindings (time, step, dt, PI, per-atom columns...).
    resolve_var: v_name -> value (recursion into other variables)."""
    B = backend
    funcs = B["funcs"]
    asnum = B["asnum"]
    num = B.get("num")

    def truthy(x):
        return x != 0

    def ev(n):
        kind = n[0]
        if kind == "num":
            return num(n[1]) if num is not None else n[1]
        if kind == "name":
            if n[1] in env:
                return env[n[1]]
            raise ExprError(
                f"Invalid thermo keyword '{n[1]}' in variable formula")
        if kind == "var":
            if resolve_var is None:
                raise ExprError(f"Variable {n[1]} referenced but no "
                                "variable resolver bound")
            return resolve_var(n[1])
        if kind == "neg":
            return -ev(n[1])
        if kind == "not":
            return asnum(~truthy(ev(n[1]))
                         if not B["checked"] else not truthy(ev(n[1])))
        if kind == "call":
            name, args = n[1], n[2]
            fn = funcs.get(name)
            if fn is None:
                raise ExprError(
                    f"Invalid math function '{name}' in variable formula")
            vals = [ev(a) for a in args]
            if B["checked"]:
                if name == "sqrt" and vals[0] < 0.0:
                    raise ExprError(
                        "Sqrt of negative value in variable formula")
                if name in ("ln", "log") and vals[0] <= 0.0:
                    raise ExprError(
                        "Log of zero/negative value in variable formula")
            try:
                return fn(*vals)
            except TypeError as e:
                raise ExprError(
                    f"Invalid math function '{name}' in variable "
                    f"formula: {e}") from None
        # binary
        op, a_n, b_n = n[1], n[2], n[3]
        a = ev(a_n)
        b = ev(b_n)
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            if B["checked"] and b == 0.0:
                raise ExprError("Divide by zero in variable formula")
            return a / b
        if op == "%":
            if B["checked"] and b == 0.0:
                raise ExprError("Modulo 0 in variable formula")
            return B["fmod"](a, b)
        if op == "^":
            if B["checked"] and a == 0.0 and b <= 0.0:
                raise ExprError("Invalid power expression in "
                                "variable formula")
            return a ** b
        if op == "==":
            return asnum(a == b)
        if op == "!=":
            return asnum(a != b)
        if op == "<":
            return asnum(a < b)
        if op == "<=":
            return asnum(a <= b)
        if op == ">":
            return asnum(a > b)
        if op == ">=":
            return asnum(a >= b)
        if op == "&&":
            if B["checked"]:
                return asnum(truthy(a) and truthy(b))
            return asnum(truthy(a) & truthy(b))
        if op in ("||", "^|"):
            if B["checked"]:
                if op == "||":
                    return asnum(truthy(a) or truthy(b))
                return asnum(truthy(a) != truthy(b))
            if op == "||":
                return asnum(truthy(a) | truthy(b))
            return asnum(truthy(a) ^ truthy(b))
        raise ExprError(f"Invalid operator '{op}' in variable formula")

    return ev(ast)
