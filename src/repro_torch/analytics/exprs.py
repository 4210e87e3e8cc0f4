"""Column expression DSL — the serialisable predicate/projection
language of SAGE's function-shipping contract (paper §3.2.1: shipped
computations are descriptions, not code).

Pushdown must not ship Python closures: a fragment that runs *at the
store* is described entirely by a JSON-able spec so the storage-side
executor can rebuild it without trusting caller bytecode (and so the
plan is printable, and the cost model can estimate predicate
selectivity by walking the same spec).  ``col(i)`` and ``lit(v)`` build
small ASTs with numpy operator overloading:

    pred = (col(1) > 0.5) & (col(0) % 2 == 0)
    keep = pred(rows)          # (n,) bool over a (n, ncols) array

Boolean composition uses ``&``/``|``/``~`` (like numpy/pandas, since
``and``/``or`` cannot be overloaded).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np

_BINOPS: Dict[str, Callable[[Any, Any], Any]] = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "%": lambda a, b: a % b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "&": lambda a, b: a & b,
    "|": lambda a, b: a | b,
}


class Expr:
    """Base expression node; evaluates against a (rows, ncols) array."""

    def __call__(self, rows: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def to_spec(self) -> Dict:
        raise NotImplementedError

    def columns(self) -> set:
        """Column indices this expression reads (stats collection and
        selectivity estimation introspect the AST through this)."""
        return set()

    # -- operator overloading builds the AST --

    def _bin(self, op: str, other, flip: bool = False) -> "Expr":
        other = other if isinstance(other, Expr) else Lit(other)
        return BinOp(op, other, self) if flip else BinOp(op, self, other)

    def __add__(self, o):  return self._bin("+", o)          # noqa: E704
    def __radd__(self, o): return self._bin("+", o, True)    # noqa: E704
    def __sub__(self, o):  return self._bin("-", o)          # noqa: E704
    def __rsub__(self, o): return self._bin("-", o, True)    # noqa: E704
    def __mul__(self, o):  return self._bin("*", o)          # noqa: E704
    def __rmul__(self, o): return self._bin("*", o, True)    # noqa: E704
    def __truediv__(self, o):  return self._bin("/", o)      # noqa: E704
    def __rtruediv__(self, o): return self._bin("/", o, True)  # noqa: E704
    def __mod__(self, o):  return self._bin("%", o)          # noqa: E704
    def __gt__(self, o):   return self._bin(">", o)          # noqa: E704
    def __ge__(self, o):   return self._bin(">=", o)         # noqa: E704
    def __lt__(self, o):   return self._bin("<", o)          # noqa: E704
    def __le__(self, o):   return self._bin("<=", o)         # noqa: E704
    def __eq__(self, o):   return self._bin("==", o)         # noqa: E704
    def __ne__(self, o):   return self._bin("!=", o)         # noqa: E704
    def __and__(self, o):  return self._bin("&", o)          # noqa: E704
    def __or__(self, o):   return self._bin("|", o)          # noqa: E704
    def __invert__(self):  return Not(self)                  # noqa: E704

    __hash__ = None


class Col(Expr):
    def __init__(self, i: int):
        self.i = int(i)

    def __call__(self, rows: np.ndarray) -> np.ndarray:
        return rows[:, self.i]

    def to_spec(self) -> Dict:
        return {"t": "col", "i": self.i}

    def columns(self) -> set:
        return {self.i}

    def __repr__(self):
        return f"col({self.i})"


class Lit(Expr):
    def __init__(self, v):
        self.v = v

    def __call__(self, rows: np.ndarray):
        return self.v

    def to_spec(self) -> Dict:
        # numpy scalars (e.g. arr.max()) coerce to plain Python so the
        # spec stays JSON-able and selectivity-estimable
        v = self.v.item() if isinstance(self.v, np.generic) else self.v
        return {"t": "lit", "v": v}

    def __repr__(self):
        return repr(self.v)


class BinOp(Expr):
    def __init__(self, op: str, l: Expr, r: Expr):
        if op not in _BINOPS:
            raise ValueError(f"unknown operator {op!r}")
        self.op, self.l, self.r = op, l, r

    def __call__(self, rows: np.ndarray) -> np.ndarray:
        return _BINOPS[self.op](self.l(rows), self.r(rows))

    def to_spec(self) -> Dict:
        return {"t": "bin", "op": self.op, "l": self.l.to_spec(),
                "r": self.r.to_spec()}

    def columns(self) -> set:
        return self.l.columns() | self.r.columns()

    def __repr__(self):
        return f"({self.l!r} {self.op} {self.r!r})"


class Not(Expr):
    def __init__(self, e: Expr):
        self.e = e

    def __call__(self, rows: np.ndarray) -> np.ndarray:
        return ~self.e(rows)

    def to_spec(self) -> Dict:
        return {"t": "not", "e": self.e.to_spec()}

    def columns(self) -> set:
        return self.e.columns()

    def __repr__(self):
        return f"~{self.e!r}"


def col(i: int) -> Col:
    """Reference column ``i`` of the dataset's row array."""
    return Col(i)


def lit(v) -> Lit:
    return Lit(v)


def from_spec(spec: Dict) -> Expr:
    """Rebuild an Expr from its JSON-able spec (the storage-side half of
    pushdown: fragments travel as specs, never as closures)."""
    t = spec["t"]
    if t == "col":
        return Col(spec["i"])
    if t == "lit":
        return Lit(spec["v"])
    if t == "bin":
        return BinOp(spec["op"], from_spec(spec["l"]), from_spec(spec["r"]))
    if t == "not":
        return Not(from_spec(spec["e"]))
    raise ValueError(f"bad expr spec {spec!r}")


def as_expr(x) -> Expr:
    """Coerce a column index or Expr into an Expr."""
    if isinstance(x, Expr):
        return x
    if isinstance(x, (int, np.integer)):
        return Col(int(x))
    raise TypeError(f"expected column index or Expr, got {type(x).__name__}")
