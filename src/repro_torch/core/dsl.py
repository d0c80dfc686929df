"""DAnA's Python-embedded DSL (paper §4).

Usage mirrors the paper's snippets::

    from repro_torch.core import dsl as dana

    mo  = dana.model([10])
    inp = dana.input([10])
    out = dana.output()
    lr  = dana.meta(0.3)

    linearR = dana.algo(mo, inp, out)
    s    = dana.sigma(mo * inp, 1)
    er   = s - out
    grad = er * inp
    grad = linearR.merge(grad, 8, "+")
    up   = lr * grad
    mo_up = mo - up
    linearR.setModel(mo_up)
    linearR.setEpochs(10)

Tracing builds the op list eagerly with dimension inference (paper §4.4):
equal shapes -> elementwise; differing ranks -> the lower-rank operand is
logically replicated (right-aligned); equal ranks with a shared suffix ->
outer replication (e.g. [5,10] * [2,10] -> [5,2,10], so sigma(.., axis=2)
yields [5,2] as in the paper's example). Group ops take a 1-based axis
constant. Untyped intermediates become ``inter`` nodes automatically.

Copy of ``repro.core.dsl``, which it is held against; the port imports nothing of ``repro``.
"""
from __future__ import annotations

import contextvars
import math
from typing import Sequence

from repro_torch.core.hdfg import Node

_CURRENT: contextvars.ContextVar["_Builder | None"] = contextvars.ContextVar(
    "dana_builder", default=None
)


class _Builder:
    def __init__(self):
        self.nodes: list[Node] = []
        self.model_ids: list[int] = []
        self.input_ids: list[int] = []
        self.output_ids: list[int] = []
        self.meta_ids: list[int] = []
        self.meta_values: dict[int, float] = {}
        self.merge_id: int | None = None
        self.merge_coef: int | None = None
        self.new_model_ids: list[int] = []
        self.convergence_id: int | None = None
        self.epochs: int | None = None

    def add(self, op, inputs, shape, kind="inter", attrs=None, name=None) -> "Var":
        nid = len(self.nodes)
        self.nodes.append(
            Node(nid, op, tuple(inputs), tuple(shape), kind, attrs or {}, name)
        )
        return Var(self, nid)


def _builder() -> _Builder:
    b = _CURRENT.get()
    if b is None:
        b = _Builder()
        _CURRENT.set(b)
    return b


def reset() -> None:
    """Start a fresh trace (each UDF definition should call this first)."""
    _CURRENT.set(_Builder())


class Var:
    """A DSL value: a handle to an hDFG node."""

    def __init__(self, builder: _Builder, nid: int):
        self._b = builder
        self.nid = nid

    @property
    def shape(self) -> tuple[int, ...]:
        return self._b.nodes[self.nid].shape

    @property
    def kind(self) -> str:
        return self._b.nodes[self.nid].kind

    # -- primary operations (paper Table 1) -----------------------------------
    def _bin(self, other, op):
        other = _as_var(other, self._b)
        shape = _broadcast(self.shape, other.shape)
        return self._b.add(op, [self.nid, other.nid], shape)

    def _rbin(self, other, op):
        other = _as_var(other, self._b)
        shape = _broadcast(other.shape, self.shape)
        return self._b.add(op, [other.nid, self.nid], shape)

    def __add__(self, o):
        return self._bin(o, "add")

    def __radd__(self, o):
        return self._rbin(o, "add")

    def __sub__(self, o):
        return self._bin(o, "sub")

    def __rsub__(self, o):
        return self._rbin(o, "sub")

    def __mul__(self, o):
        return self._bin(o, "mul")

    def __rmul__(self, o):
        return self._rbin(o, "mul")

    def __truediv__(self, o):
        return self._bin(o, "div")

    def __rtruediv__(self, o):
        return self._rbin(o, "div")

    def __gt__(self, o):
        return self._bin(o, "gt")

    def __lt__(self, o):
        return self._bin(o, "lt")

    def __neg__(self):
        return self._b.add("neg", [self.nid], self.shape)


def _as_var(x, b: _Builder) -> Var:
    if isinstance(x, Var):
        return x
    v = b.add("const", [], (), kind="const", attrs={"value": float(x)})
    return v


def _broadcast(a: tuple[int, ...], b: tuple[int, ...]) -> tuple[int, ...]:
    """Paper §4.4 dimension inference (see module docstring)."""
    if a == b:
        return a
    if len(a) != len(b):
        lo, hi = (a, b) if len(a) < len(b) else (b, a)
        # right-aligned replication of the lower-rank operand
        for i in range(1, len(lo) + 1):
            if lo[-i] not in (1, hi[-i]):
                raise ValueError(f"incompatible shapes {a} and {b}")
        return hi
    # equal rank: numpy-style broadcast when dims are compatible (equal or 1)
    if all(x == y or x == 1 or y == 1 for x, y in zip(a, b)):
        return tuple(max(x, y) for x, y in zip(a, b))
    # otherwise: outer replication over the longest common suffix (paper's
    # 'logically replicated' semantics, e.g. [5,10]*[2,10] -> [5,2,10])
    k = 0
    while k < len(a) and a[len(a) - 1 - k] == b[len(b) - 1 - k]:
        k += 1
    suffix = a[len(a) - k :]
    pa, pb = a[: len(a) - k], b[: len(b) - k]
    if not pa or not pb or (k == 0 and len(a) > 1):
        raise ValueError(f"incompatible shapes {a} and {b}")
    return (*pa, *pb, *suffix)


# -- data declarations ---------------------------------------------------------
def _decl(kind: str, dims, name=None, value=None, axes=None) -> Var:
    b = _builder()
    shape = tuple(int(d) for d in (dims or ()))
    attrs = {}
    if value is not None:
        attrs["value"] = value
    if axes is not None:
        axes = tuple(axes)
        if len(axes) != len(shape):
            raise ValueError(
                f"logical axes {axes} do not match declared shape {shape}"
            )
        attrs["logical_axes"] = axes
    v = b.add("leaf", [], shape, kind=kind, attrs=attrs, name=name)
    getattr(b, f"{kind}_ids").append(v.nid)
    if kind == "meta":
        b.meta_values[v.nid] = value
    return v


def model(
    dims: Sequence[int] | None = None,
    name: str | None = None,
    axes: Sequence[str | None] | None = None,
) -> Var:
    """``axes`` declares the parameter's *logical* sharding axes (one name or
    None per dim, e.g. ``("features",)``), resolved by ``repro_torch.dist.meshes``
    when the engine runs with ``shard_model=True``. Undeclared models stay
    replicated."""
    return _decl("model", dims, name, axes=axes)


def input(dims: Sequence[int] | None = None, name: str | None = None) -> Var:  # noqa: A001
    return _decl("input", dims, name)


def output(dims: Sequence[int] | None = None, name: str | None = None) -> Var:
    return _decl("output", dims, name)


def meta(value: float, name: str | None = None) -> Var:
    return _decl("meta", (), name, value=float(value))


# -- non-linear operations -------------------------------------------------------
def _unary(x: Var, op: str) -> Var:
    return x._b.add(op, [x.nid], x.shape)


def sigmoid(x: Var) -> Var:
    return _unary(x, "sigmoid")


def gaussian(x: Var) -> Var:
    return _unary(x, "gaussian")


def sqrt(x: Var) -> Var:
    return _unary(x, "sqrt")


def exp(x: Var) -> Var:
    return _unary(x, "exp")


def sign(x: Var) -> Var:
    return _unary(x, "sign")


def relu(x: Var) -> Var:
    return _unary(x, "relu")


# -- group operations ------------------------------------------------------------
def _group(x: Var, axis: int | None, op: str) -> Var:
    shape = x.shape
    if axis is None:
        out_shape: tuple[int, ...] = ()
        reduced = int(math.prod(shape)) if shape else 1
    else:
        ax = axis - 1  # the paper's axis constants are 1-based
        if not 0 <= ax < len(shape):
            raise ValueError(f"axis {axis} out of range for shape {shape}")
        reduced = shape[ax]
        out_shape = shape[:ax] + shape[ax + 1 :]
    return x._b.add(
        op, [x.nid], out_shape, attrs={"axis": axis, "reduced_size": reduced}
    )


def sigma(x: Var, axis: int | None = None) -> Var:
    """Summation across elements (optionally along a 1-based axis)."""
    return _group(x, axis, "sigma")


def pi(x: Var, axis: int | None = None) -> Var:
    """Product across elements."""
    return _group(x, axis, "pi")


def norm(x: Var, axis: int | None = None) -> Var:
    """Euclidean magnitude."""
    return _group(x, axis, "norm")


# -- algo component ---------------------------------------------------------------
class algo:
    """Links update rule, merge function, and terminator (paper §4.2)."""

    def __init__(self, *vars_: Var):
        self._b = _builder()
        for v in vars_:
            if v.kind not in ("model", "input", "output"):
                raise TypeError("algo() takes model/input/output declarations")

    def merge(self, x: Var, coef, op: str = "+") -> Var:
        b = self._b
        if b.merge_id is not None:
            raise ValueError("only one merge point is supported per UDF")
        coef_val = int(b.meta_values[coef.nid]) if isinstance(coef, Var) else int(coef)
        v = b.add("merge", [x.nid], x.shape, attrs={"op": op, "coef": coef_val})
        b.merge_id = v.nid
        b.merge_coef = coef_val
        return v

    def setModel(self, *updated: Var) -> None:
        self._b.new_model_ids = [v.nid for v in updated]

    def setConvergence(self, cond: Var) -> None:
        self._b.convergence_id = cond.nid

    def setEpochs(self, n: int) -> None:
        self._b.epochs = int(n)


def current_builder() -> _Builder:
    """Internal: the translator grabs the live trace from here."""
    b = _CURRENT.get()
    if b is None:
        raise RuntimeError("no DSL trace in progress")
    return b
