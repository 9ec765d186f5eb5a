"""The op recorder every static check is built on — the port's counterpart
of the reference's jaxpr walker.

The reference traces a program to a jaxpr and walks its equations. The
port's engines are eager PyTorch loops, so :func:`trace` runs the program
once under a :class:`torch.utils._python_dispatch.TorchDispatchMode` that
sees every ATen op below autograd, and keeps for each op

* every output tensor: its shape, dtype and bytes, and the op's name;
* every Python-float argument, with the floating dtype the op computes in
  — the counterpart of the jaxpr's literals. A small floating constant
  that enters as a tensor (``torch.tensor(1e-38)``, ``torch.from_numpy``
  of a host array) arrives through ``aten.lift_fresh`` and is kept too.

The checks read that record through :func:`collect_values` and
:func:`collect_literals`, and name dims through :func:`symbolize`.

Run at a fixture's small size, the record is the program's: the engines'
shapes do not depend on the data. On the card, the hand-written CUDA
kernels are ctypes calls that the dispatch mode cannot see; their outputs
are still allocated through torch (``aten.empty``) and so are recorded,
with their shapes and dtypes, while what a kernel does inside is not.
Inputs are not recorded: every intermediate is some op's output, as in
the reference, which walks equation outputs only.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "Value",
    "Record",
    "Literal",
    "collect_values",
    "collect_literals",
    "symbolize",
    "trace",
]

# Constants larger than this are data (likelihood tables, edge indices),
# not tuning literals; scanning every element of a big operand would make
# the subnormal check O(input size) for no added signal.
_LITERAL_SCAN_CAP = 64

_LIFT_OPS = ("aten.lift_fresh.default", "aten.lift_fresh_copy.default")


@dataclasses.dataclass(frozen=True)
class Value:
    """One intermediate value of a recorded program."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    prim: str               # producing op

    @property
    def nbytes(self) -> int:
        size = int(np.prod(self.shape)) if self.shape else 1
        return size * self.dtype.itemsize

    def describe(self, dims: dict[str, int] | None = None) -> str:
        shape = symbolize(self.shape, dims) if dims else self.shape
        dt = str(self.dtype).replace("torch.", "")
        return f"{self.prim} -> {shape} [{dt}]"


@dataclasses.dataclass(frozen=True)
class Literal:
    """A float constant of the program: its values as written (float64,
    before any rounding to the dtype) and the dtype the op computes it in,
    which judges it."""

    op: str
    values: np.ndarray
    dtype: torch.dtype


@dataclasses.dataclass
class Record:
    """What :func:`trace` saw: every op output (``values``) and every float
    literal (``literals``)."""

    values: list[Value] = dataclasses.field(default_factory=list)
    literals: list[Literal] = dataclasses.field(default_factory=list)


def _flat(x) -> list:
    """The leaves of an op's arguments or outputs: ATen nests at most one
    list deep (``cat``'s tensors, ``index``'s indices)."""
    if isinstance(x, (list, tuple)):
        return [leaf for item in x for leaf in
                (item if isinstance(item, (list, tuple)) else (item,))]
    return [x]


def _float_dtype(args, kwargs, outs) -> torch.dtype:
    """The floating dtype an op computes its float arguments in: an
    explicit ``dtype=``, else its first floating tensor argument's, else
    its first floating output's, else float32."""
    dt = kwargs.get("dtype")
    if isinstance(dt, torch.dtype) and dt.is_floating_point:
        return dt
    for t in (*args, *outs):
        if isinstance(t, torch.Tensor) and t.dtype.is_floating_point:
            return t.dtype
    return torch.float32


class _Recorder(TorchDispatchMode):
    def __init__(self, record: Record):
        super().__init__()
        self.record = record

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func)
        outs = [t for t in _flat(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self.record.values.append(Value(
                shape=tuple(int(s) for s in t.shape), dtype=t.dtype,
                prim=name))
        flat_args = _flat(args) + _flat(list(kwargs.values()))
        floats = [a for a in flat_args if isinstance(a, float)]
        if floats:
            dt = _float_dtype(flat_args, kwargs, outs)
            self.record.literals.append(Literal(
                name, np.asarray(floats, np.float64), dt))
        if name in _LIFT_OPS:
            for t in outs:
                if t.dtype.is_floating_point \
                        and t.numel() <= _LITERAL_SCAN_CAP:
                    self.record.literals.append(Literal(
                        name, t.detach().cpu().double().numpy(), t.dtype))
        return out


def trace(fn: Callable, *args, **kwargs) -> Record:
    """Run ``fn(*args, **kwargs)`` once under the recorder -> its
    :class:`Record`. The program really runs, on whatever device its
    tensors live."""
    record = Record()
    with _Recorder(record):
        fn(*args, **kwargs)
    return record


def collect_values(record: Record) -> list[Value]:
    """Every op output with its shape, dtype and op."""
    return list(record.values)


def collect_literals(record: Record) -> list[Literal]:
    """Every float literal the program used."""
    return list(record.literals)


def symbolize(shape: tuple[int, ...], dims: dict[str, int]) -> tuple:
    """Map a concrete shape back to fixture symbols: (64, 64, 3) with
    ``dims={"N": 64, "m": 3}`` reads ``("N", "N", "m")``.

    Dims whose size matches no symbol stay concrete ints. Two symbols
    sharing one size would make every report a guess, so ambiguous tables
    are rejected — pick pairwise-distinct fixture sizes instead (T=37
    against N=18 etc.).
    """
    rev: dict[int, str] = {}
    for name, size in dims.items():
        size = int(size)
        if size in rev:
            raise ValueError(
                f"ambiguous symbol table: {rev[size]!r} and {name!r} both "
                f"have size {size}; lint fixtures need pairwise-distinct dims"
            )
        rev[size] = name
    return tuple(rev.get(int(d), int(d)) for d in shape)
