"""Precision-policy statics: the reduced-precision carry contract.

Under a bf16 or fp16 storage policy no engine may carry persistent
per-node or per-edge float32 state from round to round. A single float32
(E, d) relay latch or (N, d) value column smuggled through the loop
silently forfeits the storage-bandwidth win the policy exists for (the
loop re-reads and re-writes it every round at full width). Accumulators
are *supposed* to be float32 — but they are transients of a round, not
state that survives it, which is exactly the line this check draws.

The reference reads the carry off its ``lax.scan``. The port's engines
are Python loops, so the carry is found in two steps:

* :func:`loop_carries` reads the engine's round loop (the first ``for _
  in range(...)`` of its source) and names the variables its body reads
  before it assigns them, and assigns: the state one round hands the next;
* :func:`carried_state` runs the engine once and takes those variables'
  values as the loop left them, from the function's frame as it returns.

:func:`find_fp32_carries` then flags every floating tensor of itemsize
>= 4 among them (NamedTuples of tensors included) that has a dimension of
a population size (N or E by default).

The reference's second proof, that a donating step aliases its state
buffers, has no counterpart: the port's step returns fresh tensors and
torch has no buffer donation.
"""
from __future__ import annotations

import ast
import inspect
import sys
import textwrap
from typing import Any, Callable

import torch

from .dense import Finding
from .walk import symbolize

__all__ = ["loop_carries", "carried_state", "find_fp32_carries"]


def _names(node, ctx) -> list[str]:
    return [n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ctx)]


def _visit(stmts, assigned: set, written: set, carries: list) -> set:
    """Walk ``stmts`` in execution order: a name read while not yet
    written in this round is carried in. Returns the names surely written
    by the end (a branch counts only what both arms write; a nested loop
    body, which may not run, counts nothing)."""
    written = set(written)

    def read(node):
        names = _names(node, ast.Load) if node is not None else []
        for name in names:
            if name in assigned and name not in written \
                    and name not in carries:
                carries.append(name)

    for stmt in stmts:
        if isinstance(stmt, ast.If):
            read(stmt.test)
            body = _visit(stmt.body, assigned, written, carries)
            orelse = _visit(stmt.orelse, assigned, written, carries)
            written |= body & orelse
        elif isinstance(stmt, (ast.For, ast.While)):
            read(stmt.iter if isinstance(stmt, ast.For) else stmt.test)
            inner = set(written)
            if isinstance(stmt, ast.For):
                inner.update(_names(stmt.target, ast.Store))
            _visit(stmt.body, assigned, inner, carries)
            _visit(stmt.orelse, assigned, written, carries)
        elif isinstance(stmt, (ast.With, ast.Try)):
            for item in getattr(stmt, "items", ()):
                read(item.context_expr)
            written |= _visit(stmt.body, assigned, written, carries)
        else:
            read(stmt)
            if isinstance(stmt, ast.AugAssign) \
                    and isinstance(stmt.target, ast.Name):
                read(ast.Name(stmt.target.id, ast.Load()))
            written.update(_names(stmt, ast.Store))
    return written


def loop_carries(fn: Callable) -> tuple[str, ...]:
    """The variables ``fn``'s round loop carries: assigned in its body and
    read there, in execution order, before any assignment in the same
    round — in order of first read."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    loop = next((n for n in ast.walk(tree) if isinstance(n, ast.For)
                 and isinstance(n.iter, ast.Call)
                 and isinstance(n.iter.func, ast.Name)
                 and n.iter.func.id == "range"), None)
    if loop is None:
        raise ValueError(f"{fn.__qualname__} has no `for _ in range(...)` "
                         "round loop")
    assigned = {n for stmt in loop.body for n in _names(stmt, ast.Store)}
    carries: list[str] = []
    _visit(loop.body, assigned, set(_names(loop.target, ast.Store)), carries)
    return tuple(carries)


def carried_state(fn: Callable, run: Callable[[], Any]) -> dict[str, Any]:
    """Run ``run()`` (which calls ``fn``) and return the values of
    ``fn``'s loop carries as its last call left them, read from its frame
    as it returns (``sys.monitoring``, on ``fn``'s code object alone)."""
    names = loop_carries(fn)
    code = fn.__code__
    seen: dict[str, Any] = {}
    mon = sys.monitoring
    tool = next((i for i in range(6) if mon.get_tool(i) is None), None)
    if tool is None:
        raise RuntimeError("no free sys.monitoring tool id")

    def on_return(ret_code, offset, value):
        local = sys._getframe(1).f_locals
        seen.clear()
        seen.update({n: local[n] for n in names if n in local})

    mon.use_tool_id(tool, "repro_torch.statics")
    try:
        mon.register_callback(tool, mon.events.PY_RETURN, on_return)
        mon.set_local_events(tool, code, mon.events.PY_RETURN)
        run()
    finally:
        mon.set_local_events(tool, code, 0)
        mon.register_callback(tool, mon.events.PY_RETURN, None)
        mon.free_tool_id(tool)
    if not seen and names:
        raise RuntimeError(f"{fn.__qualname__} was not called by run()")
    return seen


def _leaves(name: str, value) -> list[tuple[str, torch.Tensor]]:
    if isinstance(value, torch.Tensor):
        return [(name, value)]
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return [leaf for f in value._fields
                for leaf in _leaves(f"{name}.{f}", getattr(value, f))]
    if isinstance(value, (tuple, list)):
        return [leaf for i, v in enumerate(value)
                for leaf in _leaves(f"{name}[{i}]", v)]
    return []


def find_fp32_carries(
    carried: dict[str, Any],
    dims: dict[str, int],
    *,
    axes: tuple[str, ...] = ("N", "E"),
    where: str = "",
) -> list[Finding]:
    """Report carried floating state of itemsize >= 4 with ANY dimension
    of a population size (``axes`` of ``dims``). Integer, bool and key
    carries pass, as do scalar and small floats."""
    pop = {int(dims[a]) for a in axes if a in dims}
    out: list[Finding] = []
    for name, value in carried.items():
        for leaf, t in _leaves(name, value):
            if not t.dtype.is_floating_point or t.dtype.itemsize < 4:
                continue
            if not any(int(s) in pop for s in t.shape):
                continue
            dt = str(t.dtype).replace("torch.", "")
            out.append(Finding(
                check="fp32-carry", where=where or leaf,
                message=(
                    f"the round loop carries {leaf}, persistent {dt} state "
                    f"of shape {symbolize(tuple(t.shape), dims)}, under a "
                    "reduced-precision storage policy — carried state must "
                    "be in the policy's storage dtype (float32 belongs to "
                    "a round's accumulators only)"
                ),
            ))
    return out
