"""ExecutionPlan — the execution knobs of the port's ``run_*`` entry points,
and the device rule they share.

The port's plan carries only the fields its engines support so far:

``backend``     ``"auto"`` | ``"torch"`` | ``"cuda"`` — per-round kernel
                route (:mod:`repro_torch.kernels.dispatch`).
``store``       what the loop keeps; ``None`` keeps the engine's default.
``dst_sorted``  asserts that the runtime's edge index is dst-sorted; the
                entry point checks the claim against the runtime.
``faults``      a :class:`repro_torch.core.faults.FaultModel`, or a
                sequence of them (the grids cross a fault-minor axis);
                ``None`` is the fault-free program.
``async_``      a :class:`repro_torch.core.asyncrony.AsyncModel`, or a
                sequence (the grids cross an async axis, minor-most);
                ``None`` is the synchronous program.
``policy``      the precision policy: a name (``"fp32"``, ``"bf16"``), a
                :class:`repro_torch.core.precision.Policy`, or ``None``
                (the dtype-transparent float32 program).

Each entry point names the fields it honours (:func:`check_plan`): any
other field set away from its default raises ``ValueError``, as the
reference's ``resolve_plan(_supports=...)`` does.

Science knobs (``T``, ``drop_prob``, ``gamma``, ``B``, seeds) stay
parameters of each entry point, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .precision import resolve_policy

__all__ = ["ExecutionPlan", "check_plan", "resolve_device"]


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Frozen bundle of execution knobs shared by every ``run_*`` entry."""

    backend: str = "auto"
    store: str | None = None
    dst_sorted: bool = False
    faults: Any = None
    async_: Any = None
    policy: Any = None

    def replace(self, **kw) -> "ExecutionPlan":
        return dataclasses.replace(self, **kw)


_DEFAULT = ExecutionPlan()


def check_plan(plan: ExecutionPlan | None, entry: str,
               supports: tuple[str, ...]) -> ExecutionPlan:
    """``plan`` (``None`` means the default), after checking that every
    field ``entry`` does not honour keeps its default."""
    plan = _DEFAULT if plan is None else plan
    if plan.policy is not None:
        resolve_policy(plan.policy)     # an unknown name raises here
    for f in dataclasses.fields(ExecutionPlan):
        if f.name in supports:
            continue
        value, default = getattr(plan, f.name), getattr(_DEFAULT, f.name)
        # identity for the model fields: their tensors compare elementwise
        if (value is not None) if default is None else value != default:
            raise ValueError(
                f"{entry}() does not support the plan field {f.name!r} "
                f"(supported: {sorted(supports)})")
    return plan


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller names another device.

    ``None`` means ``"cuda"``; asking for CUDA where there is no card
    raises instead of carrying on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
