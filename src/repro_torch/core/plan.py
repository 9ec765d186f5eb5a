"""ExecutionPlan — the execution knobs of the port's ``run_*`` entry points,
and the device rule they share.

The port's plan carries only the fields its engines support so far:

``backend``     ``"auto"`` | ``"torch"`` | ``"cuda"`` — per-round kernel
                route (:mod:`repro_torch.kernels.dispatch`).
``store``       what the loop keeps; ``None`` keeps the engine's default.
``dst_sorted``  asserts that the runtime's edge index is dst-sorted; the
                entry point checks the claim against the runtime.

Science knobs (``T``, ``drop_prob``, ``gamma``, ``B``, seeds) stay
parameters of each entry point, as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["ExecutionPlan", "resolve_device"]


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Frozen bundle of execution knobs shared by every ``run_*`` entry."""

    backend: str = "auto"
    store: str | None = None
    dst_sorted: bool = False

    def replace(self, **kw) -> "ExecutionPlan":
        return dataclasses.replace(self, **kw)


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
