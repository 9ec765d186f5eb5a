"""Kernel route dispatch — the one resolver every ``ops.py`` of the port uses.

``backend`` is the switch on every kernel entry point:

``"torch"``  — the plain PyTorch version (:mod:`ref` of each family); runs
               on any device and is what the kernels are held against.
``"cuda"``   — the hand-written CUDA kernel; a CPU tensor raises.
``"auto"``   — the kernel for a CUDA tensor, the plain version for a CPU
               tensor.

The plain version runs on a CUDA tensor only when asked for by name. No
route falls back to another when a build or a launch fails: the error
propagates.
"""
from __future__ import annotations

import torch

__all__ = ["BACKENDS", "resolve_backend"]

BACKENDS = ("auto", "torch", "cuda")


def resolve_backend(backend: str, x: torch.Tensor) -> str:
    """The route ``"torch"`` or ``"cuda"`` for tensors on ``x``'s device."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "auto":
        return "cuda" if x.is_cuda else "torch"
    if backend == "cuda" and not x.is_cuda:
        raise ValueError(
            f"backend='cuda' needs CUDA tensors, got a tensor on {x.device}")
    return backend
