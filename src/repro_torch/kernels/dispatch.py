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

A ``FakeTensor`` (``torch._subclasses.fake_tensor``: a shape, a dtype and
strides, no memory) takes ``"cuda"`` on any device. The kernel's wrapper
then checks it as it checks a CUDA tensor and answers with its shape rule:
the tensors the launch would allocate (its outputs and workspace, as fake
tensors) and its FLOPs and bytes (:mod:`repro_torch.kernels.costs`, told
to every sink of :func:`recording`), before anything is built or
launched. The dry run (:mod:`repro_torch.launch.dryrun`) traces the model
on such tensors.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator

import torch
from torch._subclasses.fake_tensor import FakeTensor

from .costs import KernelCost

__all__ = ["BACKENDS", "resolve_backend", "is_fake", "sm_count",
           "recording", "record"]

BACKENDS = ("auto", "torch", "cuda")
# the streaming multiprocessors of the card a shape rule plans a launch for
# (an H100 SXM5's 132)
FAKE_SMS = 132


_SINKS: list[Callable[[KernelCost], None]] = []


@contextlib.contextmanager
def recording(sink: Callable[[KernelCost], None]) -> Iterator[None]:
    """Within the block, ``sink(cost)`` hears every launch a shape rule
    answers for."""
    _SINKS.append(sink)
    try:
        yield
    finally:
        _SINKS.remove(sink)


def record(cost: KernelCost) -> None:
    """A shape rule's launch, to every sink of :func:`recording`."""
    for sink in _SINKS:
        sink(cost)


def is_fake(*ts) -> bool:
    """Whether any of ``ts`` is a fake tensor (a shape rule answers)."""
    return any(isinstance(t, FakeTensor) for t in ts)


def sm_count(x: torch.Tensor) -> int:
    """The SMs of ``x``'s card, which a launch plans its grid by; a fake
    tensor's card is an H100 (:data:`FAKE_SMS`)."""
    if is_fake(x):
        return FAKE_SMS
    return torch.cuda.get_device_properties(x.device).multi_processor_count


def resolve_backend(backend: str, x: torch.Tensor) -> str:
    """The route ``"torch"`` or ``"cuda"`` for tensors on ``x``'s device."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "auto":
        return "cuda" if x.is_cuda else "torch"
    if backend == "cuda" and not x.is_cuda and not is_fake(x):
        raise ValueError(
            f"backend='cuda' needs CUDA tensors, got a tensor on {x.device}")
    return backend
