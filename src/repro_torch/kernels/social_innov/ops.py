"""Route dispatch for the innovation + belief step, and the CUDA kernel's
wrapper.

``innovation_step(..., backend=...)`` is the entry point the Algorithm 3
loop calls once per iteration (routes in
:mod:`repro_torch.kernels.dispatch`). The CUDA kernel
(``csrc/social_innov.cu``) runs one thread per agent with the row in
registers. A failed build or launch raises; nothing falls back to the
plain version.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..dispatch import resolve_backend
from .ref import innovation_ref

__all__ = ["innovation_step", "innovation_cuda"]

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def innovation_step(
    z: torch.Tensor,           # (N, m) float32
    mass: torch.Tensor,        # (N,)
    u: torch.Tensor,           # (N,)
    cdf: torch.Tensor,         # (N, S)
    log_tables: torch.Tensor,  # (N, m, S)
    backend: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample + gather + accumulate + belief -> ``(z_new, mu)``."""
    if resolve_backend(backend, z) == "torch":
        return innovation_ref(z, mass, u, cdf, log_tables)
    return innovation_cuda(z, mass, u, cdf, log_tables)


def innovation_cuda(
    z: torch.Tensor,
    mass: torch.Tensor,
    u: torch.Tensor,
    cdf: torch.Tensor,
    log_tables: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA innovation kernel on the current stream.
    ``innovation_cuda.launches`` counts the launches."""
    if not z.is_cuda:
        raise ValueError("the CUDA innovation step needs CUDA tensors")
    n, m = z.shape
    S = cdf.shape[-1]
    if n == 0 or m == 0 or S == 0 or n * m * S >= 2**31:
        raise ValueError(f"unsupported innovation shape N={n}, m={m}, S={S}")
    dev = z.device
    _build.check_arg(z, "z", torch.float32, (n, m), dev)
    _build.check_arg(mass, "mass", torch.float32, (n,), dev)
    _build.check_arg(u, "u", torch.float32, (n,), dev)
    _build.check_arg(cdf, "cdf", torch.float32, (n, S), dev)
    _build.check_arg(log_tables, "log_tables", torch.float32, (n, m, S), dev)
    z_new = torch.empty_like(z)
    mu = torch.empty_like(z)
    fn = _build.function("social_innov", "social_innov_f32", _ARGTYPES)
    code = fn(z.data_ptr(), mass.data_ptr(), u.data_ptr(), cdf.data_ptr(),
              log_tables.data_ptr(), z_new.data_ptr(), mu.data_ptr(),
              n, m, S, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_status("social_innov", code)
    innovation_cuda.launches += 1
    return z_new, mu


innovation_cuda.launches = 0
