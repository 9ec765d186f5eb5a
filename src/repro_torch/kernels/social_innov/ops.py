"""Route dispatch for the innovation + belief step, and the CUDA kernel's
wrapper.

``innovation_step(..., backend=...)`` is the entry point the Algorithm 3
loop calls once per iteration (routes in
:mod:`repro_torch.kernels.dispatch`). The CUDA kernel
(``csrc/social_innov.cu``): a block copies the rows of A consecutive
agents into shared memory with 16-byte copies and computes them there, A
picked from (m, S) by :func:`staged_agents`. A shape it cannot take, a
failed build or a failed launch raises; nothing falls back to the plain
version.

Storage dtypes: ``z`` and ``mass`` are float32, or both bfloat16 or both
float16 (the precision policy's half storage; ``z_new`` in their dtype,
``mu`` float32); ``u``, ``cdf`` and ``log_tables`` are float32 always.
The CUDA route accumulates in float32 only: a half input needs
``accum_dtype=torch.float32``, and any other dtype raises.

On fake tensors the wrapper is the kernel's shape rule
(:mod:`repro_torch.kernels.dispatch`): the same checks, the tensors the
launch allocates, its counts reported to
:func:`repro_torch.kernels.dispatch.record`; nothing is built or
launched and no launch is counted.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, costs
from ..dispatch import is_fake, record, resolve_backend
from .ref import innovation_ref

__all__ = ["innovation_step", "innovation_cuda", "staged_agents"]

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_ARGTYPES_HALF = _ARGTYPES[:12] + [ctypes.c_int, ctypes.c_void_p]
_STORAGE_CODES = {torch.bfloat16: 1, torch.float16: 2}
SMEM = 48 * 1024            # a block's shared memory without opt-in
SMEM_OPTIN = 227 * 1024     # with it, on sm_90


def staged_agents(m: int, S: int, storage_bytes: int = 4) -> int:
    """Agents a block of the kernel: the largest of 32, 16, ..., 1 whose
    rows fit ``SMEM`` bytes of shared memory, else 1 where one agent's rows
    fit ``SMEM_OPTIN``, else 0 (rows too long for the kernel). A block
    stages z, mass, u, cdf, log_tables, z_new and mu, each region padded to
    16 bytes plus 16 for its alignment phase (``staged_bytes`` in the
    source); z, mass and z_new take ``storage_bytes`` an element."""
    def region(nbytes):
        return (nbytes + 15) // 16 * 16 + 16

    def staged(A):
        sb = storage_bytes
        return (2 * region(sb * A * m) + region(4 * A * m) + region(sb * A)
                + region(4 * A) + region(4 * A * S) + region(4 * A * m * S))

    fits = [A for A in (32, 16, 8, 4, 2, 1) if staged(A) <= SMEM]
    return fits[0] if fits else int(staged(1) <= SMEM_OPTIN)


def innovation_step(
    z: torch.Tensor,           # (N, m) float32
    mass: torch.Tensor,        # (N,)
    u: torch.Tensor,           # (N,)
    cdf: torch.Tensor,         # (N, S)
    log_tables: torch.Tensor,  # (N, m, S)
    backend: str = "auto",
    *,
    accum_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample + gather + accumulate + belief -> ``(z_new, mu)``; the sum
    and ``mu`` in ``accum_dtype`` (``None``: ``z``'s), ``z_new`` in
    ``z``'s dtype."""
    if resolve_backend(backend, z) == "torch":
        return innovation_ref(z, mass, u, cdf, log_tables, accum_dtype)
    if (z.dtype if accum_dtype is None else accum_dtype) != torch.float32:
        raise ValueError(
            f"the CUDA innovation step accumulates in float32; got storage "
            f"{z.dtype} with accum_dtype={accum_dtype}")
    return innovation_cuda(z, mass, u, cdf, log_tables)


def innovation_cuda(
    z: torch.Tensor,
    mass: torch.Tensor,
    u: torch.Tensor,
    cdf: torch.Tensor,
    log_tables: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA innovation kernel on the current stream, with
    :func:`staged_agents` agents a block. ``z`` and ``mass`` are float32,
    or both bfloat16 or both float16: ``z_new`` comes out in their dtype
    and ``mu`` in float32. ``innovation_cuda.launches`` counts the
    launches and ``innovation_cuda.launches_half`` those on half
    storage."""
    st = z.dtype
    if st != torch.float32 and st not in _STORAGE_CODES:
        raise ValueError(f"the CUDA innovation step takes a float32, bfloat16 "
                         f"or float16 storage dtype, got {st}")
    fake = is_fake(z, mass, u, cdf, log_tables)
    if not z.is_cuda and not fake:
        raise ValueError("the CUDA innovation step needs CUDA tensors")
    n, m = z.shape
    S = cdf.shape[-1]
    if n == 0 or m == 0 or S == 0 or n * m * S >= 2**31:
        raise ValueError(f"unsupported innovation shape N={n}, m={m}, S={S}")
    A = staged_agents(m, S, st.itemsize)
    if A == 0:
        raise ValueError(f"rows of m={m}, S={S} do not fit the kernel's "
                         f"shared memory")
    dev = z.device
    _build.check_arg(z, "z", st, (n, m), dev)
    _build.check_arg(mass, "mass", st, (n,), dev)
    _build.check_arg(u, "u", torch.float32, (n,), dev)
    _build.check_arg(cdf, "cdf", torch.float32, (n, S), dev)
    _build.check_arg(log_tables, "log_tables", torch.float32, (n, m, S), dev)
    z_new = torch.empty_like(z)
    mu = torch.empty((n, m), dtype=torch.float32, device=dev)
    if fake:
        record(costs.innovation(n, m, S, st.itemsize))
        return z_new, mu
    args = (z.data_ptr(), mass.data_ptr(), u.data_ptr(), cdf.data_ptr(),
            log_tables.data_ptr(), z_new.data_ptr(), mu.data_ptr(),
            n, m, S, A, dev.index)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if st == torch.float32:
        fn = _build.function("social_innov", "social_innov_f32", _ARGTYPES)
        code = fn(*args, stream)
    else:
        fn = _build.function("social_innov", "social_innov_half",
                             _ARGTYPES_HALF)
        code = fn(*args, _STORAGE_CODES[st], stream)
    _build.check_status("social_innov", code)
    innovation_cuda.launches += 1
    innovation_cuda.launches_half += int(st != torch.float32)
    return z_new, mu


innovation_cuda.launches = 0
innovation_cuda.launches_half = 0
