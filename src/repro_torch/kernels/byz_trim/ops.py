"""Route dispatch for the Byzantine trim-gather, and the CUDA kernel's
wrapper.

``trim_gather(..., backend=...)`` is the entry point the sparse Byzantine
core calls once per gossip round (routes in
:mod:`repro_torch.kernels.dispatch`); ``trim_gather_pairs`` flattens the
trailing pair axes into the kernel's coordinate axis. The CUDA kernel
(``csrc/byz_trim.cu``) builds a block of receivers' slot table in shared
memory and sorts each (receiver, coordinate)'s slots as ordered keys by a
sorting network in registers, so ``deg_max`` is capped at
:data:`DEG_MAX_CAP`; the wrapper raises above it and never falls back to
the plain version.

``F`` is one trim count for every receiver (a Python int) or an (N,)
int32 tensor on ``r``'s device, receiver j trimming ``F[j]`` from each
end: the scenario grids stack scenarios of different F into one graph. A
tensor F on a CUDA tensor goes to the kernel like an int F does.

Storage dtypes: ``r`` and ``byz_msgs`` are float32, or both bfloat16 or
both float16 (the precision policy's half storage); ``tsum`` and ``kept``
are float32 in every case. The CUDA route accumulates in float32 only: a
half input needs ``accum_dtype=torch.float32``, and any other dtype
raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..dispatch import resolve_backend
from .ref import trim_gather_ref

__all__ = ["trim_gather", "trim_gather_pairs", "trim_gather_cuda",
           "DEG_MAX_CAP"]

DEG_MAX_CAP = 64    # the widest sorting network of the kernel
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
             + [ctypes.c_int, ctypes.c_void_p])
_ARGTYPES_HALF = _ARGTYPES[:16] + [ctypes.c_int, ctypes.c_void_p]
_STORAGE_CODES = {torch.bfloat16: 1, torch.float16: 2}


def trim_gather(
    r: torch.Tensor,          # (N, P) float32
    nbr_idx: torch.Tensor,    # (N, deg_max) int32
    nbr_valid: torch.Tensor,  # (N, deg_max) bool
    byz_msgs: torch.Tensor,   # (N, deg_max, P), any strides
    byz_nbr: torch.Tensor,    # (N, deg_max) bool
    F: int | torch.Tensor,    # int, or (N,) int32 per receiver
    backend: str = "auto",
    *,
    accum_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather + Byzantine substitution + 2F trim -> ``(trimmed_sum (N, P),
    kept (N,))`` in ``accum_dtype`` (``None``: ``r``'s); see :mod:`.ref`
    for the contract."""
    if resolve_backend(backend, r) == "torch":
        return trim_gather_ref(r, nbr_idx, nbr_valid, byz_msgs, byz_nbr, F,
                               accum_dtype)
    if (r.dtype if accum_dtype is None else accum_dtype) != torch.float32:
        raise ValueError(
            f"the CUDA trim-gather accumulates in float32; got storage "
            f"{r.dtype} with accum_dtype={accum_dtype}")
    return trim_gather_cuda(r, nbr_idx, nbr_valid, byz_msgs, byz_nbr, F)


def trim_gather_pairs(
    r: torch.Tensor,          # (N, *pair) — e.g. (N, m, m) or (N, m)
    nbr_idx: torch.Tensor,
    nbr_valid: torch.Tensor,
    byz_msgs: torch.Tensor,   # (N, deg_max, *pair)
    byz_nbr: torch.Tensor,
    F: int | torch.Tensor,
    backend: str = "auto",
    *,
    accum_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pair-shaped wrapper: flattens the trailing pair axes into the
    coordinate axis and restores them on the way out. The flattening of a
    broadcast ``byz_msgs`` stays a view."""
    n = r.shape[0]
    pair = tuple(r.shape[1:])
    dm = nbr_idx.shape[-1]
    tsum, kept = trim_gather(
        r.reshape(n, -1), nbr_idx, nbr_valid, byz_msgs.reshape(n, dm, -1),
        byz_nbr, F, backend, accum_dtype=accum_dtype)
    return tsum.reshape((n,) + pair), kept


def trim_gather_cuda(
    r: torch.Tensor,
    nbr_idx: torch.Tensor,
    nbr_valid: torch.Tensor,
    byz_msgs: torch.Tensor,
    byz_nbr: torch.Tensor,
    F: int | torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA trim-gather kernel on the current stream.

    ``byz_msgs`` may be any view with non-negative strides (a broadcast
    attack's ``expand`` has stride 0); every other tensor must be
    contiguous. A tensor ``F`` is checked for values below 0 once per
    version of the tensor (a read back to the host), so a loop that hands
    the same F over every round pays that once. A receiver with deg <= 2F
    keeps nothing. ``r`` and ``byz_msgs`` are float32, or both bfloat16 or
    both float16; ``tsum`` and ``kept`` are float32.
    ``trim_gather_cuda.launches`` counts the launches,
    ``trim_gather_cuda.launches_tensor_f`` those with a tensor F and
    ``trim_gather_cuda.launches_half`` those on half storage."""
    st = r.dtype
    if st != torch.float32 and st not in _STORAGE_CODES:
        raise ValueError(f"the CUDA trim-gather takes a float32, bfloat16 or "
                         f"float16 storage dtype, got {st}")
    if not r.is_cuda:
        raise ValueError("the CUDA trim-gather needs CUDA tensors")
    if r.dim() != 2 or nbr_idx.dim() != 2:
        raise ValueError("r must be (N, P) and nbr_idx (N, deg_max)")
    n, P = r.shape
    dm = nbr_idx.shape[1]
    if n == 0 or P == 0 or n * P >= 2**31:
        raise ValueError(f"unsupported trim-gather shape N={n}, P={P}")
    if not 1 <= dm <= DEG_MAX_CAP:
        raise ValueError(f"deg_max={dm} is outside the kernel's range "
                         f"[1, {DEG_MAX_CAP}]")
    dev = r.device
    f_recv = None
    if isinstance(F, torch.Tensor):
        _build.check_arg(F, "F", torch.int32, (n,), dev)
        f_recv, F = F, 0
        if getattr(f_recv, "_byz_trim_checked", None) != f_recv._version:
            if int(f_recv.min()) < 0:
                raise ValueError("F must be a non-negative int or (N,) "
                                 "tensor; it holds a negative count")
            f_recv._byz_trim_checked = f_recv._version
    elif not isinstance(F, int) or F < 0:
        raise ValueError(f"F must be a non-negative int or (N,) tensor, "
                         f"got {F!r}")
    _build.check_arg(r, "r", st, (n, P), dev)
    _build.check_arg(nbr_idx, "nbr_idx", torch.int32, (n, dm), dev)
    _build.check_arg(nbr_valid, "nbr_valid", torch.bool, (n, dm), dev)
    _build.check_arg(byz_nbr, "byz_nbr", torch.bool, (n, dm), dev)
    if byz_msgs.device != dev or byz_msgs.dtype != st:
        raise ValueError(f"byz_msgs must be {st} on {dev}, got "
                         f"{byz_msgs.dtype} on {byz_msgs.device}")
    if tuple(byz_msgs.shape) != (n, dm, P):
        raise ValueError(f"byz_msgs has shape {tuple(byz_msgs.shape)}, "
                         f"expected {(n, dm, P)}")
    if min(byz_msgs.stride()) < 0:
        raise ValueError("byz_msgs must have non-negative strides")
    tsum = torch.empty((n, P), dtype=torch.float32, device=dev)
    kept = torch.empty(n, dtype=torch.float32, device=dev)
    args = (r.data_ptr(), nbr_idx.data_ptr(), nbr_valid.data_ptr(),
            byz_msgs.data_ptr(), *byz_msgs.stride(), byz_nbr.data_ptr(),
            tsum.data_ptr(), kept.data_ptr(), n, dm, P, min(F, dm),
            None if f_recv is None else f_recv.data_ptr(), dev.index)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if st == torch.float32:
        fn = _build.function("byz_trim", "byz_trim_f32", _ARGTYPES)
        code = fn(*args, stream)
    else:
        fn = _build.function("byz_trim", "byz_trim_half", _ARGTYPES_HALF)
        code = fn(*args, _STORAGE_CODES[st], stream)
    _build.check_status("byz_trim", code)
    trim_gather_cuda.launches += 1
    trim_gather_cuda.launches_tensor_f += f_recv is not None
    trim_gather_cuda.launches_half += int(st != torch.float32)
    return tsum, kept


trim_gather_cuda.launches = 0
trim_gather_cuda.launches_tensor_f = 0
trim_gather_cuda.launches_half = 0
