"""Route dispatch for the coordinate-wise trimmed mean, and the CUDA
kernel's wrapper (the port of ``repro.kernels.trimmed_mean.ops``).

``trimmed_mean(x, F, backend=...)`` is what every trimmed aggregator of
training calls, once per trim (routes in :mod:`repro_torch.kernels.
dispatch`). On a CUDA tensor it launches K4 (``csrc/trimmed_mean.cu``) for
W <= 64 workers, or raises; the plain version runs on the card only when
``backend="torch"`` is asked for.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..dispatch import resolve_backend
from .ref import trimmed_mean_ref

__all__ = ["trimmed_mean", "trimmed_mean_pytree", "trimmed_mean_cuda",
           "W_MAX"]

W_MAX = 64          # the kernel's largest register array of worker values
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p]


def trimmed_mean(x: torch.Tensor, F: int, backend: str = "auto", *,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """Coordinate-wise trimmed mean over the leading worker axis: x (W, D)
    float32 -> (D,). ``out`` (CUDA route only) is a (D,) float32 tensor
    to write into."""
    if resolve_backend(backend, x) == "cuda":
        return trimmed_mean_cuda(x, F, out=out)
    if out is not None:
        raise ValueError("out= is taken by the CUDA route only")
    return trimmed_mean_ref(x, F)


def trimmed_mean_pytree(stacked, F: int, *, backend: str = "auto"):
    """stacked: a list or dict of (W, ...) per-worker leaves.

    Every leaf is flattened to (W, -1) in float32 and the leaves are
    concatenated, so the trim runs once over one (W, D_total) matrix; each
    output leaf comes back in its own input dtype, as in the reference."""
    leaves = list(stacked.values()) if isinstance(stacked, dict) \
        else list(stacked)
    W = leaves[0].shape[0]
    big = torch.cat([leaf.reshape(W, -1).float() for leaf in leaves], dim=1)
    flat = trimmed_mean(big, F, backend=backend)
    outs, off = [], 0
    for leaf in leaves:
        n = leaf[0].numel()
        outs.append(flat[off:off + n].reshape(leaf.shape[1:]).to(leaf.dtype))
        off += n
    if isinstance(stacked, dict):
        return dict(zip(stacked.keys(), outs))
    return type(stacked)(outs)


def trimmed_mean_cuda(x: torch.Tensor, F: int, *,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch K4 on the current stream -> (D,) float32.

    x: (W, D) float32 on the card, 1 <= W <= 64, W > 2F, with a unit
    column stride and any row stride >= D (a column range of a larger
    buffer needs no copy). ``out``: an optional contiguous (D,) float32
    tensor on x's device. ``trimmed_mean_cuda.launches`` counts the
    launches."""
    if not x.is_cuda:
        raise ValueError("the CUDA trimmed mean needs CUDA tensors")
    if x.dim() != 2:
        raise ValueError(f"x must be (W, D), got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"x has dtype {x.dtype}; the kernel takes float32")
    W, D = x.shape
    F = int(F)
    if F < 0 or W <= 2 * F:
        raise ValueError(f"need W > 2F, got W={W}, F={F}")
    if W > W_MAX:
        raise ValueError(f"the kernel takes at most {W_MAX} workers, got {W}")
    if D < 1:
        raise ValueError("the kernel needs D >= 1")
    ld = x.stride(0) if W > 1 else D
    if x.stride(1) != 1 or ld < D:
        raise ValueError(f"x needs a unit column stride and a row stride >= "
                         f"D, got strides {x.stride()}")
    dev = x.device
    if out is None:
        out = torch.empty(D, dtype=torch.float32, device=dev)
    else:
        _build.check_arg(out, "out", torch.float32, (D,), dev)
    fn = _build.function("trimmed_mean", "trimmed_mean_f32", _ARGTYPES)
    code = fn(x.data_ptr(), ld, D, W, F, out.data_ptr(), dev.index,
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check_status("trimmed_mean", code)
    trimmed_mean_cuda.launches += 1
    return out


trimmed_mean_cuda.launches = 0
