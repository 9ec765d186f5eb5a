"""Route dispatch for the push-sum edge scatter, and the CUDA kernel's
wrapper.

``edge_scatter(..., backend=...)`` is the entry point the sparse push-sum
step calls once per round (routes in :mod:`repro_torch.kernels.dispatch`).
The CUDA kernels (``csrc/edge_scatter.cu``) sum each receiver's run of a
dst-sorted edge index through its CSR offsets, in edge order: the
edge-tiled kernel for D <= ``TILED_D_MAX`` columns (the engines), the
column walk above (the training aggregator's 2^24-column passes). The
engines hoist the offsets out of the loop (:func:`repro_torch.core.social.
social_runtime_from_edge_list`). Given no offsets, the wrapper derives them
from ``dst`` and raises on an unsorted index: it never sorts silently and
never falls back to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..dispatch import resolve_backend
from .ref import edge_scatter_ref

__all__ = ["edge_scatter", "edge_scatter_cuda", "dst_offsets",
           "TILED_D_MAX"]

TILED_D_MAX = 32    # the widest D the edge-tiled kernel takes
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ARGTYPES_HALF = _ARGTYPES[:11] + [ctypes.c_int, ctypes.c_void_p]
# the half storage dtypes the kernels take, by their code in the C entry
_STORAGE_CODES = {torch.bfloat16: 1, torch.float16: 2}


def edge_scatter(
    sigma: torch.Tensor,   # (n_src, D) float32 source rows
    rho: torch.Tensor,     # (E, D) float32
    live: torch.Tensor,    # (E,) bool
    src: torch.Tensor,     # (E,) int32 source row per edge
    dst: torch.Tensor,     # (E,) int32 receiver per edge
    backend: str = "auto",
    *,
    offsets: torch.Tensor | None = None,   # (N+1,) int32 CSR offsets of dst
    n_recv: int | None = None,
    shards: int = 1,
    accum_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mask-latch + per-receiver increment sum -> ``(rho_new, recv)``.

    The source rows need not be the receivers: ``n_recv`` (default
    ``sigma``'s rows, or ``offsets``' length - 1) is the receiver count,
    and the async engines pass the per-edge snapshot (E, D) as ``sigma``
    with the identity ``src``. ``shards`` > 1 declares the receivers to
    be ``shards`` blocks of slots, one per edge shard of an emulated graph
    axis, over the ``n_recv / shards`` source rows
    (:func:`repro_torch.core.pushsum.partitioned_edges`). ``accum_dtype``
    is the dtype of ``recv`` (``None``: ``rho``'s)."""
    if n_recv is None:
        n_recv = (sigma.shape[0] if offsets is None
                  else offsets.numel() - 1)
    if resolve_backend(backend, sigma) == "torch":
        return edge_scatter_ref(sigma, rho, live, src, dst, n_recv=n_recv,
                                accum_dtype=accum_dtype)
    if (rho.dtype if accum_dtype is None else accum_dtype) != torch.float32:
        raise ValueError(
            f"the CUDA edge scatter accumulates in float32; got storage "
            f"{rho.dtype} with accum_dtype={accum_dtype}")
    if offsets is None:
        offsets = dst_offsets(dst, n_recv)
    return edge_scatter_cuda(sigma, rho, live, src, offsets, shards=shards)


def dst_offsets(dst: torch.Tensor, n: int) -> torch.Tensor:
    """(N+1,) int32 CSR offsets of a dst-sorted edge index on ``dst``'s
    device. Raises on an unsorted or out-of-range ``dst``; reads two flags
    back to the host, so callers in a loop hoist it."""
    if dst.numel() and not bool(
            (dst[1:] >= dst[:-1]).all() & (dst[0] >= 0) & (dst[-1] < n)):
        raise ValueError("the CUDA edge scatter needs a dst-sorted edge "
                         "index with 0 <= dst < N (see graphs.sort_by_dst)")
    grid = torch.arange(n + 1, dtype=dst.dtype, device=dst.device)
    return torch.searchsorted(dst, grid, side="left").to(torch.int32)


def edge_scatter_cuda(
    sigma: torch.Tensor,
    rho: torch.Tensor,
    live: torch.Tensor,
    src: torch.Tensor,
    offsets: torch.Tensor,
    *,
    tiled: bool | None = None,
    shards: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch a CUDA edge-scatter kernel on the current stream.

    ``offsets`` must be the CSR offsets of the dst-sorted index the edges
    are laid out in; their length - 1 is the receiver count, and ``sigma``
    holds the (n_src, D) source rows ``src`` indexes (the nodes, or the
    async engines' per-edge snapshot). ``tiled`` picks the kernel: the edge-tiled one (D <=
    ``TILED_D_MAX``) or the column walk; ``None`` takes the tiled one
    wherever it can. Both give the same result bit for bit.
    ``edge_scatter_cuda.launches`` counts the launches,
    ``edge_scatter_cuda.launches_tiled`` those of the tiled kernel and
    ``edge_scatter_cuda.launches_edge_rows`` those whose source rows are
    not the receivers (the async delivery's per-edge snapshot), and
    ``edge_scatter_cuda.launches_sharded`` those whose receivers are the
    slots of ``shards`` > 1 edge shards of the source rows (an emulated
    graph axis: ``n = shards * n_src``).

    ``sigma`` and ``rho`` are float32, or both bfloat16 or both float16:
    ``rho_new`` comes out in their dtype and ``recv`` in float32 in every
    case. ``edge_scatter_cuda.launches_half`` counts the launches on half
    storage."""
    st = sigma.dtype
    if st != torch.float32 and st not in _STORAGE_CODES:
        raise ValueError(f"the CUDA edge scatter takes a float32, bfloat16 "
                         f"or float16 storage dtype, got {st}")
    if not sigma.is_cuda:
        raise ValueError("the CUDA edge scatter needs CUDA tensors")
    n_src, D = sigma.shape
    n = offsets.numel() - 1
    E = rho.shape[0]
    if n < 1 or D == 0 or max(n, n_src, E) * D >= 2**31:
        raise ValueError(f"unsupported edge-scatter shape N={n}, "
                         f"n_src={n_src}, E={E}, D={D}")
    if shards > 1 and n != shards * n_src:
        raise ValueError(f"{shards} shards of {n_src} source rows need "
                         f"{shards * n_src} receivers, got {n}")
    dev = sigma.device
    _build.check_arg(sigma, "sigma", st, (n_src, D), dev)
    _build.check_arg(rho, "rho", st, (E, D), dev)
    _build.check_arg(live, "live", torch.bool, (E,), dev)
    _build.check_arg(src, "src", torch.int32, (E,), dev)
    _build.check_arg(offsets, "offsets", torch.int32, (n + 1,), dev)
    if tiled is None:
        tiled = D <= TILED_D_MAX
    elif tiled and D > TILED_D_MAX:
        raise ValueError(f"the edge-tiled kernel takes D <= {TILED_D_MAX}, "
                         f"got D={D}")
    rho_new = torch.empty_like(rho)
    recv = torch.empty((n, D), dtype=torch.float32, device=dev)
    ptrs = (sigma.data_ptr(), rho.data_ptr(), live.data_ptr(),
            src.data_ptr(), offsets.data_ptr(), rho_new.data_ptr(),
            recv.data_ptr(), n, D, int(tiled), dev.index)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if st == torch.float32:
        fn = _build.function("edge_scatter", "edge_scatter_f32", _ARGTYPES)
        code = fn(*ptrs, stream)
    else:
        fn = _build.function("edge_scatter", "edge_scatter_half",
                             _ARGTYPES_HALF)
        code = fn(*ptrs, _STORAGE_CODES[st], stream)
    _build.check_status("edge_scatter", code)
    edge_scatter_cuda.launches += 1
    edge_scatter_cuda.launches_half += int(st != torch.float32)
    edge_scatter_cuda.launches_tiled += int(tiled)
    edge_scatter_cuda.launches_edge_rows += int(shards == 1 and n_src != n)
    edge_scatter_cuda.launches_sharded += int(shards > 1)
    return rho_new, recv


edge_scatter_cuda.launches = 0
edge_scatter_cuda.launches_sharded = 0
edge_scatter_cuda.launches_tiled = 0
edge_scatter_cuda.launches_edge_rows = 0
edge_scatter_cuda.launches_half = 0
