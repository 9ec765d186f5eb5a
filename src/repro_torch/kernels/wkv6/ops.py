"""Route dispatch for the WKV6 scan of RWKV6 prefill, and the CUDA kernel's
wrapper (the port of ``repro.kernels.wkv6.ops``).

``wkv6(..., backend=...)`` is what prefill and the full forward call once
per layer (routes in :mod:`repro_torch.kernels.dispatch`). On a CPU tensor
it takes the reference's off-TPU choice: the chunked plain version with
chunk ``max(64, T // 32)`` halved until it divides T, and the sequential
scan when that falls below 16. On a CUDA tensor it launches K7
(``csrc/wkv6.cu``, chunk 64) for any T, or raises. K7 is three passes over
groups of :func:`group_chunks` chunks: each group's own state, a scan over
the groups, each group's outputs. Decode needs no kernel:
:func:`.ref.wkv6_decode_step`.

Both routes take the reference's ``(BH, T, K)`` layout, or ``(B, H, T,
K)`` views (``u`` then ``(B, H, K)``, the state ``(B, H, K, V)``), which the
kernel reads through their strides; the model hands over views of its
``(B, S, H, hd)`` projections that way and makes no transposed copy.

Training differentiates through ``wkv6``: on the card, inputs that require
grad under grad mode go through :class:`Wkv6Fn`, whose forward is K7 and
whose backward recomputes the plain chunked scan (:func:`.ref.
wkv6_chunked_ref` at K7's chunk, 64) under autograd and returns its
vector-Jacobian product: the pattern of the JAX package's
``_wkv6_kernel_ad`` (a Pallas forward, a plain chunked backward). The raw
launcher ``wkv6_cuda`` records no graph and raises on such inputs.

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
from ..dispatch import is_fake, record, resolve_backend, sm_count
from .ref import wkv6_chunked_ref, wkv6_ref

__all__ = ["wkv6", "wkv6_cuda", "Wkv6Fn", "HEAD_SIZE", "KERNEL_CHUNK",
           "group_chunks"]

HEAD_SIZE = 64          # K = V: the kernel's tile; RWKV6's published size
KERNEL_CHUNK = 64
MAX_GROUP = 4           # chunks a group of K7's passes, at most
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 10
             + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5
             + [ctypes.c_void_p])


def group_chunks(BH: int, T: int, n_sm: int) -> int:
    """Chunks a group of K7's passes: 4, halved while BH sequences of T
    tokens would give fewer than two blocks an SM. A group's state moves
    through memory four times (16 KB each); its chunks' inputs, about
    80 KB a chunk in bf16, twice. At 4 chunks the state traffic is a
    fifth of the input traffic, at 1 chunk four fifths."""
    n_chunks = -(-T // KERNEL_CHUNK)
    G = MAX_GROUP
    while G > 1 and BH * -(-n_chunks // G) < 2 * n_sm:
        G //= 2
    return G


def _plain_chunk(T: int, chunk: int | None) -> int:
    """The reference's off-TPU chunk: ``max(64, T // 32)`` (or the given
    one), halved until it divides T."""
    c = chunk or max(64, T // 32)
    while T % c:
        c //= 2
    return c


def _flat(*ts):
    """(B, H, ...) tensors as (B * H, ...) (a copy where the strides do not
    merge); (BH, ...) tensors as they are."""
    return [t.reshape((-1,) + tuple(t.shape[2:])) for t in ts]


def wkv6(
    r: torch.Tensor,   # (BH, T, K) or (B, H, T, K)
    k: torch.Tensor,
    v: torch.Tensor,   # (BH, T, V) or (B, H, T, V)
    lw: torch.Tensor,  # like r, float32 log-decay (<= 0)
    u: torch.Tensor,   # (BH, K) or (B, H, K)
    chunk: int | None = None,
    backend: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6 from a zero state -> (y like v in r.dtype, final state
    (..., K, V) float32); see :mod:`.ref` for the math."""
    if resolve_backend(backend, r) == "cuda":
        if chunk not in (None, KERNEL_CHUNK):
            raise ValueError(f"the CUDA kernel runs chunk {KERNEL_CHUNK}, "
                             f"got chunk={chunk}")
        if _needs_graph(r, k, v, lw, u):
            return Wkv6Fn.apply(r, k, v, lw, u, wkv6_cuda)
        return wkv6_cuda(r, k, v, lw, u)
    lead = r.shape[:-2]
    T = r.shape[-2]
    rf, kf, vf, lwf, uf = _flat(r, k, v, lw, u) if r.dim() == 4 else \
        (r, k, v, lw, u)
    c = _plain_chunk(T, chunk)
    if c >= 16:
        y, s = wkv6_chunked_ref(rf, kf, vf, lwf, uf, chunk=c)
    else:
        y, s = wkv6_ref(rf, kf, vf, lwf, uf)
    return y.reshape(lead + y.shape[1:]), s.reshape(lead + s.shape[1:])


def _needs_graph(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class Wkv6Fn(torch.autograd.Function):
    """``forward`` (K7's launcher on the card) for the values; the plain
    chunked scan at chunk 64 recomputed under autograd for the gradients
    of r, k, v, lw and u (through y and the final state). ``forward`` is
    an argument so the CPU tests can put a plain version in the kernel's
    slot."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, forward):
        ctx.save_for_backward(r, k, v, lw, u)
        return forward(r, k, v, lw, u)

    @staticmethod
    def backward(ctx, gy, gs):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in saved]
            flat = _flat(*ins) if ins[0].dim() == 4 else ins
            y, s = wkv6_chunked_ref(*flat, chunk=KERNEL_CHUNK)
            lead = ins[0].shape[:-2]
            outs = (y.reshape(lead + y.shape[1:]),
                    s.reshape(lead + s.shape[1:]))
            want = [t for t, need in zip(ins, ctx.needs_input_grad) if need]
            got = iter(torch.autograd.grad(outs, want, (gy, gs)))
        grads = [next(got) if need else None
                 for need in ctx.needs_input_grad[:5]]
        return (*grads, None)


def _strides3(t: torch.Tensor) -> tuple[int, int, int]:
    """(b, h, t) element strides of a 3-D (BH, T, .) or 4-D (B, H, T, .)
    tensor; a 3-D one is B = BH sequences of one head."""
    if t.dim() == 3:
        return t.stride(0), 0, t.stride(1)
    return t.stride(0), t.stride(1), t.stride(2)


def wkv6_cuda(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lw: torch.Tensor,
    u: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K7 on the current stream -> (y, final state).

    r, k, v: float32 or bfloat16, one dtype; lw and u float32; K = V = 64;
    T >= 1. Each may be any view whose channel axis is contiguous and whose
    other strides are non-negative multiples of 4 elements (u's leading
    strides may be 0, a broadcast). y is a new tensor in r.dtype: contiguous
    for 3-D inputs; for 4-D inputs a (B, H, T, V) view of a contiguous
    (B, T, H, V) tensor, the layout the model reshapes to (B, T, H * V) for
    free. The state is contiguous float32. It records no autograd graph
    and raises on inputs that require grad under grad mode: :func:`wkv6`
    differentiates through K7. ``wkv6_cuda.launches`` counts the
    calls (three kernels each)."""
    fake = is_fake(r, k, v, lw, u)
    if not r.is_cuda and not fake:
        raise ValueError("the CUDA WKV6 kernel needs CUDA tensors")
    if _needs_graph(r, k, v, lw, u):
        raise RuntimeError("the raw K7 launcher has no backward: call "
                           "wkv6(), which differentiates through Wkv6Fn")
    if r.dim() not in (3, 4):
        raise ValueError("r must be (BH, T, K) or (B, H, T, K)")
    lead = tuple(r.shape[:-2])
    T, K = r.shape[-2], r.shape[-1]
    if r.dtype not in _DTYPES:
        raise ValueError(f"r has dtype {r.dtype}; the kernel takes float32 "
                         f"or bfloat16")
    if K != HEAD_SIZE or v.shape[-1] != HEAD_SIZE:
        raise ValueError(f"the kernel takes K = V = {HEAD_SIZE}, got K={K}, "
                         f"V={v.shape[-1]}")
    if T < 1:
        raise ValueError("the kernel needs T >= 1")
    dev = r.device
    for what, t, dtype, shape in (
            ("k", k, r.dtype, lead + (T, K)), ("v", v, r.dtype, lead + (T, K)),
            ("lw", lw, torch.float32, lead + (T, K)),
            ("u", u, torch.float32, lead + (K,))):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{what} must be {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    for what, t in (("r", r), ("k", k), ("v", v), ("lw", lw), ("u", u)):
        if t.stride(-1) != 1 or any(s % 4 or s < 0 for s in t.stride()[:-1]):
            raise ValueError(f"{what} needs a contiguous channel axis and "
                             f"non-negative strides that are multiples of "
                             f"4, got {t.stride()}")
        if not fake and t.data_ptr() % 16:
            raise ValueError(f"{what} must start on a 16-byte boundary")
    if len(lead) == 1:
        B, H = lead[0], 1
        y = torch.empty((B, T, K), dtype=r.dtype, device=dev)
        usb, ush = u.stride(0), 0
    else:
        B, H = lead
        y = torch.empty((B, T, H, K), dtype=r.dtype,
                        device=dev).permute(0, 2, 1, 3)
        usb, ush = u.stride(0), u.stride(1)
    s = torch.empty(lead + (K, K), dtype=torch.float32, device=dev)
    G = group_chunks(B * H, T, sm_count(r))
    n_groups = -(-T // (KERNEL_CHUNK * G))
    if B * H * max(n_groups, 16) > 2**31 - 1:
        raise ValueError(f"too many sequences for one launch: {B * H}")
    # each group's own state, then its start state (pass 2 in place), and
    # its total decay
    ds = torch.empty((B * H * n_groups, K, K), dtype=torch.float32,
                     device=dev)
    decay = torch.empty((B * H * n_groups, K), dtype=torch.float32,
                        device=dev)
    if fake:
        record(costs.wkv6(
            B * H, T, r.element_size(), G, costs.distinct_bytes(u)
            // (4 * K)))
        return y, s
    strides = (ctypes.c_longlong * 15)(
        *(x for t in (r, k, v, lw, y) for x in _strides3(t)))
    fn = _build.function("wkv6", "wkv6", _ARGTYPES)
    code = fn(_DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
              lw.data_ptr(), u.data_ptr(), y.data_ptr(), s.data_ptr(),
              ds.data_ptr(), decay.data_ptr(), ctypes.addressof(strides),
              usb, ush, B, H, T, G, dev.index,
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check_status("wkv6", code)
    wkv6_cuda.launches += 1
    return y, s


wkv6_cuda.launches = 0
