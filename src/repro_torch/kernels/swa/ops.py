"""Route dispatch for the two attention kernels of the serve path, and the
CUDA kernels' wrappers.

``attn_decode(..., backend=...)`` is what every decode step calls once per
layer, ``swa_prefill(..., backend=...)`` what prefill calls once per layer
(routes in :mod:`repro_torch.kernels.dispatch`). The CUDA kernels take
float32 or bfloat16 and head sizes 64, 128 and 256; the wrappers raise on
anything else and never fall back to the plain versions.

K5 is two kernels in ``csrc/attn_decode.cu``, picked in the open by
:func:`decode_kernel`: bf16 (every launch of the serve path) runs on the
tensor cores in one launch (``attn_decode_tc``: cp.async-staged K/V tiles,
the splits merged by the last block of each (request, KV head)); float32
on the split and combine kernels.

K6 is two kernels in ``csrc/swa_prefill.cu``, picked in the open by
:func:`prefill_kernel`: bf16 at head sizes 64 and 128 (every launch of the
serve and training paths) runs on the tensor cores (``swa_prefill_tc``:
wgmma fed by TMA), float32, and bf16 at 256, on the FMA pipes. A failure
of either raises; neither stands in for the other.

Training differentiates through ``swa_prefill``: on the card, inputs that
require grad under grad mode go through :class:`SwaPrefillFn`, whose
forward is K6 and whose backward recomputes the plain attention
(:func:`.ref.swa_prefill_ref`) and returns its vector-Jacobian product.
The JAX package has no attention backward kernel either (it trains through
autodiff of its plain attention). The raw launcher ``swa_prefill_cuda``
records no graph, so it raises on such inputs instead of cutting the
attention out of the gradient.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..dispatch import resolve_backend
from .ref import attn_decode_ref, swa_prefill_ref

__all__ = ["attn_decode", "attn_decode_cuda", "swa_prefill",
           "swa_prefill_cuda", "SwaPrefillFn", "HEAD_DIMS", "TC_HEAD_DIMS",
           "prefill_kernel", "tma_strides", "decode_kernel",
           "decode_splits", "DECODE_MAX_GROUP"]

HEAD_DIMS = (64, 128, 256)
DECODE_MAX_GROUP = 16        # query heads per KV head the decode kernels take
TC_HEAD_DIMS = (64, 128)     # the tensor-core prefill kernel's head sizes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the decode kernel's split blocks aim at about this many blocks in all
_DECODE_BLOCKS = 1024
_DECODE_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DECODE_TC_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DECODE_TILE = 64           # cache rows a tile of the tensor-core decode
# each (device, stream)'s zeroed ticket counters of the tensor-core decode:
# the merging block of every (request, KV head) resets its own to 0
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}
_PREFILL_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                     + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 6
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_PREFILL_TC_ARGTYPES = _PREFILL_ARGTYPES[1:]


def attn_decode(
    q: torch.Tensor,        # (B, H, dh)
    k: torch.Tensor,        # (B, Hkv, Wc, dh)
    v: torch.Tensor,        # (B, Hkv, Wc, dh)
    lengths: torch.Tensor,  # (B,) int32
    backend: str = "auto",
    scale: float | None = None,
) -> torch.Tensor:
    """Single-token GQA attention over a KV cache -> (B, H, dh); see
    :func:`.ref.attn_decode_ref` for the contract."""
    if resolve_backend(backend, q) == "torch":
        return attn_decode_ref(q, k, v, lengths, scale)
    return attn_decode_cuda(q, k, v, lengths, scale)


def swa_prefill(
    q: torch.Tensor,   # (B, S, H, dh)
    k: torch.Tensor,   # (B, S, Hkv, dh)
    v: torch.Tensor,   # (B, S, Hkv, dh)
    window: int = 0,
    backend: str = "auto",
    scale: float | None = None,
) -> torch.Tensor:
    """Causal (sliding-window when ``window > 0``) GQA attention ->
    (B, S, H, dh); see :func:`.ref.swa_prefill_ref` for the contract."""
    if resolve_backend(backend, q) == "torch":
        return swa_prefill_ref(q, k, v, window, scale)
    if _needs_graph(q, k, v):
        return SwaPrefillFn.apply(q, k, v, window, scale, swa_prefill_cuda)
    return swa_prefill_cuda(q, k, v, window, scale)


def _needs_graph(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class SwaPrefillFn(torch.autograd.Function):
    """``forward`` (K6's launcher on the card) for the values; the plain
    attention recomputed under autograd for the gradients. ``forward`` is
    an argument so the CPU tests can put the plain version in the kernel's
    slot."""

    @staticmethod
    def forward(ctx, q, k, v, window, scale, forward):
        ctx.save_for_backward(q, k, v)
        ctx.window, ctx.scale = window, scale
        return forward(q, k, v, window, scale)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in saved]
            out = swa_prefill_ref(*ins, ctx.window, ctx.scale)
            want = [t for t, need in zip(ins, ctx.needs_input_grad) if need]
            got = iter(torch.autograd.grad(out, want, g))
        grads = [next(got) if need else None
                 for need in ctx.needs_input_grad[:3]]
        return (*grads, None, None, None)


def _check_heads(what: str, x: torch.Tensor, dh: int, H: int, Hkv: int,
                 max_group: int) -> None:
    if x.dtype not in _DTYPES:
        raise ValueError(f"{what} has dtype {x.dtype}; the kernel takes "
                         f"float32 or bfloat16")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head size {dh} is not one of {HEAD_DIMS}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} KV heads")
    if H // Hkv > max_group:
        raise ValueError(f"{H // Hkv} query heads per KV head exceed the "
                         f"kernel's {max_group} at head size {dh}")


def _check_aligned(*named) -> None:
    for what, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{what} must start on a 16-byte boundary")


def decode_kernel(dtype: torch.dtype) -> str:
    """Which K5 kernel takes inputs of this dtype: ``"tc"`` (the one-launch
    tensor-core kernel) for bf16, ``"split"`` (split and combine) for
    float32."""
    return "tc" if dtype == torch.bfloat16 else "split"


def decode_splits(B: int, Hkv: int, Wc: int, dh: int,
                  n_sm: int) -> tuple[int, int]:
    """(rows a split, splits) of the tensor-core decode: splits of whole
    64-row tiles, as many as keep the B * Hkv * splits blocks within one
    wave (two blocks an SM at head sizes up to 128, one at 256, by shared
    memory)."""
    slots = n_sm * (1 if dh == 256 else 2)
    tiles = -(-Wc // _DECODE_TILE)
    n_split = max(1, min(slots // (B * Hkv), tiles))
    chunk = -(-tiles // n_split) * _DECODE_TILE
    return chunk, -(-Wc // chunk)


def _tickets(dev: torch.device, n: int) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _TICKETS[key] = t
    return t


def attn_decode_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    scale: float | None = None,
) -> torch.Tensor:
    """Launch one of K5's two kernels (:func:`decode_kernel`) on the
    current stream. Every tensor must be contiguous; ``lengths`` int32.
    ``attn_decode_cuda.launches`` counts the calls of both,
    ``attn_decode_cuda.launches_tc`` those of the tensor-core kernel."""
    if not q.is_cuda:
        raise ValueError("the CUDA attention decode needs CUDA tensors")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError("q must be (B, H, dh) and k, v (B, Hkv, Wc, dh)")
    B, H, dh = q.shape
    Hkv, Wc = k.shape[1], k.shape[2]
    _check_heads("q", q, dh, H, Hkv, DECODE_MAX_GROUP)
    if B == 0 or Wc == 0 or B > 65535 or Hkv > 65535:
        raise ValueError(f"unsupported decode shape B={B}, Hkv={Hkv}, "
                         f"Wc={Wc}")
    dev = q.device
    _build.check_arg(q, "q", q.dtype, (B, H, dh), dev)
    _build.check_arg(k, "k", q.dtype, (B, Hkv, Wc, dh), dev)
    _build.check_arg(v, "v", q.dtype, (B, Hkv, Wc, dh), dev)
    _build.check_arg(lengths, "lengths", torch.int32, (B,), dev)
    _check_aligned(("q", q), ("k", k), ("v", v))
    sc = float(scale if scale is not None else dh ** -0.5)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tc = decode_kernel(q.dtype) == "tc"
    if tc:
        chunk, n_split = decode_splits(
            B, Hkv, Wc, dh,
            torch.cuda.get_device_properties(dev).multi_processor_count)
    else:
        n_split = max(1, min(-(-_DECODE_BLOCKS // (B * Hkv)), -(-Wc // 32)))
        chunk = -(-Wc // n_split)
        n_split = -(-Wc // chunk)
    part_m = torch.empty(B * H * n_split, dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty(B * H * n_split * dh, dtype=torch.float32,
                           device=dev)
    out = torch.empty_like(q)
    if tc:
        fn = _build.function("attn_decode", "attn_decode_tc",
                             _DECODE_TC_ARGTYPES)
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  lengths.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
                  part_acc.data_ptr(), _tickets(dev, B * Hkv).data_ptr(),
                  out.data_ptr(), B, H, Hkv, Wc, dh, chunk, n_split, sc,
                  dev.index, stream)
        _build.check_status("attn_decode", code)
        attn_decode_cuda.launches_tc += 1
    else:
        fn = _build.function("attn_decode", "attn_decode", _DECODE_ARGTYPES)
        code = fn(q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), lengths.data_ptr(), part_m.data_ptr(),
                  part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(), B,
                  H, Hkv, Wc, dh, chunk, n_split, sc, dev.index, stream)
        _build.check_status("attn_decode", code)
    attn_decode_cuda.launches += 1
    return out


attn_decode_cuda.launches = 0
attn_decode_cuda.launches_tc = 0


def prefill_kernel(dtype: torch.dtype, dh: int) -> str:
    """Which K6 kernel takes these inputs: ``"tc"`` (tensor cores) for
    bf16 at head sizes 64 and 128, else ``"fma"``."""
    return "tc" if dtype == torch.bfloat16 and dh in TC_HEAD_DIMS else "fma"


def tma_strides(what: str, t: torch.Tensor) -> tuple[int, int, int]:
    """The (b, s, head) strides of a (B, S, heads, dh) bf16 view as the
    tensor-core kernel's tensor maps take them: TMA reads from a 16-byte
    aligned base through strides that are positive multiples of 16 bytes
    (8 elements). An axis of size 1 is never stepped along, so its stride
    is replaced by one past the whole view. Raises ValueError otherwise."""
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must start on a 16-byte boundary")
    sizes, strides = t.shape[:3], t.stride()[:3]
    span = max([st * n for st, n in zip(strides, sizes) if n > 1]
               + [t.shape[3]])
    out = tuple(st if n > 1 else -(-span // 8) * 8
                for st, n in zip(strides, sizes))
    if any(st <= 0 or st % 8 for st in out):
        raise ValueError(f"{what}: the tensor-core kernel reads through TMA, "
                         f"which needs (b, s, head) strides that are positive "
                         f"multiples of 8 elements (16 bytes), got "
                         f"{t.stride()}")
    return out


def swa_prefill_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """Launch one of K6's two kernels (:func:`prefill_kernel`) on the
    current stream. q, k and v may be any views whose head axis is
    contiguous; their other strides must be non-negative multiples of 4
    elements (the FMA kernel) or, for the tensor-core kernel, positive
    multiples of 8 (:func:`tma_strides`). The output is a new contiguous
    (B, S, H, dh) tensor. It records no autograd graph and raises on
    inputs that require grad under grad mode: :func:`swa_prefill`
    differentiates through K6. ``swa_prefill_cuda.launches`` counts the
    launches of both kernels, ``swa_prefill_cuda.launches_tc`` those of
    the tensor-core kernel."""
    if not q.is_cuda:
        raise ValueError("the CUDA prefill attention needs CUDA tensors")
    if _needs_graph(q, k, v):
        raise RuntimeError("the raw K6 launcher has no backward: call "
                           "swa_prefill(), which differentiates through "
                           "SwaPrefillFn")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q must be (B, S, H, dh) and k, v (B, S, Hkv, dh)")
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    _check_heads("q", q, dh, H, Hkv, H)
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"window must be a non-negative int, got {window!r}")
    if B == 0 or S == 0 or B > 65535 or H > 65535:
        raise ValueError(f"unsupported prefill shape B={B}, S={S}, H={H}")
    dev = q.device
    for what, t, shape in (("q", q, (B, S, H, dh)), ("k", k, (B, S, Hkv, dh)),
                           ("v", v, (B, S, Hkv, dh))):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{what} must be {q.dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.stride(3) != 1 or any(s % 4 or s < 0 for s in t.stride()[:3]):
            raise ValueError(f"{what} needs a contiguous head axis and "
                             f"non-negative strides that are multiples of 4, "
                             f"got {t.stride()}")
    _check_aligned(("q", q), ("k", k), ("v", v))
    tc = prefill_kernel(q.dtype, dh) == "tc"
    if tc:
        strides = [tma_strides(what, t) for what, t in
                   (("q", q), ("k", k), ("v", v))]
    out = torch.empty((B, S, H, dh), dtype=q.dtype, device=dev)
    sc = float(scale if scale is not None else dh ** -0.5)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if tc:
        fn = _build.function("swa_prefill", "swa_prefill_tc",
                             _PREFILL_TC_ARGTYPES)
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  *strides[0], *strides[1], *strides[2], B, S, H, Hkv, dh,
                  window, sc, dev.index, stream)
        _build.check_status("swa_prefill", code)
        swa_prefill_cuda.launches_tc += 1
    else:
        fn = _build.function("swa_prefill", "swa_prefill", _PREFILL_ARGTYPES)
        code = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
                  k.stride(0), k.stride(1), k.stride(2), v.stride(0),
                  v.stride(1), v.stride(2), B, S, H, Hkv, dh, window, sc,
                  dev.index, stream)
        _build.check_status("swa_prefill", code)
    swa_prefill_cuda.launches += 1
    return out


swa_prefill_cuda.launches = 0
swa_prefill_cuda.launches_tc = 0
