"""Model building blocks: the port of ``repro.models.layers`` (attention,
the dense MLP, the MoE FFN, RWKV6, the RG-LRU and cross-attention).

Every block is a pair of functions, ``init_<block>(gen, cfg) -> params``
and ``<block>(params, x, ...) -> y``, on plain tensors; parameters are
nested dicts of tensors in the JAX package's layout (``(d_in, d_out)``
weights, ``x @ w``), so a tree converted from the reference computes the
same thing.

Numerics follow the reference's rounding points: matmul weights are stored
in ``cfg.dtype``; norms, RoPE, softmax and the MLP activation compute in
float32 and cast back to the input dtype where the reference does.

Attention runs on one of two routes (``backend=``, resolved by
:mod:`repro_torch.kernels.dispatch`): on the card the hand-written kernels
of :mod:`repro_torch.kernels.swa` (``swa_prefill`` for a whole sequence,
``attn_decode`` for one token over the cache); with ``backend="torch"``
the plain versions, which for a whole sequence are ``_naive_attention`` /
``_chunked_attention``, faithful to the reference's. The RWKV6 time mix
runs its scan over a whole sequence through :func:`repro_torch.kernels.
wkv6.wkv6` (kernel K7 on the card) and a decode step through the plain
``wkv6_decode_step``. Non-causal attention (Whisper's encoder and its
cross-attention) is plain torch on every route, as the reference runs it
outside any Pallas kernel. The MoE FFN's dispatch and expert products and
the RG-LRU's scan are plain torch too: the reference has no kernel for
them.

Over a model axis (``tp=``, :mod:`repro_torch.models.model_axis`) every
block takes the rank's column and row blocks (``param_specs``' layout) and
sums its partial outputs, and the MoE runs the reference's expert-parallel
dispatch (:func:`moe_block_sharded`). Attention whose column blocks are
whole heads and whole KV heads runs on them (:class:`_HeadCut`); where a
block ends inside a head (RecurrentGemma's one KV head of 256, or 10
query heads over 4 ranks) the blocks are gathered first, since RoPE's
rotation pairs and the qk norms span a whole head, and each rank attends
with the heads its row block of ``wo`` multiplies. A K/V cache whose heads
do not split holds the rank's block of the ring's rows, and a decode step
merges the ranks' rank-partial attention (K5's partial mode). RWKV6 runs
its scan on the rank's heads (on every head, gathered, where its blocks
end inside one), the channel mix cuts ``kk @ wv`` to the rank's block of
``r``, the RG-LRU its recurrence on the rank's channels of the width (the
gates read the whole conv output, gathered).

Where the reference multiplies a float32 activation by a bf16 weight, JAX
promotes the product to float32; torch raises on mixed operands, so
:func:`_matmul` makes that promotion explicit (cross-attention K/V over
Whisper's float32 encoder output, the VLM patch projection; the encoder
itself casts its weights to the frames' dtype, ``model.encode``).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.dispatch import resolve_backend
from ..kernels.swa import (attn_decode, attn_decode_merge,
                           attn_decode_partial, swa_prefill)
from ..kernels.wkv6 import wkv6, wkv6_decode_step

Params = dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dt(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in JAX's promoted dtype (float32 @ bf16 is float32)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


# ---------------------------------------------------------------------------
# initializers / norms
# ---------------------------------------------------------------------------

def _dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
                scale: float | None = None) -> torch.Tensor:
    """Normal draws in float32 on ``gen``'s device, times the std
    (``fan_in ** -0.5`` unless ``scale``), then cast: the reference's cast
    order. The draws differ from ``jax.random``'s; tests convert the
    reference's parameters instead (``repro_torch.convert``)."""
    if gen.device.type == "meta":          # model.param_shapes: no draw
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) >= 2 else 1
    if len(shape) == 3:    # (E, d, f) expert weights: fan-in is the middle
        fan_in = shape[1]
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(std).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def init_norm(gen: torch.Generator, cfg: ArchConfig,
              d: int | None = None) -> Params:
    d = d or cfg.d_model
    kw = {"dtype": _dt(cfg), "device": gen.device}
    if cfg.norm == "rmsnorm":
        return {"scale": torch.zeros((d,), **kw)}
    return {"scale": torch.ones((d,), **kw), "bias": torch.zeros((d,), **kw)}


def apply_norm(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if "bias" in p:
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S) or (S,)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                   # (dh/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[:, :, None].float() * freqs[None, None, :]  # (B,S,dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional qk-norm, optional sliding window)
# ---------------------------------------------------------------------------

def _n_heads_eff(cfg: ArchConfig) -> int:
    """Query head count incl. zero-padding (``pad_heads_to``): padded heads
    carry zero wq columns and zero wo rows, so the math is the unpadded
    model's."""
    return max(cfg.n_heads, cfg.pad_heads_to or 0)


def init_attention(gen: torch.Generator, cfg: ArchConfig) -> Params:
    d, hd, Hkv = cfg.d_model, cfg.head_dim, cfg.n_kv_heads
    H, Hp = cfg.n_heads, _n_heads_eff(cfg)
    dt = _dt(cfg)
    wq = _dense_init(gen, (d, H * hd), dt)
    wk = _dense_init(gen, (d, Hkv * hd), dt)
    wv = _dense_init(gen, (d, Hkv * hd), dt)
    wo = _dense_init(gen, (H * hd, d), dt)
    if Hp > H:
        wq = torch.cat([wq, wq.new_zeros((d, (Hp - H) * hd))], dim=1)
        wo = torch.cat([wo, wo.new_zeros(((Hp - H) * hd, d))], dim=0)
    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dt, device=gen.device)
        p["k_norm"] = torch.zeros((hd,), dtype=dt, device=gen.device)
    return p


class _HeadCut:
    """How this rank's blocks of an attention's weights cut its heads.

    ``local``: no model axis, no split, or column blocks of whole heads
    and whole KV heads: the rank attends with its own heads (their KV
    heads are its own). Otherwise the column blocks of ``wq``, ``wk`` and
    ``wv`` (split inside a head, or whole) are gathered, and the rank
    attends with the query heads ``[ha, hb)`` that its row block ``[o0, o0
    + no)`` of ``wo`` multiplies, on KV heads ``[ka, kb)`` (the touched
    heads widened to whole groups where they span several KV heads);
    ``o_split``: the row blocks' outputs are partial sums over the axis."""

    def __init__(self, p: Params, cfg: ArchConfig, tp, H: int, Hkv: int):
        hd = self.hd = cfg.head_dim
        nq, nk, no = p["wq"].shape[1], p["wk"].shape[1], p["wo"].shape[0]
        self.q_split = nq < H * hd
        self.k_split = nk < Hkv * hd
        self.o_split = no < H * hd
        self.local = tp is None or not (self.q_split or self.k_split) or \
            (self.q_split and self.k_split and nq % hd == 0
             and nk % hd == 0)
        self.o0 = 0 if tp is None else tp.block(H * hd, no)
        self.no = no
        G = H // Hkv
        ha = self.o0 // hd
        hb = -(-(self.o0 + no) // hd)
        ka, kb = ha // G, (hb - 1) // G + 1
        if kb - ka > 1:
            ha, hb = ka * G, kb * G
        self.ha, self.hb, self.ka, self.kb = ha, hb, ka, kb

    @property
    def split(self) -> bool:
        """Whether any projection is split over the axis: the region whose
        replicated inputs go behind ``copy_in``."""
        return self.q_split or self.k_split

    def project(self, x: torch.Tensor, w: torch.Tensor, split: bool, tp):
        """``x @ w`` promoted as JAX promotes it; gathered into the whole
        columns where the rank attends from gathered blocks (a whole
        weight there goes behind ``copy_in``: each rank's heads give a
        part of its gradient)."""
        if self.local:
            return _matmul(x, w)
        if not split:
            return _matmul(x, tp.copy_in(w))
        return tp.gather_cols(_matmul(x, w))

    def attended(self, q, k, v):
        """The heads this rank attends with: q (..., heads, dh) and its KV
        heads."""
        if self.local:
            return q, k, v
        return (q[:, :, self.ha:self.hb], k[:, :, self.ka:self.kb],
                v[:, :, self.ka:self.kb])

    def out(self, o: torch.Tensor, p: Params, tp) -> torch.Tensor:
        """The attention output of the attended heads (B, S, heads, dh)
        through this rank's rows of ``wo``, summed over the axis where
        they are a row block."""
        B, S = o.shape[:2]
        y = o.reshape(B, S, -1)
        if not self.local:
            c0 = self.o0 - self.ha * self.hd
            y = y[..., c0:c0 + self.no]
        y = y @ p["wo"]
        return tp.reduce_out(y) if self.o_split else y


def _qk_project(p: Params, x: torch.Tensor, cfg: ArchConfig, positions,
                tp=None, cut: _HeadCut | None = None):
    """-> q (B, S, H, dh), k and v (B, S, Hkv, dh); v is a view of the
    projection. Each product promotes as JAX's does (a bf16 ``x`` against
    float32 weights: Whisper's encoder on bf16 frames), so its cotangent
    is rounded to x's dtype on its own, as the reference's. Over a model
    axis ``tp`` the rank's local heads from its column blocks, or, where
    ``cut`` is not local, every head from the gathered blocks."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    cut = cut or _attn_cut(p, cfg, tp)
    q_norm, k_norm = p.get("q_norm"), p.get("k_norm")
    if tp is not None and cut.split:
        x = tp.copy_in(x)
        if cfg.qk_norm:
            q_norm, k_norm = tp.copy_in(q_norm), tp.copy_in(k_norm)
    q = cut.project(x, p["wq"], cut.q_split, tp).reshape(B, S, -1, hd)
    k = cut.project(x, p["wk"], cut.k_split, tp).reshape(B, S, -1, hd)
    v = cut.project(x, p["wv"], cut.k_split, tp).reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, q_norm)
        k = rms_norm(k, k_norm)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _naive_attention(q, k, v, *, causal: bool, window: int,
                     q_offset: int = 0):
    """q: (B,S,H,dh); k/v: (B,T,Hkv,dh). Materializes (B,H,S,T) scores."""
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = (q.float() * dh ** -0.5).reshape(B, S, Hkv, G, dh)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k.float())
    qi = torch.arange(S, device=q.device)[:, None] + q_offset
    ki = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window:
        mask &= ki > qi - window
    scores = torch.where(mask, scores, -torch.inf)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", p, v.float())
    return out.reshape(B, S, H, dh).to(q.dtype)


def _chunked_attention(q, k, v, *, causal: bool, window: int,
                       q_chunk: int = 512, kv_chunk: int = 1024):
    """Flash-style two-level loop: O(S * kv_chunk) live scores per head,
    never an (S, T) score matrix. Falls back to :func:`_naive_attention`
    when the chunks do not divide S and T, as the reference does."""
    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, T)
    if S % q_chunk or T % kv_chunk:
        return _naive_attention(q, k, v, causal=causal, window=window)
    nq, nk = S // q_chunk, T // kv_chunk
    dev = q.device
    qf = (q.float() * dh ** -0.5).reshape(B, nq, q_chunk, Hkv, G, dh)
    kf = k.float().reshape(B, nk, kv_chunk, Hkv, dh)
    vf = v.float().reshape(B, nk, kv_chunk, Hkv, dh)
    out = torch.empty((B, S, H, dh), dtype=torch.float32, device=dev)
    for qi in range(nq):
        qb = qf[:, qi]                                      # (B,qc,Hkv,G,dh)
        m = torch.full((B, Hkv, G, q_chunk), -1e30, device=dev)
        l = torch.zeros((B, Hkv, G, q_chunk), device=dev)
        acc = torch.zeros((B, Hkv, G, q_chunk, dh), device=dev)
        qpos = qi * q_chunk + torch.arange(q_chunk, device=dev)[:, None]
        for ki in range(nk):
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kf[:, ki])
            kpos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)[None, :]
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= kpos <= qpos
            if window:
                mask &= kpos > qpos - window
            s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vf[:, ki])
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]      # (B,Hkv,G,qc,dh)
        out[:, qi * q_chunk:(qi + 1) * q_chunk] = o.permute(
            0, 3, 1, 2, 4).reshape(B, q_chunk, H, dh)
    return out.to(q.dtype)


def _plain_attention(q, k, v, cfg: ArchConfig, *, causal: bool,
                     window: int) -> torch.Tensor:
    """The reference's attention over a whole sequence (``cfg.attn_impl``;
    ``"auto"`` is chunked from S = 2048 on)."""
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "chunked" if q.shape[1] >= 2048 else "naive"
    fn = _chunked_attention if impl == "chunked" else _naive_attention
    return fn(q, k, v, causal=causal, window=window)


def causal_attention(q, k, v, cfg: ArchConfig, *, window: int,
                     backend: str = "auto") -> torch.Tensor:
    """Causal attention over a whole sequence, (B, S, H, dh): the
    ``swa_prefill`` kernel on the card; with ``backend="torch"`` the plain
    path the reference takes."""
    if resolve_backend(backend, q) == "cuda":
        return swa_prefill(q, k, v, window, backend="cuda")
    return _plain_attention(q, k, v, cfg, causal=True, window=window)


def _row_out(y: torch.Tensor, tp, split: bool = True) -> torch.Tensor:
    """A row-split product's partial sum, summed over the model axis
    (``split``: the rows are a block; a whole weight's product is whole)."""
    return y if tp is None or not split else tp.reduce_out(y)


def _is_split(tp, local: int, full: int) -> bool:
    """Whether a dimension of ``full`` of which this rank holds ``local``
    is split over the model axis."""
    return tp is not None and local < full


def _attn_cut(p: Params, cfg: ArchConfig, tp) -> _HeadCut:
    return _HeadCut(p, cfg, tp, _n_heads_eff(cfg), cfg.n_kv_heads)


def attention_block(p: Params, x: torch.Tensor, cfg: ArchConfig,
                    positions: torch.Tensor, *, window: int = 0,
                    causal: bool = True,
                    backend: str = "auto", tp=None) -> torch.Tensor:
    """x: (B, S, d) pre-normed input -> (B, S, d). Causal attention takes
    the kernel route; non-causal (Whisper's encoder) is plain torch. Over
    a model axis ``tp`` each rank attends with its local heads (or the
    heads its row block of ``wo`` multiplies) and its rows of ``wo``, and
    the partial outputs are summed."""
    cut = _attn_cut(p, cfg, tp)
    q, k, v = cut.attended(*_qk_project(p, x, cfg, positions, tp, cut))
    if causal:
        out = causal_attention(q, k, v, cfg, window=window, backend=backend)
    else:
        out = _plain_attention(q, k, v, cfg, causal=False, window=window)
    return cut.out(out, p, tp)


def _prime(dst: torch.Tensor, src: torch.Tensor, S: int, row0: int = 0,
           wlen: int | None = None) -> None:
    """Write the K or V rows ``src`` (B, S, Hkv, dh) of a prompt into a
    layer cache ``dst`` (B, Hkv, n, dh) holding rows ``[row0, row0 + n)``
    of a ring of ``wlen`` rows (default n: the whole ring), as the
    reference primes it: appended from slot 0 while S <= wlen; once S >=
    wlen, token t at slot t % wlen (the reference's roll by S % wlen).
    Slots no token reaches stay as they are (zeros)."""
    n = dst.shape[2]
    wlen = wlen or n
    slot = torch.arange(row0, row0 + n, device=src.device)
    if S >= wlen:
        tok = S - wlen + (slot - S) % wlen
        dst.copy_(src[:, tok].transpose(1, 2))
        return
    live = int(min(max(S - row0, 0), n))
    if live:
        dst[:, :, :live].copy_(src[:, row0:row0 + live].transpose(1, 2))


def attention_prefill(p: Params, x: torch.Tensor, cfg: ArchConfig,
                      positions: torch.Tensor, cache: Params, *,
                      window: int = 0, backend: str = "auto", tp=None,
                      ring: int | None = None) -> torch.Tensor:
    """Prefill of one attention layer: project, prime ``cache`` (the
    layer's ``{"k", "v", "pos"}``) with the prompt's last rows, attend
    causally over the prompt -> (B, S, d). Over a model axis ``tp`` the
    cache holds what ``cache_specs`` gives the rank: its KV heads, the
    whole ring, or (``ring``: the whole ring's rows, where it is split over
    its rows) its block of the ring's rows."""
    B, S, _ = x.shape
    cut = _attn_cut(p, cfg, tp)
    q, k, v = _qk_project(p, x, cfg, positions, tp, cut)
    row0, wlen = 0, None
    if ring is not None and cache["k"].shape[2] < ring:
        row0, wlen = tp.ring_block(ring)[0], ring
    _prime(cache["k"], k, S, row0, wlen)
    _prime(cache["v"], v, S, row0, wlen)
    cache["pos"].fill_(S)
    out = causal_attention(*cut.attended(q, k, v), cfg, window=window,
                           backend=backend)
    return cut.out(out, p, tp)


def attention_decode(p: Params, x: torch.Tensor, cfg: ArchConfig,
                     cache: Params, *, backend: str = "auto", tp=None,
                     ring: int | None = None
                     ) -> tuple[torch.Tensor, Params]:
    """Single-token decode against a (ring-buffer when windowed) KV cache.

    x: (B, 1, d); cache ``{"k", "v": (B, Hkv, Wc, dh), "pos": (B,) int32}``.
    Unlike the reference, which returns a new cache, the new K/V row is
    written into ``cache`` in place and ``pos`` advanced in place; the same
    dict is returned. The window is the cache's own length (an ``swa``
    layer's cache holds ``min(cache_len, window)`` rows), so, as in the
    reference, no window argument is needed.

    Over a model axis ``tp`` the cache holds the rank's local KV heads, or
    the whole ring, or its block ``[r Wc / mp, (r + 1) Wc / mp)`` of a ring
    of ``ring`` = Wc rows. In the last case the new row is written only by
    the rank that owns slot ``pos % Wc``, each rank runs K5's rank-partial
    mode over its block (``lengths = clamp(len - r Wc / mp, 0, Wc / mp)``)
    for every query head, and the ranks' triples are gathered and merged;
    each rank keeps the output columns its rows of ``wo`` multiply."""
    B = x.shape[0]
    pos = cache["pos"]                 # absolute position of the new token
    cut = _attn_cut(p, cfg, tp)
    if not cut.local and ring is None:
        raise ValueError("a decode step on gathered attention blocks needs "
                         "the ring's length: pass the cache_len its prefill "
                         "was given")
    q, k, v = _qk_project(p, x, cfg, pos[:, None], tp, cut)
    Wl = cache["k"].shape[2]
    Wc = ring if ring is not None else Wl
    if Wl != Wc and (tp is None or Wl != tp.ring_block(Wc)[1]):
        raise ValueError(f"a cache of {Wl} K/V rows is neither a ring of "
                         f"{Wc} rows nor its block: pass the cache_len its "
                         f"prefill was given")
    slot = pos.long() % Wc             # ring buffer; append while pos < Wc
    bidx = torch.arange(B, device=x.device)
    kn, vn = k[:, 0].to(cache["k"].dtype), v[:, 0].to(cache["v"].dtype)
    row0 = tp.ring_block(Wc)[0] if Wl < Wc else 0
    if Wl < Wc:                        # this rank's block of the ring's rows
        # every rank writes a row; one whose block does not hold the slot
        # writes back the row it holds (no host sync on whose slot it is)
        mine = ((slot >= row0) & (slot < row0 + Wl))[:, None, None]
        slot = torch.clamp(slot - row0, 0, Wl - 1)
        kn = torch.where(mine, kn, cache["k"][bidx, :, slot])
        vn = torch.where(mine, vn, cache["v"][bidx, :, slot])
    cache["k"][bidx, :, slot] = kn
    cache["v"][bidx, :, slot] = vn
    lengths = torch.clamp_max(pos + 1, Wc).to(torch.int32)
    if Wl < Wc:
        lengths = torch.clamp(lengths - row0, 0, Wl).to(torch.int32)
        acc, m, l = attn_decode_partial(q[:, 0], cache["k"], cache["v"],
                                        lengths, backend=backend)
        hd = acc.shape[2]
        part = tp.all_gather(torch.cat([acc, m[..., None], l[..., None]],
                                       dim=-1))
        out = attn_decode_merge(part[..., :hd], part[..., hd],
                                part[..., hd + 1], q.dtype, backend=backend)
    else:                              # every head the cache holds
        out = attn_decode(q[:, 0], cache["k"], cache["v"], lengths,
                          backend=backend)
    if not cut.local:
        out = out[:, cut.ha:cut.hb]
    y = cut.out(out[:, None].to(x.dtype), p, tp)
    cache["pos"].add_(1)
    return y, cache


def init_attn_cache(cfg: ArchConfig, B: int, cache_len: int,
                    device=None) -> Params:
    hd, Hkv = cfg.head_dim, cfg.n_kv_heads
    return {
        "k": torch.zeros((B, Hkv, cache_len, hd), dtype=_dt(cfg),
                         device=device),
        "v": torch.zeros((B, Hkv, cache_len, hd), dtype=_dt(cfg),
                         device=device),
        "pos": torch.zeros((B,), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ArchConfig) -> Params:
    d, f, dt = cfg.d_model, cfg.d_ff, _dt(cfg)
    if cfg.act in ("swiglu", "geglu"):
        return {"w_gate": _dense_init(gen, (d, f), dt),
                "w_up": _dense_init(gen, (d, f), dt),
                "w_down": _dense_init(gen, (f, d), dt)}
    return {"w_up": _dense_init(gen, (d, f), dt),
            "w_down": _dense_init(gen, (f, d), dt)}


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_block(p: Params, x: torch.Tensor, cfg: ArchConfig,
              tp=None) -> torch.Tensor:
    """The activation computes in float32 and is cast back to x's dtype
    before the product, as in the reference. Over a model axis ``tp``:
    the rank's columns of ``w_gate``/``w_up`` and rows of ``w_down``, the
    partial outputs summed."""
    split = _is_split(tp, p["w_down"].shape[0], cfg.d_ff)
    if split:
        x = tp.copy_in(x)
    if "w_gate" in p:
        act = F.silu if cfg.act == "swiglu" else _gelu
        h = act((x @ p["w_gate"]).float()).to(x.dtype) * (x @ p["w_up"])
    else:
        h = _gelu((x @ p["w_up"]).float()).to(x.dtype)
    return _row_out(h @ p["w_down"], tp, split)


# ---------------------------------------------------------------------------
# Mixture of Experts (token-choice top-k, capacity-bounded dispatch)
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ArchConfig) -> Params:
    d, f, E, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, _dt(cfg)
    return {"router": _dense_init(gen, (d, E), torch.float32, scale=0.02),
            "w_gate": _dense_init(gen, (E, d, f), dt),
            "w_up": _dense_init(gen, (E, d, f), dt),
            "w_down": _dense_init(gen, (E, f, d), dt)}


def moe_route(p: Params, xt: torch.Tensor, k: int):
    """The float32 router of tokens xt (T, d) -> (probs (T, E), gates
    (T, k), expert ids (T, k)). The top k are taken by a stable descending
    sort, so that among equal probabilities the lower expert id comes
    first, as ``jax.lax.top_k`` orders them (``torch.topk`` promises no
    order among ties)."""
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, top.values[:, :k], top.indices[:, :k]


def moe_capacity(T: int, cfg: ArchConfig) -> int:
    """Slots an expert: ``max(1, ceil(T k / E * capacity_factor))``."""
    return max(1, math.ceil(T * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor))


def moe_slots(ids: torch.Tensor, E: int, cap: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(slot, kept) of each flat (token, choice) assignment of ids (T, k):
    its rank among the assignments to the same expert in token-major order
    (a stable sort by expert id in place of the reference's (T k, E)
    one-hot cumsum), slot ``expert * cap + rank``, kept while rank < cap.
    Dropped assignments get slot ``E * cap``."""
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.empty_like(flat)
    ranks[order] = torch.arange(flat.numel(), device=flat.device) \
        - starts[flat[order]]
    kept = ranks < cap
    slot = torch.where(kept, flat * cap + ranks, E * cap)
    return slot, kept


def moe_block(p: Params, x: torch.Tensor, cfg: ArchConfig, tp=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE with per-expert capacity -> (y, aux): the
    reference's ``_moe_block_gspmd`` (its ``moe_block`` takes that path
    whenever no mesh has a "model" axis, as on one card); over a model
    axis ``tp`` with ``cfg.moe_impl == "sharded"``, its expert-parallel
    ``_moe_block_sharded`` (:func:`moe_block_sharded`), which a model axis
    of several ranks runs whatever ``moe_impl`` says (its experts are
    split). A rank dispatches its own rows, so its capacity comes from its
    local tokens (the reference's GSPMD dispatch counts the global
    batch's: the same at one data rank, or wherever nothing drops).

    Renormalized gates; the Switch aux ``E sum_e f_e P_e router_aux_coef``;
    the (E cap, d) dispatch buffer, in which assignments ranked at or past
    ``cap`` are dropped with their gate mass; the expert FFN as batched
    products over the expert axis; the gate-weighted combine, the k
    products (rounded to x's dtype, as the reference's are) summed in
    float32."""
    if tp is not None and (cfg.moe_impl == "sharded" or tp.size > 1):
        return moe_block_sharded(p, x, cfg, tp)
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    probs, gates, ids = moe_route(p, xt, k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    frac = torch.bincount(ids.reshape(-1), minlength=E).float() / (T * k)
    aux = E * torch.sum(frac * probs.mean(dim=0)) * cfg.router_aux_coef

    cap = moe_capacity(T, cfg)
    slot, kept = moe_slots(ids, E, cap)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = x.new_zeros((E * cap, d))
    buf[slot[kept]] = xt[tok[kept]]
    h = buf.view(E, cap, d)

    act = F.silu if cfg.act == "swiglu" else _gelu
    g = act(torch.bmm(h, p["w_gate"]).float()).to(x.dtype)
    u = torch.bmm(h, p["w_up"])
    y_e = torch.bmm(g * u, p["w_down"]).view(E * cap, d)

    w = (gates.reshape(-1) * kept).to(x.dtype)
    per = y_e[slot.clamp_max(E * cap - 1)] * w[:, None]
    y = per.view(T, k, d).float().sum(dim=1).to(x.dtype)
    return y.view(B, S, d), aux


def moe_local_dispatch(xt: torch.Tensor, router_w: torch.Tensor,
                       w_gate: torch.Tensor, w_up: torch.Tensor,
                       w_down: torch.Tensor, cfg: ArchConfig, E_total: int,
                       e_offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One rank's expert compute (the reference's ``_moe_local_dispatch``):
    route the T local tokens xt (T, d) over all ``E_total`` experts, keep
    the assignments to this rank's E_loc experts ``[e_offset, e_offset +
    E_loc)``, each ranked among them in token-major order against a
    capacity from the local T, run those experts and combine -> (the
    partial output (T, d), the local aux). The combine sums the k products
    in float32, as :func:`moe_block`'s does."""
    T, d = xt.shape
    E_loc = w_gate.shape[0]
    k = cfg.top_k
    probs, gates, ids = moe_route({"router": router_w}, xt, k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    frac = torch.bincount(ids.reshape(-1), minlength=E_total).float() \
        / (T * k)
    aux = E_total * torch.sum(frac * probs.mean(dim=0)) \
        * cfg.router_aux_coef

    cap = max(1, math.ceil(T * k / E_total * cfg.capacity_factor))
    loc = ids - e_offset
    mine = (loc >= 0) & (loc < E_loc)
    slot, kept = moe_slots(torch.where(mine, loc, E_loc), E_loc + 1, cap)
    kept = kept & mine.reshape(-1)
    slot = torch.where(kept, slot, E_loc * cap)
    tok = torch.arange(T, device=xt.device).repeat_interleave(k)
    buf = xt.new_zeros((E_loc * cap, d))
    buf[slot[kept]] = xt[tok[kept]]
    h = buf.view(E_loc, cap, d)

    act = F.silu if cfg.act == "swiglu" else _gelu
    g = act(torch.bmm(h, w_gate).float()).to(xt.dtype)
    u = torch.bmm(h, w_up)
    y_e = torch.bmm(g * u, w_down).view(E_loc * cap, d)

    w = (gates.reshape(-1) * kept).to(xt.dtype)
    per = y_e[slot.clamp_max(E_loc * cap - 1)] * w[:, None]
    y = per.view(T, k, d).float().sum(dim=1).to(xt.dtype)
    return y, aux


def moe_block_sharded(p: Params, x: torch.Tensor, cfg: ArchConfig, tp
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism over the model axis ``tp`` (the reference's
    ``_moe_block_sharded``): x (B_loc, S, d) is this rank's batch rows,
    replicated over model; ``p`` holds the replicated router and this
    rank's E / mp experts (``e_offset = rank * E_loc``). The partial
    outputs are summed over model; the aux is averaged over model, then
    over the batch axes."""
    B, S, d = x.shape
    xt = tp.copy_in(x.reshape(B * S, d))
    E_loc = p["w_gate"].shape[0]
    y, aux = moe_local_dispatch(xt, tp.copy_in(p["router"]), p["w_gate"],
                                p["w_up"], p["w_down"], cfg, cfg.n_experts,
                                tp.rank * E_loc)
    y = tp.reduce_out(y)
    aux = tp.mean_batch(tp.mean_model(aux))
    return y.view(B, S, d), aux


# ---------------------------------------------------------------------------
# RWKV6 time-mix + channel-mix
# ---------------------------------------------------------------------------

_WKV_LORA = 64


def init_wkv6(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """The reference's leaves, shapes and dtypes, drawn in its order."""
    d, hd, dt = cfg.d_model, cfg.wkv_head_dim, _dt(cfg)
    H = d // hd
    dev = gen.device
    p = {"mu": torch.full((5, d), 0.5, dtype=dt, device=dev)}  # r,k,v,g,w
    for name in ("wr", "wk", "wv", "wg"):
        p[name] = _dense_init(gen, (d, d), dt)
    p["w0"] = torch.full((d,), -0.5, device=dev)     # base log-log decay
    p["w_lora_a"] = _dense_init(gen, (d, _WKV_LORA), dt)
    p["w_lora_b"] = _dense_init(gen, (_WKV_LORA, d), dt, scale=0.01)
    p["u"] = _dense_init(gen, (H, hd), torch.float32, scale=0.5)
    p["ln_x"] = torch.ones((d,), device=dev)         # per-head groupnorm
    p["wo"] = _dense_init(gen, (d, d), dt)
    return p


def _shift(x: torch.Tensor) -> torch.Tensor:
    """x shifted right by one token along the sequence, zero first."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _lerp_mixes(mu: torch.Tensor, x: torch.Tensor, x_prev: torch.Tensor):
    """The token-shift lerps ``x + mu[i] (x_prev - x)`` in float32, cast
    back to x's dtype, as a function of i."""
    mu = mu.float()
    xf = x.float()
    dx = x_prev.float() - xf
    return lambda i: (xf + mu[i] * dx).to(x.dtype)


def _wkv6_local(p: Params, cfg: ArchConfig, tp):
    """This rank's view of a time mix's parameters -> (params, heads the
    scan runs, the model axis where its projections are split (else None),
    this rank's output columns ``(c0, n)`` where its blocks end inside a
    head (else None)): its column blocks of ``wr``/``wk``/``wv``/``wg``/
    ``w_lora_b`` and rows of ``wo`` as held, the whole ``w0`` cut to its
    columns, and every replicated weight of the split region behind
    ``copy_in``. On whole heads ``u`` and ``ln_x`` are cut to the rank's
    heads; inside a head they stay whole, since the rank gathers the
    projections and scans every head (:func:`wkv6_mix`)."""
    d, hd = cfg.d_model, cfg.wkv_head_dim
    n = p["wr"].shape[1]
    if not _is_split(tp, n, d):
        return p, d // hd, None, None
    c0 = tp.block(d, n)
    q = dict(p)
    for name in ("mu", "w_lora_a", "w0", "u", "ln_x"):
        q[name] = tp.copy_in(p[name])
    q["w0"] = q["w0"][c0:c0 + n]
    if n % hd:
        return q, d // hd, tp, (c0, n)
    q["ln_x"] = q["ln_x"][c0:c0 + n]
    q["u"] = q["u"][c0 // hd:(c0 + n) // hd]
    return q, n // hd, tp, None


def _wkv6_inputs(p: Params, x: torch.Tensor, x_prev: torch.Tensor,
                 cfg: ArchConfig, tp=None, cut=None):
    """Token shift and the five projections -> r, k, v, g (x's dtype) and
    the float32 log-decay ``lw = -exp(clip(w0 + tanh(x A) B, -8, 4))``;
    over a split model axis ``tp`` the rank's columns (``p`` from
    :func:`_wkv6_local`), gathered whole where ``cut`` (its columns inside
    a head) is given."""
    if tp is not None:
        x, x_prev = tp.copy_in(x), tp.copy_in(x_prev)
    mix = _lerp_mixes(p["mu"], x, x_prev)
    r = mix(0) @ p["wr"]
    k = mix(1) @ p["wk"]
    v = mix(2) @ p["wv"]
    g = mix(3) @ p["wg"]
    ww = torch.tanh((mix(4) @ p["w_lora_a"]).float()) \
        @ p["w_lora_b"].float()
    lw = -torch.exp(torch.clamp(p["w0"] + ww, -8.0, 4.0))
    if cut is not None:
        return tuple(tp.gather_cols(a) for a in (r, k, v, g, lw))
    return r, k, v, g, lw


def _wkv_groupnorm(y: torch.Tensor, scale: torch.Tensor,
                   H: int) -> torch.Tensor:
    B, S, d = y.shape
    yh = y.reshape(B, S, H, d // H).float()
    mu = yh.mean(dim=-1, keepdim=True)
    var = ((yh - mu) ** 2).mean(dim=-1, keepdim=True)
    yn = (yh - mu) * torch.rsqrt(var + 1e-5)
    return (yn.reshape(B, S, d) * scale).to(y.dtype)


def _wkv6_out(p: Params, y: torch.Tensor, g: torch.Tensor, H: int,
              dtype: torch.dtype, tp=None, cut=None) -> torch.Tensor:
    """Groupnorm, the silu gate and the output projection (over a split
    model axis ``tp``, this rank's rows of ``wo``, summed; ``cut``: the
    rank's columns ``(c0, n)`` of the gathered heads' output, which its
    rows of ``wo`` multiply)."""
    y = _wkv_groupnorm(y, p["ln_x"], H)
    y = y * F.silu(g.float()).to(dtype)
    if cut is not None:
        y = y[..., cut[0]:cut[0] + cut[1]]
    return _row_out(y @ p["wo"], tp)


def wkv6_mix(p: Params, x: torch.Tensor, x_prev: torch.Tensor,
             cfg: ArchConfig, backend: str = "auto", tp=None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The time mix over a whole sequence from a zero state -> (out (B, S,
    d), final state (B, H, hd, hd) float32). The scan gets (B, H, S, hd)
    views of the projections and returns y in the (B, S, H, hd) layout on
    the card, so no transposed copy is made there. Over a model axis
    ``tp`` the scan runs on the rank's heads and the state is theirs; where
    the rank's column blocks end inside a head, the projections are
    gathered, the scan runs on every head (the state is whole, as
    ``cache_specs`` leaves it) and the rank keeps its output columns."""
    B, S, _ = x.shape
    hd = cfg.wkv_head_dim
    p, H, ax, cut = _wkv6_local(p, cfg, tp)
    r, k, v, g, lw = _wkv6_inputs(p, x, x_prev, cfg, ax, cut)

    def heads(a):
        return a.view(B, S, H, hd).transpose(1, 2)

    y, s = wkv6(heads(r), heads(k), heads(v), heads(lw),
                p["u"].expand(B, H, hd), backend=backend)
    y = y.transpose(1, 2).reshape(B, S, H * hd)
    return _wkv6_out(p, y, g, H, x.dtype, ax, cut), s


def wkv6_block(p: Params, x: torch.Tensor, cfg: ArchConfig,
               backend: str = "auto", tp=None) -> torch.Tensor:
    """Training/prefill path (full sequence, pre-normed input)."""
    return wkv6_mix(p, x, _shift(x), cfg, backend, tp)[0]


def wkv6_decode(p: Params, x: torch.Tensor, cfg: ArchConfig,
                cache: Params, tp=None) -> tuple[torch.Tensor, Params]:
    """Single-token decode. cache ``{"state": (B, H, hd, hd) float32,
    "x_prev": (B, d)}``, updated in place (the reference returns a new
    one); the same dict is returned. Over a model axis ``tp`` the state
    holds the rank's heads, or every head where the rank's blocks end
    inside a head (:func:`wkv6_mix`)."""
    B = x.shape[0]
    hd = cfg.wkv_head_dim
    p, H, ax, cut = _wkv6_local(p, cfg, tp)
    r, k, v, g, lw = _wkv6_inputs(p, x, cache["x_prev"][:, None, :], cfg,
                                  ax, cut)

    def heads(a):
        return a[:, 0].reshape(B * H, hd)

    y, s_new = wkv6_decode_step(
        heads(r), heads(k), heads(v), heads(lw),
        p["u"].expand(B, H, hd).reshape(B * H, hd),
        cache["state"].reshape(B * H, hd, hd))
    out = _wkv6_out(p, y.reshape(B, 1, H * hd), g, H, x.dtype, ax, cut)
    cache["state"].copy_(s_new.view(B, H, hd, hd))
    cache["x_prev"].copy_(x[:, 0])
    return out, cache


def init_wkv6_cache(cfg: ArchConfig, B: int, device=None) -> Params:
    d, hd = cfg.d_model, cfg.wkv_head_dim
    H = d // hd
    return {"state": torch.zeros((B, H, hd, hd), device=device),
            "x_prev": torch.zeros((B, d), dtype=_dt(cfg), device=device)}


def init_rwkv_cm(gen: torch.Generator, cfg: ArchConfig) -> Params:
    d, f, dt = cfg.d_model, cfg.d_ff, _dt(cfg)
    p = {"mu": torch.full((2, d), 0.5, dtype=dt, device=gen.device)}
    p["wk"] = _dense_init(gen, (d, f), dt)
    p["wv"] = _dense_init(gen, (f, d), dt)
    p["wr"] = _dense_init(gen, (d, d), dt)
    return p


def rwkv_cm_block(p: Params, x: torch.Tensor, cfg: ArchConfig,
                  x_prev: torch.Tensor | None = None, tp=None
                  ) -> torch.Tensor:
    """RWKV channel mix; ``x_prev`` defaults to x shifted by one token.
    Over a model axis ``tp``: ``wk`` is split over f and ``wv`` over its
    rows, so ``kk @ wv`` is a partial sum; ``wr`` is split over d, so it
    is cut to the rank's block of d (``scatter_last``), multiplied by the
    rank's ``r`` and the blocks gathered."""
    x_prev = _shift(x) if x_prev is None else x_prev
    wk, wv = p["wk"], p["wv"]
    k_split = _is_split(tp, wk.shape[1], cfg.d_ff)
    n = p["wr"].shape[1]
    r_split = _is_split(tp, n, cfg.d_model)
    if k_split or r_split:        # the split region's inputs
        mix = _lerp_mixes(tp.copy_in(p["mu"]), tp.copy_in(x),
                          tp.copy_in(x_prev))
        mix_r = mix if r_split else _lerp_mixes(p["mu"], x, x_prev)
    else:
        mix = mix_r = _lerp_mixes(p["mu"], x, x_prev)
    if r_split and not k_split:   # whole wk, wv; the rank's columns of kv
        wk, wv = tp.copy_in(wk), tp.copy_in(wv)
    kk = torch.square(torch.relu((mix(0) @ wk).float())).to(x.dtype)
    r = torch.sigmoid((mix_r(1) @ p["wr"]).float()).to(x.dtype)
    kv = kk @ wv
    if not r_split:
        return r * _row_out(kv, tp, k_split)
    c0 = tp.block(cfg.d_model, n)
    kv = tp.scatter_last(kv) if k_split else kv[..., c0:c0 + n]
    return tp.gather_last(r * kv)


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin recurrent block)
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0
_CONV_W = 4        # the temporal conv's width


def init_rglru(gen: torch.Generator, cfg: ArchConfig) -> Params:
    d, w, dt = cfg.d_model, cfg.rnn_width, _dt(cfg)
    return {"w_in": _dense_init(gen, (d, w), dt),
            "w_gate_branch": _dense_init(gen, (d, w), dt),
            "conv_w": _dense_init(gen, (_CONV_W, w), dt, scale=0.5),
            "conv_b": torch.zeros((w,), dtype=dt, device=gen.device),
            "wa": _dense_init(gen, (w, w), dt, scale=0.02),
            "wx": _dense_init(gen, (w, w), dt, scale=0.02),
            # softplus^-1 of the decay parameter
            "lam": torch.full((w,), 4.0, device=gen.device),
            "w_out": _dense_init(gen, (w, d), dt)}


def _combine(x, y):
    """The scan's operator, x before y: (a_x a_y, a_y b_x + b_y)."""
    return x[0] * y[0], y[0] * x[1] + y[1]


def _assoc_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of :func:`_combine` along axis 1 in log depth:
    ``jax.lax.associative_scan``'s odd/even recursion, so the products
    are formed in the reference's order."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = _assoc_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    out = []
    for e0, ev, od in zip((a, b), even, odd):
        r = torch.empty_like(e0)
        r[:, 0] = e0[:, 0]
        r[:, 2::2] = ev
        r[:, 1::2] = od
        out.append(r)
    return out


def _rglru_scan(a: torch.Tensor, b: torch.Tensor,
                h0: torch.Tensor | None = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 (float32), the initial state
    folded into the first step as the reference folds it."""
    if h0 is not None:
        b = b.clone()
        b[:, 0] += a[:, 0] * h0
    return _assoc_scan(a, b)[1]


def _rglru_local(p: Params, tp):
    """This rank's view of an RG-LRU's parameters -> (params, the model
    axis where its width is split, else None): its column blocks of
    ``w_in``/``w_gate_branch``/``conv_w`` and rows of ``w_out`` as held,
    the whole ``conv_b`` and ``lam`` (replicated, so their length is the
    width) cut to its channels and the whole gates ``wa``/``wx`` to its
    columns, each replicated weight behind ``copy_in``."""
    w, n = p["lam"].shape[0], p["w_in"].shape[1]
    if not _is_split(tp, n, w):
        return p, None
    c0 = tp.block(w, n)
    q = dict(p)
    for name in ("conv_b", "lam"):
        q[name] = tp.copy_in(p[name])[c0:c0 + n]
    for name in ("wa", "wx"):
        q[name] = tp.copy_in(p[name])[:, c0:c0 + n]
    return q, tp


def _rglru_core(p: Params, xw: torch.Tensor, h0=None, tp=None):
    """xw: (B, S, w) post-conv activations -> (h, a, b), float32. Over a
    model axis (``tp``, ``p`` from :func:`_rglru_local`) xw is the rank's
    channels; the gates read every channel, gathered."""
    xf = xw.float()
    full = xf if tp is None else tp.gather_cols(xw).float()
    r = torch.sigmoid(full @ p["wa"].float())
    i = torch.sigmoid(full @ p["wx"].float())
    log_a = -_RGLRU_C * r * F.softplus(p["lam"])        # (B, S, w) <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * xf)
    return _rglru_scan(a, b, h0), a, b


def _causal_conv(p: Params, xw: torch.Tensor) -> torch.Tensor:
    """The width-4 causal temporal conv in xw's dtype, summed in the
    reference's order."""
    S = xw.shape[1]
    pad = F.pad(xw, (0, 0, _CONV_W - 1, 0))
    w = p["conv_w"]
    conv = pad[:, 3:S + 3] * w[3]
    for i in range(1, _CONV_W):
        conv = conv + pad[:, 3 - i:S + 3 - i] * w[3 - i]
    return conv + p["conv_b"]


def rglru_mix(p: Params, x: torch.Tensor, tp=None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrent block over a whole sequence from a zero state ->
    (out (B, S, d), the input projection xw (B, S, w), h (B, S, w)
    float32): prefill keeps xw's last rows and h's last row. Over a model
    axis ``tp`` xw and h are the rank's channels and the output sums the
    ranks' row blocks of ``w_out``."""
    p, ax = _rglru_local(p, tp)
    if ax is not None:
        x = ax.copy_in(x)
    xw = x @ p["w_in"]
    h, _, _ = _rglru_core(p, _causal_conv(p, xw), tp=ax)
    gate = _gelu((x @ p["w_gate_branch"]).float())
    return _row_out((h * gate).to(x.dtype) @ p["w_out"], ax), xw, h


def rglru_block(p: Params, x: torch.Tensor, cfg: ArchConfig,
                tp=None) -> torch.Tensor:
    """Training/prefill path (full sequence, pre-normed input)."""
    return rglru_mix(p, x, tp)[0]


def rglru_decode(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 cache: Params, tp=None) -> tuple[torch.Tensor, Params]:
    """Single-token decode. cache ``{"h": (B, w) float32, "conv": (B, 3,
    w)}``, updated in place (the reference returns a new one); the same
    dict is returned. Over a model axis ``tp`` the cache holds the rank's
    channels."""
    p, ax = _rglru_local(p, tp)
    if ax is not None:
        x = ax.copy_in(x)
    xw = x @ p["w_in"]                                   # (B, 1, w)
    hist = torch.cat([cache["conv"], xw.to(cache["conv"].dtype)], dim=1)
    conv = (torch.einsum("btw,tw->bw", hist.float(), p["conv_w"].float())
            + p["conv_b"].float())[:, None, :]
    h, _, _ = _rglru_core(p, conv, h0=cache["h"], tp=ax)
    h = h[:, 0]
    gate = _gelu((x[:, 0] @ p["w_gate_branch"]).float())
    y = _row_out((h * gate).to(x.dtype) @ p["w_out"], ax)
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:])
    return y[:, None, :], cache


def init_rglru_cache(cfg: ArchConfig, B: int, device=None) -> Params:
    w = cfg.rnn_width
    return {"h": torch.zeros((B, w), device=device),
            "conv": torch.zeros((B, _CONV_W - 1, w), dtype=_dt(cfg),
                                device=device)}


# ---------------------------------------------------------------------------
# Cross-attention (Whisper's decoder)
# ---------------------------------------------------------------------------

def init_cross_attention(gen: torch.Generator, cfg: ArchConfig) -> Params:
    d, hd, H, dt = cfg.d_model, cfg.head_dim, cfg.n_heads, _dt(cfg)
    return {"wq": _dense_init(gen, (d, H * hd), dt),
            "wk": _dense_init(gen, (d, H * hd), dt),
            "wv": _dense_init(gen, (d, H * hd), dt),
            "wo": _dense_init(gen, (H * hd, d), dt)}


def cross_attention_block(p: Params, x: torch.Tensor, enc: torch.Tensor,
                          cfg: ArchConfig, tp=None) -> torch.Tensor:
    """x: (B, S, d) queries; enc: (B, T, d) encoder output (keys and
    values) -> (B, S, d) in x's dtype. Plain non-causal attention, as in
    the reference. A float32 ``enc`` makes K and V float32 (JAX's
    promotion), and the output is cast back to the queries' dtype. Over a
    model axis ``tp`` each rank attends with its heads (K/V from the
    replicated ``enc``) and its rows of ``wo``, the outputs summed."""
    B, S, _ = x.shape
    T = enc.shape[1]
    hd = cfg.head_dim
    cut = _HeadCut(p, cfg, tp, cfg.n_heads, cfg.n_heads)
    if tp is not None and cut.split:
        x, enc = tp.copy_in(x), tp.copy_in(enc)
    q = cut.project(x, p["wq"], cut.q_split, tp).reshape(B, S, -1, hd)
    k = cut.project(enc, p["wk"], cut.k_split, tp).reshape(B, T, -1, hd)
    v = cut.project(enc, p["wv"], cut.k_split, tp).reshape(B, T, -1, hd)
    out = _naive_attention(*cut.attended(q, k, v), causal=False, window=0)
    return cut.out(out, p, tp)
