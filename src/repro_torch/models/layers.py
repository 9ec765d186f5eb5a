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
from ..kernels.swa import attn_decode, swa_prefill
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


def _qk_project(p: Params, x: torch.Tensor, cfg: ArchConfig, positions):
    """-> q (B, S, H, dh), k and v (B, S, Hkv, dh); v is a view of the
    projection."""
    B, S, _ = x.shape
    hd, Hkv = cfg.head_dim, cfg.n_kv_heads
    H = _n_heads_eff(cfg)
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
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


def attention_block(p: Params, x: torch.Tensor, cfg: ArchConfig,
                    positions: torch.Tensor, *, window: int = 0,
                    causal: bool = True,
                    backend: str = "auto") -> torch.Tensor:
    """x: (B, S, d) pre-normed input -> (B, S, d). Causal attention takes
    the kernel route; non-causal (Whisper's encoder) is plain torch."""
    q, k, v = _qk_project(p, x, cfg, positions)
    if causal:
        out = causal_attention(q, k, v, cfg, window=window, backend=backend)
    else:
        out = _plain_attention(q, k, v, cfg, causal=False, window=window)
    B, S, H, dh = out.shape
    return out.reshape(B, S, H * dh) @ p["wo"]


def attention_decode(p: Params, x: torch.Tensor, cfg: ArchConfig,
                     cache: Params, *, backend: str = "auto"
                     ) -> tuple[torch.Tensor, Params]:
    """Single-token decode against a (ring-buffer when windowed) KV cache.

    x: (B, 1, d); cache ``{"k", "v": (B, Hkv, Wc, dh), "pos": (B,) int32}``.
    Unlike the reference, which returns a new cache, the new K/V row is
    written into ``cache`` in place and ``pos`` advanced in place; the same
    dict is returned. The window is the cache's own length (an ``swa``
    layer's cache holds ``min(cache_len, window)`` rows), so, as in the
    reference, no window argument is needed."""
    B = x.shape[0]
    hd = cfg.head_dim
    H = _n_heads_eff(cfg)
    pos = cache["pos"]                 # absolute position of the new token
    q, k, v = _qk_project(p, x, cfg, pos[:, None])
    Wc = cache["k"].shape[2]
    slot = pos.long() % Wc             # ring buffer; append while pos < Wc
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, :, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, :, slot] = v[:, 0].to(cache["v"].dtype)
    lengths = torch.clamp_max(pos + 1, Wc).to(torch.int32)
    out = attn_decode(q[:, 0], cache["k"], cache["v"], lengths,
                      backend=backend)
    y = out.reshape(B, 1, H * hd).to(x.dtype) @ p["wo"]
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


def mlp_block(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The activation computes in float32 and is cast back to x's dtype
    before the product, as in the reference."""
    if "w_gate" in p:
        act = F.silu if cfg.act == "swiglu" else _gelu
        h = act((x @ p["w_gate"]).float()).to(x.dtype) * (x @ p["w_up"])
    else:
        h = _gelu((x @ p["w_up"]).float()).to(x.dtype)
    return h @ p["w_down"]


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


def moe_block(p: Params, x: torch.Tensor, cfg: ArchConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE with per-expert capacity -> (y, aux): the
    reference's ``_moe_block_gspmd`` (its ``moe_block`` takes that path
    whenever no mesh has a "model" axis, as on one card).

    Renormalized gates; the Switch aux ``E sum_e f_e P_e router_aux_coef``;
    the (E cap, d) dispatch buffer, in which assignments ranked at or past
    ``cap`` are dropped with their gate mass; the expert FFN as batched
    products over the expert axis; the gate-weighted combine, the k
    products (rounded to x's dtype, as the reference's are) summed in
    float32."""
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


def _wkv6_inputs(p: Params, x: torch.Tensor, x_prev: torch.Tensor,
                 cfg: ArchConfig):
    """Token shift and the five projections -> r, k, v, g (x's dtype) and
    the float32 log-decay ``lw = -exp(clip(w0 + tanh(x A) B, -8, 4))``."""
    mix = _lerp_mixes(p["mu"], x, x_prev)
    r = mix(0) @ p["wr"]
    k = mix(1) @ p["wk"]
    v = mix(2) @ p["wv"]
    g = mix(3) @ p["wg"]
    ww = torch.tanh((mix(4) @ p["w_lora_a"]).float()) \
        @ p["w_lora_b"].float()
    lw = -torch.exp(torch.clamp(p["w0"] + ww, -8.0, 4.0))
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
              dtype: torch.dtype) -> torch.Tensor:
    """Groupnorm, the silu gate and the output projection."""
    y = _wkv_groupnorm(y, p["ln_x"], H)
    y = y * F.silu(g.float()).to(dtype)
    return y @ p["wo"]


def wkv6_mix(p: Params, x: torch.Tensor, x_prev: torch.Tensor,
             cfg: ArchConfig, backend: str = "auto"
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The time mix over a whole sequence from a zero state -> (out (B, S,
    d), final state (B, H, hd, hd) float32). The scan gets (B, H, S, hd)
    views of the projections and returns y in the (B, S, H, hd) layout on
    the card, so no transposed copy is made there."""
    B, S, d = x.shape
    hd = cfg.wkv_head_dim
    H = d // hd
    r, k, v, g, lw = _wkv6_inputs(p, x, x_prev, cfg)

    def heads(a):
        return a.view(B, S, H, hd).transpose(1, 2)

    y, s = wkv6(heads(r), heads(k), heads(v), heads(lw),
                p["u"].expand(B, H, hd), backend=backend)
    y = y.transpose(1, 2).reshape(B, S, d)
    return _wkv6_out(p, y, g, H, x.dtype), s


def wkv6_block(p: Params, x: torch.Tensor, cfg: ArchConfig,
               backend: str = "auto") -> torch.Tensor:
    """Training/prefill path (full sequence, pre-normed input)."""
    return wkv6_mix(p, x, _shift(x), cfg, backend)[0]


def wkv6_decode(p: Params, x: torch.Tensor, cfg: ArchConfig,
                cache: Params) -> tuple[torch.Tensor, Params]:
    """Single-token decode. cache ``{"state": (B, H, hd, hd) float32,
    "x_prev": (B, d)}``, updated in place (the reference returns a new
    one); the same dict is returned."""
    B, _, d = x.shape
    hd = cfg.wkv_head_dim
    H = d // hd
    r, k, v, g, lw = _wkv6_inputs(p, x, cache["x_prev"][:, None, :], cfg)

    def heads(a):
        return a[:, 0].reshape(B * H, hd)

    y, s_new = wkv6_decode_step(
        heads(r), heads(k), heads(v), heads(lw),
        p["u"].expand(B, H, hd).reshape(B * H, hd),
        cache["state"].reshape(B * H, hd, hd))
    out = _wkv6_out(p, y.reshape(B, 1, d), g, H, x.dtype)
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
                  x_prev: torch.Tensor | None = None) -> torch.Tensor:
    """RWKV channel mix; ``x_prev`` defaults to x shifted by one token."""
    mix = _lerp_mixes(p["mu"], x, _shift(x) if x_prev is None else x_prev)
    kk = torch.square(torch.relu((mix(0) @ p["wk"]).float())).to(x.dtype)
    r = torch.sigmoid((mix(1) @ p["wr"]).float()).to(x.dtype)
    return r * (kk @ p["wv"])


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


def _rglru_core(p: Params, xw: torch.Tensor, h0=None):
    """xw: (B, S, w) post-conv activations -> (h, a, b), float32."""
    xf = xw.float()
    r = torch.sigmoid(xf @ p["wa"].float())
    i = torch.sigmoid(xf @ p["wx"].float())
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


def rglru_mix(p: Params, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrent block over a whole sequence from a zero state ->
    (out (B, S, d), the input projection xw (B, S, w), h (B, S, w)
    float32): prefill keeps xw's last rows and h's last row."""
    xw = x @ p["w_in"]
    h, _, _ = _rglru_core(p, _causal_conv(p, xw))
    gate = _gelu((x @ p["w_gate_branch"]).float())
    return (h * gate).to(x.dtype) @ p["w_out"], xw, h


def rglru_block(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Training/prefill path (full sequence, pre-normed input)."""
    return rglru_mix(p, x)[0]


def rglru_decode(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 cache: Params) -> tuple[torch.Tensor, Params]:
    """Single-token decode. cache ``{"h": (B, w) float32, "conv": (B, 3,
    w)}``, updated in place (the reference returns a new one); the same
    dict is returned."""
    xw = x @ p["w_in"]                                   # (B, 1, w)
    hist = torch.cat([cache["conv"], xw.to(cache["conv"].dtype)], dim=1)
    conv = (torch.einsum("btw,tw->bw", hist.float(), p["conv_w"].float())
            + p["conv_b"].float())[:, None, :]
    h, _, _ = _rglru_core(p, conv, h0=cache["h"])
    h = h[:, 0]
    gate = _gelu((x[:, 0] @ p["w_gate_branch"]).float())
    y = (h * gate).to(x.dtype) @ p["w_out"]
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
                          cfg: ArchConfig) -> torch.Tensor:
    """x: (B, S, d) queries; enc: (B, T, d) encoder output (keys and
    values) -> (B, S, d) in x's dtype. Plain non-causal attention, as in
    the reference. A float32 ``enc`` makes K and V float32 (JAX's
    promotion), and the output is cast back to the queries' dtype."""
    B, S, _ = x.shape
    T = enc.shape[1]
    hd, H = cfg.head_dim, cfg.n_heads
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = _matmul(enc, p["wk"]).reshape(B, T, H, hd)
    v = _matmul(enc, p["wv"]).reshape(B, T, H, hd)
    out = _naive_attention(q, k, v, causal=False, window=0)
    return out.reshape(B, S, H * hd) @ p["wo"]
