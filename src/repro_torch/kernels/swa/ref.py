"""Plain PyTorch versions of the two attention kernels of the serve path.

``attn_decode_ref`` is the port of ``repro.kernels.swa.ref.attn_decode_ref``:
one query token per request attends to a KV cache of ``Wc`` entries, the
first ``lengths[b]`` of which are valid (a ring-buffer cache may be partly
filled), with grouped KV heads (query head ``h`` reads KV head ``h // G``).
The softmax runs in float32 with ``-inf`` masking, as the reference's does.

``swa_prefill_ref`` is the contract of ``repro.kernels.swa.prefill``'s
``swa_prefill_pallas`` in the port's ``(B, S, heads, dh)`` layout: causal,
optionally sliding-window (key ``t`` is seen by query ``s`` iff
``s - window < t <= s``) GQA attention, float32 scores masked with
``-1e30`` and divided by ``max(l, 1e-30)``, as the TPU kernel does.

The CUDA kernels (``csrc/attn_decode.cu``, ``csrc/swa_prefill.cu``) are held
against these on the card, and these against the JAX package on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["attn_decode_ref", "swa_prefill_ref"]

_NEG = -1e30
# live float32 scores of one batched pass of swa_prefill_ref
_SCORE_BYTES = 2 << 30


def attn_decode_ref(
    q: torch.Tensor,        # (B, H, dh)
    k: torch.Tensor,        # (B, Hkv, Wc, dh)
    v: torch.Tensor,        # (B, Hkv, Wc, dh)
    lengths: torch.Tensor,  # (B,) int — number of valid cache entries
    scale: float | None = None,
) -> torch.Tensor:
    """Returns (B, H, dh) in q's dtype. Softmax in float32."""
    B, H, dh = q.shape
    Hkv, Wc = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = q.float() * (scale if scale is not None else dh ** -0.5)
    kf, vf = k.float(), v.float()
    qg = qf.reshape(B, Hkv, G, dh)
    scores = torch.einsum("bhgd,bhwd->bhgw", qg, kf)        # (B, Hkv, G, Wc)
    valid = (torch.arange(Wc, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])               # (B, Wc)
    scores = torch.where(valid[:, None, None, :], scores, -torch.inf)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgw,bhwd->bhgd", p, vf)
    return out.reshape(B, H, dh).to(q.dtype)


def swa_prefill_ref(
    q: torch.Tensor,   # (B, S, H, dh)
    k: torch.Tensor,   # (B, S, Hkv, dh)
    v: torch.Tensor,   # (B, S, Hkv, dh)
    window: int = 0,   # 0 = full causal
    scale: float | None = None,
) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention -> (B, S, H, dh) in
    q's dtype. Batched over the requests: one pass materializes the
    (B, Hkv, G, S, S) float32 scores of as many requests as keep them
    under ``_SCORE_BYTES`` (all 8 requests of a paper_sim training call,
    4 of a Qwen3-8B 2,048-token prefill), so the gradient recompute of
    :class:`.ops.SwaPrefillFn` runs in one pass where that fits."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    sc = scale if scale is not None else dh ** -0.5
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = ki <= qi
    if window:
        mask &= ki > qi - window
    per = max(1, _SCORE_BYTES // (H * S * S * 4))
    outs = []
    for b0 in range(0, B, per):
        n = min(per, B - b0)
        qg = (q[b0:b0 + n].float() * sc).reshape(n, S, Hkv, G, dh)
        s = torch.einsum("bshgd,bthd->bhgst", qg, k[b0:b0 + n].float())
        s = torch.where(mask, s, _NEG)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1).clamp_min(1e-30)              # (n, Hkv, G, S)
        o = torch.einsum("bhgst,bthd->bhgsd", p, v[b0:b0 + n].float())
        o = o / l[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(n, S, H, dh))
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out.to(q.dtype)
