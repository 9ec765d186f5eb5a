"""Plain PyTorch versions of the two attention kernels of the serve path.

``attn_decode_ref`` is the port of ``repro.kernels.swa.ref.attn_decode_ref``:
one query token per request attends to a KV cache of ``Wc`` entries, the
first ``lengths[b]`` of which are valid (a ring-buffer cache may be partly
filled), with grouped KV heads (query head ``h`` reads KV head ``h // G``).
The softmax runs in float32 with ``-inf`` masking, as the reference's does.

``attn_decode_partial_ref`` is the same attention over one rank's block of
the ring's rows, unnormalised: the float32 ``(acc, m, l)`` triple of the
online softmax (acc = sum_w exp(s_w - m) v_w, m the row max, l the exp-sum),
which a sequence-split cache hands to :func:`attn_decode_merge_ref`; the
merge of the blocks' triples is the attention over their union. A block
with no valid row gives ``m = -inf, l = 0, acc = 0``, and the merge gives
it weight 0.

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

__all__ = ["attn_decode_ref", "attn_decode_partial_ref",
           "attn_decode_merge_ref", "swa_prefill_ref"]

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


def attn_decode_partial_ref(
    q: torch.Tensor,        # (B, H, dh)
    k: torch.Tensor,        # (B, Hkv, Wb, dh): a block of the ring's rows
    v: torch.Tensor,        # (B, Hkv, Wb, dh)
    lengths: torch.Tensor,  # (B,) int — valid rows of the block
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (acc (B, H, dh), m (B, H), l (B, H)), float32: the online
    softmax's triple over the first ``lengths[b]`` rows of the block."""
    B, H, dh = q.shape
    Hkv, Wb = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = q.float() * (scale if scale is not None else dh ** -0.5)
    qg = qf.reshape(B, Hkv, G, dh)
    scores = torch.einsum("bhgd,bhwd->bhgw", qg, k.float())
    valid = (torch.arange(Wb, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])               # (B, Wb)
    scores = torch.where(valid[:, None, None, :], scores, -torch.inf)
    m = scores.amax(dim=-1)                                 # (B, Hkv, G)
    p = torch.exp(scores - torch.where(m == -torch.inf, 0.0, m)[..., None])
    acc = torch.einsum("bhgw,bhwd->bhgd", p, v.float())
    return (acc.reshape(B, H, dh), m.reshape(B, H),
            p.sum(dim=-1).reshape(B, H))


def attn_decode_merge_ref(
    acc: torch.Tensor,      # (n, B, H, dh) float32: n blocks' partials
    m: torch.Tensor,        # (n, B, H)
    l: torch.Tensor,        # (n, B, H)
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The attention over the union of n blocks from their triples ->
    (B, H, dh) in ``dtype``: each block weighted by ``exp(m - max m)``
    (0 for an empty block); 0 / 0 = NaN where every block is empty, as
    :func:`attn_decode_ref` gives for a request of length 0."""
    M = m.amax(dim=0)
    c = torch.where(m == -torch.inf, 0.0,
                    torch.exp(m - torch.where(M == -torch.inf, 0.0, M)))
    L = (c * l).sum(dim=0)
    A = (c[..., None] * acc).sum(dim=0)
    return (A / L[..., None]).to(dtype)


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
