"""Plain PyTorch versions of the RWKV6 (Finch) WKV recurrence: the port of
``repro.kernels.wkv6.ref``.

Per head with key size K and value size V, the data-dependent-decay
recurrence is

    S_t = diag(w_t) S_{t-1} + k_t v_t^T                 (S in R^{K x V})
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

with ``w_t = exp(lw_t)``, per-channel log-decay ``lw_t <= 0``, and ``u``
the current-token bonus. Every function computes in float32 and returns
``y`` in ``r.dtype`` and the state in float32.

- :func:`wkv6_ref` — the sequential scan, the ground truth;
- :func:`wkv6_chunked_ref` — the chunked form of the TPU kernel and of
  ``wkv6_chunked_jnp``: the (C, C, K) pairwise decay built jointly, so
  every exponent is <= 0. It also takes a ragged last chunk (T not a
  multiple of ``chunk``), which the CUDA kernel K7 does; for T a multiple
  of ``chunk`` it is the reference's function;
- :func:`wkv6_decode_step` — one token against a carried state (decode
  needs no kernel).
"""
from __future__ import annotations

import torch

__all__ = ["wkv6_ref", "wkv6_chunked_ref", "wkv6_decode_step"]


def wkv6_ref(
    r: torch.Tensor,   # (BH, T, K) receptance
    k: torch.Tensor,   # (BH, T, K)
    v: torch.Tensor,   # (BH, T, V)
    lw: torch.Tensor,  # (BH, T, K) log-decay (<= 0)
    u: torch.Tensor,   # (BH, K) bonus
    s0: torch.Tensor | None = None,  # (BH, K, V) initial state
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential scan -> (y (BH, T, V), s_final (BH, K, V) float32)."""
    BH, T, K = r.shape
    V = v.shape[-1]
    rf, kf, vf = (a.float() for a in (r, k, v))
    wf = torch.exp(lw.float())
    uf = u.float()
    s = (torch.zeros((BH, K, V), device=r.device) if s0 is None
         else s0.float())
    ys = []
    for t in range(T):
        kv = kf[:, t, :, None] * vf[:, t, None, :]          # (BH, K, V)
        ys.append(torch.einsum("bk,bkv->bv", rf[:, t],
                               s + uf[:, :, None] * kv))
        s = wf[:, t, :, None] * s + kv
    y = torch.stack(ys, dim=1) if ys else vf.new_zeros((BH, 0, V))
    return y.to(r.dtype), s


def wkv6_chunked_ref(
    r: torch.Tensor,   # (BH, T, K)
    k: torch.Tensor,   # (BH, T, K)
    v: torch.Tensor,   # (BH, T, V)
    lw: torch.Tensor,  # (BH, T, K) log-decay (<= 0)
    u: torch.Tensor,   # (BH, K)
    chunk: int = 64,
    s0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6, the same math as the TPU kernel (see
    ``src/repro/kernels/wkv6/wkv6.py``). Within a chunk, with P the
    inclusive and E = P - lw the exclusive cumsum of the log-decay:

        y_i   = (r_i . exp(E_i)) @ S + sum_{j<i} [sum_k r_i k_j
                exp(E_i - P_j)] v_j + (r_i . u . k_i) v_i
        S_end = diag(exp(P_last)) S + sum_j (k_j . exp(P_last - P_j))^T v_j

    -> (y (BH, T, V) in r.dtype, s_final (BH, K, V) float32)."""
    BH, T, K = r.shape
    V = v.shape[-1]
    rf, kf, vf, lwf = (a.float() for a in (r, k, v, lw))
    uf = u.float()
    s = (torch.zeros((BH, K, V), device=r.device) if s0 is None
         else s0.float())
    ys = []
    for c0 in range(0, T, chunk):
        c1 = min(c0 + chunk, T)
        C = c1 - c0
        rc, kc, vc, lwc = (a[:, c0:c1] for a in (rf, kf, vf, lwf))
        P = torch.cumsum(lwc, dim=1)                     # (BH, C, K)
        E = P - lwc
        y = torch.einsum("bik,bkv->biv", rc * torch.exp(E), s)
        causal = torch.ones((C, C), dtype=torch.bool, device=r.device) \
            .tril(-1)[None, :, :, None]                  # j < i
        D = E[:, :, None, :] - P[:, None, :, :]          # (BH, C, C, K)
        A = torch.where(causal, torch.exp(torch.where(causal, D, 0.0)), 0.0)
        scores = torch.einsum("bik,bjk,bijk->bij", rc, kc, A)
        y = y + torch.einsum("bij,bjv->biv", scores, vc)
        y = y + (rc * uf[:, None, :] * kc).sum(dim=2, keepdim=True) * vc
        p_last = P[:, -1]
        k_dec = kc * torch.exp(p_last[:, None, :] - P)
        s = torch.exp(p_last)[:, :, None] * s + torch.einsum(
            "bjk,bjv->bkv", k_dec, vc)
        ys.append(y)
    y = torch.cat(ys, dim=1) if ys else vf.new_zeros((BH, 0, V))
    return y.to(r.dtype), s


def wkv6_decode_step(
    r: torch.Tensor,   # (BH, K)
    k: torch.Tensor,   # (BH, K)
    v: torch.Tensor,   # (BH, V)
    lw: torch.Tensor,  # (BH, K)
    u: torch.Tensor,   # (BH, K)
    s: torch.Tensor,   # (BH, K, V)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token decode -> (y (BH, V) in r.dtype, s_new float32).
    O(K V) a head: no kernel (the reference computes it outside any
    Pallas kernel too)."""
    rf, kf, vf = (a.float() for a in (r, k, v))
    wf = torch.exp(lw.float())
    kv = kf[:, :, None] * vf[:, None, :]
    y = torch.einsum("bk,bkv->bv", rf, s + u.float()[:, :, None] * kv)
    s_new = wf[:, :, None] * s + kv
    return y.to(r.dtype), s_new
