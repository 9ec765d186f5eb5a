"""Plain PyTorch version of the fused innovation + belief step, the port of
``repro.kernels.social_innov.ref``. Per agent ``j`` independently:

    sig[j]    = min(#{ s : u[j] > cdf[j, s] }, S - 1)   (inverse-CDF sample)
    loglik[j] = log_tables[j, :, sig[j]]                ((m,) gather)
    z_new[j]  = z[j] + loglik[j]                        (dual accumulator)
    mu[j]     = softmax(z_new[j] / max(mass[j], 1e-30)) (KL-prox belief)

The clamp keeps a uniform above an fp32 cumsum that ends below 1.0 on the
last letter. The CPU path of the engines runs this, and the CUDA kernel is
held against it.

``accum_dtype`` is the precision policy's accumulation slot: the sum
``z + loglik`` and the belief run in it and ``mu`` comes out in it, while
``z_new`` is that sum rounded to ``z``'s (storage) dtype; ``None`` keeps
``z.dtype`` throughout.
"""
from __future__ import annotations

import torch

__all__ = ["innovation_ref", "sample_signals"]


def sample_signals(u: torch.Tensor, cdf: torch.Tensor) -> torch.Tensor:
    """(N,) int64 inverse-CDF letters of the uniforms ``u`` (N,) under the
    row-wise inclusive cumsums ``cdf`` (N, S)."""
    return (u[:, None] > cdf).sum(dim=-1).clamp_max(cdf.shape[1] - 1)


def innovation_ref(
    z: torch.Tensor,           # (N, m) log-likelihood accumulator
    mass: torch.Tensor,        # (N,)  push-sum mass
    u: torch.Tensor,           # (N,)  uniforms for this iteration
    cdf: torch.Tensor,         # (N, S) inclusive cumsum of truth-row probs
    log_tables: torch.Tensor,  # (N, m, S) log l_j(s | theta_k)
    accum_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(z_new (N, m), mu (N, m))``."""
    ad = z.dtype if accum_dtype is None else accum_dtype
    sig = sample_signals(u, cdf)
    idx = sig[:, None, None].expand(-1, log_tables.shape[1], 1)
    z_acc = z.to(ad) + log_tables.gather(2, idx)[:, :, 0].to(ad)
    mu = torch.softmax(z_acc / mass.to(ad).clamp_min(1e-30)[:, None],
                       dim=-1)
    return z_acc.to(z.dtype), mu
