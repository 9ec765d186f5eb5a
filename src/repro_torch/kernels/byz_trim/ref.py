"""Plain PyTorch version of the Byzantine trim-gather: gather, ``where``,
sort along the slot axis, rank mask, sum — the port of
``repro.kernels.byz_trim.ref``.

The contract, per receiver ``j`` and per pair coordinate ``p``
independently (the paper's "collection of scalar dynamics"):

    vals[j, k, p] = byz_msgs[j, k, p]      if byz_nbr[j, k]
                    r[nbr_idx[j, k], p]    otherwise
    drop slots with nbr_valid[j, k] == False,
    drop the F largest and F smallest of the remaining values,
    trimmed_sum[j, p] = sum of the survivors
    kept[j]           = max(deg_j - 2F, 0)

F is one count for every receiver, or an (N,) integer tensor of each
receiver's own.

``kept`` is the survivor count Algorithm 2's update divides by; it does not
depend on the pair coordinate because padding is per slot, not per value.
Any ``byz_msgs`` view is accepted, including the stride-0 ``expand`` of a
broadcast attack. The CPU path of the engine runs this, and the CUDA kernel
is held against it.

``accum_dtype`` is the precision policy's accumulation slot: the values
are gathered, padded and sorted in the storage dtype of ``r`` (the pad
``finfo(r.dtype).max / 4`` too), and the survivor sum and ``kept`` are
taken in ``accum_dtype`` (``None`` keeps ``r.dtype``).
"""
from __future__ import annotations

import torch

__all__ = ["trim_gather_ref"]


def trim_gather_ref(
    r: torch.Tensor,          # (N, P) current statistics, P pair coordinates
    nbr_idx: torch.Tensor,    # (N, deg_max) int32 sender per slot
    nbr_valid: torch.Tensor,  # (N, deg_max) bool
    byz_msgs: torch.Tensor,   # (N, deg_max, P) attack values per slot
    byz_nbr: torch.Tensor,    # (N, deg_max) bool — slot's sender is Byzantine
    F: int | torch.Tensor,    # int, or (N,) per receiver
    accum_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(trimmed_sum (N, P), kept (N,) float)``."""
    ad = r.dtype if accum_dtype is None else accum_dtype
    big = torch.finfo(r.dtype).max / 4
    gathered = r[nbr_idx.long()]                            # (N, deg_max, P)
    vals = torch.where(byz_nbr[:, :, None], byz_msgs, gathered)
    masked = torch.where(nbr_valid[:, :, None], vals, big)  # pads sort high
    # every NaN the positive one: the card's sort puts a NaN with the sign
    # bit set first in a long row, where jnp.sort puts every NaN last
    s = torch.sort(torch.where(masked.isnan(), torch.nan, masked),
                   dim=1).values
    deg = nbr_valid.sum(dim=1)                              # (N,)
    if isinstance(F, torch.Tensor):
        F = F.to(deg.dtype)
        f3 = F[:, None, None]
    else:
        f3 = F
    ranks = torch.arange(masked.shape[1], device=r.device)[None, :, None]
    keep = (ranks >= f3) & (ranks < (deg[:, None, None] - f3))
    tsum = (s.to(ad) * keep.to(ad)).sum(dim=1)
    kept = (deg - 2 * F).clamp_min(0).to(ad)
    return tsum, kept
