"""Plain PyTorch version of the coordinate-wise trimmed mean: the port of
``repro.kernels.trimmed_mean.ref``.

This is the Byzantine filter of Algorithm 2 (lines 9 and 18) applied per
coordinate over a worker axis (the paper's "collection of scalar
dynamics"): for every coordinate independently, drop the F largest and
the F smallest of the W worker values and average the survivors. The CPU
path of the aggregators runs this, and the CUDA kernel K4 is held against
it on the card.
"""
from __future__ import annotations

import torch

__all__ = ["trimmed_mean_ref"]


# columns sorted at once: the sort's values and int64 indices take 12 W
# bytes a column, 36 GB for three copies of OLMoE-1B-7B's 1.05e9 at once
CHUNK = 1 << 24


def trimmed_mean_ref(x: torch.Tensor, F: int) -> torch.Tensor:
    """x: (W, D) worker values -> (D,) trimmed mean with 2F dropped.

    Requires W > 2F. Sort-based, so ties count once per occurrence and NaN
    sorts above +inf, as in the reference's ``jnp.sort``. The columns are
    sorted ``CHUNK`` at a time, each independently, so the result is that
    of one sort."""
    W = x.shape[0]
    if W <= 2 * F:
        raise ValueError(f"need W > 2F, got W={W}, F={F}")
    if F == 0:
        return x.mean(dim=0)
    out = x.new_empty(x.shape[1:])
    for c0 in range(0, x.shape[1], CHUNK):
        xc = x[:, c0:c0 + CHUNK]
        # every NaN the positive one: the card's sort puts a NaN with the
        # sign bit set first in a column of more than 32 values, where
        # jnp.sort puts every NaN last
        s = torch.sort(torch.where(xc.isnan(), torch.nan, xc), dim=0).values
        out[c0:c0 + CHUNK] = s[F:W - F].mean(dim=0)
    return out
