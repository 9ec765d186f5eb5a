"""Byzantine trim-gather: the gossip half of one Algorithm 2 round, per
receiver j of the padded in-neighbor lists and pair coordinate p:

    vals[j, k] = byz_msgs[j, k] if byz_nbr[j, k] else r[nbr_idx[j, k]]
    drop invalid slots, then the F largest and F smallest values
    trimmed_sum[j] = sum of the survivors;  kept[j] = max(deg_j - 2F, 0)

:mod:`.ref` is the plain PyTorch version and :mod:`.ops` the route dispatch
and the CUDA kernel's wrapper.
"""
from .ops import DEG_MAX_CAP, trim_gather, trim_gather_cuda, trim_gather_pairs
from .ref import trim_gather_ref

__all__ = ["trim_gather", "trim_gather_pairs", "trim_gather_cuda",
           "trim_gather_ref", "DEG_MAX_CAP"]
