"""The precision policy: storage, compute and accumulation dtypes.

The port of ``repro.core.precision``. Every engine is memory-bound: a
round streams the (E, d+1) relay state and the (N, d+1) node state. The
algorithms need full precision only in their reductions (the push-sum
receiver sums, the fusion pools, the trimmed sums, the innovation
accumulation), so storage can drop to bfloat16 or float16 while every
reduction stays float32, about halving the bytes a round moves.

:class:`Policy` is a NamedTuple of dtype *names*, threaded as ``policy=``
through :func:`repro_torch.core.pushsum.sparse_pushsum_step`, the engines'
loops, their grids (``ExecutionPlan(policy=...)``) and, as
``accum_dtype=``, through the three kernels of those loops (K1, K2, K3),
whose CUDA kernels read and write storage-typed state and accumulate in
float32:

* ``storage``: every persistent value (the node state, the relay
  latches, the async buffer, the carried belief and statistics);
* ``compute``: the dtype elementwise staging runs in;
* ``accum``: the dtype of every reduction; never below float32.

``policy=None`` and the :data:`FP32` policy run the pre-policy program
bit for bit: every cast is to the dtype the value already has.

``accum="float64"`` is accepted as the reference accepts it. The
reference runs without JAX's 64-bit mode, where a cast to float64 yields
float32, so its float64 accumulations are float32 arrays; the port
matches that: :attr:`Policy.accum_dtype` of ``"float64"`` is
``torch.float32``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Policy", "FP32", "BF16", "resolve_policy", "policy_dtypes",
           "HALF_DTYPES"]

# the names each slot accepts; accum only full-precision floats
_STORAGE_DTYPES = ("float32", "bfloat16", "float16")
_COMPUTE_DTYPES = ("float32", "bfloat16", "float16")
_ACCUM_DTYPES = ("float32", "float64")

# each name's dtype as the reference's arrays take it without 64-bit mode
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "float64": torch.float32}

#: the half storage dtypes, which the diagnostics upcast to float32
HALF_DTYPES = (torch.bfloat16, torch.float16)


class Policy(NamedTuple):
    """Storage / compute / accumulation dtype split, as dtype names."""

    storage: str = "float32"
    compute: str = "float32"
    accum: str = "float32"

    @property
    def storage_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.storage]

    @property
    def compute_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.compute]

    @property
    def accum_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.accum]

    @property
    def storage_bytes(self) -> int:
        """Bytes of one stored element."""
        return self.storage_dtype.itemsize

    @property
    def is_default(self) -> bool:
        """True iff this policy runs the pre-policy program."""
        return self == FP32

    def validate(self) -> "Policy":
        if self.storage not in _STORAGE_DTYPES:
            raise ValueError(
                f"policy storage dtype {self.storage!r} not in "
                f"{_STORAGE_DTYPES}")
        if self.compute not in _COMPUTE_DTYPES:
            raise ValueError(
                f"policy compute dtype {self.compute!r} not in "
                f"{_COMPUTE_DTYPES}")
        if self.accum not in _ACCUM_DTYPES:
            raise ValueError(
                f"policy accum dtype {self.accum!r} must be a "
                f"full-precision float {_ACCUM_DTYPES}: reductions never "
                "run below fp32")
        return self

    def tag(self) -> str:
        """``fp32``, ``bf16``, or the explicit triple."""
        for name, pol in _NAMED.items():
            if self == pol:
                return name
        return f"{self.storage}/{self.compute}/{self.accum}"


FP32 = Policy()
BF16 = Policy(storage="bfloat16")

_NAMED = {"fp32": FP32, "bf16": BF16}


def resolve_policy(policy) -> Policy:
    """``None`` (fp32), a name (``"fp32"``, ``"bf16"``) or a
    :class:`Policy` -> a validated :class:`Policy`."""
    if policy is None:
        return FP32
    if isinstance(policy, str):
        try:
            return _NAMED[policy]
        except KeyError:
            raise ValueError(
                f"unknown policy name {policy!r}; choose from "
                f"{sorted(_NAMED)} or pass a Policy(...)") from None
    if isinstance(policy, Policy):
        return policy.validate()
    raise TypeError(
        f"policy must be None, a name, or a Policy; got {type(policy)!r}")


def policy_dtypes(policy, like: torch.dtype = torch.float32):
    """``(storage, compute, accum)`` torch dtypes of ``policy``; ``None``
    gives ``like`` for all three (the dtype-transparent pre-policy
    program)."""
    if policy is None:
        return like, like, like
    pol = resolve_policy(policy)
    return pol.storage_dtype, pol.compute_dtype, pol.accum_dtype
