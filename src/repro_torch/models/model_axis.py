"""The model axis of the model stack: tensor parallelism in the Megatron
layout that ``distributed.sharding.param_specs`` gives, and the reference's
expert parallelism (``moe_impl="sharded"``).

Each rank of the "model" dimension holds the column-split ``wq``, ``wk``,
``wv``, ``w_gate`` and ``w_up``, the row-split ``wo`` and ``w_down``, the
embedding's rows and the LM head's columns of its vocabulary block, and
E / mp experts; it runs attention on its whole local heads. Activations
between blocks are replicated over the axis. Two operators carry them
across a split region, each a ``torch.autograd.Function`` of its own:

* ``copy_in`` (Megatron's f): identity forward, ``all_reduce`` backward,
  in front of a column-split product (and on a replicated weight used
  inside the split region: the qk-norm scales, the MoE router), whose
  gradient each rank holds only its part of;
* ``reduce_out`` (g): ``all_reduce`` forward, identity backward, after a
  row-split product or the masked embedding lookup.

``torch.distributed.nn.functional.all_reduce`` is not used for g: its
backward all-reduces the gradient too, which after g is already
replicated, so it would multiply it by mp.

``gather_last`` concatenates the vocabulary-split logits (its backward
keeps this rank's columns); ``mean_model`` averages a value the ranks
compute alike (the MoE aux; backward ÷ mp, so that summing the router's
gradient over the axis counts the aux once); ``mean_batch`` is the aux's
``pmean`` over the batch axes (backward identity: the trainer averages
the gradients over those axes afterwards).

The families of this slice are the attention decoders (dense GQA and the
MoE). :func:`check_model_axis` raises NotImplementedError for a model or
a split that the local-head forward cannot run (ROADMAP item 8c).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig

__all__ = ["ModelAxis", "check_model_axis"]

_LATER = "ROADMAP item 8c"


def check_model_axis(cfg: ArchConfig, mp: int) -> None:
    """Raise NotImplementedError where ``mp`` model ranks cannot run
    ``cfg`` on whole local heads, experts and vocabulary blocks."""
    if mp == 1:
        return
    kinds = set(cfg.block_pattern)
    if not kinds <= {"attn", "swa"} or cfg.encoder_layers or \
            cfg.family == "vlm" or cfg.parallel_block:
        raise NotImplementedError(
            f"{cfg.name}: the model axis runs the attention decoders "
            f"(dense GQA and the MoE); {sorted(kinds)} mixers, encoders, "
            f"patch projectors and parallel blocks over a model axis are "
            f"{_LATER}")
    H = max(cfg.n_heads, cfg.pad_heads_to or 0)
    for what, n in (("query heads", H), ("KV heads", cfg.n_kv_heads),
                    ("vocabulary rows", cfg.vocab),
                    ("experts" if cfg.is_moe else "d_ff columns",
                     cfg.n_experts if cfg.is_moe else cfg.d_ff)):
        if n % mp:
            raise NotImplementedError(
                f"{cfg.name}: {n} {what} do not split over model={mp}, so "
                f"param_specs leaves the weight whole or splits it inside "
                f"a head; such splits (the reference's sequence-parallel "
                f"KV cache, odd vocabularies) are {_LATER}")


class ModelAxis:
    """The "model" dimension of one rank's mesh, through ``comm`` (a
    :class:`~repro_torch.distributed.comm.Comm`). ``batch_axes``: the
    dimensions the MoE aux is averaged over (the batch's: (pod, data) for
    serving and the mean step; none for a robust worker, whose batch is
    its own)."""

    def __init__(self, comm, batch_axes: tuple[str, ...] = ("pod", "data")):
        self.comm = comm
        self.size = comm.mesh.size("model")
        self.rank = comm.mesh.index("model")
        self.batch_axes = tuple(a for a in batch_axes
                                if comm.mesh.size(a) > 1)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceOut.apply(x, self)

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherLast.apply(x, self)

    def mean_model(self, x: torch.Tensor) -> torch.Tensor:
        return _MeanModel.apply(x, self)

    def mean_batch(self, x: torch.Tensor) -> torch.Tensor:
        if not self.batch_axes:
            return x
        return _MeanBatch.apply(x, self)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.all_reduce(x, "model")


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.ax.all_reduce(g.contiguous().clone()), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return ax.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax, ctx.n = ax, x.shape[-1]
        parts = ax.comm.all_gather(x.contiguous(), "model")
        return torch.cat(list(parts.unbind(0)), dim=-1)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.ax.rank, ctx.n
        return g[..., r * n:(r + 1) * n], None


class _MeanModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return ax.all_reduce(x.clone()) / ax.size

    @staticmethod
    def backward(ctx, g):
        return g / ctx.ax.size, None


class _MeanBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        n = ax.comm.mesh.size(*ax.batch_axes)
        return ax.comm.all_reduce(x.clone(), ax.batch_axes) / n

    @staticmethod
    def backward(ctx, g):
        return g, None
