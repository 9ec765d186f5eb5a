"""The model axis of the model stack: tensor parallelism in the Megatron
layout that ``distributed.sharding.param_specs`` gives, and the reference's
expert parallelism (``moe_impl="sharded"``).

Each rank of the "model" dimension holds the blocks ``param_specs`` gives
it: the column-split ``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up``,
``w_in``, ``w_gate_branch``, ``w1`` and RWKV6's projections, the row-split
``wo``, ``w_down``, ``w_out`` and ``w2``, the embedding's rows and the LM
head's columns of its vocabulary block, and E / mp experts; a weight whose
dimension the extent does not divide is whole (``fit_spec``). Its caches
are the blocks ``cache_specs`` gives: its KV heads, or, where the KV heads
do not split, its block of the ring's rows (the sequence-parallel cache);
its RWKV6 heads; its RG-LRU channels. The layers read which is which from
the shapes of the blocks a rank holds and from the spec trees; nothing
here recomputes a divisibility rule of its own.

Activations between blocks are replicated over the axis. The operators
that carry them across a split region are each a
``torch.autograd.Function`` of its own:

* ``copy_in`` (Megatron's f): identity forward, ``all_reduce`` backward,
  in front of a column-split product (and on a replicated weight used
  inside the split region: the qk-norm scales, the MoE router, RWKV6's
  mixes, decays and group norm, the RG-LRU's gates), whose gradient each
  rank holds only its part of;
* ``reduce_out`` (g): ``all_reduce`` forward, identity backward, after a
  row-split product or the masked embedding lookup;
* ``gather_last``: the column blocks concatenated, for a consumer that is
  replicated (the vocabulary-split logits, the channel mix's output): its
  backward keeps this rank's columns;
* ``gather_cols``: the column blocks concatenated, for a consumer that
  uses a part of them on each rank (the query, key and value columns of a
  split inside a head, the RG-LRU's conv output): its backward sums the
  ranks' gradients, then keeps this rank's columns;
* ``scatter_last``: a partial sum over the axis cut to this rank's block
  of the last dimension (the channel mix's ``kk @ wv`` against its
  ``r`` block): its backward gathers the blocks' gradients;
* ``mean_model`` averages a value the ranks compute alike (the MoE aux;
  backward / mp, so that summing the router's gradient over the axis counts
  the aux once); ``mean_batch`` is the aux's ``pmean`` over the batch axes
  (backward identity: the trainer averages the gradients over those axes
  afterwards).

``torch.distributed.nn.functional.all_reduce`` is not used for g: its
backward all-reduces the gradient too, which after g is already
replicated, so it would multiply it by mp.

Serving runs every family over the axis (:func:`check_model_axis`); the
training steps run the attention decoders (dense GQA and the MoE) on whole
heads (``check_model_axis(..., train=True)``); FSDP and the other
families' training steps over a model axis are ROADMAP item 8c, part 3.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig

__all__ = ["ModelAxis", "check_model_axis"]

_TRAIN_LATER = "ROADMAP item 8c, part 3"


class _StandIn:
    """The mesh the spec rules read: one data rank, ``mp`` model ranks."""

    axis_names = ("data", "model")

    def __init__(self, mp: int):
        self.shape = {"data": 1, "model": mp}


def _leaf_specs(cfg: ArchConfig, mp: int) -> list[tuple[list, tuple, tuple]]:
    """(names, shape, spec) of every parameter leaf of ``cfg`` on a model
    axis of ``mp``: ``param_specs`` of ``param_shapes``."""
    from ..distributed.sharding import param_specs
    from .model import param_shapes

    out = []

    def walk(t, s, names):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k], names + [k])
        elif isinstance(t, (list, tuple)):
            for i, (a, b) in enumerate(zip(t, s)):
                walk(a, b, names + [str(i)])
        else:
            out.append((names, tuple(t.shape), s))

    shapes = param_shapes(cfg)
    walk(shapes, param_specs(shapes, cfg, _StandIn(mp)), [])
    return out


def check_model_axis(cfg: ArchConfig, mp: int, *,
                     train: bool = False) -> None:
    """Raise NotImplementedError where ``mp`` model ranks cannot run
    ``cfg``'s serve path (or, with ``train``, its training steps) on the
    blocks ``param_specs`` gives them.

    Serving runs every family over the axis, on whole or split heads, whole
    or split vocabularies, widths and d_ff. It raises for the MoE where the
    experts do not split (the expert-parallel dispatch needs E / mp
    experts a rank) and for RWKV6 where the column blocks of its
    projections fall inside a head (its scan runs on whole local heads).

    Training runs the attention decoders (dense GQA and the MoE, no
    parallel block) whose heads, KV heads, vocabulary rows and d_ff columns
    (or experts) all split into whole blocks; the other families, and
    splits inside a head, are ROADMAP item 8c, part 3."""
    if mp == 1:
        return
    leaves = _leaf_specs(cfg, mp)

    def split(spec) -> bool:
        return any(e is not None for e in spec)

    hd = cfg.head_dim
    for names, shape, spec in leaves:
        name = names[-1]
        if cfg.is_moe and "ffn" in names and name == "w_gate" and \
                spec[-3] is None:           # (E, d, f): the experts' axis
            raise NotImplementedError(
                f"{cfg.name}: {cfg.n_experts} experts do not split over "
                f"model={mp}; the expert-parallel dispatch runs E / mp "
                f"experts a rank")
        if "mixer" in names and name == "wr" and split(spec) and \
                (shape[-1] // mp) % cfg.wkv_head_dim:
            raise NotImplementedError(
                f"{cfg.name}: RWKV6's {shape[-1] // cfg.wkv_head_dim} heads "
                f"do not split over model={mp}; its scan runs on whole "
                f"local heads")
    if not train:
        return
    kinds = set(cfg.block_pattern)
    if not kinds <= {"attn", "swa"} or cfg.encoder_layers or \
            cfg.family == "vlm" or cfg.parallel_block:
        raise NotImplementedError(
            f"{cfg.name}: the training steps over a model axis run the "
            f"attention decoders (dense GQA and the MoE); {sorted(kinds)} "
            f"mixers, encoders, patch projectors and parallel blocks are "
            f"{_TRAIN_LATER}")
    for names, shape, spec in leaves:
        name = names[-1]
        if name not in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                        "embed", "lm_head"):
            continue
        whole_heads = name not in ("wq", "wk", "wv") or \
            (shape[-1] // mp) % hd == 0
        if not split(spec) or not whole_heads:
            raise NotImplementedError(
                f"{cfg.name}: param_specs leaves {'/'.join(names)} "
                f"{shape} whole or splits it inside a head over model={mp}; "
                f"training on such splits is {_TRAIN_LATER}")


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

    def gather_cols(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherCols.apply(x, self)

    def scatter_last(self, x: torch.Tensor) -> torch.Tensor:
        return _ScatterLast.apply(x, self)

    def mean_model(self, x: torch.Tensor) -> torch.Tensor:
        return _MeanModel.apply(x, self)

    def mean_batch(self, x: torch.Tensor) -> torch.Tensor:
        if not self.batch_axes:
            return x
        return _MeanBatch.apply(x, self)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.all_reduce(x, "model")

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """-> (mp, *x.shape), rank i's ``x`` at row i."""
        return self.comm.all_gather(x, "model")

    def block(self, full: int, local: int) -> int:
        """The first index of this rank's block of a dimension of ``full``
        of which it holds ``local`` (0 where the dimension is whole)."""
        return 0 if local == full else self.rank * local

    def ring_block(self, Wc: int) -> tuple[int, int]:
        """(first row, rows) of this rank's block ``[r Wc / mp, (r + 1) Wc
        / mp)`` of a sequence-split ring of ``Wc`` rows."""
        rows = Wc // self.size
        return self.rank * rows, rows


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


def _cat_blocks(x: torch.Tensor, ax) -> torch.Tensor:
    return torch.cat(list(ax.all_gather(x.contiguous()).unbind(0)), dim=-1)


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax, ctx.n = ax, x.shape[-1]
        return _cat_blocks(x, ax)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.ax.rank, ctx.n
        return g[..., r * n:(r + 1) * n], None


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax, ctx.n = ax, x.shape[-1]
        return _cat_blocks(x, ax)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.ax.rank, ctx.n
        g = ctx.ax.all_reduce(g.contiguous().clone())
        return g[..., r * n:(r + 1) * n], None


class _ScatterLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        n = x.shape[-1] // ax.size
        total = ax.all_reduce(x.contiguous().clone())
        return total[..., ax.rank * n:(ax.rank + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _cat_blocks(g, ctx.ax), None


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
