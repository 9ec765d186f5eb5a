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

Serving and the training steps run every family over the axis, on whole
heads or split inside a head (:func:`check_model_axis`). The rank paths
carry no serve-only shortcut: a replicated weight is sliced after its
``copy_in``, and every rank issues the same collectives in the same order
in the forward, the remat and the backward.

FSDP (``TrainConfig(fsdp=True)`` over a mesh with "data" ranks) adds
:class:`DataShards`: each rank holds its blocks of the data-split leaves
(``param_specs(..., fsdp=True)``), and one ``torch.autograd.Function`` a
leaf all-gathers them over "data" where a layer (or the embedding's
projector, the encoder's blocks, the LM head) uses them; its backward
reduce-scatters the gradient back, summed over the data ranks.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig

__all__ = ["ModelAxis", "DataShards", "check_model_axis"]


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


def check_model_axis(cfg: ArchConfig, mp: int) -> None:
    """Raise NotImplementedError where ``mp`` model ranks cannot run
    ``cfg``'s serve path and training steps on the blocks ``param_specs``
    gives them. Both run every family over the axis, on
    whole or split heads (RWKV6's too: where a column block ends inside a
    head, each rank gathers the projections and scans every head), whole
    or split vocabularies, widths and d_ff, so the one rule is the MoE's:
    the expert-parallel dispatch needs E / mp experts a rank."""
    if mp == 1:
        return
    for names, shape, spec in _leaf_specs(cfg, mp):
        if cfg.is_moe and "ffn" in names and names[-1] == "w_gate" and \
                spec[-3] is None:           # (E, d, f): the experts' axis
            raise NotImplementedError(
                f"{cfg.name}: {cfg.n_experts} experts do not split over "
                f"model={mp}; the expert-parallel dispatch runs E / mp "
                f"experts a rank")


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


def data_split_dims(specs, mesh):
    """The tree of ``specs`` (a ``param_specs`` tree) with, at each leaf,
    the dimension its spec splits over "data" (None where none does, or
    where the mesh has one data rank)."""
    if isinstance(specs, dict):
        return {k: data_split_dims(v, mesh) for k, v in specs.items()}
    if isinstance(specs, list):
        return [data_split_dims(v, mesh) for v in specs]
    if mesh.size("data") == 1:
        return None
    for dim, e in enumerate(specs):
        if e == "data" or (isinstance(e, tuple) and "data" in e):
            return dim
    return None


class DataShards:
    """FSDP's "data" dimension of one rank's mesh, through ``comm``:
    ``dims`` (:func:`data_split_dims` of the FSDP spec tree) says which
    dimension of each parameter leaf is split over the data ranks."""

    def __init__(self, comm, dims):
        self.comm = comm
        self.dims = dims

    def gather(self, tree, dims):
        """``tree`` with each data-split leaf (``dims``: the matching tree
        of dimensions, a layer view's from :func:`layer_dims`) gathered
        whole over "data"; the gradient of a gathered leaf comes back to
        the block, summed over the data ranks."""
        if isinstance(tree, dict):
            return {k: self.gather(v, dims[k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.gather(v, d) for v, d in zip(tree, dims))
        return tree if dims is None else _GatherData.apply(tree, dims, self)


def layer_dims(dims, cfg: ArchConfig, n_stack: int | None):
    """The data-split dimensions of each layer view that
    ``models.model._layers`` hands out, in its order: a stacked group's
    leaves lose their leading (layer) dimension. ``n_stack``: the group's
    repeats (None for the list layout)."""
    if n_stack is None:
        yield from dims["layers"]
        return
    P = len(cfg.block_pattern)

    def view(d):
        return None if d is None else d - 1

    def drop_lead(t):
        if isinstance(t, dict):
            return {k: drop_lead(v) for k, v in t.items()}
        if isinstance(t, list):
            return [drop_lead(v) for v in t]
        return view(t)

    groups = [drop_lead(g) for g in dims["groups"]]
    for _ in range(n_stack):
        yield from groups[:P]
    yield from dims["tail"]


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, fs):
        ctx.dim, ctx.fs = dim, fs
        parts = fs.comm.all_gather(x.contiguous(), "data")
        return torch.cat(list(parts.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        dim, comm = ctx.dim, ctx.fs.comm
        lead = g.movedim(dim, 0).contiguous()
        return comm.reduce_scatter(lead, "data").movedim(0, dim), None, None
