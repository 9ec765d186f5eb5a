"""Sharding rules of the model stack and the device meshes of the
scenario-sweep engines: the port of ``repro.distributed.sharding``.

The reference runs one controller over a ``jax.sharding.Mesh`` and hands
XLA a ``PartitionSpec`` tree. The port runs one process a rank, as under
``torchrun``, over a ``torch.distributed`` ``DeviceMesh`` whose dimensions
carry the reference's axis names (``"pod"``, ``"data"``, ``"model"``, or
the sweeps' ``"data"`` and ``"graph"``); every rank holds its own block
of each tensor and calls the same entry point.

A spec here is a tuple with one entry a tensor dimension: ``None``
(replicated), a mesh-dimension name, or a tuple of names (split over
their product, the first name major), as ``tuple(PartitionSpec(...))``
reads; a one-name tuple is written as the name, as ``PartitionSpec``
writes it. The rules read only ``mesh.axis_names`` and ``mesh.shape``
(a mapping of name to size), so they run on a stand-in object without a
process group; :class:`RankMesh` gives a ``DeviceMesh`` that view.

* Model stack (ROADMAP item 8b): ``param_specs`` (Megatron layout: the
  column-split ``wq``/``wk``/``wv``/``w_gate``/``w_up``, the row-split
  ``wo``/``w_down``, the embedding by vocabulary rows, the LM head by
  vocabulary columns, the experts over "model"; ``fsdp`` adds "data" on
  the inner dimension, ``worker_axis`` a leading (pod, data) axis: the
  FSDP mean step's layout, :mod:`repro_torch.distributed.trainer`),
  ``opt_state_specs``, ``batch_specs``, ``fit_spec``, ``cache_specs``,
  and :func:`shard_tree` / :func:`gather_tree` in place of the
  reference's ``to_shardings``.
* Sweeps (item 8a): ``sweep_mesh``, ``sweep_specs``.

The backend follows the device: a ``"cuda"`` mesh needs the default
process group on NCCL, one rank a card; a ``"cpu"`` mesh on gloo, which
is how the multi-rank meshes run on a machine with one card or none
(:mod:`repro_torch.distributed.comm` stages what gloo refuses on CUDA
tensors through host memory).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..configs.base import ArchConfig

__all__ = ["RankMesh", "batch_axes", "param_specs", "opt_state_specs",
           "batch_specs", "fit_spec", "cache_specs", "local_block",
           "shard_tree", "gather_tree", "sweep_mesh", "sweep_specs"]

Params = Any
Spec = tuple


class RankMesh:
    """One rank's view of a ``DeviceMesh``: the reference's ``axis_names``
    and ``shape`` (name -> size), this rank's ``coords`` (name -> index),
    and process groups over any set of its dimensions.

    :meth:`group` builds a group over several dimensions with
    ``torch.distributed.new_group`` for every slice of the mesh, which
    every rank of the default group must call in the same order: call it
    on every rank at the same point of the program (the trainers and the
    aggregators do)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.axis_names = tuple(mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, mesh.shape))
        self.coords = dict(zip(self.axis_names, mesh.get_coordinate()))
        self._groups: dict[tuple, Any] = {}

    def size(self, *axes: str) -> int:
        return math.prod(self.shape[a] for a in axes if a in self.shape)

    def index(self, *axes: str) -> int:
        """This rank's row-major index over ``axes`` (the first major)."""
        i = 0
        for a in axes:
            if a in self.shape:
                i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, *axes: str):
        """The process group of the ranks that differ from this one only
        in ``axes`` (ranks ordered row-major over ``axes``, in their order
        as given)."""
        key = tuple(a for a in axes if a in self.shape)
        if key not in self._groups:
            if len(key) == 1:
                self._groups[key] = self.mesh.get_group(key[0])
            else:
                self._groups[key] = self._new_groups(key)
        return self._groups[key]

    def _new_groups(self, key: tuple):
        import torch.distributed as dist
        ranks = self.mesh.mesh
        dims = [self.axis_names.index(a) for a in key]
        rest = [d for d in range(ranks.dim()) if d not in dims]
        rows = ranks.permute(*rest, *dims).reshape(-1, self.size(*key))
        mine = None
        me = dist.get_rank()
        for row in rows.tolist():
            g = dist.new_group(row)
            if me in row:
                mine = g
        return mine


def batch_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


# weight-name -> spec for the *trailing* dims (stack dims padded with None)
_COL = ("wq", "wk", "wv", "wg", "w_gate", "w_up", "w_in", "w_gate_branch",
        "w_lora_b", "w1", "wr")
_ROW = ("wo", "w_down", "w_out", "w2")


def _rule(names: list[str], leaf, cfg: ArchConfig, fsdp: bool) -> Spec:
    name = names[-1]
    in_ffn = "ffn" in names
    in_moe = cfg.is_moe and in_ffn
    fs = "data" if fsdp else None

    if name == "embed":
        return ("model", None)
    if name == "lm_head":
        return (fs, "model")
    if name == "router":
        return (None, None)
    if in_moe and name in ("w_gate", "w_up", "w_down"):
        return ("model", fs, None)        # expert parallel + fsdp inner dim
    if in_ffn and cfg.ffn_kind == "rwkv_cm":
        # channel-mix: wk (d,f) col, wv (f,d) row, wr (d,d) col
        if name == "wk":
            return (fs, "model")
        if name == "wv":
            return ("model", fs)
        if name == "wr":
            return (fs, "model")
    if name in _COL:
        return (fs, "model")
    if name in _ROW:
        return ("model", fs)
    if name == "conv_w":
        return (None, "model")
    if name == "u":
        return (None, None)
    if name == "w_lora_a":
        return (fs, None)
    # 1-D scales/biases, lam, w0, mu, ln_x, conv_b: replicate
    return tuple(None for _ in range(leaf.ndim))


def _canon(e):
    """``PartitionSpec``'s form of an entry: a one-name tuple is the
    name."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return e[0] if len(e) == 1 else e
    return e


def fit_spec(spec: Spec, shape: tuple[int, ...], mesh) -> Spec:
    """Drop spec axes whose mesh size does not divide the array dim (e.g.
    kv_heads=8 cannot shard over model=16; batch=1 cannot shard over
    data); entries past the array's rank become ``None``. A dimension the
    mesh does not name counts as one rank (a (data,) mesh of ranks, where
    the reference's meshes name "model" too), so it splits nothing."""
    sizes = dict(mesh.shape)
    out = []
    for i, e in enumerate(spec):
        if e is None or i >= len(shape):
            out.append(None if i >= len(shape) else e)
            continue
        axes = e if isinstance(e, (tuple, list)) else (e,)
        total = math.prod(sizes.get(a, 1) for a in axes)
        out.append(_canon(e) if shape[i] % total == 0 else None)
    return tuple(out)


def _spec_map(fn, tree, path: tuple = ()):
    """``fn(path names, leaf)`` over a nested dict/list tree, as
    ``jax.tree_util.tree_map_with_path`` visits it; the names are the
    dict keys and list indices from the root, as strings."""
    if isinstance(tree, dict):
        return {k: _spec_map(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_spec_map(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(list(path), tree)


def param_specs(params_like: Params, cfg: ArchConfig, mesh,
                fsdp: bool = False, worker_axis: bool = False) -> Params:
    """The spec tree matching ``params_like`` (tensors, or anything with
    ``.ndim`` and ``.shape``: ``model.param_shapes(cfg)`` gives the tree
    at any size without allocating). ``worker_axis``: the decentralized
    layout of stacked copies, a leading axis over (pod, data)."""
    baxes = batch_axes(mesh)

    def assign(names, leaf):
        rule = _rule(names, leaf, cfg, fsdp)
        ndim = leaf.ndim - (1 if worker_axis else 0)
        rule = tuple(rule[-ndim:]) if ndim else ()
        spec = (None,) * (ndim - len(rule)) + rule
        if worker_axis:
            spec = (baxes,) + spec
        return fit_spec(spec, tuple(leaf.shape), mesh)

    return _spec_map(assign, params_like)


def opt_state_specs(pspecs: Params) -> Params:
    """Adam moments share their param's spec; step is replicated."""
    return {"m": pspecs, "v": pspecs, "step": ()}


def batch_specs(mesh) -> Spec:
    return (_canon(batch_axes(mesh)), None)


def cache_specs(cache_like: Params, cfg: ArchConfig, mesh) -> Params:
    """KV/state caches: batch over (pod, data); heads/channels over
    model. A K/V leaf whose heads the model extent does not divide is
    split over its sequence instead (the reference's sequence-parallel
    cache): each rank holds its block of the ring's rows, and a decode step
    merges the ranks' rank-partial attention
    (``models.layers.attention_decode``)."""
    baxes = batch_axes(mesh)

    def assign(names, leaf):
        name = names[-1]
        if name in ("k", "v"):            # (B, Hkv, Wc, dh) [+stack]
            spec = (baxes, "model", None, None)
            pad0 = leaf.ndim - 4
            fitted = fit_spec((None,) * pad0 + spec, tuple(leaf.shape), mesh)
            if fitted[pad0 + 1] is None:
                spec = (baxes, None, "model", None)
        elif name == "pos":
            spec = (baxes,)
        elif name == "state":             # wkv6 (B, H, hd, hd)
            spec = (baxes, "model", None, None)
        elif name in ("x_prev", "cm_prev"):
            spec = (baxes, None)
        elif name == "h":                 # rglru (B, w)
            spec = (baxes, "model")
        elif name == "conv":              # (B, 3, w)
            spec = (baxes, None, "model")
        elif name == "enc":               # (B, T_enc, d)
            spec = (baxes, None, None)
        else:
            spec = tuple(None for _ in range(leaf.ndim))
        pad = leaf.ndim - len(spec)
        return fit_spec((None,) * pad + tuple(spec), tuple(leaf.shape), mesh)

    return _spec_map(assign, cache_like)


# ---------------------------------------------------------------------------
# a rank's blocks of a tree, and back
# ---------------------------------------------------------------------------

def _entry_axes(e) -> tuple[str, ...]:
    if e is None:
        return ()
    return tuple(e) if isinstance(e, (tuple, list)) else (e,)


def local_block(leaf: torch.Tensor, spec: Spec, mesh: RankMesh
                ) -> torch.Tensor:
    """This rank's block of ``leaf`` under ``spec``: along each split
    dimension, the slice at the rank's row-major index over the entry's
    axes. A copy (so the full leaf can be freed), or ``leaf`` itself
    where nothing is split."""
    out = leaf
    for dim, e in enumerate(spec):
        axes = _entry_axes(e)
        n = mesh.size(*axes)
        if n == 1:
            continue
        step = leaf.shape[dim] // n
        out = out.narrow(dim, mesh.index(*axes) * step, step)
    return out if out is leaf else out.contiguous()


def shard_tree(tree: Params, specs: Params, mesh: RankMesh) -> Params:
    """Every leaf's local block (:func:`local_block`), leaf by leaf."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, s, mesh) for v, s in zip(tree, specs))
    return local_block(tree, specs, mesh)


def gather_tree(tree: Params, specs: Params, mesh: RankMesh,
                comm=None) -> Params:
    """The inverse of :func:`shard_tree`: every leaf whole on every rank,
    gathered over the groups of its split dimensions, leaf by leaf (a
    collective: call it on every rank). ``comm``: the
    :class:`~repro_torch.distributed.comm.Comm` to gather through (one on
    ``mesh`` by default)."""
    if comm is None:
        from .comm import Comm
        comm = Comm(mesh)
    if isinstance(tree, dict):
        return {k: gather_tree(tree[k], specs[k], mesh, comm)
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v, s, mesh, comm)
                          for v, s in zip(tree, specs))
    out = tree
    for dim, e in enumerate(specs):
        axes = _entry_axes(e)
        if mesh.size(*axes) == 1:
            continue
        parts = comm.all_gather(out.contiguous(), axes)   # (n, *block)
        out = torch.cat(list(parts.unbind(0)), dim=dim)
    return out


# ---------------------------------------------------------------------------
# Scenario-sweep meshes: the 2-D (data x graph) layout of the edge-
# partitioned push-sum engines (repro_torch.core.sweeps)
# ---------------------------------------------------------------------------

def sweep_mesh(n_data: int, n_graph: int = 1, *, data_axis: str = "data",
               graph_axis: str = "graph", device_type: str = "cuda"):
    """The mesh of the sweep engines: ``data_axis`` splits the K scenario
    rows (one contiguous block a row of ranks), ``graph_axis`` the edge
    shards of each scenario (:func:`repro_torch.core.graphs.
    partition_edge_list`, S = ``n_graph``). Call it on every rank after
    ``torch.distributed.init_process_group`` with a world of ``n_data *
    n_graph`` ranks; rank r sits at (r // n_graph, r % n_graph)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "sweep_mesh needs torch.distributed.init_process_group first "
            "(NCCL for 'cuda', gloo for 'cpu')")
    if dist.get_world_size() != n_data * n_graph:
        raise ValueError(
            f"a {n_data} x {n_graph} mesh needs {n_data * n_graph} ranks, "
            f"the process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, (n_data, n_graph),
                            mesh_dim_names=(data_axis, graph_axis))


def sweep_specs(data_axis: str = "data",
                graph_axis: str = "graph") -> dict[str, tuple[str, ...]]:
    """Which mesh dimensions split each argument role of the 2-D sweep
    program (the reference's PartitionSpecs as dimension tuples; ``()``
    is replicated):

    * ``"replicated"``  — ``w`` and the node state,
    * ``"scenario"``    — (K,) scenario coordinates (drop, seed, models):
      data only, every graph rank of a data row sees the row's block,
    * ``"edge_shards"`` — (K, S, e_shard) edge arrays: scenario rows over
      data, the shard axis over graph,
    * ``"out"``         — results: node state is graph-replicated after
      each round's combine, so outputs name only the data axis (and are
      then all-gathered over it).
    """
    return {
        "replicated": (),
        "scenario": (data_axis,),
        "edge_shards": (data_axis, graph_axis),
        "out": (data_axis,),
    }
