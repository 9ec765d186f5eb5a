"""Device meshes of the scenario-sweep engines: the 2-D (data x graph)
layout of the edge-partitioned push-sum and the data-split grids.

The port of the sweep half of ``repro.distributed.sharding``
(``sweep_mesh``, ``sweep_specs``). The reference runs one controller over
a ``jax.sharding.Mesh``; the port runs one process a rank, as under
``torchrun``, over a ``torch.distributed`` ``DeviceMesh``: every rank
calls the same ``run_*`` entry point with the same arguments and the
same ``plan.mesh``, holds its block of scenarios and its edge shard, and
gets the full result back (:mod:`repro_torch.core.sweeps`).

The backend follows the device: a ``"cuda"`` mesh needs the default
process group on NCCL, one rank a card; a ``"cpu"`` mesh on gloo, which
is how the multi-rank meshes run on a machine with one card or none.
The parameter, cache and serve shardings of the model stack are not
ported here (ROADMAP item 8b).
"""
from __future__ import annotations

__all__ = ["sweep_mesh", "sweep_specs"]


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
