"""The multi-process side of ``tests/test_torch_distributed_engines.py``:
one gloo rank of a device mesh running the port's sweep engines on the
CPU. Imports neither JAX nor the JAX package (each rank checks).

:func:`run_case` builds every input of one mesh case from fixed seeds and
runs it with ``mesh`` (a rank) or ``mesh=None`` (the test process: the
one-process emulation of the graph axis and the unsplit grids), so both
sides compute the same rows by different routes. :func:`main` is the
spawned rank: it joins the gloo group on ``localhost``, builds its mesh,
runs the case and saves the results (or its traceback) under ``out``.
"""
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import faults as tfa
from repro_torch.core import graphs as tg
from repro_torch.core import hps as th
from repro_torch.core import social as tsoc
from repro_torch.core import sweeps as ts
from repro_torch.core.byzantine import ByzantineConfig
from repro_torch.core.attacks import large_value
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.prng import prng_key
from repro_torch.core.pushsum import (EmulatedAxis, GraphAxis, GroupAxis,
                                      partitioned_edges, shard_edge_mask)
from repro_torch.core.signals import make_confused_model

#: mesh case -> (mesh shape, dimension names)
MESHES = {
    "graph2": ((1, 2), ("data", "graph")),
    "data2_graph2": ((2, 2), ("data", "graph")),
    "data4": ((4,), ("data",)),
}
T = 12


def _pushsum_inputs():
    rng = np.random.default_rng(11)
    el = tg.random_strongly_connected_edge_list(60, 2.0, rng, sort=False)
    w = rng.normal(size=(60, 2)).astype(np.float32)
    return el, w


def _sweep_rows(res) -> dict:
    return {f: getattr(res, f) for f in res._fields
            if getattr(res, f) is not None}


def _graph_cases(mesh, group_axis) -> dict:
    """The push-sum sweep cut into 2 shards (psum and scatter, float32
    and bf16, with the fault plane), the windows of the draws, and the
    social and HPS loops with a graph axis."""
    el, w = _pushsum_inputs()
    out = {}
    base = ExecutionPlan(mesh=mesh, graph_shards=2)
    fm = tfa.gilbert_elliott_model(4.0, 0.3, leave_prob=0.05,
                                   join_prob=0.5)
    for name, plan in (("psum", base),
                       ("scatter", base.replace(halo="scatter")),
                       ("scatter_bf16", base.replace(halo="scatter",
                                                     policy="bf16")),
                       ("psum_faults", base.replace(faults=fm))):
        GraphAxis.wire_bytes = 0.0
        res = ts.run_pushsum_sweep(w, el, T, drop_probs=[0.0, 0.3],
                                   seeds=[0, 4], B=3, plan=plan,
                                   device="cpu")
        out.update({f"sweep_{name}_{k}": v
                    for k, v in _sweep_rows(res).items()})
        out[f"sweep_{name}_wire_bytes"] = torch.tensor(GraphAxis.wire_bytes)
    # the held window of a round's link mask and fault uniforms
    sh = tg.partition_edge_list(el, 2)
    axis = group_axis if group_axis is not None else EmulatedAxis(2)
    out["mask_window"] = shard_edge_mask(
        prng_key(5), 3, sh.e_shard, torch.tensor(0.3),
        torch.tensor(3, dtype=torch.int32), graph_axis=axis)
    out["uniform_window"] = tfa.edge_uniforms(prng_key(5), 7, sh.e_shard,
                                              "cpu", graph_axis=axis)
    # Algorithms 3 and 1 with a graph axis, with the fault plane
    hel, rep = tg.hier_edge_list([5] * 6, "complete")
    hsh = tg.partition_edge_list(hel, 2)
    held = dict(zip(("src", "dst", "valid", "offsets"), partitioned_edges(
        hsh.src[None], hsh.dst[None], hsh.valid[None], hel.n, axis)))
    model = make_confused_model(N=hel.n, m=3, truth=1, confusion=0.4,
                                seed=0)
    tables = model.tables.float()
    fm_ps = tfa.gilbert_elliott_model(4.0, 0.3, leave_prob=0.05,
                                      join_prob=0.5, ps_crash_prob=0.2)
    srt = tsoc.social_runtime_from_edge_list(
        hel, rep, drop_prob=0.3, gamma_period=4, B=2)._replace(**held)
    _, (beliefs, log_ratio) = tsoc._social_scan_core(
        prng_key(0), prng_key(3), srt, torch.log(tables),
        torch.cumsum(tables[:, 1, :], dim=-1), truth=1, M=6, T=T,
        store="trajectory", backend="auto", faults=fm_ps, graph_axis=axis)
    out["social_beliefs"], out["social_log_ratio"] = beliefs, log_ratio
    hrt = th.hps_runtime_from_edge_list(
        hel, rep, drop_prob=0.3, gamma_period=4, B=2)._replace(**held)
    hw = torch.from_numpy(np.random.default_rng(2).normal(
        size=(hel.n, 3)).astype(np.float32))
    _, (ratio, gap) = th._hps_scan_core(
        prng_key(1), hrt, hw, T=T, store="trajectory", backend="auto",
        faults=fm_ps, graph_axis=axis, halo="scatter")
    out["hps_ratio"], out["hps_gap"] = ratio, gap
    return out


def _data_grid_cases(mesh) -> dict:
    """Every grid with a data axis, K not a multiple of the extent."""
    out = {}
    el, w = _pushsum_inputs()
    plan = ExecutionPlan(mesh=mesh)
    res = ts.run_pushsum_sweep(w, el, T, drop_probs=[0.0, 0.3, 0.6],
                               seeds=[0, 4], B=3, plan=plan, device="cpu")
    out.update({f"pushsum_{k}": v for k, v in _sweep_rows(res).items()})
    topo = tg.make_hierarchy([6, 6, 6], topology="complete", seed=0)
    cfgs = [th.HPSConfig(topo=topo, gamma_period=g, B=2, drop_prob=d)
            for d in (0.0, 0.4, 0.8) for g in (3, 8)]
    model = make_confused_model(N=18, m=3, truth=1, confusion=0.5, seed=0)
    res = ts.run_social_grid(model, cfgs[:5], T, [0, 7], device="cpu",
                             plan=plan.replace(store="trajectory"))
    out.update({f"social_{k}": v for k, v in _sweep_rows(res).items()})
    res = ts.run_social_sweep(model, cfgs[0], T, drop_probs=[0.1, 0.5],
                              gammas=[4], seeds=[1, 2, 3], plan=plan,
                              device="cpu")
    out.update({f"social_sweep_{k}": v for k, v in _sweep_rows(res).items()})
    hw = np.random.default_rng(3).normal(size=(18, 2)).astype(np.float32)
    res = ts.run_hps_grid(hw, cfgs, T, [0, 1, 2], plan=plan.replace(
        faults=[tfa.make_fault_model(),
                tfa.gilbert_elliott_model(4.0, 0.3)]), device="cpu")
    out.update({f"hps_{k}": v for k, v in _sweep_rows(res).items()})
    res = ts.run_hps_sweep(hw, cfgs[1], T, drop_probs=[0.2], gammas=[2, 5],
                           seeds=[4, 5, 6], plan=plan, device="cpu")
    out.update({f"hps_sweep_{k}": v for k, v in _sweep_rows(res).items()})
    topos = [tg.make_hierarchy([5, 5, 5], topology="ring+",
                               extra_edge_prob=0.9, seed=s) for s in (0, 1)]
    bcfgs = [ByzantineConfig(topo=t, F=f, byz=(1,) if f else (),
                             gamma_period=4, attack=large_value())
             for t in topos for f in (0, 1)]
    bmodel = make_confused_model(N=15, m=3, truth=0, confusion=0.0, seed=0)
    res = ts.run_byzantine_grid(bmodel, bcfgs[:3], T, [0, 5], plan=plan,
                                device="cpu")
    out.update({f"byz_{k}": v for k, v in _sweep_rows(res).items()})
    return out


def run_case(name: str, mesh=None, group_axis=None) -> dict:
    """The rows of mesh case ``name``: with ``mesh`` this rank's (the full
    result on every rank), with ``None`` the one-process emulation."""
    if name == "graph2":
        return _graph_cases(mesh, group_axis)
    if name == "data2_graph2":
        el, w = _pushsum_inputs()
        out = {}
        for halo in ("psum", "scatter"):
            res = ts.run_pushsum_sweep(
                w, el, T, drop_probs=[0.0, 0.3, 0.6], seeds=[2], B=3,
                plan=ExecutionPlan(mesh=mesh, graph_shards=2, halo=halo),
                device="cpu")
            out.update({f"sweep_{halo}_{k}": v
                        for k, v in _sweep_rows(res).items()})
        return out
    return _data_grid_cases(mesh)


def _errors(mesh) -> dict:
    """The messages of the mesh-shape errors this mesh can show."""
    el, w = _pushsum_inputs()
    msgs = {}
    for plan in (ExecutionPlan(mesh=mesh, graph_shards=3),
                 ExecutionPlan(mesh=mesh, graph_shards=2,
                               graph_axis="model")):
        try:
            ts.run_pushsum_sweep(w, el, 2, plan=plan, device="cpu")
            msgs[plan.graph_axis + str(plan.graph_shards)] = ""
        except ValueError as e:
            msgs[plan.graph_axis + str(plan.graph_shards)] = str(e)
    return msgs


def main(name: str, rank: int, world: int, port: int, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.sharding import sweep_mesh
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    path = Path(out) / f"{name}_{rank}"
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        shape, dims = MESHES[name]
        mesh = (sweep_mesh(*shape, device_type="cpu") if len(shape) == 2
                else init_device_mesh("cpu", shape, mesh_dim_names=dims))
        axis = (GroupAxis(mesh.get_group("graph"))
                if "graph" in dims and name == "graph2" else None)
        res = run_case(name, mesh, axis)
        res["coordinate"] = torch.tensor(mesh.get_coordinate())
        errors = _errors(mesh)
        host = make_host_mesh(2, device_type="cpu")
        res["host_mesh"] = torch.tensor(host.shape)
        try:
            make_host_mesh(3, device_type="cpu")
            errors["host3"] = ""
        except ValueError as e:
            errors["host3"] = str(e)
        dist.barrier()
        dist.destroy_process_group()
        loaded = sorted(k for k in sys.modules
                        if k.split(".")[0] in ("jax", "jaxlib", "repro"))
        torch.save({"rows": res, "errors": errors, "loaded": loaded},
                   f"{path}.pt")
    except BaseException:
        Path(f"{path}.err").write_text(traceback.format_exc())
        raise
