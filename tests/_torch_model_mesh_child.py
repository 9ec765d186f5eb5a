"""The multi-process side of ``tests/test_torch_model_mesh.py``: one gloo
rank of a device mesh running the port's model stack on the CPU. Imports
neither JAX nor the JAX package (each rank checks).

:func:`main` is the spawned rank: it joins the gloo group on
``localhost``, builds its mesh, runs the cases of that mesh and saves the
results (or its traceback) under ``out``. The inputs the test process
prepares (converted reference parameters, the MoE block's inputs) are
read from ``out``; everything else is built here from fixed seeds, as the
test process builds it for the one-process runs.
"""
import dataclasses
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.prng import fold_in, prng_key
from repro_torch.data import SyntheticLMData
from repro_torch.distributed.aggregation import (RANK_AGGREGATORS,
                                                 AggregatorConfig)
from repro_torch.distributed.comm import Comm
from repro_torch.distributed.server import (make_decode_step,
                                            make_prefill_step, rank_rows)
from repro_torch.distributed.sharding import (RankMesh, gather_tree,
                                              param_specs, shard_tree)
from repro_torch.distributed.trainer import (TrainConfig, gather_params,
                                             make_train_step, param_spread)
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.model_axis import ModelAxis
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import leaves

#: mesh case -> (mesh shape, dimension names)
MESHES = {
    "data4": ((4,), ("data",)),
    "pod2_data2": ((2, 2), ("pod", "data")),
    "model2": ((1, 2), ("data", "model")),
    "data2_model2": ((2, 2), ("data", "model")),
    "data2": ((2,), ("data",)),
}
#: FSDP mean steps: mesh case -> the models it runs them on
FSDP = {"data2": ("qwen3",), "data2_model2": ("qwen3", "olmoe")}
AGG_D = 1001          # not a multiple of W: the sharded trim pads
AGG_CFG = AggregatorConfig(F=1, gossip_rounds=8, gamma_period=2,
                           drop_prob=0.3, B=3, graph_extra_edge_prob=0.5,
                           trim_backend="torch", pushsum_backend="torch")
AGG_KEY = prng_key(3)
STEPS = 3
#: robust runs of reduced paper_sim: mesh case -> (aggregator, Byzantine)
ROBUST = {"data4": (("trimmed_mean", (1,)), ("hierarchical_trim", (2,))),
          "pod2_data2": (("pushsum", ()), ("trimmed_mean_sharded", (3,)))}
SERVE_B, SERVE_S, SERVE_GEN = 4, 16, 3
TRAIN_SEQ, TRAIN_B = 32, 8


def agg_buffer(W: int) -> torch.Tensor:
    """The (W, D) float32 gradients every aggregator case runs on: normal
    rows, one of them 1e3 times larger (a Byzantine worker)."""
    rng = np.random.default_rng(17)
    g = rng.normal(size=(W, AGG_D)).astype(np.float32)
    g[W - 1] *= 1e3
    return torch.from_numpy(g)


def agg_cfg(name: str, per_pod: int) -> AggregatorConfig:
    """``AGG_CFG``; the hierarchical trim of pods of 2 takes F = 0 (a trim
    of F needs 2F + 1 rows)."""
    if name == "hierarchical_trim" and per_pod <= 2:
        return dataclasses.replace(AGG_CFG, F=0)
    return AGG_CFG


def agg_cases(comm: Comm, w: int, W: int) -> dict:
    """Each rank aggregator on this rank's row, and the sharded trim with
    bf16 on the wire."""
    g = agg_buffer(W)[w]
    out = {}
    for name, fn in RANK_AGGREGATORS.items():
        out[f"agg_{name}"] = fn(g, agg_cfg(name, comm.mesh.size("data")),
                                comm, AGG_KEY)
    bf = dataclasses.replace(AGG_CFG, comm_dtype="bfloat16")
    out["agg_trimmed_mean_sharded_bf16"] = RANK_AGGREGATORS[
        "trimmed_mean_sharded"](g, bf, comm, AGG_KEY)
    return out


def robust_tc(kind: str, byz: tuple) -> TrainConfig:
    cfg = reduced(get_config("paper_sim"))
    return TrainConfig(
        arch=cfg, agg=AggregatorConfig(
            kind=kind, F=1, gossip_rounds=6, gamma_period=2, drop_prob=0.2,
            trim_backend="torch", pushsum_backend="torch"),
        opt=AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10),
        byzantine_workers=byz)


def robust_data(tc: TrainConfig, W: int) -> SyntheticLMData:
    return SyntheticLMData(tc.arch.vocab, TRAIN_SEQ, TRAIN_B,
                           flavour="markov", n_agents=W, seed=0)


def robust_cases(name: str, rm: RankMesh, comm: Comm) -> dict:
    """Reduced paper_sim, ``STEPS`` robust steps on this rank's copy."""
    out = {}
    W = rm.size("pod", "data")
    for kind, byz in ROBUST[name]:
        tc = robust_tc(kind, byz)
        params = M.init_params(0, tc.arch, "cpu")
        opt = adamw_init(params)
        step = make_train_step(tc, backend="torch", mesh=rm, comm=comm,
                               record="aggregate")
        data = robust_data(tc, W)
        losses = []
        for s in range(STEPS):
            params, opt, loss = step(params, opt, data.batch(s, "cpu"),
                                     fold_in(prng_key(0), s))
            losses.append(loss)
            if s == 0:
                out[f"robust_{kind}_agg0"] = step.aggregate
        out[f"robust_{kind}_losses"] = torch.stack(losses)
        out[f"robust_{kind}_params"] = params
        out[f"robust_{kind}_spread"] = param_spread(params, rm, comm)
    return out


def qwen_cfg():
    """Reduced Qwen3-8B with 2 KV heads: ``reduced`` keeps one (its 4
    query heads over the published 4:1 ratio), which a model axis of 2
    cannot split into whole heads; the published 8 split over 2."""
    return dataclasses.replace(reduced(get_config("qwen3_8b")),
                               n_kv_heads=2)


def moe_cfg():
    """Reduced OLMoE-1B-7B with the expert-parallel dispatch."""
    return dataclasses.replace(reduced(get_config("olmoe_1b_7b")),
                               moe_impl="sharded")


def serve_prompts(cfg) -> torch.Tensor:
    g = torch.Generator().manual_seed(5)
    return torch.randint(0, cfg.vocab, (SERVE_B, SERVE_S), generator=g)


def serve(params, cfg, prompts, mesh=None, comm=None):
    """Prefill and ``SERVE_GEN`` greedy decode steps -> (every step's
    logits (B, 1 + GEN, V), the tokens (B, 1 + GEN), the final cache)."""
    pre = make_prefill_step(cfg, cache_len=SERVE_S + SERVE_GEN + 1,
                            backend="torch", mesh=mesh, comm=comm)
    dec = make_decode_step(cfg, backend="torch", mesh=mesh, comm=comm)
    with torch.no_grad():
        logits, cache = pre(params, {"tokens": prompts})
        seen = [logits[:, -1]]
        tok = logits[:, -1].argmax(-1)[:, None]
        toks = [tok]
        for _ in range(SERVE_GEN):
            logits, cache = dec(params, cache, tok)
            seen.append(logits[:, -1])
            tok = logits[:, -1].argmax(-1)[:, None]
            toks.append(tok)
    return torch.stack(seen, 1), torch.cat(toks, 1), cache


def mean_tc(cfg) -> TrainConfig:
    return TrainConfig(arch=cfg, opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                                 total_steps=20))


def tree_like(like, flat: list):
    """The tree of ``like``'s structure holding ``flat`` in ``leaves``
    order (dict keys sorted)."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def mean_losses(params, cfg, mesh=None, comm=None):
    """``STEPS`` mean steps -> (losses, trained parameters, the first
    step's gradients as a tree: this rank's blocks, averaged over the data
    ranks)."""
    tc = mean_tc(cfg)
    step = make_train_step(tc, backend="torch", record=True, mesh=mesh,
                           comm=comm)
    opt = adamw_init(params)
    data = SyntheticLMData(cfg.vocab, TRAIN_SEQ, TRAIN_B, seed=0)
    losses, grads0 = [], None
    for s in range(STEPS):
        params, opt, loss = step(params, opt, data.batch(s, "cpu"))
        losses.append(loss)
        if s == 0:
            grads0 = tree_like(params, [g.clone() for g in step.grads])
    return torch.stack(losses), params, grads0


def mean_case(cfg, full, rm: RankMesh, comm: Comm) -> dict:
    """The mean step on this rank's blocks of ``full`` -> the losses, and
    the trained parameters and first gradients gathered over the mesh."""
    specs = param_specs(M.param_shapes(cfg), cfg, rm)
    losses, trained, grads0 = mean_losses(shard_tree(full, specs, rm), cfg,
                                          rm, comm)
    return {"losses": losses,
            "params_gathered": gather_tree(trained, specs, rm, comm),
            "grads0_gathered": gather_tree(grads0, specs, rm, comm)}


def held_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(tree))


def block_bytes(cfg, specs, rm: RankMesh) -> int:
    """The bytes of this rank's blocks of every parameter leaf under
    ``specs``, from the full shapes and the mesh extents alone."""
    total = 0
    for leaf, spec in zip(leaves(M.param_shapes(cfg)), leaves_of_specs(
            specs)):
        n = leaf.numel()
        for e in spec:
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    n //= rm.size(a)
        total += n * leaf.element_size()
    return total


def leaves_of_specs(specs) -> list:
    """The spec tuples of a spec tree in ``leaves`` order."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in leaves_of_specs(specs[k])]
    if isinstance(specs, list):
        return [x for t in specs for x in leaves_of_specs(t)]
    return [specs]


def fsdp_case(cfg, full, rm: RankMesh, comm: Comm, fsdp: bool = True,
              n_micro: int = 1) -> dict:
    """``STEPS`` FSDP mean steps on this rank's ``param_specs(fsdp=True)``
    blocks of ``full`` -> the losses, the trained parameters and first
    gradients gathered over the mesh, and the bytes the rank holds
    (parameters and AdamW moments) beside its blocks' under either
    layout."""
    shapes = M.param_shapes(cfg)
    specs = param_specs(shapes, cfg, rm, fsdp=fsdp)
    local = shard_tree(full, specs, rm)
    tc = dataclasses.replace(mean_tc(cfg), fsdp=fsdp, n_micro=n_micro)
    step = make_train_step(tc, backend="torch", record=True, mesh=rm,
                           comm=comm)
    opt = adamw_init(local)
    held = held_bytes(local) + held_bytes(opt["m"]) + held_bytes(opt["v"])
    data = SyntheticLMData(cfg.vocab, TRAIN_SEQ, TRAIN_B, seed=0)
    losses, grads0 = [], None
    for s in range(STEPS):
        local, opt, loss = step(local, opt, data.batch(s, "cpu"))
        losses.append(loss)
        if s == 0:
            grads0 = tree_like(local, [g.clone() for g in step.grads])
    return {"losses": torch.stack(losses),
            "params_gathered": gather_params(local, cfg, rm, fsdp=fsdp,
                                             comm=comm),
            "grads0_gathered": gather_tree(grads0, specs, rm, comm),
            "held": held, "blocks": 3 * block_bytes(cfg, specs, rm),
            "blocks_unsharded": 3 * block_bytes(
                cfg, param_specs(shapes, cfg, rm), rm)}


def model_cases(name: str, rm: RankMesh, comm: Comm, out_dir: Path) -> dict:
    """Reduced Qwen3-8B (the reference's parameters, converted) served and
    trained on this rank's blocks, and reduced OLMoE's expert-parallel
    mean step; on (data 2 x model 2) also the sharded MoE block of reduced
    OLMoE on this rank's rows and experts."""
    cfg = qwen_cfg()
    full = torch.load(out_dir / "qwen_params.pt")
    specs = param_specs(M.param_shapes(cfg), cfg, rm)
    local = shard_tree(full, specs, rm)
    out = {"local_embed": local["embed"].clone()}
    logits, toks, cache = serve(local, cfg, rank_rows(serve_prompts(cfg), rm),
                                rm, comm)
    out.update(serve_logits=logits, serve_tokens=toks,
               cache_k=cache["layers"][0]["mixer"]["k"],
               cache_v=cache["layers"][-1]["mixer"]["v"])
    mean = mean_case(cfg, full, rm, comm)
    out.update(mean_losses=mean["losses"],
               mean_params_gathered=mean["params_gathered"],
               mean_grads0_gathered=mean["grads0_gathered"])
    moe_mean = mean_case(moe_cfg(), torch.load(out_dir / "olmoe_params.pt"),
                         rm, comm)
    out.update({f"moe_mean_{k}": v for k, v in moe_mean.items()})
    if name == "data2_model2":
        moe = torch.load(out_dir / "moe_inputs.pt")
        mcfg = moe_cfg()
        E_loc = mcfg.n_experts // rm.size("model")
        e0 = rm.index("model") * E_loc
        p = {"router": moe["router"],
             **{k: moe[k][e0:e0 + E_loc]
                for k in ("w_gate", "w_up", "w_down")}}
        with torch.no_grad():
            y, aux = L.moe_block(p, rank_rows(moe["x"], rm), mcfg,
                                 ModelAxis(comm))
        out.update(moe_y=y, moe_aux=aux)
    out.update(fsdp_cases(name, rm, comm, out_dir))
    return out


def fsdp_cases(name: str, rm: RankMesh, comm: Comm, out_dir: Path) -> dict:
    cfgs = {"qwen3": (qwen_cfg(), "qwen_params.pt"),
            "olmoe": (moe_cfg(), "olmoe_params.pt")}
    out = {}
    for model in FSDP.get(name, ()):
        cfg, path = cfgs[model]
        out.update({f"fsdp_{model}_{k}": v for k, v in fsdp_case(
            cfg, torch.load(out_dir / path), rm, comm).items()})
    if name == "data2":         # 2 micro-batches, each gathering anew
        for fsdp in (True, False):
            out.update({f"micro_{fsdp}_{k}": v for k, v in fsdp_case(
                qwen_cfg(), torch.load(out_dir / "qwen_params.pt"), rm,
                comm, fsdp, n_micro=2).items()})
    return out


def run_case(name: str, rm: RankMesh, comm: Comm, out_dir: Path) -> dict:
    if name == "data2":
        return fsdp_cases(name, rm, comm, out_dir)
    if name in ROBUST:
        W = rm.size("pod", "data")
        w = rm.index("pod", "data")
        return {**agg_cases(comm, w, W), **robust_cases(name, rm, comm)}
    return model_cases(name, rm, comm, out_dir)


def main(name: str, rank: int, world: int, port: int, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    path = Path(out) / f"{name}_{rank}"
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        shape, dims = MESHES[name]
        rm = RankMesh(init_device_mesh("cpu", shape, mesh_dim_names=dims))
        comm = Comm(rm)
        res = run_case(name, rm, comm, Path(out))
        res["coordinate"] = torch.tensor(rm.mesh.get_coordinate())
        res["staged_calls"] = comm.staged_calls
        dist.barrier()
        dist.destroy_process_group()
        loaded = sorted(k for k in sys.modules
                        if k.split(".")[0] in ("jax", "jaxlib", "repro"))
        torch.save({"rows": res, "loaded": loaded}, f"{path}.pt")
    except BaseException:
        Path(f"{path}.err").write_text(traceback.format_exc())
        raise
