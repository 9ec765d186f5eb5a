"""The multi-process side of ``tests/test_torch_model_axis_families.py``:
one gloo rank of a (data, model) mesh serving and training the other model
families on its model blocks on the CPU. Imports neither JAX nor the JAX
package (each rank checks).

:func:`main` is the spawned rank: it joins the gloo group on
``localhost``, builds its mesh, serves every case of :data:`CASES` on its
blocks of the converted reference parameters the test process saved under
``out``, runs :data:`TRAIN_STEPS` mean steps of each case on the batches
saved there (and, on (data 2 x model 2), the robust steps of
:data:`ROBUST`), and saves the results (or its traceback) there.
"""
import dataclasses
import sys
import traceback
from pathlib import Path

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.prng import fold_in, prng_key
from repro_torch.distributed.aggregation import AggregatorConfig
from repro_torch.distributed.comm import Comm
from repro_torch.distributed.server import (make_decode_step,
                                            make_prefill_step, rank_rows)
from repro_torch.distributed.sharding import (RankMesh, param_specs,
                                              shard_tree)
from repro_torch.distributed.trainer import (TrainConfig, gather_params,
                                             make_train_step,
                                             worker_opt_init)
from repro_torch.models import model as M
from repro_torch.models.model_axis import ModelAxis, check_model_axis
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import leaves

#: mesh case -> (mesh shape over ("data", "model"))
MESHES = {"model2": (1, 2), "model4": (1, 4), "data2_model2": (2, 2)}
#: case -> (arch, dataclasses.replace kwargs of its reduced config)
CASES = {
    "rwkv6": ("rwkv6_1b6", {}),
    # one KV head of 64: K/V split over the ring's rows; a window of 12
    # that a 16-token prompt wraps (6 and 3 rows a rank)
    "recurrentgemma": ("recurrentgemma_2b", {"window": 12}),
    # 6 query heads: 1.5 a rank at model 4; a window of 10 (5 rows a rank
    # at model 2, whole at model 4, where 10 rows do not split)
    "recurrentgemma_6h": ("recurrentgemma_2b", {"n_heads": 6, "window": 10}),
    "whisper": ("whisper_small", {}),
    "whisper_v509": ("whisper_small", {"vocab": 509}),
    "internvl2": ("internvl2_26b", {}),
    "internvl2_v509": ("internvl2_26b", {"vocab": 509}),
    "command_r": ("command_r_35b", {}),
    # 2 heads of 64: one a rank at model 2, half a head a rank at model 4
    # (the projections gathered, the scan on both heads, the state whole)
    "rwkv6_d128": ("rwkv6_1b6", {"d_model": 128}),
    # a d_ff of 510 splits over model 2 but not 4: there the channel mix's
    # wk and wv are whole on every rank beside a split wr
    "rwkv6_dff510": ("rwkv6_1b6", {"d_ff": 510}),
}
SERVE_B, SERVE_S, SERVE_GEN = 4, 16, 3
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 16, 3
#: robust runs on (data 2 x model 2): case -> aggregators, 2 steps each
ROBUST = {"rwkv6": ("trimmed_mean", "pushsum"),
          "recurrentgemma_6h": ("trimmed_mean", "pushsum")}
ROBUST_MESH, ROBUST_STEPS = "data2_model2", 2
OP_ROWS, OP_COLS = 3, 8          # the operators' (rows, columns a rank)


def case_cfg(name: str):
    arch, extra = CASES[name]
    return dataclasses.replace(reduced(get_config(arch)), **extra)


def cache_len(cfg) -> int:
    """Prefill's KV capacity: the prompt, the decode steps and one more,
    plus a VLM's patches."""
    P = cfg.n_patches if cfg.family == "vlm" else 0
    return SERVE_S + SERVE_GEN + 1 + P


def serve(params, cfg, prompts, stubs, mesh=None, comm=None):
    """Prefill and ``SERVE_GEN`` greedy decode steps -> (every step's
    logits (B, 1 + GEN, V), the tokens (B, 1 + GEN), the final cache)."""
    pre = make_prefill_step(cfg, cache_len=cache_len(cfg), backend="torch",
                            mesh=mesh, comm=comm)
    dec = make_decode_step(cfg, backend="torch", cache_len=cache_len(cfg),
                           mesh=mesh, comm=comm)
    with torch.no_grad():
        logits, cache = pre(params, {"tokens": prompts, **stubs})
        seen = [logits[:, -1]]
        tok = logits[:, -1].argmax(-1)[:, None]
        toks = [tok]
        for _ in range(SERVE_GEN):
            logits, cache = dec(params, cache, tok)
            seen.append(logits[:, -1])
            tok = logits[:, -1].argmax(-1)[:, None]
            toks.append(tok)
    return torch.stack(seen, 1), torch.cat(toks, 1), cache


def decode_refusals(params, cfg, prompts, stubs, mesh, comm) -> list:
    """A decode step on a fresh prefill's cache without the prefill's
    ``cache_len``, and with half of it (a shorter ring) -> [the
    ValueError's message or None for each]."""
    pre = make_prefill_step(cfg, cache_len=cache_len(cfg), backend="torch",
                            mesh=mesh, comm=comm)
    out = []
    for n in (None, cache_len(cfg) // 2):
        dec = make_decode_step(cfg, backend="torch", cache_len=n, mesh=mesh,
                               comm=comm)
        with torch.no_grad():
            logits, cache = pre(params, {"tokens": prompts, **stubs})
            try:
                dec(params, cache, logits[:, -1:].argmax(-1))
                out.append(None)
            except ValueError as e:
                out.append(str(e))
    return out


def train_tc(cfg, agg: str = "mean") -> TrainConfig:
    """The training runs' config: AdamW past its first warm-up step, the
    robust aggregators with a trim of 0 (two workers) on the plain
    route."""
    return TrainConfig(
        arch=cfg, opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20),
        agg=AggregatorConfig(kind=agg, F=0, gossip_rounds=6,
                             gamma_period=2, drop_prob=0.2,
                             trim_backend="torch",
                             pushsum_backend="torch"))


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


def mean_train(params, cfg, batches: list, mesh=None, comm=None) -> dict:
    """``TRAIN_STEPS`` mean steps on ``batches`` (the global batches) ->
    the losses, the trained parameters and each step's gradients (this
    rank's blocks, averaged over the data ranks; ``grads0`` the first
    step's as a tree)."""
    step = make_train_step(train_tc(cfg), backend="torch", record=True,
                           mesh=mesh, comm=comm)
    opt = adamw_init(params)
    losses, grads = [], []
    for batch in batches:
        params, opt, loss = step(params, opt, batch)
        losses.append(loss)
        grads.append([g.clone() for g in step.grads])
    return {"losses": torch.stack(losses), "params": params,
            "grads0": tree_like(params, grads[0]), "grads": grads}


def robust_train(params, cfg, agg: str, batches: list, mesh=None,
                 comm=None, layout=None) -> dict:
    """``ROBUST_STEPS`` robust steps of ``agg`` -> the losses, the trained
    parameters (a rank's copy, or the one-process stack) and each step's
    aggregate, leaf by leaf (the gradients AdamW took)."""
    step = make_train_step(train_tc(cfg, agg), layout, backend="torch",
                           mesh=mesh, comm=comm, record="aggregate")
    opt = adamw_init(params) if layout is None else worker_opt_init(params)
    losses, grads = [], []
    for s, batch in enumerate(batches[:ROBUST_STEPS]):
        params, opt, loss = step(params, opt, batch, fold_in(prng_key(0), s))
        losses.append(loss)
        grads.append(aggregate_leaves(step.aggregate, params,
                                      layout is not None))
    return {"losses": torch.stack(losses), "params": params, "grads": grads}


def aggregate_leaves(flat: torch.Tensor, params, stacked: bool) -> list:
    """A robust step's recorded aggregate (a rank's (D,) row, or the
    one-process (W, D) rows) leaf by leaf, in ``leaves(params)`` order and
    the leaves' shapes."""
    out, off = [], 0
    for p in leaves(params):
        n = p[0].numel() if stacked else p.numel()
        out.append(flat[..., off:off + n].reshape(p.shape))
        off += n
    return out


def train_cases(name: str, rm: RankMesh, comm: Comm, out: Path) -> dict:
    """Every case's mean steps on this rank's blocks, gathered over the
    mesh, and on :data:`ROBUST_MESH` the robust steps, each worker's copy
    gathered over "model"."""
    res = {}
    for case in CASES:
        cfg = case_cfg(case)
        check_model_axis(cfg, rm.size("model"))
        batches = torch.load(out / f"{case}_batches.pt")
        specs = param_specs(M.param_shapes(cfg), cfg, rm)

        def local():
            """This rank's blocks of the saved parameters, fresh for each
            run (a step updates them in place, and a replicated block is
            the loaded leaf itself)."""
            return shard_tree(torch.load(out / f"{case}_params.pt"), specs,
                              rm)

        got = mean_train(local(), cfg, batches, rm, comm)
        res[f"{case}/mean"] = {
            "losses": got["losses"],
            "params": gather_params(got["params"], cfg, rm, comm=comm),
            "grads0": gather_params(got["grads0"], cfg, rm, comm=comm),
            "grads": [leaves(gather_params(tree_like(got["params"], g), cfg,
                                           rm, comm=comm))
                      for g in got["grads"]]}
        if name != ROBUST_MESH or case not in ROBUST:
            continue
        for agg in ROBUST[case]:
            got = robust_train(local(), cfg, agg, batches, rm, comm)
            res[f"{case}/{agg}"] = {
                "losses": got["losses"],
                "params": gather_params(got["params"], cfg, rm, comm=comm),
                "grads": [leaves(gather_params(tree_like(got["params"], g),
                                               cfg, rm, comm=comm))
                          for g in got["grads"]]}
    return res


def operator_inputs(mp: int) -> dict:
    """The operators' gradient checks' inputs, float64 from a seed: x (R,
    d), W (d, C) with C = mp * OP_COLS columns, G (R, C) the upstream
    gradient, P (mp, R, C) one partial sum a rank."""
    g = torch.Generator().manual_seed(40 + mp)
    C = mp * OP_COLS
    return {k: torch.randn(shape, generator=g, dtype=torch.float64)
            for k, shape in (("x", (OP_ROWS, 5)), ("W", (5, C)),
                             ("G", (OP_ROWS, C)), ("P", (mp, OP_ROWS, C)))}


def operator_grads(ax: ModelAxis) -> dict:
    """This rank's gradients through ``gather_cols`` (a consumer that uses
    columns ``[r n, (r + 2) n)`` of the gathered whole, wrapping), and
    ``scatter_last`` / ``gather_last`` (a replicated consumer) ->
    {name: gradient}: the test sums them over the ranks where the
    one-process function does."""
    mp, r, n = ax.size, ax.rank, OP_COLS
    d = operator_inputs(mp)
    x = d["x"].clone().requires_grad_()
    W = d["W"][:, r * n:(r + 1) * n].clone().requires_grad_()
    Y = ax.gather_cols(ax.copy_in(x) @ W)
    used = torch.arange(r * n, (r + 2) * n) % (mp * n)
    (Y[:, used] * d["G"][:, used]).sum().backward()
    P = d["P"][r].clone().requires_grad_()
    T = ax.gather_last(ax.scatter_last(P) * d["G"][:, r * n:(r + 1) * n])
    T.sum().backward()
    return {"x": x.grad, "W": W.grad, "P": P.grad}


def run_cases(rm: RankMesh, comm: Comm, out: Path) -> dict:
    res = {}
    for name in CASES:
        cfg = case_cfg(name)
        full = torch.load(out / f"{name}_params.pt")
        inputs = torch.load(out / f"{name}_inputs.pt")
        specs = param_specs(M.param_shapes(cfg), cfg, rm)
        local = shard_tree(full, specs, rm)
        stubs = {k: rank_rows(v, rm) for k, v in inputs["stubs"].items()}
        logits, toks, cache = serve(local, cfg,
                                    rank_rows(inputs["prompts"], rm), stubs,
                                    rm, comm)
        res[name] = {"logits": logits, "tokens": toks, "cache": cache,
                     "decode_refused": None if name != "recurrentgemma"
                     else decode_refusals(
                         local, cfg, rank_rows(inputs["prompts"], rm), stubs,
                         rm, comm)}
    return res


def main(name: str, rank: int, world: int, port: int, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    path = Path(out) / f"{name}_{rank}"
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        rm = RankMesh(init_device_mesh("cpu", MESHES[name],
                                       mesh_dim_names=("data", "model")))
        comm = Comm(rm)
        res = run_cases(rm, comm, Path(out))
        trained = train_cases(name, rm, comm, Path(out))
        grads = operator_grads(ModelAxis(comm))
        coord = tuple(rm.mesh.get_coordinate())
        dist.barrier()
        dist.destroy_process_group()
        loaded = sorted(k for k in sys.modules
                        if k.split(".")[0] in ("jax", "jaxlib", "repro"))
        torch.save({"cases": res, "trained": trained,
                    "operator_grads": grads,
                    "coordinate": coord, "loaded": loaded,
                    "staged_calls": comm.staged_calls}, f"{path}.pt")
    except BaseException:
        Path(f"{path}.err").write_text(traceback.format_exc())
        raise
