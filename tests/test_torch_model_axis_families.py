"""The other model families served and trained over a model axis on the
CPU: gloo ranks in spawned processes (``tests/_torch_model_axis_child.py``),
held against the one-process port and the reference's one-device serve
and mean step.

Three meshes run once for the module, at the same time, 10 ranks: (model
2), (model 4) and (data 2 x model 2). On each, every case of
``child.CASES`` (reduced RWKV6, RecurrentGemma with a wrapping window and
with 6 query heads, Whisper and InternVL2 with their stub inputs and with
an odd vocabulary of 509, Command-R's parallel blocks, RWKV6 with 2
heads and with a d_ff of 510; float32) runs prefill and 3 greedy decode steps through the
mesh-taking step builders on the rank's blocks of the reference's
parameters (converted), then 3 mean steps. The layouts this covers:
RWKV6's heads over the axis (2 and 1 a rank, and half a head a rank at
model 4: the projections gathered, the scan on every head; its channel
mix's whole wk and wv beside a split wr at model 4), query heads
split inside a head (RecurrentGemma's 6 heads at model 4: 1.5 a rank), one
KV head split inside the head at every extent, K/V caches split over the
ring's rows (wrapped by the prompt, written by the owning rank) and a ring
whose rows do not split (whole on every rank), the RG-LRU on its
channels, Whisper's encoder and cross-attention on local heads,
vocabularies that do not split (whole on every rank), InternVL2's patch
projector, Command-R's parallel attention and MLP.

* Logits within 1e-4 of the one-process port and of the reference's
  ``prefill`` / ``decode_step`` (float32 on every side; the blocks sum
  their products in another order); greedy tokens equal to both.
* Every cache leaf of every rank within 1e-5 of its ``cache_specs`` block
  of the one-process cache.
* K5's rank-partial plain version and its merge over 1, 2 and 4 blocks of
  a ring (an empty block, a wrapped ring, requests of length 0) against
  ``attn_decode_ref`` and the reference's ``repro.kernels.swa.ref``.
* The backward rules of the model axis' new operators against one
  process's autograd (float64): ``gather_cols`` for a consumer that uses
  part of the gathered columns on each rank (its backward sums the ranks'
  gradients), ``scatter_last`` (its backward gathers the blocks') and
  ``gather_last`` for a replicated consumer.
* The mean step of every case on every mesh: 3 losses within rtol 2e-3
  of the reference's (``_grads_microbatched`` and ``adamw_update``, the
  body of its GSPMD ``make_train_step``, on one device: the reference's
  own dp x tp bound, ``tests/test_distributed.py:231``); each step's
  gradients, gathered over the mesh, against the reference's at the same
  parameters within 2e-5 of each leaf's scale plus twice the reference's
  own float32 noise there; the parameters after 3 steps within 1e-6 of
  the reference's AdamW on those gradients, and within 1e-4 of the
  reference's own run wherever its gradients fix AdamW's step (see
  ``GRAD_RTOL``); every rank's loss and gathered model identical.
* The robust rank steps of RWKV6 and RecurrentGemma with 6 heads on (data
  2 x model 2), ``trimmed_mean`` at F 0 and ``pushsum``, held the same
  way against the one-process robust step on 2 workers: the losses within
  rtol 2e-3, each step's aggregate against row w of the one-process
  step's at the same parameters, each worker's gathered copy after 2
  steps against AdamW on its aggregates and, where the aggregates fix
  AdamW's step, within 1e-4 of row w.
* ``check_model_axis``, which the training steps call, passes every case
  on every mesh; no rank loads ``jax`` or ``repro``.
* The train CLI trains reduced RWKV6 on 2 gloo ranks with
  ``--model-parallel 2``: the one-process CLI's losses.
* A decode step refuses a cache split over its ring's rows without the
  prefill's ``cache_len``, or with one that gives another ring.
"""
import dataclasses
import multiprocessing as mp
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import _torch_model_axis_child as child
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.swa.ref import attn_decode_ref as jax_attn_decode_ref
from repro.distributed.trainer import _grads_microbatched as jax_grads
from repro.models import model as JM
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro_torch.convert import params_from_jax
from repro_torch.distributed.aggregation import WorkerLayout
from repro_torch.distributed.sharding import cache_specs, local_block
from repro_torch.core.prng import fold_in, prng_key
from repro_torch.distributed.trainer import (make_train_step,
                                             replicate_for_workers,
                                             worker_opt_init)
from repro_torch.kernels.swa import (attn_decode_merge_ref,
                                     attn_decode_partial_ref,
                                     attn_decode_ref)
from repro_torch.models import model as TM
from repro_torch.models.model_axis import check_model_axis
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim.adamw import leaves

pytestmark = pytest.mark.multidevice

REPO = Path(__file__).resolve().parents[1]
WORLD = {name: d * m for name, (d, m) in child.MESHES.items()}
TIMEOUT = 300          # seconds for all three meshes
TOL, CACHE_TOL = 1e-4, 1e-5
#: The training holds. Float32 moves a gradient by its own rounding noise
#: (RWKV6's scan up to 1e-3 of a leaf's scale under a few ulps on its
#: weights), and AdamW, which divides the gradient by its own size, moves
#: a coordinate whose gradient is that noise by about lr either way. So
#: a rank step is held in its two parts, each on every coordinate: each
#: step's gradients against the reference's at the same parameters, leaf
#: by leaf within GRAD_RTOL of the leaf's scale (the bound of
#: ``tests/test_torch_model_mesh.py``) plus twice the reference's own
#: noise there (the largest gap to its gradients on the weights scaled by
#: 1 +- 2^-22, over NUDGES seeded draws: ``_band``); and its parameters
#: against the reference's AdamW on the rank's gradients, within
#: REPLAY_TOL (an elementwise update on the same inputs). The parameters
#: after the steps are also held within PARAM_TOL of the reference's own
#: run wherever the reference's gradient, at every step, lies RESOLVED
#: bands or more from zero: a gradient off by a fraction e of itself
#: turns AdamW's step by about 2 e lr, and the steps' lr sum to 2.5e-3, so
#: e <= 1 / RESOLVED keeps such a coordinate within half of PARAM_TOL.
#: The bands and that choice come from the reference side alone.
GRAD_RTOL, PARAM_TOL, REPLAY_TOL = 2e-5, 1e-4, 1e-6
NUDGES, RESOLVED = 4, 100


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_cfg(name: str):
    arch, extra = child.CASES[name]
    return dataclasses.replace(jax_reduced(jax_get_config(arch)), **extra)


def _inputs(cfg, seed: int) -> dict:
    """Prompts and the stub inputs (numpy float32) from a seed."""
    rng = np.random.default_rng(seed)
    B = child.SERVE_B
    stubs = {}
    if cfg.family == "audio":
        stubs["frames"] = rng.normal(size=(B, cfg.n_frames, cfg.d_model))
    if cfg.family == "vlm":
        stubs["patch_embeds"] = rng.normal(size=(B, cfg.n_patches, TM.D_VIS))
    return {"prompts": rng.integers(0, cfg.vocab, size=(B, child.SERVE_S)
                                    ).astype(np.int32),
            "stubs": {k: v.astype(np.float32) for k, v in stubs.items()}}


def _train_batches(cfg, seed: int) -> list[dict]:
    """``child.TRAIN_STEPS`` global batches (numpy) from a seed: tokens,
    their next tokens as labels, and the family's stub inputs."""
    rng = np.random.default_rng(seed)
    B, S = child.TRAIN_B, child.TRAIN_S
    out = []
    for _ in range(child.TRAIN_STEPS):
        toks = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "audio":
            b["frames"] = rng.normal(size=(B, cfg.n_frames, cfg.d_model))
        if cfg.family == "vlm":
            b["patch_embeds"] = rng.normal(size=(B, cfg.n_patches, TM.D_VIS))
        out.append({k: (v.astype(np.float32) if v.dtype == np.float64
                        else np.ascontiguousarray(v)) for k, v in b.items()})
    return out


def _nudged(leaf: np.ndarray, seed: int) -> np.ndarray:
    """A float32 leaf with each entry scaled by 1 +- 2^-22 (a seeded
    sign an entry): a few ulps."""
    sign = np.random.default_rng(seed).integers(0, 2, leaf.shape) * 2 - 1
    return (leaf * (1 + sign * 2.0 ** -22)).astype(leaf.dtype)


def _band(grads_at, params: list, grads: list) -> list[float]:
    """Each leaf's bound on another float32 path's gradients at
    ``params`` (a list of leaves) against ``grads``, the reference side's
    there: GRAD_RTOL of the leaf's scale plus twice the largest gap to
    the same side's gradients on NUDGES nudged copies of the weights
    (``grads_at(leaves) -> leaves``)."""
    gaps = [0.0] * len(grads)
    for k in range(NUDGES):
        moved = grads_at([_nudged(p, 100 * k + i)
                          for i, p in enumerate(params)])
        gaps = [max(m, float(np.abs(a - g).max()))
                for m, a, g in zip(gaps, moved, grads)]
    return [GRAD_RTOL * float(np.abs(g).max()) + 2 * m + 1e-12
            for g, m in zip(grads, gaps)]


def _reference_train(jp, jcfg, batches) -> dict:
    """The reference's mean step on one device, ``child.TRAIN_STEPS``
    times: its ``_grads_microbatched`` and ``adamw_update`` (the body of
    its GSPMD ``make_train_step``), each jitted -> losses, the trained
    parameters, each step's gradients and their bands (numpy leaves), and
    what a test needs to take the same steps from elsewhere: the
    initial parameters, the jitted gradient and update, the batches."""
    opt = JAdamWConfig(**dataclasses.asdict(
        child.train_tc(child.case_cfg("rwkv6")).opt))
    tree = jax.tree.structure(jp)
    grads_fn = jax.jit(lambda p, b: jax_grads(p, jcfg, b, 1))
    update = jax.jit(lambda g, o, p: jax_adamw_update(opt, g, o, p))
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]

    def at(b):
        return lambda ps: [np.asarray(g) for g in jax.tree.leaves(
            grads_fn(jax.tree.unflatten(tree, ps), b)[1])]

    p, o = jp, jax_adamw_init(jp)
    losses, grads, bands = [], [], []
    for b in jb:
        loss, g = grads_fn(p, b)
        losses.append(float(loss))
        grads.append([np.asarray(x) for x in jax.tree.leaves(g)])
        bands.append(_band(at(b), [np.asarray(x) for x in
                                   jax.tree.leaves(p)], grads[-1]))
        p, o = update(g, o, p)
    return {"losses": np.array(losses),
            "params": [np.asarray(x) for x in jax.tree.leaves(p)],
            "grads": grads, "bands": bands, "init": jp, "tree": tree,
            "grads_at": at, "update": update, "batches": jb}


def _resolved(grads: list, bands: list, i: int) -> np.ndarray:
    """Leaf i's coordinates whose gradient lies RESOLVED bands or more
    from zero at every step (``grads`` and ``bands`` by step)."""
    return np.all([np.abs(g[i]) > RESOLVED * b[i]
                   for g, b in zip(grads, bands)], axis=0)


def _within(got: np.ndarray, want: np.ndarray, bound: float,
            what: str) -> None:
    gap = float(np.abs(got - want).max()) if got.size else 0.0
    assert gap <= bound, f"{what}: {gap:.3e} past {bound:.3e}"


def _clone_tree(tree):
    return child.tree_like(tree, [x.clone() for x in leaves(tree)])


def _robust_aggregate(params_w, cfg, agg: str, batch: dict, s: int
                      ) -> list:
    """The one-process robust step's aggregate (leaf by leaf, stacked
    (W, ...)) at step ``s`` from ``params_w``, which stay as they are."""
    n = child.MESHES[child.ROBUST_MESH][0]
    p = _clone_tree(params_w)
    step = make_train_step(child.train_tc(cfg, agg), WorkerLayout(1, n),
                           backend="torch", record="aggregate")
    step(p, worker_opt_init(p), batch, fold_in(prng_key(0), s))
    return [a.numpy() for a in
            child.aggregate_leaves(step.aggregate, p, True)]


def _one_process_robust(name: str, agg: str, params, batches) -> dict:
    """The port's one-process robust step on the (data 2) workers of
    (data 2 x model 2), ``child.ROBUST_STEPS`` times -> losses, the
    stacked (2, ...) parameters, each step's aggregate and its bands (the
    same step's on nudged weights), and the initial parameters."""
    n = child.MESHES[child.ROBUST_MESH][0]
    cfg = child.case_cfg(name)
    p = replicate_for_workers(params, n)
    init = _clone_tree(p)
    step = make_train_step(child.train_tc(cfg, agg), WorkerLayout(1, n),
                           backend="torch", record="aggregate")
    opt = worker_opt_init(p)
    losses, grads, bands = [], [], []
    for s, b in enumerate(batches[:child.ROBUST_STEPS]):
        at = [x.numpy().copy() for x in leaves(p)]

        def aggregate(ps, b=b, s=s):
            return _robust_aggregate(child.tree_like(p, [
                torch.from_numpy(x) for x in ps]), cfg, agg, b, s)

        p, opt, loss = step(p, opt, b, fold_in(prng_key(0), s))
        losses.append(loss)
        grads.append([a.numpy().copy() for a in child.aggregate_leaves(
            step.aggregate, p, True)])
        bands.append(_band(aggregate, at, grads[-1]))
    return {"losses": torch.stack(losses),
            "params": [x.numpy() for x in leaves(p)], "grads": grads,
            "bands": bands, "init": init, "batches": batches}


def _reference_serve(jp, jcfg, inputs) -> tuple[np.ndarray, np.ndarray]:
    """The reference's one-device prefill and greedy decode steps, jitted
    -> (logits (B, 1 + GEN, V), tokens (B, 1 + GEN))."""
    stubs = {k: jnp.asarray(v) for k, v in inputs["stubs"].items()}
    prefill = jax.jit(lambda p, t, s: JM.prefill(
        p, jcfg, t, cache_len=child.cache_len(jcfg), **s))
    decode = jax.jit(lambda p, c, t: JM.decode_step(p, jcfg, c, t))
    lg, cache = prefill(jp, jnp.asarray(inputs["prompts"]), stubs)
    seen = [np.asarray(lg[:, -1])]
    tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
    toks = [np.asarray(tok)]
    for _ in range(child.SERVE_GEN):
        lg, cache = decode(jp, cache, tok)
        seen.append(np.asarray(lg[:, -1]))
        tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
    return np.stack(seen, 1), np.concatenate(toks, 1)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Convert each case's reference parameters, launch the three meshes,
    and meanwhile run the reference's and the one-process port's serves,
    the reference's mean steps and the port's one-process robust steps,
    with their gradients' bands ->
    (ranks by mesh, reference by case, one-process port by case, the
    reference's training by case, the one-process robust runs by (case,
    aggregator))."""
    out = tmp_path_factory.mktemp("model_axis_families")
    jparams, inputs, batches = {}, {}, {}
    for i, name in enumerate(child.CASES):
        jcfg, tcfg = _jax_cfg(name), child.case_cfg(name)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        jparams[name] = JM.init_params(jax.random.PRNGKey(i), jcfg)
        torch.save(params_from_jax(jax.tree.map(np.asarray, jparams[name]),
                                   tcfg, "cpu"), out / f"{name}_params.pt")
        inputs[name] = _inputs(tcfg, 10 + i)
        torch.save({"prompts": torch.from_numpy(inputs[name]["prompts"]),
                    "stubs": {k: torch.from_numpy(v) for k, v in
                              inputs[name]["stubs"].items()}},
                   out / f"{name}_inputs.pt")
        batches[name] = _train_batches(tcfg, 30 + i)
        torch.save([{k: torch.from_numpy(v) for k, v in b.items()}
                    for b in batches[name]], out / f"{name}_batches.pt")
    ctx = mp.get_context("spawn")
    procs = []
    for mesh, world in WORLD.items():
        port = _free_port()
        procs += [ctx.Process(target=child.main,
                              args=(mesh, r, world, port, str(out)))
                  for r in range(world)]
    for p in procs:
        p.start()
    ref, one, trained, robust = {}, {}, {}, {}
    prev = torch.get_num_threads()
    try:
        for name in child.CASES:
            ref[name] = _reference_serve(jparams[name], _jax_cfg(name),
                                         inputs[name])
            cfg = child.case_cfg(name)
            params = torch.load(out / f"{name}_params.pt")
            one[name] = child.serve(params, cfg,
                                    torch.from_numpy(inputs[name]["prompts"]),
                                    {k: torch.from_numpy(v) for k, v in
                                     inputs[name]["stubs"].items()})
            trained[name] = _reference_train(jparams[name], _jax_cfg(name),
                                             batches[name])
        torch.set_num_threads(1)     # the ranks' threads: the same GEMMs
        for name, aggs in child.ROBUST.items():
            for agg in aggs:
                robust[name, agg] = _one_process_robust(
                    name, agg, torch.load(out / f"{name}_params.pt"),
                    torch.load(out / f"{name}_batches.pt"))
    finally:
        torch.set_num_threads(prev)
        for p in procs:
            p.join(TIMEOUT)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    errs = sorted(out.glob("*.err"))
    assert not errs, "\n".join(e.read_text() for e in errs)
    assert not hung, f"{len(hung)} ranks did not finish in {TIMEOUT} s"
    assert all(p.exitcode == 0 for p in procs)
    ranks = {mesh: [torch.load(out / f"{mesh}_{r}.pt") for r in range(world)]
             for mesh, world in WORLD.items()}
    return ranks, ref, one, trained, robust


class _Coords:
    """A rank's view of a mesh for the spec rules and ``local_block``: the
    ``RankMesh`` interface without a process group."""

    axis_names = ("data", "model")

    def __init__(self, shape: tuple, coord: tuple):
        self.shape = dict(zip(self.axis_names, shape))
        self.coords = dict(zip(self.axis_names, coord))

    def size(self, *axes):
        n = 1
        for a in axes:
            n *= self.shape.get(a, 1)
        return n

    def index(self, *axes):
        i = 0
        for a in axes:
            if a in self.shape:
                i = i * self.shape[a] + self.coords[a]
        return i


def _blocks(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: _blocks(tree[k], specs[k], mesh) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_blocks(t, s, mesh) for t, s in zip(tree, specs)]
    return local_block(tree, specs, mesh)


def _close_trees(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close_trees(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _close_trees(a, b, f"{path}/{i}")
        return
    assert got.shape == want.shape and got.dtype == want.dtype, path
    torch.testing.assert_close(got, want, rtol=0, atol=CACHE_TOL, msg=path)


def test_no_rank_loads_jax_or_repro(served):
    for mesh, ranks in served[0].items():
        for r, res in enumerate(ranks):
            assert res["loaded"] == [], (mesh, r, res["loaded"])
            assert res["staged_calls"] == 0        # CPU tensors


@pytest.mark.parametrize("case", list(child.CASES))
@pytest.mark.parametrize("mesh", list(child.MESHES))
def test_family_serves_over_the_model_axis(served, mesh, case):
    """Every rank's logits against the one-process port and the
    reference, its greedy tokens against both, and every cache leaf
    against its ``cache_specs`` block of the one-process cache."""
    ranks, ref, one = served[:3]
    logits, toks, cache = one[case]
    ref_logits, ref_toks = ref[case]
    cfg = child.case_cfg(case)
    shape = child.MESHES[mesh]
    b = child.SERVE_B // shape[0]
    specs = cache_specs(cache, cfg, _Coords(shape, (0, 0)))
    for res in ranks[mesh]:
        got = res["cases"][case]
        d, m = res["coordinate"]
        rows = slice(d * b, (d + 1) * b)
        assert got["logits"].shape == (b, 1 + child.SERVE_GEN, cfg.vocab)
        torch.testing.assert_close(got["logits"], logits[rows], rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(got["logits"].numpy(), ref_logits[rows],
                                   rtol=0, atol=TOL)
        assert torch.equal(got["tokens"], toks[rows])
        np.testing.assert_array_equal(got["tokens"].numpy(), ref_toks[rows])
        _close_trees(got["cache"], _blocks(cache, specs,
                                           _Coords(shape, (d, m))))


def test_the_cases_cover_the_layouts(served):
    """The cases reach what they are there for: a K/V cache split over the
    ring's rows, a whole ring, a query split inside a head, an odd
    vocabulary whole on every rank."""
    ranks = served[0]

    def kv_rows(mesh, case):
        c = ranks[mesh][0]["cases"][case]["cache"]
        return [lay["mixer"]["k"].shape[2] for lay in c["layers"]
                if "k" in lay["mixer"]]

    assert kv_rows("model2", "recurrentgemma") == [6]     # 12-row ring
    assert kv_rows("model4", "recurrentgemma") == [3]
    assert kv_rows("model2", "recurrentgemma_6h") == [5]
    assert kv_rows("model4", "recurrentgemma_6h") == [10]  # whole ring
    assert kv_rows("model4", "internvl2") == [9, 9]
    assert kv_rows("model2", "whisper") == [20, 20]       # KV heads split
    rg6 = child.case_cfg("recurrentgemma_6h")
    assert (rg6.n_heads * rg6.head_dim // 4) % rg6.head_dim != 0


@pytest.mark.parametrize("mesh", list(child.MESHES))
def test_model_axis_operators_backward(served, mesh):
    """Every rank's gradients through the operators against one process:
    the sum over ranks r of the loss each rank's consumer computes, by
    autograd on the whole tensors."""
    ranks = served[0][mesh]
    mp, n = child.MESHES[mesh][1], child.OP_COLS
    d = child.operator_inputs(mp)
    x = d["x"].clone().requires_grad_()
    W = d["W"].clone().requires_grad_()
    P = d["P"].clone().requires_grad_()
    Y = x @ W
    total = P.sum(0)
    loss = 0
    for r in range(mp):
        used = torch.arange(r * n, (r + 2) * n) % (mp * n)
        loss = loss + (Y[:, used] * d["G"][:, used]).sum()
    # the replicated consumer: the loss is computed once, on every rank
    loss = loss + (total * d["G"]).sum()
    loss.backward()
    for res in ranks:
        got = res["operator_grads"]
        r = int(res["coordinate"][1])
        torch.testing.assert_close(got["x"], x.grad, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got["W"], W.grad[:, r * n:(r + 1) * n],
                                   rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got["P"], P.grad[r], rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("case", list(child.CASES))
@pytest.mark.parametrize("mesh", list(child.MESHES))
def test_check_model_axis_passes_every_case_for_training(mesh, case):
    """The training steps take every case on every mesh, as serving does:
    splits inside a head (RWKV6's and attention's), odd vocabularies,
    parallel blocks, encoders and patch projectors."""
    check_model_axis(child.case_cfg(case), child.MESHES[mesh][1])


@pytest.mark.parametrize("case", list(child.CASES))
@pytest.mark.parametrize("mesh", list(child.MESHES))
def test_family_trains_over_the_model_axis(served, mesh, case):
    """Every rank's 3 mean steps against the reference's one-device step,
    gathered over the mesh: the losses; each step's gradients against the
    reference's at the same parameters (the first step's at the shared
    start, a later one's where the reference's AdamW on the rank's
    gradients so far leaves them); the trained parameters against that
    replay on every coordinate, and against the reference's own run where
    its gradients resolve AdamW's step (see GRAD_RTOL). Every rank reports
    the same loss and holds the same gathered model."""
    ranks, ref = served[0][mesh], served[3][case]
    first = ranks[0]["trained"][f"{case}/mean"]
    for res in ranks:
        got = res["trained"][f"{case}/mean"]
        np.testing.assert_allclose(got["losses"].numpy(), ref["losses"],
                                   rtol=2e-3, atol=2e-3)
        assert torch.equal(got["losses"], first["losses"])
        assert all(torch.equal(a, b) for a, b in
                   zip(leaves(got["params"]), leaves(first["params"])))
    p, o = ref["init"], jax_adamw_init(ref["init"])
    for s, b in enumerate(ref["batches"]):
        got = [g.numpy() for g in first["grads"][s]]
        want, band = ref["grads"][s], ref["bands"][s]
        if s:
            at = [np.asarray(x) for x in jax.tree.leaves(p)]
            want = ref["grads_at"](b)(at)
            band = _band(ref["grads_at"](b), at, want)
        assert [g.shape for g in got] == [w.shape for w in want]
        for i, (a, w) in enumerate(zip(got, want)):
            _within(a, w, band[i],
                    f"{mesh} {case}: step {s} gradient leaf {i}")
        p, o = ref["update"](jax.tree.unflatten(
            ref["tree"], [jnp.asarray(g) for g in got]), o, p)
    trained = [x.numpy() for x in leaves(first["params"])]
    for i, (a, w) in enumerate(zip(trained, jax.tree.leaves(p))):
        _within(a, np.asarray(w), REPLAY_TOL,
                f"{mesh} {case}: parameter leaf {i} against the replay")
    for i, (a, w) in enumerate(zip(trained, ref["params"])):
        keep = _resolved(ref["grads"], ref["bands"], i)
        _within(a[keep], w[keep], PARAM_TOL,
                f"{mesh} {case}: parameter leaf {i} where resolved")


@pytest.mark.parametrize("case,agg", [(c, a) for c, aggs in
                                      child.ROBUST.items() for a in aggs])
def test_robust_rank_steps_match_the_one_process_rows(served, case, agg):
    """Each worker's copy (gathered over "model") after 2 robust steps
    against row w of the one-process robust step on the same 2 workers,
    as the mean step is held against the reference: the losses; each
    step's aggregate against the one-process step's at the same
    parameters (the first at the shared start, the second at the
    workers' copies that AdamW on their first aggregates gives); the
    parameters against that replay, and against row w where the
    one-process aggregates resolve AdamW's step."""
    want = served[4][case, agg]
    cfg = child.case_cfg(case)
    opt_cfg = child.train_tc(cfg, agg).opt
    runs = {int(r["coordinate"][0]): r["trained"][f"{case}/{agg}"]
            for r in served[0][child.ROBUST_MESH]}
    replays, opts = {}, {}
    for w, got in runs.items():
        np.testing.assert_allclose(got["losses"].numpy(),
                                   want["losses"].numpy(), rtol=2e-3)
        for i, a in enumerate(got["grads"][0]):
            _within(a.numpy(), want["grads"][0][i][w], want["bands"][0][i],
                    f"{case} {agg} worker {w}: step 0 aggregate leaf {i}")
        replays[w] = child.tree_like(want["init"], [
            x[w].clone() for x in leaves(want["init"])])
        opts[w] = adamw_init(replays[w])
        adamw_update(opt_cfg, got["grads"][0], opts[w], replays[w])
    stacked = child.tree_like(want["init"], [
        torch.stack(xs) for xs in zip(*(leaves(replays[w])
                                        for w in sorted(replays)))])
    start = [x.numpy() for x in leaves(stacked)]

    def aggregate(ps):
        return _robust_aggregate(child.tree_like(stacked, [
            torch.from_numpy(x) for x in ps]), cfg, agg, want["batches"][1], 1)

    at = aggregate(start)
    band = _band(aggregate, start, at)
    for w, got in runs.items():
        for i, a in enumerate(got["grads"][1]):
            _within(a.numpy(), at[i][w], band[i],
                    f"{case} {agg} worker {w}: step 1 aggregate leaf {i}")
        adamw_update(opt_cfg, got["grads"][1], opts[w], replays[w])
        trained = [x.numpy() for x in leaves(got["params"])]
        for i, (a, r) in enumerate(zip(trained, leaves(replays[w]))):
            _within(a, r.numpy(), REPLAY_TOL,
                    f"{case} {agg} worker {w}: leaf {i} against the replay")
        rows = [[x[w] for x in g] for g in want["grads"]]
        for i, (a, b) in enumerate(zip(trained, want["params"])):
            keep = _resolved(rows, want["bands"], i)
            _within(a[keep], b[w][keep], PARAM_TOL,
                    f"{case} {agg} worker {w}: leaf {i} where resolved")


def test_rwkv6_split_inside_a_head_keeps_the_whole_state(served):
    """RWKV6 with 2 heads at model 4 (half a head a rank): every rank's
    cache holds the whole (B, H, 64, 64) state, equal on every rank of a
    data row; at model 2 each rank holds its head."""
    cfg = child.case_cfg("rwkv6_d128")
    H = cfg.d_model // cfg.wkv_head_dim
    for mesh, heads in (("model4", H), ("model2", H // 2)):
        states = [[lay["mixer"]["state"] for lay in
                   r["cases"]["rwkv6_d128"]["cache"]["layers"]]
                  for r in served[0][mesh]]
        for st in states:
            assert all(s.shape == (child.SERVE_B, heads, 64, 64)
                       for s in st), mesh
        if mesh == "model4":
            assert all(torch.equal(a, b) for st in states[1:]
                       for a, b in zip(st, states[0]))


@pytest.mark.parametrize("mesh", list(child.MESHES))
def test_decode_refuses_a_split_ring_without_its_capacity(served, mesh):
    """RecurrentGemma's one KV head is split over its ring's rows on every
    mesh: a decode step refuses the cache without the prefill's
    ``cache_len``, and with one that gives a shorter ring."""
    for rank in served[0][mesh]:
        missing, shorter = rank["cases"]["recurrentgemma"]["decode_refused"]
        assert missing is not None and "cache_len" in missing, missing
        assert shorter is not None and "K/V rows" in shorter, shorter


# ---------------------------------------------------------------------------
# K5's rank-partial plain version and its merge
# ---------------------------------------------------------------------------

def _ring_case(seed: int, B=3, H=6, Hkv=2, Wc=16, dh=32):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, H, dh), generator=g)
    k = torch.randn((B, Hkv, Wc, dh), generator=g)
    v = torch.randn((B, Hkv, Wc, dh), generator=g)
    return q, k, v


# lengths of the whole ring: full (a wrapped ring: every row valid), a
# ring filled into its first block only (empty later blocks), inside the
# last block, a request of length 1
_LENGTHS = {"wrapped": [16, 16, 16], "first_block_only": [3, 4, 2],
            "ragged": [13, 9, 1]}


@pytest.mark.parametrize("lengths", list(_LENGTHS))
@pytest.mark.parametrize("n", [1, 2, 4])
def test_rank_partial_decode_and_merge_equal_the_whole(n, lengths):
    q, k, v = _ring_case(n)
    L = torch.tensor(_LENGTHS[lengths], dtype=torch.int32)
    Wb = k.shape[2] // n
    parts = []
    for r in range(n):
        blk = slice(r * Wb, (r + 1) * Wb)
        Lr = torch.clamp(L - r * Wb, 0, Wb).to(torch.int32)
        parts.append(attn_decode_partial_ref(q, k[:, :, blk].contiguous(),
                                             v[:, :, blk].contiguous(), Lr))
    acc, m, l = (torch.stack(t) for t in zip(*parts))
    if lengths == "first_block_only" and n > 1:
        assert bool((m[1:] == -torch.inf).all()) and \
            bool((l[1:] == 0).all()) and bool((acc[1:] == 0).all())
    got = attn_decode_merge_ref(acc, m, l)
    want = attn_decode_ref(q, k, v, L)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    jwant = jax_attn_decode_ref(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                jnp.asarray(v.numpy()), jnp.asarray(L.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_rank_partial_merge_of_empty_requests_is_nan(n):
    """A request with no valid row in any block: 0 / 0, as the whole
    decode gives a request of length 0; the other requests are exact."""
    q, k, v = _ring_case(20 + n)
    L = torch.tensor([0, 16, 5], dtype=torch.int32)
    Wb = k.shape[2] // n
    parts = [attn_decode_partial_ref(
        q, k[:, :, r * Wb:(r + 1) * Wb], v[:, :, r * Wb:(r + 1) * Wb],
        torch.clamp(L - r * Wb, 0, Wb)) for r in range(n)]
    got = attn_decode_merge_ref(*(torch.stack(t) for t in zip(*parts)))
    want = attn_decode_ref(q, k, v, L)
    assert bool(torch.isnan(got[0]).all()) and bool(torch.isnan(want[0]).all())
    torch.testing.assert_close(got[1:], want[1:], rtol=1e-5, atol=1e-6)


def test_rank_partial_merge_casts_to_the_output_dtype():
    """bf16 inputs: the triple is float32; the merge's output takes the
    requested dtype, as the whole decode returns q's."""
    q, k, v = (t.to(torch.bfloat16) for t in _ring_case(7))
    L = torch.tensor([16, 10, 3], dtype=torch.int32)
    acc, m, l = attn_decode_partial_ref(q, k, v, L)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    got = attn_decode_merge_ref(acc[None], m[None], l[None], torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = attn_decode_ref(q, k, v, L)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -8,
                               atol=2 ** -8)


def _cli_losses(text: str) -> list[float]:
    return [float(line.split()[3]) for line in text.splitlines()
            if line.startswith("step ")]


def test_train_cli_trains_rwkv6_over_the_model_axis():
    """``python -m repro_torch.launch.train --arch rwkv6_1b6 --reduced
    --model-parallel 2`` on 2 gloo CPU ranks (the environment torchrun
    gives them): rank 0 prints the ``step N loss`` lines and ``done``,
    rank 1 nothing; the losses are the one-process CLI's."""
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "rwkv6_1b6", "--reduced", "--steps", "3", "--seq-len", "16",
            "--global-batch", "4", "--device", "cpu"]
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    one = subprocess.run(args, env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert one.returncode == 0, one.stderr[-2000:]
    port = str(_free_port())
    ranks = [subprocess.Popen(
        args + ["--model-parallel", "2"], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={**env, "WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r),
             "MASTER_ADDR": "localhost", "MASTER_PORT": port})
        for r in range(2)]
    outs = [p.communicate(timeout=120) for p in ranks]
    assert [p.returncode for p in ranks] == [0, 0], outs[0][1][-2000:]
    lines = outs[0][0].splitlines()
    assert lines[-1] == "done" and outs[1][0] == ""
    got, want = _cli_losses(outs[0][0]), _cli_losses(one.stdout)
    assert len(got) == 3 and len(want) == 3
    np.testing.assert_allclose(got, want, rtol=2e-3)
