"""The port's model stack over ``torch.distributed`` device meshes on the
CPU: gloo ranks in spawned processes (``tests/_torch_model_mesh_child.py``),
held against the one-process port and the reference.

Five meshes run once for the module, at the same time, 16 ranks: (data 4)
and (pod 2, data 2) for the workers as ranks, (model 2) and (data 2 x
model 2) for the model axis, (data 2) for FSDP. Beside them a subprocess
runs the reference's expert-parallel MoE block on 4 fake devices,
reduced OLMoE's mean step on 2 and 4, and the FSDP mean steps.

* The six aggregators' rank forms, each on the reference's collective,
  against the one-card form on the same (W, D) buffer: bit-equal (the
  same operands in the same order: the gathers hand every rank the whole
  buffer, the stripes are its columns, the ring and the pods' fusion do
  the same elementwise operations; with two pods the fusion's sum has two
  operands), but ``mean``, whose ``all_reduce`` sums in gloo's order:
  within W float32 ulps of the sum's scale.
* The robust step over 4 ranks (reduced paper_sim, 3 steps) against the
  one-process ``_make_robust_step`` on a ``WorkerLayout``: each rank's
  parameters against row w, losses, first aggregate. The ranks and this
  process run one torch thread. A step's GEMMs are the same shapes on the
  same operands either way, the aggregate is bit-equal, and AdamW is
  elementwise but for its clip norm, whose sum of squares runs over a
  (W, ...) leaf in one process and a (...) leaf on a rank: the parameters
  are held to a few float32 ulps of the update (rtol 1e-6, atol 1e-7).
* The model axis: reduced Qwen3-8B in float32 on (model 2) and (data 2 x
  model 2): prefill and 3 decode steps' logits within 1e-4 of the
  one-process port, the greedy tokens equal, each KV shard its head slice
  of the one-process cache (within 1e-5: a column block of a product
  sums its terms as the full product does, but the blocking may differ);
  the mean step's 3 losses within rtol 2e-3 of the reference's
  single-device ``make_train_step`` on the same parameters (the
  reference's own dp x tp bound, ``tests/test_distributed.py:231``).
* The expert-parallel mean step (reduced OLMoE, ``moe_impl="sharded"``)
  on the same two meshes: 3 losses within rtol 2e-3 of the reference's
  ``make_train_step`` on a mesh of fake devices of the same shape.
* The backward over the model axis: the first step's gradients of both
  models, gathered over the mesh, within 2e-5 of each leaf's scale of the
  reference's (Qwen3 on one device, OLMoE on the same mesh).
* The sharded MoE (reduced OLMoE, ``moe_impl="sharded"``) on (data 2 x
  model 2) against the reference's ``_moe_block_sharded`` on a (data 2,
  model 2) mesh of fake devices: y within 1e-4, aux within 1e-6.
* The FSDP mean step (a fifth mesh, (data 2)): reduced Qwen3 on (data 2)
  and (data 2 x model 2) and reduced OLMoE's sharded MoE on (data 2 x
  model 2), each rank on its ``param_specs(fsdp=True)`` blocks, against
  the reference's ``make_train_step(TrainConfig(fsdp=True), mesh)`` on
  fake devices of the same shape (losses, first gradients, Qwen3's
  parameters); each rank's held parameter and moment bytes its FSDP
  blocks', below the unsharded rank's; ``n_micro=2`` under FSDP against
  the unsharded step on the same mesh.
* No rank loads ``jax`` or ``repro``.
"""
import dataclasses
import multiprocessing as mp
import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import _torch_model_mesh_child as child
from repro_torch.convert import params_from_jax
from repro_torch.core.prng import fold_in, prng_key
from repro_torch.distributed.aggregation import AGGREGATORS, WorkerLayout
from repro_torch.distributed.trainer import (make_train_step,
                                             replicate_for_workers,
                                             worker_opt_init)
from repro_torch.models import model as M
from repro_torch.optim.adamw import leaves

pytestmark = pytest.mark.multidevice

REPO = Path(__file__).resolve().parents[1]
WORLD = {"data4": 4, "pod2_data2": 4, "model2": 2, "data2_model2": 4,
         "data2": 2}
LAYOUT = {"data4": WorkerLayout(1, 4), "pod2_data2": WorkerLayout(2, 2)}
TIMEOUT = 300    # seconds for all four meshes
MOE_B, MOE_S = 4, 16

_MOE_REF = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_config, reduced
    from repro.data import SyntheticLMData
    from repro.distributed import trainer as T
    from repro.launch import compat
    from repro.models import layers as L
    from repro.optim import AdamWConfig, adamw_init
    d = dict(np.load(sys.argv[1]))
    cfg = dataclasses.replace(reduced(get_config("olmoe_1b_7b")),
                              moe_impl="sharded")
    mesh = compat.make_mesh((2, 2), ("data", "model"))
    p = {k: jnp.asarray(d[k]) for k in ("router", "w_gate", "w_up",
                                          "w_down")}
    with compat.set_mesh(mesh):
        y, aux = jax.jit(lambda p, x: L.moe_block(p, x, cfg))(
            p, jnp.asarray(d["x"]))
    np.savez(sys.argv[2], y=np.asarray(y), aux=np.asarray(aux))
    # the mean step of reduced OLMoE on (model 2) and (data 2 x model 2):
    # 3 losses, the trained parameters and the first step's gradients
    with open(sys.argv[3], "rb") as f:
        params = jax.tree_util.tree_map(jnp.asarray, pickle.load(f))
    data = SyntheticLMData(cfg.vocab, %(seq)d, %(batch)d, seed=0)
    tc = T.TrainConfig(arch=cfg, opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                                 total_steps=20))
    out = {}
    for name, shape in (("model2", (1, 2)), ("data2_model2", (2, 2))):
        mesh = compat.make_mesh(shape, ("data", "model"),
                                devices=jax.devices()[:shape[0] * shape[1]])
        factory, _ = T.make_train_step(tc, mesh)
        p, o = params, adamw_init(params)
        with compat.set_mesh(mesh):
            _, g0 = jax.jit(lambda p, b: T._grads_microbatched(
                p, cfg, b, 1))(p, data.batch(0))
            step = jax.jit(factory(p))
            losses = []
            for s in range(%(steps)d):
                p, o, loss = step(p, o, data.batch(s))
                losses.append(float(loss))
        out[name] = {"losses": np.array(losses),
                     "params": jax.tree_util.tree_map(np.asarray, p),
                     "grads0": jax.tree_util.tree_map(np.asarray, g0)}
    # the FSDP mean steps: reduced Qwen3 on (data 2) and (data 2 x model
    # 2), reduced OLMoE's sharded MoE on (data 2 x model 2)
    with open(sys.argv[5], "rb") as f:
        qwen = jax.tree_util.tree_map(jnp.asarray, pickle.load(f))
    qcfg = dataclasses.replace(reduced(get_config("qwen3_8b")),
                               n_kv_heads=2)
    for model, mcfg, start, name, shape in (
            ("qwen3", qcfg, qwen, "data2", (2, 1)),
            ("qwen3", qcfg, qwen, "data2_model2", (2, 2)),
            ("olmoe", cfg, params, "data2_model2", (2, 2))):
        mesh = compat.make_mesh(shape, ("data", "model"),
                                devices=jax.devices()[:shape[0] * shape[1]])
        ftc = dataclasses.replace(tc, arch=mcfg, fsdp=True)
        factory, _ = T.make_train_step(ftc, mesh)
        data = SyntheticLMData(mcfg.vocab, %(seq)d, %(batch)d, seed=0)
        p, o = start, adamw_init(start)
        with compat.set_mesh(mesh):
            step = jax.jit(factory(p))
            losses = []
            for s in range(%(steps)d):
                p, o, loss = step(p, o, data.batch(s))
                losses.append(float(loss))
        out[f"fsdp_{model}_{name}"] = {
            "losses": np.array(losses),
            "params": jax.tree_util.tree_map(np.asarray, p)}
    with open(sys.argv[4], "wb") as f:
        pickle.dump(out, f)
""" % {"seq": child.TRAIN_SEQ, "batch": child.TRAIN_B, "steps": child.STEPS})


def _ref_qwen_cfg():
    """The reference's config of ``child.qwen_cfg()``."""
    from repro.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config("qwen3_8b")),
                               n_kv_heads=2)


def _ref_moe_cfg():
    """The reference's config of ``child.moe_cfg()``."""
    from repro.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config("olmoe_1b_7b")),
                               moe_impl="sharded")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _moe_inputs(out: Path) -> None:
    """Reduced OLMoE's MoE parameters and a (4, 16, d) input, float32,
    from a seed: .npz for the reference, .pt for the ranks."""
    cfg = child.moe_cfg()
    rng = np.random.default_rng(9)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    arrays = {"router": 0.02 * rng.normal(size=(d, E)),
              "w_gate": rng.normal(size=(E, d, f)) * d ** -0.5,
              "w_up": rng.normal(size=(E, d, f)) * d ** -0.5,
              "w_down": rng.normal(size=(E, f, d)) * f ** -0.5,
              "x": rng.normal(size=(MOE_B, MOE_S, d))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    np.savez(out / "moe_inputs.npz", **arrays)
    torch.save({k: torch.from_numpy(v) for k, v in arrays.items()},
               out / "moe_inputs.pt")


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """Write the ranks' inputs, launch the four meshes (spawned gloo
    ranks) and the reference subprocess (the MoE block, and reduced
    OLMoE's mean step on 2 and 4 fake devices), wait for them, and load
    every rank's results -> ({case: [rank results]}, reference MoE
    outputs, reference Qwen3 parameters as numpy, the reference OLMoE mean
    steps by case)."""
    import repro.models.model as jm

    out = tmp_path_factory.mktemp("model_meshes")
    jparams = jm.init_params(jax.random.PRNGKey(0), _ref_qwen_cfg())
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    torch.save(params_from_jax(np_params, child.qwen_cfg(), "cpu"),
               out / "qwen_params.pt")
    moe_params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(1), _ref_moe_cfg()))
    torch.save(params_from_jax(moe_params, child.moe_cfg(), "cpu"),
               out / "olmoe_params.pt")
    with open(out / "olmoe_params.pkl", "wb") as f:
        pickle.dump(moe_params, f)
    with open(out / "qwen_params.pkl", "wb") as f:
        pickle.dump(np_params, f)
    _moe_inputs(out)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", _MOE_REF,
                            str(out / "moe_inputs.npz"),
                            str(out / "moe_ref.npz"),
                            str(out / "olmoe_params.pkl"),
                            str(out / "olmoe_mean_ref.pkl"),
                            str(out / "qwen_params.pkl")], env=env,
                           cwd=REPO,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    ctx = mp.get_context("spawn")
    procs = []
    for name, world in WORLD.items():
        port = _free_port()
        procs += [ctx.Process(target=child.main,
                              args=(name, r, world, port, str(out)))
                  for r in range(world)]
    for p in procs:
        p.start()
    _, ref_err = ref.communicate(timeout=TIMEOUT)
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
    assert ref.returncode == 0, ref_err[-2000:]
    ranks = {name: [torch.load(out / f"{name}_{r}.pt") for r in range(world)]
             for name, world in WORLD.items()}
    with open(out / "olmoe_mean_ref.pkl", "rb") as f:
        moe_mean = pickle.load(f)
    return ranks, dict(np.load(out / "moe_ref.npz")), np_params, moe_mean


def test_no_rank_loads_jax_or_repro(meshes):
    for name, ranks in meshes[0].items():
        for r, res in enumerate(ranks):
            assert res["loaded"] == [], (name, r, res["loaded"])
            assert res["rows"]["staged_calls"] == 0   # CPU tensors


@pytest.mark.parametrize("case", sorted(LAYOUT))
@pytest.mark.parametrize("kind", ["pushsum", "pushsum_sparse",
                                  "trimmed_mean", "hierarchical_trim",
                                  "trimmed_mean_sharded",
                                  "trimmed_mean_sharded_bf16"])
def test_rank_aggregators_bit_equal_the_one_card_forms(meshes, case, kind):
    layout = LAYOUT[case]
    W = layout.n_workers
    G = child.agg_buffer(W)
    name = kind.removesuffix("_bf16")
    cfg = child.agg_cfg(name, layout.per_pod)
    if kind.endswith("_bf16"):
        cfg = dataclasses.replace(cfg, comm_dtype="bfloat16")
    want = AGGREGATORS[name](G, cfg, layout, child.AGG_KEY)
    for w, res in enumerate(meshes[0][case]):
        got = res["rows"][f"agg_{kind}"]
        assert got.dtype == torch.float32 and got.shape == (child.AGG_D,)
        assert torch.equal(got, want[w]), (case, kind, w)


@pytest.mark.parametrize("case", sorted(LAYOUT))
def test_rank_mean_within_w_ulps(meshes, case):
    layout = LAYOUT[case]
    W = layout.n_workers
    G = child.agg_buffer(W)
    want = AGGREGATORS["mean"](G, child.AGG_CFG, layout, child.AGG_KEY)[0]
    scale = G.abs().sum(0) / W
    eps = torch.finfo(torch.float32).eps
    for res in meshes[0][case]:
        got = res["rows"]["agg_mean"]
        assert bool(((got - want).abs() <= W * eps * scale).all())
    # every rank holds the same mean
    assert all(torch.equal(r["rows"]["agg_mean"],
                           meshes[0][case][0]["rows"]["agg_mean"])
               for r in meshes[0][case])


def _one_process_robust(case: str, kind: str, byz: tuple):
    layout = LAYOUT[case]
    W = layout.n_workers
    tc = child.robust_tc(kind, byz)
    params = replicate_for_workers(M.init_params(0, tc.arch, "cpu"), W)
    opt = worker_opt_init(params)
    step = make_train_step(tc, layout, backend="torch", record="aggregate")
    data = child.robust_data(tc, W)
    losses, agg0 = [], None
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for s in range(child.STEPS):
            params, opt, loss = step(params, opt, data.batch(s, "cpu"),
                                     fold_in(prng_key(0), s))
            losses.append(loss)
            if s == 0:
                agg0 = step.aggregate.clone()
    finally:
        torch.set_num_threads(prev)
    return params, torch.stack(losses), agg0


@pytest.mark.parametrize("case,kind,byz", [
    (c, k, b) for c, runs in child.ROBUST.items() for k, b in runs])
def test_robust_step_over_ranks_matches_the_one_process_rows(meshes, case,
                                                             kind, byz):
    params, losses, agg0 = _one_process_robust(case, kind, byz)
    for w, res in enumerate(meshes[0][case]):
        rows = res["rows"]
        assert torch.equal(rows[f"robust_{kind}_agg0"], agg0[w]), w
        torch.testing.assert_close(rows[f"robust_{kind}_losses"], losses,
                                   rtol=1e-6, atol=0)
        for got, want in zip(leaves(rows[f"robust_{kind}_params"]),
                             leaves(params)):
            torch.testing.assert_close(got, want[w], rtol=1e-6, atol=1e-7)
    spreads = [r["rows"][f"robust_{kind}_spread"]
               for r in meshes[0][case]]
    assert all(torch.equal(s, spreads[0]) for s in spreads)
    if kind != "pushsum":        # a trim hands every worker one aggregate
        assert float(spreads[0]) == 0.0
    else:
        assert 0.0 < float(spreads[0]) < 0.05


@pytest.fixture(scope="module")
def one_process_serve(meshes):
    cfg = child.qwen_cfg()
    params = params_from_jax(meshes[2], cfg, "cpu")
    return child.serve(params, cfg, child.serve_prompts(cfg)), params


@pytest.mark.parametrize("case", ["model2", "data2_model2"])
def test_model_axis_serves_as_one_process(meshes, one_process_serve, case):
    (logits, toks, cache), params = one_process_serve
    cfg = child.qwen_cfg()
    ranks = meshes[0][case]
    n_data = 2 if case == "data2_model2" else 1
    b = child.SERVE_B // n_data
    Hl = cfg.n_kv_heads // 2
    V_loc = cfg.vocab // 2
    for res in ranks:
        rows = res["rows"]
        d, m = (int(c) for c in res["rows"]["coordinate"])
        sl = slice(d * b, (d + 1) * b)
        assert rows["serve_logits"].shape == (b, 1 + child.SERVE_GEN,
                                              cfg.vocab)
        torch.testing.assert_close(rows["serve_logits"], logits[sl],
                                   rtol=0, atol=1e-4)
        assert torch.equal(rows["serve_tokens"], toks[sl])
        hs = slice(m * Hl, (m + 1) * Hl)
        torch.testing.assert_close(
            rows["cache_k"], cache["layers"][0]["mixer"]["k"][sl, hs],
            rtol=0, atol=1e-5)
        torch.testing.assert_close(
            rows["cache_v"], cache["layers"][-1]["mixer"]["v"][sl, hs],
            rtol=0, atol=1e-5)
        assert torch.equal(rows["local_embed"],
                           params["embed"][m * V_loc:(m + 1) * V_loc])


@pytest.fixture(scope="module")
def reference_mean_losses(meshes):
    """The reference's single-device GSPMD step, 3 steps, on the
    parameters the ranks start from."""
    import jax.numpy as jnp
    from repro.data import SyntheticLMData
    from repro.distributed.trainer import TrainConfig, make_train_step
    from repro.launch import compat
    from repro.optim import AdamWConfig, adamw_init

    cfg = _ref_qwen_cfg()
    params = jax.tree_util.tree_map(jnp.asarray, meshes[2])
    mesh = compat.make_mesh((1, 1), ("data", "model"),
                            devices=jax.devices()[:1])
    tc = TrainConfig(arch=cfg, opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                               total_steps=20))
    factory, _ = make_train_step(tc, mesh)
    data = SyntheticLMData(cfg.vocab, child.TRAIN_SEQ, child.TRAIN_B,
                           seed=0)
    p, o = params, adamw_init(params)
    losses = []
    with compat.set_mesh(mesh):
        step = jax.jit(factory(p))
        for s in range(child.STEPS):
            p, o, loss = step(p, o, data.batch(s))
            losses.append(float(loss))
    return np.array(losses), jax.tree_util.tree_map(np.asarray, p)


@pytest.mark.parametrize("case", ["model2", "data2_model2"])
def test_model_axis_mean_step_matches_the_reference(meshes,
                                                    reference_mean_losses,
                                                    case):
    want, _ = reference_mean_losses
    ranks = meshes[0][case]
    for res in ranks:
        got = res["rows"]["mean_losses"].numpy()
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    # every rank reports the same loss and holds the same gathered model
    first = ranks[0]["rows"]
    for res in ranks[1:]:
        assert torch.equal(res["rows"]["mean_losses"], first["mean_losses"])
        assert all(torch.equal(a, b) for a, b in zip(
            leaves(res["rows"]["mean_params_gathered"]),
            leaves(first["mean_params_gathered"])))


def test_model_axis_mean_step_tracks_the_reference_parameters(
        meshes, reference_mean_losses):
    """After 3 steps the gathered parameters of (data 2 x model 2) against
    the reference's: AdamW's first steps move every weight by about lr, so
    a parameter off by more than lr / 10 would be a wrong update."""
    _, want = reference_mean_losses
    got = meshes[0]["data2_model2"][0]["rows"]["mean_params_gathered"]
    want_t = params_from_jax(want, child.qwen_cfg(), "cpu")
    for a, b in zip(leaves(got), leaves(want_t)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def test_sharded_moe_matches_the_reference(meshes):
    ref = meshes[1]
    ranks = meshes[0]["data2_model2"]
    b = MOE_B // 2
    for res in ranks:
        d = int(res["rows"]["coordinate"][0])
        np.testing.assert_allclose(res["rows"]["moe_y"].numpy(),
                                   ref["y"][d * b:(d + 1) * b],
                                   rtol=0, atol=1e-4)
        assert abs(float(res["rows"]["moe_aux"]) - float(ref["aux"])) \
            <= 1e-6


@pytest.mark.parametrize("case", ["model2", "data2_model2"])
def test_model_axis_moe_mean_step_matches_the_reference(meshes, case):
    """Reduced OLMoE's expert-parallel mean step against the reference's
    ``make_train_step`` on the same (data, model) mesh of fake devices
    (its ``_moe_block_sharded``: capacity from the local tokens, the aux
    averaged over model and the batch): the losses within the reference's
    dp x tp bound, equal on every rank, and every rank holding the same
    gathered model. The trained parameters are not held to the
    reference's: AdamW moves a coordinate whose gradient is rounding noise
    (1e-7 of the leaf's scale) by about lr whichever sign the noise has,
    so they differ by up to 2e-4 where the gradients agree to 3e-6 of the
    scale; the first step's gradients are held instead (below)."""
    ref = meshes[3][case]
    ranks = meshes[0][case]
    for res in ranks:
        np.testing.assert_allclose(res["rows"]["moe_mean_losses"].numpy(),
                                   ref["losses"], rtol=2e-3, atol=2e-3)
    first = ranks[0]["rows"]
    for res in ranks[1:]:
        assert torch.equal(res["rows"]["moe_mean_losses"],
                           first["moe_mean_losses"])
        assert all(torch.equal(a, b) for a, b in zip(
            leaves(res["rows"]["moe_mean_params_gathered"]),
            leaves(first["moe_mean_params_gathered"])))


@pytest.fixture(scope="module")
def reference_qwen_grads0(meshes):
    """The reference's gradients of reduced Qwen3-8B's loss on the first
    batch, one device."""
    import jax.numpy as jnp
    from repro.data import SyntheticLMData
    from repro.distributed.trainer import _grads_microbatched

    cfg = _ref_qwen_cfg()
    params = jax.tree_util.tree_map(jnp.asarray, meshes[2])
    data = SyntheticLMData(cfg.vocab, child.TRAIN_SEQ, child.TRAIN_B,
                           seed=0)
    _, g = jax.jit(lambda p, b: _grads_microbatched(p, cfg, b, 1))(
        params, data.batch(0))
    return jax.tree_util.tree_map(np.asarray, g)


#: the first step's gradients against the reference's, leaf by leaf:
#: within GRAD_RTOL of the leaf's largest reference entry (float32 sums
#: in another order and blocking: up to 2.5e-6 of the scale on these
#: meshes); a gradient scaled by the model extent (an all_reduce in a
#: backward that needs none) is off by the whole scale
GRAD_RTOL = 2e-5


@pytest.mark.parametrize("arch", ["qwen3", "olmoe"])
@pytest.mark.parametrize("case", ["model2", "data2_model2"])
def test_model_axis_first_step_gradients_match_the_reference(
        meshes, reference_qwen_grads0, arch, case):
    """Every rank's first-step gradients (its blocks, averaged over the
    data ranks), gathered over the mesh, against the reference's: Qwen3's
    on one device (the data ranks' mean of equal row blocks is the global
    batch's gradient), OLMoE's on the same mesh of fake devices (the
    expert-parallel backward: the router's gradient summed over model,
    the aux's divided by the extent)."""
    if arch == "qwen3":
        cfg, ref, key = child.qwen_cfg(), reference_qwen_grads0, "mean"
    else:
        cfg, ref, key = child.moe_cfg(), meshes[3][case]["grads0"], \
            "moe_mean"
    want = leaves(params_from_jax(ref, cfg, "cpu"))
    ranks = meshes[0][case]
    for res in ranks:
        got = leaves(res["rows"][f"{key}_grads0_gathered"])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            scale = float(b.abs().max())
            torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                       atol=GRAD_RTOL * scale + 1e-12)


# ---------------------------------------------------------------------------
# the FSDP mean step
# ---------------------------------------------------------------------------

_FSDP_RUNS = [(model, name) for name, models in child.FSDP.items()
              for model in models]


@pytest.mark.parametrize("model,case", _FSDP_RUNS)
def test_fsdp_mean_step_matches_the_reference(meshes, reference_qwen_grads0,
                                              model, case):
    """The FSDP mean step (each rank holding its ``param_specs(fsdp=True)``
    blocks, each layer gathering them over "data" and reduce-scattering
    their gradients) against the reference's ``make_train_step(TrainConfig(
    fsdp=True), mesh)`` on fake devices of the same (data, model) shape:
    3 losses within rtol 2e-3 and equal on every rank, the first step's
    gradients within GRAD_RTOL of each leaf's scale of the reference's
    loss gradients (FSDP lays them out, it does not change them: Qwen3's
    on one device, OLMoE's on the same mesh), every rank holding the same
    gathered model, within 1e-4 of the reference's (Qwen3; for OLMoE's
    experts, the gradients: the note of
    ``test_model_axis_moe_mean_step_matches_the_reference``)."""
    ref = meshes[3][f"fsdp_{model}_{case}"]
    cfg = child.qwen_cfg() if model == "qwen3" else child.moe_cfg()
    grads0 = reference_qwen_grads0 if model == "qwen3" \
        else meshes[3][case]["grads0"]
    ranks = meshes[0][case]
    key = f"fsdp_{model}_"
    first = ranks[0]["rows"]
    for res in ranks:
        rows = res["rows"]
        np.testing.assert_allclose(rows[key + "losses"].numpy(),
                                   ref["losses"], rtol=2e-3, atol=2e-3)
        assert torch.equal(rows[key + "losses"], first[key + "losses"])
        assert all(torch.equal(a, b) for a, b in zip(
            leaves(rows[key + "params_gathered"]),
            leaves(first[key + "params_gathered"])))
    want = leaves(params_from_jax(grads0, cfg, "cpu"))
    got = leaves(first[key + "grads0_gathered"])
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=GRAD_RTOL * scale + 1e-12,
                                   msg=lambda m, i=i: f"gradient leaf {i}: {m}")
    if model == "qwen3":
        want_p = leaves(params_from_jax(ref["params"], cfg, "cpu"))
        for a, b in zip(leaves(first[key + "params_gathered"]), want_p):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("model,case", _FSDP_RUNS)
def test_fsdp_ranks_hold_only_their_blocks(meshes, model, case):
    """Each rank's held parameter and AdamW-moment bytes are its blocks'
    under ``param_specs(fsdp=True)``, less than a rank holds without FSDP;
    printed beside ``train_memory_gb(fsdp=True)``'s parameters and
    optimizer terms (bf16 parameters and float32 moments of the whole
    model over the mesh: the model's count, not this float32 run's)."""
    from repro_torch.analysis.memory_model import train_memory_gb
    from repro_torch.configs.base import InputShape
    cfg = child.qwen_cfg() if model == "qwen3" else child.moe_cfg()
    shape = dict(zip(child.MESHES[case][1], child.MESHES[case][0]))
    est = train_memory_gb(cfg, InputShape("train", child.TRAIN_SEQ,
                                          child.TRAIN_B, "train"),
                          shape, True, 1)
    key = f"fsdp_{model}_"
    for res in meshes[0][case]:
        rows = res["rows"]
        assert rows[key + "held"] == rows[key + "blocks"]
        assert rows[key + "held"] < rows[key + "blocks_unsharded"]
        print(f"{model} on {case}: a rank holds {rows[key + 'held']} B of "
              f"parameters and moments under FSDP, "
              f"{rows[key + 'blocks_unsharded']} B without; the memory "
              f"model's params + optimizer "
              f"{est['params_gb'] + est['optimizer_gb']} GB")


def test_fsdp_mean_step_gathers_each_micro_batch(meshes):
    """``n_micro=2`` on (data 2): the FSDP step gathers its blocks for
    each micro-batch and accumulates the reduce-scattered gradients; its
    3 losses and first gradients (gathered) are the unsharded step's on
    the same mesh, within float32 sums in another order."""
    for res in meshes[0]["data2"]:
        rows = res["rows"]
        torch.testing.assert_close(rows["micro_True_losses"],
                                   rows["micro_False_losses"], rtol=1e-6,
                                   atol=0)
        for a, b in zip(leaves(rows["micro_True_grads0_gathered"]),
                        leaves(rows["micro_False_grads0_gathered"])):
            scale = float(b.abs().max())
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=GRAD_RTOL * scale + 1e-12)
        assert rows["micro_True_held"] < rows["micro_False_held"]
