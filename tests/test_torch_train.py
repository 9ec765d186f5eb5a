"""The port's training stack against the JAX package's on the CPU: data,
AdamW, checkpoints, the loss and its gradients, the aggregators, the
autograd wrappers of the mixer kernels, the train steps and the CLI.

Each side starts from the same weights: the JAX package initializes them
and ``repro_torch.convert`` carries them across.

Tolerances: tokens and checkpoints are exact. AdamW, the loss and the
aggregators compute in float32 in another order (oneDNN against XLA's CPU
dots and reductions): 1e-5 relative on the loss, 1e-4 on aggregates of
size ~1, and 1e-4 of each gradient leaf's largest entry (an entry may
pass through zero, its rounding is the sum's). A train step
divides the first moment by the square root of the second, so a
coordinate whose gradient is within its rounding error of zero can move
by up to lr / 2 on one side and not the other: parameters are held to
atol 5e-5 + rtol 1e-4 after three steps at lr 1e-4 (losses to 1e-5).
A bf16 gradient is the float32 one rounded once: 2^-8 relative.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

from repro.checkpoint import ckpt as JC
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data import SyntheticLMData as JaxData
from repro.distributed import aggregation as JA
from repro.distributed import trainer as JT
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import adamw as JO
from repro_torch.checkpoint import ckpt as TC
from repro_torch.configs import get_config, reduced
from repro_torch.convert import (params_from_jax, train_state_from_jax,
                                 tree_to_numpy)
from repro_torch.core.prng import fold_in, prng_key
from repro_torch.data import SyntheticLMData
from repro_torch.distributed import aggregation as TA
from repro_torch.distributed import trainer as TT
from repro_torch.kernels.swa import SwaPrefillFn, swa_prefill_ref
from repro_torch.kernels.wkv6 import Wkv6Fn, wkv6_chunked_ref
from repro_torch.launch import train as TRAIN
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _np(tree):
    """A JAX tree as numpy, bfloat16 leaves as float32 (for comparing)."""
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


def _host(tree):
    """A JAX tree as numpy in its own dtypes (for converting)."""
    return jax.tree.map(np.asarray, tree)


def _close_trees(got, want, atol, rtol):
    """Port tree (tensors) against a JAX tree, leaf by leaf, in float32."""
    g = jax.tree_util.tree_leaves(tree_to_numpy(got))
    w = jax.tree_util.tree_leaves(_np(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.astype(np.float32),
                                   b.astype(np.float32), atol=atol, rtol=rtol)


def _close_grads(got, want, rtol=1e-4):
    """Gradient trees: each leaf within rtol of its own largest entry (the
    float32 rounding of a sum is relative to the sum's terms, not to the
    entry, which may pass through zero)."""
    g = jax.tree_util.tree_leaves(tree_to_numpy(got))
    w = jax.tree_util.tree_leaves(_np(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=rtol * float(np.abs(b).max()))


def _configs(arch, **extra):
    j = dataclasses.replace(jax_reduced(jax_get_config(arch)), **extra)
    t = dataclasses.replace(reduced(get_config(arch)), **extra)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flavour", ["iid", "markov"])
def test_synthetic_tokens_are_the_reference_tokens(flavour):
    kw = dict(vocab=97, seq_len=20, global_batch=6, flavour=flavour,
              n_agents=4, seed=3)
    jd, td = JaxData(**kw), SyntheticLMData(**kw)
    for step in (0, 5):
        jb, tb = jd.batch(step), td.batch(step, CPU)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
        for agent in (0, 3, 9):
            jb = jd.shard_batch(step, agent, 3)
            tb = td.shard_batch(step, agent, 3, CPU)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(tb[k].numpy(),
                                              np.asarray(jb[k]))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_cosine_lr_matches():
    cfg = JO.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=50)
    tcfg = TO.AdamWConfig(**dataclasses.asdict(cfg))
    steps = np.arange(0, 60, dtype=np.int32)
    np.testing.assert_allclose(
        TO.cosine_lr(tcfg, torch.from_numpy(steps)).numpy(),
        np.asarray(JO.cosine_lr(cfg, jnp.asarray(steps))), rtol=1e-6)


def _opt_tree(rng, dtype):
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "scale": rng.normal(size=(5,)).astype(np.float32),
            "blocks": [{"k": rng.normal(size=(3, 4, 2)).astype(np.float32)}]}


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches(param_dtype, moment_dtype):
    """Three updates of a tree with 1-D, 2-D and 3-D leaves: decay only on
    leaves of 2 or more dims, the clip (a large gradient on step 2), bf16
    params and both moment dtypes."""
    rng = np.random.default_rng(0)
    cfg = JO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                         moment_dtype=moment_dtype)
    tcfg = TO.AdamWConfig(**dataclasses.asdict(cfg))
    jdt = jnp.bfloat16 if param_dtype == "bfloat16" else jnp.float32
    p0 = _opt_tree(rng, param_dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p0)
    tp = params_from_jax(_host(jp), get_config("paper_sim"), CPU)
    js = JO.adamw_init(jp, moment_dtype)
    ts = TO.adamw_init(tp, moment_dtype)
    for i in range(3):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) *
                                    (30.0 if i == 1 else 0.1)
                                    ).astype(np.float32), p0)
        jg = jax.tree.map(lambda a: jnp.asarray(a, jdt), g)
        tg = params_from_jax(_host(jg), get_config("paper_sim"), CPU)
        jp, js = JO.adamw_update(cfg, jg, js, jp)
        tp, ts = TO.adamw_update(tcfg, tg, ts, tp)
    tol = 2 ** -8 if param_dtype == "bfloat16" else 1e-6
    _close_trees(tp, jp, atol=tol, rtol=tol)
    mtol = 2 ** -7 if moment_dtype == "bfloat16" else 1e-6
    _close_trees(ts["m"], js["m"], atol=mtol, rtol=mtol)
    _close_trees(ts["v"], js["v"], atol=mtol, rtol=mtol)
    assert int(ts["step"]) == int(js["step"]) == 3
    assert ts["m"]["w"].dtype == TO._DTYPES[moment_dtype]


def test_stacked_adamw_is_the_per_worker_update():
    """n_lead=1: per-worker clip norms and step counters, no decay on a
    stacked (W, d) norm scale, against jax.vmap of the reference."""
    rng = np.random.default_rng(1)
    W = 3
    cfg = JO.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    tcfg = TO.AdamWConfig(**dataclasses.asdict(cfg))
    p = {"w": rng.normal(size=(W, 6, 5)).astype(np.float32),
         "scale": rng.normal(size=(W, 5)).astype(np.float32)}
    g = {"w": rng.normal(size=(W, 6, 5)).astype(np.float32),
         "scale": rng.normal(size=(W, 5)).astype(np.float32)}
    g["w"][1] *= 40.0                      # only worker 1 clips
    js = JT.worker_opt_init(p)
    js["step"] = jnp.asarray([0, 3, 1], jnp.int32)
    jp, js = jax.vmap(lambda gg, ss, pp: JO.adamw_update(cfg, gg, ss, pp))(
        g, js, p)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    ts = TT.worker_opt_init(tp)
    ts["step"] = torch.tensor([0, 3, 1], dtype=torch.int32)
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    TO.adamw_update(tcfg, tg, ts, tp, n_lead=1)
    _close_trees(tp, jp, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(ts["step"].numpy(), np.asarray(js["step"]))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoints_restore_across_the_packages(tmp_path):
    jcfg, tcfg = _configs("paper_sim", dtype="bfloat16")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(_host(jp), tcfg, CPU)
    for leaf in jax.tree_util.tree_leaves(tp):
        leaf.mul_(2)                        # a state the reference lacks
    TC.save_checkpoint(str(tmp_path / "t"), 7, tp)
    JC.save_checkpoint(str(tmp_path / "j"), 5, jp)
    assert TC.latest_step(str(tmp_path / "t")) == 7
    assert JC.latest_step(str(tmp_path / "t")) == 7
    mt = json.loads((tmp_path / "t" / "step_00000007" /
                     "manifest.json").read_text())
    mj = json.loads((tmp_path / "j" / "step_00000005" /
                     "manifest.json").read_text())
    assert mt["keys"] == mj["keys"] and mt["shapes"] == mj["shapes"]
    assert mt["dtypes"] == mj["dtypes"]
    from_port = JC.restore_checkpoint(str(tmp_path / "t"), 7, jp)
    _close_trees(tp, from_port, atol=0, rtol=0)
    from_jax = TC.restore_checkpoint(str(tmp_path / "j"), 5, tp)
    _close_trees(from_jax, jp, atol=0, rtol=0)
    assert from_jax["embed"].dtype == torch.bfloat16
    bad = dict(tp, embed=tp["embed"][:3])
    with pytest.raises(ValueError, match="shape mismatch"):
        TC.restore_checkpoint(str(tmp_path / "j"), 5, bad)
    assert not any(p.name.endswith(".tmp") for p in (tmp_path / "t").iterdir())


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["paper_sim", "qwen3_8b"])
@pytest.mark.parametrize("chunk", [0, 8])
def test_loss_and_grads_match(arch, chunk):
    """Full and streamed cross-entropy (20 positions: a ragged last chunk
    at 8), value and every gradient, against jax.value_and_grad."""
    jcfg, tcfg = _configs(arch, ce_chunk=chunk)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(_host(jp), tcfg, CPU)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab, size=(2, 20)).astype(np.int32)
    labs = rng.integers(0, jcfg.vocab, size=(2, 20)).astype(np.int32)
    jl, jg = jax.value_and_grad(JM.loss_fn)(jp, jcfg, toks, labs)
    for p in jax.tree_util.tree_leaves(tp):
        p.requires_grad_()
    tl = TM.loss_fn(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(labs))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _close_grads(jax.tree.map(lambda p: p.grad, tp), jg)


def test_remat_recomputes_the_same_gradients():
    """cfg.remat runs each block under torch.utils.checkpoint: the same
    loss and gradients as without, and the reference's with remat."""
    jcfg, tcfg = _configs("paper_sim", remat=True)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, size=(2, 12)).astype(np.int32)
    jl, jg = jax.value_and_grad(JM.loss_fn)(jp, jcfg, toks, toks)
    grads = {}
    for remat in (True, False):
        tp = params_from_jax(_host(jp), tcfg, CPU)
        for p in jax.tree_util.tree_leaves(tp):
            p.requires_grad_()
        cfg = dataclasses.replace(tcfg, remat=remat)
        t = torch.from_numpy(toks)
        loss = TM.loss_fn(tp, cfg, t, t)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jl),
                                   rtol=1e-5)
        grads[remat] = jax.tree.map(lambda p: p.grad, tp)
    for a, b in zip(jax.tree_util.tree_leaves(grads[True]),
                    jax.tree_util.tree_leaves(grads[False])):
        assert torch.equal(a, b)
    _close_grads(grads[True], jg)


# ---------------------------------------------------------------------------
# the mixer kernels' autograd wrappers, the plain forward in the kernel's slot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_prefill_fn_gradients_are_plain_autograd(window, dtype):
    g = torch.Generator().manual_seed(0)
    B, S, H, Hkv, dh = 2, 13, 4, 2, 16
    q, k, v = (torch.randn((B, S, h, dh), generator=g).to(dtype)
               for h in (H, Hkv, Hkv))
    up = torch.randn((B, S, H, dh), generator=g).to(dtype)
    got, want = [], []
    for fn, store in ((lambda *a: SwaPrefillFn.apply(*a, swa_prefill_ref),
                       got), (swa_prefill_ref, want)):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ins, window, None)
        (out.float() * up.float()).sum().backward()
        store.extend([out.detach()] + [t.grad for t in ins])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # a frozen input gets no gradient and costs no backward of its own
    q2 = q.clone().requires_grad_()
    SwaPrefillFn.apply(q2, k, v, window, None, swa_prefill_ref).sum().backward()
    assert q2.grad is not None


@pytest.mark.parametrize("four_d", [False, True])
def test_wkv6_fn_gradients_are_plain_autograd(four_d):
    """The wrapper's backward is the chunk-64 plain scan's VJP through y
    and the final state, for the flat and the model's (B, H, T, K) view
    layouts (u a broadcast)."""
    g = torch.Generator().manual_seed(1)
    B, H, T, K = 2, 3, 70, 64
    r, k, v = (torch.randn((B * H, T, K), generator=g) * 0.5
               for _ in range(3))
    lw = -torch.exp(torch.randn((B * H, T, K), generator=g) - 1.0)
    u = torch.randn((H, K), generator=g) * 0.3
    gy = torch.randn((B * H, T, K), generator=g)
    gs = torch.randn((B * H, K, K), generator=g)

    def fwd(*a):
        return wkv6_chunked_ref(*a, chunk=64)

    def plain(*a):
        if a[0].dim() == 4:
            y, s = wkv6_chunked_ref(*(t.reshape((-1,) + t.shape[2:])
                                      for t in a), chunk=64)
            return y.reshape(B, H, T, K), s.reshape(B, H, K, K)
        return fwd(*a)

    res = {}
    for name, fn in (("fn", lambda *a: Wkv6Fn.apply(*a, plain)),
                     ("plain", plain)):
        ins = [t.clone().requires_grad_() for t in (r, k, v, lw)]
        uu = u.clone().requires_grad_()
        if four_d:
            args = [t.view(B, H, T, K) for t in ins] + [uu.expand(B, H, K)]
        else:
            args = ins + [uu.repeat(B, 1)]
        y, s = fn(*args)
        ((y.reshape(B * H, T, K) * gy).sum()
         + (s.reshape(B * H, K, K) * gs).sum()).backward()
        res[name] = [y.detach(), s.detach()] + [t.grad for t in ins] \
            + [uu.grad]
    for a, b in zip(res["fn"], res["plain"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_raw_launchers_refuse_a_graph():
    """On the CPU the raw launchers raise for want of CUDA tensors; the
    grad guard is the card's (tests/test_torch_kernels_cuda.py)."""
    from repro_torch.kernels.swa import swa_prefill_cuda
    from repro_torch.kernels.wkv6 import wkv6_cuda
    x = torch.zeros((1, 4, 2, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        swa_prefill_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wkv6_cuda(x[0], x[0], x[0], x[0], x[0, 0])


# ---------------------------------------------------------------------------
# aggregators, against AGGREGATORS[kind] under a one-axis jax.vmap
# ---------------------------------------------------------------------------

AGG_CASES = [
    ("mean", {}),
    ("trimmed_mean", {"F": 1}),
    ("trimmed_mean", {"F": 2}),
    ("trimmed_mean_sharded", {"F": 2}),
    ("trimmed_mean_sharded", {"F": 1, "comm_dtype": "bfloat16"}),
    ("hierarchical_trim", {"F": 2}),
    ("pushsum", {"gossip_rounds": 9, "drop_prob": 0.4, "B": 3}),
    ("pushsum_sparse", {"gossip_rounds": 7, "drop_prob": 0.3,
                        "graph_seed": 4}),
]


@pytest.mark.parametrize("kind,kw", AGG_CASES)
def test_aggregator_matches_the_reference(kind, kw):
    W, D = 7, 50
    rng = np.random.default_rng(6)
    G = rng.normal(size=(W, D)).astype(np.float32)
    G[3] *= 1e3                               # a Byzantine-sized row
    jcfg = JA.AggregatorConfig(kind=kind, **kw)
    tcfg = TA.AggregatorConfig(kind=kind, **kw)
    key = jax.random.fold_in(jax.random.PRNGKey(11), 2)
    fn = JA.AGGREGATORS[kind]
    want = np.asarray(jax.vmap(
        lambda g: fn({"g": g}, jcfg, "data", None, key)["g"],
        axis_name="data")(jnp.asarray(G)))
    got = TA.AGGREGATORS[kind](torch.from_numpy(G), tcfg,
                               TA.WorkerLayout(1, W),
                               fold_in(prng_key(11), 2))
    assert got.shape == (W, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    if kind.startswith("pushsum"):           # the drops did bite
        assert np.ptp(want, axis=0).max() > 1e-3


def test_ring_pushsum_with_pods_fuses_every_gamma():
    """Two pods of three: the rings run per pod and the pods' first
    workers fuse every Γ rounds; the pooled mass stays W."""
    W, D = 6, 8
    G = np.random.default_rng(7).normal(size=(W, D)).astype(np.float32)
    cfg = TA.AggregatorConfig(kind="pushsum", gossip_rounds=40,
                              gamma_period=4, drop_prob=0.2)
    est = TA.agg_pushsum(torch.from_numpy(G), cfg, TA.WorkerLayout(2, 3),
                         prng_key(0))
    err = (est - torch.from_numpy(G).mean(0)).abs().max().item()
    few = TA.agg_pushsum(torch.from_numpy(G), dataclasses.replace(
        cfg, gossip_rounds=4), TA.WorkerLayout(2, 3), prng_key(0))
    err_few = (few - torch.from_numpy(G).mean(0)).abs().max().item()
    assert err < 0.5 * err_few


@pytest.mark.parametrize("pods,per_pod", [(2, 3), (3, 4), (2, 4)])
def test_ring_pushsum_with_pods_matches_the_reference(pods, per_pod):
    """The port's ring push-sum over pods (rings per pod, the pods' first
    workers fused every Γ rounds) against the reference's ``agg_pushsum``
    under a nested ``jax.vmap`` over (``pod``, ``data``): worker w is data
    index w % per_pod of pod w // per_pod in both."""
    W, D = pods * per_pod, 20
    G = np.random.default_rng(pods * 10 + per_pod).normal(
        size=(W, D)).astype(np.float32)
    kw = dict(gossip_rounds=14, gamma_period=4, drop_prob=0.25)
    jcfg = JA.AggregatorConfig(kind="pushsum", **kw)
    tcfg = TA.AggregatorConfig(kind="pushsum", **kw)
    key = jax.random.fold_in(jax.random.PRNGKey(13), pods)
    want = np.asarray(jax.vmap(jax.vmap(
        lambda g: JA.agg_pushsum({"g": g}, jcfg, "data", "pod", key)["g"],
        axis_name="data"), axis_name="pod")(
            jnp.asarray(G.reshape(pods, per_pod, D)))).reshape(W, D)
    got = TA.agg_pushsum(torch.from_numpy(G), tcfg,
                         TA.WorkerLayout(pods, per_pod),
                         fold_in(prng_key(13), pods))
    assert got.shape == (W, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # the estimates still disagree (drops bit), and the pods were fused:
    # the same rounds without pods give another result
    assert np.ptp(want, axis=0).max() > 1e-3
    alone = TA.agg_pushsum(torch.from_numpy(G), tcfg,
                           TA.WorkerLayout(1, W), fold_in(prng_key(13), pods))
    assert (alone - got).abs().max().item() > 1e-3


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _jax_robust_steps(tc, params, batches, keys, W):
    """The reference's per-worker step (trainer.py's ``per_worker``) under
    a one-axis ``jax.vmap(axis_name="data")``."""
    agg_fn = JA.AGGREGATORS[tc.agg.kind]

    def per_worker(p, o, batch, step_key):
        loss, grads = JT._grads_microbatched(p, tc.arch, batch, tc.n_micro)
        widx = jax.lax.axis_index("data")
        is_byz = jnp.zeros((), bool)
        for b in tc.byzantine_workers:
            is_byz = is_byz | (widx == b)
        grads = jax.tree.map(
            lambda g: jnp.where(is_byz, -tc.byzantine_scale * g, g), grads)
        agg = agg_fn(grads, tc.agg, "data", None, step_key)
        p, o = JO.adamw_update(tc.opt, agg, o, p)
        return p, o, jax.lax.pmean(loss, "data")

    step = jax.jit(jax.vmap(per_worker, in_axes=(0, 0, 0, None),
                            axis_name="data"))
    pw = JT.replicate_for_workers(params, W)
    ow = JT.worker_opt_init(pw)
    losses = []
    for batch, key in zip(batches, keys):
        local = jax.tree.map(lambda x: x.reshape((W, -1) + x.shape[1:]),
                             batch)
        pw, ow, loss = step(pw, ow, local, key)
        losses.append(float(loss[0]))
    return pw, ow, losses


@pytest.mark.parametrize("kind,n_micro", [("trimmed_mean", 1),
                                          ("trimmed_mean", 2),
                                          ("pushsum_sparse", 1)])
def test_robust_steps_match_the_reference(kind, n_micro):
    """Three robust steps of reduced paper_sim (float32), W = 4, F = 1,
    worker 1 Byzantine, from converted weights: losses, parameters and the
    AdamW state against the reference's per-worker step."""
    W = 4
    jcfg, tcfg = _configs("paper_sim")
    kw = dict(kind=kind, F=1, gossip_rounds=6, drop_prob=0.3)
    opt = dict(lr=1e-4, warmup_steps=1, total_steps=3)
    jtc = JT.TrainConfig(arch=jcfg, agg=JA.AggregatorConfig(**kw),
                         opt=JO.AdamWConfig(**opt), n_micro=n_micro,
                         byzantine_workers=(1,))
    ttc = TT.TrainConfig(arch=tcfg, agg=TA.AggregatorConfig(**kw),
                         opt=TO.AdamWConfig(**opt), n_micro=n_micro,
                         byzantine_workers=(1,))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    data = JaxData(jcfg.vocab, 16, 8, flavour="markov", seed=0)
    batches = [data.batch(s) for s in range(3)]
    keys = [jax.random.fold_in(jax.random.PRNGKey(0), s) for s in range(3)]
    jpw, jow, jlosses = _jax_robust_steps(jtc, jp, batches, keys, W)

    pw, ow = train_state_from_jax(
        _host(JT.replicate_for_workers(jp, W)),
        _host(JT.worker_opt_init(JT.replicate_for_workers(jp, W))), tcfg, CPU)
    step = TT.make_train_step(ttc, (1, W))
    losses = []
    for s, batch in enumerate(batches):
        tb = {k: torch.from_numpy(np.array(v)).long()
              for k, v in batch.items()}
        pw, ow, loss = step(pw, ow, tb, fold_in(prng_key(0), s))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _close_trees(pw, jpw, atol=5e-5, rtol=1e-4)
    np.testing.assert_array_equal(ow["step"].numpy(),
                                  np.asarray(jow["step"]))
    spread = float(TT.param_spread(pw))
    assert spread == float(JT.param_spread(jpw)) or kind == "pushsum_sparse"
    if kind == "trimmed_mean":
        assert spread == 0.0


def test_mean_step_matches_the_reference():
    """The one-copy baseline (the reference's GSPMD step without a mesh):
    two steps with n_micro = 2."""
    jcfg, tcfg = _configs("qwen3_8b")
    opt = dict(lr=1e-4, warmup_steps=1, total_steps=3)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(_host(jp), tcfg, CPU)
    jo = JO.adamw_init(jp)
    to = TO.adamw_init(tp)
    step = TT.make_train_step(TT.TrainConfig(
        arch=tcfg, opt=TO.AdamWConfig(**opt), n_micro=2))
    data = JaxData(jcfg.vocab, 16, 4, seed=0)
    for s in range(2):
        batch = data.batch(s)
        loss, grads = JT._grads_microbatched(jp, jcfg, batch, 2)
        jp, jo = JO.adamw_update(JO.AdamWConfig(**opt), grads, jo, jp)
        tb = {k: torch.from_numpy(np.array(v)).long()
              for k, v in batch.items()}
        tp, to, tl = step(tp, to, tb)
        np.testing.assert_allclose(float(tl), float(loss), rtol=1e-5)
    _close_trees(tp, jp, atol=5e-5, rtol=1e-4)


def test_adamw_updates_a_large_leaf_in_slices_bit_for_bit(monkeypatch):
    """A leaf past ``_CHUNK`` elements is updated a block of rows at a
    time (its float32 temporaries a block's): every operation is
    elementwise, so three steps give the whole-leaf update's parameters
    and moments bit for bit, bf16 and float32 leaves, with weight decay
    and without, one copy and stacked worker copies (``n_lead=1``, a
    gradient shared by the workers through a stride-0 ``expand``, a
    leaf of one scalar a worker)."""
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(300, 37, generator=g).to(torch.bfloat16),
              "b": torch.randn(999, generator=g)}
    grads = {"w": torch.randn(300, 37, generator=g).to(torch.bfloat16),
             "b": torch.randn(999, generator=g)}
    cfg = TO.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    W = 3
    stacked = {"w": params["w"][None].repeat(W, 1, 1),
               "b": params["b"][None].repeat(W, 1),
               "s": torch.randn(W, generator=g)}
    sgrads = {"w": grads["w"][None].expand(W, -1, -1),
              "b": torch.randn(W, 999, generator=g),
              "s": torch.randn(W, generator=g)}
    runs = []
    for chunk in (TO._CHUNK, 256):
        monkeypatch.setattr(TO, "_CHUNK", chunk)
        p = {k: v.clone() for k, v in params.items()}
        st = TO.adamw_init(p)
        pw = {k: v.clone() for k, v in stacked.items()}
        sw = TO.adamw_init(pw, n_workers=W)
        for _ in range(3):
            TO.adamw_update(cfg, grads, st, p)
            TO.adamw_update(cfg, sgrads, sw, pw, n_lead=1)
        runs.append(TO.leaves(p) + TO.leaves(st) + TO.leaves(pw)
                    + TO.leaves(sw))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_fsdp_and_missing_layout_raise():
    """A robust step without a worker layout raises. ``fsdp=True`` no
    longer does: the one-process mean step, whose one data rank splits
    nothing, is the ``fsdp=False`` step bit for bit (two steps: losses,
    gradients, parameters and moments equal)."""
    tcfg = reduced(get_config("paper_sim"))
    runs = []
    for fsdp in (False, True):
        params = TM.init_params(0, tcfg, CPU)
        opt = TO.adamw_init(params)
        step = TT.make_train_step(TT.TrainConfig(arch=tcfg, fsdp=fsdp),
                                  backend="torch", record=True)
        data = SyntheticLMData(tcfg.vocab, 16, 4, seed=0)
        losses, grads = [], []
        for s in range(2):
            params, opt, loss = step(params, opt, data.batch(s, CPU))
            losses.append(loss)
            grads += step.grads
        runs.append((losses, grads, TO.leaves(params), TO.leaves(opt)))
    for a, b in zip(*runs):
        assert len(a) == len(b)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="layout"):
        TT.make_train_step(TT.TrainConfig(
            arch=tcfg, agg=TA.AggregatorConfig(kind="trimmed_mean")))


def test_two_pod_hierarchical_trim_matches_the_reference_trainer(tmp_path):
    """hierarchical_trim over 2 pods x 3 workers (F = 1 within pods, a
    mean across the two pods) with worker 4 Byzantine: two steps of the
    reference's real make_train_step on a (pod, data, model) = (2, 3, 1)
    mesh of fake devices, against the port's step on WorkerLayout(2, 3)."""
    out = tmp_path / "ref.npz"
    prog = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=6"
        import jax, numpy as np
        from repro.launch import compat
        from repro.configs import get_config, reduced
        from repro.data import SyntheticLMData
        from repro.distributed.aggregation import AggregatorConfig
        from repro.distributed.trainer import (TrainConfig, make_train_step,
            replicate_for_workers, worker_opt_init)
        from repro.optim import AdamWConfig
        import repro.models.model as M
        mesh = compat.make_mesh((2, 3, 1), ("pod", "data", "model"))
        cfg = reduced(get_config("paper_sim"))
        params = M.init_params(jax.random.PRNGKey(0), cfg)
        data = SyntheticLMData(cfg.vocab, 16, 6, flavour="markov", seed=0)
        tc = TrainConfig(arch=cfg,
            agg=AggregatorConfig(kind="hierarchical_trim", F=1),
            opt=AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=2),
            byzantine_workers=(4,))
        factory, _ = make_train_step(tc, mesh)
        pw = replicate_for_workers(params, 6)
        ow = worker_opt_init(pw)
        losses = []
        with compat.set_mesh(mesh):
            step = jax.jit(factory(pw))
            for s in range(2):
                pw, ow, loss = step(pw, ow, data.batch(s),
                                    jax.random.fold_in(jax.random.PRNGKey(0), s))
                losses.append(float(loss))
        flat = {{"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(pw)[0]}}
        np.savez({str(out)!r}, losses=np.asarray(losses), **flat)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    for _ in range(2):   # the CPU collective rendezvous may stall once
        run = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                             text=True, timeout=300, env=env, cwd=REPO)
        if run.returncode == 0 or "rendezvous" not in run.stderr.lower():
            break
    assert run.returncode == 0, run.stderr[-3000:]
    ref = np.load(out)

    jcfg, tcfg = _configs("paper_sim")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    pw, ow = train_state_from_jax(
        _host(JT.replicate_for_workers(jp, 6)),
        _host(JT.worker_opt_init(JT.replicate_for_workers(jp, 6))), tcfg, CPU)
    ttc = TT.TrainConfig(
        arch=tcfg, agg=TA.AggregatorConfig(kind="hierarchical_trim", F=1),
        opt=TO.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=2),
        byzantine_workers=(4,))
    step = TT.make_train_step(ttc, (2, 3))
    data = SyntheticLMData(tcfg.vocab, 16, 6, flavour="markov", seed=0)
    losses = []
    for s in range(2):
        pw, ow, loss = step(pw, ow, data.batch(s, CPU),
                            fold_in(prng_key(0), s))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    flat = dict(TC._flatten(pw))
    assert sorted(flat) == sorted(k for k in ref.files if k != "losses")
    for k, v in flat.items():
        np.testing.assert_allclose(v, ref[k], atol=5e-5, rtol=1e-4)
    for leaf in jax.tree_util.tree_leaves(pw):      # one aggregate for all
        assert all(torch.equal(leaf[0], leaf[w]) for w in range(1, 6))


def test_train_cli_on_the_cpu(capsys, tmp_path):
    TRAIN.main(["--arch", "paper_sim", "--reduced", "--steps", "4",
                "--seq-len", "32", "--global-batch", "8", "--agg",
                "trimmed_mean", "--workers", "4", "--byzantine", "1",
                "--device", "cpu", "--ckpt-dir", str(tmp_path),
                "--ckpt-every", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "done"
    steps = [ln.split() for ln in lines[:-1]]
    assert [int(s[1]) for s in steps] == [0, 1, 2, 3]
    assert all(np.isfinite(float(s[3])) for s in steps)
    assert all(s[4] == "consensus_spread" and s[5] == "0.000e+00"
               for s in steps)
    assert TC.latest_step(str(tmp_path)) == 4


def test_train_cli_mean_mode_and_defaults(capsys):
    TRAIN.main(["--reduced", "--steps", "2", "--seq-len", "16",
                "--global-batch", "4", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "done" and lines[0].startswith("step     0 loss ")
    assert "consensus_spread" not in lines[0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TRAIN.main(["--reduced", "--steps", "1"])
