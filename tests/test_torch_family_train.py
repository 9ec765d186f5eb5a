"""Training of the MoE, audio and VLM families (OLMoE-1B-7B, Whisper-small,
InternVL2-26B) in the port against the JAX package on the CPU, at
``reduced`` size: ``loss_fn`` and its gradients (the MoE aux, Whisper's
frames, the VLM's patch slice, full and streamed cross-entropy),
``moe_block`` under autograd with capacity drops, remat, the robust and
mean train steps with the stub inputs in the batch, and the train CLI.

``repro.models.model.init_params`` draws the parameters and
``repro_torch.convert.params_from_jax`` carries them across.

Tolerances (``tests/test_torch_train.py``'s): float32 on both sides in
another summation order, the loss within 1e-5 relative and each gradient
leaf within 1e-4 of its largest entry; train steps' losses 1e-5,
parameters atol 5e-5 + rtol 1e-4. Two cases round to bf16 on the way:

- bf16 stubs on float32 weights: Whisper's first encoder norm rounds its
  output to bf16, and a float32 ulp of difference in the norm flips a
  rounding, so the gradients are held to 2^-8 of each leaf's largest
  entry (one bf16 rounding);
- bf16 storage: every activation is rounded to bf16 in each layer of
  the forward and the backward, so the two orders' roundings part by a
  few bf16 ulps over two layers: the loss within 2^-8 relative, each
  gradient leaf within 2^-5 (8 bf16 ulps) of its largest entry, and each
  gradient in the reference's dtype.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data import SyntheticLMData as JaxData
from repro.distributed import aggregation as JA
from repro.distributed import trainer as JT
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import adamw as JO
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.core.prng import fold_in, prng_key
from repro_torch.distributed import aggregation as TA
from repro_torch.distributed import trainer as TT
from repro_torch.launch import train as TRAIN
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TO
from test_torch_train import (_close_grads, _close_trees, _host,
                              _jax_robust_steps)

CPU = torch.device("cpu")
BF16_ROUND = 2 ** -8
BF16_STORAGE = 2 ** -5
OPT = dict(lr=1e-4, warmup_steps=1, total_steps=3)
# the reference's loss and gradients, compiled once a config (the eager
# form compiles every op on first use: 9-15 s a family)
_JAX_LOSS_GRAD = jax.jit(jax.value_and_grad(JM.loss_fn), static_argnums=1)
_PARAMS = {}


def _jax_params(jcfg):
    """The reference's parameters of ``jcfg`` (seed 0), drawn once for the
    configs that differ only in what the draws do not read."""
    key = dataclasses.replace(jcfg, ce_chunk=0, remat=False,
                              capacity_factor=1.0)
    if key not in _PARAMS:
        _PARAMS[key] = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return _PARAMS[key]


def _configs(arch, **extra):
    j = dataclasses.replace(jax_reduced(jax_get_config(arch)), **extra)
    t = dataclasses.replace(reduced(get_config(arch)), **extra)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _stubs(cfg, B, dtype="float32", seed=1):
    """The stub inputs of ``cfg``'s family as numpy float32 and as the two
    packages' arrays in ``dtype``: (numpy, jax, torch) dicts."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "audio":
        out["frames"] = rng.normal(size=(B, cfg.n_frames, cfg.d_model))
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(size=(B, cfg.n_patches, TM.D_VIS))
    out = {k: v.astype(np.float32) for k, v in out.items()}
    jst = {k: jnp.asarray(v, jnp.dtype(dtype)) for k, v in out.items()}
    tst = {k: torch.from_numpy(v).to(getattr(torch, dtype))
           for k, v in out.items()}
    return out, jst, tst


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
                 for _ in range(2))


def _loss_and_grads(jcfg, tcfg, jst, tst, toks, labs):
    """(port loss, port grads tree, reference loss, reference grads)."""
    jp = _jax_params(jcfg)
    tp = params_from_jax(_host(jp), tcfg, CPU)
    jl, jg = _JAX_LOSS_GRAD(jp, jcfg, toks, labs, **jst)
    for p in jax.tree_util.tree_leaves(tp):
        p.requires_grad_()
    tl = TM.loss_fn(tp, tcfg, torch.from_numpy(toks),
                    torch.from_numpy(labs), **tst)
    tl.backward()
    return (float(tl.detach()), jax.tree.map(lambda p: p.grad, tp),
            float(jl), jg)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

# each family with ce_chunk 0 and 8, the stubs in float32 and bf16
LOSS_CASES = [("olmoe_1b_7b", 0, "float32"), ("olmoe_1b_7b", 8, "float32"),
              ("whisper_small", 0, "float32"),
              ("whisper_small", 8, "bfloat16"),
              ("internvl2_26b", 0, "bfloat16"),
              ("internvl2_26b", 8, "float32")]


@pytest.mark.parametrize("arch,chunk,stub_dtype", LOSS_CASES)
def test_loss_and_grads_match(arch, stub_dtype, chunk):
    """Full and streamed cross-entropy plus the MoE aux (20 text positions:
    a ragged last chunk at 8; a VLM's 16 patch rows before them), value
    and every gradient, against jax.value_and_grad of the reference's
    loss_fn with the same stubs."""
    jcfg, tcfg = _configs(arch, ce_chunk=chunk)
    _, jst, tst = _stubs(jcfg, 2, stub_dtype)
    toks, labs = _tokens(jcfg, 2, 20, seed=2)
    tl, tg, jl, jg = _loss_and_grads(jcfg, tcfg, jst, tst, toks, labs)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    bf16_first_norm = stub_dtype == "bfloat16" and arch == "whisper_small"
    _close_grads(tg, jg, rtol=BF16_ROUND if bf16_first_norm else 1e-4)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "whisper_small",
                                  "internvl2_26b"])
def test_bf16_storage_grads_come_back_in_the_reference_dtypes(arch):
    """bf16 weights with float32 stubs: Whisper's encoder promotes its bf16
    weights to float32, the VLM multiplies float32 patches by bf16 ``w1``;
    each cotangent comes back to a gradient in its leaf's dtype (bf16,
    the MoE router float32), as the reference's, within the bf16 storage
    limits."""
    jcfg, tcfg = _configs(arch, dtype="bfloat16")
    _, jst, tst = _stubs(jcfg, 2)
    toks, labs = _tokens(jcfg, 2, 20, seed=3)
    tl, tg, jl, jg = _loss_and_grads(jcfg, tcfg, jst, tst, toks, labs)
    np.testing.assert_allclose(tl, jl, rtol=BF16_ROUND)
    got, want = jax.tree_util.tree_leaves(tg), jax.tree_util.tree_leaves(jg)
    assert [str(g.dtype)[6:] for g in got] == [str(w.dtype) for w in want]
    assert any(g.dtype == torch.bfloat16 for g in got)
    _close_grads(tg, jg, rtol=BF16_STORAGE)


def test_vlm_without_patches_trains_text_only():
    """No ``patch_embeds``: nothing is sliced, and ``vis_proj`` gets no
    gradient (the reference's is zero)."""
    jcfg, tcfg = _configs("internvl2_26b")
    toks, labs = _tokens(jcfg, 2, 12, seed=4)
    tl, tg, jl, jg = _loss_and_grads(jcfg, tcfg, {}, {}, toks, labs)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tg["vis_proj"]["w1"] is None
    assert not np.asarray(jg["vis_proj"]["w1"]).any()


def test_audio_without_frames_raises():
    """The reference fails in ``encode`` with an AttributeError; the port
    raises ValueError naming the missing frames, from ``loss_fn`` and from
    the train CLI, whose batches hold tokens and labels only."""
    jcfg, tcfg = _configs("whisper_small")
    tp = params_from_jax(_host(_jax_params(jcfg)),
                         tcfg, CPU)
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="frames"):
        TM.loss_fn(tp, tcfg, toks, toks)
    with pytest.raises(ValueError, match="frames"):
        TRAIN.main(["--arch", "whisper_small", "--reduced", "--steps", "1",
                    "--seq-len", "8", "--global-batch", "2", "--device",
                    "cpu"])


# ---------------------------------------------------------------------------
# the MoE under autograd: capacity drops, the aux, remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["drops", "tied_router"])
def test_moe_block_gradients_reach_only_kept_slots(case):
    """The vjp of ``moe_block`` (y with a random cotangent, and the aux)
    against the reference's ``_moe_block_gspmd`` where capacity drops
    occur: capacity factor 0.5, or a zero router at factor 1 (every token
    ties on experts 0 and 1, half the assignments drop). Every gradient
    (x, router, the three expert weights) within 1e-4 of its largest
    entry: a dropped (token, choice) pair sends nothing back to x or its
    gate, and the aux alone carries the router's gradient through the
    mean router probabilities."""
    zero = case == "tied_router"
    jcfg, tcfg = _configs("olmoe_1b_7b",
                          capacity_factor=1.0 if zero else 0.5)
    jp = JL.init_moe(jax.random.PRNGKey(3), jcfg)
    if zero:
        jp["router"] = jnp.zeros_like(jp["router"])
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 12, tcfg.d_model)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    for aux_only in (False, True):
        def jf(p, xx):
            y, aux = JL._moe_block_gspmd(p, xx, jcfg)
            return aux if aux_only else jnp.sum(y * dy) + 0.5 * aux

        jgp, jgx = jax.jit(jax.grad(jf, argnums=(0, 1)))(jp,
                                                        jnp.asarray(x))
        tp = params_from_jax(_host(jp), tcfg, CPU)
        for p in tp.values():
            p.requires_grad_()
        tx = torch.from_numpy(x).requires_grad_()
        y, aux = TL.moe_block(tp, tx, tcfg)
        (aux if aux_only else (y * torch.from_numpy(dy)).sum()
         + 0.5 * aux).backward()
        grads = {k: p.grad for k, p in tp.items()}
        if aux_only:      # the aux reaches the router and x, no expert
            assert all(grads[k] is None for k in ("w_gate", "w_up",
                                                  "w_down"))
            assert grads["router"].abs().max() > 0
            _close_grads({"router": grads["router"], "x": tx.grad},
                         {"router": jgp["router"], "x": jgx})
            continue
        _close_grads(grads, jgp)
        _close_grads({"x": tx.grad}, {"x": jgx})
    _, _, ids = TL.moe_route(tp, torch.from_numpy(x).reshape(24, -1),
                             tcfg.top_k)
    _, kept = TL.moe_slots(ids, tcfg.n_experts,
                           TL.moe_capacity(24, tcfg))
    assert not bool(kept.all())


@pytest.mark.parametrize("remat", [True, False])
def test_moe_capacity_drops_with_and_without_remat(remat, monkeypatch):
    """OLMoE in the stacked (R, ...) layout at capacity factor 1.0, where
    the routes drop assignments: loss and gradients against the
    reference's with the same ``remat``; the recompute under
    ``torch.utils.checkpoint`` takes the same routes, so remat on and off
    give the same gradients bit for bit."""
    jcfg, tcfg = _configs("olmoe_1b_7b", capacity_factor=1.0,
                          scan_layers=True, remat=remat)
    dropped = []
    slots = TL.moe_slots

    def counting(ids, E, cap):
        slot, kept = slots(ids, E, cap)
        dropped.append(int((~kept).sum()))
        return slot, kept

    monkeypatch.setattr(TL, "moe_slots", counting)
    toks, labs = _tokens(jcfg, 2, 16, seed=6)
    tl, tg, jl, jg = _loss_and_grads(jcfg, tcfg, {}, {}, toks, labs)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _close_grads(tg, jg)
    # two layers, and a second pass of both under remat
    assert len(dropped) == (4 if remat else 2) and min(dropped) > 0
    _, tg_off, _, _ = _loss_and_grads(
        jcfg, dataclasses.replace(tcfg, remat=not remat), {}, {}, toks, labs)
    for a, b in zip(jax.tree_util.tree_leaves(tg),
                    jax.tree_util.tree_leaves(tg_off)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# train steps with the stubs in the batch
# ---------------------------------------------------------------------------

def _batches(jcfg, B, S, n, stub_dtype):
    """``n`` global batches of the reference's markov stream with the
    family's stubs added (seeded per step) -> (jax batches, port batches).
    """
    data = JaxData(jcfg.vocab, S, B, flavour="markov", seed=0)
    jb, tb = [], []
    for s in range(n):
        _, jst, tst = _stubs(jcfg, B, stub_dtype, seed=10 + s)
        batch = data.batch(s)
        jb.append({**batch, **jst})
        tb.append({**{k: torch.from_numpy(np.array(v)).long()
                      for k, v in batch.items()}, **tst})
    return jb, tb


@pytest.mark.parametrize("arch,n_micro,stub_dtype", [
    ("internvl2_26b", 2, "bfloat16"),
    ("whisper_small", 1, "float32"),
    ("olmoe_1b_7b", 2, "float32")])
def test_robust_step_with_stubs_matches_the_reference(arch, n_micro,
                                                      stub_dtype):
    """Two robust trimmed-mean steps, W = 4, F = 1, worker 1 Byzantine,
    each worker's rows of the tokens and of the stubs (the micro-batch
    split interleaves both): losses, parameters and the AdamW step count
    against the reference's per-worker step; the copies stay equal.
    (Whisper's bf16 frames are held at the loss: their first-norm rounding
    flips, within 2^-8 of a gradient, move the sign of a few near-zero
    coordinates, which AdamW turns into a step of lr.)"""
    W = 4
    jcfg, tcfg = _configs(arch)
    kw = dict(kind="trimmed_mean", F=1)
    jtc = JT.TrainConfig(arch=jcfg, agg=JA.AggregatorConfig(**kw),
                         opt=JO.AdamWConfig(**OPT), n_micro=n_micro,
                         byzantine_workers=(1,))
    ttc = TT.TrainConfig(arch=tcfg, agg=TA.AggregatorConfig(**kw),
                         opt=TO.AdamWConfig(**OPT), n_micro=n_micro,
                         byzantine_workers=(1,))
    jp = _jax_params(jcfg)
    jb, tb = _batches(jcfg, 8, 12, 2, stub_dtype)
    keys = [jax.random.fold_in(jax.random.PRNGKey(0), s) for s in range(2)]
    jpw, jow, jlosses = _jax_robust_steps(jtc, jp, jb, keys, W)

    jpw0 = JT.replicate_for_workers(jp, W)
    pw, ow = train_state_from_jax(_host(jpw0),
                                  _host(JT.worker_opt_init(jpw0)), tcfg, CPU)
    step = TT.make_train_step(ttc, (1, W))
    losses = []
    for s, batch in enumerate(tb):
        pw, ow, loss = step(pw, ow, batch, fold_in(prng_key(0), s))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _close_trees(pw, jpw, atol=5e-5, rtol=1e-4)
    np.testing.assert_array_equal(ow["step"].numpy(),
                                  np.asarray(jow["step"]))
    assert float(TT.param_spread(pw)) == 0.0


def test_mean_step_with_stubs_matches_the_reference():
    """The one-copy baseline with InternVL2's bf16 patches in the batch:
    two steps with n_micro = 2 against the reference's
    ``_grads_microbatched`` and AdamW."""
    jcfg, tcfg = _configs("internvl2_26b")
    jp = _jax_params(jcfg)
    tp = params_from_jax(_host(jp), tcfg, CPU)
    jo, to = JO.adamw_init(jp), TO.adamw_init(tp)
    step = TT.make_train_step(TT.TrainConfig(
        arch=tcfg, opt=TO.AdamWConfig(**OPT), n_micro=2))
    jb, tb = _batches(jcfg, 4, 12, 2, "bfloat16")
    for s in range(2):
        loss, grads = jax.jit(JT._grads_microbatched, static_argnums=(1, 3))(
            jp, jcfg, jb[s], 2)
        jp, jo = JO.adamw_update(JO.AdamWConfig(**OPT), grads, jo, jp)
        tp, to, tl = step(tp, to, tb[s])
        np.testing.assert_allclose(float(tl), float(loss), rtol=1e-5)
    _close_trees(tp, jp, atol=5e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "internvl2_26b"])
def test_train_cli_trains_the_families_on_the_cpu(arch, capsys):
    """``launch/train`` at reduced size: OLMoE with the aux, InternVL2
    text-only (the CLI's batches hold tokens and labels, as the
    reference's); four robust steps of 4 workers, one Byzantine, with a
    finite loss and the copies in consensus."""
    TRAIN.main(["--arch", arch, "--reduced", "--steps", "4", "--seq-len",
                "16", "--global-batch", "8", "--agg", "trimmed_mean",
                "--workers", "4", "--byzantine", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "done"
    steps = [ln.split() for ln in lines[:-1]]
    assert [int(s[1]) for s in steps] == [0, 1, 2, 3]
    assert all(np.isfinite(float(s[3])) for s in steps)
    assert all(s[4] == "consensus_spread" and s[5] == "0.000e+00"
               for s in steps)
