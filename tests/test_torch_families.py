"""The port's other model families against the JAX package on the CPU:
the MoE decoders (OLMoE-1B-7B, Qwen3-MoE-235B), the RG-LRU hybrid
(RecurrentGemma-2B), the encoder-decoder (Whisper-small) and the VLM
backbone (InternVL2-26B), at ``reduced`` size.

``repro.models.model.init_params`` draws the parameters and
``repro_torch.convert.params_from_jax`` carries them across. Their
layers (``moe_block`` with its routes, drops and aux; ``_rglru_scan``,
``rglru_block`` and ``rglru_decode``; ``cross_attention_block``;
``encode``; ``embed_inputs`` with patches) and each family's forward,
prefill and decode steps are held against ``repro.models``.

Tolerances: float32 on both sides, another summation order (XLA's CPU dot
against oneDNN/MKL) compounded over 2-3 layers on logits of size ~1-3:
atol = rtol = 1e-4; caches (K/V rows, the RG-LRU state and conv history,
the encoder output) 1e-5. Routes, the dropped set and the capacity are
held to equality. Where the reference mixes a float32 activation with
bf16 weights (Whisper's encoder, the patch projection), the dtypes are
held to the reference's and the values to its float32 limits.
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.swa.ref import attn_decode_ref as jax_attn_decode_ref
from repro.kernels.swa.swa import attn_decode_pallas
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.kernels.swa import attn_decode_ref
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

CPU = torch.device("cpu")
TOL = 1e-4
CACHE_TOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]

FAMILIES = ["olmoe_1b_7b", "qwen3_moe_235b_a22b", "recurrentgemma_2b",
            "whisper_small", "internvl2_26b"]
# name -> (arch, replace kwargs)
CONFIGS = {
    **{a: (a, {}) for a in FAMILIES},
    # 8 layers of (rglru, rglru, swa): two stacked repeats and a tail of
    # two RG-LRU layers, the layout of the full 26
    "recurrentgemma_scan8": ("recurrentgemma_2b",
                             {"n_layers": 8, "scan_layers": True}),
    # a window shorter than the prompts: the decode ring wraps
    "recurrentgemma_window8": ("recurrentgemma_2b", {"window": 8}),
    "olmoe_scan4": ("olmoe_1b_7b", {"n_layers": 4, "scan_layers": True}),
}
PUBLISHED = {   # arch -> the published parameter range of param_count()
    "olmoe_1b_7b": (6.5e9, 7.2e9),
    "qwen3_moe_235b_a22b": (2.2e11, 2.4e11),
    "recurrentgemma_2b": (2.5e9, 3.0e9),
    "whisper_small": (2.0e8, 2.6e8),
    "internvl2_26b": (1.9e10, 2.1e10),
}


def _configs(arch, extra):
    j = dataclasses.replace(jax_reduced(jax_get_config(arch)), **extra)
    t = dataclasses.replace(reduced(get_config(arch)), **extra)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


_MODELS = {}


def _model(name):
    """(jax cfg, torch cfg, jax params, port params), once a worker."""
    if name not in _MODELS:
        jcfg, tcfg = _configs(*CONFIGS[name])
        jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
        _MODELS[name] = (jcfg, tcfg, jp, tp)
    return _MODELS[name]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _np(t):
    return t.detach().float().numpy()


def _stubs(cfg, B, seed=1):
    """The reference CLI's stub inputs as numpy float32: Whisper's frames,
    the VLM's patch embeddings."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "audio":
        out["frames"] = rng.normal(size=(B, cfg.n_frames, cfg.d_model)
                                   ).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(size=(B, cfg.n_patches, TM.D_VIS)
                                         ).astype(np.float32)
    return out


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_config_equals_the_reference(arch):
    cfg, ref = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.param_count() == ref.param_count()
    lo, hi = PUBLISHED[arch]
    assert lo < cfg.param_count() < hi
    assert dataclasses.asdict(reduced(cfg)) == dataclasses.asdict(
        jax_reduced(ref))


@pytest.mark.parametrize("name", ["olmoe_scan4", "recurrentgemma_scan8",
                                  "whisper_small", "internvl2_26b"])
def test_init_params_has_the_reference_layout(name):
    jcfg, tcfg, jp, _ = _model(name)
    tp = TM.init_params(0, tcfg, CPU)
    meta = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)[6:]), tp,
                        is_leaf=torch.is_tensor) == meta


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "recurrentgemma_2b",
                                  "whisper_small", "internvl2_26b"])
def test_params_from_jax_keeps_each_leaf_dtype(arch):
    """bf16 weights with the reference's float32 leaves (MoE's router,
    RG-LRU's lam) carried across in their dtypes."""
    jcfg, tcfg = _configs(arch, {"dtype": "bfloat16"})
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    meta = jax.tree.map(lambda a: str(a.dtype), jp)
    assert jax.tree.map(lambda a: str(a.dtype)[6:], tp,
                        is_leaf=torch.is_tensor) == meta
    flat = [(jax.tree_util.keystr(k), v) for k, v in
            jax.tree_util.tree_flatten_with_path(meta)[0]]
    f32 = {k for k, v in flat if v == "float32"}
    want = {"moe": "['router']", "hybrid": "['lam']"}.get(jcfg.family)
    assert all(want in k for k in f32) if want else not f32
    assert f32 or not want


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _reference_kept(ids, E, cap):
    """The reference's kept set: the (T k, E) one-hot cumsum rank < cap."""
    flat = ids.reshape(-1)
    onehot = jax.nn.one_hot(flat, E, dtype=jnp.int32)
    ranks = (jnp.cumsum(onehot, axis=0) - onehot).sum(
        axis=1, where=onehot.astype(bool))
    return np.asarray(ranks < cap)


def _moe_case(extra, zero_router=False, S=12):
    jcfg, tcfg = _configs("olmoe_1b_7b", extra)
    jp = JL.init_moe(jax.random.PRNGKey(3), jcfg)
    if zero_router:
        jp["router"] = jnp.zeros_like(jp["router"])
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    x = np.random.default_rng(4).normal(size=(2, S, tcfg.d_model)
                                        ).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


@pytest.mark.parametrize("case", ["reduced", "drops", "tied_router",
                                  "decode_cap"])
def test_moe_block_matches_reference(case):
    """Output and aux within 1e-4; routes (ties to the lower expert id),
    the capacity and the dropped set equal. ``reduced`` is drop-free;
    ``drops`` (capacity factor 0.5) and ``decode_cap`` (one token a
    request, cap 1) drop assignments; ``tied_router`` (zero router
    weights, capacity factor 1) ties every expert, so every token picks
    experts 0 and 1 and half the assignments drop."""
    extra = {"drops": {"capacity_factor": 0.5},
             "tied_router": {"capacity_factor": 1.0},
             "decode_cap": {"capacity_factor": 0.5}}.get(case, {})
    jcfg, tcfg, jp, tp, x = _moe_case(extra, case == "tied_router",
                                      S=1 if case == "decode_cap" else 12)
    want, want_aux = JL._moe_block_gspmd(jp, jnp.asarray(x), jcfg)
    got, aux = TL.moe_block(tp, torch.from_numpy(x), tcfg)
    _close(_np(got), want)
    _close(float(aux), float(want_aux))

    T, k, E = x.shape[0] * x.shape[1], tcfg.top_k, tcfg.n_experts
    xt = x.reshape(T, -1)
    probs = jax.nn.softmax(jnp.asarray(xt) @ jp["router"], axis=-1)
    _, ref_ids = jax.lax.top_k(probs, k)
    _, _, ids = TL.moe_route(tp, torch.from_numpy(xt), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    cap = TL.moe_capacity(T, tcfg)
    assert cap == max(1, int(math.ceil(T * k / E * jcfg.capacity_factor)))
    slot, kept = TL.moe_slots(ids, E, cap)
    np.testing.assert_array_equal(kept.numpy(),
                                  _reference_kept(ref_ids, E, cap))
    dropped = int((~kept).sum())
    if case == "tied_router":
        assert (ids.numpy() == np.arange(k)).all()
    if case in ("drops", "decode_cap", "tied_router"):
        assert dropped > 0
    else:
        assert dropped == 0
    assert sorted(slot[kept].tolist()) == sorted(set(slot[kept].tolist()))


def test_moe_block_bf16_rounds_where_the_reference_rounds():
    jcfg, tcfg = _configs("olmoe_1b_7b", {"dtype": "bfloat16",
                                          "capacity_factor": 0.75})
    jp = JL.init_moe(jax.random.PRNGKey(5), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    x = np.random.default_rng(6).normal(size=(2, 16, tcfg.d_model))
    want, want_aux = JL._moe_block_gspmd(jp, jnp.asarray(x, jnp.bfloat16),
                                         jcfg)
    got, aux = TL.moe_block(tp, torch.from_numpy(x).to(torch.bfloat16),
                            tcfg)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    want = np.asarray(want.astype(jnp.float32))
    # one bf16 rounding of each expert product and of the combine
    _close(_np(got), want, 2 ** -6)
    _close(float(aux), float(want_aux), 1e-5)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 13, 16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_reference(S, with_h0):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, size=(2, S, 8)).astype(np.float32)
    b = rng.normal(size=(2, S, 8)).astype(np.float32)
    h0 = rng.normal(size=(2, 8)).astype(np.float32) if with_h0 else None
    want = JL._rglru_scan(jnp.asarray(a), jnp.asarray(b),
                          None if h0 is None else jnp.asarray(h0))
    got = TL._rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                         None if h0 is None else torch.from_numpy(h0))
    _close(got.numpy(), want, CACHE_TOL)


def test_rglru_block_and_decode_match_reference():
    jcfg, tcfg = _configs("recurrentgemma_2b", {})
    jp = JL.init_rglru(jax.random.PRNGKey(7), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    x = np.random.default_rng(8).normal(size=(2, 9, tcfg.d_model)
                                        ).astype(np.float32)
    _close(_np(TL.rglru_block(tp, torch.from_numpy(x), tcfg)),
           JL.rglru_block(jp, jnp.asarray(x), jcfg))
    jc = JL.init_rglru_cache(jcfg, 2)
    tc = TL.init_rglru_cache(tcfg, 2)
    for t in range(4):
        xt = x[:, t:t + 1]
        want, jc = JL.rglru_decode(jp, jnp.asarray(xt), jcfg, jc)
        got, tc2 = TL.rglru_decode(tp, torch.from_numpy(xt), tcfg, tc)
        assert tc2 is tc
        _close(_np(got), want)
        for leaf in ("h", "conv"):
            _close(_np(tc[leaf]), jc[leaf], CACHE_TOL)
    # four decode steps from the zero state are the block's first rows
    _close(_np(got)[:, 0], np.asarray(
        JL.rglru_block(jp, jnp.asarray(x[:, :4]), jcfg))[:, 3])


# ---------------------------------------------------------------------------
# cross-attention, the encoder, the patch projection
# ---------------------------------------------------------------------------

def test_cross_attention_block_matches_reference():
    jcfg, tcfg = _configs("whisper_small", {})
    jp = JL.init_cross_attention(jax.random.PRNGKey(9), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 5, tcfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, 7, tcfg.d_model)).astype(np.float32)
    _close(_np(TL.cross_attention_block(tp, torch.from_numpy(x),
                                        torch.from_numpy(enc), tcfg)),
           JL.cross_attention_block(jp, jnp.asarray(x), jnp.asarray(enc),
                                    jcfg))


def test_encode_with_float32_frames_of_bf16_weights():
    """bf16 weights, float32 frames: the reference promotes the whole
    encoder to float32 (``enc`` float32); the decoder's cross-attention
    takes bf16 queries against float32 K/V and returns bf16."""
    jcfg, tcfg = _configs("whisper_small", {"dtype": "bfloat16"})
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    frames = _stubs(jcfg, 2)["frames"]
    want = JM.encode(jp, jnp.asarray(frames), jcfg)
    got = TM.encode(tp, torch.from_numpy(frames), tcfg)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _close(_np(got), want)
    blk = jp["layers"][0]
    x = np.random.default_rng(11).normal(size=(2, 3, tcfg.d_model))
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    want_x = JL.cross_attention_block(blk["xattn"], jx, want, jcfg)
    got_x = TL.cross_attention_block(tp["layers"][0]["xattn"], tx, got, tcfg)
    assert want_x.dtype == jnp.bfloat16 and got_x.dtype == torch.bfloat16
    _close(_np(got_x), np.asarray(want_x.astype(jnp.float32)), 2 ** -6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_inputs_prepends_projected_patches(dtype):
    jcfg, tcfg = _configs("internvl2_26b", {"dtype": dtype})
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    toks = _tokens(jcfg, 2, 5)
    patches = _stubs(jcfg, 2)["patch_embeds"]
    want = JM.embed_inputs(jp, jcfg, jnp.asarray(toks), jnp.asarray(patches))
    got = TM.embed_inputs(tp, tcfg, torch.from_numpy(toks),
                          torch.from_numpy(patches))
    assert got.shape == (2, jcfg.n_patches + 5, tcfg.d_model)
    assert str(got.dtype)[6:] == str(want.dtype)
    tol = TOL if dtype == "float32" else 2 ** -7
    _close(_np(got), np.asarray(want.astype(jnp.float32)), tol)


def test_decode_attention_at_ten_heads_per_kv_head_of_256():
    """RecurrentGemma's decode attention (10 query heads on 1 KV head of
    256): the plain version against the reference's and its TPU kernel
    (interpret mode), and at a group of 16."""
    rng = np.random.default_rng(12)
    for H in (10, 16):
        q = rng.normal(size=(2, H, 256)).astype(np.float32)
        k = (2 * rng.normal(size=(2, 1, 64, 256))).astype(np.float32)
        v = rng.normal(size=(2, 1, 64, 256)).astype(np.float32)
        L = np.asarray([64, 23], np.int32)
        got = attn_decode_ref(*(torch.from_numpy(a) for a in (q, k, v, L)))
        _close(got.numpy(), jax_attn_decode_ref(q, k, v, L), 1e-5)
        _close(got.numpy(), attn_decode_pallas(q, k, v, L, block_w=32,
                                               interpret=True), 1e-5)


def test_rglru_decode_writes_the_state_in_place():
    _, tcfg, _, tp = _model("recurrentgemma_scan8")
    toks = torch.from_numpy(_tokens(tcfg, 2, 6)).long()
    _, cache = TM.prefill(tp, tcfg, toks, cache_len=9)
    mixer = cache["groups"][0]["mixer"]
    ptrs = mixer["h"].data_ptr(), mixer["conv"].data_ptr()
    before = mixer["h"].clone()
    _, cache2 = TM.decode_step(tp, tcfg, cache, toks[:, :1])
    assert cache2 is cache
    assert ptrs == (mixer["h"].data_ptr(), mixer["conv"].data_ptr())
    assert mixer["h"].shape == (2, 2, tcfg.rnn_width)
    assert mixer["h"].dtype == torch.float32
    assert not torch.equal(mixer["h"], before)


def test_short_prompt_keeps_a_zero_conv_history():
    """A prompt shorter than the conv's width: the reference's cache would
    take fewer rows; the port keeps zeros before the prompt, which is what
    the conv saw, and decodes as the full forward."""
    _, tcfg, _, tp = _model("recurrentgemma_2b")
    toks = torch.from_numpy(_tokens(tcfg, 2, 4, seed=3)).long()
    full = TM.forward_train(tp, tcfg, toks)
    lg, cache = TM.prefill(tp, tcfg, toks[:, :2], cache_len=8)
    conv = cache["layers"][0]["mixer"]["conv"]
    assert bool((conv[:, 0] == 0).all())
    for i in range(2):
        lg, cache = TM.decode_step(tp, tcfg, cache, toks[:, 2 + i:3 + i])
        _close(_np(lg[:, 0]), _np(full[:, 2 + i]))


# ---------------------------------------------------------------------------
# training: the hybrid's loss; the other families raise
# ---------------------------------------------------------------------------

def test_hybrid_loss_matches_reference():
    jcfg, tcfg, jp, tp = _model("recurrentgemma_2b")
    toks, labels = _tokens(jcfg, 2, 12), _tokens(jcfg, 2, 12, seed=1)
    want = JM.loss_fn(jp, jcfg, jnp.asarray(toks), jnp.asarray(labels))
    got = TM.loss_fn(tp, tcfg, torch.from_numpy(toks),
                     torch.from_numpy(labels))
    _close(float(got), float(want))


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "whisper_small",
                                  "internvl2_26b"])
def test_untrained_families_raise(arch):
    from repro_torch.launch import train
    cfg = reduced(get_config(arch))
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="9d-2"):
        TM.loss_fn({}, cfg, toks, toks)
    args = train.parse_args(["--arch", arch, "--reduced", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="9d-2"):
        train.build(args)


# ---------------------------------------------------------------------------
# the serve entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["whisper_small", "internvl2_26b"])
def test_generate_takes_the_stub_inputs(arch):
    """``generate`` with frames or patches: greedy tokens equal the
    reference's serve loop on the same parameters, the cache sized as the
    reference's CLI sizes it."""
    from repro_torch.launch.serve import generate
    jcfg, tcfg, jp, tp = _model(arch)
    B, S, gen = 2, 6, 4
    toks, stubs = _tokens(jcfg, B, S, seed=2), _stubs(jcfg, B)
    got, seen = generate(tp, tcfg, torch.from_numpy(toks), gen,
                         backend="torch", **_t(stubs))
    n_patch = jcfg.n_patches if jcfg.family == "vlm" else 0
    jl, jc = JM.prefill(jp, jcfg, jnp.asarray(toks),
                        cache_len=S + gen + 1 + n_patch,
                        **{k: jnp.asarray(v) for k, v in stubs.items()})
    tok = jl[:, -1].argmax(-1)[:, None].astype(jnp.int32)
    want = [tok]
    for _ in range(gen - 1):
        jl, jc = JM.decode_step(jp, jcfg, jc, tok)
        tok = jl[:, -1].argmax(-1)[:, None].astype(jnp.int32)
        want.append(tok)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.concatenate(want, 1)))
    assert seen.shape == (B, gen, tcfg.vocab)


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "whisper_small"])
def test_serve_robust_example_runs_on_the_cpu(arch):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "serve_robust_torch.py"),
         "--arch", arch, "--device", "cpu", "--gen", "4"],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    assert f"family={get_config(arch).family}" in out.stdout
    assert out.stdout.rstrip().endswith("serve_robust OK")
