"""The port's model stack (``repro_torch.models``: the dense decoders and
RWKV6) against the JAX package's (``repro.models``) on the CPU.

The JAX package initializes the parameters; ``repro_torch.convert.
params_from_jax`` carries them across, so both compute the same model.
Configs: reduced Qwen3-8B (``"layers"`` layout), the same with 4 layers and
``scan_layers=True`` (the stacked ``"groups"`` layout Qwen3-8B uses at full
depth), reduced paper_sim, a sliding-window (``("swa",)``, window 8)
variant, reduced RWKV6-1.6B in both layouts (``"layers"``, and 4 layers
stacked as at full depth), and the other dense archs the port runs
(parallel block, layernorm, gelu, tied embeddings).

Tolerances: both sides compute in float32; the matmuls and softmax sums
add in another order (XLA's CPU dot against oneDNN/MKL), a few ulp per
op, compounded over 2-4 layers, on logits of size ~1-3: atol 1e-4,
rtol 1e-4. The K/V cache rows are one projection + norm + RoPE away from
the embedding: atol 1e-5, rtol 1e-5. The RWKV6 caches (the WKV state, a
sum over the prompt of k v products, and the token-shift rows, normed
activations after one or more layers) get the logits' limits. Inside the
port, prefill + decode against the full forward is the same float32 math
in another order: the same limits. One test runs both packages in bf16
and states its own limits.
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
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

CPU = torch.device("cpu")
ATOL = RTOL = 1e-4
CACHE_TOL = 1e-5

# name -> (arch, replace kwargs)
CONFIGS = {
    "qwen3_8b": ("qwen3_8b", {}),
    "qwen3_8b_scan4": ("qwen3_8b", {"n_layers": 4, "scan_layers": True}),
    "paper_sim": ("paper_sim", {}),
    "qwen3_8b_swa8": ("qwen3_8b", {"block_pattern": ("swa",), "window": 8}),
    "rwkv6_1b6": ("rwkv6_1b6", {}),
    "rwkv6_1b6_scan4": ("rwkv6_1b6", {"n_layers": 4, "scan_layers": True}),
}
OTHER_DENSE = ["llama3_405b", "command_r_35b", "minitron_4b"]


def _configs(arch, extra):
    j = dataclasses.replace(jax_reduced(jax_get_config(arch)), **extra)
    t = dataclasses.replace(reduced(get_config(arch)), **extra)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


_PARAMS = {}


def _model(name):
    """(jax cfg, torch cfg, jax params, port params), built once per
    config and worker."""
    if name not in _PARAMS:
        arch, extra = CONFIGS.get(name, (name, {}))
        jcfg, tcfg = _configs(arch, extra)
        jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
        _PARAMS[name] = (jcfg, tcfg, jp, tp)
    return _PARAMS[name]


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _close_cache(tc, jc):
    """One layer's cache (or a stacked group's): K/V rows and ``pos`` to
    CACHE_TOL, the RWKV6 state and token-shift rows to ATOL."""
    assert sorted(tc) == sorted(jc)
    for name in tc:
        if isinstance(tc[name], dict):
            _close_cache(tc[name], jc[name])
            continue
        tol = CACHE_TOL if name in ("k", "v", "pos") else ATOL
        assert tc[name].shape == jc[name].shape, name
        _close(tc[name].float().numpy(), jc[name], tol)


def _mixer_caches(cache):
    """Every layer's cache dict of a cache tree (either layout): the mixer's
    and, for RWKV6, the channel mix's ``cm_prev``."""
    if "groups" in cache:
        return list(cache["groups"]) + list(cache["tail"])
    return list(cache["layers"])


def test_norms_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32) * 3
    scale = rng.normal(size=(16,)).astype(np.float32) * 0.1
    bias = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(2, 5)).astype(np.int32)
    tx, ts, tb = (torch.from_numpy(a) for a in (x, scale, bias))
    _close(TL.rms_norm(tx, ts).numpy(), JL.rms_norm(x, scale), 1e-6)
    _close(TL.layer_norm(tx, ts, tb).numpy(), JL.layer_norm(x, scale, bias),
           1e-5)
    for theta in (1e4, 1e6):
        _close(TL.rope_freqs(16, theta).numpy(), JL.rope_freqs(16, theta),
               1e-7)
        _close(TL.apply_rope(tx, torch.from_numpy(pos), theta).numpy(),
               JL.apply_rope(x, pos, theta), 1e-5)
        _close(TL.apply_rope(tx, torch.arange(5), theta).numpy(),
               JL.apply_rope(x, jnp.arange(5), theta), 1e-5)
    # bf16 rounds at the reference's points: compute in fp32, cast back
    xb = tx.to(torch.bfloat16)
    want = JL.rms_norm(jnp.asarray(x, jnp.bfloat16), scale)
    assert TL.rms_norm(xb, ts).dtype == torch.bfloat16
    _close(TL.rms_norm(xb, ts).float().numpy(), want.astype(jnp.float32),
           1e-2)


@pytest.mark.parametrize("name", list(CONFIGS) + OTHER_DENSE)
def test_forward_train_logits_match_jax(name):
    jcfg, tcfg, jp, tp = _model(name)
    toks = _tokens(jcfg, 2, 12)
    want, _ = JM.forward_train(jp, jcfg, jnp.asarray(toks))
    got = TM.forward_train(tp, tcfg, torch.from_numpy(toks))
    assert got.shape == (2, 12, tcfg.vocab)
    _close(got.numpy(), want, ATOL)


@pytest.mark.parametrize("S,extra", [(16, 4), (13, 4)])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_then_three_decode_steps_match_jax(name, S, extra):
    """Logits of prefill and of three decode steps, and every layer's
    cache after each. The window-8 variant primes a ring (S >= 8, rolled
    by S % 8 for S = 13); the others pad the cache past S."""
    jcfg, tcfg, jp, tp = _model(name)
    B = 2
    toks = _tokens(jcfg, B, S, seed=S)
    cache_len = S + extra
    jl, jc = JM.prefill(jp, jcfg, jnp.asarray(toks), cache_len=cache_len)
    tl, tc = TM.prefill(tp, tcfg, torch.from_numpy(toks),
                        cache_len=cache_len)
    assert tl.shape == (B, 1, tcfg.vocab)
    _close(tl.numpy(), jl, ATOL)
    for t_c, j_c in zip(_mixer_caches(tc), _mixer_caches(jc)):
        _close_cache(t_c, j_c)
    nxt = _tokens(jcfg, B, 3, seed=100 + S)
    for i in range(3):
        jl, jc = JM.decode_step(jp, jcfg, jc, jnp.asarray(nxt[:, i:i + 1]))
        tl, tc = TM.decode_step(tp, tcfg, tc, torch.from_numpy(
            nxt[:, i:i + 1]))
        _close(tl.numpy(), jl, ATOL)
    for t_c, j_c in zip(_mixer_caches(tc), _mixer_caches(jc)):
        _close_cache(t_c, j_c)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_plus_decode_equals_forward(name):
    """Inside the port: the last-position logits of prefill and of every
    decode step equal the full forward's over the same tokens."""
    _, tcfg, _, tp = _model(name)
    B, S, steps = 2, 11, 4
    toks = torch.from_numpy(_tokens(tcfg, B, S + steps, seed=7)).long()
    full = TM.forward_train(tp, tcfg, toks)
    lg, cache = TM.prefill(tp, tcfg, toks[:, :S], cache_len=S + steps + 1)
    _close(lg[:, 0].numpy(), full[:, S - 1].numpy(), ATOL)
    for i in range(steps):
        lg, cache = TM.decode_step(tp, tcfg, cache, toks[:, S + i:S + i + 1])
        _close(lg[:, 0].numpy(), full[:, S + i].numpy(), ATOL)


def test_decode_writes_the_cache_in_place():
    _, tcfg, _, tp = _model("qwen3_8b_scan4")
    toks = torch.from_numpy(_tokens(tcfg, 2, 6)).long()
    _, cache = TM.prefill(tp, tcfg, toks, cache_len=9)
    k = cache["groups"][0]["mixer"]["k"]
    ptr = k.data_ptr()
    _, cache2 = TM.decode_step(tp, tcfg, cache, toks[:, :1])
    assert cache2 is cache and k.data_ptr() == ptr
    assert cache["groups"][0]["mixer"]["pos"].tolist() == [[7, 7]] * 4
    assert bool(k[:, :, :, 6].abs().sum() > 0)        # the new row
    assert bool((k[:, :, :, 7:] == 0).all())          # rows not yet written


@pytest.mark.parametrize("name", ["qwen3_8b", "qwen3_8b_scan4",
                                  "command_r_35b", "rwkv6_1b6_scan4"])
def test_init_params_has_the_reference_layout(name):
    jcfg, tcfg, jp, _ = _model(name)
    tp = TM.init_params(0, tcfg, CPU)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda a: tuple(a.shape), tp,
                        is_leaf=torch.is_tensor) == shapes
    again = TM.init_params(0, tcfg, CPU)
    assert torch.equal(tp["embed"], again["embed"])
    # the draws have the reference's scale (normal * fan_in ** -0.5)
    w = tp["lm_head"] if "lm_head" in tp else tp["embed"]
    want_std = (tcfg.d_model ** -0.5) if "lm_head" in tp else 0.02
    assert abs(w.float().std().item() / want_std - 1) < 0.05


def test_full_qwen3_8b_config_and_unported_families():
    cfg = get_config("qwen3-8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.qk_norm, cfg.rope_theta,
            cfg.scan_layers, cfg.dtype) == (36, 4096, 32, 8, 128, 12288,
                                            151936, True, 1e6, True,
                                            "bfloat16")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_get_config("qwen3_8b"))
    assert 8.1e9 < cfg.param_count() < 8.3e9
    # the other families build too, each the reference's config with its
    # parameter count in the published range
    for arch, lo, hi in (("olmoe_1b_7b", 6.5e9, 7.2e9),
                         ("qwen3_moe_235b_a22b", 2.2e11, 2.4e11),
                         ("recurrentgemma_2b", 2.5e9, 3.0e9),
                         ("whisper_small", 2.0e8, 2.6e8),
                         ("internvl2_26b", 1.9e10, 2.1e10)):
        other = get_config(arch)
        assert dataclasses.asdict(other) == dataclasses.asdict(
            jax_get_config(arch))
        assert lo < other.param_count() < hi
    with pytest.raises(KeyError):
        get_config("gpt2")


def test_full_rwkv6_1b6_config():
    cfg = get_config("rwkv6-1.6b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_get_config("rwkv6_1b6"))
    assert (cfg.n_layers, cfg.d_model, cfg.wkv_head_dim, cfg.d_ff,
            cfg.vocab, cfg.block_pattern, cfg.ffn_kind, cfg.norm,
            cfg.tie_embeddings, cfg.scan_layers, cfg.dtype) == (
        24, 2048, 64, 7168, 65536, ("wkv6",), "rwkv_cm", "layernorm",
        False, True, "bfloat16")
    assert cfg.param_count() == jax_get_config("rwkv6_1b6").param_count()
    assert 1.5e9 < cfg.param_count() < 1.7e9


def test_rwkv6_decode_writes_the_state_in_place():
    _, tcfg, _, tp = _model("rwkv6_1b6_scan4")
    toks = torch.from_numpy(_tokens(tcfg, 2, 6)).long()
    _, cache = TM.prefill(tp, tcfg, toks)
    group = cache["groups"][0]
    ptrs = [group["mixer"]["state"].data_ptr(),
            group["mixer"]["x_prev"].data_ptr(), group["cm_prev"].data_ptr()]
    before = group["mixer"]["state"].clone()
    _, cache2 = TM.decode_step(tp, tcfg, cache, toks[:, :1])
    assert cache2 is cache
    assert ptrs == [group["mixer"]["state"].data_ptr(),
                    group["mixer"]["x_prev"].data_ptr(),
                    group["cm_prev"].data_ptr()]
    assert group["mixer"]["state"].shape == (4, 2, 4, 64, 64)
    assert not torch.equal(group["mixer"]["state"], before)


@pytest.mark.parametrize("arch", ["rwkv6_1b6", "qwen3_8b"])
def test_bf16_logits_round_where_the_reference_rounds(arch):
    """Reduced 2-layer models in bf16, JAX-initialized and converted: the
    port's forward logits against ``repro.models``'. Both round to bf16 at
    the same points and accumulate in float32, so they differ only where a
    float32 sum rounds differently (another GEMM order): rms gap within
    1e-2 of the logits' rms, max gap within 4 bf16 ulps of the largest
    logit."""
    jcfg, tcfg = _configs(arch, {"dtype": "bfloat16"})
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    assert tp["embed"].dtype == torch.bfloat16
    toks = _tokens(jcfg, 2, 80)
    want, _ = JM.forward_train(jp, jcfg, jnp.asarray(toks))
    want = np.asarray(want.astype(jnp.float32))
    got = TM.forward_train(tp, tcfg, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    d = got.float().numpy() - want
    rms = np.sqrt((want ** 2).mean())
    assert np.sqrt((d ** 2).mean()) <= 1e-2 * rms
    assert np.abs(d).max() <= 4 * 2 ** -7 * np.abs(want).max()
