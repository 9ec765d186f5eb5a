"""Each of the port's other model families end to end against the JAX
package on the CPU, at ``reduced`` size: forward logits and the MoE aux,
prefill followed by three decode steps (logits and every cache leaf), and,
inside the port, prefill + decode against the full forward. The models,
helpers and tolerances are ``tests/test_torch_families.py``'s (logits
atol = rtol = 1e-4, caches 1e-5); this file holds the slow cases apart so
that they run beside the layer tests.
"""
import dataclasses

import jax.numpy as jnp
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

from repro.models import model as JM
from repro_torch.models import model as TM
from test_torch_families import (CACHE_TOL, CONFIGS, _close, _model, _np,
                                 _stubs, _t, _tokens)


# ---------------------------------------------------------------------------
# each family end to end
# ---------------------------------------------------------------------------

def _caches(cache):
    """Every layer's cache dict (either layout), then ``enc`` if any."""
    out = list(cache.get("groups", ())) + list(cache.get("tail", ())) \
        + list(cache.get("layers", ()))
    if "enc" in cache:
        out.append({"enc": cache["enc"]})
    return out


def _close_cache(tc, jc):
    assert sorted(tc) == sorted(jc)
    for name in tc:
        if isinstance(tc[name], dict):
            _close_cache(tc[name], jc[name])
            continue
        assert tuple(tc[name].shape) == tuple(jc[name].shape), name
        _close(_np(tc[name]), jc[name], CACHE_TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_logits_and_aux_match_reference(name):
    jcfg, tcfg, jp, tp = _model(name)
    toks, stubs = _tokens(jcfg, 2, 12), _stubs(jcfg, 2)
    want, want_aux = JM.forward_train(
        jp, jcfg, jnp.asarray(toks),
        **{k: jnp.asarray(v) for k, v in stubs.items()})
    got, aux = TM.forward_train(tp, tcfg, torch.from_numpy(toks),
                                with_aux=True, **_t(stubs))
    assert got.shape == want.shape
    _close(_np(got), want)
    _close(float(aux), float(want_aux))
    assert (float(aux) > 0) == (tcfg.family == "moe")
    # today's callers: logits alone
    _close(_np(TM.forward_train(tp, tcfg, torch.from_numpy(toks),
                                **_t(stubs))), want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_then_three_decode_steps_match_reference(name):
    """Logits of prefill and of three decode steps, and every cache leaf
    after each (K/V rows, the RG-LRU state and conv history, ``enc``)."""
    jcfg, tcfg, jp, tp = _model(name)
    B, S = 2, 13
    toks, stubs = _tokens(jcfg, B, S, seed=S), _stubs(jcfg, B)
    n_patch = jcfg.n_patches if jcfg.family == "vlm" else 0
    cache_len = S + 4 + n_patch
    jl, jc = JM.prefill(jp, jcfg, jnp.asarray(toks), cache_len=cache_len,
                        **{k: jnp.asarray(v) for k, v in stubs.items()})
    tl, tc = TM.prefill(tp, tcfg, torch.from_numpy(toks),
                        cache_len=cache_len, **_t(stubs))
    _close(_np(tl), jl)
    for t_c, j_c in zip(_caches(tc), _caches(jc), strict=True):
        _close_cache(t_c, j_c)
    nxt = _tokens(jcfg, B, 3, seed=100 + S)
    for i in range(3):
        jl, jc = JM.decode_step(jp, jcfg, jc, jnp.asarray(nxt[:, i:i + 1]))
        tl, tc = TM.decode_step(tp, tcfg, tc,
                                torch.from_numpy(nxt[:, i:i + 1]))
        _close(_np(tl), jl)
        for t_c, j_c in zip(_caches(tc), _caches(jc), strict=True):
            _close_cache(t_c, j_c)


@pytest.mark.parametrize("name", [n for n in CONFIGS
                                  if CONFIGS[n][0] != "olmoe_1b_7b"
                                  and CONFIGS[n][0] != "qwen3_moe_235b_a22b"]
                         + ["olmoe_dropfree"])
def test_prefill_plus_decode_equals_forward(name):
    """Inside the port: prefill's and each decode step's last-position
    logits equal the full forward's over the same tokens. MoE drops
    depend on how many tokens a call routes (its capacity), so the MoE
    case runs at a drop-free capacity (E / k), where the paths compute the
    same function."""
    if name == "olmoe_dropfree":
        _, tcfg, _, tp = _model("olmoe_1b_7b")
        tcfg = dataclasses.replace(tcfg, capacity_factor=tcfg.n_experts
                                   / tcfg.top_k)
    else:
        _, tcfg, _, tp = _model(name)
    B, S, steps = 2, 11, 4
    toks = torch.from_numpy(_tokens(tcfg, B, S + steps, seed=7)).long()
    stubs = _t(_stubs(tcfg, B))
    P = tcfg.n_patches if tcfg.family == "vlm" else 0
    full = TM.forward_train(tp, tcfg, toks, **stubs)
    lg, cache = TM.prefill(tp, tcfg, toks[:, :S],
                           cache_len=S + steps + 1 + P, **stubs)
    _close(_np(lg[:, 0]), _np(full[:, P + S - 1]))
    for i in range(steps):
        lg, cache = TM.decode_step(tp, tcfg, cache, toks[:, S + i:S + i + 1])
        _close(_np(lg[:, 0]), _np(full[:, P + S + i]))
