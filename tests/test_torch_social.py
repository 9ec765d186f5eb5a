"""Algorithm 3 in the port against ``repro.core.social``: the loop core fed
the reference's hoisted tables for all three stores, the PS fusion,
Theorem 2's rate, the quickstart scenario end to end, and the entry
points' device and plan rules.

Tolerances. The link masks and signals are bit-equal (threefry port), so
what differs is arithmetic: the reference runs the loop as one jitted
``lax.scan``, where XLA contracts ``sigma + z * share`` and
``z * share + recv`` into fused multiply-adds, about 1 ulp per op, while
the port rounds each op. Over 120 rounds that compounds to a relative
1e-5 on ``z`` (rtol 1e-4 here). Beliefs and log ratios divide ``z`` by a
mass that decays to ~1e-2, so their absolute gap grows by that factor:
beliefs within 1e-3, log ratios within 1e-2 + 1e-3 relative, and the
final decision (argmax) equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import repro.core.graphs as jg
import repro.core.signals as js
from repro.core import social as jsoc
from repro.core.hps import HPSConfig as JaxHPSConfig
from repro.core.hps import hps_fusion as jax_hps_fusion
from repro_torch import convert
from repro_torch.core import social as tsoc
from repro_torch.core.graphs import EdgeList, make_hierarchy
from repro_torch.core.hps import HPSConfig, hps_fusion
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.prng import prng_key
from repro_torch.core.pushsum import sparse_mass_invariant
from repro_torch.core.signals import make_confused_model

T_CORE = 120


def _scenario(drop):
    topo = jg.make_hierarchy([6, 6, 6], "complete", seed=0)
    model = js.make_confused_model(18, 3, truth=1, confusion=0.5, seed=0)
    cfg = JaxHPSConfig(topo=topo, gamma_period=8, B=4, drop_prob=drop)
    return model, jsoc.make_social_runtime(cfg)


def _close_run(got, ref):
    (tf, (tb, tl)), (jf, (jb, jl)) = got, ref
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_allclose(tf.z.numpy(), np.asarray(jf.z), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tf.m.numpy(), np.asarray(jf.m), rtol=1e-5,
                               atol=1e-7)
    last = (lambda b: b[-1]) if tb.ndim == 3 else (lambda b: b)
    np.testing.assert_array_equal(last(tb.numpy()).argmax(-1),
                                  last(np.asarray(jb)).argmax(-1))


@pytest.mark.parametrize("store", ["trajectory", "log_ratio", "final"])
@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_core_matches_reference_with_hoisted_tables(store, drop):
    model, jrt = _scenario(drop)
    lt = model.log_tables().astype(jnp.float32)
    cdf = jnp.cumsum(model.tables[:, model.truth, :].astype(jnp.float32), -1)
    ref = jsoc._social_compiled(
        jax.random.PRNGKey(0), jax.random.PRNGKey(100), jrt, lt, cdf,
        truth=1, M=3, T=T_CORE, store=store, backend="xla", dst_sorted=True)
    rt = convert.social_runtime_from_numpy(*(np.asarray(x) for x in jrt))
    got = tsoc._social_scan_core(
        prng_key(0), prng_key(100), rt, torch.tensor(np.asarray(lt)),
        torch.tensor(np.asarray(cdf)), truth=1, M=3, T=T_CORE,
        store=store, backend="auto")
    assert got[1][0].shape == ref[1][0].shape
    assert got[1][1].shape == ref[1][1].shape
    _close_run(got, ref)
    inv = sparse_mass_invariant(got[0], rt.src, rt.valid)
    np.testing.assert_allclose(inv[-1].item(), 18.0, rtol=1e-5)


def test_hps_fusion_matches_reference():
    rng = np.random.default_rng(4)
    z = rng.normal(size=(20, 3)).astype(np.float32)
    m = rng.random(20).astype(np.float32)
    rep = np.zeros(20, bool)
    rep[[0, 7, 13]] = True
    got = hps_fusion(torch.from_numpy(z), torch.from_numpy(m),
                     torch.from_numpy(rep), 3)
    ref = jax_hps_fusion(jnp.asarray(z), jnp.asarray(m), jnp.asarray(rep), 3)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)
    # non-representatives are untouched; total mass is conserved
    assert torch.equal(got[0][~torch.from_numpy(rep)],
                       torch.from_numpy(z)[~rep])
    np.testing.assert_allclose(got[1].sum().item(), m.sum(), rtol=1e-6)


def test_theorem2_rate_and_kl_update_match_reference():
    jm = js.make_confused_model(30, 4, truth=2, confusion=0.5, seed=3)
    tm = convert.signal_model_from_numpy(np.asarray(jm.tables), jm.truth)
    np.testing.assert_array_equal(tsoc.theorem2_rate(tm, 30),
                                  jsoc.theorem2_rate(jm, 30))
    rng = np.random.default_rng(0)
    z = rng.normal(size=(6, 4)).astype(np.float32)
    m = np.array([1.0, 0.5, 1e-31, 0.0, 2.0, 0.1], np.float32)
    np.testing.assert_allclose(
        tsoc.kl_dual_averaging_update(torch.from_numpy(z),
                                      torch.from_numpy(m)).numpy(),
        np.asarray(jsoc.kl_dual_averaging_update(jnp.asarray(z),
                                                 jnp.asarray(m))),
        rtol=1e-6, atol=1e-7)


def test_quickstart_scenario_learns_theta_star():
    """examples/quickstart.py's Algorithm 3 scenario: 3x6 complete, 30 %
    packet loss, fusion every 8 rounds, T = 500."""
    topo = make_hierarchy([6, 6, 6], topology="complete", seed=0)
    model = make_confused_model(N=topo.N, m=3, truth=1, confusion=0.5, seed=0)
    cfg = HPSConfig(topo=topo, gamma_period=8, B=4, drop_prob=0.3)
    res = tsoc.run_social_learning(model, cfg, T=500, seed=0, device="cpu")
    beliefs, state, log_ratio = res.to_numpy()
    assert beliefs.shape == log_ratio.shape == (500, 18, 3)
    assert state["rho"].shape == (cfg.edge_index().E, 3)
    assert beliefs[-1, :, model.truth].min() > 0.95
    ref = jsoc.run_social_learning(
        js.make_confused_model(N=18, m=3, truth=1, confusion=0.5, seed=0),
        JaxHPSConfig(topo=jg.make_hierarchy([6, 6, 6], "complete", seed=0),
                     gamma_period=8, B=4, drop_prob=0.3), T=500, seed=0)
    np.testing.assert_array_equal(beliefs[-1].argmax(-1),
                                  np.asarray(ref.beliefs)[-1].argmax(-1))
    # the mass counters are fp32 running sums ~T large, so the invariant
    # drifts by rounding; the reference itself ends at 18.00097 here
    inv = sparse_mass_invariant(res.final_state, *_edges(cfg))
    np.testing.assert_allclose(inv[-1].item(), 18.0, rtol=1e-4)


def _edges(cfg):
    el = cfg.edge_index()
    return torch.from_numpy(el.src), torch.from_numpy(el.valid)


def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = make_hierarchy([3, 3], topology="complete", seed=0)
    model = make_confused_model(N=6, m=3, seed=0)
    cfg = HPSConfig(topo=topo, gamma_period=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsoc.run_social_learning(model, cfg, T=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsoc.run_social_runtime(model, tsoc.make_social_runtime(cfg), 2, 2,
                                device="cuda")


def test_plan_rules():
    topo = make_hierarchy([3, 3], topology="complete", seed=0)
    model = make_confused_model(N=6, m=3, seed=0)
    rt = tsoc.make_social_runtime(HPSConfig(topo=topo, gamma_period=2))
    with pytest.raises(ValueError, match="store"):
        tsoc.run_social_runtime(model, rt, 2, 2, device="cpu",
                                plan=ExecutionPlan(store="gap"))
    el = EdgeList(src=np.array([0, 1, 2], np.int32),
                  dst=np.array([2, 0, 1], np.int32), n=6,
                  valid=np.ones(3, bool))
    unsorted = tsoc.social_runtime_from_edge_list(
        el, topo.rep_mask(), drop_prob=0.0, gamma_period=2)
    assert unsorted.offsets is None
    with pytest.raises(ValueError, match="dst-sorted"):
        tsoc.run_social_runtime(model, unsorted, 2, 2, device="cpu",
                                plan=ExecutionPlan(dst_sorted=True))
    # the plain path accepts any edge order
    res = tsoc.run_social_runtime(model, unsorted, 2, 3, device="cpu",
                                  plan=ExecutionPlan(store="final"))
    assert res.beliefs.shape == (6, 3)
    with pytest.raises(ValueError, match="lie in"):
        tsoc.social_runtime_from_edge_list(
            EdgeList(src=np.array([0], np.int32), dst=np.array([6], np.int32),
                     n=6, valid=np.ones(1, bool)),
            topo.rep_mask(), drop_prob=0.0, gamma_period=2)


def test_padded_runtime_matches_reference_padding():
    jel, jrep = jg.block_complete_edge_list([4, 4])
    jrt = jsoc.social_runtime_from_edge_list(
        jel, jrep, drop_prob=0.2, gamma_period=4, B=2, e_max=40)
    el = EdgeList(src=jel.src, dst=jel.dst, n=jel.n, valid=jel.valid)
    rt = tsoc.social_runtime_from_edge_list(
        el, jrep, drop_prob=0.2, gamma_period=4, B=2, e_max=40)
    for name in ("src", "dst", "valid", "rep_mask", "drop_prob", "gamma", "B"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(jrt, name)), name)
    assert rt.offsets[-1].item() == 40


@pytest.mark.parametrize("store", ["trajectory", "log_ratio", "final"])
def test_belief_floor_keeps_converged_log_ratios_finite(store):
    """Watch-list regression: a converged wrong-hypothesis belief is exactly
    0 in fp32; the floor is the smallest NORMAL fp32, so log ratios stay
    finite (a subnormal floor flushed to zero gave log(0) and NaN)."""
    assert tsoc._MU_FLOOR == float(np.finfo(np.float32).tiny)
    topo = make_hierarchy([4, 4], topology="complete", seed=0)
    rows = np.full((8, 3, 4), 0.01 / 3, np.float32)
    rows[:, :, 0] = 0.99          # every wrong hypothesis says "letter 0"
    rows[:, 1] = rows[:, 1, ::-1]  # theta* = 1 makes letter 3 likely
    model = convert.signal_model_from_numpy(rows, truth=1)
    cfg = HPSConfig(topo=topo, gamma_period=2)
    res = tsoc.run_social_learning(model, cfg, T=40, device="cpu",
                                   plan=ExecutionPlan(store=store))
    final = res.beliefs[-1] if store == "trajectory" else res.beliefs
    assert (final[:, 0] == 0).all()          # underflowed to exactly zero
    assert torch.isfinite(res.log_ratio).all()
    assert res.log_ratio.min() >= np.log(np.finfo(np.float32).tiny) - 1


def test_stream_folds_are_disjoint_over_the_horizon():
    T = 10_000
    link = {tsoc.social_stream_fold(t, tsoc.STREAM_LINK) for t in range(T)}
    signal = {tsoc.social_stream_fold(t, tsoc.STREAM_SIGNAL)
              for t in range(T)}
    assert len(link) == len(signal) == T and not link & signal
