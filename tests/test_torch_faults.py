"""The fault plane in the port (``repro_torch.core.faults``) against
``repro.core.faults``: the fold band, the Gilbert–Elliott, churn and PS
draws, the faulted link mask, and the four engines under the chaos lane's
severe model and the churn model; plus the port's own properties — the
degenerate model bit-equal to ``faults=None``, mass through churn, a
crashed PS equal to never fusing, frozen dead agents, finiteness under
extreme faults — and the error cases.

Tolerances. Draws are bit-equal (threefry port). Engine state against the
reference's jitted scan is held as ``tests/test_torch_hps.py`` and
``tests/test_torch_social.py`` hold the fault-free runs: (z, m) within
rtol 1e-4 / atol 1e-5 (XLA contracts multiply-adds, ~1 ulp an op), the
HPS gap curve within 1e-4; Alg. 3 beliefs within 1e-3 where the agent's
mass is at least 1e-3 (churn drains a frozen network's mass to ~1e-9,
where z / m magnifies one ulp of z past any belief limit) and the final
decisions equal; Alg. 2's statistic within rtol 2e-5 / atol 2e-3 and
every decision at every step equal, as ``tests/test_torch_byzantine.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import repro.core.attacks as jat
import repro.core.byzantine as jb
import repro.core.faults as jf
import repro.core.graphs as jg
import repro.core.hps as jh
import repro.core.pushsum as jp
import repro.core.signals as jsig
import repro.core.social as jsoc
from repro.core.plan import ExecutionPlan as JaxPlan
import repro_torch.core.attacks as tat
import repro_torch.core.byzantine as tb
import repro_torch.core.faults as tf
import repro_torch.core.graphs as tg
import repro_torch.core.hps as th
import repro_torch.core.pushsum as tp
import repro_torch.core.signals as tsig
import repro_torch.core.social as tsoc
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.prng import Key, fold_in, prng_key, uniform

HORIZON = 1 << 20
TS = [0, 1, 199, HORIZON - 1]


def _models(mod, kind):
    """The chaos lane's severe model (``benchmarks/chaos.py:52-56``), the
    churn model of ``benchmarks/social_learning.py:190``, or the
    degenerate one."""
    if kind == "severe":
        return mod.gilbert_elliott_model(8.0, 0.5, leave_prob=0.1,
                                         join_prob=0.25, ps_crash_prob=0.5)
    if kind == "churn":
        return mod.make_fault_model(leave_prob=0.02, join_prob=0.3)
    return mod.make_fault_model()


def _chaos(mod):
    """tests/test_faults.py's harsh model."""
    return mod.make_fault_model(p_gb=0.25, p_bg=0.5, drop_bad=0.9,
                                leave_prob=0.05, join_prob=0.5,
                                ps_crash_prob=0.3)


def _pushsum_setup(n=12, seed=0):
    rng = np.random.default_rng(seed)
    el = jg.sort_by_dst(jg.edge_list(jg.random_strongly_connected(
        n, 0.3, rng)))[0]
    return el, rng.normal(size=(n, 3)).astype(np.float32)


def _key_words(jkey):
    return tuple(int(x) for x in np.asarray(jkey))


# ---------------------------------------------------------------------------
# The fold band and the draws, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", TS)
def test_fold_values_and_keys_match_reference(t):
    for e in range(tf.N_ENGINES):
        for s in range(tf.N_FAULT_STREAMS):
            got, want = tf.fault_stream_fold(t, e, s), jf.fault_stream_fold(
                t, e, s)
            assert type(got) is np.int32 and got == want, (t, e, s)
            key = fold_in(prng_key(5), got)
            assert (key.k0, key.k1) == _key_words(
                jax.random.fold_in(jax.random.PRNGKey(5), want))
    # the band lies below the HPS ~t band and apart from every stream
    assert int(tf.fault_stream_fold(t, 3, 2)) < -(1 << 20)


def test_gilbert_elliott_parameterization_matches_reference():
    for L, frac in ((8.0, 0.5), (32.0, 0.5), (3.0, 0.3), (1.0, 0.0)):
        got = tf.gilbert_elliott_model(L, frac, leave_prob=0.1)
        want = jf.gilbert_elliott_model(L, frac, leave_prob=0.1)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            assert g.item() == np.float32(w)
    for bad in ((0.5, 0.2), (4.0, 1.0), (4.0, -0.1)):
        with pytest.raises(ValueError):
            tf.gilbert_elliott_model(*bad)


@pytest.mark.parametrize("engine", range(4))
def test_step_faults_matches_reference(engine):
    E, N = 37, 11
    fm_j, fm_t = _chaos(jf), _chaos(tf)
    fs_j, fs_t = jf.init_fault_state(N, E), tf.init_fault_state(N, E)
    for t in TS + [2, 3, 4]:
        fs_j = jf.step_faults(jax.random.PRNGKey(13), jnp.uint32(t), fm_j,
                              fs_j, engine=engine)
        fs_t = tf.step_faults(prng_key(13), t, fm_t, fs_t, engine=engine)
        np.testing.assert_array_equal(fs_t.edge_bad.numpy(),
                                      np.asarray(fs_j.edge_bad))
        np.testing.assert_array_equal(fs_t.node_live.numpy(),
                                      np.asarray(fs_j.node_live))


def test_stacked_step_faults_match_reference_rows():
    """K scenarios stacked flat, each with its own key and model (a
    grid's fault axis), draw each row as the reference draws it alone."""
    E, N, K = 23, 7, 3
    models = [_models(tf, "severe"), _models(tf, "churn"), _chaos(tf)]
    jmodels = [_models(jf, "severe"), _models(jf, "churn"), _chaos(jf)]
    seeds = np.array([3, 9, 2**31 + 5], np.int64)
    keys = Key(np.zeros(K, np.int64), seeds)
    fm = tf.stack_fault_models(models)
    fs = tf.init_fault_state(K * N, K * E)
    js = [jf.init_fault_state(N, E) for _ in range(K)]
    for t in range(6):
        fs = tf.step_faults(keys, t, fm, fs, engine=tf.ENGINE_SOCIAL)
        for k in range(K):
            js[k] = jf.step_faults(
                jax.random.PRNGKey(np.uint32(seeds[k])), jnp.uint32(t),
                jmodels[k], js[k], engine=jf.ENGINE_SOCIAL)
            np.testing.assert_array_equal(
                fs.edge_bad[k * E:(k + 1) * E].numpy(),
                np.asarray(js[k].edge_bad))
            np.testing.assert_array_equal(
                fs.node_live[k * N:(k + 1) * N].numpy(),
                np.asarray(js[k].node_live))


def test_step_faults_nbr_matches_reference_single_and_stacked():
    N, dm, K = 9, 5, 3
    fm_j, fm_t = _models(jf, "severe"), _models(tf, "severe")
    one_j = jf.init_fault_state(N, (N, dm))
    one_t = tf.init_fault_state(N, (N, dm))
    seeds = np.array([1, 4, 7], np.int64)
    many = tf.init_fault_state(K * N, (K * N, dm))
    rows = [jf.init_fault_state(N, (N, dm)) for _ in range(K)]
    for t in [0, 1, 2, 199]:
        one_j, drop_j = jf.step_faults_nbr(
            jax.random.PRNGKey(1), jnp.uint32(t), fm_j, one_j,
            engine=jf.ENGINE_BYZANTINE)
        one_t, drop_t = tf.step_faults_nbr(prng_key(1), t, fm_t, one_t,
                                           engine=tf.ENGINE_BYZANTINE)
        for g, w in ((one_t.edge_bad, one_j.edge_bad), (drop_t, drop_j),
                     (one_t.node_live, one_j.node_live)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        many, drop = tf.step_faults_nbr(
            Key(np.zeros(K, np.int64), seeds), t, fm_t, many,
            engine=tf.ENGINE_BYZANTINE)
        for k in range(K):
            rows[k], dk = jf.step_faults_nbr(
                jax.random.PRNGKey(int(seeds[k])), jnp.uint32(t), fm_j,
                rows[k], engine=jf.ENGINE_BYZANTINE)
            sl = slice(k * N, (k + 1) * N)
            np.testing.assert_array_equal(many.edge_bad[sl].numpy(),
                                          np.asarray(rows[k].edge_bad))
            np.testing.assert_array_equal(drop[sl].numpy(), np.asarray(dk))
            np.testing.assert_array_equal(many.node_live[sl].numpy(),
                                          np.asarray(rows[k].node_live))


def test_faulty_edge_mask_matches_reference():
    E, N, B = 41, 10, 3
    rng = np.random.default_rng(2)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    u = rng.random(E).astype(np.float32)
    fm_j, fm_t = _chaos(jf), _chaos(tf)
    for t in range(4):
        bad = rng.random(E) < 0.4
        live = rng.random(N) < 0.8
        want = jf.faulty_edge_mask(
            jnp.asarray(u), jnp.uint32(t), fm_j,
            jf.FaultState(jnp.asarray(bad), jnp.asarray(live)),
            jnp.asarray(src), jnp.asarray(dst), 0.35, B)
        got = tf.faulty_edge_mask(
            torch.from_numpy(u), t, fm_t,
            tf.FaultState(torch.from_numpy(bad), torch.from_numpy(live)),
            torch.from_numpy(src).long(), torch.from_numpy(dst).long(),
            torch.tensor(0.35), torch.tensor(B, dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_degenerate_mask_is_the_bernoulli_mask_draw_for_draw():
    """And both tests/test_faults.py hand cases: a bad edge is exempt from
    the B-window, a dead end silences an edge."""
    E, N = 33, 9
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.integers(0, N, E))
    dst = torch.from_numpy(rng.integers(0, N, E))
    fm0, fs0 = tf.make_fault_model(), tf.init_fault_state(N, E)
    drop, B = torch.tensor(0.35), torch.tensor(3, dtype=torch.int32)
    for t in range(7):
        kt = fold_in(prng_key(7), t)
        got = tf.faulty_edge_mask(uniform(kt, E, "cpu"), t, fm0, fs0,
                                  src, dst, drop, B)
        assert torch.equal(got, tp.step_edge_mask(prng_key(7), t, E, drop,
                                                  B))
    fs = tf.FaultState(edge_bad=torch.tensor([True, False]),
                       node_live=torch.ones(2, dtype=torch.bool))
    got = tf.faulty_edge_mask(torch.tensor([0.5, 0.0]), 1,
                              tf.make_fault_model(drop_bad=1.0), fs,
                              torch.tensor([0, 0]), torch.tensor([1, 1]),
                              torch.tensor(0.9), torch.tensor(2))
    assert got.tolist() == [False, True]
    fs = tf.FaultState(edge_bad=torch.zeros(3, dtype=torch.bool),
                       node_live=torch.tensor([True, False, True]))
    got = tf.faulty_edge_mask(torch.zeros(3), 1, fm0, fs,
                              torch.tensor([0, 1, 2]), torch.tensor([2, 2, 1]),
                              torch.tensor(0.0), torch.tensor(2))
    assert got.tolist() == [True, False, False]


def test_ps_alive_matches_reference_and_the_host_table():
    fm_j, fm_t = _models(jf, "severe"), _models(tf, "severe")
    T = 64
    table = tf.ps_alive_rounds(prng_key(11), T, fm_t, engine=2)
    assert table.shape == (T, 1) and 0 < table.sum() < T
    for t in list(range(T)) + [HORIZON - 1]:
        want = bool(jf.ps_alive(jax.random.PRNGKey(11), jnp.uint32(t), fm_j,
                                engine=2))
        assert bool(tf.ps_alive(prng_key(11), t, fm_t, engine=2)) == want
        if t < T:
            assert bool(table[t, 0]) == want
    # K keys and (K,) crash probabilities at once
    seeds = np.array([0, 11, 12], np.int64)
    fm = tf.stack_fault_models([tf.make_fault_model(ps_crash_prob=p)
                                for p in (0.0, 0.5, 1.0)])
    many = tf.ps_alive_rounds(Key(np.zeros(3, np.int64), seeds), T, fm,
                              engine=1)
    assert many[:, 0].all() and not many[:, 2].any()
    np.testing.assert_array_equal(
        many[:, 1], [bool(jf.ps_alive(jax.random.PRNGKey(11), jnp.uint32(t),
                                      jf.make_fault_model(ps_crash_prob=0.5),
                                      engine=1)) for t in range(T)])


def test_freeze_shapes():
    live = torch.tensor([True, False, True])
    out = tf.freeze(live, torch.arange(6.0).reshape(3, 2), -torch.ones(3, 2))
    assert out.tolist() == [[0.0, 1.0], [-1.0, -1.0], [4.0, 5.0]]
    out = tf.freeze(live, torch.arange(3.0), -torch.ones(3))
    assert out.tolist() == [0.0, -1.0, 2.0]


# ---------------------------------------------------------------------------
# The four engines under the severe and churn models, against the reference
# ---------------------------------------------------------------------------

def _hier(mod):
    return mod.make_hierarchy([6, 6, 6], "complete", seed=0)


@pytest.mark.parametrize("kind", ["severe", "churn"])
def test_pushsum_matches_reference(kind):
    el, w = _pushsum_setup()
    kw = dict(drop_prob=0.2, B=3, record_every=1)
    sj, trj = jp.run_pushsum_sparse(
        w, el.src, el.dst, 40, key=jax.random.PRNGKey(1),
        plan=JaxPlan(backend="xla", faults=_models(jf, kind)), **kw)
    st, trt = tp.run_pushsum_sparse(
        w, el.src, el.dst, 40, key=prng_key(1), device="cpu",
        plan=ExecutionPlan(faults=_models(tf, kind)), **kw)
    for g, r in ((st.z, sj.z), (st.m, sj.m), (st.sigma, sj.sigma),
                 (st.rho, sj.rho)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)
    heavy = np.asarray(sj.m) >= 1e-3
    np.testing.assert_allclose(trt[-1].numpy()[heavy],
                               np.asarray(trj)[-1][heavy], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kind", ["severe", "churn"])
def test_hps_matches_reference(kind):
    w = np.random.default_rng(3).normal(size=(18, 4)).astype(np.float32)
    rj = jh.run_hps(w, jh.HPSConfig(_hier(jg), 4, B=2, drop_prob=0.2), 60,
                    seed=1, plan=JaxPlan(backend="xla", store="gap",
                                         faults=_models(jf, kind)))
    rt = th.run_hps(w, th.HPSConfig(_hier(tg), 4, B=2, drop_prob=0.2), 60,
                    seed=1, device="cpu",
                    plan=ExecutionPlan(store="gap", faults=_models(tf, kind)))
    np.testing.assert_allclose(rt.gap.numpy(), np.asarray(rj.gap), atol=1e-4)
    for g, r in ((rt.final_state.z, rj.final_state.z),
                 (rt.final_state.m, rj.final_state.m)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)


def _social_pair(kind, T=60, store="trajectory", **plan):
    mj = jsig.make_confused_model(N=18, m=3, truth=1, confusion=0.3, seed=0)
    mt = tsig.make_confused_model(N=18, m=3, truth=1, confusion=0.3, seed=0)
    fj = None if kind is None else _models(jf, kind)
    ft = None if kind is None else _models(tf, kind)
    rj = jsoc.run_social_learning(
        mj, jh.HPSConfig(_hier(jg), 4, B=2, drop_prob=0.3), T, seed=2,
        plan=JaxPlan(**{"backend": "xla", "store": store, "faults": fj,
                        **plan.get("jax", {})}))
    rt = tsoc.run_social_learning(
        mt, th.HPSConfig(_hier(tg), 4, B=2, drop_prob=0.3), T, seed=2,
        device="cpu", plan=ExecutionPlan(**{"store": store, "faults": ft,
                                            **plan.get("torch", {})}))
    return rt, rj


def hold_social(rt, rj):
    """State to fp32 tolerance, beliefs where the mass is not drained,
    the final decisions equal."""
    zt, zj = rt.final_state, rj.final_state
    np.testing.assert_allclose(zt.z.numpy(), np.asarray(zj.z), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(zt.m.numpy(), np.asarray(zj.m), rtol=1e-4,
                               atol=1e-7)
    bt, bj = rt.beliefs.numpy(), np.asarray(rj.beliefs)
    last_t, last_j = (bt[-1], bj[-1]) if bt.ndim == 3 else (bt, bj)
    heavy = np.asarray(zj.m) >= 1e-3
    np.testing.assert_allclose(last_t[heavy], last_j[heavy], atol=1e-3)
    np.testing.assert_array_equal(last_t.argmax(-1), last_j.argmax(-1))


@pytest.mark.parametrize("kind", ["severe", "churn"])
def test_social_matches_reference(kind):
    hold_social(*_social_pair(kind))


def _byz_cfg(g, b, a):
    """tests/test_faults.py's Byzantine fixture: 4 x 7 complete, F 1,
    agent 2 lying large values, Γ 4."""
    return b.ByzantineConfig(topo=g.make_hierarchy([7] * 4, "complete",
                                                   seed=0),
                             F=1, byz=(2,), gamma_period=4,
                             attack=a.large_value())


def _byz_model(mod):
    return mod.make_confused_model(N=28, m=3, truth=0, confusion=0.3, seed=1)


@pytest.mark.parametrize("kind", ["severe", "churn"])
def test_byzantine_matches_reference(kind):
    rj = jb.make_byzantine_scan(_byz_model(jsig), _byz_cfg(jg, jb, jat), 40,
                                faults=_models(jf, kind))(
        jax.random.PRNGKey(3))
    rt = tb.run_byzantine_learning(
        _byz_model(tsig), _byz_cfg(tg, tb, tat), 40, seed=3, device="cpu",
        plan=ExecutionPlan(faults=_models(tf, kind)))
    np.testing.assert_allclose(rt.r.numpy(), np.asarray(rj.r), rtol=2e-5,
                               atol=2e-3)
    np.testing.assert_array_equal(rt.decisions.numpy(),
                                  np.asarray(rj.decisions))


# ---------------------------------------------------------------------------
# The port's own properties
# ---------------------------------------------------------------------------

def _run_engine(engine, plan, T=30, **kw):
    """One of the four engines on the port's CPU path -> its outputs as a
    flat tuple of tensors."""
    if engine == "pushsum":
        el, w = _pushsum_setup(**kw)
        st, traj = tp.run_pushsum_sparse(w, el.src, el.dst, T, drop_prob=0.3,
                                         B=3, key=prng_key(1), plan=plan,
                                         device="cpu")
        return (*st, traj)
    if engine == "hps":
        w = np.random.default_rng(3).normal(size=(18, 2)).astype(np.float32)
        res = th.run_hps(w, th.HPSConfig(_hier(tg), 4, B=2, drop_prob=0.2),
                         T, seed=0, plan=plan.replace(store="gap"),
                         device="cpu")
        return (res.ratio, res.gap, *res.final_state)
    if engine == "social":
        m = tsig.make_confused_model(N=18, m=3, truth=1, confusion=0.4,
                                     seed=0)
        res = tsoc.run_social_learning(
            m, th.HPSConfig(_hier(tg), kw.get("gamma", 4), B=2,
                            drop_prob=0.3), T, seed=0,
            plan=plan.replace(store="log_ratio"), device="cpu")
        return (res.beliefs, res.log_ratio, *res.final_state)
    res = tb.run_byzantine_learning(_byz_model(tsig), _byz_cfg(tg, tb, tat),
                                    12, seed=3, device="cpu",
                                    plan=plan.replace(store="final"))
    return tuple(res)


ENGINES = ["pushsum", "hps", "social", "byzantine"]


@pytest.mark.parametrize("engine", ENGINES)
def test_degenerate_model_is_bit_identical_to_no_faults(engine):
    base = _run_engine(engine, ExecutionPlan())
    got = _run_engine(engine, ExecutionPlan(faults=tf.make_fault_model()))
    assert all(torch.equal(a, b) for a, b in zip(base, got))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mass_invariant_under_churn(seed):
    el, w = _pushsum_setup(n=14, seed=seed)
    fm = tf.make_fault_model(p_gb=0.25, p_bg=0.5, drop_bad=0.9,
                             leave_prob=0.15, join_prob=0.4)
    st, _ = tp.run_pushsum_sparse(w, el.src, el.dst, 40, drop_prob=0.2, B=2,
                                  key=prng_key(seed), device="cpu",
                                  plan=ExecutionPlan(faults=fm))
    inv = tp.sparse_mass_invariant(st, torch.from_numpy(el.src).long(),
                                   torch.ones(el.E, dtype=torch.bool))
    np.testing.assert_allclose(inv[:-1].numpy(), w.sum(0), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(inv[-1].item(), 14.0, rtol=1e-5)


def test_crashed_ps_is_never_fusing():
    """A PS that is always down degrades the hierarchy to local consensus:
    exactly the Γ -> infinity engine."""
    crash = ExecutionPlan(faults=tf.make_fault_model(ps_crash_prob=1.0))
    none = ExecutionPlan(faults=tf.make_fault_model())
    a = _run_engine("social", crash)
    b = _run_engine("social", none, gamma=10**6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    w = np.random.default_rng(5).normal(size=(18, 2)).astype(np.float32)
    runs = [th.run_hps(w, th.HPSConfig(_hier(tg), g, B=2, drop_prob=0.2), 20,
                       plan=p.replace(store="final"), device="cpu")
            for g, p in ((4, crash), (10**6, none))]
    assert torch.equal(runs[0].ratio, runs[1].ratio)


def test_dead_agent_state_frozen_until_rejoin():
    el, w = _pushsum_setup(n=10, seed=3)
    plan = ExecutionPlan(faults=tf.make_fault_model(leave_prob=1.0,
                                                    join_prob=0.0))
    runs = [tp.run_pushsum_sparse(w, el.src, el.dst, T, key=prng_key(0),
                                  plan=plan, device="cpu")[0]
            for T in (2, 9)]
    assert torch.equal(runs[0].zm, runs[1].zm)
    assert torch.equal(runs[0].sigma_zm, runs[1].sigma_zm)


EXTREME = {
    "all_edges_dropped": dict(p_gb=1.0, p_bg=0.0, drop_bad=1.0),
    "all_agents_dead": dict(leave_prob=1.0, join_prob=0.0),
}


@pytest.mark.parametrize("name", sorted(EXTREME))
@pytest.mark.parametrize("engine", ENGINES)
def test_extreme_faults_stay_finite(engine, name):
    out = _run_engine(engine, ExecutionPlan(
        faults=tf.make_fault_model(**EXTREME[name])), T=15)
    for x in out:
        if x.is_floating_point():
            assert torch.isfinite(x).all(), (engine, name)


def test_error_cases():
    el, w = _pushsum_setup()
    fm = tf.make_fault_model()
    with pytest.raises(ValueError, match="masks"):
        tp.run_pushsum_sparse(w, el.src, el.dst, 2, device="cpu",
                              masks=np.ones((2, el.E), bool),
                              plan=ExecutionPlan(faults=fm))
    with pytest.raises(ValueError, match="sparse"):
        tb.run_byzantine_learning(_byz_model(tsig), _byz_cfg(tg, tb, tat), 2,
                                  core="dense", device="cpu",
                                  plan=ExecutionPlan(faults=fm))
    with pytest.raises(ValueError, match="does not support .*'store'"):
        tp.run_pushsum_sparse(w, el.src, el.dst, 2, device="cpu",
                              plan=ExecutionPlan(store="final"))
    with pytest.raises(ValueError, match="does not support .*'dst_sorted'"):
        th.run_hps(w, th.HPSConfig(_hier(tg), 4), 2, device="cpu",
                   plan=ExecutionPlan(dst_sorted=True))
    with pytest.raises(ValueError, match="does not support .*'dst_sorted'"):
        tsoc.run_social_learning(
            tsig.make_confused_model(N=18, m=3, seed=0),
            th.HPSConfig(_hier(tg), 4), 2, device="cpu",
            plan=ExecutionPlan(dst_sorted=True))
