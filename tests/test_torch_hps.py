"""Algorithm 1 (hierarchical push-sum) in the port against ``repro.core.hps``:
the ``~t`` fold and the link masks, the engine for every store and both PS
rules, the dense reference, Theorem 1's bound, the trimmed PS pool, and the
entry points' device and plan rules.

Tolerances. The masks and the fold values are bit-equal (threefry port).
Against the reference run op by op (eager, so XLA fuses nothing across
ops) the port's ratios are bit-equal: the same float32 recursion, each
receiver's increments added in edge order, the same three-term fusion
sum. Against the reference's jitted engine they agree within rtol 1e-4 /
atol 1e-5, the reference's own tolerance between its lowerings
(``tests/test_hps_engine.py``): XLA contracts ``sigma + z * share`` and
``z * share + recv`` into fused multiply-adds there, about 1 ulp an op.
The dense reference sums each receiver's (N, N) column in the backend's
own order: the same tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import repro.core.graphs as jg
import repro.core.hps as jh
import repro.core.pushsum as jp
from repro_torch import convert
from repro_torch.core import hps as th
from repro_torch.core.graphs import hier_edge_list, make_hierarchy
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.prng import prng_key
from repro_torch.core.pushsum import (
    run_pushsum,
    run_pushsum_sparse,
    sparse_mass_invariant,
    step_edge_mask,
)

TOL = dict(rtol=1e-4, atol=1e-5)
SCENARIOS = [(0.0, 4, 1), (0.3, 8, 2), (0.6, 3, 4)]   # (drop, Γ, B)
T_RUN = 40
NEG_NAN = np.uint32(0xFFC00000).view(np.float32)


def _w(n, d=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _runtimes(kind, drop, gamma, B):
    """(reference runtime, port runtime): the HPSConfig path on 3x6 complete
    networks, or a dense-free ``hier_edge_list`` index padded by 7 edges."""
    if kind == "config":
        cfg = jh.HPSConfig(topo=jg.make_hierarchy([6, 6, 6], "complete",
                                                  seed=0),
                           gamma_period=gamma, B=B, drop_prob=drop)
        jrt = jh.make_hps_runtime(cfg)
    else:
        el, rep = jg.hier_edge_list([6, 6, 6], topology="ring+", seed=2)
        jrt = jh.hps_runtime_from_edge_list(el, rep, drop_prob=drop,
                                            gamma_period=gamma, B=B,
                                            e_max=el.E + 7)
    return jrt, convert.hps_runtime_from_numpy(*(np.asarray(x)
                                                 for x in jrt))


def _eager_reference(w, jrt, T, seed, F):
    """The reference's Algorithm 1 round, op by op: its mask draw on the
    ``hps_stream_fold`` domain, its sparse step and its fusion, eagerly."""
    key = jax.random.PRNGKey(seed)
    E = jrt.src.shape[0]
    state = jp.init_sparse_state(jnp.asarray(w), E)
    share = 1.0 / (jp._out_degree(jrt.src, jrt.valid, w.shape[0],
                                  jnp.float32) + 1.0)
    out = []
    for t in range(T):
        mask = jp.step_edge_mask(key, jnp.int32(t), E, jrt.drop_prob, jrt.B,
                                 fold_t=jh.hps_stream_fold(t))
        st = jp.sparse_pushsum_step(state, mask, jrt.src, jrt.dst, jrt.valid,
                                    "xla", share=share, dst_sorted=True)
        if (t + 1) % int(jrt.gamma) == 0:
            z, m = jh.hps_fusion(st.z, st.m, jrt.rep_mask, jrt.M, F)
            st = st._replace(z=z, m=m)
        state = st
        out.append(np.asarray(jp.sparse_ratios(state)))
    return np.stack(out)


# ---- (a) the fold and the masks ----

@pytest.mark.parametrize("drop,B", [(0.1, 4), (0.7, 1)])
def test_fold_values_and_masks_are_bit_equal(drop, B):
    E = 97
    dp = torch.tensor(drop, dtype=torch.float32)
    Bt = torch.tensor(B, dtype=torch.int32)
    for t in range(64):
        fold = th.hps_stream_fold(t)
        ref = jh.hps_stream_fold(t)
        assert np.int32(fold) == ref
        assert np.uint32(fold & 0xFFFFFFFF) == np.asarray(ref).view(np.uint32)
        got = step_edge_mask(prng_key(11), t, E, dp, Bt, fold_t=fold)
        want = jp.step_edge_mask(jax.random.PRNGKey(11), jnp.int32(t), E,
                                 jnp.float32(drop), jnp.int32(B),
                                 fold_t=ref)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the ~t band is disjoint from the social (2t + s) and Byzantine
    # (3t + s) fold domains over the horizon
    folds = {th.hps_stream_fold(t) & 0xFFFFFFFF for t in range(10_000)}
    assert not folds & set(range(3 * 10_000 + 3))


# ---- (b) the engine against the reference ----

@pytest.mark.parametrize("kind", ["config", "padded"])
@pytest.mark.parametrize("F", [0, 1])
@pytest.mark.parametrize("drop,gamma,B", SCENARIOS)
def test_engine_matches_reference_for_every_store(kind, F, drop, gamma, B):
    jrt, rt = _runtimes(kind, drop, gamma, B)
    w = _w(18)
    shapes = {"trajectory": ((T_RUN, 18, 3), (T_RUN,)),
              "gap": ((18, 3), (T_RUN,)), "final": ((18, 3), ())}
    for store, (r_shape, g_shape) in shapes.items():
        got = th.run_hps_runtime(w, rt, T_RUN, seed=3, F=F, device="cpu",
                                 plan=ExecutionPlan(store=store,
                                                    dst_sorted=True))
        ref = jh.run_hps_runtime(w, jrt, T_RUN, seed=3, F=F,
                                 plan=jh.ExecutionPlan(backend="xla",
                                                       store=store))
        assert got.ratio.shape == r_shape and got.gap.shape == g_shape
        np.testing.assert_allclose(got.ratio.numpy(), np.asarray(ref.ratio),
                                   **TOL)
        np.testing.assert_allclose(got.gap.numpy(), np.asarray(ref.gap),
                                   **TOL)
        ref_state = ref.final_state
        for f, v in got.final_state.to_numpy().items():
            np.testing.assert_allclose(v, np.asarray(getattr(ref_state, f)),
                                       err_msg=f, **TOL)
    if F == 0:      # the exact fusion conserves value and mass
        inv = sparse_mass_invariant(got.final_state, rt.src,
                                    rt.valid).numpy()
        np.testing.assert_allclose(inv[:-1], w.sum(axis=0), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(inv[-1], 18, rtol=1e-5)


@pytest.mark.parametrize("F", [0, 1])
@pytest.mark.parametrize("drop,gamma,B", SCENARIOS)
def test_engine_is_bit_equal_to_the_reference_op_by_op(F, drop, gamma, B):
    jrt, rt = _runtimes("config", drop, gamma, B)
    w = _w(18)
    got = th.run_hps_runtime(w, rt, T_RUN, seed=3, F=F, device="cpu")
    np.testing.assert_array_equal(got.ratio.numpy(),
                                  _eager_reference(w, jrt, T_RUN, 3, F))


def test_runtime_fields_match_reference_padding():
    jel, jrep = jg.hier_edge_list([5, 4, 6], topology="ring+", seed=1)
    jrt = jh.hps_runtime_from_edge_list(jel, jrep, drop_prob=0.2,
                                        gamma_period=5, B=3, e_max=jel.E + 9)
    el, rep = hier_edge_list([5, 4, 6], topology="ring+", seed=1)
    rt = th.hps_runtime_from_edge_list(el, rep, drop_prob=0.2,
                                       gamma_period=5, B=3, e_max=el.E + 9)
    for name in jh.HPSRuntime._fields:
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(jrt, name)), name)
    assert rt.M.ndim == 0 and rt.M.item() == 3
    assert rt.offsets[-1].item() == el.E + 9
    cfg = th.HPSConfig(make_hierarchy([3, 5], "ring", seed=0), 4)
    jcfg = jh.HPSConfig(jg.make_hierarchy([3, 5], "ring", seed=0), 4)
    for name in jh.HPSRuntime._fields:
        np.testing.assert_array_equal(
            getattr(th.make_hps_runtime(cfg, e_max=20), name).numpy(),
            np.asarray(getattr(jh.make_hps_runtime(jcfg, e_max=20), name)),
            name)
    np.testing.assert_array_equal(cfg.rep_mask().numpy(),
                                  np.asarray(jcfg.rep_mask()))
    np.testing.assert_array_equal(cfg.adj().numpy(), np.asarray(jcfg.adj()))


# ---- (c) the dense reference ----

def test_dense_reference_matches_reference_and_the_engine():
    topo = jg.make_hierarchy([6, 6, 6], "complete", seed=0)
    jcfg = jh.HPSConfig(topo=topo, gamma_period=4, B=2, drop_prob=0.2)
    cfg = th.HPSConfig(topo=make_hierarchy([6, 6, 6], "complete", seed=0),
                       gamma_period=4, B=2, drop_prob=0.2)
    w = _w(18, seed=1)
    final, traj = th.run_hps_dense(w, cfg, 60, seed=3, device="cpu")
    j_final, j_traj = jh.run_hps_dense(w, jcfg, 60, seed=3)
    assert traj.shape == (60, 18, 3) and final.rho.shape == (18, 18, 3)
    np.testing.assert_allclose(traj.numpy(), np.asarray(j_traj), **TOL)
    for f in jp.PushSumState._fields:
        np.testing.assert_allclose(getattr(final, f).numpy(),
                                   np.asarray(getattr(j_final, f)),
                                   err_msg=f, **TOL)
    sparse = th.run_hps(w, cfg, 60, seed=3, device="cpu")
    np.testing.assert_allclose(sparse.ratio.numpy(), traj.numpy(), **TOL)


# ---- (d) the stores agree with one another ----

@pytest.mark.parametrize("F", [0, 1])
def test_stores_are_consistent(F):
    cfg = th.HPSConfig(make_hierarchy([6, 6, 6], "ring+", seed=4), 8, B=2,
                       drop_prob=0.3)
    w = _w(18, seed=2)
    runs = {store: th.run_hps(w, cfg, 60, seed=0, F=F, device="cpu",
                              plan=ExecutionPlan(store=store))
            for store in th.HPS_STORES}
    traj, gap, fin = runs["trajectory"], runs["gap"], runs["final"]
    assert torch.equal(gap.ratio, traj.ratio[-1])
    assert torch.equal(fin.ratio, traj.ratio[-1])
    # the same ratios reduced by an exact max: equal, not merely close
    assert torch.equal(gap.gap, traj.gap)
    assert torch.equal(fin.gap, traj.gap[-1])
    for a, b in zip(gap.final_state, fin.final_state):
        assert torch.equal(a, b)


# ---- (e) Theorem 1 ----

@pytest.mark.parametrize("gamma", [2, 4])
@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_gap_curves_lie_under_theorem1_bound(gamma, drop):
    """tests/test_hps_engine.py's envelope check, run per configuration:
    4x2 complete networks, B in {1, 2}, seeds {0, 1}, T = 300."""
    topo = make_hierarchy([4, 4], topology="complete", seed=5)
    jtopo = jg.make_hierarchy([4, 4], topology="complete", seed=5)
    w = np.random.default_rng(3).normal(size=(8, 2)).astype(np.float32)
    for B in (1, 2):
        cfg = th.HPSConfig(topo, gamma_period=gamma, B=B, drop_prob=drop)
        jcfg = jh.HPSConfig(jtopo, gamma_period=gamma, B=B, drop_prob=drop)
        bound = np.asarray([th.theorem1_bound(cfg, w, t) for t in range(300)])
        want = np.asarray([jh.theorem1_bound(jcfg, w, t)
                           for t in range(300)])
        np.testing.assert_allclose(bound, want, rtol=1e-12, atol=0)
        for seed in (0, 1):
            gap = th.run_hps(w, cfg, 300, seed=seed, device="cpu",
                             plan=ExecutionPlan(store="gap")).gap.numpy()
            assert (gap <= bound + 1e-6).all(), (
                f"B={B} seed={seed}: worst excess {(gap - bound).max():.2e}")
            assert gap[-1] < 0.1 * gap[0]


# ---- the fusion and the trimmed pool ----

def test_fusion_takes_M_as_a_tensor_and_conserves_mass():
    rng = np.random.default_rng(4)
    z = torch.from_numpy(rng.normal(size=(20, 3)).astype(np.float32))
    m = torch.from_numpy(rng.random(20).astype(np.float32))
    rep = torch.zeros(20, dtype=torch.bool)
    rep[[0, 7, 13]] = True
    a = th.hps_fusion(z, m, rep, 3)
    b = th.hps_fusion(z, m, rep, torch.tensor(3, dtype=torch.int32))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    ref = jh.hps_fusion(jnp.asarray(z.numpy()), jnp.asarray(m.numpy()),
                        jnp.asarray(rep.numpy()), 3)
    for x, y in zip(a, ref):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert torch.equal(a[0][~rep], z[~rep])
    np.testing.assert_allclose(a[1].sum().item(), m.sum().item(), rtol=1e-6)
    # F > 0: the reps' (z, m) rows trimmed, half kept, the pool's half added
    t = th.hps_fusion(z, m, rep, 3, F=1)
    r = jh.hps_fusion(jnp.asarray(z.numpy()), jnp.asarray(m.numpy()),
                      jnp.asarray(rep.numpy()), 3, F=1)
    for x, y in zip(t, r):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("R", [5, 33, 200])
@pytest.mark.parametrize("F", [0, 1, 2])
@pytest.mark.parametrize("nan_row", [False, True])
def test_ps_trimmed_pool_matches_reference(R, F, nan_row):
    """One virtual receiver through the plain trim-gather, as the
    reference routes it; a valid row of sign-bit NaNs makes every
    coordinate NaN on both (its ``s * keep`` is NaN whether trimmed or
    not)."""
    rng = np.random.default_rng(R + F)
    pool = rng.normal(size=(R, 5)).astype(np.float32)
    pool[0] = 1e6                                  # a lying representative
    valid = rng.random(R) < 0.8
    valid[:3] = True
    if nan_row:
        pool[2] = NEG_NAN
    got = th.ps_trimmed_pool(torch.from_numpy(pool),
                             torch.from_numpy(valid), F).numpy()
    ref = np.asarray(jh.ps_trimmed_pool(jnp.asarray(pool),
                                        jnp.asarray(valid), F))
    assert got.shape == ref.shape == (5,)
    if nan_row:
        assert np.isnan(got).all() and np.isnan(ref).all()
        return
    kept = max(int(valid.sum()) - 2 * F, 1)
    bound = (R * np.finfo(np.float32).eps
             * np.abs(np.where(valid[:, None], pool, 0)).sum(0) / kept)
    assert (np.abs(got - ref) <= bound + 1e-6 * np.abs(ref)).all()


# ---- (h) the entry points' device and plan rules ----

def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = make_hierarchy([3, 3], topology="complete", seed=0)
    cfg = th.HPSConfig(topo=topo, gamma_period=2)
    w = _w(6)
    el = cfg.edge_index()
    calls = [lambda: th.run_hps(w, cfg, 2),
             lambda: th.run_hps_runtime(w, th.make_hps_runtime(cfg), 2,
                                        device="cuda"),
             lambda: th.run_hps_dense(w, cfg, 2),
             lambda: run_pushsum_sparse(w, el.src, el.dst, 2),
             lambda: run_pushsum(w, topo.adj, np.ones((2, 6, 6), bool))]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_plan_rules():
    topo = make_hierarchy([3, 3], topology="complete", seed=0)
    cfg = th.HPSConfig(topo=topo, gamma_period=2)
    w = _w(6)
    with pytest.raises(ValueError, match="store"):
        th.run_hps(w, cfg, 2, device="cpu",
                   plan=ExecutionPlan(store="log_ratio"))
    el = th.EdgeList(src=np.array([0, 1, 2], np.int32),
                     dst=np.array([2, 0, 1], np.int32), n=6,
                     valid=np.ones(3, bool))
    unsorted = th.hps_runtime_from_edge_list(el, topo.rep_mask(),
                                             drop_prob=0.0, gamma_period=2)
    assert unsorted.offsets is None
    with pytest.raises(ValueError, match="dst-sorted"):
        th.run_hps_runtime(w, unsorted, 2, device="cpu",
                           plan=ExecutionPlan(dst_sorted=True))
    with pytest.raises(ValueError, match="CUDA tensors"):
        th.run_hps(w, cfg, 2, device="cpu",
                   plan=ExecutionPlan(backend="cuda"))
    # the plain path accepts any edge order
    res = th.run_hps_runtime(w, unsorted, 3, device="cpu",
                             plan=ExecutionPlan(store="final"))
    assert res.ratio.shape == (6, 3) and res.gap.shape == ()
    empty = th.run_hps(w, cfg, 0, device="cpu")
    assert empty.ratio.shape == (0, 6, 3) and empty.gap.shape == (0,)
