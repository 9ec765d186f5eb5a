"""Scenario batching in the port (``repro_torch.core.sweeps``) against
``repro.core.sweeps``: the batched link masks, the block-diagonal stacking,
the push-sum sweep and the HPS and social grids and sweeps, their stores,
coordinates, ``describe()`` and validation.

Tolerances. The link masks are bit-equal (threefry port, a batch of keys
in one pass). A row against the reference's vmapped row: HPS within rtol
1e-4 / atol 1e-5, and push-sum the same, as ``tests/test_torch_hps.py``
holds a single run; Alg. 3 beliefs within atol 1e-3, log ratios within
rtol 1e-3 / atol 1e-2 and the argmax decisions equal, as
``tests/test_torch_social.py`` holds a single run (XLA contracts
multiply-adds in the jitted scan). A row against the port's own
single-scenario run of the same scenario is bit-equal: the same
operations, each receiver's increments added in edge order in its own
block, each scenario's fusion pool summed over its own N rows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import repro.core.graphs as jg
import repro.core.hps as jh
import repro.core.pushsum as jp
import repro.core.signals as jsig
import repro.core.social as jsoc
import repro.core.sweeps as js
import repro.core.asyncrony as jas
import repro.core.faults as jfa
import repro.core.plan as jplan
import repro_torch.core.graphs as tg
import repro_torch.core.signals as tsig
from repro_torch.core import hps as th
from repro_torch.core import social as tsoc
from repro_torch.core import sweeps as ts
from repro_torch.core import asyncrony as tas
from repro_torch.core import faults as tfa
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.prng import Key, fold_rounds, prng_key
from repro_torch.core.pushsum import edge_mask, run_pushsum_sparse
from repro_torch.core.pushsum import step_edge_mask

HPS_TOL = dict(rtol=1e-4, atol=1e-5)
T_GRID = 25


def _hps_topos(g):
    """tests/test_hps_engine.py's grid fixture: 4 hierarchies over N = 18
    with M in {3, 2, 6} and different edge counts."""
    return [
        g.make_hierarchy([6, 6, 6], topology="complete", seed=0),
        g.make_hierarchy([6, 6, 6], topology="ring+", extra_edge_prob=0.8,
                         seed=1),
        g.make_hierarchy([9, 9], topology="complete", seed=2),
        g.make_hierarchy([3] * 6, topology="complete", seed=3),
    ]


def _hps_cfgs(kind, g, C):
    if kind == "mixed":     # 16 configs, mixed E and M
        return [C(topo=t, gamma_period=gm, B=2, drop_prob=d)
                for t in _hps_topos(g) for gm in (4, 8) for d in (0.0, 0.3)]
    topo = g.make_hierarchy([6, 6, 6], topology="complete", seed=0)
    return [C(topo=topo, gamma_period=gm, B=2, drop_prob=d)
            for d in (0.0, 0.4, 0.8) for gm in (3, 8)]


def _social_cfgs(kind, g, C):
    """tests/test_social_engine.py's sizes: two ring+ draws over 3 x 6
    (mixed E) x 3 drops x 2 Γ, or one 3 x 6 complete topology."""
    if kind == "mixed":
        topos = [g.make_hierarchy([6, 6, 6], topology="ring+",
                                  extra_edge_prob=0.8, seed=s)
                 for s in range(2)]
        return [C(topo=t, gamma_period=gm, B=2, drop_prob=d)
                for t in topos for d in (0.0, 0.3, 0.6) for gm in (4, 8)]
    topo = g.make_hierarchy([6, 6, 6], topology="complete", seed=0)
    return [C(topo=topo, gamma_period=gm, B=2, drop_prob=d)
            for d in (0.0, 0.4, 0.8) for gm in (3, 8)]


def _model(mod):
    return mod.make_confused_model(N=18, m=3, truth=1, confusion=0.3, seed=0)


def _w():
    return np.random.default_rng(0).normal(size=(18, 3)).astype(np.float32)


SEEDS = {"mixed": [1, 2], "uniform": [0, 3]}


@pytest.fixture(scope="module")
def hps_runs():
    """Port and reference grids, each computed once for the module."""
    out = {}
    for kind in ("mixed", "uniform"):
        tc = _hps_cfgs(kind, tg, th.HPSConfig)
        jc = _hps_cfgs(kind, jg, jh.HPSConfig)
        got = ts.run_hps_grid(_w(), tc, T_GRID, SEEDS[kind], device="cpu")
        want = js.run_hps_grid(_w(), jc, T=T_GRID, seeds=SEEDS[kind])
        out[kind] = (tc, got, want)
    return out


@pytest.fixture(scope="module")
def social_runs():
    out = {}
    for kind in ("mixed", "uniform"):
        tc = _social_cfgs(kind, tg, th.HPSConfig)
        jc = _social_cfgs(kind, jg, jh.HPSConfig)
        got = ts.run_social_grid(_model(tsig), tc, T_GRID, SEEDS[kind],
                                 device="cpu")
        want = js.run_social_grid(_model(jsig), jc, T=T_GRID,
                                  seeds=SEEDS[kind])
        out[kind] = (tc, got, want)
    return out


def _pushsum_case():
    """2 graph draws x 2 drops x 2 seeds at n = 32, dst-sorted."""
    rng = np.random.default_rng(0)
    adjs = [jg.random_strongly_connected(32, 0.1, rng) for _ in range(2)]
    w = rng.normal(size=(32, 4)).astype(np.float32)
    return adjs, w, dict(drop_probs=[0.0, 0.5], seeds=[0, 7], B=4)


@pytest.fixture(scope="module")
def pushsum_runs():
    adjs, w, kw = _pushsum_case()
    tel = tg.sort_by_dst(tg.stack_edge_lists(adjs))[0]
    jel = jg.sort_by_dst(jg.stack_edge_lists(adjs))[0]
    return (tel, w, kw, ts.run_pushsum_sweep(w, tel, 30, device="cpu", **kw),
            js.run_pushsum_sweep(w, jel, 30, **kw))


def _same_coords(got, want, names):
    assert got.K == want.K and got._fields == want._fields
    for name in names:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    assert got.fault is None and got.async_ is None
    assert got.describe() == want.describe()


# ---- (a) batched link masks ----

@pytest.mark.parametrize("domain", ["pushsum", "hps", "social_link",
                                    "social_signal"])
def test_batched_masks_are_bit_equal(domain):
    """K keys folded for every round at once, each round's K masks drawn in
    one pass: bit-equal to the reference's vmapped draw, and to the port's
    one-key draw row by row."""
    seeds = np.array([0, 5, 11, 2**32 - 1], np.int64)
    drops = np.array([0.0, 0.3, 0.6, 0.9], np.float32)
    Bs = np.array([1, 2, 4, 3], np.int32)
    fold = {"pushsum": lambda t: t, "hps": jh.hps_stream_fold,
            "social_link": lambda t: jsoc.social_stream_fold(t, 0),
            "social_signal": lambda t: jsoc.social_stream_fold(t, 1)}[domain]
    T, E = 12, 53
    keys = fold_rounds(Key(np.zeros_like(seeds), seeds),
                       [int(fold(t)) for t in range(T)], "cpu")
    assert keys.k0.shape == (T, 4, 1)
    jkeys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.uint32))
    dp, Bt = torch.from_numpy(drops), torch.from_numpy(Bs)
    for t in range(T):
        got = edge_mask(Key(keys.k0[t], keys.k1[t]), t, E, dp, Bt)
        want = jax.vmap(lambda k, d, b, t=t: jp.step_edge_mask(
            k, jnp.int32(t), E, d, b, fold_t=fold(t)))(
                jkeys, jnp.asarray(drops), jnp.asarray(Bs))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).reshape(-1))
        # a batch of unfolded keys through step_edge_mask: the same bits
        batch = Key(torch.zeros(4, 1, dtype=torch.int64),
                    torch.from_numpy(seeds)[:, None])
        assert torch.equal(step_edge_mask(batch, t, E, dp, Bt,
                                          fold_t=int(fold(t))), got)
        for k, s in enumerate(seeds):
            one = step_edge_mask(prng_key(int(s)), t, E, dp[k], Bt[k],
                                 fold_t=int(fold(t)))
            assert torch.equal(one, got[k * E:(k + 1) * E])


# ---- (b) the block-diagonal stacking ----

@pytest.mark.parametrize("engine", ["hps", "social"])
def test_stack_runtimes_is_one_block_diagonal_graph(engine):
    make = th.make_hps_runtime if engine == "hps" else tsoc.make_social_runtime
    cfgs = _hps_cfgs("mixed", tg, th.HPSConfig)[::3]
    e_max = max(int(np.count_nonzero(c.topo.adj)) for c in cfgs)
    rts = [make(c, e_max=e_max) for c in cfgs]
    st = ts.stack_runtimes(rts)
    K, N, E = len(rts), 18, e_max
    assert type(st) is type(rts[0])
    assert st.src.shape == (K * E,) and st.rep_mask.shape == (K * N,)
    assert st.offsets.shape == (K * N + 1,)
    for k, rt in enumerate(rts):
        sl = slice(k * E, (k + 1) * E)
        assert torch.equal(st.src[sl], rt.src + k * N)
        assert torch.equal(st.dst[sl], rt.dst + k * N)
        assert torch.equal(st.valid[sl], rt.valid)
        assert torch.equal(st.rep_mask[k * N:(k + 1) * N], rt.rep_mask)
        assert torch.equal(st.offsets[k * N:(k + 1) * N + 1],
                           rt.offsets + k * E)
        for f in rt._fields[5:]:
            assert getattr(st, f).shape == (K,)
            assert getattr(st, f)[k] == getattr(rt, f)
    # one CSR over the K·N receivers of a still-sorted index
    assert (st.dst[1:] >= st.dst[:-1]).all()
    assert torch.equal(st.offsets, torch.searchsorted(
        st.dst, torch.arange(K * N + 1, dtype=torch.int32)).to(torch.int32))
    with pytest.raises(ValueError, match="edge count"):
        ts.stack_runtimes([rts[0], make(cfgs[0], e_max=e_max + 1)])
    with pytest.raises(ValueError, match="single-scenario"):
        ts.stack_runtimes([st])


# ---- (c) the HPS grid ----

@pytest.mark.parametrize("kind", ["mixed", "uniform"])
def test_hps_grid_matches_reference(hps_runs, kind):
    cfgs, got, want = hps_runs[kind]
    assert got.ratio.shape == (len(cfgs) * 2, 18, 3)
    assert got.gap.shape == (len(cfgs) * 2, T_GRID)
    np.testing.assert_allclose(got.ratio.numpy(), np.asarray(want.ratio),
                               **HPS_TOL)
    np.testing.assert_allclose(got.gap.numpy(), np.asarray(want.gap),
                               **HPS_TOL)
    _same_coords(got, want, ("drop_prob", "gamma", "M", "seed", "cfg"))
    if kind == "mixed":
        assert set(got.M.tolist()) == {2, 3, 6}


@pytest.mark.parametrize("kind", ["mixed", "uniform"])
def test_hps_grid_rows_equal_single_runs(hps_runs, kind):
    """Every row bit-equal to the port's single run: on the e_max-padded
    runtime for the mixed-E grid, through ``run_hps`` on the uniform one."""
    cfgs, got, _ = hps_runs[kind]
    e_max = max(int(np.count_nonzero(c.topo.adj)) for c in cfgs)
    plan = ExecutionPlan(store="gap")
    for k in range(got.K):
        cfg, seed = cfgs[int(got.cfg[k])], int(got.seed[k])
        if kind == "mixed":
            one = th.run_hps_runtime(_w(), th.make_hps_runtime(cfg, e_max),
                                     T_GRID, seed=seed, plan=plan,
                                     device="cpu")
        else:
            one = th.run_hps(_w(), cfg, T_GRID, seed=seed, plan=plan,
                             device="cpu")
        assert torch.equal(got.ratio[k], one.ratio), k
        assert torch.equal(got.gap[k], one.gap), k


def test_hps_grid_curves_lie_under_theorem1_bound():
    """tests/test_hps_engine.py's Theorem 1 acceptance as one grid: 2 x 4
    complete networks, Γ 2/4 x drop 0/0.3 x B 1/2, seeds 0 and 1."""
    topo = tg.make_hierarchy([4, 4], topology="complete", seed=5)
    w = np.random.default_rng(3).normal(size=(8, 2)).astype(np.float32)
    cfgs = [th.HPSConfig(topo=topo, gamma_period=g, B=b, drop_prob=dp)
            for g in (2, 4) for dp in (0.0, 0.3) for b in (1, 2)]
    res = ts.run_hps_grid(w, cfgs, 300, [0, 1], device="cpu")
    assert res.K == 16
    for k in range(res.K):
        cfg = cfgs[int(res.cfg[k])]
        bound = np.asarray([th.theorem1_bound(cfg, w, t)
                            for t in range(300)])
        assert (res.gap[k].numpy() <= bound + 1e-6).all(), k


# ---- (d) the social grid ----

@pytest.mark.parametrize("kind", ["mixed", "uniform"])
def test_social_grid_matches_reference(social_runs, kind):
    cfgs, got, want = social_runs[kind]
    assert got.beliefs.shape == (len(cfgs) * 2, 18, 3)
    assert got.log_ratio.shape == (len(cfgs) * 2, T_GRID)
    np.testing.assert_allclose(got.beliefs.numpy(), np.asarray(want.beliefs),
                               atol=1e-3)
    np.testing.assert_allclose(got.log_ratio.numpy(),
                               np.asarray(want.log_ratio), rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_array_equal(got.beliefs.numpy().argmax(-1),
                                  np.asarray(want.beliefs).argmax(-1))
    _same_coords(got, want, ("drop_prob", "gamma", "seed", "cfg"))


@pytest.mark.parametrize("kind", ["mixed", "uniform"])
def test_social_grid_rows_equal_single_runs(social_runs, kind):
    """Every row bit-equal to the port's single run with ``signal_seed``
    equal to the seed: on the e_max-padded runtime for the mixed-E grid,
    through ``run_social_learning`` on the uniform one."""
    cfgs, got, _ = social_runs[kind]
    e_max = max(int(np.count_nonzero(c.topo.adj)) for c in cfgs)
    plan = ExecutionPlan(store="log_ratio")
    model = _model(tsig)
    for k in range(got.K):
        cfg, seed = cfgs[int(got.cfg[k])], int(got.seed[k])
        if kind == "mixed":
            one = tsoc.run_social_runtime(
                model, tsoc.make_social_runtime(cfg, e_max), 3, T_GRID,
                seed=seed, signal_seed=seed, plan=plan, device="cpu")
        else:
            one = tsoc.run_social_learning(model, cfg, T_GRID, seed=seed,
                                           signal_seed=seed, plan=plan,
                                           device="cpu")
        assert torch.equal(got.beliefs[k], one.beliefs), k
        assert torch.equal(got.log_ratio[k], one.log_ratio), k


# ---- (e) the push-sum sweep ----

def test_pushsum_sweep_matches_reference(pushsum_runs):
    _, _, _, got, want = pushsum_runs
    assert got.err.shape == (8, 30) and got.final_ratio.shape == (8, 32, 4)
    assert got.mass_gap.shape == (8, 4)
    for name in ("err", "final_ratio", "mass_gap"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, **HPS_TOL)
    _same_coords(got, want, ("drop_prob", "seed", "graph"))
    assert (got.err[:, -1] < got.err[:, 0]).all()


def test_pushsum_sweep_rows_equal_single_runs(pushsum_runs):
    """Each row bit-equal to ``run_pushsum_sparse`` on its draw with
    ``key=prng_key(seed)``: every frame's worst error and the final
    ratios; its mass gap equal to the single run's invariant."""
    el, w, _, got, _ = pushsum_runs
    target = torch.from_numpy(w).mean(0)
    for k in range(got.K):
        g = int(got.graph[k])
        fin, traj = run_pushsum_sparse(
            w, el.src[g], el.dst[g], 30, drop_prob=float(got.drop_prob[k]),
            B=4, key=prng_key(int(got.seed[k])), valid=el.valid[g],
            device="cpu")
        assert torch.equal(got.final_ratio[k], traj[-1]), k
        assert torch.equal(got.err[k],
                           (traj - target).abs().amax(dim=(1, 2))), k
        inv = (fin.z.sum(0) + ((fin.sigma[torch.from_numpy(el.src[g]).long()]
                                - fin.rho) * torch.from_numpy(
                                    el.valid[g])[:, None]).sum(0))
        assert torch.equal(got.mass_gap[k], inv - torch.from_numpy(w).sum(0))


def test_pushsum_sweep_single_graph_and_scalar_axes():
    """A single (unbatched) graph is one draw; scalar drop and seed are
    one level each; an unsorted index runs on the plain path but fails
    ``plan.dst_sorted``."""
    adjs, w, _ = _pushsum_case()
    el = tg.edge_list(adjs[0])
    got = ts.run_pushsum_sweep(w, el, 6, drop_probs=0.2, seeds=3,
                               device="cpu")
    want = js.run_pushsum_sweep(w, jg.edge_list(adjs[0]), 6,
                                drop_probs=0.2, seeds=3)
    assert got.K == 1 and got.err.shape == (1, 6)
    np.testing.assert_allclose(got.final_ratio.numpy(),
                               np.asarray(want.final_ratio), **HPS_TOL)
    _same_coords(got, want, ("drop_prob", "seed", "graph"))
    with pytest.raises(ValueError, match="dst-sorted"):
        ts.run_pushsum_sweep(w, el, 2, device="cpu",
                             plan=ExecutionPlan(dst_sorted=True))
    with pytest.raises(ValueError, match="rows"):
        ts.run_pushsum_sweep(w[:5], el, 2, device="cpu")


# ---- (f) stores, K = 1, T = 0, coordinates ----

@pytest.mark.parametrize("engine,store", [
    ("hps", "trajectory"), ("hps", "final"),
    ("social", "trajectory"), ("social", "final")])
def test_other_stores_match_reference_shapes_and_rows(engine, store):
    """The stores besides the default: the reference's shapes and values,
    and row 1 equal to the port's single run of that store."""
    if engine == "hps":
        cfg = th.HPSConfig(tg.make_hierarchy([6, 6, 6], "complete", seed=0),
                           gamma_period=4, B=2, drop_prob=0.3)
        jcfg = jh.HPSConfig(jg.make_hierarchy([6, 6, 6], "complete", seed=0),
                            gamma_period=4, B=2, drop_prob=0.3)
        got = ts.run_hps_sweep(_w(), cfg, 15, seeds=[0, 1], device="cpu",
                               plan=ExecutionPlan(store=store))
        want = js.run_hps_sweep(_w(), jcfg, T=15, seeds=[0, 1],
                                plan=jh.ExecutionPlan(store=store))
        one = th.run_hps(_w(), cfg, 15, seed=1, device="cpu",
                         plan=ExecutionPlan(store=store))
        pairs = [(got.ratio, want.ratio, one.ratio),
                 (got.gap, want.gap, one.gap)]
        tol = [HPS_TOL, HPS_TOL]
    else:
        cfg = th.HPSConfig(tg.make_hierarchy([6, 6, 6], "complete", seed=0),
                           gamma_period=4, B=2, drop_prob=0.3)
        jcfg = jh.HPSConfig(jg.make_hierarchy([6, 6, 6], "complete", seed=0),
                            gamma_period=4, B=2, drop_prob=0.3)
        got = ts.run_social_sweep(_model(tsig), cfg, 15, seeds=[0, 1],
                                  device="cpu",
                                  plan=ExecutionPlan(store=store))
        want = js.run_social_sweep(_model(jsig), jcfg, T=15, seeds=[0, 1],
                                   plan=jh.ExecutionPlan(store=store))
        one = tsoc.run_social_learning(_model(tsig), cfg, 15, seed=1,
                                       signal_seed=1, device="cpu",
                                       plan=ExecutionPlan(store=store))
        pairs = [(got.beliefs, want.beliefs, one.beliefs),
                 (got.log_ratio, want.log_ratio, one.log_ratio)]
        tol = [dict(atol=1e-3), dict(rtol=1e-3, atol=1e-2)]
    for (g, w_, o), t in zip(pairs, tol):
        assert tuple(g.shape) == np.asarray(w_).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **t)
        assert torch.equal(g[1], o)
    assert got.describe() == want.describe()


@pytest.mark.parametrize("engine", ["hps", "social", "pushsum"])
def test_one_scenario_grid_equals_the_single_run(engine):
    cfg = th.HPSConfig(tg.make_hierarchy([4, 5], "ring+", seed=2),
                       gamma_period=3, B=2, drop_prob=0.4)
    w = np.random.default_rng(1).normal(size=(9, 2)).astype(np.float32)
    if engine == "hps":
        got = ts.run_hps_grid(w, [cfg], 20, 5, device="cpu")
        one = th.run_hps(w, cfg, 20, seed=5, device="cpu",
                         plan=ExecutionPlan(store="gap"))
        pairs = [(got.ratio, one.ratio), (got.gap, one.gap)]
    elif engine == "social":
        model = tsig.make_confused_model(N=9, m=3, truth=2, seed=1)
        got = ts.run_social_grid(model, [cfg], 20, 5, device="cpu")
        one = tsoc.run_social_learning(model, cfg, 20, seed=5, signal_seed=5,
                                       device="cpu",
                                       plan=ExecutionPlan(store="log_ratio"))
        pairs = [(got.beliefs, one.beliefs), (got.log_ratio, one.log_ratio)]
    else:
        el = cfg.edge_index()
        got = ts.run_pushsum_sweep(w, el, 20, drop_probs=0.4, seeds=5, B=2,
                                   device="cpu")
        _, traj = run_pushsum_sparse(w, el.src, el.dst, 20, drop_prob=0.4,
                                     B=2, key=prng_key(5), record_every=20,
                                     device="cpu")
        pairs = [(got.final_ratio, traj[0])]
    assert got.K == 1
    for a, b in pairs:
        assert a.shape == (1, *b.shape) and torch.equal(a[0], b)


@pytest.mark.parametrize("engine,store", [
    ("hps", "trajectory"), ("hps", "gap"), ("hps", "final"),
    ("social", "trajectory"), ("social", "log_ratio"), ("social", "final"),
    ("pushsum", None)])
def test_zero_rounds(engine, store):
    cfg = th.HPSConfig(tg.make_hierarchy([3, 3], "complete", seed=0), 2)
    w = _w()[:6]
    plan = ExecutionPlan(store=store)
    if engine == "hps":
        res = ts.run_hps_sweep(w, cfg, 0, drop_probs=[0.0, 0.5], seeds=[0],
                               plan=plan, device="cpu")
        shapes = {"trajectory": ((2, 0, 6, 3), (2, 0)),
                  "gap": ((2, 6, 3), (2, 0)), "final": ((2, 6, 3), (2,))}
        assert (tuple(res.ratio.shape), tuple(res.gap.shape)) == shapes[store]
        if store != "trajectory":     # the ratios are w itself
            assert torch.equal(res.ratio[1], torch.from_numpy(w))
    elif engine == "social":
        res = ts.run_social_sweep(tsig.make_confused_model(6, 3, seed=0), cfg,
                                  0, drop_probs=[0.0, 0.5], seeds=[0],
                                  plan=plan, device="cpu")
        shapes = {"trajectory": ((2, 0, 6, 3), (2, 0, 6, 3)),
                  "log_ratio": ((2, 6, 3), (2, 0)),
                  "final": ((2, 6, 3), (2, 6, 3))}
        assert ((tuple(res.beliefs.shape), tuple(res.log_ratio.shape))
                == shapes[store])
    else:
        res = ts.run_pushsum_sweep(w, cfg.edge_index(), 0,
                                   drop_probs=[0.0, 0.5], device="cpu")
        assert res.err.shape == (2, 0)
        assert torch.equal(res.final_ratio[0], torch.from_numpy(w))
        assert torch.equal(res.mass_gap, torch.zeros((2, 3)))
    assert res.K == 2


@pytest.mark.parametrize("engine", ["hps", "social"])
def test_sweep_cross_product_coordinates(engine):
    """Base-major, then drop, then Γ, then seed, as the reference."""
    cfg = th.HPSConfig(tg.make_hierarchy([6, 6, 6], "complete", seed=0),
                       gamma_period=8, B=2)
    kw = dict(drop_probs=[0.0, 0.5], gammas=[2, 8], seeds=[0, 1, 2])
    if engine == "hps":
        res = ts.run_hps_sweep(_w(), [cfg, cfg], 3, device="cpu", **kw)
    else:
        res = ts.run_social_sweep(_model(tsig), [cfg, cfg], 3, device="cpu",
                                  **kw)
    assert res.K == 24
    rows = [(int(res.cfg[k]), float(res.drop_prob[k]), int(res.gamma[k]),
             int(res.seed[k])) for k in range(res.K)]
    assert rows == [(b * 4 + di * 2 + gi, d, g, s)
                    for b in range(2) for di, d in enumerate((0.0, 0.5))
                    for gi, g in enumerate((2, 8)) for s in (0, 1, 2)]


# ---- (g) validation and the device rule ----

@pytest.mark.parametrize("engine", ["hps", "social"])
def test_validation_errors(engine):
    good = th.HPSConfig(tg.make_hierarchy([6, 6, 6], "complete", seed=0), 4)
    other_n = th.HPSConfig(tg.make_hierarchy([5, 5, 5], "complete"), 4)
    if engine == "hps":
        def run(cfgs, **kw):
            return ts.run_hps_grid(_w(), cfgs, 5, [0], device="cpu", **kw)
        with pytest.raises(ValueError, match="share"):
            ts.run_hps_grid(_w()[:9], [good], 5, [0], device="cpu")
    else:
        def run(cfgs, **kw):
            return ts.run_social_grid(_model(tsig), cfgs, 5, [0],
                                      device="cpu", **kw)
        other_m = th.HPSConfig(tg.make_hierarchy([9, 9], "complete"), 4)
        with pytest.raises(ValueError, match="share"):
            run([good, other_m])
    with pytest.raises(ValueError, match="share"):
        run([good, other_n])
    with pytest.raises(ValueError, match="store"):
        run([good], plan=ExecutionPlan(store="bogus"))
    with pytest.raises(ValueError, match="at least one"):
        run([])


def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = th.HPSConfig(tg.make_hierarchy([3, 3], "complete", seed=0), 2)
    w = _w()[:6]
    model = tsig.make_confused_model(6, 3, seed=0)
    calls = [lambda: ts.run_hps_grid(w, [cfg], 2, [0]),
             lambda: ts.run_hps_sweep(w, cfg, 2),
             lambda: ts.run_social_grid(model, [cfg], 2, [0]),
             lambda: ts.run_social_sweep(model, cfg, 2),
             lambda: ts.run_pushsum_sweep(w, cfg.edge_index(), 2),
             lambda: ts.run_hps_grid(w, [cfg], 2, [0], device="cuda")]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ts.run_hps_grid(w, [cfg], 2, [0], device="cpu",
                        plan=ExecutionPlan(backend="cuda"))


# ---- (h) the fault and async axes ----

def _fault_models(mod):
    """The degenerate model, then benchmarks/chaos.py:52-56's four
    (burst 8 or 32 x churn 0.1 or 0.3, half the time bad, a coin-flip
    PS, rejoin 0.25)."""
    return [mod.make_fault_model()] + [
        mod.gilbert_elliott_model(L, 0.5, leave_prob=c, join_prob=0.25,
                                  ps_crash_prob=0.5)
        for L in (8.0, 32.0) for c in (0.1, 0.3)]


def _async_models(mod):
    return [mod.make_async_model(1.0, 0), mod.make_async_model(0.6, 8)]


def _plans(n_faults=5, n_async=2):
    jf_ = _fault_models(jfa)[:n_faults] if n_faults else None
    tf_ = _fault_models(tfa)[:n_faults] if n_faults else None
    ja_ = _async_models(jas)[:n_async] if n_async else None
    ta_ = _async_models(tas)[:n_async] if n_async else None
    return dict(faults=jf_, async_=ja_), dict(faults=tf_, async_=ta_)


def _plane_coords(got, want, names):
    for name in names + ("fault", "async_"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    assert got.describe() == want.describe()


@pytest.fixture(scope="module")
def plane_runs():
    """The push-sum sweep on one draw x 2 drops x 2 seeds x 5 faults x 2
    async models (K = 40), and the social grid of the uniform configs x
    one seed x 5 faults x 2 async models (K = 60), port and reference."""
    adjs, w, kw = _pushsum_case()
    kw = dict(kw)
    tel = tg.sort_by_dst(tg.edge_list(adjs[0]))[0]
    jel = jg.sort_by_dst(jg.edge_list(adjs[0]))[0]
    jp_, tp_ = _plans()
    ps = (tel, w, kw,
          ts.run_pushsum_sweep(w, tel, 20, device="cpu",
                               plan=ExecutionPlan(**tp_), **kw),
          js.run_pushsum_sweep(w, jel, 20, plan=jplan.ExecutionPlan(**jp_),
                               **kw))
    tc = _social_cfgs("uniform", tg, th.HPSConfig)
    jc = _social_cfgs("uniform", jg, jh.HPSConfig)
    soc = (tc,
           ts.run_social_grid(_model(tsig), tc, T_GRID, [3], device="cpu",
                              plan=ExecutionPlan(store="final", **tp_)),
           js.run_social_grid(_model(jsig), jc, T_GRID, [3],
                              plan=jplan.ExecutionPlan(store="final", **jp_)))
    return ps, soc


def test_pushsum_sweep_fault_and_async_axes_match_reference(plane_runs):
    (_, _, _, got, want), _ = plane_runs
    assert got.K == 40
    _plane_coords(got, want, ("drop_prob", "seed", "graph"))
    np.testing.assert_array_equal(got.fault.numpy(),
                                  np.repeat(np.tile(np.arange(5), 4), 2))
    np.testing.assert_array_equal(got.async_.numpy(), np.tile([0, 1], 20))
    for name in ("err", "final_ratio", "mass_gap"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, rtol=1e-4, atol=1e-4)
    assert torch.isfinite(got.err).all()


def test_social_grid_fault_and_async_axes_match_reference(plane_runs):
    _, (_, got, want) = plane_runs
    assert got.K == 60
    _plane_coords(got, want, ("drop_prob", "gamma", "seed", "cfg"))
    # beliefs and decisions where the top two beliefs are more than 1e-2
    # apart (chip_smoke.py's rule): a drained mass magnifies one ulp of z
    gb, wb = got.beliefs.numpy(), np.asarray(want.beliefs)
    top2 = np.sort(wb, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-2
    assert clear.mean() > 0.8
    np.testing.assert_array_equal(gb.argmax(-1)[clear], wb.argmax(-1)[clear])
    np.testing.assert_allclose(gb[clear], wb[clear], atol=1e-3)


def test_plane_rows_equal_single_runs(plane_runs):
    """Each crossed row bit-equal to the port's single run under its own
    fault and async model (the social grid, every fifth row; the push-sum
    sweep, every row)."""
    (el, w, kw, ps, _), (cfgs, soc, _) = plane_runs
    fms, ams = _fault_models(tfa), _async_models(tas)
    for k in range(ps.K):
        _, traj = run_pushsum_sparse(
            w, el.src, el.dst, 20, drop_prob=float(ps.drop_prob[k]), B=4,
            key=prng_key(int(ps.seed[k])), device="cpu",
            record_every=20, plan=ExecutionPlan(
                faults=fms[int(ps.fault[k])], async_=ams[int(ps.async_[k])]))
        assert torch.equal(ps.final_ratio[k], traj[-1]), k
    model = _model(tsig)
    for k in range(0, soc.K, 5):
        one = tsoc.run_social_learning(
            model, cfgs[int(soc.cfg[k])], T_GRID, seed=3, signal_seed=3,
            device="cpu", plan=ExecutionPlan(
                store="final", faults=fms[int(soc.fault[k])],
                async_=ams[int(soc.async_[k])]))
        assert torch.equal(soc.beliefs[k], one.beliefs), k


def test_hps_sweep_fault_and_async_axes_match_reference():
    topo_t, topo_j = (g.make_hierarchy([6, 6, 6], topology="complete",
                                       seed=0) for g in (tg, jg))
    jp_, tp_ = _plans(n_faults=3)
    got = ts.run_hps_sweep(_w(), th.HPSConfig(topo_t, 4, B=2), T_GRID,
                           drop_probs=[0.1, 0.4], seeds=[0], device="cpu",
                           plan=ExecutionPlan(**tp_))
    want = js.run_hps_sweep(_w(), jh.HPSConfig(topo_j, 4, B=2), T_GRID,
                            drop_probs=[0.1, 0.4], seeds=[0],
                            plan=jplan.ExecutionPlan(**jp_))
    assert got.K == 12
    _plane_coords(got, want, ("drop_prob", "gamma", "M", "seed", "cfg"))
    np.testing.assert_allclose(got.gap.numpy(), np.asarray(want.gap),
                               atol=1e-4)
    np.testing.assert_allclose(got.ratio.numpy(), np.asarray(want.ratio),
                               rtol=1e-4, atol=1e-4)


def test_batched_degenerate_async_row_matches_the_sync_rows(pushsum_runs):
    """The degenerate model on a grid's async axis runs the buffered
    loop; its rows hold to the synchronous sweep's (the reference's
    tolerance, tests/test_async.py:318-333)."""
    el, w, kw, sync, _ = pushsum_runs
    got = ts.run_pushsum_sweep(w, el, 30, device="cpu", plan=ExecutionPlan(
        async_=[tas.make_async_model(), tas.make_async_model(0.5, 1)]), **kw)
    np.testing.assert_allclose(got.err[0::2].numpy(), sync.err.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.final_ratio[0::2].numpy(),
                               sync.final_ratio.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_single_models_as_axes():
    """One degenerate async model adds no axis; one fault model is an
    axis of one level (the column all zeros)."""
    adjs, w, kw = _pushsum_case()
    el = tg.sort_by_dst(tg.edge_list(adjs[0]))[0]
    res = ts.run_pushsum_sweep(w, el, 4, device="cpu", plan=ExecutionPlan(
        async_=tas.make_async_model(), faults=tfa.make_fault_model()), **kw)
    assert res.async_ is None and res.K == 4
    assert res.fault.tolist() == [0, 0, 0, 0]
    res = ts.run_pushsum_sweep(w, el, 4, device="cpu", plan=ExecutionPlan(
        async_=tas.make_async_model(0.5, 1)), **kw)
    assert res.fault is None and res.async_.tolist() == [0, 0, 0, 0]
    with pytest.raises(ValueError, match="at least one"):
        ts.run_pushsum_sweep(w, el, 4, device="cpu",
                             plan=ExecutionPlan(faults=[]), **kw)


def test_grids_reject_unsupported_plan_fields():
    cfgs = _hps_cfgs("uniform", tg, th.HPSConfig)[:1]
    for call in (
            lambda p: ts.run_hps_grid(_w(), cfgs, 2, [0], device="cpu",
                                      plan=p),
            lambda p: ts.run_social_sweep(_model(tsig), cfgs[0], 2,
                                          device="cpu", plan=p)):
        with pytest.raises(ValueError, match="does not support"):
            call(ExecutionPlan(dst_sorted=True))
