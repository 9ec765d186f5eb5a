"""Algorithm 2's scenario batching in the port (``run_byzantine_sweep``,
``run_byzantine_grid``) against ``repro.core.sweeps``: the stacked
neighbor-list runtime, the attacks and the fusion over K scenarios, the
grid on the reference's own fixture (N = 15, F 0|1), heterogeneous Γ, the
sweep over every attack in pairwise and one-vs-rest mode, the extra-reps
branch, the dense oracle, the stores, K = 1, T = 0, ``describe()``,
validation and the device rule.

Tolerances. A row against the reference's vmapped row is held as
``tests/test_torch_byzantine.py`` holds a single run: ``r`` within rtol
2e-5 / atol 2e-3 and every decision at every step equal (XLA sums the
trimmed survivors and the attacks' means in its own order, and the port's
``normal`` is within 4 ulp of jax's). A row against the port's own single
run of its scenario is bit-equal: the same operations, each receiver's
survivors summed in its own row, each scenario's pool trimmed in its own
row and each scenario's attack value reduced over its own N agents."""
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import repro.core.attacks as ja
import repro.core.byzantine as jb
import repro.core.graphs as jg
import repro.core.signals as jsig
import repro.core.sweeps as js
import repro_torch.core.attacks as ta
import repro_torch.core.byzantine as tb
import repro_torch.core.graphs as tg
from repro_torch import convert
from repro_torch.core import sweeps as ts
from repro_torch.core.hps import ps_trimmed_pool
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.prng import Key, prng_key

RTOL, ATOL = 2e-5, 2e-3
T = 30
SEEDS = [0, 5]


def _attack(mod, name, truth=0):
    return (mod.truth_suppression(truth) if name == "truth_suppression"
            else mod.ATTACKS[name]())


def _grid_cfgs(g, b, a, gammas=(4, 4)):
    """tests/test_byz_trim_kernel.py's grid fixture (benchmarks/
    byzantine_bench.py's grid): three ring+ draws over 3 x 5 agents, F 0
    (no Byzantine agent) and F 1 (agent 1) on each; ``gammas`` the Γ of
    the F 0 and the F 1 configs (the fixture's is 4 for both)."""
    atk = a.large_value()
    topos = [g.make_hierarchy([5, 5, 5], topology="ring+",
                              extra_edge_prob=0.9, seed=s) for s in range(3)]
    cfgs = []
    for topo in topos:
        cfgs.append(b.ByzantineConfig(topo=topo, F=0, byz=(),
                                      gamma_period=gammas[0], attack=atk))
        cfgs.append(b.ByzantineConfig(topo=topo, F=1, byz=(1,),
                                      gamma_period=gammas[1], attack=atk))
    return cfgs


def _models(N=15, truth=0, seed=0):
    jm = jsig.make_confused_model(N=N, m=3, truth=truth, confusion=0.0,
                                  seed=seed)
    return jm, convert.signal_model_from_numpy(np.asarray(jm.tables), truth)


def _close(got_r, got_d, want_r, want_d):
    assert tuple(got_r.shape) == want_r.shape
    assert tuple(got_d.shape) == want_d.shape
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=RTOL,
                               atol=ATOL)


def _single(model, cfg, seed, attack, mode="pairwise", store="decisions",
            core="sparse"):
    rt, extra, n_reps = tb.make_byzantine_runtime(model, cfg)
    return tb.run_byzantine_runtime(model, rt, extra, n_reps, attack, T,
                                    seed, mode=mode, core=core,
                                    plan=ExecutionPlan(store=store),
                                    device="cpu")


@pytest.fixture(scope="module")
def grid_runs():
    """The fixture grid (Γ 4) and a heterogeneous-Γ grid (Γ 3 for F 0, 4
    for F 1) under sign_flip, pairwise and ovr, with the reference's grid
    where ``GRID_REF`` names it (every reference call compiles a scan of
    its own: one-vs-rest sign_flip is held against the reference by the
    sweep below)."""
    jm, tm = _models()
    out = {}
    for name, gammas, atk in (("fixture", (4, 4), "large_value"),
                              ("mixed_gamma", (3, 4), "sign_flip")):
        jc = _grid_cfgs(jg, jb, ja, gammas)
        tc = _grid_cfgs(tg, tb, ta, gammas)
        for mode in ("pairwise", "ovr"):
            got = ts.run_byzantine_grid(tm, tc, T, SEEDS,
                                        attack=_attack(ta, atk), mode=mode,
                                        device="cpu")
            want = (js.run_byzantine_grid(jm, jc, T, SEEDS,
                                          attack=_attack(ja, atk), mode=mode)
                    if (name, mode) in GRID_REF else None)
            out[name, mode] = (tm, tc, _attack(ta, atk), got, want)
    return out


GRIDS = [(n, m) for n in ("fixture", "mixed_gamma")
         for m in ("pairwise", "ovr")]
GRID_REF = GRIDS[:3]


# ---- the stacked runtime ----

def test_stack_runtimes_is_one_neighbor_list_graph():
    """Rows padded to the widest deg_max with invalid slots, senders and
    network offsets shifted by k·N, F and Γ (K,) host arrays; the
    reference pads a grid's rows the same way."""
    jm, tm = _models()

    def cfgs(g, b, a):     # the fixture's configs and a ring (deg_max 1)
        return _grid_cfgs(g, b, a, (3, 4)) + [b.ByzantineConfig(
            g.make_hierarchy([5, 5, 5], topology="ring", seed=0), 0, (), 6,
            a.large_value())]

    tc = cfgs(tg, tb, ta)
    rts = [tb.make_byzantine_runtime(tm, c)[0] for c in tc]
    st = ts.stack_runtimes(rts)
    K, N = len(rts), 15
    dm = max(rt.nbr_idx.shape[1] for rt in rts)
    assert dm > min(rt.nbr_idx.shape[1] for rt in rts)   # rows get padded
    assert st.nbr_idx.shape == (K * N, dm) and st.offsets.shape == (K * 3,)
    np.testing.assert_array_equal(st.F, [c.F for c in tc])
    np.testing.assert_array_equal(st.gamma, [c.gamma_period for c in tc])
    for k, (rt, c) in enumerate(zip(rts, cfgs(jg, jb, ja))):
        rows = slice(k * N, (k + 1) * N)
        jrt = jb.make_byzantine_runtime(jm, c, deg_max=dm)[0]
        np.testing.assert_array_equal(st.nbr_idx[rows] - k * N,
                                      np.asarray(jrt.nbr_idx))
        for f in ("nbr_valid", "byz_mask", "active", "in_C", "sizes"):
            np.testing.assert_array_equal(
                getattr(st, f)[rows if f != "sizes" else slice(3 * k,
                                                               3 * k + 3)],
                np.asarray(getattr(jrt, f)), f)
        np.testing.assert_array_equal(st.byz_nbr[rows],
                                      np.asarray(jrt.byz_mask)[
                                          np.asarray(jrt.nbr_idx)])
        assert torch.equal(st.offsets[3 * k:3 * k + 3], rt.offsets + k * N)
    with pytest.raises(ValueError, match="single-scenario"):
        ts.stack_runtimes([st])
    other = tg.make_hierarchy([5, 10], topology="complete", seed=0)
    with pytest.raises(ValueError, match="network count"):
        ts.stack_runtimes([rts[0], tb.make_byzantine_runtime(
            tm, tb.ByzantineConfig(other, 0, (), 4, ta.large_value()))[0]])


# ---- the pieces over K scenarios ----

@pytest.mark.parametrize("attack", sorted(ta.ATTACKS))
@pytest.mark.parametrize("pair", [(3, 3), (3,)])
def test_attacks_over_k_scenarios_are_each_scenarios_own(attack, pair):
    """``nbr_messages`` of K = 3 scenarios (K keys, r (K, N, *pair)) is,
    scenario by scenario, the single call on its own r and key, bit for
    bit; a value that differs per scenario is one row a receiver, stride
    0 over the slots, and a constant lie stays all stride 0."""
    rng = np.random.default_rng(len(pair))
    K, N, dm = 3, 6, 4
    r = torch.from_numpy(rng.normal(size=(K, N) + pair).astype(np.float32))
    r[1] *= 100.0                  # a mean across scenarios would show
    idx = torch.from_numpy(rng.integers(0, N, size=(K, N, dm)).astype(
        np.int32))
    seeds = np.array([7, 0, 2**32 - 1], np.int64)
    atk = _attack(ta, attack, 1)
    got = atk.nbr_messages(Key(np.zeros(K, np.int64), seeds), 5, r, idx)
    assert got.shape == (K, N, dm) + pair
    for k in range(K):
        one = atk.nbr_messages(prng_key(int(seeds[k])), 5, r[k], idx[k])
        assert torch.equal(got[k], one), k
    if attack == "random_noise":          # a lie a slot, drawn per slot
        return
    flat = got.reshape((K * N, dm) + pair)
    assert flat.stride()[1] == 0
    if attack in ("large_value", "truth_suppression"):
        assert flat.stride()[0] == 0
    # one scenario keeps the all-stride-0 view of the single call
    one_k = atk.nbr_messages(Key(seeds[:1] * 0, seeds[:1]), 5, r[:1],
                             idx[:1]).reshape((N, dm) + pair)
    assert one_k.stride()[:2] == (0, 0)


@pytest.mark.parametrize("F", [1, "per_pool"])
def test_trimmed_pool_over_k_pools_is_each_pools_own(F):
    rng = np.random.default_rng(4)
    K, R = 4, 9
    pool = torch.from_numpy(rng.normal(size=(K, R, 3, 3)).astype(np.float32))
    pool[:, 0] = 1e6
    valid = torch.from_numpy(rng.random((K, R)) < 0.8)
    Fs = [0, 1, 2, 4] if F == "per_pool" else [F] * K
    got = ps_trimmed_pool(pool, valid, torch.tensor(Fs) if F == "per_pool"
                          else F)
    assert got.shape == (K, 3, 3)
    for k in range(K):
        assert torch.equal(got[k], ps_trimmed_pool(pool[k], valid[k], Fs[k]))


# ---- the grid ----

@pytest.mark.parametrize("name,mode", GRID_REF)
def test_grid_matches_reference(grid_runs, name, mode):
    _, tc, _, got, want = grid_runs[name, mode]
    K = len(tc) * len(SEEDS)
    assert got.r.shape == (K, 15) + ((3, 3) if mode == "pairwise"
                                     else (3, 1))
    assert got.decisions.shape == (K, T, 15)
    _close(got.r, got.decisions, want.r, want.decisions)
    for f in ("cfg", "F", "seed"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert got.fault is None and got.async_ is None
    assert got.describe() == want.describe()


@pytest.mark.parametrize("name,mode", GRIDS)
def test_grid_rows_equal_single_runs(grid_runs, name, mode):
    """Every row bit-equal to the port's single run of its config and
    seed; the heterogeneous-Γ grid fuses each row on its own Γ."""
    tm, tc, atk, got, _ = grid_runs[name, mode]
    for k in range(got.K):
        one = _single(tm, tc[int(got.cfg[k])], int(got.seed[k]), atk, mode)
        assert torch.equal(got.r[k], one.r), k
        assert torch.equal(got.decisions[k], one.decisions), k


def test_grid_stores_and_one_scenario():
    """The three stores hold the same run; a grid of one config and one
    seed is its single run; T = 0 gives empty curves."""
    _, tm = _models()
    tc = _grid_cfgs(tg, tb, ta, (3, 4))[:2]
    runs = {s: ts.run_byzantine_grid(tm, tc, T, SEEDS, device="cpu",
                                     plan=ExecutionPlan(store=s))
            for s in tb.STORES}
    traj, dec, fin = (runs[s] for s in ("trajectory", "decisions", "final"))
    assert traj.r.shape == (4, T, 15, 3, 3) and fin.decisions.shape == (4, 15)
    assert torch.equal(traj.r[:, -1], dec.r) and torch.equal(dec.r, fin.r)
    assert torch.equal(traj.decisions, dec.decisions)
    assert torch.equal(dec.decisions[:, -1], fin.decisions)
    one = ts.run_byzantine_grid(tm, tc[1:], T, 5, device="cpu",
                                plan=ExecutionPlan(store="trajectory"))
    assert one.K == 1
    single = _single(tm, tc[1], 5, tc[1].attack, store="trajectory")
    assert torch.equal(one.r[0], single.r)
    assert torch.equal(one.decisions[0], single.decisions)
    empty = ts.run_byzantine_grid(tm, tc, 0, SEEDS, device="cpu")
    assert empty.decisions.shape == (4, 0, 15)
    assert empty.r.shape == (4, 15, 3, 3) and not empty.r.any()


def test_grid_validation_errors_are_the_references():
    jm, tm = _models()
    other_n = tg.make_hierarchy([5, 5, 4], topology="complete", seed=0)
    other_m = tg.make_hierarchy([5, 10], topology="complete", seed=0)
    good = _grid_cfgs(tg, tb, ta)
    for topo in (other_n, other_m):
        bad = tb.ByzantineConfig(topo, 0, (), 4, ta.large_value())
        with pytest.raises(ValueError, match=r"must share \(N, M\)"):
            ts.run_byzantine_grid(tm, [good[0], bad], 5, [0], device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        ts.run_byzantine_grid(tm, [], 5, [0], device="cpu")
    with pytest.raises(ValueError, match="store"):
        ts.run_byzantine_grid(tm, good, 5, [0], device="cpu",
                              plan=ExecutionPlan(store="gap"))
    # M = 3 < 2F+1 = 5, with a network outside C: the extra-reps branch
    jm2, tm2 = _models(N=25, truth=1)
    topo = tg.make_hierarchy([7, 7, 7, 4], topology="complete", seed=2)
    jtopo = jg.make_hierarchy([7, 7, 7, 4], topology="complete", seed=2)
    cfg = tb.ByzantineConfig(topo, 2, (2, 9), 10, ta.large_value())
    jcfg = jb.ByzantineConfig(jtopo, 2, (2, 9), 10, ja.large_value())
    assert tb.make_byzantine_runtime(tm2, cfg)[1] is not None
    with pytest.raises(ValueError, match="2F\\+1") as port:
        ts.run_byzantine_grid(tm2, [cfg], 5, [0], device="cpu")
    with pytest.raises(ValueError, match="2F\\+1") as ref:
        js.run_byzantine_grid(jm2, [jcfg], 5, [0])
    assert str(port.value) == str(ref.value)


# ---- the sweep ----

# the attacks each mode's sweep is held against the reference's with (the
# one-vs-rest grid above holds large_value against it)
SWEEP_REF = {"pairwise": sorted(ta.ATTACKS),
             "ovr": ["extreme_pull", "random_noise", "sign_flip",
                     "truth_suppression"]}


@pytest.fixture(scope="module")
def sweep_runs():
    """Every attack over seeds 0 and 5 on the fixture's F 1 config, port
    and reference (the attacks of ``SWEEP_REF``), pairwise and ovr, store
    trajectory."""
    jm, tm = _models()
    jcfg, tcfg = _grid_cfgs(jg, jb, ja)[1], _grid_cfgs(tg, tb, ta)[1]
    out = {}
    for mode in ("pairwise", "ovr"):
        got = ts.run_byzantine_sweep(tm, tcfg, T, SEEDS,
                                     [_attack(ta, n) for n in ta.ATTACKS],
                                     mode=mode, device="cpu")
        want = js.run_byzantine_sweep(jm, jcfg, T, SEEDS,
                                      [_attack(ja, n)
                                       for n in SWEEP_REF[mode]],
                                      mode=mode)
        out[mode] = (tm, tcfg, got, want)
    return out


@pytest.mark.parametrize("attack", sorted(ta.ATTACKS))
@pytest.mark.parametrize("mode", ["pairwise", "ovr"])
def test_sweep_every_attack_matches_reference_and_single_runs(
        sweep_runs, attack, mode):
    tm, cfg, got, want = sweep_runs[mode]
    assert set(got) == set(ta.ATTACKS)
    res = got[attack]
    assert res.r.shape == (2, T, 15) + ((3, 3) if mode == "pairwise"
                                        else (3, 1))
    if attack in want:
        _close(res.r, res.decisions, want[attack].r, want[attack].decisions)
    for s, seed in enumerate(SEEDS):
        one = _single(tm, cfg, seed, _attack(ta, attack), mode,
                      store="trajectory")
        assert torch.equal(res.r[s], one.r), seed
        assert torch.equal(res.decisions[s], one.decisions), seed


def test_sweep_extra_reps_branch():
    """M = 4 < 2F+1 with network 3 outside C: each scenario draws its
    representatives from every C network plus a ``choice`` of agents
    outside C from its own key, and its random_noise replies from its own
    key too."""
    attack = "random_noise"
    sizes = [7, 7, 7, 4]
    jm, tm = _models(N=25, truth=1)
    jcfg = jb.ByzantineConfig(jg.make_hierarchy(sizes, "complete", seed=2),
                              2, (2, 9), 10, _attack(ja, attack, 1))
    cfg = tb.ByzantineConfig(tg.make_hierarchy(sizes, "complete", seed=2),
                             2, (2, 9), 10, _attack(ta, attack, 1))
    assert tb.make_byzantine_runtime(tm, cfg)[1] is not None
    seeds = [0, 3]
    got = ts.run_byzantine_sweep(tm, cfg, T, seeds, device="cpu")[attack]
    want = js.run_byzantine_sweep(jm, jcfg, T, seeds)[attack]
    _close(got.r, got.decisions, want.r, want.decisions)
    for s, seed in enumerate(seeds):
        one = _single(tm, cfg, seed, cfg.attack, store="trajectory")
        assert torch.equal(got.r[s], one.r) and torch.equal(
            got.decisions[s], one.decisions)


def test_sweep_dense_core_is_the_oracle_per_scenario():
    """``core="dense"`` runs each seed alone on the (N, N) oracle: its rows
    are the single dense runs bit for bit, and every decision equals the
    sparse sweep's."""
    _, tm = _models()
    cfg = _grid_cfgs(tg, tb, ta)[1]
    atk = [ta.extreme_pull()]
    plan = ExecutionPlan(store="decisions")
    dense = ts.run_byzantine_sweep(tm, cfg, T, SEEDS, atk, core="dense",
                                   plan=plan, device="cpu")["extreme_pull"]
    sparse = ts.run_byzantine_sweep(tm, cfg, T, SEEDS, atk, plan=plan,
                                    device="cpu")["extreme_pull"]
    assert torch.equal(dense.decisions, sparse.decisions)
    torch.testing.assert_close(dense.r, sparse.r, rtol=1e-5, atol=1e-3)
    for s, seed in enumerate(SEEDS):
        one = _single(tm, cfg, seed, atk[0], core="dense")
        assert torch.equal(dense.r[s], one.r)
        assert torch.equal(dense.decisions[s], one.decisions)


def test_sweep_attack_without_sparse_form():
    """An attack with only the dense ``messages`` form: each scenario's
    slots gathered from its own dense tensor, its reply from ``ps_reply``
    on its own state."""
    def tmsg(key, t, r):
        n, m = r.shape[0], r.shape[-1]
        return (r.mean(dim=0) * -3.0).expand(n, n, m, m)

    _, tm = _models()
    cfg = _grid_cfgs(tg, tb, ta)[1]
    atk = ta.Attack("mirror", tmsg, ta._broadcast_reply(tmsg))
    got = ts.run_byzantine_sweep(tm, cfg, T, SEEDS, [atk],
                                 device="cpu")["mirror"]
    for s, seed in enumerate(SEEDS):
        one = _single(tm, cfg, seed, atk, store="trajectory")
        assert torch.equal(got.r[s], one.r)


def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tm = _models()
    cfgs = _grid_cfgs(tg, tb, ta)
    for call in (lambda: ts.run_byzantine_grid(tm, cfgs, 2, [0]),
                 lambda: ts.run_byzantine_sweep(tm, cfgs[1], 2, [0]),
                 lambda: ts.run_byzantine_grid(tm, cfgs, 2, [0],
                                               device="cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ts.run_byzantine_grid(tm, cfgs, 2, [0], device="cpu",
                              plan=ExecutionPlan(backend="cuda"))


# ---- the fault plane over a grid and a sweep ----

def _severe(mod):
    """The chaos lane's severe model (benchmarks/chaos.py:52-56)."""
    return mod.gilbert_elliott_model(8.0, 0.5, leave_prob=0.1,
                                     join_prob=0.25, ps_crash_prob=0.5)


def test_grid_and_sweep_under_faults_match_reference_and_single_runs():
    """One fault model over every scenario: the grid (slot draws at the
    grid's common padded deg_max) and the sweep against the reference,
    the grid's fault column all zeros, each row bit-equal to the port's
    single run of its scenario under the same model."""
    import repro.core.faults as jfa
    import repro.core.plan as jplan
    import repro_torch.core.faults as tfa
    jm, tm = _models()
    jc, tc = _grid_cfgs(jg, jb, ja, (3, 4)), _grid_cfgs(tg, tb, ta, (3, 4))
    plan = ExecutionPlan(faults=_severe(tfa))
    got = ts.run_byzantine_grid(tm, tc, T, SEEDS, device="cpu", plan=plan)
    want = js.run_byzantine_grid(jm, jc, T, SEEDS, plan=jplan.ExecutionPlan(
        faults=_severe(jfa)))
    _close(got.r, got.decisions, want.r, want.decisions)
    np.testing.assert_array_equal(got.fault.numpy(), np.asarray(want.fault))
    assert got.fault.tolist() == [0] * got.K and got.async_ is None
    dm = max(tb.make_byzantine_runtime(tm, c)[0].nbr_idx.shape[1]
             for c in tc)
    for k in (0, 5, got.K - 1):
        rt, extra, n_reps = tb.make_byzantine_runtime(tm, tc[int(got.cfg[k])],
                                                      deg_max=dm)
        one = tb.run_byzantine_runtime(
            tm, rt, extra, n_reps, tc[0].attack, T, int(got.seed[k]),
            device="cpu", plan=plan.replace(store="decisions"))
        assert torch.equal(got.r[k], one.r) and torch.equal(
            got.decisions[k], one.decisions), k
    atk = _attack(ta, "sign_flip")
    sw = ts.run_byzantine_sweep(tm, tc[1], T, SEEDS, [atk], device="cpu",
                                plan=plan)["sign_flip"]
    ref = js.run_byzantine_sweep(jm, jc[1], T, SEEDS,
                                 [_attack(ja, "sign_flip")],
                                 plan=jplan.ExecutionPlan(
                                     faults=_severe(jfa)))["sign_flip"]
    _close(sw.r, sw.decisions, ref.r, ref.decisions)
