"""Algorithm 2 in the port against ``repro.core.byzantine``: the set-up
(healthy networks, the runtime, its dense-free construction), the attacks
and the dense oracle's trim, and the loop run on the reference's own
runtime carried across, over pairwise and one-vs-rest, sparse and dense
cores, the three stores, every attack, F in {0, 1, 2} and both
representative branches; then the quickstart scenario end to end and the
entry points' rules.

Tolerances. Signals, ``random_noise`` lies and the fusion's representative
draws come from the bit-exact threefry port, so what differs is
arithmetic: XLA sums the trimmed survivors and the attacks' means in its
own order inside the jitted scan, about one ulp per round, and the port's
``normal`` is within 4 ulp of jax's. The statistics grow to ~1e2..1e4 over
the horizon, so ``r`` is held to rtol 2e-5 with atol 2e-3, and every
decision at every step must be equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import repro.core.attacks as ja
import repro.core.byzantine as jb
import repro.core.graphs as jg
import repro.core.signals as js
import repro_torch.core.attacks as ta
import repro_torch.core.byzantine as tb
import repro_torch.core.graphs as tg
from repro_torch import convert
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.prng import prng_key

T = 60
RTOL, ATOL = 2e-5, 2e-3

# name -> (sizes, topology, confusion, truth, model seed, F, byz)
SCENARIOS = {
    # the main cell's set-up cut to 8 networks: networks 0 and 1 fail A4,
    # so the fusion's queried representatives there adopt w_tilde
    "cell": ([8] * 8, "complete", 0.25, 0, 1, 2, (2, 9)),
    # M = 4 < 2F + 1 with network 3 outside C: reps from every C network
    # plus a choice() of agents outside C
    "branch2": ([7, 7, 7, 4], "complete", 0.0, 1, 0, 2, (2, 9)),
    "F1": ([4, 4, 4], "complete", 0.0, 0, 2, 1, (5,)),
    "F0": ([5, 5, 5], "ring+", 0.0, 0, 2, 0, (1,)),
}


def _attack(mod, name, truth):
    return (mod.truth_suppression(truth) if name == "truth_suppression"
            else mod.ATTACKS[name]())


def _pair(name, attack="large_value"):
    """The reference's (model, cfg) and the port's, for one scenario."""
    sizes, topology, confusion, truth, seed, F, byz = SCENARIOS[name]
    jtopo = jg.make_hierarchy(sizes, topology, seed=2)
    jmodel = js.make_confused_model(N=jtopo.N, m=3, truth=truth,
                                    confusion=confusion, seed=seed)
    jcfg = jb.ByzantineConfig(topo=jtopo, F=F, byz=byz, gamma_period=10,
                              attack=_attack(ja, attack, truth))
    model = convert.signal_model_from_numpy(np.asarray(jmodel.tables), truth)
    cfg = tb.ByzantineConfig(topo=tg.make_hierarchy(sizes, topology, seed=2),
                             F=F, byz=byz, gamma_period=10,
                             attack=_attack(ta, attack, truth))
    return (jmodel, jcfg), (model, cfg)


def _reference(jmodel, jcfg, mode, core, store="trajectory", seed=0):
    return jb.make_byzantine_scan(jmodel, jcfg, T, mode=mode, core=core,
                                  backend="xla", store=store)(
        jax.random.PRNGKey(seed))


def _carried(jmodel, jcfg, model, attack, mode, core, store, seed=0):
    """The port's loop on the reference's runtime, carried across."""
    jrt, extra_reps, n_reps, _ = jb.make_byzantine_runtime(jmodel, jcfg)
    rt = convert.byz_runtime_from_numpy(*(np.asarray(x) for x in jrt))
    return tb.run_byzantine_runtime(
        model, rt, extra_reps, n_reps, attack, T, seed, mode=mode,
        core=core, plan=ExecutionPlan(store=store), device="cpu")


def _close(got, r_ref, d_ref):
    r, d = got.to_numpy()
    assert r.shape == r_ref.shape and d.shape == d_ref.shape
    np.testing.assert_array_equal(d, d_ref)
    np.testing.assert_allclose(r, r_ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["pairwise", "ovr"])
@pytest.mark.parametrize("core", ["sparse", "dense"])
def test_loop_matches_reference_in_every_store(mode, core):
    (jmodel, jcfg), (model, cfg) = _pair("cell")
    ref = _reference(jmodel, jcfg, mode, core)
    jr, jd = np.asarray(ref.r), np.asarray(ref.decisions)
    assert jr.shape == ((T, 64, 3, 3) if mode == "pairwise"
                        else (T, 64, 3, 1))
    expected = {"trajectory": (jr, jd), "decisions": (jr[-1], jd),
                "final": (jr[-1], jd[-1])}
    for store, (r_ref, d_ref) in expected.items():
        got = _carried(jmodel, jcfg, model, cfg.attack, mode, core, store)
        _close(got, r_ref, d_ref)
    # queried representatives outside C adopted the pooled value
    assert not np.asarray(jb.make_byzantine_runtime(jmodel, jcfg)[0].in_C
                          ).all()


@pytest.mark.parametrize("attack", sorted(ta.ATTACKS))
@pytest.mark.parametrize("mode,core", [("pairwise", "sparse"),
                                       ("ovr", "sparse"),
                                       ("pairwise", "dense")])
def test_every_attack_matches_reference(attack, mode, core):
    (jmodel, jcfg), (model, cfg) = _pair("cell", attack)
    ref = _reference(jmodel, jcfg, mode, core)
    got = _carried(jmodel, jcfg, model, cfg.attack, mode, core,
                   "trajectory")
    _close(got, np.asarray(ref.r), np.asarray(ref.decisions))


@pytest.mark.parametrize("name,mode,core", [
    ("F0", "pairwise", "sparse"), ("F0", "ovr", "dense"),
    ("F1", "pairwise", "sparse"), ("F1", "pairwise", "dense"),
    ("branch2", "pairwise", "sparse"), ("branch2", "ovr", "sparse"),
    ("branch2", "pairwise", "dense"),
])
def test_trim_counts_and_representative_branches_match_reference(name, mode,
                                                                 core):
    (jmodel, jcfg), (model, cfg) = _pair(name)
    extra_reps = jb.make_byzantine_runtime(jmodel, jcfg)[1]
    assert (extra_reps is None) == (name != "branch2")
    ref = _reference(jmodel, jcfg, mode, core, seed=3)
    got = _carried(jmodel, jcfg, model, cfg.attack, mode, core,
                   "trajectory", seed=3)
    _close(got, np.asarray(ref.r), np.asarray(ref.decisions))


def test_attack_without_sparse_form_matches_reference():
    """An attack with no ``nbr_messages``: the sparse core gathers its
    dense messages and the fusion asks its ``ps_reply``."""
    def jmsg(key, t, r):
        n, m = r.shape[0], r.shape[-1]
        return jnp.broadcast_to(jnp.arange(m * m, dtype=r.dtype).reshape(
            m, m) * 50.0, (n, n, m, m))

    def tmsg(key, t, r):
        n, m = r.shape[0], r.shape[-1]
        return (torch.arange(m * m, dtype=r.dtype).reshape(m, m)
                * 50.0).expand(n, n, m, m)

    (jmodel, jcfg), (model, _) = _pair("cell")
    jatk = ja.Attack("ramp", jmsg, ja._broadcast_reply(jmsg))
    tatk = ta.Attack("ramp", tmsg, ta._broadcast_reply(tmsg))
    jcfg = jb.ByzantineConfig(topo=jcfg.topo, F=jcfg.F, byz=jcfg.byz,
                              gamma_period=jcfg.gamma_period, attack=jatk)
    for mode in ("pairwise", "ovr"):
        ref = _reference(jmodel, jcfg, mode, "sparse")
        got = _carried(jmodel, jcfg, model, tatk, mode, "sparse",
                       "trajectory")
        _close(got, np.asarray(ref.r), np.asarray(ref.decisions))


# ---------------------------------------------------------------------------
# set-up
# ---------------------------------------------------------------------------

def _same_runtime(rt, extra_reps, n_reps, ref):
    jrt, j_extra, j_n = ref[:3]
    for field in jb.ByzRuntime._fields:
        got = getattr(rt, field)
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_array_equal(got, np.asarray(getattr(jrt, field)),
                                      field)
    np.testing.assert_array_equal(
        rt.byz_nbr.numpy(), np.asarray(jrt.byz_mask)[np.asarray(jrt.nbr_idx)])
    assert extra_reps == j_extra and n_reps == j_n


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_runtime_and_healthy_networks_match_reference(name):
    (jmodel, jcfg), (model, cfg) = _pair(name)
    ref = jb.make_byzantine_runtime(jmodel, jcfg)
    rt, extra_reps, n_reps = tb.make_byzantine_runtime(model, cfg)
    _same_runtime(rt, extra_reps, n_reps, ref)
    np.testing.assert_array_equal(tb.gossip_adjacency(rt), np.asarray(ref[3]))
    for m_ref, m_port in ((jmodel, model), (None, None)):
        assert (tb.healthy_networks(cfg.topo, cfg.byz_mask(), cfg.F, m_port)
                == jb.healthy_networks(jcfg.topo, jcfg.byz_mask(), jcfg.F,
                                       m_ref))
    padded = tb.make_byzantine_runtime(model, cfg, deg_max=9)
    _same_runtime(*padded, jb.make_byzantine_runtime(jmodel, jcfg,
                                                         deg_max=9))


@pytest.mark.parametrize("sizes,topology,F,byz,confusion", [
    ([8] * 8, "complete", 2, (2, 9), 0.25),
    ([7, 7, 7, 4], "complete", 2, (2, 9), 0.0),
    ([6, 9, 7, 8], "ring+", 0, (3,), 0.25),
    ([5, 6, 7], "ring", 0, (), 0.25),
])
def test_dense_free_runtime_equals_reference(sizes, topology, F, byz,
                                             confusion):
    """``byzantine_runtime_from_edge_list`` on a hierarchical edge index
    gives every leaf of the reference's ``make_byzantine_runtime`` on the
    same graph's dense topology."""
    el, rep_mask = tg.hier_edge_list(sizes, topology, seed=1)
    adj = np.zeros((el.n, el.n), bool)
    adj[el.src, el.dst] = True
    offsets = tuple(int(o) for o in np.cumsum([0] + sizes[:-1]))
    jtopo = jg.HierTopology(adj=adj, sizes=tuple(sizes), offsets=offsets,
                            reps=offsets)
    jmodel = js.make_confused_model(N=el.n, m=3, truth=1,
                                    confusion=confusion, seed=4)
    jcfg = jb.ByzantineConfig(topo=jtopo, F=F, byz=byz, gamma_period=10,
                              attack=ja.large_value())
    model = convert.signal_model_from_numpy(np.asarray(jmodel.tables), 1)
    got = tb.byzantine_runtime_from_edge_list(model, el, sizes, F, byz, 10)
    _same_runtime(*got, jb.make_byzantine_runtime(jmodel, jcfg))


def test_dense_free_runtime_allocates_no_square_array():
    """2,048 complete 8-agent networks (N = 16,384): the build's peak
    allocation stays far below one (N, N) bool array (268 MB)."""
    import tracemalloc

    from repro_torch.core.signals import make_confused_model

    N = 16_384
    el, _ = tg.block_complete_edge_list([8] * (N // 8))
    model = make_confused_model(N=N, m=3, truth=0, confusion=0.25, seed=1)
    tracemalloc.start()
    try:
        rt, extra_reps, n_reps = tb.byzantine_runtime_from_edge_list(
            model, el, [8] * (N // 8), 2, (2, 9), 10)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < N * N // 16, peak
    assert rt.nbr_idx.shape == (N, 7) and extra_reps is None
    assert n_reps == N // 8
    assert 0 < int(rt.in_C.sum()) < N        # some networks fail A4


def test_set_up_errors():
    (_, _), (model, cfg) = _pair("cell")
    bad = tb.ByzantineConfig(topo=cfg.topo, F=2, byz=cfg.byz,
                             gamma_period=10, attack=cfg.attack)
    tight = convert.signal_model_from_numpy(
        np.repeat(model.tables.numpy()[:, :1], 3, axis=1), 0)
    with pytest.raises(ValueError, match="Assumption 5"):
        tb.make_byzantine_runtime(tight, bad)     # no network passes A4
    el, _ = tg.block_complete_edge_list([8] * 8)
    with pytest.raises(ValueError, match="sizes"):
        tb.byzantine_runtime_from_edge_list(model, el, [8] * 7, 2, (2,), 10)
    with pytest.raises(ValueError, match="gamma_period"):
        tb.byzantine_runtime_from_edge_list(model, el, [8] * 8, 2, (2,), 0)


# ---------------------------------------------------------------------------
# pieces: attacks, the dense oracle's trim, the decision rule, PRNG streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attack", sorted(ta.ATTACKS))
@pytest.mark.parametrize("pair", [(3, 3), (3,), (4, 4)])
def test_attack_messages_match_reference(attack, pair):
    rng = np.random.default_rng(len(pair))
    n = 6
    r = rng.normal(size=(n,) + pair).astype(np.float32)
    idx = rng.integers(0, n, size=(n, 4)).astype(np.int32)
    jatk, tatk = _attack(ja, attack, 1), _attack(ta, attack, 1)
    jkey, key = jax.random.PRNGKey(7), prng_key(7)
    got = tatk.nbr_messages(key, 5, torch.from_numpy(r), torch.from_numpy(idx))
    ref = jatk.nbr_messages(jkey, jnp.uint32(5), jnp.asarray(r),
                            jnp.asarray(idx))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-5)
    if len(pair) == 2:
        got = tatk.messages(key, 5, torch.from_numpy(r))
        ref = jatk.messages(jkey, jnp.uint32(5), jnp.asarray(r))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-5)
        np.testing.assert_allclose(
            tatk.ps_reply(key, 5, torch.from_numpy(r)).numpy(),
            np.asarray(jatk.ps_reply(jkey, jnp.uint32(5), jnp.asarray(r))),
            rtol=1e-6, atol=1e-5)
        if attack != "random_noise":   # the two forms agree slot by slot
            full = tatk.messages(key, 5, torch.from_numpy(r)).numpy()
            nbr = tatk.nbr_messages(key, 5, torch.from_numpy(r),
                                    torch.from_numpy(idx)).numpy()
            np.testing.assert_array_equal(
                nbr, full[idx, np.arange(n)[:, None]])


@pytest.mark.parametrize("F", [0, 1, 2])
@pytest.mark.parametrize("pair", [(3, 3), (3, 1)])
def test_trimmed_neighbor_mean_matches_reference(F, pair):
    rng = np.random.default_rng(F)
    adj = jg.random_strongly_connected(9, 0.4, rng)
    vals = rng.normal(size=(9, 9) + pair).astype(np.float32)
    got = tb.trimmed_neighbor_mean(torch.from_numpy(vals),
                                   torch.from_numpy(adj), F)
    ref = jb.trimmed_neighbor_mean(jnp.asarray(vals), jnp.asarray(adj), F)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_decide_matches_reference():
    rng = np.random.default_rng(0)
    r = rng.normal(size=(50, 4, 4)).astype(np.float32)
    r[:5] = 0.0                                   # ties go to the first
    got = tb.decide(torch.from_numpy(r))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jb.decide(jnp.asarray(r))))


def test_stream_folds_are_the_reference_domains():
    T_h = 10_000
    folds = [{tb.stream_fold(t, s) for t in range(T_h)}
             for s in range(tb.N_STREAMS)]
    assert all(len(f) == T_h for f in folds)
    assert not (folds[0] & folds[1] or folds[0] & folds[2]
                or folds[1] & folds[2])
    assert [tb.stream_fold(7, s) for s in range(3)] == [
        int(jb.stream_fold(7, s)) for s in range(3)]
    assert (tb.STREAM_SIGNAL, tb.STREAM_GOSSIP, tb.STREAM_FUSION) == (
        jb.STREAM_SIGNAL, jb.STREAM_GOSSIP, jb.STREAM_FUSION)


# ---------------------------------------------------------------------------
# top level and entry rules
# ---------------------------------------------------------------------------

def _quickstart():
    from repro_torch.core.signals import make_confused_model
    topo = tg.make_hierarchy([7, 7, 7], topology="complete", seed=0)
    model = make_confused_model(N=topo.N, m=3, truth=1, confusion=0.0,
                                seed=0)
    cfg = tb.ByzantineConfig(topo=topo, F=2, byz=(2, 9), gamma_period=10,
                             attack=ta.truth_suppression(1, magnitude=1e3))
    return model, cfg


def test_quickstart_scenario_reaches_full_accuracy():
    """examples/quickstart.py's Algorithm 2 scenario: 3x7 complete,
    truth-suppression from agents 2 and 9, F = 2, Γ = 10, T = 500."""
    model, cfg = _quickstart()
    res = tb.run_byzantine_learning(model, cfg, T=500, seed=0, device="cpu")
    assert res.r.shape == (500, 21, 3, 3) and res.decisions.shape == (500, 21)
    normal = ~cfg.byz_mask()
    assert (res.decisions[-1].numpy()[normal] == model.truth).all()
    ovr = tb.run_byzantine_learning_ovr(model, cfg, T=500, seed=0,
                                        device="cpu",
                                        plan=ExecutionPlan(store="final"))
    assert ovr.r.shape == (21, 3, 1) and ovr.decisions.shape == (21,)


def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, cfg = _quickstart()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.run_byzantine_learning(model, cfg, T=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.make_byzantine_scan(model, cfg, 2, device="cuda")


def test_scan_options_and_unported_planes():
    model, cfg = _quickstart()
    run = tb.make_byzantine_scan(model, cfg, 3, store="final", device="cpu")
    assert run(prng_key(0)).r.shape == (21, 3, 3)
    for bad in ({"mode": "both"}, {"core": "pallas"}, {"store": "gap"}):
        with pytest.raises(ValueError):
            tb.make_byzantine_scan(model, cfg, 3, device="cpu", **bad)
    # the fault plane arrives only as a plan field; the precision policy
    # is a parameter of the scan, as in the reference
    with pytest.raises(TypeError):
        tb.make_byzantine_scan(model, cfg, 3, device="cpu", faults=None)
    half = tb.make_byzantine_scan(model, cfg, 3, store="final",
                                  device="cpu", policy="bf16")(prng_key(0))
    assert half.r.shape == (21, 3, 3) and half.r.dtype == torch.float32
    empty = tb.run_byzantine_learning(model, cfg, T=0, device="cpu")
    assert empty.r.shape == (0, 21, 3, 3) and empty.decisions.shape == (0, 21)
