"""The async plane in the port (``repro_torch.core.asyncrony``) against
``repro.core.asyncrony``: the wake band and coins, one buffered tick of
the sparse step, and push-sum, HPS and Alg. 3 under
``benchmarks/social_learning.py``'s acceptance model and with the fault
plane on top; plus the port's own properties — the degenerate model
bit-equal to the synchronous step and entry points, mass under any wake
schedule — K1's route with per-edge source rows, and the error cases.

Tolerances as ``tests/test_torch_faults.py``: draws bit-equal; state
within rtol 1e-4 / atol 1e-5 of the reference's jitted scan (one tick of
the eager step: rtol 1e-6); Alg. 3 beliefs within 1e-3 where the mass is
not drained and the final decisions equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import repro.core.asyncrony as ja
import repro.core.faults as jf
import repro.core.graphs as jg
import repro.core.hps as jh
import repro.core.pushsum as jp
from repro.core.plan import ExecutionPlan as JaxPlan
import repro_torch.core.asyncrony as ta
import repro_torch.core.attacks as tat
import repro_torch.core.byzantine as tb
import repro_torch.core.faults as tf
import repro_torch.core.graphs as tg
import repro_torch.core.hps as th
import repro_torch.core.pushsum as tp
import repro_torch.core.signals as tsig
import repro_torch.core.sweeps as ts
from repro_torch.kernels.pushsum_edge import edge_scatter, edge_scatter_ref
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.prng import prng_key
from test_torch_faults import _social_pair, hold_social

TS = [0, 1, 199, (1 << 20) - 1]
# benchmarks/social_learning.py:282's acceptance cell, and a short bound
MODELS = [(0.6, 8), (0.5, 1)]


def _fixture(n=10, seed=0):
    rng = np.random.default_rng(seed)
    el = jg.sort_by_dst(jg.edge_list(jg.random_strongly_connected(
        n, 0.3, rng)))[0]
    return el, rng.normal(size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("t", TS)
def test_fold_values_and_wake_coins_match_reference(t):
    for e in range(4):
        got = ta.async_stream_fold(t, e)
        assert type(got) is np.int32 and got == ja.async_stream_fold(t, e)
        # below the fault band
        assert int(got) < int(tf.fault_stream_fold(t, 3, 2)) or t == 0
    for e, p in ((0, 0.3), (1, 0.6), (2, 0.9)):
        want = ja.wake_mask(jax.random.PRNGKey(4), t, 37, p, engine=e)
        got = ta.wake_mask(prng_key(4), t, 37, p, engine=e)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ta.wake_mask(prng_key(0), t, 64, 1.0, engine=0).all()


def test_degenerate_detection():
    assert ta.is_degenerate_async(None)
    assert ta.is_degenerate_async(ta.make_async_model())
    assert ta.is_degenerate_async(ta.make_async_model(1.0, 0))
    assert not ta.is_degenerate_async(ta.make_async_model(0.7, 0))
    assert not ta.is_degenerate_async(ta.make_async_model(1.0, 2))
    stacked = ta.stack_async_models([ta.make_async_model()] * 2)
    assert stacked.wake_prob.shape == (2,)
    assert not ta.is_degenerate_async(stacked)


def _tick_inputs(el, w, seed):
    rng = np.random.default_rng(seed)
    E, n = el.E, w.shape[0]
    masks = rng.random((12, E)) < 0.6
    awake = rng.random((12, n)) < 0.5
    return masks, awake


def test_buffered_tick_matches_reference_step():
    el, w = _fixture()
    E, d = el.E, w.shape[1]
    masks, awake = _tick_inputs(el, w, 1)
    sj = jp.init_sparse_state(jnp.asarray(w), E)
    bj = ja.init_async_buffer(E, d)
    st = tp.init_sparse_state(torch.from_numpy(w), E)
    bt = ta.init_async_buffer(E, d)
    valid = np.ones(E, bool)
    src, dst = torch.from_numpy(el.src).long(), torch.from_numpy(el.dst).long()
    for t in range(12):
        sj, bj = jp.sparse_pushsum_step(
            sj, jnp.asarray(masks[t]), el.src, el.dst, jnp.asarray(valid),
            backend="xla", awake=jnp.asarray(awake[t]), abuf=bj,
            staleness=jnp.asarray(2, jnp.int32))
        st, bt = tp.sparse_pushsum_step(
            st, torch.from_numpy(masks[t]), src, dst,
            torch.from_numpy(valid), awake=torch.from_numpy(awake[t]),
            abuf=bt, staleness=torch.tensor(2, dtype=torch.int32))
        np.testing.assert_array_equal(bt.age.numpy(), np.asarray(bj.age))
        np.testing.assert_allclose(bt.snap[:, :-1].numpy(),
                                   np.asarray(bj.snap), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(bt.snap_m.numpy(), np.asarray(bj.snap_m),
                                   rtol=1e-6, atol=1e-6)
        for g, r in ((st.z, sj.z), (st.m, sj.m), (st.rho, sj.rho)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-6)


def test_degenerate_tick_is_the_synchronous_step_bit_for_bit():
    el, w = _fixture()
    E, n = el.E, w.shape[0]
    st = tp.init_sparse_state(torch.from_numpy(w), E)
    mask = torch.from_numpy(np.random.default_rng(3).random(E) < 0.7)
    src, dst = torch.from_numpy(el.src).long(), torch.from_numpy(el.dst).long()
    valid = torch.ones(E, dtype=torch.bool)
    for _ in range(3):
        ref = tp.sparse_pushsum_step(st, mask, src, dst, valid)
        got, abuf = tp.sparse_pushsum_step(
            st, mask, src, dst, valid, awake=torch.ones(n, dtype=torch.bool),
            abuf=ta.init_async_buffer(E, w.shape[1]),
            staleness=torch.tensor(0, dtype=torch.int32))
        assert all(torch.equal(a, b) for a, b in zip(ref, got))
        assert (abuf.age == 0).all()
        st = ref


@pytest.mark.parametrize("wake,stale", [(0.3, 0), (0.5, 2), (0.8, 5)])
def test_mass_invariant_under_random_wakes(wake, stale):
    el, w = _fixture()
    E, n = el.E, w.shape[0]
    st = tp.init_sparse_state(torch.from_numpy(w), E)
    abuf = ta.init_async_buffer(E, w.shape[1])
    src, dst = torch.from_numpy(el.src).long(), torch.from_numpy(el.dst).long()
    valid = torch.ones(E, dtype=torch.bool)
    rng = np.random.default_rng(9)
    for t in range(12):
        awake = ta.wake_mask(prng_key(7), t, n, wake, engine=0)
        st, abuf = tp.sparse_pushsum_step(
            st, torch.from_numpy(rng.random(E) < 0.6), src, dst, valid,
            awake=awake, abuf=abuf,
            staleness=torch.tensor(stale, dtype=torch.int32))
        inv = tp.sparse_mass_invariant(st, src, valid)
        np.testing.assert_allclose(inv[:-1].numpy(), w.sum(0), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(inv[-1].item(), n, rtol=1e-6)


@pytest.mark.parametrize("D", [4, 5])
def test_k1_route_with_per_edge_source_rows(D):
    """The async delivery: K1's plain route with (E, D) source rows and
    the identity index, against the edge-order sum, and the wrapper's
    receiver count taken apart from the source rows."""
    el, _ = _fixture(n=12, seed=D)
    E, n = el.E, 12
    rng = np.random.default_rng(D)
    snap = torch.from_numpy(rng.normal(size=(E, D)).astype(np.float32))
    rho = torch.from_numpy(rng.normal(size=(E, D)).astype(np.float32))
    live = torch.from_numpy(rng.random(E) < 0.7)
    ident = torch.arange(E, dtype=torch.int32)
    dst = torch.from_numpy(el.dst).int()
    rho_new, recv = edge_scatter(snap, rho, live, ident, dst, n_recv=n)
    assert rho_new.shape == (E, D) and recv.shape == (n, D)
    want = torch.where(live[:, None], snap, rho)
    assert torch.equal(rho_new, want)
    order_sum = torch.zeros((n, D))
    for e in range(E):     # each receiver's increments in edge order
        order_sum[dst[e]] += want[e] - rho[e]
    torch.testing.assert_close(recv, order_sum, rtol=0, atol=1e-6)
    ref = edge_scatter_ref(snap, rho, live, ident, dst, n_recv=n)
    assert torch.equal(ref[0], rho_new) and torch.equal(ref[1], recv)


# ---------------------------------------------------------------------------
# The engines under the async plane, against the reference
# ---------------------------------------------------------------------------

def _hier(mod):
    return mod.make_hierarchy([6, 6, 6], "complete", seed=0)


@pytest.mark.parametrize("model", MODELS)
def test_pushsum_matches_reference(model):
    el, w = _fixture(n=12)
    kw = dict(drop_prob=0.2, B=2, record_every=40)
    sj, trj = jp.run_pushsum_sparse(
        w, el.src, el.dst, 40, key=jax.random.PRNGKey(2),
        plan=JaxPlan(backend="xla", async_=ja.make_async_model(*model)), **kw)
    st, trt = tp.run_pushsum_sparse(
        w, el.src, el.dst, 40, key=prng_key(2), device="cpu",
        plan=ExecutionPlan(async_=ta.make_async_model(*model)), **kw)
    for g, r in ((st.z, sj.z), (st.m, sj.m), (st.rho, sj.rho),
                 (trt, trj)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("model", MODELS)
def test_hps_matches_reference(model):
    w = np.random.default_rng(5).normal(size=(18, 2)).astype(np.float32)
    rj = jh.run_hps(w, jh.HPSConfig(_hier(jg), 4, B=2, drop_prob=0.2), 50,
                    plan=JaxPlan(backend="xla", store="gap",
                                 async_=ja.make_async_model(*model)))
    rt = th.run_hps(w, th.HPSConfig(_hier(tg), 4, B=2, drop_prob=0.2), 50,
                    device="cpu", plan=ExecutionPlan(
                        store="gap", async_=ta.make_async_model(*model)))
    np.testing.assert_allclose(rt.gap.numpy(), np.asarray(rj.gap), atol=1e-4)
    np.testing.assert_allclose(rt.final_state.z.numpy(),
                               np.asarray(rj.final_state.z), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("model", MODELS)
def test_social_matches_reference(model):
    hold_social(*_social_pair(None, store="log_ratio", jax={
        "async_": ja.make_async_model(*model)}, torch={
        "async_": ta.make_async_model(*model)}))


def test_async_composes_with_faults_as_the_reference():
    fj = jf.make_fault_model(p_gb=0.1, p_bg=0.5, leave_prob=0.05,
                             join_prob=0.5, ps_crash_prob=0.3)
    ft = tf.make_fault_model(p_gb=0.1, p_bg=0.5, leave_prob=0.05,
                             join_prob=0.5, ps_crash_prob=0.3)
    hold_social(*_social_pair(None, store="final", jax={
        "async_": ja.make_async_model(0.6, 2), "faults": fj}, torch={
        "async_": ta.make_async_model(0.6, 2), "faults": ft}))
    el, w = _fixture(n=12)
    sj, _ = jp.run_pushsum_sparse(
        w, el.src, el.dst, 30, drop_prob=0.2, B=2, record_every=30,
        key=jax.random.PRNGKey(0),
        plan=JaxPlan(backend="xla", faults=fj,
                     async_=ja.make_async_model(0.6, 2)))
    st, _ = tp.run_pushsum_sparse(
        w, el.src, el.dst, 30, drop_prob=0.2, B=2, record_every=30,
        key=prng_key(0), device="cpu",
        plan=ExecutionPlan(faults=ft, async_=ta.make_async_model(0.6, 2)))
    np.testing.assert_allclose(st.zm.numpy()[:, :-1], np.asarray(sj.z),
                               rtol=1e-4, atol=1e-5)
    inv = tp.sparse_mass_invariant(st, torch.from_numpy(el.src).long(),
                                   torch.ones(el.E, dtype=torch.bool))
    np.testing.assert_allclose(inv[-1].item(), 12.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# The entry points: degenerate bit-identity and the error cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["pushsum", "hps", "social"])
def test_degenerate_entry_points_are_bit_identical(engine):
    from test_torch_faults import _run_engine
    base = _run_engine(engine, ExecutionPlan())
    got = _run_engine(engine, ExecutionPlan(async_=ta.make_async_model()))
    assert all(torch.equal(a, b) for a, b in zip(base, got))


def test_error_cases():
    el, w = _fixture()
    am = ta.make_async_model(0.5, 1)
    with pytest.raises(ValueError, match="masks"):
        tp.run_pushsum_sparse(w, el.src, el.dst, 2, device="cpu",
                              masks=np.ones((2, el.E), bool),
                              plan=ExecutionPlan(async_=am))
    topo = tg.make_hierarchy([7] * 4, "complete", seed=0)
    model = tsig.make_confused_model(N=28, m=3, truth=0, confusion=0.3,
                                     seed=1)
    cfg = tb.ByzantineConfig(topo=topo, F=1, byz=(2,), gamma_period=4,
                             attack=tat.large_value())
    plan = ExecutionPlan(async_=am)
    for call in (
            lambda: tb.run_byzantine_learning(model, cfg, 2, device="cpu",
                                              plan=plan),
            lambda: tb.run_byzantine_runtime(
                model, *tb.make_byzantine_runtime(model, cfg), cfg.attack,
                2, device="cpu", plan=plan),
            lambda: ts.run_byzantine_grid(model, [cfg], 2, [0],
                                          device="cpu", plan=plan),
            lambda: ts.run_byzantine_sweep(model, cfg, 2, [0],
                                           device="cpu", plan=plan)):
        with pytest.raises(ValueError, match="async_"):
            call()
    with pytest.raises(ValueError, match="store"):
        ts.run_pushsum_sweep(w, el, 2, device="cpu",
                             plan=ExecutionPlan(store="gap", async_=am))
