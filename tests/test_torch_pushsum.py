"""The port's sparse push-sum rounds against ``repro.core.pushsum`` on ring,
complete and random digraphs, across drop rates and B-windows, fed the same
bit-equal link masks; plus the mass invariant and the numpy carry-across;
then the engine ``run_pushsum_sparse`` (key-driven, and on an explicit
schedule) and the dense spec ``run_pushsum``.

Both sides run the same fp32 recursion op by op (the reference eagerly
here, so XLA fuses no multiply-add across ops) and sum each receiver's
increments in edge order, so the states are bit-equal after 40 rounds. The
invariant is held to fp32 summation accuracy (rtol 1e-5).

The engines run the reference as one compiled ``lax.scan``, where XLA
contracts multiply-adds (about 1 ulp an op), and the dense spec sums each
receiver's column of (N, N) increments in the backend's own order, so
engine runs and dense runs are held within rtol 1e-4 / atol 1e-5, the
reference's own dense-to-sparse tolerance
(``tests/test_pushsum_sparse.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import repro.core.graphs as jg
import repro.core.pushsum as jp
from repro_torch.convert import dense_state_from_numpy, sparse_state_from_numpy
from repro_torch.core.graphs import edge_list, edge_masks, link_schedule, sort_by_dst
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.prng import prng_key
from repro_torch.core.pushsum import (
    _out_degree,
    init_sparse_state,
    mass_invariant,
    pushsum_step,
    run_pushsum,
    run_pushsum_sparse,
    sparse_mass_invariant,
    sparse_pushsum_step,
    sparse_ratios,
    step_edge_mask,
)

FIELDS = ("z", "m", "sigma", "sigma_m", "rho", "rho_m")


def _graph(kind):
    rng = np.random.default_rng(7)
    adj = {"ring": jg.ring(12), "complete": jg.complete(9),
           "random": jg.random_strongly_connected(15, 0.25, rng)}[kind]
    return sort_by_dst(edge_list(adj))[0]


@pytest.mark.parametrize("kind", ["ring", "complete", "random"])
@pytest.mark.parametrize("drop", [0.0, 0.3, 0.7])
@pytest.mark.parametrize("B", [1, 3])
def test_rounds_match_reference(kind, drop, B):
    el = _graph(kind)
    n, E = el.n, el.E
    w = np.random.default_rng(1).normal(size=(n, 3)).astype(np.float32)
    src, dst, valid = (torch.from_numpy(a) for a in (el.src, el.dst, el.valid))
    j_src, j_dst, j_valid = (jnp.asarray(a) for a in (el.src, el.dst, el.valid))
    share = 1.0 / (_out_degree(src, valid, n) + 1.0)
    st = init_sparse_state(torch.from_numpy(w), E)
    ref = jp.init_sparse_state(jnp.asarray(w), E)
    dp, Bt = torch.tensor(drop, dtype=torch.float32), torch.tensor(B)
    for t in range(40):
        mask = step_edge_mask(prng_key(3), t, E, dp, Bt)
        j_mask = jp.step_edge_mask(jax.random.PRNGKey(3), t, E,
                                   jnp.float32(drop), jnp.int32(B))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
        st = sparse_pushsum_step(st, mask, src, dst, valid, share=share)
        ref = jp.sparse_pushsum_step(ref, j_mask, j_src, j_dst, j_valid,
                                     "xla", dst_sorted=True)
    got = st.to_numpy()
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(ref, f)), f)
    np.testing.assert_array_equal(sparse_ratios(st).numpy(),
                                  np.asarray(jp.sparse_ratios(ref)))
    inv = sparse_mass_invariant(st, src, valid).numpy()
    np.testing.assert_allclose(
        inv[:-1], np.asarray(jp.sparse_mass_invariant(ref, j_src, j_valid)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(inv[:-1], w.sum(axis=0), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(inv[-1], n, rtol=1e-5)
    if drop == 0.0:   # a complete or strongly connected graph reaches consensus
        ratios = sparse_ratios(st).numpy()
        assert np.ptp(ratios, axis=0).max() < np.ptp(w, axis=0).max()


def test_share_defaults_to_out_degree():
    el = _graph("random")
    args = [torch.from_numpy(a) for a in (el.src, el.dst, el.valid)]
    st = init_sparse_state(torch.ones(el.n, 2), el.E)
    mask = torch.ones(el.E, dtype=torch.bool)
    share = 1.0 / (torch.from_numpy(el.out_degree()).float() + 1.0)
    a = sparse_pushsum_step(st, mask, *args)
    b = sparse_pushsum_step(st, mask, *args, share=share)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_state_carry_across_round_trips():
    rng = np.random.default_rng(2)
    fields = {f: rng.normal(size=s).astype(np.float32) for f, s in
              zip(FIELDS, [(5, 3), (5,), (5, 3), (5,), (9, 3), (9,)])}
    st = sparse_state_from_numpy(**fields)
    assert st.zm.shape == (5, 4) and st.rho_zm.shape == (9, 4)
    back = st.to_numpy()
    for f in FIELDS:
        np.testing.assert_array_equal(back[f], fields[f])


# ---- the engine and the dense spec ----

ENGINE_TOL = dict(rtol=1e-4, atol=1e-5)


def _random_graph(seed, n=13):
    rng = np.random.default_rng(seed)
    adj = jg.random_strongly_connected(n, 0.3, rng)
    w = rng.normal(size=(n, 3)).astype(np.float32)
    return adj, w


def _close_states(got, ref, **tol):
    got = got.to_numpy() if hasattr(got, "to_numpy") else {
        f: getattr(got, f).numpy() for f in FIELDS}
    for f in FIELDS:
        np.testing.assert_allclose(got[f], np.asarray(getattr(ref, f)),
                                   err_msg=f, **tol)


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("record_every", [1, 5])
def test_engine_key_driven_matches_reference(sort, record_every):
    adj, w = _random_graph(3)
    el = jg.edge_list(adj)
    if sort:
        el = jg.sort_by_dst(el)[0]
    T = 20
    got, traj = run_pushsum_sparse(
        w, el.src, el.dst, T, drop_prob=0.3, B=2, key=prng_key(5),
        record_every=record_every, device="cpu",
        plan=ExecutionPlan(dst_sorted=sort))
    ref, ref_traj = jp.run_pushsum_sparse(
        w, el.src, el.dst, T, drop_prob=0.3, B=2,
        key=jax.random.PRNGKey(5), record_every=record_every)
    assert traj.shape == ref_traj.shape == (T // record_every, 13, 3)
    np.testing.assert_allclose(traj.numpy(), np.asarray(ref_traj),
                               **ENGINE_TOL)
    _close_states(got, ref, **ENGINE_TOL)
    inv = sparse_mass_invariant(got, torch.from_numpy(el.src),
                                torch.from_numpy(el.valid)).numpy()
    np.testing.assert_allclose(inv[:-1], w.sum(axis=0), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(inv[-1], 13, rtol=1e-5)
    # the frames are rounds k - 1, 2k - 1, ... of the full record
    _, every = run_pushsum_sparse(w, el.src, el.dst, T, drop_prob=0.3, B=2,
                                  key=prng_key(5), device="cpu")
    assert torch.equal(traj, every[record_every - 1 :: record_every])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_on_a_schedule_matches_the_dense_spec(seed):
    adj, w = _random_graph(seed, n=9 + seed)
    T = 30
    sched = link_schedule(adj, T, 0.4, 4, seed=seed)
    el = edge_list(adj)
    masks = edge_masks(sched, el)
    got, traj = run_pushsum_sparse(w, el.src, el.dst, T, masks=masks,
                                   device="cpu")
    ref, ref_traj = jp.run_pushsum_sparse(w, el.src, el.dst, T, masks=masks)
    np.testing.assert_allclose(traj.numpy(), np.asarray(ref_traj),
                               **ENGINE_TOL)
    _close_states(got, ref, **ENGINE_TOL)
    dense, dense_traj = run_pushsum(w, adj, sched, device="cpu")
    np.testing.assert_allclose(traj.numpy(), dense_traj.numpy(),
                               **ENGINE_TOL)
    j_dense, j_traj = jp.run_pushsum(w, adj, sched)
    np.testing.assert_allclose(dense_traj.numpy(), np.asarray(j_traj),
                               **ENGINE_TOL)
    _close_states(dense, j_dense, **ENGINE_TOL)
    inv = mass_invariant(dense, torch.from_numpy(adj)).numpy()
    np.testing.assert_allclose(
        inv, np.asarray(jp.mass_invariant(j_dense, jnp.asarray(adj))),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(inv, w.sum(axis=0), rtol=1e-3, atol=1e-3)
    # record_every keeps only the end of each window
    _, sparse5 = run_pushsum_sparse(w, el.src, el.dst, T, masks=masks,
                                    record_every=5, device="cpu")
    _, dense5 = run_pushsum(w, adj, sched, record_every=5, device="cpu")
    assert torch.equal(sparse5, traj[4::5])
    assert torch.equal(dense5, dense_traj[4::5])


def test_dense_step_matches_reference_and_ignores_stray_mask_bits():
    adj, w = _random_graph(4, n=7)
    rng = np.random.default_rng(8)
    st = dense_state_from_numpy(w, np.ones(7, np.float32),
                                *(np.zeros(s, np.float32) for s in
                                  [(7, 3), (7,), (7, 7, 3), (7, 7)]))
    ref = jp.init_state(jnp.asarray(w))
    for _ in range(6):
        mask = rng.random((7, 7)) < 0.6          # stray bits off the graph
        st = pushsum_step(st, torch.from_numpy(mask), torch.from_numpy(adj))
        ref = jp.pushsum_step(ref, jnp.asarray(mask), jnp.asarray(adj))
    _close_states(st, ref, rtol=1e-6, atol=1e-6)
    off_graph = ~adj
    assert not st.rho[torch.from_numpy(off_graph)].any()
    assert not st.rho_m[torch.from_numpy(off_graph)].any()


def test_engine_rules():
    adj, w = _random_graph(0, n=6)
    el = jg.edge_list(adj)
    with pytest.raises(ValueError, match="rounds but T"):
        run_pushsum_sparse(w, el.src, el.dst, 4,
                           masks=np.ones((3, el.E), bool), device="cpu")
    with pytest.raises(ValueError, match="dst-sorted"):
        run_pushsum_sparse(w, el.src, el.dst, 2, device="cpu",
                           plan=ExecutionPlan(dst_sorted=True))
    with pytest.raises(ValueError, match="CUDA tensors"):
        run_pushsum_sparse(w, el.src, el.dst, 2, device="cpu",
                           plan=ExecutionPlan(backend="cuda"))
    # padding edges carry nothing: the same run with two inert edges
    src = np.concatenate([el.src, [0, 1]]).astype(np.int32)
    dst = np.concatenate([el.dst, [5, 5]]).astype(np.int32)
    valid = np.concatenate([np.ones(el.E, bool), [False, False]])
    a, ta = run_pushsum_sparse(w, el.src, el.dst, 9, drop_prob=0.2,
                               key=prng_key(1), device="cpu")
    b, tb = run_pushsum_sparse(w, src, dst, 9, drop_prob=0.2, valid=valid,
                               key=prng_key(1), device="cpu")
    assert torch.equal(a.zm, b.zm)
    assert torch.equal(a.rho_zm, b.rho_zm[:el.E])
    assert not b.rho_zm[el.E:].any()
