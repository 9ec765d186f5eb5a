"""The port's sparse push-sum rounds against ``repro.core.pushsum`` on ring,
complete and random digraphs, across drop rates and B-windows, fed the same
bit-equal link masks; plus the mass invariant and the numpy carry-across.

Both sides run the same fp32 recursion op by op (the reference eagerly
here, so XLA fuses no multiply-add across ops) and sum each receiver's
increments in edge order, so the states are bit-equal after 40 rounds. The
invariant is held to fp32 summation accuracy (rtol 1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.graphs as jg
import repro.core.pushsum as jp
from repro_torch.convert import sparse_state_from_numpy
from repro_torch.core.graphs import edge_list, sort_by_dst
from repro_torch.core.prng import prng_key
from repro_torch.core.pushsum import (
    _out_degree,
    init_sparse_state,
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
