"""The edge-partitioned push-sum in the port (``repro_torch.core.graphs.
partition_edge_list``, ``pushsum.shard_edge_mask``, the windowed fault
draws, ``sparse_pushsum_step(graph_axis=)``, ``run_pushsum_sweep(
graph_shards=)`` and the social and HPS loops with an axis) against
``repro.core`` and against the port's own unsharded runs, on one process
(the emulated axis: all S shards in one K1 launch).

What is bit-equal and what is not. One round from the same state gives a
receiver whose in-edges lie on one shard exactly the unsharded round's
value on ``EdgeShards.padded_edge_list()`` (its other shards add +0.0);
a boundary receiver (its run split by a cut) sums its two parts in
another order, within the float32 recursive-summation bound ``deg * 2^-23
* sum |increment|``. Over T rounds a boundary receiver's last-bit
difference reaches its out-neighbours, so whole runs are bit-equal only
where the cut has no boundary receiver (or one shard); otherwise they are
held within the sweep tolerance of ``tests/test_torch_sweeps.py`` (rtol
1e-4 / atol 1e-5), as are the port's rows against the reference's
unsharded ``run_pushsum_sweep`` on the padded list. (The reference's own
sharded emulation fails under jax 0.9, so it is not an oracle here.)
The multi-process axis is held against this emulation in
``tests/test_torch_distributed_engines.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import repro.core.faults as jfa
import repro.core.graphs as jg
import repro.core.pushsum as jp
import repro.core.sweeps as js
import repro_torch.core.graphs as tg
from repro_torch.analysis.roofline import pushsum_halo_wire_bytes
from repro_torch.core import faults as tfa
from repro_torch.core import hps as th
from repro_torch.core import social as tsoc
from repro_torch.core import sweeps as ts
from repro_torch.core.graphs import partition_edge_list
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.prng import Key, fold_rounds, prng_key
from repro_torch.core.pushsum import (EmulatedAxis, GraphAxis, edge_mask,
                                      edge_index_tensors, init_sparse_state,
                                      partitioned_edges, shard_edge_mask,
                                      sparse_pushsum_step)
from repro_torch.core.signals import make_confused_model

TOL = dict(rtol=1e-4, atol=1e-5)
# the mass gaps are float32 round-off of sums over ~100 agents and ~500
# edges (~1e-5 each), so they are held in absolute terms
GAP_TOL = dict(rtol=0, atol=1e-4)
EPS32 = 2.0 ** -23


def _graph(n=90, extra=2.5, seed=0, sort=False, g=tg):
    return g.random_strongly_connected_edge_list(
        n, extra, np.random.default_rng(seed), sort=sort)


def _ragged(g):
    """Three topology draws of one N with different edge counts, stacked
    (padding edges 0 -> 0, valid False) and unsorted."""
    rng = np.random.default_rng(3)
    adjs = [g.random_strongly_connected(24, p, rng) for p in (0.1, 0.3, 0.2)]
    return g.stack_edge_lists(adjs)


# ---------------------------------------------------------------------------
# The partitioner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["plain", "batched"])
@pytest.mark.parametrize("S", [1, 2, 3, 8])
def test_partition_is_the_references(S, kind):
    if kind == "plain":
        el_t, el_j = _graph(), _graph(g=jg)
    else:
        el_t, el_j = _ragged(tg), _ragged(jg)
    got, want = partition_edge_list(el_t, S), jg.partition_edge_list(el_j, S)
    for f in ("src", "dst", "valid", "boundary"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    assert (got.n, got.e_total, got.n_shards, got.e_shard, got.e_pad,
            got.is_batched) == (want.n, want.e_total, want.n_shards,
                                want.e_shard, want.e_pad, want.is_batched)
    pad_t, pad_j = got.padded_edge_list(), want.padded_edge_list()
    for f in ("src", "dst", "valid"):
        np.testing.assert_array_equal(getattr(pad_t, f), getattr(pad_j, f))
    assert tg.is_dst_sorted(got.dst)
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        partition_edge_list(el_t, 0)


def test_layout_of_the_held_shards():
    """Shard-major slots: src node ids k n + u, dst slots (j K + k) n + v,
    sorted, with CSR offsets over local K n receivers."""
    sh = partition_edge_list(_ragged(tg), 3)
    axis = EmulatedAxis(3)
    rows = np.array([0, 2, 2, 1])
    src, dst, valid, offsets = partitioned_edges(
        sh.src[rows], sh.dst[rows], sh.valid[rows], sh.n, axis)
    K, e, n = 4, sh.e_shard, sh.n
    assert src.shape == dst.shape == valid.shape == (3 * K * e,)
    assert offsets.shape == (3 * K * n + 1,)
    assert bool((dst[1:] >= dst[:-1]).all())
    s3, d3, v3 = (x.view(3, K, e).numpy() for x in (src, dst, valid))
    for j in range(3):
        for k, g in enumerate(rows):
            np.testing.assert_array_equal(s3[j, k], sh.src[g, j] + k * n)
            np.testing.assert_array_equal(d3[j, k],
                                          sh.dst[g, j] + (j * K + k) * n)
            np.testing.assert_array_equal(v3[j, k], sh.valid[g, j])
    np.testing.assert_array_equal(
        offsets.numpy(), tg._dst_offsets(dst.numpy(), 3 * K * n))


# ---------------------------------------------------------------------------
# The windowed draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [2, 3])
def test_shard_masks_and_fault_draws_are_slices_of_the_padded_draw(S):
    """The emulated axis' (S, K, e) window of every draw, shard s's row,
    is the reference's E_pad draw sliced at [s e, (s+1) e): the link mask
    (plain fold and a strided fold), the edge uniforms of the fault plane
    and one Gilbert–Elliott step."""
    sh = partition_edge_list(_graph(), S)
    e, E = sh.e_shard, sh.e_pad
    axis = EmulatedAxis(S)
    drop = torch.tensor(0.3)
    B = torch.tensor(3, dtype=torch.int32)
    for t in (0, 2, 7):
        for fold in (None, 2 * t + 1):
            got = shard_edge_mask(prng_key(5), t, e, drop, B,
                                  graph_axis=axis, fold_t=fold)
            want = np.asarray(jp.step_edge_mask(
                jax.random.PRNGKey(5), jnp.uint32(t), E, 0.3, 3,
                fold_t=fold))
            for s in range(S):
                np.testing.assert_array_equal(
                    got.view(S, e)[s].numpy(), want[s * e:(s + 1) * e])
        u = tfa.edge_uniforms(prng_key(5), t, e, "cpu", graph_axis=axis)
        uj = np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.PRNGKey(5), t), (E,)))
        np.testing.assert_array_equal(u.numpy(), uj)
    # K keys at once: row k of the (S, K, e) window is key k's slice
    keys = fold_rounds(Key(np.zeros(3, np.int64), np.arange(3)), [4], None)
    drops = torch.tensor([0.1, 0.5, 0.9])
    Bs = torch.tensor([2, 3, 4], dtype=torch.int32)
    got = edge_mask(Key(keys.k0[0], keys.k1[0]), 4, E, drops, Bs,
                    axis).view(S, 3, e)
    for k in range(3):
        want = np.asarray(jp.step_edge_mask(
            jax.random.PRNGKey(k), jnp.uint32(4), E, float(drops[k]),
            int(Bs[k])))
        for s in range(S):
            np.testing.assert_array_equal(got[s, k].numpy(),
                                          want[s * e:(s + 1) * e])
    # the fault chain's edge step and churn, windowed
    fm = tfa.make_fault_model(p_gb=0.3, p_bg=0.4, leave_prob=0.2,
                              join_prob=0.5)
    fmj = jfa.make_fault_model(p_gb=0.3, p_bg=0.4, leave_prob=0.2,
                               join_prob=0.5)
    fs = tfa.init_fault_state(sh.n, E)
    fsj = jfa.init_fault_state(sh.n, E)
    for t in range(3):
        fs = tfa.step_faults(prng_key(9), t, fm, fs, engine=0,
                             graph_axis=axis)
        fsj = jfa.step_faults(jax.random.PRNGKey(9), jnp.uint32(t), fmj,
                              fsj, engine=0)
        np.testing.assert_array_equal(fs.edge_bad.numpy(),
                                      np.asarray(fsj.edge_bad))
        np.testing.assert_array_equal(fs.node_live.numpy(),
                                      np.asarray(fsj.node_live))
    assert fs.edge_bad.any() and not fs.edge_bad.all()


# ---------------------------------------------------------------------------
# One round, sharded against unsharded
# ---------------------------------------------------------------------------

def _round_pair(sh, S, d=2, rounds=6, policy=None, halo="psum"):
    """The unsharded state on the padded list after ``rounds`` rounds, then
    one more round unsharded and one sharded (emulated axis) from it ->
    (unsharded zm, sharded zm, per-receiver in-degree and sum of
    |increments| of the last round)."""
    pad = sh.padded_edge_list()
    src, dst, valid, offsets = edge_index_tensors(pad)
    n = sh.n
    axis = EmulatedAxis(S)
    src_l, dst_l, valid_l, off_l = partitioned_edges(
        sh.src[None], sh.dst[None], sh.valid[None], n, axis)
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=(n, d)).astype(np.float32))
    state = init_sparse_state(w, pad.E, policy)
    drop, B = torch.tensor(0.25), torch.tensor(3, dtype=torch.int32)
    for t in range(rounds + 1):
        mask = torch.from_numpy(np.array(jp.step_edge_mask(
            jax.random.PRNGKey(2), jnp.uint32(t), pad.E, 0.25, 3)))
        if t == rounds:
            # K = 1: the (S, 1, e) layout is the padded order itself
            assert torch.equal(mask, shard_edge_mask(
                prng_key(2), t, sh.e_shard, drop, B, graph_axis=axis))
            prev = state
            sharded = sparse_pushsum_step(state, mask, src_l, dst_l,
                                          valid_l, offsets=off_l,
                                          policy=policy, graph_axis=axis,
                                          halo=halo)
        state = sparse_pushsum_step(state, mask, src, dst, valid,
                                    offsets=offsets, policy=policy)
    inc = (state.rho_zm.float() - prev.rho_zm.float()).abs()
    sumabs = torch.zeros((n, d + 1)).index_add_(0, dst.long(), inc)
    deg = torch.bincount(dst.long()[valid], minlength=n)
    return state, sharded, deg, sumabs


@pytest.mark.parametrize("S", [2, 3, 8])
def test_one_round_interior_bit_equal_boundary_within_bound(S):
    sh = partition_edge_list(_graph(n=120, extra=3.0, seed=4), S)
    bnd = torch.from_numpy(sh.boundary)
    assert int(bnd.sum()) > 0, "pick a cut with boundary receivers"
    want, got, deg, sumabs = _round_pair(sh, S)
    assert torch.equal(got.rho_zm, want.rho_zm)
    for f in ("zm", "sigma_zm"):
        a, b = getattr(got, f), getattr(want, f)
        assert torch.equal(a[~bnd], b[~bnd]), f
        bound = (deg[bnd, None] * EPS32 * sumabs[bnd]
                 + EPS32 * b[bnd].abs())
        assert bool(((a[bnd] - b[bnd]).abs() <= bound).all()), f


def test_wire_bytes_are_the_models():
    """The halo bytes the axis counts for one round at N % S == 0 are
    ``pushsum_halo_wire_bytes`` for both variants, float32 and bf16."""
    S = 4
    el = _graph(n=96, extra=2.0, seed=2)
    sh = partition_edge_list(el, S)
    for halo, policy, sb in (("psum", None, 4), ("scatter", None, 4),
                             ("scatter", "bf16", 2)):
        GraphAxis.wire_bytes = 0.0
        _round_pair(sh, S, d=1, rounds=0, policy=policy, halo=halo)
        assert GraphAxis.wire_bytes == pushsum_halo_wire_bytes(
            96, 1, S, variant=halo, storage_bytes=sb), (halo, policy)
    GraphAxis.wire_bytes = 0.0


def test_scatter_under_bf16_rounds_the_reduced_rows():
    """``halo="scatter"`` casts each receiver's reduced partial sum to the
    storage dtype before the gather: under bf16 the round differs from
    the psum round by that one rounding, and is the psum round where the
    sums are bf16 numbers already (S = 1, fp32: the same round)."""
    sh = partition_edge_list(_graph(n=80, extra=2.0, seed=6), 3)
    ref, ps, _, _ = _round_pair(sh, 3, policy="bf16", halo="psum")
    _, sc, _, _ = _round_pair(sh, 3, policy="bf16", halo="scatter")
    assert sc.zm.dtype == torch.bfloat16
    assert torch.equal(sc.rho_zm, ps.rho_zm)
    diff = (sc.zm.float() - ps.zm.float()).abs()
    assert float(diff.max()) > 0
    # two bf16 roundings at most: the reduced rows', then the state's
    assert bool((diff <= 2 ** -7 * ps.zm.float().abs() + 1e-30).all())
    _, a, _, _ = _round_pair(sh, 3, halo="scatter")
    _, b, _, _ = _round_pair(sh, 3, halo="psum")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

def _sweep(el, T=20, plan=None, **kw):
    w = np.random.default_rng(7).normal(size=(el.n, 2)).astype(np.float32)
    return ts.run_pushsum_sweep(w, el, T, drop_probs=[0.0, 0.3],
                                seeds=[0, 4], B=3, plan=plan, device="cpu",
                                **kw), w


@pytest.mark.parametrize("halo", ["psum", "scatter"])
def test_one_shard_is_the_unsharded_sweep(halo):
    el = _ragged(tg)
    plans = [ExecutionPlan(), ExecutionPlan(
        faults=tfa.gilbert_elliott_model(4.0, 0.3, leave_prob=0.05))]
    for plan in plans:
        got, _ = _sweep(el, plan=plan.replace(graph_shards=1, halo=halo))
        want, _ = _sweep(partition_edge_list(el, 1).padded_edge_list(),
                         plan=plan)
        for f in ("err", "final_ratio", "mass_gap", "drop_prob", "seed",
                  "graph"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("S", [2, 3, 8])
def test_sharded_sweep_against_the_unsharded_and_the_reference(S):
    el = _graph(n=120, extra=3.0, seed=4)
    sh = partition_edge_list(el, S)
    assert sh.boundary.sum() > 0
    got, w = _sweep(el, plan=ExecutionPlan(graph_shards=S))
    pad = sh.padded_edge_list()
    want, _ = _sweep(pad)
    ref = js.run_pushsum_sweep(
        w, jg.EdgeList(src=pad.src, dst=pad.dst, n=pad.n, valid=pad.valid),
        20, drop_probs=[0.0, 0.3], seeds=[0, 4], B=3)
    for other in (want, ref):
        for f, tol in (("err", TOL), ("final_ratio", TOL),
                       ("mass_gap", GAP_TOL)):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(other, f)), **tol,
                                       err_msg=f)
    np.testing.assert_array_equal(got.seed.numpy(), np.asarray(ref.seed))
    # the same rows from an EdgeShards passed as the edge list
    again, _ = _sweep(sh)
    assert all(torch.equal(getattr(again, f), getattr(got, f))
               for f in ("err", "final_ratio", "mass_gap"))


def _boundary_free():
    """8 complete 6-agent networks (in-degree 5), E = 240 = 4 x 60: each
    cut falls between two receivers' runs."""
    el, rep = tg.hier_edge_list([6] * 8, "complete")
    return el, rep


@pytest.mark.parametrize("faults", [False, True])
def test_boundary_free_cut_is_bit_equal(faults):
    el, _ = _boundary_free()
    sh = partition_edge_list(el, 4)
    assert sh.boundary.sum() == 0 and sh.e_pad == el.E
    plan = ExecutionPlan(faults=tfa.gilbert_elliott_model(
        4.0, 0.3, leave_prob=0.05, join_prob=0.5) if faults else None)
    got, _ = _sweep(el, plan=plan.replace(graph_shards=4))
    want, _ = _sweep(el, plan=plan)
    for f in ("err", "final_ratio"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    torch.testing.assert_close(got.mass_gap, want.mass_gap, **GAP_TOL)


# ---------------------------------------------------------------------------
# The Algorithm 3 and Algorithm 1 loops with an axis
# ---------------------------------------------------------------------------

def _sharded_runtime(rt, el, S):
    sh = partition_edge_list(el, S)
    edges = partitioned_edges(sh.src[None], sh.dst[None], sh.valid[None],
                              el.n, EmulatedAxis(S))
    return rt._replace(**dict(zip(("src", "dst", "valid", "offsets"),
                                  edges))), sh


def _social(rt, model, M, axis=None, plan_faults=None, store="trajectory"):
    tables = model.tables.float()
    return tsoc._social_scan_core(
        prng_key(0), prng_key(3), rt, torch.log(tables),
        torch.cumsum(tables[:, model.truth, :], dim=-1), truth=model.truth,
        M=M, T=24, store=store, backend="auto", faults=plan_faults,
        graph_axis=axis)


@pytest.mark.parametrize("sizes,S,free", [([6] * 8, 4, True),
                                          ([5] * 7, 3, False)])
def test_social_and_hps_loops_with_an_axis(sizes, S, free):
    """Boundary-free cuts give the unsharded loops' results bit for bit
    (with the fault plane too); cuts with boundary receivers stay within
    the engines' tolerances."""
    el, rep = tg.hier_edge_list(sizes, "complete")
    N, M = el.n, len(sizes)
    model = make_confused_model(N=N, m=3, truth=1, confusion=0.4, seed=0)
    fm = tfa.gilbert_elliott_model(4.0, 0.3, leave_prob=0.05,
                                   join_prob=0.5, ps_crash_prob=0.2)
    pad = partition_edge_list(el, S).padded_edge_list()
    srt = tsoc.social_runtime_from_edge_list(pad, rep, drop_prob=0.3,
                                             gamma_period=4, B=2)
    hrt = th.hps_runtime_from_edge_list(pad, rep, drop_prob=0.3,
                                        gamma_period=4, B=2)
    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=(N, 3)).astype(np.float32))
    for faults in (None, fm):
        srt_s, sh = _sharded_runtime(srt, el, S)
        assert (sh.boundary.sum() == 0) == free
        want = _social(srt, model, M, plan_faults=faults)
        got = _social(srt_s, model, M, EmulatedAxis(S), faults)
        hrt_s, _ = _sharded_runtime(hrt, el, S)
        hw = th._hps_scan_core(prng_key(1), hrt, w, T=24, store="gap",
                               backend="auto", faults=faults)
        hg = th._hps_scan_core(prng_key(1), hrt_s, w, T=24, store="gap",
                               backend="auto", faults=faults,
                               graph_axis=EmulatedAxis(S))
        if free:
            assert torch.equal(got[1][0], want[1][0])
            assert torch.equal(got[1][1], want[1][1])
            assert torch.equal(hg[1][0], hw[1][0])
            assert torch.equal(hg[1][1], hw[1][1])
        else:
            torch.testing.assert_close(got[1][0], want[1][0], rtol=0,
                                       atol=1e-3)
            torch.testing.assert_close(hg[1][0], hw[1][0], **TOL)
            torch.testing.assert_close(hg[1][1], hw[1][1], **TOL)


# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------

def test_value_errors():
    from repro_torch.core.asyncrony import (init_async_buffer,
                                            make_async_model)
    el = _graph(n=40, extra=1.0)
    sh = partition_edge_list(el, 2)
    axis = EmulatedAxis(2)
    am = make_async_model(0.6, 2)
    w = np.zeros((40, 2), np.float32)
    with pytest.raises(ValueError, match="async_ is incompatible"):
        ts.run_pushsum_sweep(w, el, 3, plan=ExecutionPlan(graph_shards=2,
                                                          async_=am),
                             device="cpu")
    with pytest.raises(ValueError, match="EdgeShards has 2 shards"):
        ts.run_pushsum_sweep(w, sh, 3, plan=ExecutionPlan(graph_shards=3),
                             device="cpu")
    src, dst, valid, off = partitioned_edges(sh.src[None], sh.dst[None],
                                             sh.valid[None], 40, axis)
    state = init_sparse_state(torch.zeros(40, 2), src.shape[0])
    with pytest.raises(ValueError, match="async mode does not compose"):
        sparse_pushsum_step(
            state, valid, src, dst, valid, offsets=off, graph_axis=axis,
            awake=torch.ones(40, dtype=torch.bool),
            abuf=init_async_buffer(src.shape[0], 3),
            staleness=torch.tensor(2))
    with pytest.raises(ValueError, match="halo="):
        sparse_pushsum_step(state, valid, src, dst, valid, offsets=off,
                            graph_axis=axis, halo="ring")
    el_h, rep = tg.hier_edge_list([6] * 4, "complete")
    srt_s, _ = _sharded_runtime(tsoc.social_runtime_from_edge_list(
        el_h, rep, drop_prob=0.1, gamma_period=4), el_h, 2)
    model = make_confused_model(N=24, m=3, truth=0, confusion=0.4, seed=0)
    with pytest.raises(ValueError, match="async mode does not compose"):
        tables = model.tables.float()
        tsoc._social_scan_core(
            prng_key(0), prng_key(0), srt_s, torch.log(tables),
            torch.cumsum(tables[:, 0, :], -1), truth=0, M=4, T=2,
            store="final", backend="auto", async_=am, graph_axis=axis)
    hrt_s, _ = _sharded_runtime(th.hps_runtime_from_edge_list(
        el_h, rep, drop_prob=0.1, gamma_period=4), el_h, 2)
    with pytest.raises(ValueError, match="incompatible with graph_axis"):
        th._hps_scan_core(prng_key(0), hrt_s, torch.zeros(24, 2), T=2,
                          store="final", backend="auto", async_=am,
                          graph_axis=axis)
    with pytest.raises(ValueError, match="1-D edge_bad"):
        tfa.step_faults(prng_key(0), 0, tfa.make_fault_model(),
                        tfa.init_fault_state(4, (4, 3)), engine=3,
                        graph_axis=axis)
    for bad in (dict(halo="ring"), dict(graph_shards=0)):
        with pytest.raises(ValueError):
            ts.run_pushsum_sweep(w, el, 3, plan=ExecutionPlan(**bad),
                                 device="cpu")
    with pytest.raises(ValueError, match="does not support the plan field "
                                         "'graph_shards'"):
        ts.run_social_grid(model, [], 2, 0, plan=ExecutionPlan(
            graph_shards=2), device="cpu")
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        EmulatedAxis(0)
