"""The precision policy in the port (``repro_torch.core.precision``) against
``repro.core.precision``: the policy object, the plan errors, the cast
points of the sparse push-sum step, the three kernels' plain versions at
half storage, the four engines and their grids under ``"bf16"``, and the
bf16 error envelope of ``tests/test_bf16_envelope.py`` on the port.

Tolerances and why:

* ``policy="fp32"`` is the pre-policy program: bit-identical to
  ``policy=None`` in every engine and grid.
* The sparse step under bf16 and fp16 storage, synchronous, async and
  faulted, is bit-equal to the reference's eager step over 24 rounds:
  both sides stage in float32, round to storage once, sum each receiver's
  float32 increments in edge order and re-stage from the rounded value.
* K1's plain version is bit-equal to the reference's (the same
  edge-order float32 sum); K2's ``z_new`` is bit-equal and ``mu`` within
  the float32 bound of the softmax (1e-6); K3's ``tsum`` is the float32
  sum of the same sorted survivors in another order: within 4 float32
  ulps of the sum of magnitudes (``deg_max`` <= 8 terms).
* The engines under bf16: HPS (both PS rules) bit-equal to the
  reference's eager bf16 run; against the jitted scans, whose fused
  float32 arithmetic (contracted multiply-adds, reassociated pools) can
  flip a bf16 rounding that the cumulative bf16 relay then keeps, HPS's
  ratios within one bf16 ulp of the input spread at T = 24; Alg. 3's
  state, push-sum under a plane and Alg. 2 under ``sign_flip`` bit-equal
  to the jitted runs, Alg. 3's beliefs within 1e-5 (two softmaxes);
  ``random_noise``'s lies differ from the reference's by a float32 ulp,
  so its decisions are held on clear agents. The grids' rows are the
  port's single runs bit for bit.
* The envelope classes keep ``tests/test_bf16_envelope.py``'s constants.
* ``compute="bfloat16"``: XLA on the CPU may keep float32 between fused
  bf16 ops where the port rounds after each, so the step is held to 2 bf16
  ulps of the state's scale a round, not bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

import repro.core.byzantine as jb
import repro.core.faults as jf
import repro.core.asyncrony as ja
import repro.core.attacks as jat
import repro.core.graphs as jg
import repro.core.hps as jh
import repro.core.precision as jprec
import repro.core.pushsum as jp
import repro.core.signals as jsig
import repro.core.social as jsoc
import repro.core.sweeps as jsw
import repro.kernels.byz_trim.ref as jk3
import repro.kernels.pushsum_edge.ref as jk1
import repro.kernels.social_innov.ref as jk2
from repro.core.plan import ExecutionPlan as JaxPlan
import repro_torch.core.asyncrony as ta
import repro_torch.core.attacks as tat
import repro_torch.core.byzantine as tb
import repro_torch.core.faults as tf
import repro_torch.core.graphs as tg
import repro_torch.core.hps as th
import repro_torch.core.precision as tprec
import repro_torch.core.pushsum as tp
import repro_torch.core.signals as tsig
import repro_torch.core.social as tsoc
import repro_torch.core.sweeps as tsw
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.prng import prng_key
from repro_torch.kernels.byz_trim import trim_gather, trim_gather_cuda
from repro_torch.kernels.byz_trim.ref import trim_gather_ref
from repro_torch.kernels.pushsum_edge import edge_scatter, edge_scatter_cuda
from repro_torch.kernels.pushsum_edge.ref import edge_scatter_ref
from repro_torch.kernels.social_innov import innovation_cuda, innovation_step
from repro_torch.kernels.social_innov.ref import innovation_ref

HALF = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
        "float16": (torch.float16, jnp.float16)}
EPS_BF16 = 2.0 ** -8          # bfloat16 unit roundoff (8 mantissa bits)


def _np(x):
    """A torch or jax array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _same(got, want, what=""):
    np.testing.assert_array_equal(_np(got), _np(want), err_msg=what)


# ---------------------------------------------------------------------------
# The policy object and the plan
# ---------------------------------------------------------------------------

POLICIES = [None, "fp32", "bf16", ("float16", "float32", "float32"),
            ("bfloat16", "bfloat16", "float32"),
            ("float32", "float32", "float64")]


@pytest.mark.parametrize("spec", POLICIES)
def test_policy_matches_reference(spec):
    if isinstance(spec, tuple):
        pt, pj = tprec.Policy(*spec), jprec.Policy(*spec)
    else:
        pt, pj = spec, spec
    rt, rj = tprec.resolve_policy(pt), jprec.resolve_policy(pj)
    assert tuple(rt) == tuple(rj)
    assert rt.tag() == rj.tag()
    assert rt.storage_bytes == rj.storage_bytes
    assert rt.is_default == rj.is_default
    # without 64-bit mode the reference's arrays take float64 as float32
    for slot in ("storage", "compute", "accum"):
        want = jnp.zeros(2, jnp.float32).astype(getattr(rj, f"{slot}_dtype"))
        got = torch.zeros(2).to(getattr(rt, f"{slot}_dtype"))
        assert str(got.dtype).split(".")[-1] == str(want.dtype)


@pytest.mark.parametrize("bad", [
    "bf32", tprec.Policy(storage="float64"), tprec.Policy(compute="int8"),
    tprec.Policy(accum="bfloat16"), tprec.Policy(accum="float16")])
def test_bad_policies_raise_as_the_reference(bad):
    jbad = bad if isinstance(bad, str) else jprec.Policy(*bad)
    with pytest.raises(ValueError):
        jprec.resolve_policy(jbad)
    with pytest.raises(ValueError):
        tprec.resolve_policy(bad)
    el, w = _graph(10, 0)
    with pytest.raises(ValueError):
        tp.run_pushsum_sparse(w, el.src, el.dst, 2, device="cpu",
                              plan=ExecutionPlan(policy=bad))
    with pytest.raises(TypeError):
        tprec.resolve_policy(16)


def test_every_entry_point_honours_the_policy():
    """Each entry point the reference gives ``policy`` takes it and stores
    its state at the storage dtype, its outputs float32."""
    el, wp = _graph(8, 0)
    w = np.random.default_rng(3).normal(size=(18, 4)).astype(np.float32)
    cfg = th.HPSConfig(_hier(tg), 4, B=2, drop_prob=0.2)
    model = tsig.make_confused_model(N=18, m=3, truth=1, confusion=0.3,
                                     seed=0)
    bcfg = _byz_cfg(tg, "sign_flip")
    plan = ExecutionPlan(policy="bf16")
    cpu = dict(device="cpu")
    st, tr = tp.run_pushsum_sparse(wp, el.src, el.dst, 2, plan=plan, **cpu)
    assert st.zm.dtype == torch.bfloat16 and tr.dtype == torch.float32
    for res in (th.run_hps(w, cfg, 2, plan=plan, **cpu),
                th.run_hps_runtime(w, th.make_hps_runtime(cfg), 2, plan=plan,
                                   **cpu)):
        assert res.final_state.zm.dtype == torch.bfloat16
        assert res.ratio.dtype == res.gap.dtype == torch.float32
    for res in (tsoc.run_social_learning(model, cfg, 2, plan=plan, **cpu),
                tsoc.run_social_runtime(model, tsoc.make_social_runtime(cfg),
                                        3, 2, plan=plan, **cpu)):
        assert res.final_state.zm.dtype == torch.bfloat16
        assert res.beliefs.dtype == res.log_ratio.dtype == torch.float32
    rt, extra, n_reps = tb.make_byzantine_runtime(model, bcfg)
    for res in (tb.run_byzantine_learning(model, bcfg, 2, plan=plan, **cpu),
                tb.run_byzantine_learning_ovr(model, bcfg, 2, plan=plan,
                                              **cpu),
                tb.run_byzantine_runtime(model, rt, extra, n_reps,
                                         bcfg.attack, 2, plan=plan, **cpu),
                tb.make_byzantine_scan(model, bcfg, 2, policy="bf16",
                                       **cpu)(prng_key(0))):
        assert res.r.dtype == torch.float32
    sweeps = (
        tsw.run_pushsum_sweep(wp, el, 2, seeds=[0, 1], plan=plan, **cpu).err,
        tsw.run_hps_grid(w, [cfg], 2, [0], plan=plan, **cpu).gap,
        tsw.run_hps_sweep(w, cfg, 2, seeds=[0], plan=plan, **cpu).gap,
        tsw.run_social_grid(model, [cfg], 2, [0], plan=plan, **cpu).beliefs,
        tsw.run_social_sweep(model, cfg, 2, seeds=[0], plan=plan,
                             **cpu).beliefs,
        tsw.run_byzantine_grid(model, [bcfg], 2, [0], plan=plan, **cpu).r,
        tsw.run_byzantine_sweep(model, bcfg, 2, [0], plan=plan,
                                **cpu)["sign_flip"].r)
    assert all(x.dtype == torch.float32 for x in sweeps)
    with pytest.raises(ValueError, match="policy"):
        tp.run_pushsum_sparse(wp, el.src, el.dst, 2, device="cpu",
                              plan=ExecutionPlan(policy="fp16"))


# ---------------------------------------------------------------------------
# The sparse step's cast points, bit for bit
# ---------------------------------------------------------------------------

def _graph(n, seed):
    rng = np.random.default_rng(seed)
    el = jg.sort_by_dst(jg.edge_list(jg.random_strongly_connected(
        n, 0.25, rng)))[0]
    return el, rng.normal(size=(n, 3)).astype(np.float32)


ROUNDS = 24


@pytest.mark.parametrize("storage", sorted(HALF))
@pytest.mark.parametrize("plane", ["sync", "async", "faulted"])
def test_sparse_step_bit_equal_to_reference(storage, plane):
    el, w = _graph(24, 1)
    n, E, d = w.shape[0], el.E, w.shape[1]
    rng = np.random.default_rng(5)
    masks = rng.random((ROUNDS, E)) < 0.8
    awake = rng.random((ROUNDS, n)) < 0.6
    alive = rng.random((ROUNDS, n)) < 0.85
    pt, pj = tprec.Policy(storage=storage), jprec.Policy(storage=storage)
    st = tp.init_sparse_state(torch.from_numpy(w), E, pt)
    sj = jp.init_sparse_state(jnp.asarray(w), E, policy=pj)
    assert st.zm.dtype == HALF[storage][0]
    bt = ta.init_async_buffer(E, d, st.zm.dtype)
    bj = ja.init_async_buffer(E, d, sj.z.dtype)
    src, dst = torch.from_numpy(el.src), torch.from_numpy(el.dst)
    valid = torch.ones(E, dtype=torch.bool)
    stale = 2
    for t in range(ROUNDS):
        mt, mj = torch.from_numpy(masks[t]), jnp.asarray(masks[t])
        kw_t, kw_j = {}, {}
        if plane == "faulted":
            live = alive[t]
            kw_t["faults"] = tf.FaultState(
                torch.zeros(E, dtype=torch.bool), torch.from_numpy(live))
            kw_j["faults"] = jf.FaultState(jnp.zeros(E, bool),
                                           jnp.asarray(live))
        if plane == "async":
            kw_t.update(awake=torch.from_numpy(awake[t]), abuf=bt,
                        staleness=torch.tensor(stale, dtype=torch.int32))
            kw_j.update(awake=jnp.asarray(awake[t]), abuf=bj,
                        staleness=jnp.asarray(stale, jnp.int32))
        out_t = tp.sparse_pushsum_step(st, mt, src, dst, valid, policy=pt,
                                       **kw_t)
        out_j = jp.sparse_pushsum_step(sj, mj, el.src, el.dst,
                                       jnp.asarray(valid.numpy()), "xla",
                                       dst_sorted=True, policy=pj, **kw_j)
        if plane == "async":
            (st, bt), (sj, bj) = out_t, out_j
            _same(bt.snap[:, :-1], bj.snap, "snap")
            _same(bt.snap_m, bj.snap_m, "snap_m")
            assert bt.snap.dtype == st.zm.dtype
        else:
            st, sj = out_t, out_j
    for f in ("z", "m", "sigma", "sigma_m", "rho", "rho_m"):
        assert getattr(st, f).dtype == HALF[storage][0]
        _same(getattr(st, f), getattr(sj, f), f)
    _same(tp.sparse_ratios(st), jp.sparse_ratios(sj), "ratios")
    assert tp.sparse_ratios(st).dtype == torch.float32
    inv = tp.sparse_mass_invariant(st, src, valid)
    np.testing.assert_allclose(
        inv[:-1].numpy(),
        np.asarray(jp.sparse_mass_invariant(sj, jnp.asarray(el.src),
                                            jnp.asarray(valid.numpy()))),
        rtol=1e-5, atol=1e-5)


def test_float64_accum_runs_as_the_reference_float32():
    """The reference runs without 64-bit mode: ``accum="float64"`` is a
    float32 accumulation there, and the port's is the same program."""
    el, w = _graph(16, 2)
    E = el.E
    masks = np.random.default_rng(3).random((8, E)) < 0.7
    src, dst = torch.from_numpy(el.src), torch.from_numpy(el.dst)
    valid = torch.ones(E, dtype=torch.bool)
    p64 = tprec.Policy(storage="bfloat16", accum="float64")
    p32 = tprec.Policy(storage="bfloat16")
    a = b = tp.init_sparse_state(torch.from_numpy(w), E, p64)
    sj = jp.init_sparse_state(jnp.asarray(w), E,
                              policy=jprec.Policy("bfloat16", "float32",
                                                  "float64"))
    for t in range(8):
        mt = torch.from_numpy(masks[t])
        a = tp.sparse_pushsum_step(a, mt, src, dst, valid, policy=p64)
        b = tp.sparse_pushsum_step(b, mt, src, dst, valid, policy=p32)
        sj = jp.sparse_pushsum_step(
            sj, jnp.asarray(masks[t]), el.src, el.dst,
            jnp.asarray(valid.numpy()), "xla", dst_sorted=True,
            policy=jprec.Policy("bfloat16", "float32", "float64"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    _same(a.z, sj.z, "z")
    _same(a.rho_m, sj.rho_m, "rho_m")


def test_bf16_compute_policy_within_tolerance():
    """``compute="bfloat16"``: XLA may keep float32 between fused bf16 ops
    where the port rounds after each op; held to 2 bf16 ulps of the
    state's scale a round (12 rounds)."""
    el, w = _graph(16, 4)
    E = el.E
    masks = np.random.default_rng(6).random((12, E)) < 0.8
    pt = tprec.Policy("bfloat16", "bfloat16", "float32")
    pj = jprec.Policy("bfloat16", "bfloat16", "float32")
    st = tp.init_sparse_state(torch.from_numpy(w), E, pt)
    sj = jp.init_sparse_state(jnp.asarray(w), E, policy=pj)
    src, dst = torch.from_numpy(el.src), torch.from_numpy(el.dst)
    valid = torch.ones(E, dtype=torch.bool)
    for t in range(12):
        st = tp.sparse_pushsum_step(st, torch.from_numpy(masks[t]), src, dst,
                                    valid, policy=pt)
        sj = jp.sparse_pushsum_step(sj, jnp.asarray(masks[t]), el.src,
                                    el.dst, jnp.asarray(valid.numpy()), "xla",
                                    dst_sorted=True, policy=pj)
    for f in ("z", "m", "sigma", "sigma_m"):
        got, want = _np(getattr(st, f)), _np(getattr(sj, f))
        scale = float(np.abs(want).max())
        assert np.abs(got - want).max() <= 2 * EPS_BF16 * 12 * scale, f


# ---------------------------------------------------------------------------
# The kernels' plain versions at half storage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", sorted(HALF))
@pytest.mark.parametrize("D", [4, 5])
def test_k1_plain_version_at_half_storage(storage, D):
    tdt, jdt = HALF[storage]
    rng = np.random.default_rng(D)
    el, _ = _graph(40, D)
    E, n = el.E, el.n
    sigma = rng.normal(size=(n, D)).astype(np.float32) * 30
    rho = rng.normal(size=(E, D)).astype(np.float32) * 30
    live = rng.random(E) < 0.6
    got = edge_scatter_ref(
        torch.from_numpy(sigma).to(tdt), torch.from_numpy(rho).to(tdt),
        torch.from_numpy(live), torch.from_numpy(el.src),
        torch.from_numpy(el.dst), accum_dtype=torch.float32)
    want = jk1.edge_scatter_ref(
        jnp.asarray(sigma).astype(jdt), jnp.asarray(rho).astype(jdt),
        jnp.asarray(live), jnp.asarray(el.src), jnp.asarray(el.dst),
        indices_sorted=True, accum_dtype="float32")
    assert got[0].dtype == tdt and got[1].dtype == torch.float32
    _same(got[0], want[0], "rho_new")
    _same(got[1], want[1], "recv")
    # the dispatcher's CPU route is the plain version
    via = edge_scatter(torch.from_numpy(sigma).to(tdt),
                       torch.from_numpy(rho).to(tdt), torch.from_numpy(live),
                       torch.from_numpy(el.src), torch.from_numpy(el.dst),
                       accum_dtype=torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(via, got))


@pytest.mark.parametrize("storage", sorted(HALF))
def test_k2_plain_version_at_half_storage(storage):
    tdt, jdt = HALF[storage]
    rng = np.random.default_rng(11)
    n, m, S = 300, 3, 4
    z = rng.normal(size=(n, m)).astype(np.float32) * 40
    mass = rng.uniform(0.05, 2.0, size=n).astype(np.float32)
    u = rng.random(n).astype(np.float32)
    probs = rng.dirichlet(np.ones(S), size=n).astype(np.float32)
    cdf = np.cumsum(probs, axis=1).astype(np.float32)
    lt = np.log(rng.dirichlet(np.ones(S), size=(n, m))).astype(np.float32)
    zt, mt = (torch.from_numpy(x).to(tdt) for x in (z, mass))
    got = innovation_ref(zt, mt, torch.from_numpy(u), torch.from_numpy(cdf),
                         torch.from_numpy(lt), accum_dtype=torch.float32)
    want = jk2.innovation_ref(
        jnp.asarray(z).astype(jdt), jnp.asarray(mass).astype(jdt),
        jnp.asarray(u), jnp.asarray(cdf), jnp.asarray(lt),
        accum_dtype="float32")
    assert got[0].dtype == tdt and got[1].dtype == torch.float32
    _same(got[0], want[0], "z_new")
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=0, atol=1e-6)
    via = innovation_step(zt, mt, torch.from_numpy(u), torch.from_numpy(cdf),
                          torch.from_numpy(lt), accum_dtype=torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(via, got))


@pytest.mark.parametrize("storage", sorted(HALF))
@pytest.mark.parametrize("per_receiver_f", [False, True])
def test_k3_plain_version_at_half_storage(storage, per_receiver_f):
    tdt, jdt = HALF[storage]
    rng = np.random.default_rng(17)
    n, dm, P = 200, 8, 9
    r = (rng.normal(size=(n, P)) * 20).astype(np.float32)
    idx = rng.integers(0, n, size=(n, dm)).astype(np.int32)
    valid = rng.random((n, dm)) < 0.85
    byz = rng.random((n, dm)) < 0.2
    msgs = (rng.normal(size=(n, dm, P)) * 500).astype(np.float32)
    F = (rng.integers(0, 3, size=n).astype(np.int32) if per_receiver_f
         else 2)
    rt_, mt_ = (torch.from_numpy(x).to(tdt) for x in (r, msgs))
    args_t = (rt_, torch.from_numpy(idx), torch.from_numpy(valid), mt_,
              torch.from_numpy(byz),
              torch.from_numpy(F) if per_receiver_f else F)
    tsum, kept = trim_gather_ref(*args_t, accum_dtype=torch.float32)
    rj, mj = jnp.asarray(r).astype(jdt), jnp.asarray(msgs).astype(jdt)
    if per_receiver_f:
        # the reference takes one F a call: each F's receivers apart
        want_t = []
        for f in np.unique(F):
            want = jk3.trim_gather_ref(rj, jnp.asarray(idx),
                                       jnp.asarray(valid), mj,
                                       jnp.asarray(byz), int(f),
                                       accum_dtype="float32")
            sel = F == f
            want_t.append((sel, _np(want[0])[sel], _np(want[1])[sel]))
        wt, wk = np.zeros((n, P), np.float32), np.zeros(n, np.float32)
        for sel, a, b in want_t:
            wt[sel], wk[sel] = a, b
    else:
        want = jk3.trim_gather_ref(rj, jnp.asarray(idx), jnp.asarray(valid),
                                   mj, jnp.asarray(byz), F,
                                   accum_dtype="float32")
        wt, wk = _np(want[0]), _np(want[1])
    assert tsum.dtype == torch.float32 and kept.dtype == torch.float32
    np.testing.assert_array_equal(kept.numpy(), wk)
    # the same survivors summed in another order: 4 float32 ulps of the
    # sum of their magnitudes
    vals = torch.where(torch.from_numpy(byz)[:, :, None], mt_,
                       rt_[torch.from_numpy(idx).long()]).float()
    mag = (vals.abs() * torch.from_numpy(valid)[:, :, None]).sum(1).numpy()
    assert (np.abs(tsum.numpy() - wt) <= 4 * 2.0 ** -24 * mag + 0).all()
    # a broadcast (stride-0) lie at half storage
    lie = torch.tensor(7.5, dtype=tdt).expand(n, dm, P)
    a = trim_gather(rt_, *args_t[1:3], lie, *args_t[4:],
                    accum_dtype=torch.float32)
    b = trim_gather_ref(rt_, *args_t[1:3], lie.contiguous(), *args_t[4:],
                        accum_dtype=torch.float32)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_cuda_routes_refuse_what_they_do_not_take():
    """The CUDA wrappers raise on a dtype they do not take, before anything
    else, and the dispatchers raise on a half input without a float32
    accumulation instead of rerouting; nothing falls back to the plain
    version."""
    n, D = 6, 4
    idx = torch.zeros(n, dtype=torch.int32)
    live = torch.ones(n, dtype=torch.bool)
    for dt in (torch.float64, torch.int32):
        x = torch.zeros((n, D), dtype=dt)
        with pytest.raises(ValueError, match="storage"):
            edge_scatter_cuda(x, x, live, idx, torch.zeros(n + 1, dtype=torch.int32))
        with pytest.raises(ValueError, match="storage"):
            innovation_cuda(x[:, :3], x[:, 0], x[:, 0].float(),
                            torch.zeros(n, 4), torch.zeros(n, 3, 4))
        with pytest.raises(ValueError, match="storage"):
            trim_gather_cuda(x, idx.view(n, 1), live.view(n, 1),
                             x.view(n, 1, D), live.view(n, 1), 0)
    # the CPU route is the plain version only on a CPU tensor: backend
    # "cuda" on a CPU tensor raises whatever the dtype
    h = torch.zeros((n, D), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        edge_scatter(h, h, live, idx, idx, backend="cuda",
                     accum_dtype=torch.float32)


# ---------------------------------------------------------------------------
# fp32 is the pre-policy program, in every engine and grid
# ---------------------------------------------------------------------------

def _hier(mod, sizes=(6, 6, 6)):
    return mod.make_hierarchy(list(sizes), "complete", seed=0)


def _engines(policy, T=20):
    """Each engine's run and one grid of each kind, on the CPU."""
    w = np.random.default_rng(3).normal(size=(18, 4)).astype(np.float32)
    cfg = th.HPSConfig(_hier(tg), 4, B=2, drop_prob=0.2)
    model = tsig.make_confused_model(N=18, m=3, truth=1, confusion=0.3,
                                     seed=0)
    el, wp = _graph(12, 0)
    bcfg = tb.ByzantineConfig(topo=tg.make_hierarchy([6, 6, 6], "complete",
                                                     seed=0),
                              F=1, byz=(2,), gamma_period=4,
                              attack=tat.sign_flip())
    plan = ExecutionPlan(policy=policy)
    cpu = dict(device="cpu")
    out = {
        "pushsum": tp.run_pushsum_sparse(wp, el.src, el.dst, T,
                                         drop_prob=0.2, B=2, plan=plan,
                                         **cpu),
        "hps": th.run_hps(w, cfg, T, seed=1, plan=plan.replace(store="gap"),
                          **cpu),
        "social": tsoc.run_social_learning(model, cfg, T, seed=2, plan=plan,
                                           **cpu),
        "byzantine": tb.run_byzantine_learning(model, bcfg, T, seed=3,
                                               plan=plan, **cpu),
        "pushsum_sweep": tsw.run_pushsum_sweep(
            wp, el, T, drop_probs=[0.0, 0.3], seeds=[0, 1], plan=plan,
            **cpu),
        "hps_grid": tsw.run_hps_grid(w, [cfg], T, seeds=[0, 1], plan=plan,
                                     **cpu),
        "social_grid": tsw.run_social_grid(model, [cfg], T, seeds=[0, 1],
                                           plan=plan, **cpu),
        "byzantine_grid": tsw.run_byzantine_grid(model, [bcfg], T,
                                                 seeds=[0, 1], plan=plan,
                                                 **cpu),
    }
    return out


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors(y)]
    return []


def test_fp32_policy_is_the_pre_policy_program():
    base, fp32 = _engines(None), _engines("fp32")
    for name in base:
        a, b = _tensors(base[name]), _tensors(fp32[name])
        assert len(a) == len(b) > 0, name
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y), name


# ---------------------------------------------------------------------------
# The engines under bf16 against the reference's bf16 runs
# ---------------------------------------------------------------------------

def _hps_cfgs(drop=0.2):
    return (th.HPSConfig(_hier(tg), 4, B=2, drop_prob=drop),
            jh.HPSConfig(_hier(jg), 4, B=2, drop_prob=drop))


@pytest.mark.parametrize("F", [0, 1])
def test_hps_bf16_matches_reference(F):
    """Bit-equal to the reference's eager run (the same cast points, op by
    op). Against its jitted scan, XLA's fused float32 arithmetic may flip
    a bf16 rounding, which the cumulative bf16 relay then keeps (the
    horizon cliff below): at T = 24 the final ratios are held to one bf16
    ulp of the input spread (bit-equal under jax 0.9 on the CPU)."""
    w = np.random.default_rng(3).normal(size=(18, 4)).astype(np.float32)
    ct, cj = _hps_cfgs()
    rt = th.run_hps(w, ct, 12, seed=1, F=F, device="cpu",
                    plan=ExecutionPlan(store="gap", policy="bf16"))
    with jax.disable_jit():
        rj = jh.run_hps(w, cj, 12, seed=1, F=F,
                        plan=JaxPlan(backend="xla", store="gap",
                                     policy="bf16"))
    assert rt.final_state.zm.dtype == torch.bfloat16
    assert rt.ratio.dtype == rt.gap.dtype == torch.float32
    _same(rt.ratio, rj.ratio, "ratio")
    _same(rt.gap, rj.gap, "gap")
    for f in ("z", "m", "sigma", "rho"):
        _same(getattr(rt.final_state, f), getattr(rj.final_state, f), f)
    rt = th.run_hps(w, ct, 24, seed=1, F=F, device="cpu",
                    plan=ExecutionPlan(store="final", policy="bf16"))
    rj = jh.run_hps(w, cj, 24, seed=1, F=F,
                    plan=JaxPlan(backend="xla", store="final",
                                 policy="bf16"))
    np.testing.assert_allclose(_np(rt.ratio), _np(rj.ratio), rtol=0,
                               atol=EPS_BF16 * float(np.ptp(w)))


def _social_pair(T, store, jit=True, **planes):
    mj = jsig.make_confused_model(N=18, m=3, truth=1, confusion=0.3, seed=0)
    mt = tsig.make_confused_model(N=18, m=3, truth=1, confusion=0.3, seed=0)
    ct, cj = _hps_cfgs(0.3)
    rt = tsoc.run_social_learning(
        mt, ct, T, seed=2, device="cpu",
        plan=ExecutionPlan(store=store, policy="bf16",
                           **{k: v[0] for k, v in planes.items()}))
    rj = jsoc.run_social_learning(
        mj, cj, T, seed=2,
        plan=JaxPlan(backend="xla", store=store, policy="bf16",
                     **{k: v[1] for k, v in planes.items()}))
    return rt, rj


@pytest.mark.parametrize("store", ["trajectory", "log_ratio"])
def test_social_bf16_matches_reference(store):
    """The carried state (z, m) and the relay are bit-equal to the
    reference's jitted bf16 scan; the beliefs, float32 softmaxes of the
    same sums, within 1e-5 (jax.nn.softmax and torch.softmax round
    differently); the decisions equal."""
    rt, rj = _social_pair(60, store)
    for f in ("z", "m", "sigma", "rho"):
        assert getattr(rt.final_state, f).dtype == torch.bfloat16
        _same(getattr(rt.final_state, f), getattr(rj.final_state, f), f)
    assert rt.beliefs.dtype == rt.log_ratio.dtype == torch.float32
    np.testing.assert_allclose(_np(rt.beliefs), _np(rj.beliefs), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(_np(rt.log_ratio), _np(rj.log_ratio),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(_np(rt.beliefs).argmax(-1),
                                  _np(rj.beliefs).argmax(-1))


def test_social_bf16_with_both_planes_matches_reference():
    """Faults (the chaos lane's severe model) and async wakes together
    under bf16: the carried state bit-equal, the final carried belief
    within 1e-5."""
    faults = (tf.gilbert_elliott_model(8.0, 0.5, leave_prob=0.1,
                                       join_prob=0.25, ps_crash_prob=0.5),
              jf.gilbert_elliott_model(8.0, 0.5, leave_prob=0.1,
                                       join_prob=0.25, ps_crash_prob=0.5))
    async_ = (ta.make_async_model(0.6, 8), ja.make_async_model(0.6, 8))
    rt, rj = _social_pair(60, "final", faults=faults, async_=async_)
    for f in ("z", "m", "rho"):
        _same(getattr(rt.final_state, f), getattr(rj.final_state, f), f)
    np.testing.assert_allclose(_np(rt.beliefs), _np(rj.beliefs), rtol=0,
                               atol=1e-5)


def _byz_cfg(mod, atk, F=1, byz=(2,)):
    amod = tat if mod is tg else jat
    cls = tb.ByzantineConfig if mod is tg else jb.ByzantineConfig
    return cls(topo=mod.make_hierarchy([6, 6, 6], "complete", seed=0), F=F,
               byz=byz, gamma_period=4, attack=getattr(amod, atk)())


@pytest.mark.parametrize("mode", ["pairwise", "ovr"])
def test_byzantine_bf16_matches_reference(mode):
    """A deterministic attack (``sign_flip``): r and the decisions of 30
    rounds bit-equal to the reference's jitted bf16 scan (its float32
    trim sums differ from the port's by an ulp now and then, which the
    bf16 rounding of the carried statistic absorbs here).
    ``random_noise``'s Gaussian lies differ from the reference's by a
    float32 ulp (the inverse-erf tails), which can flip a lie's bf16
    rounding: the final decisions equal on the agents whose decision
    margin is clear (above 1 nat)."""
    mt = tsig.make_confused_model(N=18, m=3, truth=1, confusion=0.3, seed=0)
    mj = jsig.make_confused_model(N=18, m=3, truth=1, confusion=0.3, seed=0)
    rt = tb.run_byzantine_learning(mt, _byz_cfg(tg, "sign_flip"), 30, seed=3,
                                   mode=mode, device="cpu",
                                   plan=ExecutionPlan(policy="bf16"))
    rj = jb.run_byzantine_learning(mj, _byz_cfg(jg, "sign_flip"), 30,
                                   seed=3, mode=mode, backend="xla",
                                   policy="bf16")
    assert rt.r.dtype == torch.float32
    _same(rt.r, rj.r, "r")
    np.testing.assert_array_equal(rt.decisions.numpy(),
                                  np.asarray(rj.decisions))
    if mode == "ovr":
        return
    rt = tb.run_byzantine_learning(mt, _byz_cfg(tg, "random_noise"), 30,
                                   seed=3, device="cpu",
                                   plan=ExecutionPlan(policy="bf16",
                                                      store="final"))
    rj = jb.run_byzantine_learning(mj, _byz_cfg(jg, "random_noise"), 30,
                                   seed=3, backend="xla", policy="bf16",
                                   store="final")
    worst = np.where(np.eye(3, dtype=bool), np.inf, _np(rj.r)).min(-1)
    top2 = np.sort(worst, axis=-1)
    clear = ((top2[:, -1] - top2[:, -2]) > 1.0) & (np.arange(18) != 2)
    assert clear.sum() >= 12
    np.testing.assert_array_equal(rt.decisions.numpy()[clear],
                                  np.asarray(rj.decisions)[clear])


def test_byzantine_bf16_under_faults_matches_reference():
    mt = tsig.make_confused_model(N=18, m=3, truth=1, confusion=0.3, seed=0)
    mj = jsig.make_confused_model(N=18, m=3, truth=1, confusion=0.3, seed=0)
    sev = {m: m.gilbert_elliott_model(8.0, 0.5, leave_prob=0.1,
                                      join_prob=0.25, ps_crash_prob=0.5)
           for m in (tf, jf)}
    rt = tb.run_byzantine_learning(
        mt, _byz_cfg(tg, "sign_flip"), 40, seed=3, device="cpu",
        plan=ExecutionPlan(policy="bf16", faults=sev[tf]))
    rj = jb.run_byzantine_learning(
        mj, _byz_cfg(jg, "sign_flip"), 40, seed=3, backend="xla",
        policy="bf16", faults=sev[jf])
    _same(rt.r, rj.r, "r")
    np.testing.assert_array_equal(rt.decisions.numpy(),
                                  np.asarray(rj.decisions))


@pytest.mark.parametrize("plane", ["async", "faults"])
def test_pushsum_bf16_with_a_plane_matches_reference(plane):
    el, w = _graph(12, 0)
    models = {"async": (ta.make_async_model(0.6, 8),
                        ja.make_async_model(0.6, 8)),
              "faults": (tf.gilbert_elliott_model(8.0, 0.5, leave_prob=0.1,
                                                  join_prob=0.25),
                         jf.gilbert_elliott_model(8.0, 0.5, leave_prob=0.1,
                                                  join_prob=0.25))}[plane]
    field = "async_" if plane == "async" else "faults"
    kw = dict(drop_prob=0.2, B=3)
    st, trt = tp.run_pushsum_sparse(
        w, el.src, el.dst, 30, key=prng_key(1), device="cpu",
        plan=ExecutionPlan(policy="bf16", **{field: models[0]}), **kw)
    sj, trj = jp.run_pushsum_sparse(
        w, el.src, el.dst, 30, key=jax.random.PRNGKey(1),
        plan=JaxPlan(backend="xla", policy="bf16", **{field: models[1]}),
        **kw)
    for f in ("z", "m", "sigma", "sigma_m", "rho", "rho_m"):
        _same(getattr(st, f), getattr(sj, f), f)
    _same(trt, trj, "ratios")


# ---------------------------------------------------------------------------
# The grids under bf16: one policy over the block-diagonal graph
# ---------------------------------------------------------------------------

def test_grids_bf16_rows_are_the_single_runs():
    """Each grid row under bf16 is the port's single run of its scenario,
    bit for bit: one policy applies to the whole stacked graph."""
    w = np.random.default_rng(3).normal(size=(18, 4)).astype(np.float32)
    ct, _ = _hps_cfgs()
    model = tsig.make_confused_model(N=18, m=3, truth=1, confusion=0.3,
                                     seed=0)
    plan = ExecutionPlan(policy="bf16")
    T, seeds = 16, [0, 5]
    hg = tsw.run_hps_grid(w, [ct], T, seeds, device="cpu", plan=plan)
    sg = tsw.run_social_grid(model, [ct], T, seeds, device="cpu", plan=plan)
    bg = tsw.run_byzantine_grid(model, [_byz_cfg(tg, "sign_flip")], T,
                                seeds, device="cpu", plan=plan)
    el, wp = _graph(12, 0)
    pg = tsw.run_pushsum_sweep(wp, el, T, drop_probs=0.2, seeds=seeds, B=3,
                               device="cpu", plan=plan)
    for k, s in enumerate(seeds):
        h = th.run_hps(w, ct, T, seed=s, device="cpu",
                       plan=plan.replace(store="gap"))
        _same(hg.gap[k], h.gap, "hps gap")
        _same(hg.ratio[k], h.ratio, "hps ratio")
        so = tsoc.run_social_learning(model, ct, T, seed=s, signal_seed=s,
                                      device="cpu",
                                      plan=plan.replace(store="log_ratio"))
        _same(sg.log_ratio[k], so.log_ratio, "social log ratio")
        _same(sg.beliefs[k], so.beliefs, "social beliefs")
        b = tb.run_byzantine_learning(model, _byz_cfg(tg, "sign_flip"), T,
                                      seed=s, device="cpu",
                                      plan=plan.replace(store="decisions"))
        _same(bg.r[k], b.r, "byzantine r")
        _same(bg.decisions[k], b.decisions, "byzantine decisions")
        st, tr = tp.run_pushsum_sparse(wp, el.src, el.dst, T, drop_prob=0.2,
                                       B=3, key=prng_key(s), device="cpu",
                                       plan=plan)
        _same(pg.final_ratio[k], tp.sparse_ratios(st), "pushsum ratios")


def test_pushsum_sweep_bf16_matches_reference_sweep():
    el, w = _graph(12, 0)
    pt = tsw.run_pushsum_sweep(w, el, 20, drop_probs=[0.0, 0.3],
                               seeds=[0, 1], B=3, device="cpu",
                               plan=ExecutionPlan(policy="bf16"))
    pj = jsw.run_pushsum_sweep(w, el, 20, drop_probs=[0.0, 0.3],
                               seeds=[0, 1], B=3,
                               plan=JaxPlan(backend="xla", policy="bf16"))
    _same(pt.final_ratio, pj.final_ratio, "final ratios")
    # |ratio - mean(w)|: the mean's float32 reduction order, an ulp
    np.testing.assert_allclose(_np(pt.err), _np(pj.err), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(pt.mass_gap), _np(pj.mass_gap),
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# The bf16 error envelope of tests/test_bf16_envelope.py, on the port, with
# the reference's constants unchanged
# ---------------------------------------------------------------------------

TOPOLOGIES = ("ring", "complete", "ring+")
C_MASS = 2.0                  # mass drift slope (x EPS x T) at T = 32
C_GAP = 32.0                  # gap difference / input spread at T = 32
C_LR = 1280.0                 # Thm-2 log-ratio relative difference at T = 16


def _scenarios(k: int, seed: int):
    """k (drop, Γ, topology, seed) draws from one seeded generator, as the
    reference's suite draws them."""
    rng = np.random.default_rng(seed)
    return [(float(rng.uniform(0.0, 0.6)), int(rng.choice([2, 4, 8, 16])),
             TOPOLOGIES[int(rng.integers(len(TOPOLOGIES)))],
             int(rng.integers(1000))) for _ in range(k)]


def _port_hps_pair(drop, gamma, topology, seed, T):
    """(fp32 run, bf16 run, runtime, inputs) of one scenario on the port."""
    topo = tg.make_hierarchy([5, 5, 5], topology=topology, seed=seed)
    cfg = th.HPSConfig(topo=topo, gamma_period=gamma, B=4, drop_prob=drop)
    w = (np.random.default_rng(seed)
         .normal(size=(topo.N, 3)).astype(np.float32))
    rt = th.make_hps_runtime(cfg)
    runs = [th.run_hps(w, cfg, T, seed=seed, device="cpu",
                       plan=ExecutionPlan(store="gap", policy=p))
            for p in (None, "bf16")]
    return runs[0], runs[1], rt, w


def _mass_rel_drift(res, rt, w):
    """Worst relative drift of sum_j z_j + in-flight from sum_j w_j."""
    mi = tp.sparse_mass_invariant(res.final_state, rt.src,
                                  rt.valid)[:-1].numpy()
    return float(np.max(np.abs(mi - w.sum(axis=0))
                        / np.maximum(np.abs(w).sum(axis=0), 1e-6)))


class TestTheorem1Envelope:
    T = 32

    def test_mass_invariant_drift_linear_in_T(self):
        """bf16 mass drift <= C_MASS * EPS * T; fp32 stays at roundoff."""
        env = C_MASS * EPS_BF16 * self.T
        for drop, gamma, topology, seed in _scenarios(10, seed=7):
            r32, r16, rt, w = _port_hps_pair(drop, gamma, topology, seed,
                                             self.T)
            assert _mass_rel_drift(r32, rt, w) <= 1e-5, (topology, seed)
            d16 = _mass_rel_drift(r16, rt, w)
            assert d16 <= env, (drop, gamma, topology, seed, d16, env)

    def test_consensus_gap_perturbation(self):
        """|gap_bf16 - gap_fp32| <= C_GAP * EPS * spread(w) at T = 32."""
        for drop, gamma, topology, seed in _scenarios(10, seed=11):
            r32, r16, _, w = _port_hps_pair(drop, gamma, topology, seed,
                                            self.T)
            diff = abs(float(r16.gap[-1]) - float(r32.gap[-1]))
            assert diff <= C_GAP * EPS_BF16 * float(np.ptp(w)), (
                drop, gamma, topology, seed, diff)


class TestTheorem2Envelope:
    T = 16

    def test_log_ratio_envelope(self):
        """Thm-2 worst-case log-ratio: bf16 within C_LR * EPS of fp32,
        relative with a +1 absolute floor."""
        env = C_LR * EPS_BF16
        for drop, gamma, topology, seed in _scenarios(8, seed=13):
            topo = tg.make_hierarchy([5, 5, 5], topology=topology,
                                     seed=seed)
            model = tsig.make_confused_model(N=topo.N, m=3, truth=1,
                                             confusion=0.4, seed=seed)
            cfg = th.HPSConfig(topo=topo, gamma_period=gamma, B=4,
                               drop_prob=drop)
            lr32, lr16 = (tsoc.run_social_learning(
                model, cfg, self.T, seed=seed, device="cpu",
                plan=ExecutionPlan(store="log_ratio", policy=p)
            ).log_ratio.numpy() for p in (None, "bf16"))
            rel = float(np.max(np.abs(lr16 - lr32) / (np.abs(lr32) + 1.0)))
            assert rel <= env, (drop, gamma, topology, seed, rel, env)
            assert np.isfinite(lr16).all()


class TestHorizonCliff:
    """The envelopes hold for short horizons only: the cumulative relay in
    bf16 starves once a counter is ~2^8 times a round's increment."""

    def test_mass_envelope_fails_by_T200(self):
        env = C_MASS * EPS_BF16 * 32     # the short-horizon envelope
        worst = 0.0
        for drop, gamma, topology, seed in _scenarios(6, seed=7):
            _, r16, rt, w = _port_hps_pair(drop, gamma, topology, seed,
                                           T=200)
            worst = max(worst, _mass_rel_drift(r16, rt, w))
        assert worst > env, worst

    def test_fp32_policy_has_no_cliff(self):
        drop, gamma, topology, seed = _scenarios(1, seed=7)[0]
        topo = tg.make_hierarchy([5, 5, 5], topology=topology, seed=seed)
        cfg = th.HPSConfig(topo=topo, gamma_period=gamma, B=4,
                           drop_prob=drop)
        w = (np.random.default_rng(seed)
             .normal(size=(topo.N, 3)).astype(np.float32))
        res = th.run_hps(w, cfg, 200, seed=seed, device="cpu",
                         plan=ExecutionPlan(store="gap", policy="fp32"))
        assert _mass_rel_drift(res, th.make_hps_runtime(cfg), w) <= 1e-4
