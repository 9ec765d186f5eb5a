"""The port's static checks (``repro_torch.statics``) against
``repro.statics``'s pure modules and its declared contracts.

Covers, in order:
* the stream prover: ``affine_disjoint`` against the reference's and
  against ``brute_force_disjoint`` on hypothesis draws; ``fit_affine`` of
  every port fold equal to the reference fold's ``(a, b)``; each port
  contract's patterns, fitted streams and seed links equal to the
  reference contract of the same name; the three legacy schemes caught
  with the reference's witnesses; every current stream disjoint over
  ``DEFAULT_HORIZON``, within each engine and across ``shares_seed_with``,
  and the horizon where the fault band first meets the async band;
* the dense linter: injected (N, N) values caught; the named exemption
  spares the port's (T, K, 1) key words and (T, K) coins only — (T, N)
  and (T, E) values are still caught; each engine's plain path clean at
  its fixture, and its key words found once the exemption is lifted;
* the subnormal-literal scan, judged in the op's dtype;
* the signature linter, and a fake entry point with ``policy=``;
* the bf16 carry contract on the engines and on an injected float32
  carry;
* the step-byte models and ``step_floor`` equal to the reference's;
* ``python -m repro_torch.statics lint|budget|list``.

The reference's jaxpr walker does not run under jax 0.9, so no reference
program is recorded here: the JAX side is the pure modules only.
"""
import contextlib
import dataclasses
import io
import itertools

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)
from hypothesis import given, settings, strategies as st

import repro.core  # noqa: F401  registers the reference's contracts
import repro.core.asyncrony as jasync
import repro.core.byzantine as jbyz
import repro.core.faults as jfaults
import repro.core.hps as jhps
import repro.core.social as jsoc
import repro.statics.contracts as jcontracts
import repro.statics.memory as jmem
import repro.statics.signatures as jsig
import repro.statics.streams as jstreams
import repro.analysis.roofline as jrl
import repro_torch.core  # noqa: F401  registers the port's contracts
import repro_torch.core.asyncrony as tasync
import repro_torch.core.byzantine as tbyz
import repro_torch.core.faults as tfaults
import repro_torch.core.hps as thps
import repro_torch.core.social as tsoc
from repro_torch.analysis.roofline import HW
from repro_torch.statics import (cli, contracts, dense, memory, precision,
                                 signatures, streams, walk)
from repro_torch.statics.streams import (LEGACY_BUGGY_STREAMS, AffineMap,
                                         affine_disjoint,
                                         brute_force_disjoint, check_streams,
                                         fit_affine)

HORIZON = contracts.DEFAULT_HORIZON


# ---------------------------------------------------------------------------
# The stream prover
# ---------------------------------------------------------------------------

@settings(max_examples=400, deadline=None)
@given(a1=st.integers(-6, 6), b1=st.integers(-20, 20),
       a2=st.integers(-6, 6), b2=st.integers(-20, 20),
       T=st.integers(1, 30), T2=st.integers(1, 30))
def test_affine_disjoint_matches_reference_and_brute_force(
        a1, b1, a2, b2, T, T2):
    m1, m2 = AffineMap("x", a1, b1), AffineMap("y", a2, b2)
    got = affine_disjoint(m1, m2, T, T2)
    want = jstreams.affine_disjoint(jstreams.AffineMap("x", a1, b1),
                                    jstreams.AffineMap("y", a2, b2), T, T2)
    assert got == want
    assert got[0] == brute_force_disjoint(m1, m2, T, T2)
    if not got[0]:
        t1, t2, val = got[1]
        assert 0 <= t1 < T and 0 <= t2 < T2 and m1(t1) == m2(t2) == val


def test_affine_disjoint_edge_cases():
    for args in [(0, 5, 0, 5, 9, 9), (0, 5, 0, 6, 9, 9), (2, 0, 0, 4, 9, 9),
                 (0, 4, 2, 0, 9, 9), (-3, 0, 3, 0, 9, 9), (1, 0, 1, 0, 1, 1)]:
        a1, b1, a2, b2, T, T2 = args
        assert affine_disjoint(AffineMap("x", a1, b1), AffineMap("y", a2, b2),
                               T, T2) == jstreams.affine_disjoint(
            jstreams.AffineMap("x", a1, b1), jstreams.AffineMap("y", a2, b2),
            T, T2)
    with pytest.raises(ValueError, match="signed fold-in"):
        affine_disjoint(AffineMap("big", 1 << 20, 0), AffineMap("y", 1, 0),
                        1 << 12)
    with pytest.raises(ValueError, match="not affine"):
        fit_affine(lambda t: t * t, "sq")


def _fold_pairs():
    """(name, port fold, reference fold) of every fold map of the engines."""
    out = [("pushsum.link", lambda t: t, lambda t: t),
           ("hps.link", thps.hps_stream_fold, jhps.hps_stream_fold)]
    out += [(f"social.{s}", lambda t, s=s: tsoc.social_stream_fold(t, s),
             lambda t, s=s: jsoc.social_stream_fold(t, s))
            for s in range(tsoc.N_SOCIAL_STREAMS)]
    out += [(f"byzantine.{s}", lambda t, s=s: tbyz.stream_fold(t, s),
             lambda t, s=s: jbyz.stream_fold(t, s))
            for s in range(tbyz.N_STREAMS)]
    out += [(f"fault.{e}.{s}",
             lambda t, e=e, s=s: tfaults.fault_stream_fold(t, e, s),
             lambda t, e=e, s=s: jfaults.fault_stream_fold(t, e, s))
            for e in range(tfaults.N_ENGINES)
            for s in range(tfaults.N_FAULT_STREAMS)]
    out += [(f"async.{e}", lambda t, e=e: tasync.async_stream_fold(t, e),
             lambda t, e=e: jasync.async_stream_fold(t, e))
            for e in range(tfaults.N_ENGINES)]
    return out


@pytest.mark.parametrize("name,port,ref", _fold_pairs(),
                         ids=[p[0] for p in _fold_pairs()])
def test_fit_affine_of_every_port_fold_is_the_references(name, port, ref):
    got, want = fit_affine(port, name), jstreams.fit_affine(ref, name)
    assert (got.a, got.b) == (want.a, want.b)
    # affine over the whole horizon, as the np.int32 word it folds
    for t in (0, 1, HORIZON // 3, HORIZON - 1):
        assert int(np.asarray(port(t))) == got(t) == int(np.asarray(ref(t)))


@pytest.mark.parametrize("name", sorted(contracts.REGISTRY))
def test_port_contract_is_the_references(name):
    """Patterns, fitted streams, horizon and seed links of each port
    contract are the reference contract's of the same name."""
    c, j = contracts.get(name), jcontracts.get(name)
    assert dict(c.forbidden) == dict(j.forbidden)
    assert c.horizon == j.horizon == HORIZON
    assert [(s.name, fit_affine(s.fold, s.name).a,
             fit_affine(s.fold, s.name).b) for s in c.streams] == \
        [(s.name, jstreams.fit_affine(s.fold, s.name).a,
          jstreams.fit_affine(s.fold, s.name).b) for s in j.streams]
    assert c.shares_seed_with == j.shares_seed_with
    has_horizon_ban = any(p[:1] == ("T",) for ps in c.forbidden.values()
                          for p in ps)
    assert c.exempt == ((dense.HORIZON_KEYS,) if has_horizon_ban else ())


def test_registry_is_the_references_but_the_sharded_engine():
    """Since the edge-partitioned push-sum was ported, the sharded engine
    is registered too: the registry is the reference's."""
    assert set(contracts.REGISTRY) == set(jcontracts.REGISTRY)


def test_legacy_schemes_caught_with_the_reference_witnesses():
    for engine in ("byzantine", "social"):
        got = check_streams(LEGACY_BUGGY_STREAMS[engine], HORIZON)
        want = jstreams.check_streams(jstreams.LEGACY_BUGGY_STREAMS[engine],
                                      HORIZON)
        assert [f.message for f in got] == [f.message for f in want]
    msgs = [f.message for f in check_streams(
        LEGACY_BUGGY_STREAMS["byzantine"], HORIZON)]
    assert len(msgs) == 2
    assert any("signal@t=1 == gossip@t=0 (both fold 1)" in m for m in msgs)
    assert any("signal@t=2 == fusion@t=0 (both fold 2)" in m for m in msgs)
    (social,) = check_streams(LEGACY_BUGGY_STREAMS["social"], HORIZON)
    assert "link@t=0 == signal@t=0 (both fold 0)" in social.message
    # hps folded plain t; social's link stream is 2t: a shared seed
    # aliased the two schedules from t = 0
    link = fit_affine(contracts.get("social").streams[0].fold, "social.link")
    assert affine_disjoint(LEGACY_BUGGY_STREAMS["hps"][0], link,
                           HORIZON) == (False, (0, 0, 0))
    for engine in LEGACY_BUGGY_STREAMS:
        assert cli.stream_findings(
            sorted(contracts.REGISTRY),
            {engine: LEGACY_BUGGY_STREAMS[engine]}) != []


def test_every_port_stream_disjoint_over_the_horizon():
    """Within each engine and across every shares_seed_with link: the
    fault bands and the async bands against every stream on their key."""
    assert cli.stream_findings(sorted(contracts.REGISTRY)) == []
    for name in ("pushsum_faults", "social_faults", "hps_faults",
                 "byzantine_faults", "pushsum_async", "social_async",
                 "hps_async"):
        c = contracts.get(name)
        host = name.split("_")[0]
        assert host in c.shares_seed_with
    assert set(contracts.get("hps").shares_seed_with) == {"social",
                                                          "byzantine"}


def test_the_fault_band_meets_the_async_band_past_the_horizon(monkeypatch):
    """Over DEFAULT_HORIZON the fault band stays above -2^25; the prover
    finds the first horizon where it reaches the async band: 2,621,441
    rounds (12 t1 - 4 t2 = 2^25 - 2^21 first solvable at t1 = 2,621,440),
    and the lint reports the pair once both contracts run that long."""
    fault = fit_affine(lambda t: tfaults.fault_stream_fold(
        t, tfaults.ENGINE_PUSHSUM, tfaults.FAULT_EDGE), "fault-edge")
    wake = fit_affine(lambda t: tasync.async_stream_fold(
        t, tfaults.ENGINE_PUSHSUM), "async-wake")
    assert affine_disjoint(fault, wake, HORIZON) == (True, None)
    first = 2_621_441
    assert affine_disjoint(fault, wake, first - 1) == (True, None)
    disjoint, (t1, t2, val) = affine_disjoint(fault, wake, first)
    assert not disjoint and t1 == first - 1 and fault(t1) == wake(t2) == val
    assert first > HORIZON
    for name in ("pushsum_faults", "pushsum_async"):
        monkeypatch.setitem(contracts.REGISTRY, name, dataclasses.replace(
            contracts.get(name), horizon=1 << 22))
    found = cli.stream_findings(["pushsum_async"])
    assert found and all(f.where == "pushsum_async x pushsum_faults"
                         for f in found)


# ---------------------------------------------------------------------------
# The dense linter
# ---------------------------------------------------------------------------

def _values(*specs):
    """A record of the given (shape, dtype) op outputs."""
    rec = walk.Record()
    rec.values = [walk.Value(shape, dt, "aten.test") for shape, dt in specs]
    return rec


DIMS = {"N": 18, "m": 3, "T": 37, "E": 90}
BANS = (("N", "N"), ("T", "*"))


def test_synthetic_dense_injection_caught():
    rec = cli.synthetic_dense({"N": 11, "d": 2}, "cpu")
    out = dense.find_forbidden(rec, {"N": 11, "d": 2}, (("N", "N"),))
    assert len(out) >= 1 and "('N', 'N')" in out[0].message


@pytest.mark.parametrize("shape,dtype,caught", [
    ((37, 1, 1), torch.int64, False),     # a round's key words
    ((37, 1), torch.bool, False),          # PS coins
    ((37, 2), torch.int64, False),         # two words
    ((37, 18), torch.bool, True),          # (T, N)
    ((37, 90), torch.float32, True),       # (T, E)
    ((37, 18), torch.int64, True),
    ((37, 1), torch.float32, True),        # a float curve is no key
    ((37, 4), torch.int64, True),          # wider than one key
    ((18, 18), torch.int64, True),         # (N, N) is never exempt
], ids=lambda v: str(v))
def test_horizon_key_exemption_is_narrow(shape, dtype, caught):
    rec = _values((shape, dtype))
    out = dense.find_forbidden(rec, DIMS, BANS, exempt=(dense.HORIZON_KEYS,))
    assert bool(out) == caught
    assert dense.find_forbidden(rec, DIMS, BANS) != []


def test_unknown_exemption_and_empty_record():
    with pytest.raises(KeyError, match="unknown exemption"):
        dense.find_forbidden(_values(), DIMS, BANS, exempt=("all",))
    assert dense.assert_nonempty(walk.Record(), where="x")
    with pytest.raises(ValueError, match="ambiguous"):
        walk.symbolize((3,), {"m": 3, "d": 3})


@pytest.mark.parametrize("name", sorted(contracts.REGISTRY))
def test_engine_plain_path_clean_at_its_fixture(name):
    """Each engine at its fixture on the CPU, every store: no finding;
    where its contract bans (T, *), the run did hold horizon-major key
    words, which the exemption alone spares."""
    c = contracts.get(name)
    dims, stores, make = cli.FIXTURES[name]()
    for store in stores:
        rec = make(store, "cpu")
        pats = c.forbidden_for(store)
        assert dense.assert_nonempty(rec) == []
        assert dense.find_forbidden(rec, dims, pats, exempt=c.exempt) == []
        assert dense.find_subnormal_consts(rec) == []
        lifted = dense.find_forbidden(rec, dims, pats)
        if any(p[:1] == ("T",) for p in pats):
            assert lifted and all("('T', 1" in f.message for f in lifted)
        else:
            assert lifted == []


# ---------------------------------------------------------------------------
# Subnormal literals
# ---------------------------------------------------------------------------

def test_subnormal_literal_caught():
    tiny = float(np.finfo(np.float32).tiny)
    x = torch.rand(5) + 0.5
    bad = walk.trace(lambda: torch.log(x.clamp_min(1e-38)))
    (f,) = dense.find_subnormal_consts(bad)
    assert "1e-38" in f.message and "float32" in f.message
    lifted = walk.trace(lambda: torch.maximum(x, torch.tensor(1e-40)))
    assert dense.find_subnormal_consts(lifted) != []
    assert dense.find_subnormal_consts(
        walk.trace(lambda: torch.log(x.clamp_min(tiny)))) == []
    # judged in the op's dtype: normal for float32, subnormal for fp16
    assert dense.find_subnormal_consts(
        walk.trace(lambda: x.clamp_min(1e-6))) == []
    assert dense.find_subnormal_consts(
        walk.trace(lambda: x.half().clamp_min(1e-6))) != []


# ---------------------------------------------------------------------------
# Signatures
# ---------------------------------------------------------------------------

def test_entrypoints_are_the_references_and_lint_clean():
    assert [f for _, f in signatures.ENTRYPOINTS] == \
        [f for _, f in jsig.ENTRYPOINTS]
    assert signatures.check_entrypoints() == []
    from repro.core.plan import PLAN_FIELDS
    from repro_torch.core.plan import ExecutionPlan
    port = {f.name for f in dataclasses.fields(ExecutionPlan)}
    assert port == set(PLAN_FIELDS)


def test_fake_entrypoints_flagged():
    def run_fake(w, T, *, policy=None, plan=None, device=None):
        pass

    def run_meshy(w, T, mesh=None, *, plan=None):
        pass

    def run_planless(w, T, *, device=None):
        pass

    def run_fine(w, T, *, drop_probs=(), plan=None, device=None, **legacy):
        pass

    (f,) = signatures.check_signature(run_fake, "fake")
    assert "policy" in f.message
    (f,) = signatures.check_signature(run_meshy, "meshy")
    assert "mesh" in f.message
    (f,) = signatures.check_signature(run_planless, "planless")
    assert "no plan=" in f.message
    assert signatures.check_signature(run_fine, "fine") == []


# ---------------------------------------------------------------------------
# The bf16 carry contract
# ---------------------------------------------------------------------------

def _toy_engine(T: int, N: int, leak: bool):
    """A loop that carries bf16 state, and, with ``leak``, a float32 (N,)
    accumulator across rounds."""
    x = torch.zeros(N, dtype=torch.bfloat16)
    acc = torch.zeros(N)
    for t in range(T):
        total = x.float() + 1.0             # a round's float32 transient
        if leak:
            acc = acc + total               # carried at full width
        x = total.to(torch.bfloat16)
    return x, acc


def test_fp32_carry_injected_under_bf16_caught():
    assert precision.loop_carries(_toy_engine) == ("x", "acc")
    dims = {"N": 7, "T": 5}
    leaky = precision.carried_state(_toy_engine,
                                    lambda: _toy_engine(5, 7, True))
    (f,) = precision.find_fp32_carries(leaky, dims, where="toy")
    assert f.check == "fp32-carry" and "acc" in f.message
    clean = precision.carried_state(_toy_engine,
                                    lambda: _toy_engine(5, 7, False))
    # acc is carried but stays (N,) zeros: float32 all the same
    assert precision.find_fp32_carries(clean, dims) != []
    assert precision.find_fp32_carries({"x": clean["x"]}, dims) == []


def test_engines_carry_no_fp32_state_under_bf16():
    loops = {n: precision.loop_carries(fn)
             for n, (fn, _, _) in cli._loops().items()}
    assert loops["pushsum"] == ("fs", "state", "abuf")
    assert loops["hps"] == ("fs", "state", "abuf")
    assert loops["social"] == ("fs", "state", "abuf", "mu")
    assert set(loops["byzantine"]) >= {"r", "cum_llr"}
    assert cli.precision_findings("cpu", "bf16") == []
    # under fp32 the same carries are float32 state: the check sees them
    assert cli.precision_findings("cpu", "fp32") != []


# ---------------------------------------------------------------------------
# Step-byte models
# ---------------------------------------------------------------------------

def test_step_byte_models_match_reference():
    for (N, E, d), pol in itertools.product(
            ((11, 30, 1), (131_072, 917_504, 4), (1 << 20, 1 << 21, 3)),
            (None, "bf16", "fp32")):
        assert memory.pushsum_step_bytes(N, E, d, policy=pol) == \
            jmem.pushsum_step_bytes(N, E, d, policy=pol)
        assert memory.hps_step_bytes(N, E, d, policy=pol) == \
            jmem.hps_step_bytes(N, E, d, policy=pol)
        assert memory.social_step_bytes(N, E, d, 3, policy=pol) == \
            jmem.social_step_bytes(N, E, d, 3, policy=pol)
        assert memory.byz_sparse_step_bytes(N, 7, d, policy=pol) == \
            jmem.byz_sparse_step_bytes(N, 7, d, policy=pol)
        for S in (1, 2, 8):
            assert memory.pushsum_sharded_step_bytes(
                N, E, d, S, policy=pol) == jmem.pushsum_sharded_step_bytes(
                    N, E, d, S, policy=pol)
        assert memory.byz_dense_bytes(N % 5000, d) == \
            jmem.byz_dense_bytes(N % 5000, d)
    hw = HW()
    jhw = jrl.HW(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
                 link_bw=hw.link_bw, hbm_bytes=hw.hbm_bytes)
    for b, f, w, n in ((27e6, 0.0, 0.0, 1), (1e9, 1e12, 5e6, 4)):
        assert memory.step_floor(b, f, wire_bytes=w, n_devices=n) == \
            jmem.step_floor(b, f, jhw, wire_bytes=w, n_devices=n)


def test_footprint_of_a_record():
    rec = cli.synthetic_dense({"N": 11, "d": 2}, "cpu")
    fp = memory.footprint(rec, {"N": 11, "d": 2})
    assert fp["peak_value_bytes"] == 11 * 11 * 4
    assert fp["n_values"] == len(rec.values) and "('N', 'N')" in fp["top"][0]


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _main(*argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def test_cli_lint_passes_on_the_cpu():
    rc, out, err = _main("lint", "--device", "cpu")
    assert rc == 0, err
    assert "lint: PASS" in out and "12 engine contracts" in out


def test_cli_inject_flags_fail_the_lint():
    """Both test hooks in one run: the lint fails, and each injection is
    among the findings (without them it passes, above)."""
    rc, out, err = _main("lint", "--device", "cpu", "--inject-dense",
                         "--inject-legacy-streams", "byzantine")
    assert rc == 1 and "lint: FAIL" in err
    assert "pushsum[synthetic-dense-injection]" in err
    assert "signal@t=1 == gossip@t=0" in err


def test_cli_defaults_to_the_card(monkeypatch):
    """``lint`` and ``budget`` run on the card unless asked for the CPU:
    with no card they refuse, naming ``--device cpu``, and run nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in ("lint", "budget"):
        rc, out, err = _main(cmd)
        assert rc == 2 and out == ""
        assert "no CUDA device; pass --device cpu" in err


def test_cli_budget_and_list_run():
    rc, out, _ = _main("budget", "--device", "cpu")
    assert rc == 0
    assert "H100 constants" in out and "floor" in out
    assert "recorded footprints (cpu)" in out and "social:" in out
    rc, out, _ = _main("list")
    assert rc == 0
    for name in contracts.REGISTRY:
        assert f"  {name}: streams=" in out
