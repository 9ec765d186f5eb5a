"""``python -m repro_torch.statics`` — run the static checks from the command
line.

Subcommands:

* ``lint``   — run every registered engine at its small fixture, on each
  of its stores, under the op recorder, and run the full registry of
  checks: the ``run_*`` signature linter (no entry point may grow a loose
  execution kwarg that ``ExecutionPlan`` covers), the dense-intermediate
  linter, the subnormal-constant scan, the PRNG stream-domain
  disjointness proofs (within each engine and across the engines that
  share one base key), and the reduced-precision carry check (no engine
  carries float32 per-node or per-edge state under the bf16 policy).
  ``--device cuda`` (the default) runs the kernel path, where K1, K2
  and K3 launch; ``--device cpu`` the plain path. Exit 0 iff no findings.
* ``budget`` — print the analytic per-engine step bytes, their H100
  roofline floors, the per-policy budgets (fp32 against bf16 storage),
  the partitioned push-sum's halo bytes, and the recorded footprint of
  each engine's fixture.
* ``list``   — show the registered contracts.

The ``--inject-*`` flags are TEST hooks: they swap a known-bad
configuration (an engine's historical buggy PRNG fold-in scheme, or a
synthetic dense intermediate) into the checked set, so a test can show the
lint would catch each one. They are not for normal use.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from . import contracts, dense, memory, precision, signatures, streams, walk
from .dense import Finding

_BACKEND = "auto"   # the kernels on CUDA tensors, the plain path on the CPU


# ---------------------------------------------------------------------------
# Fixtures — tiny concrete runs per engine, the reference's sizes. Dim sizes
# are pairwise distinct WITHIN each fixture so symbolize can never confuse
# axes. ``make(store, device, policy=None)`` runs the engine once under the
# recorder and returns its Record.
# ---------------------------------------------------------------------------

def _chaos_model():
    """One non-degenerate FaultModel shared by the four faulted fixtures:
    every fault mechanism (burst chain, churn, PS crash) is live, so every
    fault stream is drawn."""
    from ..core.faults import make_fault_model

    return make_fault_model(p_gb=0.2, p_bg=0.5, drop_bad=0.9,
                            leave_prob=0.05, join_prob=0.5,
                            ps_crash_prob=0.3)


def _async_model():
    """One non-degenerate AsyncModel shared by the three async fixtures:
    agents sleep and stale snapshots deliver, so the wake stream is drawn
    and the per-edge buffer carried (a degenerate model runs the
    synchronous loop)."""
    from ..core.asyncrony import make_async_model

    return make_async_model(wake_prob=0.6, staleness=2)


def _planes(plane: str | None) -> dict:
    if plane == "faults":
        return {"faults": _chaos_model()}
    if plane == "async":
        return {"async_": _async_model()}
    return {}


def _pushsum_fixture(plane: str | None = None):
    from ..core.graphs import edge_list, random_strongly_connected, \
        sort_by_dst
    from ..core.plan import ExecutionPlan
    from ..core.prng import prng_key
    from ..core.pushsum import run_pushsum_sparse

    rng = np.random.default_rng(0)
    el = sort_by_dst(edge_list(random_strongly_connected(11, 0.3, rng)))[0]
    w = rng.normal(size=(11, 2)).astype(np.float32)
    dims = {"N": 11, "d": 2, "T": 7, "E": int(el.E)}
    # under a plane, record_every=T: one ratio frame, so the (T, *) ban
    # holds over the whole run (the plane's state is O(E) + O(N))
    every = 1 if plane is None else 7

    def make(store, device, policy=None):
        plan = ExecutionPlan(backend=_BACKEND, policy=policy,
                             **_planes(plane))
        return walk.trace(run_pushsum_sparse, w, el.src, el.dst, 7,
                          drop_prob=0.1, B=2, key=prng_key(0),
                          record_every=every, plan=plan, device=device)

    return dims, (None,), make


def _social_fixture(plane: str | None = None):
    from ..core.graphs import make_hierarchy
    from ..core.hps import HPSConfig
    from ..core.plan import ExecutionPlan
    from ..core.signals import make_confused_model
    from ..core.social import (SOCIAL_STORES, make_social_runtime,
                               run_social_runtime)

    topo = make_hierarchy([6, 6, 6], topology="complete", seed=2)
    model = make_confused_model(N=topo.N, m=3, truth=1, confusion=0.5,
                                seed=0)
    cfg = HPSConfig(topo=topo, gamma_period=4, B=2, drop_prob=0.3)
    rt = make_social_runtime(cfg)
    dims = {"N": 18, "m": 3, "T": 37, "E": int(rt.src.shape[0])}

    def make(store, device, policy=None):
        plan = ExecutionPlan(backend=_BACKEND, store=store, dst_sorted=True,
                             policy=policy, **_planes(plane))
        return walk.trace(run_social_runtime, model, rt, len(topo.sizes), 37,
                          plan=plan, device=device)

    # log_ratio is the in-loop-reduced store: the one where (T, *) is a
    # provable ban rather than the store's own output
    return dims, (SOCIAL_STORES if plane is None else ("log_ratio",)), make


def _hps_fixture(plane: str | None = None):
    from ..core.graphs import make_hierarchy
    from ..core.hps import HPS_STORES, HPSConfig, make_hps_runtime, run_hps
    from ..core.plan import ExecutionPlan

    topo = make_hierarchy([5, 5, 5], topology="complete", seed=0)
    cfg = HPSConfig(topo=topo, gamma_period=4, B=2, drop_prob=0.2)
    rt = make_hps_runtime(cfg)
    w = np.random.default_rng(3).normal(size=(15, 2)).astype(np.float32)
    dims = {"N": 15, "d": 2, "T": 31, "E": int(rt.src.shape[0])}

    def make(store, device, policy=None):
        plan = ExecutionPlan(backend=_BACKEND, store=store, policy=policy,
                             **_planes(plane))
        return walk.trace(run_hps, w, cfg, 31, seed=0, plan=plan,
                          device=device)

    return dims, (HPS_STORES if plane is None else ("gap",)), make


def _pushsum_sharded_fixture():
    """The edge-partitioned sweep of 2 scenarios over 2 shards, emulated in
    one process (the held shards' values are what the contract budgets;
    the reference lints its vmap emulation the same way)."""
    from ..core.graphs import (partition_edge_list,
                               random_strongly_connected_edge_list)
    from ..core.plan import ExecutionPlan
    from ..core.sweeps import run_pushsum_sweep

    rng = np.random.default_rng(5)
    el = random_strongly_connected_edge_list(11, 0.25, rng, sort=False)
    sh = partition_edge_list(el, 2)
    w = rng.normal(size=(11, 3)).astype(np.float32)
    dims = {"N": 11, "d": 3, "T": 5, "S": sh.n_shards, "E": sh.e_pad,
            "Es": sh.e_shard}
    assert len(set(dims.values())) == len(dims), dims

    def make(store, device, policy=None):
        plan = ExecutionPlan(backend=_BACKEND, policy=policy)
        return walk.trace(run_pushsum_sweep, w, sh, 5,
                          drop_probs=[0.1, 0.3], seeds=0, B=2, plan=plan,
                          device=device)

    return dims, (None,), make


def _byz_fixture(plane: str | None = None):
    from ..core import attacks
    from ..core.byzantine import (STORES, ByzantineConfig,
                                  make_byzantine_scan, run_byzantine_learning)
    from ..core.graphs import make_hierarchy
    from ..core.plan import ExecutionPlan
    from ..core.prng import prng_key
    from ..core.signals import make_confused_model

    topo = make_hierarchy([8] * 8, topology="complete", seed=0)   # N = 64
    model = make_confused_model(N=64, m=3, truth=0, confusion=0.0, seed=1)
    cfg = ByzantineConfig(topo=topo, F=2, byz=(2, 9), gamma_period=4,
                          attack=attacks.sign_flip())
    dims = {"N": 64, "m": 3, "T": 5}

    def make(store, device, policy=None):
        if plane is None:
            run = make_byzantine_scan(model, cfg, 5, core="sparse",
                                      backend=_BACKEND, store=store,
                                      policy=policy, device=device)
            return walk.trace(run, prng_key(0))
        # the fault plane arrives as a plan field only
        plan = ExecutionPlan(backend=_BACKEND, store=store, policy=policy,
                             **_planes(plane))
        return walk.trace(run_byzantine_learning, model, cfg, 5, seed=0,
                          core="sparse", plan=plan, device=device)

    return dims, (STORES if plane is None else ("final",)), make


FIXTURES = {
    "pushsum": _pushsum_fixture,
    "social": _social_fixture,
    "hps": _hps_fixture,
    "byzantine": _byz_fixture,
    "pushsum_sharded": _pushsum_sharded_fixture,
    "pushsum_faults": lambda: _pushsum_fixture("faults"),
    "social_faults": lambda: _social_fixture("faults"),
    "hps_faults": lambda: _hps_fixture("faults"),
    "byzantine_faults": lambda: _byz_fixture("faults"),
    "pushsum_async": lambda: _pushsum_fixture("async"),
    "social_async": lambda: _social_fixture("async"),
    "hps_async": lambda: _hps_fixture("async"),
}


def synthetic_dense(dims: dict, device) -> walk.Record:
    """A deliberately broken push-sum-shaped program: it materializes the
    (N, N) averaging matrix the sparse core exists to avoid."""
    import torch

    N = dims["N"]

    def bad(w):
        dense_mix = torch.ones((N, N), dtype=w.dtype, device=w.device) / N
        return dense_mix @ w

    return walk.trace(bad, torch.zeros((N, dims["d"]), device=device))


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------

def dense_findings(engines, device="cuda", *,
                   inject_dense: bool = False) -> tuple[list[Finding], int]:
    """Run each engine's fixture on each of its stores under the recorder
    and lint the record -> ``(findings, targets run)``."""
    out: list[Finding] = []
    n = 0
    for name in engines:
        c = contracts.get(name)
        dims, stores, make = FIXTURES[name]()
        for store in stores:
            where = f"{name}[device={device}" + (
                f", store={store}]" if store else "]")
            n += 1
            try:
                rec = make(store, device)
            except Exception as e:  # a run itself must not break
                out.append(Finding(check="trace-error", where=where,
                                   message=f"{type(e).__name__}: {e}"))
                continue
            out.extend(dense.assert_nonempty(rec, where=where))
            out.extend(dense.find_forbidden(
                rec, dims, c.forbidden_for(store), where=where,
                exempt=c.exempt))
            out.extend(dense.find_subnormal_consts(rec, where=where))
        if inject_dense and name == "pushsum":
            out.extend(dense.find_forbidden(
                synthetic_dense(dims, device), dims, c.forbidden_for(None),
                where="pushsum[synthetic-dense-injection]"))
    return out, n


def _fitted_streams(c, override: dict | None) -> list[streams.AffineMap]:
    if override and c.name in override:
        return list(override[c.name])
    return [streams.fit_affine(s.fold, f"{c.name}.{s.name}")
            for s in c.streams]


def stream_findings(engines, override: dict | None = None) -> list[Finding]:
    """The lattice proofs: each engine's streams pairwise, and each against
    the streams of every engine it shares a base key with."""
    out: list[Finding] = []
    fitted = {}
    for name in engines:
        c = contracts.get(name)
        try:
            fitted[name] = _fitted_streams(c, override)
        except ValueError as e:
            out.append(Finding(check="prng-stream-collision", where=name,
                               message=str(e)))
            fitted[name] = []
    for name in engines:
        c = contracts.get(name)
        out.extend(streams.check_streams(fitted[name], c.horizon,
                                         where=name))
        for other in c.shares_seed_with:
            oc = contracts.get(other)
            if other not in fitted:
                fitted[other] = _fitted_streams(oc, override)
            horizon = min(c.horizon, oc.horizon)
            for m1 in fitted[name]:
                for m2 in fitted[other]:
                    disjoint, wit = streams.affine_disjoint(m1, m2, horizon)
                    if not disjoint:
                        t1, t2, val = wit
                        out.append(Finding(
                            check="prng-stream-collision",
                            where=f"{name} x {other}",
                            message=(
                                f"shared-seed engines collide: {m1.name}"
                                f"@t={t1} == {m2.name}@t={t2} (both fold "
                                f"{val}); maps [{m1}] vs [{m2}] over "
                                f"horizon T={horizon}"
                            ),
                        ))
    return out


def _loops() -> dict:
    """Engine -> (the function holding its round loop, its fixture, the
    store the carry check runs)."""
    from ..core import byzantine, hps, pushsum, social

    return {
        "pushsum": (pushsum.run_pushsum_sparse, _pushsum_fixture, None),
        "social": (social._social_scan_core, _social_fixture, "log_ratio"),
        "hps": (hps._hps_scan_core, _hps_fixture, "gap"),
        "byzantine": (byzantine._scan_core, _byz_fixture, "final"),
    }


def precision_findings(device="cuda", policy="bf16") -> list[Finding]:
    """The carry contract of each engine under ``policy``, synchronous and
    under the async plane (whose per-edge buffer is carried too)."""
    out: list[Finding] = []
    for name, (fn, fixture, store) in _loops().items():
        for plane in (None, "async") if name in ("pushsum", "social", "hps") \
                else (None,):
            dims, _, make = fixture(plane)
            where = f"{name}[policy={policy}" + (
                f", {plane}]" if plane else "]")
            carried = precision.carried_state(
                fn, lambda: make(store, device, policy))
            out += precision.find_fp32_carries(carried, dims, where=where)
    return out


def lint(device="cuda", *, inject_dense: bool = False,
         override: dict | None = None) -> tuple[list[Finding], int]:
    """Every check of ``lint`` -> ``(findings, fixture runs)``."""
    from .. import core  # noqa: F401  registers every contract

    engines = sorted(contracts.REGISTRY)
    findings = signatures.check_entrypoints()
    dense_out, n = dense_findings(engines, device, inject_dense=inject_dense)
    findings += dense_out
    findings += stream_findings(engines, override)
    findings += precision_findings(device)
    return findings, n


# ---------------------------------------------------------------------------
# Subcommands
# ---------------------------------------------------------------------------

def _cmd_lint(args) -> int:
    override = None
    if args.inject_legacy_streams:
        override = {args.inject_legacy_streams:
                    streams.LEGACY_BUGGY_STREAMS[args.inject_legacy_streams]}
    findings, n = lint(args.device, inject_dense=args.inject_dense,
                       override=override)
    for f in findings:
        print(f, file=sys.stderr)
    if findings:
        print(f"lint: FAIL — {len(findings)} finding(s) over {n} recorded "
              f"runs on {args.device}", file=sys.stderr)
        return 1
    print(f"lint: PASS — {n} recorded runs on {args.device}, "
          f"{len(contracts.REGISTRY)} engine contracts, 0 findings")
    return 0


# the engines' main cells at full size (benchmarks' set-ups): name ->
# (model, its arguments)
_MAIN_CELLS = (
    ("Alg. 3   N=131072 E=917504 m=3", memory.social_step_bytes,
     (131072, 917504, 3)),
    ("Alg. 2   N=131072 deg=7 m=3x3", memory.byz_sparse_step_bytes,
     (131072, 7, 9)),
    ("HPS      N=131072 E=917504 d=4", memory.hps_step_bytes,
     (131072, 917504, 4)),
    ("pushsum  N=131072 E=393211 d=4", memory.pushsum_step_bytes,
     (131072, 393211, 4)),
)


def _cmd_budget(args) -> int:
    from ..analysis.memory_model import pushsum_device_memory_gb
    from ..analysis.roofline import HW, pushsum_halo_wire_bytes

    from .. import core  # noqa: F401  registers every contract

    hw = HW()
    print(f"H100 constants: {hw}")
    print("analytic per-round step bytes and H100 roofline floors:")
    cases = [
        ("pushsum  N=1024 E=3102 d=1",
         memory.pushsum_step_bytes(1024, 3102, 1)),
        ("social   N=18 E=90 m=3", memory.social_step_bytes(18, 90, 3)),
        ("hps      N=15 E=62 d=2", memory.hps_step_bytes(15, 62, 2)),
        ("byz-sparse N=64 deg=8 m=3",
         memory.byz_sparse_step_bytes(64, 8, 3)),
        ("byz-DENSE  N=4096 m=3", memory.byz_dense_bytes(4096, 3)),
        *((label, fn(*a)) for label, fn, a in _MAIN_CELLS),
    ]
    for label, b in cases:
        floor = memory.step_floor(b)
        print(f"  {label:32s} {b / 1e6:10.3f} MB  "
              f"floor {floor['bound_step_time_s'] * 1e6:9.3f} us  "
              f"({floor['dominant']}-bound)")

    print("edge-partitioned per-DEVICE budgets (graph axis, halo on the "
          "collective term):")
    for Ns, Es, ds, Ss in ((1 << 20, 1 << 21, 1, 4),
                           (1 << 20, 1 << 21, 1, 1)):
        b = memory.pushsum_sharded_step_bytes(Ns, Es, d=ds, n_shards=Ss)
        wire = pushsum_halo_wire_bytes(Ns, ds, Ss)
        floor = memory.step_floor(b, wire_bytes=wire, n_devices=Ss)
        resid = pushsum_device_memory_gb(Ns, Es, d=ds, n_shards=Ss)
        label = f"pushsum-2d N={Ns} E={Es} d={ds} S={Ss}"
        print(f"  {label:38s} {b / 1e6:10.3f} MB/step  "
              f"halo {wire / 1e6:7.3f} MB  "
              f"floor {floor['bound_step_time_s'] * 1e6:8.3f} us  "
              f"({floor['dominant']}-bound)  "
              f"resident {resid['total_gb']} GB "
              f"fits_hbm={resid['fits_hbm']}")

    print("per-policy step budgets (storage dtype is the bandwidth knob; "
          "masks, PRNG draws, sort keys and ids stay fp32/int32, so bf16 "
          "lands near — not exactly at — half):")
    pol_cases = [
        ("pushsum    N=131072 E=524288 d=1",
         lambda p: memory.pushsum_step_bytes(131072, 524288, 1, policy=p)),
        ("pushsum-2d N=1048576 E=2097152 S=4",
         lambda p: memory.pushsum_sharded_step_bytes(
             1 << 20, 1 << 21, d=1, n_shards=4, policy=p)),
        ("social     N=131072 E=917504 m=3",
         lambda p: memory.social_step_bytes(131072, 917504, 3, policy=p)),
        ("hps        N=131072 E=917504 d=4",
         lambda p: memory.hps_step_bytes(131072, 917504, 4, policy=p)),
        ("byz-sparse N=131072 deg=7 m=3x3",
         lambda p: memory.byz_sparse_step_bytes(131072, 7, 9, policy=p)),
    ]
    for label, fn in pol_cases:
        f32, b16 = fn(None), fn("bf16")
        print(f"  {label:36s} fp32 {f32 / 1e6:10.3f} MB  "
              f"bf16 {b16 / 1e6:10.3f} MB  ratio {b16 / f32:.3f}")
    print("halo wire bytes per round per device (N=1048576 d=1 S=4), "
          "psum vs scatter+gather:")
    for sb, tag in ((4, "fp32"), (2, "bf16")):
        wp = pushsum_halo_wire_bytes(1 << 20, 1, 4)
        ws = pushsum_halo_wire_bytes(1 << 20, 1, 4, variant="scatter",
                                     storage_bytes=sb)
        print(f"  storage={tag}: psum {wp / 1e6:8.3f} MB  "
              f"scatter {ws / 1e6:8.3f} MB  ratio {ws / wp:.3f}")

    print(f"recorded footprints ({args.device}):")
    for name in ("byzantine", "hps", "pushsum", "social"):
        dims, stores, make = FIXTURES[name]()
        fp = memory.footprint(make(stores[0], args.device), dims)
        print(f"  {name}: {fp['n_values']} values, peak "
              f"{fp['peak_value_bytes']} B, total {fp['total_bytes']} B")
        for line in fp["top"][:3]:
            print(f"    {line}")
    return 0


def _cmd_list(args) -> int:
    from .. import core  # noqa: F401  registers every contract

    print("contracts:")
    for c in contracts.all_contracts():
        pats = {k: list(v) for k, v in c.forbidden.items()}
        print(f"  {c.name}: streams={[s.name for s in c.streams]}, "
              f"forbidden={pats}, exempt={list(c.exempt)}, "
              f"shares_seed_with={list(c.shares_seed_with)}, "
              f"horizon={c.horizon}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.statics",
        description="static checks of the port's engines",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    lint_p = sub.add_parser("lint", help="run every static check")
    lint_p.add_argument("--device", default="cuda",
                        help="where the fixtures run: cuda (the kernel "
                             "path, the default) or cpu (the plain path)")
    lint_p.add_argument("--inject-legacy-streams",
                        choices=sorted(streams.LEGACY_BUGGY_STREAMS),
                        help="TEST ONLY: check the named engine with its "
                             "historical buggy fold-in scheme")
    lint_p.add_argument("--inject-dense", action="store_true",
                        help="TEST ONLY: add a synthetic (N, N) "
                             "intermediate to the pushsum lint target")
    lint_p.set_defaults(fn=_cmd_lint)

    budget = sub.add_parser("budget", help="static memory/byte budgets")
    budget.add_argument("--device", default="cuda",
                        help="where the footprint fixtures run: cuda (the "
                             "default) or cpu")
    budget.set_defaults(fn=_cmd_budget)

    lst = sub.add_parser("list", help="show the contracts")
    lst.set_defaults(fn=_cmd_list)

    args = ap.parse_args(argv)
    if getattr(args, "device", "cpu").startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            print(f"{args.cmd}: no CUDA device; pass --device cpu for the "
                  f"plain path", file=sys.stderr)
            return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
