"""Smoke run of the PyTorch/CUDA port of Algorithm 3 on one NVIDIA GPU.

Phases (any failure raises and the script exits non-zero):

1. build   — compile every CUDA kernel of the port from
             src/repro_torch/kernels/csrc, one nvcc per source, at once;
2. kernels — hold each kernel against its plain PyTorch version on the card
             at the main path's full-size shapes, with stated tolerances;
3. main    — run_social_runtime at N = 131,072 agents (16,384 complete
             8-agent networks, E = 917,504 links), T = 200, through the
             kernels and again through the plain path; both kernels must
             launch T times, the two runs must agree, mass is conserved;
4. quickstart — examples/quickstart.py's Algorithm 3 scenario on the card:
             every agent's final belief in theta* above 0.95;
5. timing  — CUDA-event medians of each kernel and its plain version, and
             of one main-path step at N = 16,384 and 131,072; a profiler
             breakdown of the full-size step.

It prints the card's name and power limit, one JSON line of kernel
figures, and last the device line. Run from the repository root:

    python3 chip_smoke.py

Where there is no CUDA device, or the port's sources are not beside this
file, it exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

T_MAIN = 200
N_FULL = 131_072
N_SMALL = 16_384
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
TIMED_RUNS = 30
STEP_RUNS, STEP_T = 20, 50


def require(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def scenario(n_agents: int):
    """benchmarks/social_learning.py's step set-up: N/8 complete 8-agent
    networks, drop 0.1, fusion every 8 rounds, B = 4, confusion 0.75."""
    from repro_torch.core import (block_complete_edge_list,
                                  make_confused_model,
                                  social_runtime_from_edge_list)
    el, rep_mask = block_complete_edge_list([8] * (n_agents // 8))
    model = make_confused_model(N=n_agents, m=3, truth=0, confusion=0.75,
                                seed=1)
    rt = social_runtime_from_edge_list(el, rep_mask, drop_prob=0.1,
                                       gamma_period=8, B=4)
    return model, rt, n_agents // 8


def event_ms(fn, runs: int, flush=None) -> float:
    """Median device milliseconds of ``fn()``, each run bracketed by its
    own CUDA events; ``flush()`` runs before each, outside the events."""
    import torch
    times = []
    for _ in range(runs):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(bytes_moved: int, flops: int) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core import ExecutionPlan, HPSConfig, make_hierarchy
    from repro_torch.core import make_confused_model, run_social_learning
    from repro_torch.core import run_social_runtime, sparse_mass_invariant
    from repro_torch.core.signals import SignalModel
    from repro_torch.kernels import _build
    from repro_torch.kernels.pushsum_edge import (edge_scatter_cuda,
                                                  edge_scatter_ref)
    from repro_torch.kernels.social_innov import (innovation_cuda,
                                                  innovation_ref,
                                                  sample_signals)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {len(built)} kernels in {time.perf_counter() - t0:.2f} s")
    for b in built.values():
        ptxas = [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {b.name}: {b.seconds:.2f} s -> {b.path.name}; "
            + " | ".join(ptxas))

    # ---- set-up at full size -------------------------------------------
    t0 = time.perf_counter()
    model, rt, M = scenario(N_FULL)
    rt_d = rt.to(dev)
    tables_d = model.tables.to(dev)
    N, E = N_FULL, rt.src.shape[0]
    log(f"[setup] N={N} E={E} M={M} in {time.perf_counter() - t0:.2f} s")
    require(E == 917_504, "E == 917,504")

    # ---- phase 2: kernels against their plain versions ------------------
    rng = np.random.default_rng(0)
    D = 4
    sigma = torch.tensor(rng.normal(size=(N, D)), dtype=torch.float32,
                         device=dev)
    rho = torch.tensor(rng.normal(size=(E, D)), dtype=torch.float32,
                       device=dev)
    live = torch.tensor(rng.random(E) < 0.9, device=dev) & rt_d.valid
    k1_args = (sigma, rho, live, rt_d.src, rt_d.offsets)
    rho_k, recv_k = edge_scatter_cuda(*k1_args)
    rho_p, recv_p = edge_scatter_ref(sigma, rho, live, rt_d.src, rt_d.dst)
    torch.cuda.synchronize()
    require(torch.equal(rho_k, rho_p), "edge_scatter rho_new bit-equal")
    torch.testing.assert_close(recv_k, recv_p, rtol=1e-5, atol=1e-6)
    k1_err = max((rho_k - rho_p).abs().max().item(),
                 (recv_k - recv_p).abs().max().item())
    log(f"[kernels] edge_scatter: rho_new bit-equal, recv within rtol 1e-5 "
        f"atol 1e-6 (reduction order); max_abs_err {k1_err:.3e}")

    m_hyp, S = model.m, model.S
    log_tables = torch.log(tables_d)
    cdf = torch.cumsum(tables_d[:, model.truth, :], dim=-1)
    z = torch.tensor(rng.normal(size=(N, m_hyp)) * 10, dtype=torch.float32,
                     device=dev)
    mass = torch.tensor(rng.random(N), dtype=torch.float32, device=dev)
    mass[:64] = 0.0                       # vanishing mass stays finite
    u = torch.tensor(rng.random(N), dtype=torch.float32, device=dev)
    u[64:128] = cdf[64:128, -1]           # at / above the last CDF value
    u[128:192] = 0.99999994
    k2_args = (z, mass, u, cdf, log_tables)
    # the sampled letter, read through z_new on a table holding each
    # letter's index: z_new = 0 + index = sig exactly
    letters = torch.arange(S, dtype=torch.float32, device=dev).expand(
        N, m_hyp, S).contiguous()
    sig_k, _ = innovation_cuda(torch.zeros_like(z), mass, u, cdf, letters)
    sig_p = sample_signals(u, cdf)
    torch.cuda.synchronize()
    require(torch.equal(sig_k[:, 0].long(), sig_p), "signals bit-equal")
    zk, mu_k = innovation_cuda(*k2_args)
    zp, mu_p = innovation_ref(*k2_args)
    torch.cuda.synchronize()
    require(torch.equal(zk, zp), "innovation z_new bit-equal")
    torch.testing.assert_close(mu_k, mu_p, rtol=1e-5, atol=1e-6)
    require(bool(torch.isfinite(mu_k).all()), "beliefs finite")
    k2_err = max((zk - zp).abs().max().item(),
                 (mu_k - mu_p).abs().max().item())
    log(f"[kernels] social_innov: signals and z_new bit-equal, mu within "
        f"rtol 1e-5 atol 1e-6 (softmax order); max_abs_err {k2_err:.3e}")

    # ---- phase 3: the main path at full size ----------------------------
    plan_k = ExecutionPlan(store="log_ratio", dst_sorted=True)
    plan_p = plan_k.replace(backend="torch")
    edge_scatter_cuda.launches = innovation_cuda.launches = 0
    t0 = time.perf_counter()
    res_k = run_social_runtime(model, rt, M, T_MAIN, seed=0, plan=plan_k)
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    launches = {"edge_scatter": edge_scatter_cuda.launches,
                "social_innov": innovation_cuda.launches}
    log(f"[main] N={N} T={T_MAIN} kernels: {wall_k:.2f} s, launches "
        f"{launches}")
    require(launches == {"edge_scatter": T_MAIN, "social_innov": T_MAIN},
            "each kernel launched T times on the main path")
    res_p = run_social_runtime(model, rt, M, T_MAIN, seed=0, plan=plan_p)
    res_p2 = run_social_runtime(model, rt, M, T_MAIN, seed=0, plan=plan_p)
    torch.cuda.synchronize()
    require(edge_scatter_cuda.launches == T_MAIN
            and innovation_cuda.launches == T_MAIN,
            "the plain path launched no kernel")
    bk, bp = res_k.beliefs, res_p.beliefs
    require(bk.shape == (N, m_hyp) and res_k.log_ratio.shape == (T_MAIN,),
            "result shapes")
    require(bool(torch.isfinite(bk).all())
            and bool(torch.isfinite(res_k.log_ratio).all()), "finite")

    def gaps(a, b):
        return ((a.beliefs - b.beliefs).abs().max().item(),
                (a.log_ratio - b.log_ratio).abs().max().item())

    gap_kp, gap_pp = gaps(res_k, res_p), gaps(res_p2, res_p)
    counter = res_k.final_state.sigma.abs().max().item()
    log(f"[main] max gap (beliefs, worst-log-ratio curve): kernel vs plain "
        f"{gap_kp[0]:.3e}, {gap_kp[1]:.3e}; plain vs plain {gap_pp[0]:.3e}, "
        f"{gap_pp[1]:.3e}; largest relay counter |sigma| {counter:.1f}")
    # Tolerance. The two paths add each receiver's increments in different
    # orders (the kernel in edge order, index_add_ with atomics), about one
    # ulp of the receiver sum per round. The relay counters sigma and rho
    # are cumulative, so they grow to ~1e3-1e4 by T = 200; a one-ulp
    # change in a sum can flip the rounding of such a counter, moving z / m
    # by one counter ulp (~1e-4..1e-3) over the mass. Beliefs are held to
    # 1e-2, the worst-log-ratio curve to 5e-2 nats, and the argmax to
    # equality wherever the top two beliefs are more than 2e-2 apart.
    torch.testing.assert_close(bk, bp, rtol=0, atol=1e-2)
    torch.testing.assert_close(res_k.log_ratio, res_p.log_ratio, rtol=0,
                               atol=5e-2)
    top2 = bp.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2e-2
    require(torch.equal(bk.argmax(-1)[decided], bp.argmax(-1)[decided]),
            "argmax equal")
    learned = (bk.argmax(-1) == model.truth).float().mean().item()
    inv = sparse_mass_invariant(res_k.final_state, rt_d.src, rt_d.valid)
    mass_total = inv[-1].item()
    require(abs(mass_total - N) <= 1e-4 * N, "mass invariant")
    log(f"[main] argmax equal on {int(decided.sum())}/{N} decided agents; "
        f"share deciding theta* {learned:.4f}; worst log ratio at T "
        f"{res_k.log_ratio[-1].item():.3f}; total mass {mass_total:.3f}")

    # ---- phase 4: quickstart scenario -----------------------------------
    topo = make_hierarchy([6, 6, 6], topology="complete", seed=0)
    qmodel = make_confused_model(N=topo.N, m=3, truth=1, confusion=0.5,
                                 seed=0)
    qcfg = HPSConfig(topo=topo, gamma_period=8, B=4, drop_prob=0.3)
    edge_scatter_cuda.launches = innovation_cuda.launches = 0
    qres = run_social_learning(qmodel, qcfg, T=500, seed=0)
    torch.cuda.synchronize()
    require(edge_scatter_cuda.launches == 500
            and innovation_cuda.launches == 500, "quickstart launches")
    qmin = qres.beliefs[-1, :, qmodel.truth].min().item()
    log(f"[quickstart] min final belief in theta*: {qmin:.6f}")
    require(qmin > 0.95, "quickstart learns theta*")

    # ---- phase 5: timing ------------------------------------------------
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()   # evict the 50 MB L2 between timed launches

    k1_ms = event_ms(lambda: edge_scatter_cuda(*k1_args), TIMED_RUNS, flush)
    k1_plain = event_ms(lambda: edge_scatter_ref(
        sigma, rho, live, rt_d.src, rt_d.dst), TIMED_RUNS, flush)
    k2_ms = event_ms(lambda: innovation_cuda(*k2_args), TIMED_RUNS, flush)
    k2_plain = event_ms(lambda: innovation_ref(*k2_args), TIMED_RUNS, flush)
    k1_bound, k1_by = bound(
        nbytes(sigma, rho, live, rt_d.src, rt_d.offsets, rho_k, recv_k),
        2 * E * D)
    k2_bound, k2_by = bound(nbytes(*k2_args, zk, mu_k),
                            N * (S + m_hyp * 8))
    log(f"[timing] edge_scatter {k1_ms:.4f} ms (plain {k1_plain:.4f}, "
        f"bound {k1_bound:.4f}); social_innov {k2_ms:.4f} ms (plain "
        f"{k2_plain:.4f}, bound {k2_bound:.4f}); medians of {TIMED_RUNS}, "
        f"L2 flushed")

    step_ms, cells = {}, {}
    for n_agents in (N_SMALL, N_FULL):
        smodel, srt, sM = (model, rt, M) if n_agents == N_FULL \
            else scenario(n_agents)
        smodel = SignalModel(tables=smodel.tables.to(dev), truth=smodel.truth)
        srt = srt.to(dev)
        cells[n_agents] = (smodel, srt, sM)
        for backend in ("auto", "torch"):
            plan = ExecutionPlan(backend=backend, store="final",
                                 dst_sorted=True)

            def run():
                run_social_runtime(smodel, srt, sM, STEP_T, seed=0, plan=plan)

            run()
            step_ms[(n_agents, backend)] = event_ms(run, STEP_RUNS) / STEP_T
        log(f"[timing] step at N={n_agents}: kernels "
            f"{step_ms[(n_agents, 'auto')]:.4f} ms, plain "
            f"{step_ms[(n_agents, 'torch')]:.4f} ms (median of {STEP_RUNS} "
            f"runs of {STEP_T} steps, store=final)")

    for n_agents, (pmodel, prt, pM) in cells.items():
        profile_step(run_social_runtime, pmodel, prt, pM,
                     step_ms[(n_agents, "auto")])

    kernels = [
        {"name": "edge_scatter", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/edge_scatter.cu",
         "replaces": "src/repro/kernels/pushsum_edge/pushsum_edge.py:114",
         "launches": launches["edge_scatter"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "social_innov", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/social_innov.cu",
         "replaces": "src/repro/kernels/social_innov/social_innov.py:75",
         "launches": launches["social_innov"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def profile_step(run_social_runtime, model, rt, M, step_ms: float) -> None:
    """Device time by kernel over 20 kernel-path steps (torch.profiler),
    and the share of the unprofiled step time ``step_ms`` it covers."""
    import torch
    from repro_torch.core import ExecutionPlan

    plan = ExecutionPlan(store="final", dst_sorted=True)
    run_social_runtime(model, rt, M, 5, seed=0, plan=plan)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        run_social_runtime(model, rt, M, 20, seed=0, plan=plan)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    if not rows:
        log("[profile] the profiler recorded no device time: not measured")
        return
    busy = sum(r[1] for r in rows)
    log(f"[profile] 20 steps at N={rt.rep_mask.shape[0]}: device busy "
        f"{busy:.3f} ms in {sum(r[2] for r in rows)} device ops (run set-up "
        f"included), {busy / 20:.4f} ms a step = {busy / 20 / step_ms:.3f} "
        f"of the unprofiled {step_ms:.4f} ms step; wall {wall_ms:.1f} ms "
        f"with the profiler on")
    for key, ms, count in rows[:12]:
        log(f"[profile]   {ms:9.3f} ms  x{count:<5d} {key[:90]}")


if __name__ == "__main__":
    sys.exit(main())
