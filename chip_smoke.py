"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: Algorithm 3
(social learning), Algorithm 2 (Byzantine-resilient learning), Algorithm 1
(push-sum consensus and hierarchical push-sum), grids of Algorithm 1, 2
and 3 scenarios run as one graph, the serving path of the dense GQA models (Qwen3-8B) and of RWKV6 (RWKV6-1.6B),
and decentralized robust training (paper_sim).

Phases (any failure raises and the script exits non-zero):

1. build   — compile every CUDA kernel of the port from
             src/repro_torch/kernels/csrc, one nvcc per source, at once;
2. kernels — hold each kernel against its plain PyTorch version on the card
             at the main paths' full-size shapes, with stated tolerances;
             K1 on both of its kernels (edge-tiled, column walk), its recv
             bit-equal to the float32 edge-order sum, also at its edge
             cases (D 3/4/40, empty receivers, padding, no live edge, a hub
             of in-degree 1,500 over three edge tiles, unaligned rows); K2's
             letters and z_new bit-equal, also at a ragged last block,
             unaligned ranges, other alphabets and long rows (16 agents a
             block, and one past 48 KB of shared memory); K3's tsum
             bit-equal to the float32 rank-order sum of the sorted
             survivors and kept bit-equal, at its edge
             cases too (deg_max 1..64 over every width of its network,
             scattered valid slots, deg <= 2F, F = 0, +-1e6, NaN, sign-bit
             NaN and +-inf lies), and the plain trim-gather on the card
             bit-equal to its CPU run with sign-bit NaN lies at deg_max 33
             and 64;
3. main    — run_social_runtime at N = 131,072 agents (16,384 complete
             8-agent networks, E = 917,504 links), T = 200, through the
             kernels and again through the plain path; both kernels must
             launch T times (K1 on its edge-tiled kernel), the two runs
             must agree, mass is conserved;
4. quickstart — examples/quickstart.py's Algorithm 3 scenario on the card:
             every agent's final belief in theta* above 0.95;
5. byzantine main — run_byzantine_runtime at N = 131,072 (the same
             networks, F = 2, large_value lies from agents 2 and 9, Γ = 10),
             T = 200, through the trim-gather kernel and again through the
             plain path; the kernel launches T times, decisions agree where
             the decision margin is clear, r agrees;
6. byzantine oracles — examples/quickstart.py's Algorithm 2 scenario on
             the card (normal-agent accuracy 1.0), and the sparse kernel
             path against the port's dense oracle on 4x7 complete networks
             for every attack;
6a. K1 at D = 5 — the Algorithm 1 engines' width (d = 4 values and the
             mass), on the edge-tiled kernel's scalar-row path, at both
             full shapes: rho_new bit-equal, recv bit-equal to the float32
             edge-order sum;
6b. hps main — run_hps_runtime at N = 131,072 (16,384 complete 8-agent
             networks, benchmarks/hps_bench.py's step set-up), Γ 8, B 4,
             drop 0.1, T = 200, store gap, through K1 and again through the
             plain path; K1 launches T times, all tiled, the plain path
             none; mass conserved, the gap falls, the paths agree;
6c. pushsum main — run_pushsum_sparse on benchmarks/pushsum_sweep.py's
             random strongly connected graph (N = 131,072, ~393,000
             links), drop 0.2, B 4, T = 200, kernels and plain; K1 launches
             T times; the value and mass invariants hold, the paths agree;
6d. theorem 1 — benchmarks/hps_bench.py's six consensus scenarios, each
             gap curve through the kernels against the plain path, and
             tests/test_hps_engine.py's envelope (16 runs on 2x4 complete
             networks) under theorem1_bound;
6e. hps grid — run_hps_grid over 256 complete 8-agent networks (N =
             2,048), drop 0/0.1/0.3/0.6 x Γ 4/8 x 8 seeds = 64 scenarios,
             B 4, T = 200, as one block-diagonal graph of 131,072 nodes
             and 917,504 links: K1 launches T times for all of them; the
             rows against the plain path, every row's mass, every gap
             curve under theorem1_bound; rows 0 and 63 against their
             single runs on the card (link masks and K1's recv bit-equal);
             then benchmarks/hps_bench.py's 48-scenario grid (N = 18, M
             2/3/6, mixed E) at T = 300; timings;
6f. social grid — run_social_grid on the same networks, m = 3, drop
             0/0.3/0.6/0.9 x Γ 4/8 x 8 seeds, T = 200: K1 and K2 launch T
             times; beliefs and decisions against the plain path; rows 0
             and 63 against their single runs (masks, signal uniforms,
             K1's recv and K2's outputs bit-equal); then
             benchmarks/social_learning.py's 48-scenario sweep at T = 300,
             every agent's final belief in theta* above 0.9 where drop <
             0.9; timings;
6g. pushsum sweep — run_pushsum_sweep over two draws of
             benchmarks/pushsum_sweep.py's graph at N = 4,096, drop
             0/0.3/0.6/0.9 x 4 seeds = 32 scenarios, B 4, T = 200, one
             graph of 131,072 nodes: K1 launches T times; every row's
             mass gap within 1e-4 N, err falls where drop < 0.9, the rows
             against the plain path and rows 0 and 31 against their single
             runs; timings (each grid's step, its scenario-step, one
             scenario alone, and a profile);
6h. byzantine grid — run_byzantine_grid over the same 256 networks at
             confusion 0.25, 4 configs (F/Byzantine/Γ 0/-/10, 1/2/10,
             2/2,9/10, 2/2,9/4) x 16 seeds = 64 scenarios, large_value
             lies, T = 200, one neighbor-list graph of 131,072 receivers:
             K3 launches T times, each with F per receiver; rows against
             the plain path, every row's normal agents in C deciding
             theta* (share > 0.99); rows 0 and 63 against their single
             runs (signal uniforms and K3's tsum bit-equal); then
             run_byzantine_sweep on the F 2, Γ 10 config over 16 seeds
             with sign_flip, extreme_pull and random_noise, and
             benchmarks/byzantine_bench.py's 48-scenario grid; K3 with F
             per receiver bit-equal to the rank-order sum at the grid's
             shape and at the edge cases; timings (K3 with F per receiver
             beside an int F, the grid step, a profile);
6i. planes — the fault and async planes through the four engines at N =
             131,072 (the main cells), T = 200: Alg. 3 under the chaos
             lane's severe model, the churn model and make_async_model(0.6,
             8); HPS and push-sum under the severe and the async model;
             Alg. 2 under the severe model; each through the kernels and
             the plain path: K1, K2 and K3 launch T times where the engine
             uses them (K1 on its identity-source route under async),
             outputs finite, mass within 1e-4 N, decisions equal on the
             clear agents; the fault, liveness, wake and mask draws on the
             card bit-equal to the CPU's; the degenerate models bit-equal
             to no plane on the kernel path; K1's identity-source route at
             the HPS and push-sum shapes bit-equal to the edge-order sum;
             timings (kernel and plain in turns) and profiles;
6j. planes grid — the social grid of 6f and the HPS grid of 6e (2 seeds)
             crossed with benchmarks/chaos.py's four fault models (K·N =
             131,072), the social grid crossed with social_learning.py's
             nine (wake, staleness) cells (N = 18, T = 600), the Byzantine
             grid of 6h under the severe model: each kernel once a round
             for all K; rows 0 and K-1 against their single runs (draws
             bit-equal, state within the single paths' limits); timings;
             then examples/quickstart_torch.py on the card (its sections'
             asserts; each loop's kernels launched once a round);
6k. precision — the precision policy: K1, K2 and K3 on bf16 and fp16
             storage at the engines' main shapes (K1 at D = 4 on both
             kernels, at D = 5 and on its identity-source route; K3 with
             stride-0 lies, an int F and F per receiver) against their
             plain versions: rho_new and z_new bit-equal, recv and tsum
             bit-equal to the float32 edge-order and rank-order sums of the
             upcast storage values; the four engines at N = 131,072 under
             policy bf16, T = 32 (the envelope's horizon: bf16 storage is
             for short windows), through the kernels (each launching T
             times on half storage) and the plain path: decisions equal on
             clear agents, ratios within 4 bf16 ulps of their scale where
             m >= 0.1; policy fp32 bit-equal to no policy on the
             kernel path; tests/test_bf16_envelope.py's T = 32 envelope on
             the kernel path (its ten scenarios and the HPS main cell); the
             HPS grid of 6e under bf16 (K1 once a round for all 64
             scenarios); each variant's time beside its float32 kernel's
             and its bound, and the four engines' ms a step under bf16 and
             fp32 in turns;
7. timing  — K1-K3 three ways (device time with the host's enqueueing
             hidden, the JSON time; the kernel alone under the profiler;
             host-inclusive), K1's column walk beside its edge-tiled kernel,
             K3 with materialized lies and at deg_max 16, 32 and 64, and K1
             at pushsum_sparse's shape (8 workers x 2^24 + 1 columns), their
             plain versions; K1 at D = 5 at the HPS and push-sum shapes
             three ways, beside its plain version, its bound and a device
             copy of the same bytes; CUDA-event medians of one step of each
             main path (Alg. 3, Alg. 2, HPS, push-sum) at N = 16,384 and
             131,072; profiler breakdowns of the full-size steps;
8. serve kernels — the decode attention (K5: its one-launch tensor-core
             kernel for bf16, split and combine for float32) and the
             prefill attention (K6: its tensor-core kernel for bf16 at head
             sizes 64 and 128, its FMA kernel otherwise) against their
             plain versions at the serve path's full shapes, at the
             training shape, and at edge cases (ragged cache, lengths < Wc
             and inside 64-row tiles, a ring window, a cache shorter than a
             tile, empty requests, G in {1, 3, 4, 8, 16}; window in {0, w},
             a window edge inside a query tile, S not a multiple of the
             tile, strided views), with stated tolerances, each case on
             the kernel its dtype picks;
9. serve main — Qwen3-8B at published widths and full depth (36 layers),
             bf16, seeded random weights: 8 requests of 2,048-token
             prompts, 32 greedy tokens through launch.serve.generate
             (prefill, then 31 decode steps; K6 launches 36 times and K5
             36 x 31, all on their tensor-core kernels); its logits
             against the plain serve path and the plain full forward over
             the same tokens;
10. serve timing — CUDA-event medians of K5, K6, their plain versions
             and SDPA at the serve shapes (and K6 and SDPA at the training
             shape; K5 also with the host's enqueueing hidden behind a
             device sleep, its JSON time); time to prefill and ms per
             decode step, kernel and plain paths; a profile of decode
             steps;
11. serve fp32 — the same path at 2 layers in float32 (4 x 1,000-token
             prompts, 16 tokens) against the plain full forward, within a
             limit a bf16 computation would fail;
12. rwkv kernel — the chunked WKV6 scan (K7: three chunk-parallel
             passes) against its plain chunked version and the sequential
             scan: T in {1, 63, 64, 65, 1,000, 2,048}, the chunk-group
             edges 127, 128, 129, 255 and 257, one sequence of 8,192, BH in
             {1, 8, 256, 300}, (B, H) views of (B, T, H, 64) projections,
             float32 and bf16, the model's decay and both clip ends, with
             stated tolerances;
13. rwkv main — RWKV6-1.6B at published widths and full depth (24
             layers), bf16, seeded random weights: 8 requests of
             2,048-token prompts, 32 greedy tokens through
             launch.serve.generate (K7 launches 24 times, decode none); its
             logits against the plain serve path and the plain full
             forward;
14. rwkv timing — K7 (device time with the host hidden, and
             host-inclusive) and its plain version at the serve shape,
             beside its bound and its design's floor; time to prefill and
             ms per decode step, kernel and plain paths, a profile of
             decode steps;
15. rwkv fp32 — 2 layers in float32, 4 x 1,000-token prompts (a ragged
             last chunk), 16 tokens, against the plain full forward; then
             the full 24 layers in float32 (2 x 2,048-token prompts, 8
             tokens) by the rule of phase 13, where the greedy choices must
             agree on at least half the positions;
16. train kernels — the trimmed mean (K4) against its sort-based plain
             version at the main path's (8, 99,496,704) for F in {0, 2} and
             at edge cases (W 3..64, D 1/3/4,097, a column offset of 1,
             ties, +-1e6, inf and NaN rows, NaN rows with the sign bit
             set, +-0 ties; W <= 2F raises), and the plain version on the
             card bit-equal to its CPU run with sign-bit NaN rows at W = 33
             and 64; K6's and K7's
             gradients through their autograd wrappers against plain
             autograd at a layer's shape, float32 and bf16 (bit-equal);
17. train main — paper_sim at published widths and full depth, bf16,
             seeded weights, through launch.train.build: 8 workers,
             trimmed_mean F = 2, Byzantine workers 2 and 5, 64 x 1,024
             tokens a step, 10 steps (K4 10 launches, K6 1,280, all on its
             tensor-core kernel); the loss falls, param_spread is exactly
             0, and the plain path agrees
             (first-step aggregate, losses); then at 2 layers in float32
             (3 steps, against the plain path), hierarchical_trim over 2
             pods x 4 with a worker at ~1e6 (the aggregate within the
             honest gradients), pushsum_sparse through K1, and a 2-layer
             RWKV6-1.6B training step's gradients through K7;
18. train timing — K4 three ways at F = 2 and F = 0, its plain version,
             its bound and torch.mean at the main shape; step times of
             both paths (medians of 5, in turns), peak memory and a
             profile of a kernel-path step.

The build phase prints ptxas' registers and spills of every K4
instantiation (4 to 64 workers), K1's three kernels, every K3 width (8 to
64 slots) and K2's kernel, each K1-K3 kernel at float32, bf16 and fp16
storage, which must not spill, of K6's tensor-core
kernel, K7's three passes and K5's tensor-core kernel, and the count of HGMMA (wgmma) and HMMA (mma.sync) instructions in
the built K6, K7 and K5 libraries (cuobjdump -sass): HGMMA in K6's and
HMMA in K7's and K5's must be nonzero.

It prints the card's name and power limit, one JSON line of kernel
figures, and last the device line. Run from the repository root:

    python3 chip_smoke.py

Where there is no CUDA device, or the port's sources are not beside this
file, it exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import os
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
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
TIMED_RUNS = 30
STEP_RUNS, STEP_T = 10, 50
BYZ_F, BYZ_AGENTS, BYZ_GAMMA = 2, (2, 9), 10
SERVE_B, SERVE_S, SERVE_GEN = 8, 2048, 32
# Byzantine main path: decisions are compared where the decision margin
# (the winner's min_b r(a, b) minus the runner-up's) exceeds this gap
BYZ_MARGIN = 1e-2
# the same under the bf16 policy, where r is stored to 8 mantissa bits: a
# margin of a few bf16 ulps of |r| ~ 1e2..1e3
PREC_BYZ_MARGIN = 16.0


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


def byz_scenario(n_agents: int):
    """benchmarks/byzantine_bench.py's step set-up (N/8 complete 8-agent
    networks, F = 2, Byzantine agents 2 and 9, Γ = 10, large_value lies)
    at confusion 0.25, so about a quarter of the networks fail A4 and the
    fusion's representatives there adopt the pooled value; built with no
    (N, N) array. -> (model, (runtime, extra_reps, n_reps), attack)."""
    from repro_torch.core import (attacks, block_complete_edge_list,
                                  byzantine_runtime_from_edge_list,
                                  make_confused_model)
    sizes = [8] * (n_agents // 8)
    el, _ = block_complete_edge_list(sizes)
    model = make_confused_model(N=n_agents, m=3, truth=0, confusion=0.25,
                                seed=1)
    setup = byzantine_runtime_from_edge_list(model, el, sizes, BYZ_F,
                                             BYZ_AGENTS, BYZ_GAMMA)
    return model, setup, attacks.large_value(1e3)


# a NaN with its sign bit set (0xFFC00000)
NEG_NAN = float(np.uint32(0xFFC00000).view(np.float32))

# the trim-gather's edge cases: (name, P, F, deg_max, layout, lies)
TRIM_EDGE = (("ties", 9, 2, 7, "prefix", "ties"),
             ("under_trimmed", 9, 3, 7, "under", "normal"),
             ("huge", 9, 2, 7, "prefix", "huge"),
             ("ovr", 3, 2, 7, "prefix", "normal"),
             ("single_slot", 9, 0, 1, "prefix", "normal"),
             ("wide", 3, 4, 20, "prefix", "normal"),
             ("deg_max_33", 9, 2, 33, "prefix", "normal"),
             ("deg_max_64", 9, 3, 64, "prefix", "huge"),
             ("scattered_64", 9, 2, 64, "scattered", "normal"),
             ("scattered_33_f0", 9, 0, 33, "scattered", "normal"),
             ("under_trimmed_64", 3, 4, 64, "under", "normal"),
             ("nan", 9, 2, 7, "prefix", "nan"),
             ("nan_sign_33", 9, 2, 33, "scattered", "nan_sign"),
             ("inf", 9, 2, 7, "prefix", "inf"),
             ("non_finite_64", 9, 3, 64, "scattered", "mixed"),
             ("too_many_non_finite", 9, 1, 20, "prefix", "too_many"))


def trim_edge_cases(dev):
    """Small trim-gather problems at the kernel's edge cases, N = 1,001
    receivers (``TRIM_EDGE``): ties, deg <= 2F (also in 64 slots), +-1e6
    lies beside O(1) values (at most F a row, so all are trimmed), P = 3,
    deg_max 1, 20, 33 and 64 (every width of the kernel's network), valid
    slots scattered through the row, F = 0, and NaN, sign-bit NaN and
    +-inf lies: at most F a row, on the first valid slots, or (``too_many``)
    on any slot. Yields ``(name, F, args)``; invalid slots hold NaN
    messages."""
    import torch
    rng = np.random.default_rng(1)
    n = 1001
    for name, P, F, dm, layout, lies in TRIM_EDGE:
        if layout == "scattered":
            valid = rng.random((n, dm)) < 0.6
        else:
            lo, hi = (0, min(2 * F, dm)) if layout == "under" else (1, dm)
            deg = rng.integers(lo, hi + 1, size=n)
            valid = np.arange(dm)[None, :] < deg[:, None]
        idx = np.where(valid, rng.integers(0, n, size=(n, dm)), 0)
        if lies == "ties":
            r = rng.integers(0, 3, size=(n, P))
            msgs = rng.integers(0, 3, size=(n, dm, P))
        else:
            r = rng.normal(size=(n, P))
            msgs = 10 * rng.normal(size=(n, dm, P))
        byz = rng.random((n, dm)) < 0.25
        first_f = valid & (np.cumsum(valid, axis=1) <= F)
        if lies == "huge":
            msgs = np.where(rng.random((n, dm, P)) < 0.5, -1e6, 1e6)
            byz = first_f
        elif lies != "normal" and lies != "ties":
            pick = {"nan": (np.nan,), "nan_sign": (NEG_NAN,),
                    "inf": (np.inf, -np.inf)}.get(
                        lies, (np.nan, NEG_NAN, np.inf, -np.inf))
            odd = rng.random((n, dm, P)) < 0.7
            msgs = np.where(odd, np.array(pick)[rng.integers(
                0, len(pick), size=(n, dm, P))], msgs)
            byz = (rng.random((n, dm)) < 0.5) if lies == "too_many" \
                else first_f
        msgs = msgs.astype(np.float32)
        msgs[~valid] = np.nan
        yield name, F, [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                        for a in (r.astype(np.float32), idx.astype(np.int32),
                                  valid, msgs, byz)]


def slot_values(r, idx, valid, msgs, byz):
    """(N, deg_max, P) values of the slots, the messages where Byzantine."""
    import torch
    return torch.where(byz[:, :, None], msgs, r[idx.long()])


def trim_sorted(r, idx, valid, msgs, byz):
    """Each row's slot values in K3's order, on any device: each value as a
    NaN-canonical ordered key (invalid slots above every key), an exact
    integer sort, the keys decoded -> (sorted values (N, deg_max, P),
    survivors (N, deg_max, 1) -> ranks F .. deg - F - 1 for a given F)."""
    import torch
    vals = slot_values(r, idx, valid, msgs, byz)
    bits = vals.view(torch.int32).long() & 0xFFFFFFFF
    bits = torch.where(vals.isnan(), 0x7FC00000, bits)
    keys = bits ^ torch.where(bits >= 2**31, 0xFFFFFFFF, 0x80000000)
    keys = torch.where(valid[:, :, None], keys, 2**32)
    keys = torch.sort(keys, dim=1).values
    bits = torch.where(keys >= 2**31, keys ^ 0x80000000, keys ^ 0xFFFFFFFF)
    bits = bits & 0xFFFFFFFF
    sorted_vals = torch.where(bits >= 2**31, bits - 2**32, bits).to(
        torch.int32).view(torch.float32)
    deg = valid.sum(dim=1)
    q = torch.arange(idx.shape[1], device=idx.device)[None, :]

    def survivors(F):
        f = F[:, None] if torch.is_tensor(F) else F
        return ((q >= f) & (q < deg[:, None] - f))[:, :, None]

    return sorted_vals, survivors


def rank_order_tsum(r, idx, valid, msgs, byz, F):
    """The trim-gather's survivor sum as K3 forms it: the ranks F .. deg -
    F - 1 of :func:`trim_sorted` added in float32 in rank order, from 0 ->
    (N, P). ``F`` is an int or an (N,) tensor per receiver."""
    import torch
    sorted_vals, survivors = trim_sorted(r, idx, valid, msgs, byz)
    on = survivors(F)
    tsum = torch.zeros_like(r)
    for q in range(idx.shape[1]):
        tsum = torch.where(on[:, q], tsum + sorted_vals[:, q], tsum)
    return tsum


def same_bits(a, b) -> bool:
    """Bit-equal, every NaN taken as one value (the card's arithmetic gives
    its own NaN payload)."""
    import torch
    nan = a.isnan()
    return bool(torch.equal(nan, b.isnan()) and torch.equal(
        a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]))


def trim_sum_bound(r, idx, valid, msgs, byz, F):
    """Per-row bound on two orders of one survivor sum, deg_max * eps32 *
    the sum of the survivors' |values| (ranks F .. deg - F - 1 of the
    sorted row; a trimmed finite slot adds exactly 0 to the plain
    version's ``s * keep``) -> (bound (N, P), rows whose valid values are
    all finite (N,))."""
    import torch
    vals = slot_values(r, idx, valid, msgs, byz)
    on = valid[:, :, None].expand_as(vals)
    fin = torch.where(on, torch.isfinite(vals), True).all(dim=2).all(dim=1)
    sorted_vals, survivors = trim_sorted(r, idx, valid, msgs, byz)
    mag = torch.where(survivors(F) & torch.isfinite(sorted_vals),
                      sorted_vals.abs(), 0.0).sum(dim=1)
    return idx.shape[1] * EPS32 * mag, fin


def event_ms(fn, runs: int, flush=None, hide_host: bool = False) -> float:
    """Median device milliseconds of ``fn()``, each run bracketed by its
    own CUDA events; ``flush()`` runs before each, outside the events.
    With ``hide_host`` the device first sleeps ~1 ms, so the host has
    queued the start event, ``fn``'s launches and the end event before the
    start event runs: the events then time the device's work alone, not
    the host's enqueueing (which exceeds a kernel of tens of µs)."""
    import torch
    times = []
    for _ in range(runs):
        if flush is not None:
            flush()
        if hide_host:
            torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(bytes_moved: int, flops: int,
          peak: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def ptxas_report(log: str, kernel: str) -> str:
    """ptxas' register and spill lines for the entry whose mangled name
    holds ``kernel`` (nvcc -Xptxas -v output)."""
    out, on = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            on = kernel in ln
        elif on and ("registers" in ln or "spill" in ln):
            out.append(ln.replace("ptxas info    :", "").strip())
    return " | ".join(out) or "not found"


def sass_count(lib: Path, opcodes) -> dict[str, int]:
    """How many instructions of each opcode the compiled library holds
    (cuobjdump -sass from the CUDA toolkit)."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    words = [w.split(".")[0] for w in sass.split()]
    return {op: words.count(op) for op in opcodes}


def three_ways(fn, runs: int, flush) -> dict:
    """A kernel call's device milliseconds three ways, the L2 flushed
    before each run: with the host's enqueueing hidden (``ms``, the figure
    the kernels line carries), the call's kernels alone under the profiler
    (``kernel_ms``, the mean a launch summed over the call's kernels; None
    where the profiler records no device time) and with the events around
    the host's call (``host_inclusive_ms``)."""
    kt = kernel_times(fn, 10, flush)
    return {"ms": event_ms(fn, runs, flush, hide_host=True),
            "kernel_ms": sum(t for t, _ in kt.values()) if kt else None,
            "host_inclusive_ms": event_ms(fn, runs, flush)}


def engine_args(dev, model, rt_d, brt_d) -> dict:
    """K1-K3's inputs at the engines' main shapes, from seed 0: K1 the
    consensus state of N agents (D = 4) over the dst-sorted index with 0.9
    of the links live (``k1``: the CUDA wrapper's arguments; ``dst`` for
    the plain version); K2 beliefs, masses (64 of them 0) and uniforms
    (some at or above the CDF's top); K3 the Byzantine path's r, neighbor
    slots and large_value lies, a stride-0 view (``k3``) and materialized
    (``k3_dense``)."""
    import torch
    rng = np.random.default_rng(0)
    N, E, D = rt_d.offsets.shape[0] - 1, rt_d.src.shape[0], 4
    sigma = torch.tensor(rng.normal(size=(N, D)), dtype=torch.float32,
                         device=dev)
    rho = torch.tensor(rng.normal(size=(E, D)), dtype=torch.float32,
                       device=dev)
    live = torch.tensor(rng.random(E) < 0.9, device=dev) & rt_d.valid
    tables_d = model.tables.to(dev)
    log_tables = torch.log(tables_d)
    cdf = torch.cumsum(tables_d[:, model.truth, :], dim=-1)
    z = torch.tensor(rng.normal(size=(N, model.m)) * 10, dtype=torch.float32,
                     device=dev)
    mass = torch.tensor(rng.random(N), dtype=torch.float32, device=dev)
    mass[:64] = 0.0                       # vanishing mass stays finite
    u = torch.tensor(rng.random(N), dtype=torch.float32, device=dev)
    u[64:128] = cdf[64:128, -1]           # at / above the last CDF value
    u[128:192] = 0.99999994
    dm, P = brt_d.nbr_idx.shape[1], model.m ** 2
    r_b = torch.tensor(rng.normal(size=(N, P)) * 30, dtype=torch.float32,
                       device=dev)
    lies = torch.full((), 1e3, device=dev).expand(N, dm, P)
    k3 = (r_b, brt_d.nbr_idx, brt_d.nbr_valid, lies, brt_d.byz_nbr, BYZ_F)
    return {"k1": (sigma, rho, live, rt_d.src, rt_d.offsets),
            "dst": rt_d.dst, "k2": (z, mass, u, cdf, log_tables),
            "k3": k3, "k3_dense": k3[:3] + (lies.contiguous(),) + k3[4:]}


def edge_order_recv(rho_new, rho, offsets):
    """Each receiver's increments rho_new - rho added in float32 in edge
    order, starting from 0: the sum K1 gives, bit for bit, on both of its
    kernels (vectorized over the receivers, one in-edge position at a
    time)."""
    import torch
    start = offsets[:-1].long()
    deg = offsets[1:].long() - start
    delta = rho_new - rho
    recv = torch.zeros((deg.shape[0], rho.shape[1]), dtype=rho.dtype,
                       device=rho.device)
    for k in range(int(deg.max()) if deg.numel() else 0):
        has = k < deg
        row = delta[torch.where(has, start + k, 0)]
        recv = torch.where(has[:, None], recv + row, recv)
    return recv


def k1_edge_cases(dev):
    """Small edge-scatter problems at K1's edge cases, N = 1,001 receivers,
    at D = 4 (the edge-tiled kernel's vector path), 3 (its scalar path) and
    40 (the column walk): in-degrees 0..9 (empty receivers, a ragged last
    block), most receivers hearing nobody, no live edge, inert padding
    edges at the end, a hub receiver of in-degree 1,500 (three tiles of the
    tiled kernel at D = 4, which holds 512 edges a tile) and rows that
    start off the 16-byte vector alignment. Yields ``(name, D, args,
    dst)``: the CUDA wrapper's arguments and the plain version's dst."""
    import torch
    rng = np.random.default_rng(2)
    n = 1001
    for D in (4, 3, 40):
        for name in ("ragged", "no_in_edges", "none_live", "padding", "hub",
                     "unaligned"):
            if name == "no_in_edges":
                deg = np.where(rng.random(n) < 0.7, 0,
                               rng.integers(1, 5, size=n))
            else:
                deg = rng.integers(0, 10, size=n)
            if name == "hub":
                deg[n // 2] = 1500
            dst = np.repeat(np.arange(n), deg)
            src = rng.integers(0, n, size=dst.shape[0])
            live = rng.random(dst.shape[0]) < (0.0 if name == "none_live"
                                               else 0.6)
            if name == "padding":       # inert tail edges: dst = N-1, dead
                dst = np.concatenate([dst, np.full(37, n - 1)])
                src = np.concatenate([src, np.zeros(37, np.int64)])
                live = np.concatenate([live, np.zeros(37, bool)])
            E = dst.shape[0]
            sigma = torch.tensor(rng.normal(size=(n, D)),
                                 dtype=torch.float32, device=dev)
            rho = torch.tensor(rng.normal(size=(E, D)), dtype=torch.float32,
                               device=dev)
            if name == "unaligned":     # contiguous rows one float in
                sigma = torch.cat([sigma.new_zeros(1), sigma.view(-1)])[1:]
                sigma = sigma.view(n, D)
                rho = torch.cat([rho.new_zeros(1), rho.view(-1)])[1:]
                rho = rho.view(E, D)
            offsets = np.searchsorted(dst, np.arange(n + 1), side="left")
            as_dev = [torch.tensor(a, device=dev) for a in (
                live, src.astype(np.int32), offsets.astype(np.int32),
                dst.astype(np.int32))]
            yield name, D, (sigma, rho, *as_dev[:3]), as_dev[3]


def k1_hold(what, k1, dst, tiled, by_order=False) -> float:
    """One K1 call on the card held against the plain version: the kernel
    the wrapper picks (``tiled=None``) or the one asked for; rho_new
    bit-equal, recv bit-equal to :func:`edge_order_recv` and within rtol
    1e-5 atol 1e-6 of the plain version's ``index_add_`` (with
    ``by_order``, within the bound for two orders of one sum, (n - 1)
    eps32 sum |increments|) -> the largest error against the plain
    version."""
    import torch
    from repro_torch.kernels.pushsum_edge import (edge_scatter_cuda,
                                                  edge_scatter_ref)
    from repro_torch.kernels.pushsum_edge.ops import TILED_D_MAX
    before = edge_scatter_cuda.launches_tiled
    rho_k, recv_k = edge_scatter_cuda(*k1, tiled=tiled)
    rho_p, recv_p = edge_scatter_ref(*k1[:4], dst,
                                     n_recv=k1[4].numel() - 1)
    want = edge_order_recv(rho_p, k1[1], k1[4])
    torch.cuda.synchronize()
    on_tiled = k1[0].shape[1] <= TILED_D_MAX if tiled is None else tiled
    require(edge_scatter_cuda.launches_tiled - before == int(on_tiled),
            f"edge_scatter {what}: the kernel the wrapper picks")
    require(torch.equal(rho_k, rho_p), f"edge_scatter {what}: rho_new "
            f"bit-equal")
    require(torch.equal(recv_k, want), f"edge_scatter {what}: recv "
            f"bit-equal to the float32 edge-order sum")
    tol = 1e-5 * recv_p.abs() + 1e-6
    if by_order:
        deg = (k1[4][1:] - k1[4][:-1]).float()[:, None]
        tol = torch.maximum(tol, (deg - 1).clamp_min(0) * EPS32
                            * torch.zeros_like(recv_p).index_add_(
                                0, dst, (rho_p - k1[1]).abs()))
    require(bool(((recv_k - recv_p).abs() <= tol).all()),
            f"edge_scatter {what}: recv against the plain version")
    return (recv_k - recv_p).abs().max().item()


def edge_scatter_checks(dev, args) -> float:
    """Phase 2's K1 checks (:func:`k1_hold`). At the engine's shape, on the
    edge-tiled kernel and on the column walk; then at
    :func:`k1_edge_cases` on the kernel the wrapper picks and on the
    column walk, where the hub's run of 1,500 increments is held to the
    plain version within the order bound (2.0e-5 relative measured against
    ``index_add_``) -> the largest error against the plain version at the
    main shape."""
    err = max(k1_hold(f"main shape tiled={t}", args["k1"], args["dst"], t)
              for t in (True, False))
    n_cases = 0
    for name, D, k1, dst in k1_edge_cases(dev):
        for tiled in (None, False):
            k1_hold(f"{name} D={D} tiled={tiled}", k1, dst, tiled,
                    by_order=name == "hub")
            n_cases += 1
    log(f"[kernels] edge_scatter: rho_new bit-equal, recv bit-equal to the "
        f"float32 edge-order sum on the edge-tiled kernel and the column "
        f"walk, at the main shape and {n_cases} edge cases (D 4/3/40; "
        f"empty receivers, padding, no live edge, a hub of in-degree 1,500, "
        f"unaligned rows); against the plain version's index_add_ within "
        f"rtol 1e-5 atol 1e-6 (its order; the hub within the order bound)"
        f"; max_abs_err {err:.3e}")
    return err


def innov_edge_cases(dev):
    """Small innovation problems at K2's edge cases: N = 1,001 (a ragged
    last block), every range one float off the 16-byte alignment (ragged
    ends in every block), the alphabets (5, 7) and (2, 3), rows of (16, 32)
    (16 agents a block) and of (128, 128) (one agent a block, past 48 KB of
    shared memory). Yields ``(name, args)``; the uniforms reach the CDF's
    top."""
    import torch
    rng = np.random.default_rng(4)
    for name, n, m, S, shift in (("ragged_tail", 1001, 3, 4, 0),
                                 ("unaligned", 1001, 3, 4, 1),
                                 ("m5_s7", 777, 5, 7, 0),
                                 ("m2_s3", 4097, 2, 3, 1),
                                 ("m16_s32", 300, 16, 32, 0),
                                 ("m128_s128", 40, 128, 128, 1)):
        probs = rng.dirichlet(np.ones(S), size=n)
        cdf = np.cumsum(probs, axis=-1)
        u = rng.random(n)
        u[: n // 8] = cdf[: n // 8, -1]
        arrays = (rng.normal(size=(n, m)) * 10, rng.random(n), u, cdf,
                  np.log(np.maximum(rng.dirichlet(np.ones(S), size=(n, m)),
                                    2e-2)))
        out = []
        for a in arrays:
            flat = torch.tensor(np.concatenate([np.zeros(shift),
                                                a.reshape(-1)]),
                                dtype=torch.float32, device=dev)
            out.append(flat[shift:].view(a.shape))
        out[1][:5] = 0.0                  # vanishing mass
        yield name, out


def innovation_checks(dev, k2) -> float:
    """Phase 2's K2 checks, at the main shape and at
    :func:`innov_edge_cases`: the sampled letters (read through z_new on a
    table holding each letter's index, so z_new = sig exactly) and z_new
    bit-equal to the plain version, mu within rtol 1e-5 atol 1e-6 (the
    softmax's order) and finite -> the largest error against the plain
    version at the main shape."""
    import torch
    from repro_torch.kernels.social_innov import (innovation_cuda,
                                                  innovation_ref,
                                                  sample_signals,
                                                  staged_agents)

    def hold(what, args):
        z, mass, u, cdf, lt = args
        n, m = z.shape
        S = cdf.shape[1]
        tag = f"social_innov {what} ({staged_agents(m, S)} agents a block)"
        letters = torch.arange(S, dtype=torch.float32, device=dev).expand(
            n, m, S).contiguous()
        sig_p = sample_signals(u, cdf)
        zp, mu_p = innovation_ref(*args)
        before = innovation_cuda.launches
        sig_k, _ = innovation_cuda(torch.zeros_like(z), mass, u, cdf,
                                   letters)
        zk, mu_k = innovation_cuda(*args)
        torch.cuda.synchronize()
        require(innovation_cuda.launches == before + 2, f"{tag}: launched")
        require(torch.equal(sig_k[:, 0].long(), sig_p),
                f"{tag}: signals bit-equal")
        require(torch.equal(zk, zp), f"{tag}: z_new bit-equal")
        torch.testing.assert_close(mu_k, mu_p, rtol=1e-5, atol=1e-6)
        require(bool(torch.isfinite(mu_k).all()), f"{tag}: finite")
        return (mu_k - mu_p).abs().max().item()

    err = hold("main shape", k2)
    names = []
    for name, case_args in innov_edge_cases(dev):
        hold(name, case_args)
        names.append(name)
    log(f"[kernels] social_innov: signals and z_new bit-equal, mu within "
        f"rtol 1e-5 atol 1e-6 (softmax order), at the main shape and "
        f"{len(names)} edge cases ({', '.join(names)}); max_abs_err "
        f"{err:.3e}")
    return err


def trim_gather_checks(dev, args) -> float:
    """Phase 2's K3 checks, at the Byzantine main path's shape and
    messages (a large_value attack is a stride-0 view of one float, read in
    place; also materialized) and at :func:`trim_edge_cases`: ``kept``
    bit-equal to the plain version; ``tsum`` bit-equal to
    :func:`rank_order_tsum` (the float32 rank-order sum of the sorted
    survivors) everywhere, within :func:`trim_sum_bound` of the plain
    version on rows whose values are finite (the plain version sums
    ``s * keep``, so a trimmed NaN or inf makes its row NaN), and exactly 0
    where nothing survives; deg_max 65 raises. Then the plain version on
    the card against its run on the CPU at deg_max 33 and 64 with sign-bit
    NaN lies -> the largest error against the plain version at the main
    shape."""
    import torch
    from repro_torch.kernels.byz_trim import (DEG_MAX_CAP, trim_gather_cuda,
                                              trim_gather_ref)

    def hold(what, a, F):
        tk, kk = trim_gather_cuda(*a, F)
        tp, kp = trim_gather_ref(*a, F)
        want = rank_order_tsum(*a, F)
        bnd, fin = trim_sum_bound(*a, F)
        torch.cuda.synchronize()
        require(torch.equal(kk, kp), f"trim_gather {what}: kept bit-equal")
        require(same_bits(tk, want), f"trim_gather {what}: tsum bit-equal "
                f"to the float32 rank-order sum")
        err = (tk - tp).abs()[fin]
        require(bool((err <= bnd[fin]).all()), f"trim_gather {what}: tsum "
                f"within the order bound of the plain version on finite "
                f"rows")
        require(bool((tk[kp == 0] == 0).all()),
                f"trim_gather {what}: no survivor sums to 0")
        return err.max().item() if err.numel() else 0.0

    k3, k3_dense = args["k3"], args["k3_dense"]
    err = hold("main shape", k3[:5], k3[5])
    require(all(torch.equal(x, y) for x, y in zip(
        trim_gather_cuda(*k3), trim_gather_cuda(*k3_dense))),
        "trim_gather: stride-0 and materialized messages give the same "
        "result")
    names, worst = [], 0.0
    for name, F_case, case_args in trim_edge_cases(dev):
        worst = max(worst, hold(name, case_args, F_case))
        names.append(name)
    wide = [a[:, :1].expand(-1, DEG_MAX_CAP + 1, *a.shape[2:]).contiguous()
            for a in k3[1:5]]
    try:
        trim_gather_cuda(k3[0], *wide, 1)
    except ValueError:
        pass
    else:
        raise RuntimeError(f"check failed: trim_gather deg_max="
                           f"{DEG_MAX_CAP + 1} must raise")
    # the plain version on the card orders every NaN as the CPU does:
    # integer values, so any order of the survivors' sum is exact
    n_nan = 0
    for dm in (33, 64):
        g = np.random.default_rng(dm)
        n, P, F = 257, 9, 3
        valid = g.random((n, dm)) < 0.8
        byz = valid & (np.cumsum(valid, axis=1) <= F)
        msgs = np.where(g.random((n, dm, P)) < 0.5, NEG_NAN,
                        g.integers(-1024, 1025, size=(n, dm, P)))
        a = [torch.tensor(x, device=dev) for x in (
            g.integers(-1024, 1025, size=(n, P)).astype(np.float32),
            np.where(valid, g.integers(0, n, size=(n, dm)), 0).astype(
                np.int32), valid, msgs.astype(np.float32), byz)]
        on_card = trim_gather_ref(*a, F)
        on_cpu = trim_gather_ref(*(x.cpu() for x in a), F)
        require(all(same_bits(x.cpu(), y) for x, y in zip(on_card, on_cpu)),
                f"trim_gather_ref deg_max={dm}: the card's result bit-equal "
                f"to the CPU's with sign-bit NaN lies")
        n_nan += int(on_cpu[0].isnan().any(dim=1).sum())
    log(f"[kernels] byz_trim: kept bit-equal, tsum bit-equal to the float32 "
        f"rank-order sum and within the order bound of the plain version "
        f"(finite rows) at the main shape (stride-0 and materialized lies) "
        f"and {len(names)} edge cases ({', '.join(names)}); deg_max "
        f"{DEG_MAX_CAP + 1} raises; max_abs_err {err:.3e} at the main shape, "
        f"{worst:.3e} over the edge cases; the plain version on the card "
        f"bit-equal to the CPU's at deg_max 33 and 64 with sign-bit NaN "
        f"lies ({n_nan} rows NaN on both: s * keep of a trimmed NaN)")
    return err


def engine_kernel_times(args, flush) -> dict:
    """Phase 7's kernel timings at the engines' main shapes: K1 (the kernel
    the wrapper picks, and the column walk where the wrapper offers the
    choice), K2 and K3 (with the main path's stride-0 lies, and
    materialized), each :func:`three_ways`; their plain versions
    host-inclusive; their bounds -> each kernel's JSON timings."""
    import torch
    from repro_torch.kernels.byz_trim import trim_gather_cuda, trim_gather_ref
    from repro_torch.kernels.pushsum_edge import (edge_scatter_cuda,
                                                  edge_scatter_ref)
    from repro_torch.kernels.social_innov import (innovation_cuda,
                                                  innovation_ref)
    k1, k2, k3, k3_dense = (args[k] for k in ("k1", "k2", "k3", "k3_dense"))
    sigma, rho = k1[:2]
    N, D, E = sigma.shape[0], sigma.shape[1], rho.shape[0]
    m_hyp, S = k2[4].shape[1:]
    dm, P = k3[3].shape[1:]
    outs = {"edge_scatter": edge_scatter_cuda(*k1),
            "social_innov": innovation_cuda(*k2),
            "byz_trim": trim_gather_cuda(*k3)}
    torch.cuda.synchronize()
    # bytes: every input read once and every output written once (the
    # stride-0 lies are one float); operations: K1 two a row element, K2 a
    # CDF search and m softmax terms an agent, K3 a compare in each of the
    # 2F extraction rounds and one add per (receiver, coordinate, slot)
    k3_ops = N * P * dm * (2 * BYZ_F + 1)
    bounds = {
        "edge_scatter": bound(nbytes(*k1, *outs["edge_scatter"]), 2 * E * D),
        "social_innov": bound(nbytes(*k2, *outs["social_innov"]),
                              N * (S + m_hyp * 8)),
        "byz_trim": bound(nbytes(*k3[:3], k3[4], *outs["byz_trim"]) + 4,
                          k3_ops)}
    calls = {"edge_scatter": (lambda: edge_scatter_cuda(*k1),
                              lambda: edge_scatter_ref(*k1[:4], args["dst"])),
             "social_innov": (lambda: innovation_cuda(*k2),
                              lambda: innovation_ref(*k2)),
             "byz_trim": (lambda: trim_gather_cuda(*k3),
                          lambda: trim_gather_ref(*k3))}
    out = {}
    for name, (fn, plain) in calls.items():
        out[name] = {**three_ways(fn, TIMED_RUNS, flush),
                     "plain_ms": event_ms(plain, TIMED_RUNS, flush),
                     "bound_ms": bounds[name][0],
                     "bound_by": bounds[name][1], "library_ms": None}
    k3d = three_ways(lambda: trim_gather_cuda(*k3_dense), TIMED_RUNS, flush)
    k3d_bound = bound(nbytes(*k3_dense[:5], *outs["byz_trim"]), k3_ops)[0]
    out["byz_trim"]["materialized_ms"] = k3d["ms"]
    walk = three_ways(lambda: edge_scatter_cuda(*k1, tiled=False),
                      TIMED_RUNS, flush)
    out["edge_scatter"].update({f"walk_{k}": v for k, v in walk.items()})
    for name, t in out.items():
        log(f"[timing] {name}: device {t['ms']:.5f} ms with the host hidden, "
            f"kernel alone {t['kernel_ms']} (profiler), host-inclusive "
            f"{t['host_inclusive_ms']:.5f}; plain {t['plain_ms']:.5f} "
            f"(host-inclusive); bound {t['bound_ms']:.5f} ({t['bound_by']})"
            f"; medians of {TIMED_RUNS}, L2 flushed")
    t = out["edge_scatter"]
    log(f"[timing] edge_scatter's column walk (the old design) at the same "
        f"shape: device {t['walk_ms']:.5f} ms with the host hidden, kernel "
        f"alone {t['walk_kernel_ms']}, host-inclusive "
        f"{t['walk_host_inclusive_ms']:.5f}")
    log(f"[timing] byz_trim with materialized lies: device {k3d['ms']:.5f} "
        f"ms with the host hidden, kernel alone {k3d['kernel_ms']}, "
        f"host-inclusive {k3d['host_inclusive_ms']:.5f} (bound "
        f"{k3d_bound:.5f})")
    return out


def k3_width_times(dev, flush, widths=(16, 32, 64)) -> dict:
    """K3 at wider networks (the main path's 7 slots take the 8-slot one):
    N = 131,072 receivers, P = 9, F = 2, every slot of ``widths`` valid
    (deg_max = the width) with neighbors drawn at random, two Byzantine
    slots a row with stride-0 lies -> ``{deg_max: {"ms", "bound_ms"}}``,
    device milliseconds with the host hidden (L2 flushed)."""
    import torch
    from repro_torch.kernels.byz_trim import trim_gather_cuda
    g = torch.Generator(device=dev).manual_seed(6)
    n, P, out = N_FULL, 9, {}
    for dm in widths:
        r = torch.randn((n, P), generator=g, device=dev)
        idx = torch.randint(0, n, (n, dm), generator=g, device=dev,
                            dtype=torch.int32)
        valid = torch.ones((n, dm), dtype=torch.bool, device=dev)
        byz = torch.zeros_like(valid)
        byz[:, :2] = True
        lies = torch.full((), 1e3, device=dev).expand(n, dm, P)
        a = (r, idx, valid, lies, byz, BYZ_F)
        outs = trim_gather_cuda(*a)
        t = {"ms": event_ms(lambda: trim_gather_cuda(*a), TIMED_RUNS, flush,
                            hide_host=True),
             "bound_ms": bound(nbytes(r, idx, valid, byz, *outs) + 4,
                               n * P * dm * (2 * BYZ_F + 1))[0]}
        out[dm] = t
        log(f"[timing] byz_trim at deg_max {dm} (every slot valid, random "
            f"neighbors, N={n}, P={P}, F={BYZ_F}): device {t['ms']:.5f} ms "
            f"with the host hidden; bound {t['bound_ms']:.5f} (bytes)")
    return out


def k1_sparse_times(dev, flush) -> dict:
    """K1 at phase 17d's ``pushsum_sparse`` shape: the aggregator's worker
    digraph (8 workers, ``AggregatorConfig``'s graph), one full pass of
    2^24 columns plus the mass column, 0.9 of the links live;
    :func:`three_ways` beside its bound."""
    import torch
    from repro_torch.core.graphs import (edge_list, random_strongly_connected,
                                         sort_by_dst)
    from repro_torch.distributed.aggregation import (GOSSIP_COLS,
                                                     AggregatorConfig)
    from repro_torch.kernels.pushsum_edge import edge_scatter_cuda
    cfg = AggregatorConfig(kind="pushsum_sparse")
    adj = random_strongly_connected(TRAIN_W, cfg.graph_extra_edge_prob,
                                    np.random.default_rng(cfg.graph_seed))
    el, _, _, offsets = sort_by_dst(edge_list(adj), return_offsets=True)
    E, D = el.src.shape[0], GOSSIP_COLS + 1
    g = torch.Generator(device=dev).manual_seed(3)
    sigma = torch.randn((TRAIN_W, D), generator=g, device=dev)
    rho = torch.randn((E, D), generator=g, device=dev)
    live = (torch.rand(E, generator=g, device=dev) < 0.9) \
        & torch.from_numpy(el.valid).to(dev)
    k1 = (sigma, rho, live, torch.from_numpy(el.src).to(dev),
          torch.from_numpy(offsets).to(dev))
    outs = edge_scatter_cuda(*k1)
    t = three_ways(lambda: edge_scatter_cuda(*k1), 10, flush)
    t["bound_ms"], t["bound_by"] = bound(nbytes(*k1, *outs), 2 * E * D)
    log(f"[timing] edge_scatter at pushsum_sparse's shape (N={TRAIN_W}, "
        f"E={E}, D={D}, the column walk): device {t['ms']:.4f} ms with the "
        f"host hidden, kernel alone {t['kernel_ms']}, host-inclusive "
        f"{t['host_inclusive_ms']:.4f}; bound {t['bound_ms']:.4f} "
        f"({t['bound_by']}); medians of 10, L2 flushed")
    del k1, outs, sigma, rho
    torch.cuda.empty_cache()
    return t


# ---------------------------------------------------------------------------
# Algorithm 1: the push-sum consensus engine and the hierarchical push-sum
# (HPS) engine, the consensus half of every round through K1 at D = 5
# ---------------------------------------------------------------------------

A1_D = 4                       # values an agent carries in both engines
# kernel against plain path (phases 6b-6d). The two paths add each
# receiver's increments in other orders (the kernel in edge order,
# index_add_ with atomics), about one ulp of the sum a round; that can flip
# the rounding of a cumulative relay counter, a displacement of one counter
# ulp that stays in the system and moves the receiver's ratio z / m by that
# ulp over its mass ("a round" below, at the median mass). The flips have
# random signs and the gossip averages them, so T rounds move a ratio by
# about sqrt(T) of that; a fault of K1 (a lost or doubled increment) moves
# it by O(1). Limit: 1e-2 absolute on the ratios and the gap curves. On
# the random graph a few agents hear one sender of many out-links and hold
# masses down to ~1e-6, where one counter ulp over the mass exceeds the
# limit with no fault: their ratios are held where m >= A1_MASS_FLOOR, and
# every agent's (z, m) to the same 1e-2.
A1_LIMIT = 1e-2
A1_MASS_FLOOR = 1e-3


def hps_scenario(n_agents: int):
    """benchmarks/hps_bench.py's step set-up (:65-74): N/8 complete 8-agent
    networks built with no (N, N) array, drop 0.1, fusion every 8 rounds,
    B = 4, w from default_rng(1) -> (HPSRuntime, w (N, 4) float32)."""
    from repro_torch.core import hier_edge_list, hps_runtime_from_edge_list
    el, rep_mask = hier_edge_list([8] * (n_agents // 8), topology="complete")
    rt = hps_runtime_from_edge_list(el, rep_mask, drop_prob=0.1,
                                    gamma_period=8, B=4)
    w = np.random.default_rng(1).normal(size=(n_agents, A1_D))
    return rt, w.astype(np.float32)


def pushsum_scenario(n_agents: int):
    """benchmarks/pushsum_sweep.py's graph (:128-134): a Hamiltonian cycle
    plus 2N random extra edges, dst-sorted, and w drawn after it from the
    same default_rng(0) -> (EdgeList, w (N, 4) float32)."""
    from repro_torch.core import random_strongly_connected_edge_list
    rng = np.random.default_rng(0)
    el = random_strongly_connected_edge_list(n_agents, 2.0, rng)
    return el, rng.normal(size=(n_agents, A1_D)).astype(np.float32)


def hold_a1(what: str, pairs: dict, state, T: int,
            floor: float = A1_MASS_FLOOR) -> None:
    """Kernel-path tensors against plain-path ones within ``A1_LIMIT``:
    ``pairs`` maps a name to (kernel, plain) or (kernel, plain, rows held:
    those with m >= ``floor``); ``state`` is the kernel run's final
    state."""
    counter = max(state.sigma_zm.abs().max().item(),
                  state.rho_zm.abs().max().item())
    fig = (float(np.spacing(np.float32(counter)))
           / state.m.median().item())
    msg = []
    for name, (a, b, *rows) in pairs.items():
        diff = (a - b).abs().reshape(a.shape[0], -1).amax(dim=1)
        held = diff if not rows else diff[rows[0]]
        gap = held.max().item()
        msg.append(f"{name} {gap:.3e}" + (
            f" (m >= {floor}: {held.numel()} of {diff.numel()}; "
            f"all {diff.max().item():.3e})" if rows else ""))
        require(gap <= A1_LIMIT, f"{what}: {name} within {A1_LIMIT} of the "
                f"plain path")
    log(f"[{what}] kernel vs plain, max gap: " + ", ".join(msg)
        + f"; largest relay counter {counter:.1f}, a round {fig:.3e}, "
        f"sqrt(T) of it {fig * T ** 0.5:.3e}; limit {A1_LIMIT}")


def k1_d5_args(dev, src, offsets, dst, seed: int):
    """K1's inputs at D = 5 over an engine's dst-sorted index: sigma and
    rho normal, 0.9 of the links live -> (the CUDA wrapper's arguments,
    dst for the plain version)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    N, E = offsets.shape[0] - 1, src.shape[0]
    sigma = torch.randn((N, A1_D + 1), generator=g, device=dev)
    rho = torch.randn((E, A1_D + 1), generator=g, device=dev)
    live = torch.rand(E, generator=g, device=dev) < 0.9
    return (sigma, rho, live, src, offsets), dst


def algorithm1_phases(dev) -> dict:
    """Phases 6a-6d -> K1's D = 5 inputs at both full shapes (``k1``: name
    -> (args, dst)), its largest error there, and its launches on the HPS
    and push-sum main paths."""
    import torch
    from repro_torch.core import (ExecutionPlan, run_hps_runtime,
                                  run_pushsum_sparse, sparse_mass_invariant)
    from repro_torch.kernels.pushsum_edge import dst_offsets
    out = {"k1": {}}
    N, T = N_FULL, T_MAIN

    # ---- phase 6a: K1 at D = 5 against its plain version -----------------
    hrt, hw = hps_scenario(N)
    hrt = hrt.to(dev)
    el, pw = pushsum_scenario(N)
    src, dst = (torch.from_numpy(a).to(dev) for a in (el.src, el.dst))
    offsets = dst_offsets(dst, N)
    out["k1"]["hps"] = k1_d5_args(dev, hrt.src, hrt.offsets, hrt.dst, 7)
    out["k1"]["pushsum"] = k1_d5_args(dev, src, offsets, dst, 8)
    indeg = np.bincount(el.dst, minlength=N)
    out["k1_err"] = max(k1_hold(f"D=5 {name} shape", k1, d, None)
                        for name, (k1, d) in out["k1"].items())
    log(f"[a1 kernels] edge_scatter at D=5 (its scalar-row tiled kernel): "
        f"rho_new bit-equal, recv bit-equal to the float32 edge-order sum "
        f"at the HPS shape (N={N}, E={hrt.src.shape[0]}, in-degree 7) and "
        f"the push-sum shape (E={el.E}, in-degree 1..{indeg.max()}, mean "
        f"{indeg.mean():.2f}); max_abs_err against index_add_ "
        f"{out['k1_err']:.3e}")

    # ---- phase 6b: the HPS main path at full size ------------------------
    plan_k = ExecutionPlan(store="gap", dst_sorted=True)
    hw_d = torch.from_numpy(hw).to(dev)
    _zero_counts()
    t0 = time.perf_counter()
    res_k = run_hps_runtime(hw_d, hrt, T, seed=0, plan=plan_k)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    log(f"[hps main] N={N} E={hrt.src.shape[0]} M={hrt.M.item()} T={T}, "
        f"Γ 8, B 4, drop 0.1, store gap: kernels {wall:.2f} s, launches "
        f"{counts}")
    require(counts == _only(edge_scatter=T, edge_scatter_tiled=T),
            "HPS main: K1 launched T times, all on its edge-tiled kernel")
    out["hps_launches"] = counts["edge_scatter"]
    res_p = run_hps_runtime(hw_d, hrt, T, seed=0,
                            plan=plan_k.replace(backend="torch"))
    torch.cuda.synchronize()
    require(_counts() == counts, "HPS main: the plain path launched no "
            "kernel")
    require(res_k.ratio.shape == (N, A1_D) and res_k.gap.shape == (T,),
            "HPS main: result shapes")
    require(bool(torch.isfinite(res_k.ratio).all())
            and bool(torch.isfinite(res_k.gap).all()), "HPS main: finite")
    inv = sparse_mass_invariant(res_k.final_state, hrt.src, hrt.valid)
    require(abs(inv[-1].item() - N) <= 1e-4 * N, "HPS main: mass conserved")
    hold_a1("hps main", {"ratio": (res_k.ratio, res_p.ratio),
                         "gap curve": (res_k.gap, res_p.gap)},
            res_k.final_state, T)
    g = res_k.gap
    log(f"[hps main] gap after rounds 1/50/100/200: {g[0].item():.4f} "
        f"{g[49].item():.4f} {g[99].item():.4f} {g[-1].item():.4f}; "
        f"total mass {inv[-1].item():.3f}; value invariant off sum(w) by "
        f"{(inv[:-1] - hw_d.sum(0)).abs().max().item():.3e}")
    # 16,384 networks meet only through one representative each, which
    # hands half of its 1/8 share to the pool every Γ rounds: the networks'
    # means converge slowly, so the gap falls by about a quarter in T
    require(g[-1].item() < g[99].item() < g[49].item() < g[0].item(),
            "HPS main: the gap falls")

    # ---- phase 6c: the push-sum main path at full size -------------------
    plan_k = ExecutionPlan(dst_sorted=True)
    pw_d = torch.from_numpy(pw).to(dev)
    ps_args = dict(drop_prob=0.2, B=4, record_every=T)
    _zero_counts()
    t0 = time.perf_counter()
    fin_k, traj_k = run_pushsum_sparse(pw_d, src, dst, T, plan=plan_k,
                                       **ps_args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    log(f"[pushsum main] N={N} E={el.E} largest in-degree {indeg.max()} "
        f"T={T}, drop 0.2, B 4, record_every T: kernels {wall:.2f} s, "
        f"launches {counts}")
    require(counts == _only(edge_scatter=T, edge_scatter_tiled=T),
            "push-sum main: K1 launched T times, all on its edge-tiled "
            "kernel")
    out["pushsum_launches"] = counts["edge_scatter"]
    fin_p, traj_p = run_pushsum_sparse(pw_d, src, dst, T,
                                       plan=plan_k.replace(backend="torch"),
                                       **ps_args)
    torch.cuda.synchronize()
    require(_counts() == counts, "push-sum main: the plain path launched "
            "no kernel")
    require(traj_k.shape == (1, N, A1_D)
            and bool(torch.isfinite(traj_k).all()), "push-sum main: one "
            "finite frame")
    inv = sparse_mass_invariant(fin_k, src, torch.ones_like(src,
                                                            dtype=torch.bool))
    w_sum = pw_d.sum(0)
    value_tol = 1e-4 * pw_d.abs().sum(0)
    require(bool(((inv[:-1] - w_sum).abs() <= value_tol).all()),
            "push-sum main: the value invariant holds against sum(w)")
    require(abs(inv[-1].item() - N) <= 1e-4 * N, "push-sum main: mass "
            "conserved")
    hold_a1("pushsum main", {
        "final frame": (traj_k[-1], traj_p[-1], fin_k.m >= A1_MASS_FLOOR),
        "final (z, m)": (fin_k.zm, fin_p.zm)}, fin_k, T)
    spread = (traj_k[-1] - pw_d.mean(0)).abs().max().item()
    log(f"[pushsum main] invariant off sum(w) by "
        f"{(inv[:-1] - w_sum).abs().max().item():.3e} (limit 1e-4 sum|w|, "
        f"{value_tol.min().item():.2f}); total mass {inv[-1].item():.3f}; "
        f"worst |ratio - mean(w)| at T {spread:.4e} (at 0: "
        f"{(pw_d - pw_d.mean(0)).abs().max().item():.3f})")

    # ---- phase 6d: Theorem 1 on the card ---------------------------------
    theorem1_phase(dev)
    return out


def theorem1_phase(dev) -> None:
    """benchmarks/hps_bench.py's six consensus scenarios (:33-62) through
    the kernels and the plain path, each gap curve held within A1_LIMIT;
    then tests/test_hps_engine.py's envelope (:452-497) per configuration,
    every gap at or below theorem1_bound + 1e-6."""
    import torch
    from repro_torch.core import (ExecutionPlan, HPSConfig, make_hierarchy,
                                  run_hps, theorem1_bound)
    rng = np.random.default_rng(0)
    gap_plan = ExecutionPlan(store="gap")

    def curves(sizes, gamma, B, drop, T, topology="complete"):
        topo = make_hierarchy(sizes, topology=topology, seed=0)
        w = rng.normal(size=(topo.N, 4)).astype(np.float32)
        cfg = HPSConfig(topo=topo, gamma_period=gamma, B=B, drop_prob=drop)
        _zero_counts()
        k = run_hps(w, cfg, T, seed=0, plan=gap_plan)
        torch.cuda.synchronize()
        require(_counts() == _only(edge_scatter=T, edge_scatter_tiled=T),
                f"theorem 1 {sizes}: K1 launched T times")
        p = run_hps(w, cfg, T, seed=0, plan=gap_plan.replace(
            backend="torch"))
        err = (k.gap - p.gap).abs().max().item()
        require(err <= A1_LIMIT, f"theorem 1 {sizes} B={B}: gap curve "
                f"within {A1_LIMIT} of the plain path")
        return k.gap.cpu().numpy(), err

    for B in (1, 2, 8):
        g, err = curves([6, 6, 6], 8, B, 0.7, 600)
        log(f"[theorem1] hps_consensus_B{B} (3x6 complete, drop 0.7, Γ 8): "
            f"err_t300 {g[300]:.3e}; kernel vs plain {err:.2e}")
    for sizes in ([24], [12, 12], [6, 6, 6, 6]):
        g, err = curves(sizes, 4, 2, 0.2, 900, topology="ring")
        log(f"[theorem1] hps_consensus_ringM{len(sizes)} (N=24 rings, drop "
            f"0.2, Γ 4, B 2): err_t600 {g[600]:.3e}; kernel vs plain "
            f"{err:.2e}")
    g, err = curves([6, 6, 6], 4, 1, 0.1, 600)
    log(f"[theorem1] hps_decay_checkpoints: err(100;200;400) "
        f"{g[100]:.1e};{g[200]:.1e};{g[400]:.1e}; kernel vs plain "
        f"{err:.2e}")

    topo = make_hierarchy([4, 4], topology="complete", seed=5)
    w = np.random.default_rng(3).normal(size=(topo.N, 2)).astype(np.float32)
    worst, n_runs = -np.inf, 0
    for gamma in (2, 4):
        for drop in (0.0, 0.3):
            for B in (1, 2):
                cfg = HPSConfig(topo=topo, gamma_period=gamma, B=B,
                                drop_prob=drop)
                bound_t = np.asarray([theorem1_bound(cfg, w, t)
                                      for t in range(300)])
                for seed in (0, 1):
                    gap = run_hps(w, cfg, 300, seed=seed,
                                  plan=gap_plan).gap.cpu().numpy()
                    require(bool((gap <= bound_t + 1e-6).all()),
                            f"theorem 1 envelope Γ={gamma} drop={drop} "
                            f"B={B} seed={seed}")
                    worst = max(worst, float((gap - bound_t).max()))
                    n_runs += 1
    log(f"[theorem1] envelope on 2x4 complete: {n_runs} runs (Γ 2/4 x drop "
        f"0/0.3 x B 1/2 x seeds 0/1, T 300) through the kernels, every gap "
        f"under theorem1_bound + 1e-6; worst gap - bound {worst:.3e}")


def k1_d5_times(flush, k1_shapes: dict, d4_ms: float) -> dict:
    """K1 at D = 5 at the HPS and push-sum shapes: :func:`three_ways`, the
    plain version (host-inclusive), the byte bound and a device copy of
    the same bytes (half read, half written), the L2 flushed before each
    run -> name -> timings."""
    import torch
    from repro_torch.kernels.pushsum_edge import (edge_scatter_cuda,
                                                  edge_scatter_ref)
    out = {}
    for name, (k1, dst) in k1_shapes.items():
        E, D = k1[1].shape
        outs = edge_scatter_cuda(*k1)
        moved = nbytes(*k1, *outs)
        t = three_ways(lambda k1=k1: edge_scatter_cuda(*k1), TIMED_RUNS,
                       flush)
        t["plain_ms"] = event_ms(
            lambda k1=k1, dst=dst: edge_scatter_ref(*k1[:4], dst),
            TIMED_RUNS, flush)
        t["bound_ms"], t["bound_by"] = bound(moved, 2 * E * D)
        a = torch.ones(moved // 8, device=k1[0].device)
        b = torch.empty_like(a)
        t["copy_ms"] = event_ms(lambda a=a, b=b: b.copy_(a), TIMED_RUNS,
                                flush, hide_host=True)
        t.update(E=E, D=D, mb=moved / 1e6)
        out[name] = t
        log(f"[timing] edge_scatter D=5 at the {name} shape (E={E}, "
            f"{moved / 1e6:.2f} MB): device {t['ms']:.5f} ms with the host "
            f"hidden, kernel alone {t['kernel_ms']}, host-inclusive "
            f"{t['host_inclusive_ms']:.5f}; plain {t['plain_ms']:.5f}; bound "
            f"{t['bound_ms']:.5f} ({t['bound_by']}); a device copy of the "
            f"same bytes {t['copy_ms']:.5f}; D=4 at the Alg. 3 shape in this "
            f"call {d4_ms:.5f}; medians of {TIMED_RUNS}, L2 flushed")
    return out


def algorithm1_step_timing(dev) -> None:
    """Milliseconds per step of both Algorithm 1 engines at N = 16,384 and
    131,072, kernel and plain path (median of STEP_RUNS runs of STEP_T
    steps; HPS store final, push-sum one frame at the end), and profiles
    of the full-size kernel-path steps."""
    import torch
    from repro_torch.core import (ExecutionPlan, run_hps_runtime,
                                  run_pushsum_sparse)
    for n_agents in (N_SMALL, N_FULL):
        rt, w = hps_scenario(n_agents)
        rt, w = rt.to(dev), torch.from_numpy(w).to(dev)
        el, pw = pushsum_scenario(n_agents)
        src, dst, pw = (torch.from_numpy(a).to(dev)
                        for a in (el.src, el.dst, pw))
        runs = {}
        for backend in ("auto", "torch"):
            hplan = ExecutionPlan(backend=backend, store="final",
                                  dst_sorted=True)
            pplan = ExecutionPlan(backend=backend, dst_sorted=True)
            runs[("hps", backend)] = (
                lambda T=STEP_T, plan=hplan: run_hps_runtime(
                    w, rt, T, seed=0, plan=plan))
            runs[("pushsum", backend)] = (
                lambda T=STEP_T, plan=pplan: run_pushsum_sparse(
                    pw, src, dst, T, drop_prob=0.2, B=4, record_every=T,
                    plan=plan))
        ms = {}
        for key, run in runs.items():
            run()
            ms[key] = event_ms(run, STEP_RUNS) / STEP_T
        for engine in ("hps", "pushsum"):
            log(f"[timing] {engine} step at N={n_agents}: kernel "
                f"{ms[(engine, 'auto')]:.4f} ms, plain "
                f"{ms[(engine, 'torch')]:.4f} ms (median of {STEP_RUNS} runs "
                f"of {STEP_T} steps)")
        if n_agents == N_FULL:
            for engine in ("hps", "pushsum"):
                profile_step(runs[(engine, "auto")], f"{engine} N={n_agents}",
                             ms[(engine, "auto")])


# ---------------------------------------------------------------------------
# Scenario batching: K scenarios of Algorithms 1 and 3 as one block-diagonal
# graph, one K1 (and K2) launch a round for all of them
# ---------------------------------------------------------------------------

GRID_NETS = 256                 # complete 8-agent networks a scenario
GRID_SEEDS = 8
PS_SWEEP_N = 4_096              # push-sum sweep: nodes a graph draw
# timing: median of SWEEP_RUNS x STEP_T steps; few runs, so that the
# script keeps well inside its time limit as phases are added
SWEEP_RUNS = 6
# a grid row against the port's single run of its scenario on the card:
# the masks and K1's recv bit-equal, the rest within the CPU tests' limits
# (tests/test_torch_sweeps.py): the fusion pools each scenario's
# representatives with a reduction over (K, N, d+1) where the single run
# reduces (N, d+1), which the card may order otherwise
HPS_ROW_TOL = dict(rtol=1e-4, atol=1e-5)


def hps_grid_configs(sizes, drops, gammas, B):
    """Each drop x Γ on one hierarchy of ``sizes`` complete networks, in
    run_hps_sweep's order -> (base config, expanded configs)."""
    import dataclasses
    from repro_torch.core import HPSConfig, make_hierarchy
    base = HPSConfig(make_hierarchy(sizes, topology="complete"),
                     gamma_period=8, B=B)
    return base, [dataclasses.replace(base, drop_prob=float(np.float32(d)),
                                      gamma_period=g)
                  for d in drops for g in gammas]


def row_masks_equal(fold, res_seed, rows, E, drops, Bs, T, dev) -> None:
    """Every round's batched link-mask draw of the whole grid (keys folded
    for all rounds at once, one draw of K x E) against each row's own
    one-key draw (step_edge_mask), bit for bit, over rows ``rows``."""
    import torch
    from repro_torch.core.prng import Key, fold_rounds, prng_key
    from repro_torch.core.pushsum import edge_mask, step_edge_mask
    seeds = res_seed.numpy()
    keys = fold_rounds(Key(np.zeros_like(seeds), seeds),
                       [fold(t) for t in range(T)], dev)
    for t in range(T):
        batch = edge_mask(Key(keys.k0[t], keys.k1[t]), t, E, drops, Bs)
        for k in rows:
            one = step_edge_mask(prng_key(int(seeds[k])), t, E, drops[k],
                                 Bs[k], fold_t=fold(t))
            require(torch.equal(batch[k * E:(k + 1) * E], one),
                    f"row {k}'s link mask at round {t} bit-equal to its "
                    f"single draw")


def row_recv_equal(what, src, valid, offsets, K, rows, D, dev,
                   flush) -> float:
    """K1 over a stacked graph of K blocks (``src``, ``valid``, CSR
    ``offsets``) against K1 over row k's own block on the same random
    inputs: rho_new and recv bit-equal, for rows ``rows`` -> the stacked
    launch's device ms with the host hidden, L2 flushed (logged beside its
    byte bound)."""
    import torch
    from repro_torch.kernels.pushsum_edge import edge_scatter_cuda
    N, E = (offsets.shape[0] - 1) // K, src.shape[0] // K
    g = torch.Generator(device=dev).manual_seed(5)
    sigma = torch.randn((K * N, D), generator=g, device=dev)
    rho = torch.randn((K * E, D), generator=g, device=dev)
    live = (torch.rand(K * E, generator=g, device=dev) < 0.7) & valid
    args = (sigma, rho, live, src, offsets)
    rho_b, recv_b = edge_scatter_cuda(*args)
    for k in rows:
        n, e = slice(k * N, (k + 1) * N), slice(k * E, (k + 1) * E)
        rho_1, recv_1 = edge_scatter_cuda(
            sigma[n].contiguous(), rho[e].contiguous(), live[e].contiguous(),
            (src[e] - k * N).contiguous(),
            (offsets[k * N:(k + 1) * N + 1] - k * E).contiguous())
        require(torch.equal(rho_b[e], rho_1) and torch.equal(recv_b[n], recv_1),
                f"{what}: K1's rho_new and recv of row {k} bit-equal to its "
                f"single graph's")
    ms = event_ms(lambda: edge_scatter_cuda(*args), TIMED_RUNS, flush,
                  hide_host=True)
    b_ms, by = bound(nbytes(*args, rho_b, recv_b), 2 * K * E * D)
    log(f"[timing] {what}: edge_scatter at the grid's shape (K·N={K * N}, "
        f"K·E={K * E}, D={D}): {ms:.5f} ms with the host hidden, bound "
        f"{b_ms:.5f} ({by}); median of {TIMED_RUNS}, L2 flushed")
    return ms


def theorem1_curve(cfg, w, T: int) -> np.ndarray:
    """theorem1_bound(cfg, w, t) for t < T: the bound moves every 2Γ
    rounds, so it is evaluated once for each of those steps."""
    from repro_torch.core import theorem1_bound
    span = 2 * cfg.gamma_period
    at = [theorem1_bound(cfg, w, s * span) for s in range((T - 1) // span + 1)]
    return np.asarray([at[t // span] for t in range(T)])


def hold_rows(what, pairs: dict, tol: dict) -> str:
    """Grid rows against single runs within ``tol`` -> the measured gaps."""
    import torch
    msg = []
    for name, (a, b) in pairs.items():
        gap = (a - b).abs().max().item()
        msg.append(f"{name} {gap:.3e}")
        require(bool(torch.isclose(a, b, **tol).all()),
                f"{what}: {name} within {tol} of the single run")
    return ", ".join(msg)


def grid_timing(label: str, core, single, K: int, n_single: int,
                profile: bool = True) -> None:
    """ms a grid step (``core(T)``, the entry point's loop on its stacked
    inputs), ms a scenario-step, the single run of one scenario alone
    (``single(T)``), and (``profile``) a profile of the grid's steps."""
    grid_ms = event_ms(lambda: core(STEP_T), SWEEP_RUNS) / STEP_T
    one_ms = event_ms(lambda: single(STEP_T), SWEEP_RUNS) / STEP_T
    log(f"[timing] {label} grid step (K={K}): {grid_ms:.4f} ms, "
        f"{grid_ms / K:.5f} ms a scenario-step; one scenario alone at "
        f"N={n_single}: {one_ms:.4f} ms a step, {one_ms * K / grid_ms:.2f}x "
        f"the grid's scenario-step (median of {SWEEP_RUNS} runs of "
        f"{STEP_T} steps, store final)")
    if profile:
        profile_step(core, f"{label} grid K={K}", grid_ms)


def sweep_phases(dev) -> dict:
    """Phases 6e-6g -> each grid's kernel launches on its main run and K1's
    (and K2's) device ms at its shape, and the L2 flush they timed with."""
    import torch
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_        # evict the 50 MB L2 between timed runs
    return {"hps_grid": hps_grid_phase(dev, flush),
            "social_grid": social_grid_phase(dev, flush),
            "pushsum_sweep": pushsum_sweep_phase(dev, flush),
            "flush": flush}


def hps_grid_phase(dev, flush) -> dict:
    """Phase 6e: 64 HPS scenarios of N = 2,048 as one graph of 131,072."""
    import torch
    from repro_torch.core import (ExecutionPlan, HPSConfig, make_hierarchy,
                                  make_hps_runtime, run_hps_grid,
                                  run_hps_runtime, stack_runtimes)
    from repro_torch.core.hps import _hps_scan_core, hps_stream_fold
    from repro_torch.core.prng import Key
    T = T_MAIN
    base, cfgs = hps_grid_configs([8] * GRID_NETS, (0.0, 0.1, 0.3, 0.6),
                                  (4, 8), B=4)
    N = base.topo.N
    seeds = list(range(GRID_SEEDS))
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=(N, A1_D)).astype(np.float32)).to(dev)
    plan = ExecutionPlan(store="gap")
    _zero_counts()
    t0 = time.perf_counter()
    res = run_hps_grid(w, cfgs, T, seeds, plan=plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    K = res.K
    per_cfg = [make_hps_runtime(c) for c in cfgs]
    rts = [per_cfg[int(c)] for c in res.cfg]
    rt = stack_runtimes(rts).to(dev)
    log(f"[hps grid] {len(cfgs)} configs (drop 0/0.1/0.3/0.6 x Γ 4/8, B 4) "
        f"x {GRID_SEEDS} seeds = {K} scenarios of N={N} ({GRID_NETS} "
        f"complete 8-agent networks): one graph of K·N={K * N}, "
        f"K·E={rt.src.shape[0]}; T={T} store gap: {wall:.2f} s, launches "
        f"{counts}")
    require(K * N == N_FULL and rt.src.shape[0] == 917_504,
            "HPS grid: K·N = 131,072 and K·E = 917,504")
    require(counts == _only(edge_scatter=T, edge_scatter_tiled=T),
            "HPS grid: K1 launched T times for all K scenarios, on its "
            "edge-tiled kernel")
    res_p = run_hps_grid(w, cfgs, T, seeds, plan=plan.replace(
        backend="torch"))
    torch.cuda.synchronize()
    require(_counts() == counts, "HPS grid: the plain path launched no "
            "kernel")
    require(res.ratio.shape == (K, N, A1_D) and res.gap.shape == (K, T)
            and bool(torch.isfinite(res.ratio).all())
            and bool(torch.isfinite(res.gap).all()),
            "HPS grid: finite rows of the expected shapes")
    d_ratio = (res.ratio - res_p.ratio).abs().max().item()
    d_gap = (res.gap - res_p.gap).abs().max().item()
    require(max(d_ratio, d_gap) <= A1_LIMIT, f"HPS grid: rows within "
            f"{A1_LIMIT} of the plain path")
    # every row's mass: the same loop on the same stacked runtime
    state, _ = _hps_scan_core(
        Key(np.zeros(K, np.int64), res.seed.numpy()), rt, w, T=T,
        store="final", backend="auto")
    mass = state.m.view(K, N).sum(1) + (
        (state.sigma_m[rt.src.long()] - state.rho_m)
        * rt.valid).view(K, -1).sum(1)
    require(bool(((mass - N).abs() <= 1e-4 * N).all()), "HPS grid: every "
            "row's mass within 1e-4 N")
    # every gap curve under Theorem 1's bound (it moves every 2Γ rounds)
    bounds = [theorem1_curve(c, w.cpu().numpy(), T) for c in cfgs]
    worst = -np.inf
    for k in range(K):
        bound_t = bounds[int(res.cfg[k])]
        gap = res.gap[k].cpu().numpy()
        require(bool((gap <= bound_t + 1e-6).all()), f"HPS grid row {k}: "
                f"gap under theorem1_bound")
        worst = max(worst, float((gap / bound_t).max()))
    g = res.gap
    log(f"[hps grid] kernel vs plain: ratio {d_ratio:.3e}, gap curves "
        f"{d_gap:.3e} (limit {A1_LIMIT}); mass off N by at most "
        f"{(mass - N).abs().max().item():.3e}; worst gap / theorem1_bound "
        f"{worst:.3e}; gap at T by drop 0/0.1/0.3/0.6 (Γ 8, seed 0): "
        + " ".join(f"{g[k, -1].item():.4f}" for k in range(K)
                   if int(res.gamma[k]) == 8 and int(res.seed[k]) == 0))
    # rows 0 and K-1 against the single run of their scenario on the card
    rows = (0, K - 1)
    E = rt.src.shape[0] // K
    row_masks_equal(hps_stream_fold, res.seed, rows, E,
                    rt.drop_prob, rt.B, T, dev)
    k1_ms = row_recv_equal("HPS grid", rt.src, rt.valid, rt.offsets, K,
                           rows, A1_D + 1, dev, flush)
    for k in rows:
        cfg, seed = cfgs[int(res.cfg[k])], int(res.seed[k])
        one = run_hps_runtime(w, rts[k], T, seed=seed, plan=plan)
        gaps = hold_rows(f"HPS grid row {k}", {
            "ratio": (res.ratio[k], one.ratio), "gap": (res.gap[k], one.gap)},
            HPS_ROW_TOL)
        log(f"[hps grid] row {k} (drop {cfg.drop_prob:.2g}, Γ "
            f"{cfg.gamma_period}, seed {seed}) against its single run on the "
            f"card: link masks and K1's recv bit-equal; {gaps}")

    # benchmarks/hps_bench.py's grid (:112-125): 4 hierarchies of N = 18
    # (M 3, 3, 2, 6; mixed E) x Γ 4/8 x drop 0/0.3 x 3 seeds, T = 300
    topos = [make_hierarchy([6, 6, 6], topology="complete", seed=0),
             make_hierarchy([6, 6, 6], topology="ring+",
                            extra_edge_prob=0.8, seed=1),
             make_hierarchy([9, 9], topology="complete", seed=2),
             make_hierarchy([3] * 6, topology="complete", seed=3)]
    bcfgs = [HPSConfig(topo=t, gamma_period=gm, B=2, drop_prob=d)
             for t in topos for gm in (4, 8) for d in (0.0, 0.3)]
    bw = np.random.default_rng(0).normal(size=(18, 3)).astype(np.float32)
    _zero_counts()
    bres = run_hps_grid(bw, bcfgs, 300, list(range(3)))
    torch.cuda.synchronize()
    require(_counts() == _only(edge_scatter=300, edge_scatter_tiled=300),
            "hps_bench grid: K1 launched T times")
    bres_p = run_hps_grid(bw, bcfgs, 300, list(range(3)),
                          plan=ExecutionPlan(backend="torch"))
    d_b = (bres.gap - bres_p.gap).abs().max().item()
    require(d_b <= A1_LIMIT, "hps_bench grid: gap curves within the limit "
            "of the plain path")
    bbounds = [theorem1_curve(c, bw, 300) for c in bcfgs]
    for k in range(bres.K):
        bound_t = bbounds[int(bres.cfg[k])]
        require(bool((bres.gap[k].cpu().numpy() <= bound_t + 1e-6).all()),
                f"hps_bench grid row {k}: gap under theorem1_bound")
    log(f"[hps grid] hps_bench grid: {bres.K} scenarios (M "
        f"{sorted(set(bres.M.tolist()))}, E padded to "
        f"{max(int(np.count_nonzero(c.topo.adj)) for c in bcfgs)}), T 300, "
        f"K1 300 launches; kernel vs plain gap curves {d_b:.3e}; every "
        f"curve under theorem1_bound; worst final gap "
        f"{bres.gap[:, -1].max().item():.3e}")

    def core(T):
        return _hps_scan_core(Key(np.zeros(K, np.int64), res.seed.numpy()),
                              rt, w, T=T, store="final", backend="auto")

    one_rt = rts[0].to(dev)
    grid_timing("hps", core, lambda T: run_hps_runtime(
        w, one_rt, T, seed=0, plan=ExecutionPlan(store="final")), K, N)
    return {"launches": counts["edge_scatter"], "k1_ms": k1_ms}


def social_grid_phase(dev, flush) -> dict:
    """Phase 6f: 64 Algorithm 3 scenarios of N = 2,048 as one graph."""
    import torch
    from repro_torch.core import (ExecutionPlan, HPSConfig, make_confused_model,
                                  make_hierarchy, make_social_runtime,
                                  run_social_grid, run_social_runtime,
                                  run_social_sweep, stack_runtimes)
    from repro_torch.core.prng import (Key, fold_in, fold_rounds, prng_key,
                                       uniform)
    from repro_torch.core.social import (STREAM_LINK, STREAM_SIGNAL,
                                         _social_scan_core,
                                         social_stream_fold)
    from repro_torch.kernels.social_innov import innovation_cuda
    T = T_MAIN
    base, cfgs = hps_grid_configs([8] * GRID_NETS, (0.0, 0.3, 0.6, 0.9),
                                  (4, 8), B=4)
    N, M = base.topo.N, base.topo.M
    model = make_confused_model(N=N, m=3, truth=1, confusion=0.5)
    seeds = list(range(GRID_SEEDS))
    plan = ExecutionPlan(store="log_ratio")
    _zero_counts()
    t0 = time.perf_counter()
    res = run_social_grid(model, cfgs, T, seeds, plan=plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    K = res.K
    per_cfg = [make_social_runtime(c) for c in cfgs]
    rts = [per_cfg[int(c)] for c in res.cfg]
    rt = stack_runtimes(rts).to(dev)
    log(f"[social grid] {len(cfgs)} configs (drop 0/0.3/0.6/0.9 x Γ 4/8, B "
        f"4) x {GRID_SEEDS} seeds = {K} scenarios of N={N}, m=3, truth 1, "
        f"confusion 0.5: one graph of K·N={K * N}, K·E={rt.src.shape[0]}; "
        f"T={T} store log_ratio: {wall:.2f} s, launches {counts}")
    require(K * N == N_FULL, "social grid: K·N = 131,072")
    require(counts == _only(edge_scatter=T, edge_scatter_tiled=T,
                            social_innov=T),
            "social grid: K1 and K2 launched T times each for all K "
            "scenarios, K1 on its edge-tiled kernel")
    res_p = run_social_grid(model, cfgs, T, seeds,
                            plan=plan.replace(backend="torch"))
    torch.cuda.synchronize()
    require(_counts() == counts, "social grid: the plain path launched no "
            "kernel")
    bk, bp = res.beliefs, res_p.beliefs
    require(bk.shape == (K, N, 3) and res.log_ratio.shape == (K, T)
            and bool(torch.isfinite(bk).all())
            and bool(torch.isfinite(res.log_ratio).all()),
            "social grid: finite rows of the expected shapes")
    # phase 3's limits: beliefs 1e-2, worst-log-ratio curves 5e-2, the
    # argmax equal where the top two beliefs are more than 2e-2 apart
    d_b = (bk - bp).abs().max().item()
    d_l = (res.log_ratio - res_p.log_ratio).abs().max().item()
    require(d_b <= 1e-2 and d_l <= 5e-2, "social grid: beliefs and log "
            "ratios within phase 3's limits of the plain path")
    top2 = bp.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2e-2
    require(torch.equal(bk.argmax(-1)[decided], bp.argmax(-1)[decided]),
            "social grid: decisions equal")
    learned = (bk.argmax(-1) == model.truth).float().mean(1)
    log(f"[social grid] kernel vs plain: beliefs {d_b:.3e}, log-ratio "
        f"curves {d_l:.3e}; decisions equal on {int(decided.sum())}/{K * N} "
        f"decided agents; share deciding theta* by drop 0/0.3/0.6/0.9 (Γ 8, "
        f"seed 0): " + " ".join(f"{learned[k].item():.4f}" for k in range(K)
                               if int(res.gamma[k]) == 8
                               and int(res.seed[k]) == 0))
    rows = (0, K - 1)
    E = rt.src.shape[0] // K
    row_masks_equal(lambda t: social_stream_fold(t, STREAM_LINK),
                    res.seed, rows, E, rt.drop_prob, rt.B, T, dev)
    k1_ms = row_recv_equal("social grid", rt.src, rt.valid, rt.offsets, K,
                           rows, 4, dev, flush)
    # the signal draw and K2 per agent: each row's slice of the batched
    # uniforms and of K2 over the K·N agents equals its own
    seeds_np = res.seed.numpy()
    sk = fold_rounds(Key(np.zeros_like(seeds_np), seeds_np),
                     [social_stream_fold(t, STREAM_SIGNAL) for t in (0, T - 1)],
                     dev)
    tables = model.tables.to(dev)
    lt, cdf = torch.log(tables), torch.cumsum(tables[:, 1, :], dim=-1)
    g = torch.Generator(device=dev).manual_seed(3)
    z = torch.randn((K * N, 3), generator=g, device=dev)
    mass = torch.rand(K * N, generator=g, device=dev) + 0.5
    for i, t in enumerate((0, T - 1)):
        u = uniform(Key(sk.k0[i], sk.k1[i]), N, dev)
        z_b, mu_b = innovation_cuda(z, mass, u.reshape(-1),
                                    cdf.repeat(K, 1), lt.repeat(K, 1, 1))
        for k in rows:
            u1 = uniform(fold_in(prng_key(int(seeds_np[k])),
                                 social_stream_fold(t, STREAM_SIGNAL)), N, dev)
            n = slice(k * N, (k + 1) * N)
            z_1, mu_1 = innovation_cuda(z[n].contiguous(),
                                        mass[n].contiguous(), u1, cdf, lt)
            require(torch.equal(u[k], u1) and torch.equal(z_b[n], z_1)
                    and torch.equal(mu_b[n], mu_1),
                    f"social grid row {k}: signal uniforms and K2's z_new "
                    f"and mu bit-equal to its single run's at round {t}")
    k2_args = (z, mass, u.reshape(-1), cdf.repeat(K, 1), lt.repeat(K, 1, 1))
    k2_ms = event_ms(lambda: innovation_cuda(*k2_args), TIMED_RUNS, flush,
                     hide_host=True)
    b_ms, by = bound(nbytes(*k2_args, z_b, mu_b), 0)
    log(f"[timing] social grid: social_innov at the grid's shape (K·N="
        f"{K * N}, m=3, S={cdf.shape[1]}): {k2_ms:.5f} ms with the host "
        f"hidden, bound {b_ms:.5f} ({by}); median of {TIMED_RUNS}, L2 "
        f"flushed")
    for k in rows:
        cfg, seed = cfgs[int(res.cfg[k])], int(res.seed[k])
        one = run_social_runtime(model, rts[k], M, T, seed=seed,
                                 signal_seed=seed, plan=plan)
        gaps = hold_rows(f"social grid row {k}", {
            "beliefs": (res.beliefs[k], one.beliefs)}, dict(rtol=0, atol=1e-3))
        gaps += ", " + hold_rows(f"social grid row {k}", {
            "log ratio": (res.log_ratio[k], one.log_ratio)},
            dict(rtol=1e-3, atol=1e-2))
        top2 = one.beliefs.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2e-2
        require(torch.equal(res.beliefs[k].argmax(-1)[clear],
                            one.beliefs.argmax(-1)[clear]),
                f"social grid row {k}: decisions equal to its single run's")
        log(f"[social grid] row {k} (drop {cfg.drop_prob:.2g}, Γ "
            f"{cfg.gamma_period}, seed {seed}) against its single run on the "
            f"card: link masks, signal uniforms, K1's recv and K2's outputs "
            f"bit-equal, decisions equal; {gaps}")

    # benchmarks/social_learning.py's sweep (:144-153): 3 x 6 complete,
    # drop 0/0.3/0.6/0.9 x Γ 4/8/16 x 4 seeds, T = 300
    topo = make_hierarchy([6, 6, 6], topology="complete", seed=0)
    bmodel = make_confused_model(N=topo.N, m=3, truth=1, confusion=0.5,
                                 seed=0)
    bcfg = HPSConfig(topo=topo, gamma_period=8, B=4, drop_prob=0.0)
    _zero_counts()
    bres = run_social_sweep(bmodel, bcfg, 300,
                            drop_probs=(0.0, 0.3, 0.6, 0.9),
                            gammas=(4, 8, 16), seeds=range(4))
    torch.cuda.synchronize()
    require(_counts() == _only(edge_scatter=300, edge_scatter_tiled=300,
                               social_innov=300),
            "social_learning sweep: K1 and K2 launched T times")
    final = bres.beliefs[:, :, bmodel.truth].min(dim=1).values
    ok = final[bres.drop_prob < 0.9]
    require(bres.K == 48 and bool((ok > 0.9).all()),
            "social_learning sweep: every agent's final belief in theta* "
            "above 0.9 in every row with drop < 0.9")
    log(f"[social grid] social_learning sweep: {bres.K} scenarios, T 300, "
        f"K1 and K2 300 launches each; least final belief in theta* "
        f"{ok.min().item():.6f} over drop < 0.9, "
        f"{final[bres.drop_prob >= 0.9].min().item():.6f} at drop 0.9")

    keys = Key(np.zeros(K, np.int64), res.seed.numpy())

    def core(T):
        return _social_scan_core(keys, keys, rt, lt, cdf, truth=1, M=M, T=T,
                                 store="final", backend="auto")

    one_rt = rts[0].to(dev)
    grid_timing("social", core, lambda T: run_social_runtime(
        model, one_rt, M, T, seed=0, plan=ExecutionPlan(store="final")),
        K, N)
    return {"launches": counts["edge_scatter"],
            "k2_launches": counts["social_innov"], "k1_ms": k1_ms,
            "k2_ms": k2_ms}


def pushsum_sweep_phase(dev, flush) -> dict:
    """Phase 6g: 2 graph draws x 4 drops x 4 seeds of N = 4,096 as one
    graph of 131,072."""
    import torch
    from repro_torch.core import (ExecutionPlan, random_strongly_connected_edge_list,
                                  run_pushsum_sparse, run_pushsum_sweep,
                                  sort_by_dst, stack_edge_lists)
    from repro_torch.core.prng import prng_key
    from repro_torch.core.sweeps import _pushsum_grid, _pushsum_sweep_core
    T, n = T_MAIN, PS_SWEEP_N
    # benchmarks/pushsum_sweep.py's graph (:128), two draws from one rng
    rng = np.random.default_rng(0)
    draws = [random_strongly_connected_edge_list(n, 2.0, rng)
             for _ in range(2)]
    w = torch.from_numpy(rng.normal(size=(n, A1_D)).astype(np.float32)).to(dev)
    el = sort_by_dst(stack_edge_lists([d.to_dense() for d in draws]))[0]
    drops = (0.0, 0.3, 0.6, 0.9)
    kw = dict(drop_probs=drops, seeds=range(4), B=4)
    plan = ExecutionPlan(dst_sorted=True)
    _zero_counts()
    t0 = time.perf_counter()
    res = run_pushsum_sweep(w, el, T, plan=plan, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    K = res.K
    log(f"[pushsum sweep] 2 draws (E {draws[0].E} and {draws[1].E}, padded "
        f"to {el.E}) x drop 0/0.3/0.6/0.9 x 4 seeds = {K} scenarios of "
        f"N={n}, B 4: one graph of K·N={K * n}, K·E={K * el.E}; T={T}: "
        f"{wall:.2f} s, launches {counts}")
    require(K * n == N_FULL, "push-sum sweep: K·N = 131,072")
    require(counts == _only(edge_scatter=T, edge_scatter_tiled=T),
            "push-sum sweep: K1 launched T times for all K scenarios, on "
            "its edge-tiled kernel")
    res_p = run_pushsum_sweep(w, el, T, plan=plan.replace(backend="torch"),
                              **kw)
    torch.cuda.synchronize()
    require(_counts() == counts, "push-sum sweep: the plain path launched "
            "no kernel")
    require(res.err.shape == (K, T) and res.final_ratio.shape == (K, n, A1_D)
            and bool(torch.isfinite(res.final_ratio).all()),
            "push-sum sweep: finite rows of the expected shapes")
    require(bool((res.mass_gap.abs() <= 1e-4 * n).all()),
            "push-sum sweep: every row's mass gap within 1e-4 N")
    falls = res.err[:, -1] < res.err[:, 0]
    require(bool(falls[res.drop_prob < 0.9].all()), "push-sum sweep: err "
            "falls in every row with drop < 0.9")
    d_r = (res.final_ratio - res_p.final_ratio).abs().max().item()
    d_e = (res.err - res_p.err).abs().max().item()
    require(max(d_r, d_e) <= A1_LIMIT, f"push-sum sweep: rows within "
            f"{A1_LIMIT} of the plain path")
    log(f"[pushsum sweep] kernel vs plain: final ratios {d_r:.3e}, err "
        f"curves {d_e:.3e} (limit {A1_LIMIT}); largest |mass gap| "
        f"{res.mass_gap.abs().max().item():.3e}; err at T by drop "
        f"0/0.3/0.6/0.9 (graph 0, seed 0): "
        + " ".join(f"{res.err[k, -1].item():.3e}" for k in range(K)
                   if int(res.graph[k]) == 0 and int(res.seed[k]) == 0))
    args, _, _ = _pushsum_grid(el, drops, range(4), 4, plan, dev)
    rows = (0, K - 1)
    row_masks_equal(lambda t: t, res.seed, rows, el.E, args[5], args[6], T,
                    dev)
    k1_ms = row_recv_equal("push-sum sweep", args[1], args[3], args[4], K,
                           rows, A1_D + 1, dev, flush)
    target = w.mean(0)
    for k in rows:
        g = int(res.graph[k])
        fin, traj = run_pushsum_sparse(
            w, el.src[g], el.dst[g], T, drop_prob=float(res.drop_prob[k]),
            B=4, key=prng_key(int(res.seed[k])), valid=el.valid[g],
            record_every=1, plan=plan)
        err = (traj - target).abs().amax(dim=(1, 2))
        gaps = hold_rows(f"push-sum sweep row {k}", {
            "final ratios": (res.final_ratio[k], traj[-1]),
            "err": (res.err[k], err)}, HPS_ROW_TOL)
        log(f"[pushsum sweep] row {k} (graph {g}, drop "
            f"{float(res.drop_prob[k]):.2g}, seed {int(res.seed[k])}) against "
            f"its single run on the card: link masks and K1's recv "
            f"bit-equal; {gaps}")

    def core(T):
        return _pushsum_sweep_core(*args, w, T=T, backend="auto")

    src0, dst0, valid0 = (torch.from_numpy(a[0]).to(dev)
                          for a in (el.src, el.dst, el.valid))
    grid_timing("pushsum", core, lambda T: run_pushsum_sparse(
        w, src0, dst0, T, drop_prob=0.0, B=4, valid=valid0, record_every=T,
        plan=plan), K, n)
    return {"launches": counts["edge_scatter"], "k1_ms": k1_ms}


# ---------------------------------------------------------------------------
# Algorithm 2's scenario batching: K scenarios as one block-diagonal
# neighbor-list graph, one K3 launch a round for all of them, each
# receiver trimming its own scenario's F
# ---------------------------------------------------------------------------

BYZ_GRID_SEEDS = 16
# (F, Byzantine agents, Γ) of the grid's four configs
BYZ_GRID_CFGS = ((0, (), BYZ_GAMMA), (1, (2,), BYZ_GAMMA),
                 (BYZ_F, BYZ_AGENTS, BYZ_GAMMA), (BYZ_F, BYZ_AGENTS, 4))
BYZ_SWEEP_ATTACKS = ("sign_flip", "extreme_pull", "random_noise")


def byz_grid_setup():
    """byz_scenario's networks at N = 2,048 (256 complete 8-agent
    networks, confusion 0.25) and the grid's four configs -> (model,
    configs)."""
    from repro_torch.core import (ByzantineConfig, attacks,
                                  make_confused_model, make_hierarchy)
    topo = make_hierarchy([8] * GRID_NETS, topology="complete", seed=0)
    model = make_confused_model(N=topo.N, m=3, truth=0, confusion=0.25,
                                seed=1)
    atk = attacks.large_value(1e3)
    return model, [ByzantineConfig(topo=topo, F=F, byz=byz, gamma_period=g,
                                   attack=atk)
                   for F, byz, g in BYZ_GRID_CFGS]


def hold_byz(what, rk, rp, dk, dp, normal) -> str:
    """Byzantine rows (r (K, N, 3, 3), final decisions (K, N)) against
    another run of the same scenarios: r within byzantine_main's limits,
    final decisions equal where the decision margin is clear -> gaps."""
    import torch
    gap = (rk - rp).abs().max().item()
    require(bool(torch.isclose(rk, rp, rtol=2e-6, atol=1e-2).all()),
            f"{what}: r within rtol 2e-6, atol 1e-2")
    eye = torch.eye(3, dtype=torch.bool, device=rp.device)
    worst = torch.where(eye, torch.inf, rp).min(dim=-1).values
    top2 = worst.topk(2, dim=-1).values
    clear = normal & ((top2[..., 0] - top2[..., 1]) > BYZ_MARGIN)
    require(torch.equal(dk[clear], dp[clear]), f"{what}: decisions equal "
            f"where the margin is clear")
    return (f"r {gap:.3e}, final decisions equal on {int(clear.sum())}/"
            f"{int(normal.sum())} normal agents with margin > {BYZ_MARGIN}")


def byzantine_grid_phase(dev, flush) -> dict:
    """Phase 6h: 4 Byzantine configs x 16 seeds of N = 2,048 as one
    neighbor-list graph of 131,072 receivers; the sweep's attacks;
    benchmarks/byzantine_bench.py's grid; K3 with F per receiver; timings
    -> K3's launches on the grid's run and its grid-shape timings."""
    import torch
    from repro_torch.core import (ByzantineConfig, ExecutionPlan, attacks,
                                  make_byzantine_runtime, make_confused_model,
                                  make_hierarchy, run_byzantine_grid,
                                  run_byzantine_runtime, run_byzantine_sweep,
                                  stack_runtimes)
    from repro_torch.core.byzantine import (STREAM_SIGNAL, _build_scan,
                                            stream_fold)
    from repro_torch.core.prng import (Key, fold_in, fold_rounds, prng_key,
                                       uniform)
    from repro_torch.kernels.byz_trim import trim_gather_cuda
    T = T_MAIN
    model, cfgs = byz_grid_setup()
    N, M = cfgs[0].topo.N, cfgs[0].topo.M
    seeds = list(range(BYZ_GRID_SEEDS))
    atk = cfgs[0].attack
    plan = ExecutionPlan(store="decisions")
    t0 = time.perf_counter()
    per_cfg = [make_byzantine_runtime(model, c)[0] for c in cfgs]
    setup_s = time.perf_counter() - t0
    _zero_counts()
    t0 = time.perf_counter()
    res = run_byzantine_grid(model, cfgs, T, seeds, plan=plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    K = res.K
    rts = [per_cfg[int(c)] for c in res.cfg]
    rt = stack_runtimes(rts).to(dev)
    n_c = [int(r.in_C.sum()) // 8 for r in per_cfg]
    log(f"[byzantine grid] {len(cfgs)} configs (F/Byzantine/Γ "
        f"{', '.join(f'{F}/{list(b)}/{g}' for F, b, g in BYZ_GRID_CFGS)}; "
        f"networks in C {n_c} of {M}) x {BYZ_GRID_SEEDS} seeds = {K} "
        f"scenarios of N={N}: one neighbor-list graph of K·N={K * N} "
        f"receivers, deg_max {rt.nbr_idx.shape[1]}; large_value(1e3), T={T} "
        f"store decisions: {wall:.2f} s (set-up of the 4 runtimes "
        f"{setup_s:.2f} s), launches {counts}")
    require(K * N == N_FULL, "Byzantine grid: K·N = 131,072")
    require(counts == _only(byz_trim=T, byz_trim_tensor_f=T),
            "Byzantine grid: K3 launched T times for all K scenarios, each "
            "with F per receiver")
    res_p = run_byzantine_grid(model, cfgs, T, seeds,
                               plan=plan.replace(backend="torch"))
    torch.cuda.synchronize()
    require(_counts() == counts, "Byzantine grid: the plain path launched "
            "no kernel")
    require(res.r.shape == (K, N, 3, 3) and res.decisions.shape == (K, T, N)
            and bool(torch.isfinite(res.r).all()),
            "Byzantine grid: finite rows of the expected shapes")
    normal = ~rt.byz_mask.view(K, N)
    in_C = rt.in_C.view(K, N)
    gaps = hold_byz("Byzantine grid, kernel vs plain", res.r, res_p.r,
                    res.decisions[:, -1], res_p.decisions[:, -1], normal)
    share = ((res.decisions[:, -1] == model.truth) & normal & in_C).sum(1) \
        / (normal & in_C).sum(1)
    require(bool((share > 0.99).all()), "Byzantine grid: the share of "
            "normal agents in C deciding theta* above 0.99 in every row")
    log(f"[byzantine grid] kernel vs plain: {gaps}; share of normal agents "
        f"in C deciding theta* by config (seed 0): "
        + " ".join(f"{share[k].item():.4f}" for k in range(K)
                   if int(res.seed[k]) == 0)
        + f"; least over all rows {share.min().item():.4f}")

    # rows 0 and K-1 against their single runs on the card: the signal
    # uniforms and K3's tsum bit-equal, the rows within the limits
    rows = (0, K - 1)
    sk = fold_rounds(Key(np.zeros(K, np.int64), res.seed.numpy()),
                     [stream_fold(t, STREAM_SIGNAL) for t in (0, T - 1)],
                     dev)
    for i, t in enumerate((0, T - 1)):
        u = uniform(Key(sk.k0[i], sk.k1[i]), N, dev)
        for k in rows:
            u1 = uniform(fold_in(prng_key(int(res.seed[k])),
                                 stream_fold(t, STREAM_SIGNAL)), N, dev)
            require(torch.equal(u[k], u1), f"Byzantine grid row {k}: signal "
                    f"uniforms bit-equal to its single run's at round {t}")
    g = torch.Generator(device=dev).manual_seed(8)
    r_in = torch.randn((K * N, 9), generator=g, device=dev) * 30
    lies = torch.full((), 1e3, device=dev).expand(K * N, rt.nbr_idx.shape[1],
                                                  9)
    F_recv = torch.from_numpy(np.repeat(rt.F, N).astype(np.int32)).to(dev)
    k3 = (r_in, rt.nbr_idx, rt.nbr_valid, lies, rt.byz_nbr, F_recv)
    tsum_b, kept_b = trim_gather_cuda(*k3)
    require(same_bits(tsum_b, rank_order_tsum(*k3)),
            "Byzantine grid: K3's tsum with F per receiver bit-equal to the "
            "float32 rank-order sum at the grid's shape")
    for k in rows:
        n = slice(k * N, (k + 1) * N)
        one = rts[k].to(dev)
        t1, k1 = trim_gather_cuda(r_in[n].contiguous(), one.nbr_idx,
                                  one.nbr_valid, lies[n], one.byz_nbr,
                                  int(rt.F[k]))
        require(torch.equal(tsum_b[n], t1) and torch.equal(kept_b[n], k1),
                f"Byzantine grid row {k}: K3's tsum and kept bit-equal to "
                f"its single graph's with an int F")
        cfg, seed = cfgs[int(res.cfg[k])], int(res.seed[k])
        single = run_byzantine_runtime(model, one, None, M, atk, T,
                                       seed=seed, plan=plan)
        gaps = hold_byz(f"Byzantine grid row {k} vs its single run",
                        res.r[k:k + 1], single.r[None],
                        res.decisions[k:k + 1, -1], single.decisions[None, -1],
                        normal[k:k + 1])
        log(f"[byzantine grid] row {k} (F {cfg.F}, Byzantine "
            f"{list(cfg.byz)}, Γ {cfg.gamma_period}, seed {seed}) against "
            f"its single run on the card: signal uniforms and K3's tsum "
            f"bit-equal; {gaps}")

    # the sweep on the (F 2, Γ 10) config over 16 seeds, three attacks
    sweep_cfg = cfgs[2]
    srt = stack_runtimes([per_cfg[2]] * BYZ_GRID_SEEDS).to(dev)
    s_normal = ~srt.byz_mask.view(BYZ_GRID_SEEDS, N)
    s_in_C = srt.in_C.view(BYZ_GRID_SEEDS, N)
    for name in BYZ_SWEEP_ATTACKS:
        satk = [attacks.ATTACKS[name]()]
        _zero_counts()
        sk_res = run_byzantine_sweep(model, sweep_cfg, T, seeds, satk,
                                     plan=plan)[name]
        torch.cuda.synchronize()
        require(_counts() == _only(byz_trim=T, byz_trim_tensor_f=T),
                f"Byzantine sweep {name}: K3 launched T times")
        sp_res = run_byzantine_sweep(model, sweep_cfg, T, seeds, satk,
                                     plan=plan.replace(backend="torch"))[name]
        require(bool(torch.isfinite(sk_res.r).all()),
                f"Byzantine sweep {name}: finite rows")
        gaps = hold_byz(f"Byzantine sweep {name}, kernel vs plain",
                        sk_res.r, sp_res.r, sk_res.decisions[:, -1],
                        sp_res.decisions[:, -1], s_normal)
        single = run_byzantine_runtime(model, per_cfg[2], None, M, satk[0],
                                       T, seed=0, plan=plan, device=dev)
        gaps0 = hold_byz(f"Byzantine sweep {name} row 0 vs its single run",
                         sk_res.r[:1], single.r[None],
                         sk_res.decisions[:1, -1],
                         single.decisions[None, -1], s_normal[:1])
        s_share = ((sk_res.decisions[:, -1] == model.truth) & s_normal
                   & s_in_C).sum(1) / (s_normal & s_in_C).sum(1)
        require(bool((s_share > 0.99).all()), f"Byzantine sweep {name}: "
                f"normal agents in C learn theta* in every row")
        log(f"[byzantine sweep] {name} (F 2, Γ 10, {BYZ_GRID_SEEDS} seeds): "
            f"K3 {T} launches; kernel vs plain: {gaps}; row 0 vs its single "
            f"run: {gaps0}; least share deciding theta* "
            f"{s_share.min().item():.4f}")

    # benchmarks/byzantine_bench.py's grid (:140-177): 3 ring+ topologies
    # of 3 x 5 agents x F 0|1 x 8 seeds = 48 scenarios, T = 200
    bmodel = make_confused_model(N=15, m=3, truth=0, confusion=0.0, seed=0)
    batk = attacks.large_value()
    bcfgs = []
    for s in range(3):
        topo = make_hierarchy([5, 5, 5], topology="ring+",
                              extra_edge_prob=0.9, seed=s)
        bcfgs += [ByzantineConfig(topo=topo, F=0, byz=(), gamma_period=4,
                                  attack=batk),
                  ByzantineConfig(topo=topo, F=1, byz=(1,), gamma_period=4,
                                  attack=batk)]
    _zero_counts()
    t0 = time.perf_counter()
    bres = run_byzantine_grid(bmodel, bcfgs, T, list(range(8)), plan=plan)
    torch.cuda.synchronize()
    b_wall = time.perf_counter() - t0
    require(_counts() == _only(byz_trim=T, byz_trim_tensor_f=T),
            "byzantine_bench grid: K3 launched T times")
    dec = bres.decisions[:, -1].cpu().numpy()
    accs = []
    for k in range(bres.K):
        bm = np.zeros(15, bool)
        bm[list(bcfgs[int(bres.cfg[k])].byz)] = True
        accs.append(float((dec[k][~bm] == bmodel.truth).mean()))
    log(f"[byzantine grid] byzantine_bench grid: {bres.K} scenarios (3 "
        f"ring+ topologies x F 0|1 x 8 seeds), T {T}: {b_wall:.2f} s, K3 "
        f"{T} launches; mean accuracy {np.mean(accs):.3f} (least "
        f"{min(accs):.3f})")
    require(bres.K == 48, "byzantine_bench grid: 48 scenarios")

    # K3 with a tensor F at the grid's shape beside the int-F call, and at
    # TRIM_EDGE's cases with mixed F per receiver
    grid_ms = event_ms(lambda: trim_gather_cuda(*k3), TIMED_RUNS, flush,
                       hide_host=True)
    k3_int = k3[:5] + (BYZ_F,)
    int_ms = event_ms(lambda: trim_gather_cuda(*k3_int), TIMED_RUNS, flush,
                      hide_host=True)
    dm = rt.nbr_idx.shape[1]
    b_ms, by = bound(nbytes(*k3[:3], rt.byz_nbr, F_recv, tsum_b, kept_b) + 4,
                     K * N * 9 * dm * (2 * BYZ_F + 1))
    log(f"[timing] byz_trim at the Byzantine grid's shape (K·N={K * N}, "
        f"deg_max {dm}, P 9, stride-0 lies): F per receiver {grid_ms:.5f} "
        f"ms, int F = {BYZ_F} {int_ms:.5f} ms ({grid_ms / int_ms:.3f}x), "
        f"with the host hidden; bound {b_ms:.5f} ({by}); medians of "
        f"{TIMED_RUNS}, L2 flushed")
    names, under = [], 0
    rng = np.random.default_rng(9)
    for name, _, case_args in trim_edge_cases(dev):
        n_r, dm_c = case_args[1].shape
        f = rng.integers(0, max(4, dm_c // 2 + 1) + 1, size=n_r)
        f[::5] = 0
        F_t = torch.from_numpy(f.astype(np.int32)).to(dev)
        tk, kk = trim_gather_cuda(*case_args, F_t)
        deg = case_args[2].sum(1)
        require(same_bits(tk, rank_order_tsum(*case_args, F_t))
                and torch.equal(kk, (deg - 2 * F_t).clamp_min(0).float()),
                f"trim_gather {name} with F per receiver: tsum bit-equal to "
                f"the rank-order sum, kept max(deg - 2F, 0)")
        under += int(((deg <= 2 * F_t) & (deg > 0)).sum())
        names.append(name)
    require(under > 0, "trim_gather with F per receiver: rows with deg <= "
            "2F among the edge cases")
    log(f"[kernels] byz_trim with F per receiver (0 .. deg_max / 2 + 1, "
        f"every fifth row 0; {under} rows with 0 < deg <= 2F): tsum "
        f"bit-equal to the float32 rank-order sum and kept bit-equal at the "
        f"grid's shape and {len(names)} edge cases ({', '.join(names)})")

    # the grid step, a scenario-step, one scenario alone, a profile
    keys = Key(np.zeros(K, np.int64), res.seed.numpy())

    def core(T):
        return _build_scan(model, rt, None, M, atk, T, mode="pairwise",
                           core="sparse", backend="auto", store="final",
                           device=dev)(keys)

    one_rt = rts[2].to(dev)
    grid_timing("byzantine", core, lambda T: run_byzantine_runtime(
        model, one_rt, None, M, atk, T, seed=0,
        plan=ExecutionPlan(store="final")), K, N)
    return {"launches": counts["byz_trim"], "ms": grid_ms, "int_f_ms": int_ms,
            "bound_ms": b_ms}


# ---------------------------------------------------------------------------
# Phases 6i-6j: the fault and async planes (core/faults.py,
# core/asyncrony.py) through the four engines and their grids, on K1-K3
# ---------------------------------------------------------------------------

# A faulted or async run against the plain path. The plain path adds each
# receiver's increments through index_add_'s atomics, in another order a
# run, so the two paths differ by about an ulp of a relay counter a round,
# which moves z / m by that ulp over the mass. Churn freezes dead agents
# and drains the mass of networks that lose their links (to 1e-23 on these
# cells), so beliefs and ratios are held where m >= PLANE_MASS_FLOOR (H100
# runs: Alg. 3 severe 1.2e-4 there, 6.4e-3 at m >= 1e-3 in one run and
# past 1e-2 in another; push-sum severe 1.8e-5), every (z, m) within
# A1_LIMIT, and the decisions of Alg. 3 equal wherever the top two beliefs
# are more than 2e-2 apart (phase 3's rule), those of Alg. 2 where the
# decision margin is clear (hold_byz, phase 5's rule).
PLANE_MASS_FLOOR = 0.1
PLANE_T_DEGENERATE = 50         # rounds of the degenerate bit-identity runs


PLANE_DESC = {
    "severe": "gilbert_elliott_model(8.0, 0.5, leave 0.1, join 0.25, PS "
              "crash 0.5)",
    "churn": "make_fault_model(leave 0.02, join 0.3)",
    "async": "make_async_model(0.6, 8)"}


def plane_plans() -> dict:
    """The chaos lane's severe model (benchmarks/chaos.py:52-56), the churn
    row's (benchmarks/social_learning.py:190) and the async acceptance
    cell (benchmarks/social_learning.py:282), as plans (PLANE_DESC)."""
    from repro_torch.core import (ExecutionPlan, gilbert_elliott_model,
                                  make_async_model, make_fault_model)
    return {"severe": ExecutionPlan(faults=gilbert_elliott_model(
                8.0, 0.5, leave_prob=0.1, join_prob=0.25, ps_crash_prob=0.5)),
            "churn": ExecutionPlan(faults=make_fault_model(leave_prob=0.02,
                                                           join_prob=0.3)),
            "async": ExecutionPlan(async_=make_async_model(0.6, 8))}


def chaos_models() -> list:
    """benchmarks/chaos.py:49-56's fault grid: burst 8 or 32 x churn 0.1 or
    0.3, half the time bad, a coin-flip PS, rejoin 0.25."""
    from repro_torch.core import gilbert_elliott_model
    return [gilbert_elliott_model(L, 0.5, leave_prob=c, join_prob=0.25,
                                  ps_crash_prob=0.5)
            for L in (8.0, 32.0) for c in (0.1, 0.3)]


def plane_engines(dev, model, rt, M, bmodel, bsetup, battack) -> dict:
    """The four engines at N = 131,072 on the main cells of PERF.md §4 ->
    name: run(plan, T), the plan's route and planes applied."""
    import torch
    from repro_torch.core import (run_byzantine_runtime, run_hps_runtime,
                                  run_pushsum_sparse, run_social_runtime)
    rt_d = rt.to(dev)
    hrt, hw = hps_scenario(N_FULL)
    hrt, hw = hrt.to(dev), torch.from_numpy(hw).to(dev)
    el, pw = pushsum_scenario(N_FULL)
    src, dst, pw = (torch.from_numpy(a).to(dev) for a in (el.src, el.dst,
                                                           pw))
    brt, extra, n_reps = bsetup
    brt = brt.to(dev)
    return {
        "social": lambda plan, T: run_social_runtime(
            model, rt_d, M, T, seed=0,
            plan=plan.replace(store="final", dst_sorted=True)),
        "hps": lambda plan, T: run_hps_runtime(
            hw, hrt, T, seed=0, plan=plan.replace(store="gap",
                                                  dst_sorted=True)),
        "pushsum": lambda plan, T: run_pushsum_sparse(
            pw, src, dst, T, drop_prob=0.2, B=4, record_every=T,
            plan=plan.replace(dst_sorted=True)),
        "byzantine": lambda plan, T: run_byzantine_runtime(
            bmodel, brt, extra, n_reps, battack, T, seed=0,
            plan=plan.replace(store="decisions")),
        "_edges": {"social": (rt_d.src, rt_d.valid),
                   "hps": (hrt.src, hrt.valid),
                   "pushsum": (src, torch.ones_like(src, dtype=torch.bool))},
        "_byz": brt,
    }


def plane_outputs(engine: str, res) -> tuple:
    """A run's outputs, flat: the state and what the engine emits."""
    if engine == "pushsum":
        return (*res[0], res[1])
    if engine == "byzantine":
        return tuple(res)
    return (res[0], res[2], *res.final_state)


def plane_launches(engine: str, T: int, on_async: bool) -> dict:
    if engine == "byzantine":
        return _only(byz_trim=T)
    k2 = {"social_innov": T} if engine == "social" else {}
    return _only(edge_scatter=T, edge_scatter_tiled=T,
                 edge_scatter_edge_rows=T if on_async else 0, **k2)


def hold_plane(engine: str, what: str, k, p, edges, N: int, T: int,
               truth: int, byz=None) -> str:
    """A faulted or async run of ``engine`` on the kernels (``k``) against
    the plain path (``p``) at the limits above -> the gaps, logged."""
    import torch
    from repro_torch.core import decide, sparse_mass_invariant
    if engine == "byzantine":
        normal = ~byz.byz_mask
        require(bool(torch.isfinite(k.r).all()), f"{what}: finite")
        gaps = hold_byz(what, k.r[None], p.r[None], k.decisions[None, -1],
                        p.decisions[None, -1], normal[None])
        require(torch.equal(k.decisions[-1], decide(k.r)),
                f"{what}: final decisions follow r")
        share = ((k.decisions[-1] == truth) & normal & byz.in_C).float().sum() \
            / (normal & byz.in_C).float().sum()
        return f"{gaps}; share of normal agents in C deciding theta* " \
               f"{share.item():.4f}"
    state_k = k[0] if engine == "pushsum" else k.final_state
    state_p = p[0] if engine == "pushsum" else p.final_state
    out = plane_outputs(engine, k)
    require(all(bool(torch.isfinite(x).all()) for x in out
                if x.is_floating_point()), f"{what}: outputs finite")
    inv = sparse_mass_invariant(state_k, *edges)
    require(abs(inv[-1].item() - N) <= 1e-4 * N,
            f"{what}: mass within 1e-4 N")
    heavy = state_k.m >= PLANE_MASS_FLOOR
    if engine == "social":
        bk, bp = k.beliefs, p.beliefs
        diff = (bk - bp).abs().amax(dim=-1)
        by_mass = ", ".join(
            f"m >= {f:g}: {diff[state_k.m >= f].max().item():.3e} on "
            f"{int((state_k.m >= f).sum())}" for f in (1e-1, 1e-2, 1e-3, 0))
        top2 = bp.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2e-2
        flips = int((bk.argmax(-1) != bp.argmax(-1))[clear].sum())
        d_zm = (state_k.zm - state_p.zm).abs().max().item()
        log(f"[planes] {what}: belief gap by mass {by_mass}; decisions "
            f"that differ on {flips}/{int(clear.sum())} clear agents; (z, m) "
            f"{d_zm:.3e}")
        d_b = diff[heavy].max().item()
        require(d_b <= 1e-2, f"{what}: beliefs within 1e-2 of the plain "
                f"path where m >= {PLANE_MASS_FLOOR}")
        require(d_zm <= A1_LIMIT, f"{what}: (z, m) within {A1_LIMIT} of the "
                f"plain path")
        require(flips == 0, f"{what}: decisions equal where the top two "
                f"beliefs are more than 2e-2 apart")
        return (f"beliefs {d_b:.3e} on {int(heavy.sum())}/{N} agents with m "
                f">= {PLANE_MASS_FLOOR}, (z, m) {d_zm:.3e}; decisions equal "
                f"on {int(clear.sum())}/{N} clear agents, deciding theta* "
                f"{(bk.argmax(-1) == truth).float().mean().item():.4f}; total "
                f"mass {inv[-1].item():.3f}")
    ratio_k = k[1][-1] if engine == "pushsum" else k.ratio
    ratio_p = p[1][-1] if engine == "pushsum" else p.ratio
    pairs = {"final ratio": (ratio_k, ratio_p, heavy),
             "final (z, m)": (state_k.zm, state_p.zm)}
    if engine == "hps":
        pairs["gap curve"] = (k.gap, p.gap)
    hold_a1(what, pairs, state_k, T, floor=PLANE_MASS_FLOOR)
    return f"total mass {inv[-1].item():.3f}; least mass " \
           f"{state_k.m.min().item():.3e}"


def plane_draws_equal(dev, engine: str, plan, N: int, T: int, key,
                      src=None, dst=None, brt=None) -> None:
    """The fault, liveness, wake and link-mask draws of ``engine``'s loop
    on the card against the same draws on the CPU, bit for bit: round 0
    from the initial state and round T - 1 from a random one."""
    import torch
    from repro_torch.core import faults as fa
    from repro_torch.core.hps import hps_stream_fold
    from repro_torch.core.prng import Key, fold_in, fold_rounds
    from repro_torch.core.pushsum import PlaneRounds, round_mask
    from repro_torch.core.social import STREAM_LINK, social_stream_fold
    g = np.random.default_rng(T)
    if engine == "byzantine":
        shape = tuple(brt.nbr_idx.shape)
        rand = fa.FaultState(torch.from_numpy(g.random(shape) < 0.5),
                             torch.from_numpy(g.random(shape[0]) < 0.8))
        fe, fc = (fold_rounds(key, [fa.fault_stream_fold(
            t, fa.ENGINE_BYZANTINE, s) for t in (0, T - 1)], None)
                  for s in (fa.FAULT_EDGE, fa.FAULT_CHURN))
        for i, fs0 in enumerate((fa.init_fault_state(shape[0], shape),
                                 rand)):
            (fs_d, drop_d), (fs_c, drop_c) = (
                fa.advance_faults_nbr(
                    Key(fe.k0[i], fe.k1[i]), Key(fc.k0[i], fc.k1[i]),
                    plan.faults.to(d),
                    fa.FaultState(*(x.to(d) for x in fs0)))
                for d in (dev, "cpu"))
            require(all(torch.equal(a.cpu(), b) for a, b in zip(
                (*fs_d, drop_d), (*fs_c, drop_c))),
                f"byzantine at round {(0, T - 1)[i]}: the slot chain, "
                f"liveness and drop draws on the card bit-equal to the CPU's")
        return
    eng = {"social": fa.ENGINE_SOCIAL, "hps": fa.ENGINE_HPS,
           "pushsum": fa.ENGINE_PUSHSUM}[engine]
    link = {"social": lambda t: social_stream_fold(t, STREAM_LINK),
            "hps": hps_stream_fold, "pushsum": lambda t: t}[engine]
    E = src.shape[0]
    rand = fa.FaultState(torch.from_numpy(g.random(E) < 0.5),
                         torch.from_numpy(g.random(N) < 0.8))
    drop, B = torch.tensor(0.1), torch.tensor(4, dtype=torch.int32)
    for t in (0, T - 1):
        draws = []
        for d in (dev, "cpu"):
            pr = PlaneRounds.build(key, T, eng, plan.faults, plan.async_, E,
                                   d)
            fs, _ = pr.init(N, E, 1, d)
            if fs is not None and t:
                fs = fa.FaultState(*(x.to(d) for x in rand))
            fs, awake = pr.step(t, fs, N)
            mask = round_mask(fold_in(key, link(t)), t, E, drop.to(d),
                              B.to(d), pr.faults, fs, src.to(d), dst.to(d))
            draws.append([x for x in (mask, awake,
                                      *(() if fs is None else fs))
                          if x is not None])
        require(all(torch.equal(a.cpu(), b) for a, b in zip(*draws)),
                f"{engine} at round {t}: the fault, liveness, wake and link "
                f"mask draws on the card bit-equal to the CPU's")


def turns_ms(fns: dict, runs: int = SWEEP_RUNS, steps: int = STEP_T) -> dict:
    """Median ms a step of each ``fns[name](steps)``, the runs taken in
    turns (name after name, ``runs`` times)."""
    times = {name: [] for name in fns}
    for fn in fns.values():
        fn(min(5, steps))
    for _ in range(runs):
        for name, fn in fns.items():
            times[name].append(event_ms(lambda fn=fn: fn(steps), 1) / steps)
    return {name: float(np.median(t)) for name, t in times.items()}


def plane_single_phase(dev, model, rt, M, bmodel, bsetup, battack) -> dict:
    """Phase 6i: the four engines at N = 131,072 under the planes, kernel
    path against plain path; the draws on the card against the CPU's; the
    degenerate models bit-equal to no plane on the kernel path; K1's
    identity-source route at the engines' shapes; timings -> launches."""
    import torch
    from repro_torch.core import (ExecutionPlan, make_async_model,
                                  make_fault_model)
    from repro_torch.core.prng import prng_key
    T, N = T_MAIN, N_FULL
    plans = plane_plans()
    runs = plane_engines(dev, model, rt, M, bmodel, bsetup, battack)
    cells = [("social", "severe"), ("social", "churn"), ("social", "async"),
             ("hps", "severe"), ("hps", "async"), ("pushsum", "severe"),
             ("pushsum", "async"), ("byzantine", "severe")]
    out = {}
    for engine, name in cells:
        plan = plans[name]
        what = f"planes {engine} {name}"
        _zero_counts()
        t0 = time.perf_counter()
        res_k = runs[engine](plan, T)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        require(counts == plane_launches(engine, T, plan.async_ is not None),
                f"{what}: each kernel of the engine launched T times"
                + (", K1 on its identity-source route" if plan.async_
                   is not None else ""))
        out[(engine, name)] = counts
        res_p = runs[engine](plan.replace(backend="torch"), T)
        torch.cuda.synchronize()
        require(_counts() == counts, f"{what}: the plain path launched no "
                f"kernel")
        gaps = hold_plane(engine, what, res_k, res_p,
                          runs["_edges"].get(engine), N, T,
                          bmodel.truth if engine == "byzantine"
                          else model.truth, byz=runs["_byz"])
        log(f"[planes] {engine} N={N} T={T} under {name} "
            f"({PLANE_DESC[name]}): "
            f"kernels {wall:.2f} s, launches {counts}; kernel vs plain: "
            f"{gaps}")
    # the draws: the card's against the CPU's
    hrt, _ = hps_scenario(N)
    el, _ = pushsum_scenario(N)
    setups = {"social": (rt.src, rt.dst), "hps": (hrt.src, hrt.dst),
              "pushsum": (torch.from_numpy(el.src), torch.from_numpy(el.dst))}
    for engine, name in (("social", "severe"), ("social", "async"),
                         ("pushsum", "severe")):
        plane_draws_equal(dev, engine, plans[name], N, T, prng_key(0),
                          src=setups[engine][0], dst=setups[engine][1])
    plane_draws_equal(dev, "byzantine", plans["severe"], N, T, prng_key(0),
                      brt=bsetup[0])
    log(f"[planes] draws: the Gilbert–Elliott chain, churn liveness and "
        f"faulted link masks of the social and push-sum loops (severe "
        f"model; E up to {rt.src.shape[0]}; HPS runs the same code on "
        f"another fold), the social loop's wake coins "
        f"and link masks (async model) and the Byzantine slot chain, "
        f"liveness and drop coins, at rounds 0 and {T - 1}, bit-equal on the "
        f"card and the CPU")
    # degenerate models on the kernel path: bit-equal to no plane
    Td = PLANE_T_DEGENERATE
    for engine in ("social", "hps", "pushsum", "byzantine"):
        base = plane_outputs(engine, runs[engine](ExecutionPlan(), Td))
        deg = [ExecutionPlan(faults=make_fault_model())]
        if engine != "byzantine":
            deg.append(ExecutionPlan(async_=make_async_model()))
        for plan in deg:
            got = plane_outputs(engine, runs[engine](plan, Td))
            require(all(torch.equal(a, b) for a, b in zip(base, got)),
                    f"{engine}: the degenerate {plan} bit-equal to no plane "
                    f"on the kernel path")
    log(f"[planes] degenerate models (make_fault_model(), and "
        f"make_async_model() but for Alg. 2) through the four engines on the "
        f"kernel path, T={Td}: bit-equal to faults=None / async_=None")
    # K1's identity-source route at the engines' shapes, and its time
    # beside the node route's on the same edges (host hidden, L2 flushed)
    from repro_torch.kernels.pushsum_edge import dst_offsets, edge_scatter_cuda
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev).zero_
    out["k1_identity_ms"] = {}
    for label, (src, dst) in (("hps", (hrt.src, hrt.dst)),
                              ("pushsum", (el.src, el.dst))):
        dst_d = torch.as_tensor(dst).to(dev)
        src_d = torch.as_tensor(src).to(dev)
        E = dst_d.shape[0]
        g = torch.Generator(device=dev).manual_seed(11)
        snap = torch.randn((E, A1_D + 1), generator=g, device=dev)
        sigma = torch.randn((N, A1_D + 1), generator=g, device=dev)
        rho = torch.randn((E, A1_D + 1), generator=g, device=dev)
        live = torch.rand(E, generator=g, device=dev) < 0.6
        ident = torch.arange(E, dtype=torch.int32, device=dev)
        offsets = dst_offsets(dst_d, N)
        k1 = (snap, rho, live, ident, offsets)
        err = k1_hold(f"identity-source route, {label} shape", k1, dst_d,
                      None)
        node = (sigma, rho, live, src_d, offsets)
        ms = {name: event_ms(lambda a=a: edge_scatter_cuda(*a), TIMED_RUNS,
                             flush, hide_host=True)
              for name, a in (("identity", k1), ("node", node))}
        out["k1_identity_ms"][label] = ms["identity"]
        # each input read once, rho_new and recv written once
        b_ms, by = bound(nbytes(*k1, rho) + N * (A1_D + 1) * 4,
                         2 * E * (A1_D + 1))
        log(f"[planes] edge_scatter's identity-source route (the async "
            f"delivery) at the {label} shape (E={E}, D={A1_D + 1}): rho_new "
            f"bit-equal, recv bit-equal to the float32 edge-order sum; "
            f"against index_add_ {err:.3e}; {ms['identity']:.5f} ms with the "
            f"host hidden beside the node route's {ms['node']:.5f} on the "
            f"same edges (bound {b_ms:.5f}, {by}; median of {TIMED_RUNS}, "
            f"L2 flushed)")
    # timings: kernel and plain paths in turns and a profile (Alg. 3
    # severe and async, Alg. 2 severe), the kernel path alone (HPS severe,
    # push-sum async); the plane-free steps are phase 7's. (Profiles are
    # few: in a long process the profiler stops recording some launches.)
    for engine, name, turns in (("social", "severe", True),
                                ("social", "async", True),
                                ("byzantine", "severe", True),
                                ("hps", "severe", False),
                                ("pushsum", "async", False)):
        plan, fn = plans[name], runs[engine]
        paths = {"kernel": lambda T, p=plan, fn=fn: fn(p, T)}
        if turns:
            paths["plain"] = lambda T, p=plan, fn=fn: fn(
                p.replace(backend="torch"), T)
        runs_n = SWEEP_RUNS if turns else 3
        ms = turns_ms(paths, runs=runs_n)
        log(f"[timing] {engine} under {name} at N={N}: kernel "
            f"{ms['kernel']:.4f} ms"
            + (f", plain {ms['plain']:.4f} ms" if turns else "")
            + f" a step ({'in turns, ' if turns else ''}median of {runs_n} "
            f"runs of {STEP_T} steps)")
        if turns:
            profile_step(paths["kernel"], f"{engine} {name} N={N}",
                         ms["kernel"])
    return out


def plane_grid_rows(what, engine, res, rows, models, N, E, T, dev) -> None:
    """Rows of a crossed grid against their single runs' draws: each row's
    slice of the grid's stacked fault and wake draws (rounds 0 and T - 1,
    from the initial state) bit-equal to its single run's."""
    import torch
    from repro_torch.core import faults as fa
    from repro_torch.core.asyncrony import AsyncModel, stack_async_models
    from repro_torch.core.prng import Key, prng_key
    from repro_torch.core.pushsum import PlaneRounds
    eng = {"social": fa.ENGINE_SOCIAL, "hps": fa.ENGINE_HPS}[engine]
    seeds = res.seed.numpy()
    K = len(seeds)
    keys = Key(np.zeros(K, np.int64), seeds)
    fl, al = models
    fm = (None if res.fault is None
          else fa.stack_fault_models([fl[int(i)] for i in res.fault]))
    am = (None if res.async_ is None
          else stack_async_models([al[int(i)] for i in res.async_]))
    grid = PlaneRounds.build(keys, T, eng, fm, am, E, dev)
    for t in (0, T - 1):
        fs, _ = grid.init(K * N, K * E, 1, dev)
        fs_b, wake_b = grid.step(t, fs, K * N)
        for k in rows:
            one = PlaneRounds.build(
                prng_key(int(seeds[k])), T, eng,
                None if fm is None else fa.FaultModel(*(x[k] for x in fm)),
                None if am is None else AsyncModel(*(x[k] for x in am)),
                E, dev)
            fs1, _ = one.init(N, E, 1, dev)
            fs1, wake1 = one.step(t, fs1, N)
            n, e = slice(k * N, (k + 1) * N), slice(k * E, (k + 1) * E)
            pairs = []
            if fs_b is not None:
                pairs += [(fs_b.edge_bad[e], fs1.edge_bad),
                          (fs_b.node_live[n], fs1.node_live)]
            if wake_b is not None:
                pairs.append((wake_b[n], wake1))
            require(all(torch.equal(a, b) for a, b in pairs),
                    f"{what} row {k}: the fault and wake draws of round {t} "
                    f"bit-equal to its single run's")


def plane_grid_phase(dev) -> dict:
    """Phase 6j: the social grid of 6f and the HPS grid of 6e crossed with
    the chaos lane's four fault models (seeds cut to keep K·N = 131,072),
    the social grid crossed with social_learning.py's nine (wake,
    staleness) cells, the Byzantine grid of 6h under the severe model;
    two rows of each against their single runs; timings -> launches."""
    import torch
    from repro_torch.core import (ExecutionPlan, HPSConfig,
                                  make_async_model, make_confused_model,
                                  make_byzantine_runtime, make_hierarchy,
                                  make_hps_runtime, make_social_runtime,
                                  run_byzantine_grid, run_byzantine_runtime,
                                  run_hps_grid, run_hps_runtime,
                                  run_social_grid, run_social_runtime,
                                  stack_runtimes)
    from repro_torch.core import faults as fa
    T = T_MAIN
    faults = chaos_models()
    seeds = list(range(GRID_SEEDS // len(faults)))
    out = {}
    # ---- the social grid of 6f x the four fault models ----
    base, cfgs = hps_grid_configs([8] * GRID_NETS, (0.0, 0.3, 0.6, 0.9),
                                  (4, 8), B=4)
    N, M = base.topo.N, base.topo.M
    model = make_confused_model(N=N, m=3, truth=1, confusion=0.5)
    plan = ExecutionPlan(store="log_ratio", faults=faults)
    _zero_counts()
    t0 = time.perf_counter()
    res = run_social_grid(model, cfgs, T, seeds, plan=plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    K = res.K
    log(f"[planes grid] social: {len(cfgs)} configs x {len(seeds)} seeds x "
        f"{len(faults)} fault models = {K} scenarios of N={N}, T={T}: "
        f"{wall:.2f} s, launches {counts}")
    require(K * N == N_FULL and res.fault.tolist() == list(range(4)) * (
        K // 4), "social x faults grid: K·N = 131,072, fault-minor rows")
    require(counts == _only(edge_scatter=T, edge_scatter_tiled=T,
                            social_innov=T),
            "social x faults grid: K1 and K2 launched T times for all K")
    require(bool(torch.isfinite(res.beliefs).all())
            and bool(torch.isfinite(res.log_ratio).all()),
            "social x faults grid: finite")
    out["social_faults"] = counts
    rows = (0, K - 1)
    E = make_social_runtime(cfgs[0]).src.shape[0]
    plane_grid_rows("social x faults grid", "social", res, rows,
                    (faults, None), N, E, T, dev)
    for k in rows:
        cfg, seed = cfgs[int(res.cfg[k])], int(res.seed[k])
        one = run_social_runtime(
            model, make_social_runtime(cfg), M, T, seed=seed,
            signal_seed=seed, plan=ExecutionPlan(
                store="log_ratio", faults=faults[int(res.fault[k])]))
        top2 = one.beliefs.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2e-2
        gaps = hold_rows(f"social x faults row {k}", {
            "beliefs": (res.beliefs[k][clear], one.beliefs[clear])},
            dict(rtol=0, atol=1e-3))
        require(torch.equal(res.beliefs[k].argmax(-1)[clear],
                            one.beliefs.argmax(-1)[clear]),
                f"social x faults row {k}: decisions equal to its single "
                f"run's")
        log(f"[planes grid] social row {k} (drop {cfg.drop_prob:.2g}, Γ "
            f"{cfg.gamma_period}, seed {seed}, fault {int(res.fault[k])}) "
            f"against its single run: fault draws bit-equal; {gaps} on "
            f"{int(clear.sum())}/{N} clear agents, decisions equal")

    # ---- the HPS grid of 6e x the four fault models ----
    hbase, hcfgs = hps_grid_configs([8] * GRID_NETS, (0.0, 0.1, 0.3, 0.6),
                                    (4, 8), B=4)
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=(N, A1_D)).astype(np.float32)).to(dev)
    hplan = ExecutionPlan(store="gap", faults=faults)
    _zero_counts()
    t0 = time.perf_counter()
    hres = run_hps_grid(w, hcfgs, T, seeds, plan=hplan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    log(f"[planes grid] HPS: {len(hcfgs)} configs x {len(seeds)} seeds x "
        f"{len(faults)} fault models = {hres.K} scenarios of N={N}, "
        f"d={A1_D}, T={T}: {wall:.2f} s, launches {counts}")
    require(counts == _only(edge_scatter=T, edge_scatter_tiled=T),
            "HPS x faults grid: K1 launched T times for all K")
    require(bool(torch.isfinite(hres.gap).all())
            and bool(torch.isfinite(hres.ratio).all()),
            "HPS x faults grid: finite")
    out["hps_faults"] = counts
    hE = make_hps_runtime(hcfgs[0]).src.shape[0]
    plane_grid_rows("HPS x faults grid", "hps", hres, rows,
                    (faults, None), N, hE, T, dev)
    for k in rows:
        cfg, seed = hcfgs[int(hres.cfg[k])], int(hres.seed[k])
        one = run_hps_runtime(w, make_hps_runtime(cfg), T, seed=seed,
                              plan=ExecutionPlan(
                                  store="gap",
                                  faults=faults[int(hres.fault[k])]))
        gaps = hold_rows(f"HPS x faults row {k}", {
            "gap curve": (hres.gap[k], one.gap)}, HPS_ROW_TOL)
        log(f"[planes grid] HPS row {k} (drop {cfg.drop_prob:.2g}, Γ "
            f"{cfg.gamma_period}, seed {seed}, fault {int(hres.fault[k])}) "
            f"against its single run: fault draws bit-equal; {gaps}")

    # ---- benchmarks/social_learning.py:244-250's nine async cells ----
    topo = make_hierarchy([6, 6, 6], topology="complete", seed=0)
    amodel = make_confused_model(N=topo.N, m=3, truth=1, confusion=0.5,
                                 seed=0)
    acfg = HPSConfig(topo=topo, gamma_period=8, B=1_000_000, drop_prob=0.1)
    wakes, stales = (1.0, 0.9, 0.6), (0, 2, 8)
    ams = [make_async_model(q, s) for q in wakes for s in stales]
    aT = 600
    _zero_counts()
    t0 = time.perf_counter()
    ares = run_social_grid(amodel, [acfg], aT, [0, 1, 2, 3], plan=ExecutionPlan(
        store="log_ratio", async_=ams))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    log(f"[planes grid] social x async: 9 (wake, staleness) cells x 4 seeds "
        f"= {ares.K} scenarios of N=18, T={aT}: {wall:.2f} s, launches "
        f"{counts}")
    require(counts == _only(edge_scatter=aT, edge_scatter_tiled=aT,
                            edge_scatter_edge_rows=aT, social_innov=aT),
            "social x async grid: K1 (identity-source route) and K2 "
            "launched T times for all K")
    require(bool(torch.isfinite(ares.log_ratio).all()),
            "social x async grid: finite")
    out["social_async"] = counts
    arows = (0, ares.K - 1)
    plane_grid_rows("social x async grid", "social", ares, arows,
                    (None, ams), 18, make_social_runtime(acfg).src.shape[0],
                    aT, dev)
    for k in arows:
        seed = int(ares.seed[k])
        one = run_social_runtime(
            amodel, make_social_runtime(acfg), topo.M, aT, seed=seed,
            signal_seed=seed, plan=ExecutionPlan(
                store="log_ratio", async_=ams[int(ares.async_[k])]))
        gaps = hold_rows(f"social x async row {k}", {
            "log ratio": (ares.log_ratio[k], one.log_ratio)},
            dict(rtol=1e-3, atol=1e-2))
        log(f"[planes grid] social x async row {k} (cell "
            f"{int(ares.async_[k])}, seed {seed}) against its single run: "
            f"wake draws bit-equal; {gaps}")
    med = [float(ares.log_ratio[a::9, -1].median()) for a in range(9)]
    log("[planes grid] social x async: median final worst log ratio by "
        "(wake, staleness): " + " ".join(
            f"({q}, {s}) {m:+.2f}" for (q, s), m in zip(
                [(q, s) for q in wakes for s in stales], med)))

    # ---- the Byzantine grid of 6h under the severe model ----
    bmodel, bcfgs = byz_grid_setup()
    bplan = ExecutionPlan(store="decisions", faults=plane_plans()[
        "severe"].faults)
    bseeds = list(range(BYZ_GRID_SEEDS))
    _zero_counts()
    t0 = time.perf_counter()
    bres = run_byzantine_grid(bmodel, bcfgs, T, bseeds, plan=bplan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    log(f"[planes grid] Byzantine under severe: {bres.K} scenarios of "
        f"N={N}, T={T}: {wall:.2f} s, launches {counts}")
    require(counts == _only(byz_trim=T, byz_trim_tensor_f=T),
            "Byzantine x severe grid: K3 launched T times for all K, with F "
            "per receiver")
    require(bool(torch.isfinite(bres.r).all())
            and bres.fault.tolist() == [0] * bres.K,
            "Byzantine x severe grid: finite, the fault column all zeros")
    out["byzantine_faults"] = counts
    per_cfg = [make_byzantine_runtime(bmodel, c)[0] for c in bcfgs]
    brt = stack_runtimes([per_cfg[int(c)] for c in bres.cfg])
    normal = ~brt.byz_mask.view(bres.K, N).to(dev)
    from repro_torch.core.prng import Key, fold_rounds, prng_key
    for t in (0, T - 1):
        fk = [fold_rounds(Key(np.zeros(bres.K, np.int64), bres.seed.numpy()),
                          [fa.fault_stream_fold(t, fa.ENGINE_BYZANTINE, s)],
                          dev) for s in (fa.FAULT_EDGE, fa.FAULT_CHURN)]
        fs_b, drop_b = fa.advance_faults_nbr(
            Key(fk[0].k0[0], fk[0].k1[0]), Key(fk[1].k0[0], fk[1].k1[0]),
            bplan.faults.to(dev), fa.init_fault_state(
                bres.K * N, tuple(brt.nbr_idx.shape), dev))
        for k in rows:
            fs1, drop1 = fa.step_faults_nbr(
                prng_key(int(bres.seed[k])), t, bplan.faults.to(dev),
                fa.init_fault_state(N, tuple(brt.nbr_idx[:N].shape), dev),
                engine=fa.ENGINE_BYZANTINE)
            n = slice(k * N, (k + 1) * N)
            require(torch.equal(fs_b.edge_bad[n], fs1.edge_bad)
                    and torch.equal(fs_b.node_live[n], fs1.node_live)
                    and torch.equal(drop_b[n], drop1),
                    f"Byzantine x severe row {k}: slot, liveness and drop "
                    f"draws of round {t} bit-equal to its single run's")
    for k in rows:
        cfg, seed = bcfgs[int(bres.cfg[k])], int(bres.seed[k])
        one = run_byzantine_runtime(bmodel, per_cfg[int(bres.cfg[k])], None,
                                    M, cfg.attack, T, seed=seed, plan=bplan)
        gaps = hold_byz(f"Byzantine x severe row {k} vs its single run",
                        bres.r[k:k + 1], one.r[None],
                        bres.decisions[k:k + 1, -1], one.decisions[None, -1],
                        normal[k:k + 1])
        log(f"[planes grid] Byzantine row {k} (F {cfg.F}, Γ "
            f"{cfg.gamma_period}, seed {seed}) against its single run: "
            f"draws bit-equal; {gaps}")

    # ---- timings: each grid's step, its scenario-step, one scenario alone
    # (the social and Byzantine grids; the HPS grid's faulted step is the
    # single HPS step's, timed in 6i)
    from repro_torch.core.byzantine import _build_scan
    from repro_torch.core.prng import Key
    from repro_torch.core.social import _social_scan_core
    srt = stack_runtimes([make_social_runtime(cfgs[int(c)])
                          for c in res.cfg]).to(dev)
    skeys = Key(np.zeros(K, np.int64), res.seed.numpy())
    sfm = fa.stack_fault_models([faults[int(i)] for i in res.fault])
    tables = model.tables.to(dev)
    lt, cdf = torch.log(tables), torch.cumsum(tables[:, 1, :], dim=-1)
    one_s = make_social_runtime(cfgs[0]).to(dev)
    grid_timing("social x faults", lambda T: _social_scan_core(
        skeys, skeys, srt, lt, cdf, truth=1, M=M, T=T, store="final",
        backend="auto", faults=sfm), lambda T: run_social_runtime(
        model, one_s, M, T, seed=0, plan=ExecutionPlan(
            store="final", faults=faults[0])), K, N)
    bkeys = Key(np.zeros(bres.K, np.int64), bres.seed.numpy())
    brt_d = brt.to(dev)
    one_b = per_cfg[2].to(dev)
    grid_timing("byzantine x severe", lambda T: _build_scan(
        bmodel, brt_d, None, M, bcfgs[0].attack, T, mode="pairwise",
        core="sparse", backend="auto", store="final", device=dev,
        faults=bplan.faults)(bkeys), lambda T: run_byzantine_runtime(
        bmodel, one_b, None, M, bcfgs[0].attack, T, seed=0,
        plan=bplan.replace(store="final")), bres.K, N, profile=False)
    return out


# ---------------------------------------------------------------------------
# Phase 6k: the precision policy (core/precision.py): K1-K3's half-storage
# variants, the four engines and the HPS grid under bf16
# ---------------------------------------------------------------------------

HALF = ("bfloat16", "float16")
EPS_BF16 = 2.0 ** -8             # bfloat16's unit roundoff
# tests/test_bf16_envelope.py's constants: the bf16 policy's mass drift
# (x EPS x T) and consensus-gap perturbation (x EPS x spread(w)) at T = 32
C_MASS, C_GAP, ENVELOPE_T = 2.0, 32.0, 32
# rounds of the bf16 engine runs: the envelope's horizon. bf16 storage is
# for short windows: past ~2^8 increments of a cumulative relay counter a
# round's delivery rounds away (tests/test_bf16_envelope.py's horizon
# cliff); at T = 100 the main cells under bf16 lost 70% of their mass
PREC_T = ENVELOPE_T


def half_dtype(name: str):
    import torch
    return getattr(torch, name)


def k1_half_hold(what, k1, dst, tiled, st) -> float:
    """One K1 call on ``st`` storage held against the plain version:
    rho_new bit-equal, recv (float32) bit-equal to the float32 edge-order
    sum of the upcast storage differences and within K1's float32 limits
    of the plain version's index_add_ -> the largest error against it."""
    import torch
    from repro_torch.kernels.pushsum_edge import (edge_scatter_cuda,
                                                  edge_scatter_ref)
    a = (k1[0].to(st), k1[1].to(st), *k1[2:])
    before = edge_scatter_cuda.launches_half
    rho_k, recv_k = edge_scatter_cuda(*a, tiled=tiled)
    rho_p, recv_p = edge_scatter_ref(*a[:4], dst, n_recv=a[4].numel() - 1,
                                     accum_dtype=torch.float32)
    want = edge_order_recv(rho_p.float(), a[1].float(), a[4])
    torch.cuda.synchronize()
    require(edge_scatter_cuda.launches_half == before + 1,
            f"edge_scatter {what}: counted as a half-storage launch")
    require(rho_k.dtype == st and recv_k.dtype == torch.float32,
            f"edge_scatter {what}: rho_new at storage, recv float32")
    require(torch.equal(rho_k, rho_p), f"edge_scatter {what}: rho_new "
            f"bit-equal")
    require(torch.equal(recv_k, want), f"edge_scatter {what}: recv "
            f"bit-equal to the float32 edge-order sum")
    require(bool(((recv_k - recv_p).abs()
                  <= 1e-5 * recv_p.abs() + 1e-6).all()),
            f"edge_scatter {what}: recv against the plain version")
    return (recv_k - recv_p).abs().max().item()


def half_kernel_checks(dev, args, k1_d5) -> dict:
    """K1, K2 and K3 on half storage at the engines' main shapes, bf16 and
    fp16 -> {kernel: {storage: largest error against the plain
    version}}."""
    import torch
    from repro_torch.kernels.byz_trim import trim_gather_cuda, trim_gather_ref
    from repro_torch.kernels.pushsum_edge import dst_offsets
    from repro_torch.kernels.social_innov import (innovation_cuda,
                                                  innovation_ref)
    out = {"edge_scatter": {}, "social_innov": {}, "byz_trim": {}}
    hps_k1, hps_dst = k1_d5["hps"]
    N, E = hps_k1[4].numel() - 1, hps_k1[1].shape[0]
    g = torch.Generator(device=dev).manual_seed(12)
    snap = torch.randn((E, A1_D + 1), generator=g, device=dev)
    ident = torch.arange(E, dtype=torch.int32, device=dev)
    ident_k1 = (snap, hps_k1[1], hps_k1[2], ident, hps_k1[4])
    for name in HALF:
        st = half_dtype(name)
        errs = [k1_half_hold(f"{name} D=4 main shape tiled={t}",
                             args["k1"], args["dst"], t, st)
                for t in (None, False)]
        errs += [k1_half_hold(f"{name} D=5 HPS shape tiled={t}", hps_k1,
                              hps_dst, t, st) for t in (None, False)]
        errs.append(k1_half_hold(f"{name} identity-source route, HPS shape",
                                 ident_k1, hps_dst, None, st))
        out["edge_scatter"][name] = max(errs)
        # K2: storage-typed z and mass, float32 u, cdf and tables
        z, mass, u, cdf, lt = args["k2"]
        a = (z.to(st), mass.to(st), u, cdf, lt)
        before = innovation_cuda.launches_half
        zk, mu_k = innovation_cuda(*a)
        zp, mu_p = innovation_ref(*a, accum_dtype=torch.float32)
        torch.cuda.synchronize()
        require(innovation_cuda.launches_half == before + 1,
                f"social_innov {name}: counted as a half-storage launch")
        require(zk.dtype == st and mu_k.dtype == torch.float32,
                f"social_innov {name}: z_new at storage, mu float32")
        require(torch.equal(zk, zp), f"social_innov {name}: z_new "
                f"bit-equal")
        torch.testing.assert_close(mu_k, mu_p, rtol=1e-5, atol=1e-6)
        require(bool(torch.isfinite(mu_k).all()), f"social_innov {name}: "
                f"finite")
        out["social_innov"][name] = (mu_k - mu_p).abs().max().item()
        # K3: storage-typed r and lies (stride 0), an int F and F per
        # receiver (the grids' form)
        r, idx, valid, lies, byz, F = args["k3"]
        r_h = r.to(st)
        lies_h = torch.full((), 1e3, dtype=st, device=dev).expand(lies.shape)
        f_recv = torch.from_numpy(np.random.default_rng(13).integers(
            0, 4, size=r.shape[0]).astype(np.int32)).to(dev)
        worst = 0.0
        for label, FF in (("int F", F), ("F per receiver", f_recv)):
            before = trim_gather_cuda.launches_half
            tk, kk = trim_gather_cuda(r_h, idx, valid, lies_h, byz, FF)
            tp, kp = trim_gather_ref(r_h, idx, valid, lies_h, byz, FF,
                                     accum_dtype=torch.float32)
            want = rank_order_tsum(r_h.float(), idx, valid, lies_h.float(),
                                   byz, FF)
            bnd, fin = trim_sum_bound(r_h.float(), idx, valid,
                                      lies_h.float(), byz, FF)
            torch.cuda.synchronize()
            what = f"trim_gather {name} {label}"
            require(trim_gather_cuda.launches_half == before + 1,
                    f"{what}: counted as a half-storage launch")
            require(tk.dtype == kk.dtype == torch.float32,
                    f"{what}: tsum and kept float32")
            require(torch.equal(kk, kp), f"{what}: kept bit-equal")
            require(same_bits(tk, want), f"{what}: tsum bit-equal to the "
                    f"float32 rank-order sum")
            err = (tk - tp).abs()[fin]
            require(bool((err <= bnd[fin]).all()), f"{what}: tsum within "
                    f"the order bound of the plain version")
            worst = max(worst, err.max().item())
        out["byz_trim"][name] = worst
    log(f"[precision kernels] bf16 and fp16 storage at the main shapes: K1 "
        f"(D = 4 on both kernels, D = 5 at the HPS shape, the "
        f"identity-source route) rho_new bit-equal, recv bit-equal to the "
        f"float32 edge-order sum; K2 z_new bit-equal, mu within rtol 1e-5 "
        f"atol 1e-6; K3 (stride-0 lies, int F and F per receiver) kept "
        f"bit-equal, tsum bit-equal to the float32 rank-order sum; largest "
        f"errors against the plain versions {out}")
    return out


def hold_half_engine(engine: str, k, p, edges, N: int, truth: int,
                     byz=None) -> str:
    """A bf16 run of ``engine`` on the kernels (``k``) against the plain
    path on the card (``p``) -> the gaps, logged."""
    import torch
    from repro_torch.core import sparse_mass_invariant
    if engine == "byzantine":
        normal = ~byz.byz_mask
        require(bool(torch.isfinite(k.r).all()), "bf16 byzantine: finite")
        eye = torch.eye(3, dtype=torch.bool, device=p.r.device)
        worst = torch.where(eye, torch.inf, p.r).min(dim=-1).values
        top2 = worst.topk(2, dim=-1).values
        clear = normal & ((top2[..., 0] - top2[..., 1]) > PREC_BYZ_MARGIN)
        require(torch.equal(k.decisions[-1][clear], p.decisions[-1][clear]),
                "bf16 byzantine: decisions equal where the margin is clear")
        share = ((k.decisions[-1] == truth) & normal & byz.in_C).float() \
            .sum() / (normal & byz.in_C).float().sum()
        return (f"r {(k.r - p.r).abs().max().item():.3e}; final decisions "
                f"equal on {int(clear.sum())}/{int(normal.sum())} normal "
                f"agents with margin > {PREC_BYZ_MARGIN}; normal agents in C "
                f"deciding theta* {share.item():.4f}")
    state_k = k[0] if engine == "pushsum" else k.final_state
    state_p = p[0] if engine == "pushsum" else p.final_state
    require(state_k.zm.dtype == torch.bfloat16, f"bf16 {engine}: state "
            f"stored in bf16")
    require(all(bool(torch.isfinite(x).all()) for x in
                plane_outputs(engine, k) if x.is_floating_point()),
            f"bf16 {engine}: outputs finite")
    inv = sparse_mass_invariant(state_k, *edges)
    mass_dev = abs(inv[-1].item() - N) / N
    if engine == "social":
        bk, bp = k.beliefs, p.beliefs
        top2 = bp.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2e-2
        flips = int((bk.argmax(-1) != bp.argmax(-1))[clear].sum())
        require(flips == 0, "bf16 social: decisions equal where the top "
                "two beliefs are more than 2e-2 apart")
        return (f"beliefs {(bk - bp).abs().max().item():.3e}, (z, m) "
                f"{(state_k.zm.float() - state_p.zm.float()).abs().max()
                   .item():.3e}; decisions equal on {int(clear.sum())}/{N} "
                f"clear agents, deciding theta* "
                f"{(bk.argmax(-1) == truth).float().mean().item():.4f}; "
                f"total mass off N by {mass_dev:.3e} of N")
    ratio_k = k[1][-1] if engine == "pushsum" else k.ratio
    ratio_p = p[1][-1] if engine == "pushsum" else p.ratio
    heavy = state_k.m.float() >= PLANE_MASS_FLOOR
    diff = (ratio_k - ratio_p).abs().amax(dim=-1)
    gap = diff[heavy].max().item() if bool(heavy.any()) else 0.0
    # the two paths order the receiver sums (and HPS's pools) otherwise,
    # which can flip a bf16 rounding: 4 bf16 ulps of the ratios' scale
    limit = 4 * EPS_BF16 * ratio_p.abs().max().item()
    require(gap <= limit, f"bf16 {engine}: ratios within {limit:.3e} of "
            f"the plain path where m >= {PLANE_MASS_FLOOR}")
    return (f"final ratios {gap:.3e} (m >= {PLANE_MASS_FLOOR}: "
            f"{int(heavy.sum())} of {N}), all {diff.max().item():.3e}; "
            f"total mass off N by {mass_dev:.3e} of N")


def precision_phase(dev, args, k1_d5, model, rt, M, bmodel, bsetup,
                    battack) -> dict:
    """Phase 6k -> each kernel's largest errors on half storage, its
    launches on the bf16 main paths and its half-storage timings."""
    import torch
    from repro_torch.core import ExecutionPlan
    out = {"errs": half_kernel_checks(dev, args, k1_d5), "launches": {}}
    T, N = PREC_T, N_FULL
    runs = plane_engines(dev, model, rt, M, bmodel, bsetup, battack)
    bf16 = ExecutionPlan(policy="bf16")
    for engine in ("social", "hps", "pushsum", "byzantine"):
        what = f"bf16 {engine}"
        _zero_counts()
        t0 = time.perf_counter()
        res_k = runs[engine](bf16, T)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        if engine == "byzantine":
            want = _only(byz_trim=T, byz_trim_half=T)
        else:
            k2 = ({"social_innov": T, "social_innov_half": T}
                  if engine == "social" else {})
            want = _only(edge_scatter=T, edge_scatter_tiled=T,
                         edge_scatter_half=T, **k2)
        require(counts == want, f"{what}: each kernel of the engine "
                f"launched T times, on half storage")
        for name, c in counts.items():
            if c:
                out["launches"].setdefault(name, {})[engine] = c
        res_p = runs[engine](bf16.replace(backend="torch"), T)
        torch.cuda.synchronize()
        require(_counts() == counts, f"{what}: the plain path launched no "
                f"kernel")
        gaps = hold_half_engine(engine, res_k, res_p,
                                runs["_edges"].get(engine), N,
                                bmodel.truth if engine == "byzantine"
                                else model.truth, byz=runs["_byz"])
        log(f"[precision] {engine} N={N} T={T} under policy bf16: kernels "
            f"{wall:.2f} s, launches {counts}; kernel vs plain: {gaps}")
    # policy="fp32" is the pre-policy program on the kernel path
    Td = PLANE_T_DEGENERATE
    for engine in ("social", "hps", "pushsum", "byzantine"):
        base = plane_outputs(engine, runs[engine](ExecutionPlan(), Td))
        got = plane_outputs(engine, runs[engine](
            ExecutionPlan(policy="fp32"), Td))
        require(all(torch.equal(a, b) for a, b in zip(base, got)),
                f"{engine}: policy fp32 bit-equal to no policy on the "
                f"kernel path")
    log(f"[precision] policy fp32 through the four engines on the kernel "
        f"path, T={Td}: bit-equal to policy None")
    envelope_phase(dev)
    out["hps_grid"] = half_hps_grid(dev)
    out["times"] = half_times(dev, args, k1_d5, runs)
    return out


def envelope_scenarios(k: int, seed: int):
    """tests/test_bf16_envelope.py's scenario draws: k (drop, Γ, topology,
    seed) from one seeded generator."""
    rng = np.random.default_rng(seed)
    return [(float(rng.uniform(0.0, 0.6)), int(rng.choice([2, 4, 8, 16])),
             ("ring", "complete", "ring+")[int(rng.integers(3))],
             int(rng.integers(1000))) for _ in range(k)]


def envelope_phase(dev) -> None:
    """tests/test_bf16_envelope.py's T = 32 envelope on the kernel path,
    its scenarios drawn as the test draws them (three 5-agent networks):
    each run under fp32 and bf16; on the mass test's ten scenarios the
    bf16 run's relative drift of the value invariant within C_MASS * EPS *
    T and the fp32 run's within 1e-5, on the gap test's ten the final gaps
    within C_GAP * EPS * spread(w). Then the same two figures at the HPS
    main cell (N = 131,072), logged: the constants were calibrated on 15
    agents, and the gap is a maximum over the agents."""
    import torch
    from repro_torch.core import (ExecutionPlan, HPSConfig, make_hierarchy,
                                  make_hps_runtime, run_hps_runtime,
                                  sparse_mass_invariant)
    T = ENVELOPE_T

    def pair(rt_, w, seed):
        res = {p: run_hps_runtime(w, rt_, T, seed=seed, plan=ExecutionPlan(
            store="gap", dst_sorted=True, policy=p)) for p in (None, "bf16")}
        drift = {}
        for p, r in res.items():
            inv = sparse_mass_invariant(r.final_state, rt_.src, rt_.valid)
            drift[p] = ((inv[:-1] - w.sum(0)).abs()
                        / w.abs().sum(0).clamp_min(1e-6)).max().item()
        gap = abs(res["bf16"].gap[-1].item() - res[None].gap[-1].item())
        return drift, gap, (w.max() - w.min()).item(), res

    def cell(drop, gamma, topology, seed):
        topo = make_hierarchy([5, 5, 5], topology=topology, seed=seed)
        cfg = HPSConfig(topo=topo, gamma_period=gamma, B=4, drop_prob=drop)
        w = torch.from_numpy(np.random.default_rng(seed).normal(
            size=(topo.N, 3)).astype(np.float32)).to(dev)
        return make_hps_runtime(cfg).to(dev), w, seed

    worst_drift = worst_gap = 0.0
    for sc in envelope_scenarios(10, seed=7):
        drift, _, _, _ = pair(*cell(*sc))
        require(drift[None] <= 1e-5, f"envelope {sc}: fp32 drift at "
                f"roundoff")
        require(drift["bf16"] <= C_MASS * EPS_BF16 * T,
                f"envelope {sc}: bf16 mass drift within C_MASS EPS T")
        worst_drift = max(worst_drift, drift["bf16"] / (EPS_BF16 * T))
    for sc in envelope_scenarios(10, seed=11):
        _, gap, spread, _ = pair(*cell(*sc))
        require(gap <= C_GAP * EPS_BF16 * spread, f"envelope {sc}: gap "
                f"perturbation within C_GAP EPS spread(w)")
        worst_gap = max(worst_gap, gap / (EPS_BF16 * spread))
    hrt, hw = hps_scenario(N_FULL)
    drift, gap, spread, res = pair(hrt.to(dev), torch.from_numpy(hw).to(dev),
                                   0)
    log(f"[precision] envelope on the kernel path, T={T}: worst bf16 mass "
        f"drift {worst_drift:.3f} EPS T over the mass test's ten scenarios "
        f"(C_MASS {C_MASS}), worst gap perturbation {worst_gap:.3f} EPS "
        f"spread over the gap test's ten (C_GAP {C_GAP}); at the HPS main "
        f"cell (N={N_FULL}): bf16 drift {drift['bf16'] / (EPS_BF16 * T):.3f}"
        f" EPS T (fp32 {drift[None]:.3e}), gap bf16 "
        f"{res['bf16'].gap[-1].item():.5f} vs fp32 "
        f"{res[None].gap[-1].item():.5f}: {gap / (EPS_BF16 * spread):.3f} "
        f"EPS spread")


def half_hps_grid(dev) -> dict:
    """The HPS grid of 6e under policy bf16: 64 scenarios as one graph of
    131,072 nodes, K1 launching once a round for all of them on half
    storage; each row's final gap against the plain path's -> the
    launches."""
    import torch
    from repro_torch.core import ExecutionPlan, run_hps_grid
    T = PREC_T
    base, cfgs = hps_grid_configs([8] * GRID_NETS, (0.0, 0.1, 0.3, 0.6),
                                  (4, 8), B=4)
    N = base.topo.N
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=(N, A1_D)).astype(np.float32)).to(dev)
    plan = ExecutionPlan(store="gap", policy="bf16")
    _zero_counts()
    t0 = time.perf_counter()
    res = run_hps_grid(w, cfgs, T, list(range(GRID_SEEDS)), plan=plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    require(res.K * N == N_FULL, "bf16 HPS grid: K·N = 131,072")
    require(counts == _only(edge_scatter=T, edge_scatter_tiled=T,
                            edge_scatter_half=T),
            "bf16 HPS grid: K1 launched T times for all K scenarios, on "
            "half storage")
    res_p = run_hps_grid(w, cfgs, T, list(range(GRID_SEEDS)),
                         plan=plan.replace(backend="torch"))
    torch.cuda.synchronize()
    require(_counts() == counts, "bf16 HPS grid: the plain path launched "
            "no kernel")
    require(bool(torch.isfinite(res.gap).all()), "bf16 HPS grid: finite")
    d_gap = (res.gap - res_p.gap).abs().max().item()
    log(f"[precision] HPS grid of 6e under bf16: {res.K} scenarios of "
        f"N={N}, T={T}: {wall:.2f} s, launches {counts}; gap curves against "
        f"the plain path {d_gap:.3e}; final gap range "
        f"{res.gap[:, -1].min().item():.4f}..{res.gap[:, -1].max().item():.4f}")
    return {"launches": counts["edge_scatter_half"]}


def half_times(dev, args, k1_d5, runs) -> dict:
    """Each half-storage variant's device time with the host hidden (L2
    flushed) beside its float32 kernel's in the same process and its
    bound; then ms a step of the four engines under bf16 and fp32, in
    turns -> {kernel: {storage: {ms, fp32_ms, bound_ms, bound_by}}}."""
    import torch
    from repro_torch.core import ExecutionPlan
    from repro_torch.kernels.byz_trim import trim_gather_cuda
    from repro_torch.kernels.pushsum_edge import edge_scatter_cuda
    from repro_torch.kernels.social_innov import innovation_cuda
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev).zero_
    out = {"edge_scatter": {}, "edge_scatter_d5": {}, "social_innov": {},
           "byz_trim": {}}
    k1, k1_5 = args["k1"], k1_d5["hps"][0]
    z, mass, u, cdf, lt = args["k2"]
    r, idx, valid, lies, byz, F = args["k3"]
    N, m_hyp, S = z.shape[0], z.shape[1], cdf.shape[1]
    dm, P = idx.shape[1], r.shape[1]
    k3_ops = N * P * dm * (2 * BYZ_F + 1)

    def timed(fn, inputs, outputs, ops):
        ms = event_ms(fn, TIMED_RUNS, flush, hide_host=True)
        b_ms, by = bound(nbytes(*inputs, *outputs), ops)
        return {"ms": ms, "bound_ms": b_ms, "bound_by": by}

    for name in ("float32",) + HALF:
        st = half_dtype(name)
        for key, a in (("edge_scatter", k1), ("edge_scatter_d5", k1_5)):
            ah = (a[0].to(st), a[1].to(st), *a[2:])
            o = edge_scatter_cuda(*ah)
            E, D = ah[1].shape
            out[key][name] = timed(lambda ah=ah: edge_scatter_cuda(*ah), ah,
                                   o, 2 * E * D)
        a2 = (z.to(st), mass.to(st), u, cdf, lt)
        o = innovation_cuda(*a2)
        out["social_innov"][name] = timed(lambda: innovation_cuda(*a2), a2,
                                          o, N * (S + m_hyp * 8))
        r_h = r.to(st)
        lies_h = torch.full((), 1e3, dtype=st, device=dev).expand(lies.shape)
        a3 = (r_h, idx, valid, lies_h, byz, F)
        o = trim_gather_cuda(*a3)
        out["byz_trim"][name] = timed(lambda: trim_gather_cuda(*a3),
                                      (r_h, idx, valid, byz), o, k3_ops)
        out["byz_trim"][name]["bound_ms"] += st.itemsize / HBM_BYTES_PER_S \
            * 1e3                         # the one stride-0 lie
    for key, t in out.items():
        log(f"[timing] {key} by storage, device ms with the host hidden "
            f"(median of {TIMED_RUNS}, L2 flushed) and bound: " + "; ".join(
                f"{name} {v['ms']:.5f} (bound {v['bound_ms']:.5f}, "
                f"{v['bound_by']})" for name, v in t.items()))
    plans = {"fp32": ExecutionPlan(), "bf16": ExecutionPlan(policy="bf16")}
    steps = {}
    for engine in ("social", "hps", "pushsum", "byzantine"):
        fn = runs[engine]
        ms = turns_ms({p: (lambda T, p=p, fn=fn: fn(plans[p], T))
                       for p in plans})
        steps[engine] = ms
        log(f"[timing] {engine} at N={N_FULL}, kernel path: fp32 "
            f"{ms['fp32']:.4f} ms, bf16 {ms['bf16']:.4f} ms a step (in "
            f"turns, median of {SWEEP_RUNS} runs of {STEP_T} steps)")
        if engine in ("social", "byzantine"):
            profile_step(lambda T, fn=fn: fn(plans["bf16"], T),
                         f"{engine} bf16 N={N_FULL}", ms["bf16"])
    out["steps"] = steps
    return out


def quickstart_torch_phase() -> None:
    """examples/quickstart_torch.py on the card: every section's asserts,
    and the launches of K1 (on its identity-source route in the async
    grid), K2 and K3 its loops make."""
    import importlib.util
    import torch
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _zero_counts()
    t0 = time.perf_counter()
    mod.main()
    torch.cuda.synchronize()
    counts = _counts()
    log(f"[quickstart_torch] all sections passed in "
        f"{time.perf_counter() - t0:.2f} s, launches {counts}")
    # Alg. 3 500 + sweep 300 + HPS grid 2000 + phase diagram 400 + async
    # 400 rounds of K1; Alg. 3, the phase diagram and async of K2; Alg. 2
    require(counts == _only(edge_scatter=3600, edge_scatter_tiled=3600,
                            edge_scatter_edge_rows=400, social_innov=1300,
                            byz_trim=500),
            "quickstart_torch: each loop's kernels launched once a round")


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
    started = [time.perf_counter()]

    def lap(done: str) -> None:
        """Log the seconds since the last lap, which ``done`` took."""
        now = time.perf_counter()
        log(f"[phase] {done}: {now - started[0]:.1f} s")
        started[0] = now

    # ---- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {len(built)} kernels in {time.perf_counter() - t0:.2f} s")
    for b in built.values():
        ptxas = [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {b.name}: {b.seconds:.2f} s -> {b.path.name}; "
            + " | ".join(ptxas))
    # K1-K3 by storage type: float, __nv_bfloat16, __half
    storage = ("f", "13__nv_bfloat16", "6__half")
    for name, kernel in (
            *(("trimmed_mean", f"trimmed_mean_kernelILi{w}E")
              for w in (4, 8, 16, 32, 64)),
            *(("edge_scatter", f"edge_scatter_tiledI{t}Li{v}E")
              for t in storage for v in (4, 1)),
            *(("edge_scatter", f"edge_scatter_walkI{t}E") for t in storage),
            *(("byz_trim", f"trim_gather_kernelI{t}Li{w}E")
              for t in storage for w in (8, 16, 32, 64)),
            *(("social_innov", f"social_innov_stagedI{t}E")
              for t in storage)):
        report = ptxas_report(built[name].log, kernel)
        log(f"[build] ptxas, {kernel}: {report}")
        require(report.count("0 bytes spill stores") == 1
                and report.count("0 bytes spill loads") == 1,
                f"{kernel} built, with no spills")
    for name, kernel in (("swa_prefill", "swa_prefill_tc_kernelILi64"),
                         ("swa_prefill", "swa_prefill_tc_kernelILi128"),
                         ("wkv6", "wkv6_group_statesI13__nv_bfloat16"),
                         ("wkv6", "wkv6_group_statesIf"),
                         ("wkv6", "wkv6_group_scan"),
                         ("wkv6", "wkv6_group_outputsI13__nv_bfloat16"),
                         ("wkv6", "wkv6_group_outputsIf"),
                         ("attn_decode", "attn_decode_tc_kernelILi64ELi16"),
                         ("attn_decode", "attn_decode_tc_kernelILi128ELi8"),
                         ("attn_decode", "attn_decode_tc_kernelILi128ELi16"),
                         ("attn_decode", "attn_decode_tc_kernelILi256ELi8"),
                         ("attn_decode", "attn_decode_tc_kernelILi256ELi16"),
                         ("attn_decode", "attn_decode_splitIfLi256ELi8")):
        log(f"[build] ptxas, {kernel}: "
            f"{ptxas_report(built[name].log, kernel)}")
    for name, op, what in (("swa_prefill", "HGMMA", "K6's tensor-core kernel"),
                           ("wkv6", "HMMA", "K7's passes 1 and 3"),
                           ("attn_decode", "HMMA",
                            "K5's tensor-core kernel")):
        n_mma = sass_count(built[name].path, ("HGMMA", "HMMA"))
        log(f"[build] {name} SASS (cuobjdump -sass): {n_mma['HGMMA']} "
            f"HGMMA and {n_mma['HMMA']} HMMA instructions")
        require(n_mma[op] > 0, f"{what} issue tensor-core instructions")

    # ---- set-up at full size -------------------------------------------
    t0 = time.perf_counter()
    model, rt, M = scenario(N_FULL)
    rt_d = rt.to(dev)
    N, E = N_FULL, rt.src.shape[0]
    log(f"[setup] N={N} E={E} M={M} in {time.perf_counter() - t0:.2f} s")
    require(E == 917_504, "E == 917,504")
    t0 = time.perf_counter()
    bmodel, bsetup, battack = byz_scenario(N_FULL)
    brt_d = bsetup[0].to(dev)
    dm = brt_d.nbr_idx.shape[1]
    n_c = int(brt_d.in_C.sum()) // 8
    log(f"[setup] byzantine runtime N={N} deg_max={dm} networks in C "
        f"{n_c}/{M} n_reps={bsetup[2]} (dense-free) in "
        f"{time.perf_counter() - t0:.2f} s")
    require(dm == 7 and bsetup[1] is None and 0 < n_c < M,
            "byzantine set-up: deg_max 7, one rep per network, some "
            "networks outside C")

    lap("phases 1 and set-up")
    # ---- phase 2: kernels against their plain versions ------------------
    args = engine_args(dev, model, rt_d, brt_d)
    k1_err = edge_scatter_checks(dev, args)

    k2_err = innovation_checks(dev, args["k2"])
    k3_err = trim_gather_checks(dev, args)
    m_hyp = model.m

    lap("phase 2")
    # ---- phase 3: the main path at full size ----------------------------
    plan_k = ExecutionPlan(store="log_ratio", dst_sorted=True)
    plan_p = plan_k.replace(backend="torch")
    _zero_counts()
    t0 = time.perf_counter()
    res_k = run_social_runtime(model, rt, M, T_MAIN, seed=0, plan=plan_k)
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    launches = _counts()
    log(f"[main] N={N} T={T_MAIN} kernels: {wall_k:.2f} s, launches "
        f"{launches}")
    require(launches == _only(edge_scatter=T_MAIN,
                              edge_scatter_tiled=T_MAIN,
                              social_innov=T_MAIN),
            "each kernel of the path launched T times on the main path, K1 "
            "on its edge-tiled kernel")
    res_p = run_social_runtime(model, rt, M, T_MAIN, seed=0, plan=plan_p)
    res_p2 = run_social_runtime(model, rt, M, T_MAIN, seed=0, plan=plan_p)
    torch.cuda.synchronize()
    require(_counts() == launches, "the plain path launched no kernel")
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

    lap("phase 3")
    # ---- phase 4: quickstart scenario -----------------------------------
    topo = make_hierarchy([6, 6, 6], topology="complete", seed=0)
    qmodel = make_confused_model(N=topo.N, m=3, truth=1, confusion=0.5,
                                 seed=0)
    qcfg = HPSConfig(topo=topo, gamma_period=8, B=4, drop_prob=0.3)
    _zero_counts()
    qres = run_social_learning(qmodel, qcfg, T=500, seed=0)
    torch.cuda.synchronize()
    require(_counts() == _only(edge_scatter=500, edge_scatter_tiled=500,
                               social_innov=500),
            "quickstart launches")
    qmin = qres.beliefs[-1, :, qmodel.truth].min().item()
    log(f"[quickstart] min final belief in theta*: {qmin:.6f}")
    require(qmin > 0.95, "quickstart learns theta*")

    lap("phase 4")
    # ---- phase 5: the Byzantine main path at full size ------------------
    launches["byz_trim"] = byzantine_main(bmodel, bsetup, battack, dev)

    lap("phase 5")
    # ---- phase 6: Byzantine oracle scenarios ------------------------------
    byzantine_oracles(dev)

    lap("phase 6")
    # ---- phases 6a-6d: Algorithm 1, push-sum and HPS, through K1 ----------
    a1 = algorithm1_phases(dev)

    lap("phases 6a-6d")
    # ---- phases 6e-6g: scenario grids as one block-diagonal graph ---------
    sw = sweep_phases(dev)

    lap("phases 6e-6g")
    # ---- phase 6h: Algorithm 2's grid as one neighbor-list graph ---------
    bg = byzantine_grid_phase(dev, sw["flush"])

    lap("phase 6h")
    # ---- phases 6i-6j: the fault and async planes -------------------------
    pl = plane_single_phase(dev, model, rt, M, bmodel, bsetup, battack)
    k1_identity_ms = pl.pop("k1_identity_ms")
    pl.update(plane_grid_phase(dev))
    quickstart_torch_phase()

    lap("phases 6i-6j and quickstart_torch")
    # ---- phase 6k: the precision policy -----------------------------------
    prec = precision_phase(dev, args, a1["k1"], model, rt, M, bmodel, bsetup,
                           battack)

    lap("phase 6k")
    # ---- phase 7: timing ------------------------------------------------
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()   # evict the 50 MB L2 between timed launches

    kt = engine_kernel_times(args, flush)
    kt["byz_trim"]["widths"] = k3_width_times(dev, flush)
    kt["edge_scatter"].update({f"pushsum_sparse_{k}": v for k, v in
                               k1_sparse_times(dev, flush).items()})
    kt["edge_scatter"]["d5"] = k1_d5_times(flush, a1["k1"],
                                           kt["edge_scatter"]["ms"])
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
        profile_step(
            lambda T, pmodel=pmodel, prt=prt, pM=pM: run_social_runtime(
                pmodel, prt, pM, T, seed=0, plan=ExecutionPlan(
                    store="final", dst_sorted=True)),
            f"social N={n_agents}", step_ms[(n_agents, "auto")])
    byzantine_step_timing(bmodel, bsetup, battack, dev)
    algorithm1_step_timing(dev)

    def plane_launches(kernel: str) -> dict:
        """Phases 6i-6j's launches of ``kernel``, by run."""
        return {(k if isinstance(k, str) else " ".join(k)): c[kernel]
                for k, c in pl.items() if c[kernel]}

    kernels = [
        {"name": "edge_scatter", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/edge_scatter.cu",
         "replaces": "src/repro/kernels/pushsum_edge/pushsum_edge.py:114",
         "launches": launches["edge_scatter"],
         "launches_hps": a1["hps_launches"],
         "launches_pushsum": a1["pushsum_launches"],
         "launches_hps_grid": sw["hps_grid"]["launches"],
         "launches_social_grid": sw["social_grid"]["launches"],
         "launches_pushsum_sweep": sw["pushsum_sweep"]["launches"],
         "hps_grid_ms": sw["hps_grid"]["k1_ms"],
         "social_grid_ms": sw["social_grid"]["k1_ms"],
         "pushsum_sweep_ms": sw["pushsum_sweep"]["k1_ms"],
         "launches_planes": plane_launches("edge_scatter"),
         "launches_planes_edge_rows": plane_launches(
             "edge_scatter_edge_rows"),
         "identity_route_ms": k1_identity_ms,
         "max_abs_err": k1_err, "d5_max_abs_err": a1["k1_err"],
         **kt["edge_scatter"], **half_entry(prec, "edge_scatter")},
        {"name": "social_innov", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/social_innov.cu",
         "replaces": "src/repro/kernels/social_innov/social_innov.py:75",
         "launches": launches["social_innov"],
         "launches_social_grid": sw["social_grid"]["k2_launches"],
         "social_grid_ms": sw["social_grid"]["k2_ms"],
         "launches_planes": plane_launches("social_innov"),
         "max_abs_err": k2_err,
         **kt["social_innov"], **half_entry(prec, "social_innov")},
        {"name": "byz_trim", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/byz_trim.cu",
         "replaces": "src/repro/kernels/byz_trim/byz_trim.py:91",
         "launches": launches["byz_trim"], "max_abs_err": k3_err,
         "launches_byzantine_grid": bg["launches"],
         "byzantine_grid_ms": bg["ms"],
         "byzantine_grid_int_f_ms": bg["int_f_ms"],
         "byzantine_grid_bound_ms": bg["bound_ms"],
         "launches_planes": plane_launches("byz_trim"),
         **kt["byz_trim"], **half_entry(prec, "byz_trim")},
    ]
    lap("phase 7")
    kernels += serve_phases(dev, flush)
    lap("phases 8-11")
    kernels.append(rwkv_phases(dev, flush))
    lap("phases 12-15b")
    fam = family_phases(dev, flush, lap)
    by_name = {k["name"]: k for k in kernels}
    for name, what, n in (("attn_decode", "decode", "launches_decode"),
                          ("swa_prefill", "prefill", "launches_prefill")):
        by_name[name]["launches_families"] = {
            f: m[n] for f, m in fam["mains"].items()}
        by_name[name]["rg_256_g10"] = fam["k256"][what]
        by_name[name]["serve_families"] = {
            f: {k: m[k] for k in (f"{what}_ms", f"{what}_plain_ms")}
            for f, m in fam["mains"].items()}
    by_name["attn_decode"]["max_abs_err"] = max(
        by_name["attn_decode"]["max_abs_err"], fam["k256"]["err"])
    kernels.append(train_phases(dev, flush))
    lap("phases 16-18")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def half_entry(prec: dict, name: str) -> dict:
    """Phase 6k's figures of one of K1-K3 for the kernels line: its
    half-storage launches on the bf16 main paths (by engine), and by
    storage its largest error against the plain version, its time with
    the host hidden and its bound (K1 at D = 4, and at D = 5 under
    ``d5``)."""
    launches = prec["launches"].get(f"{name}_half", {})
    out = {"launches_half": sum(launches.values()),
           "launches_half_by_engine": launches, "half": {}}
    for st in HALF:
        out["half"][st] = {"max_abs_err": prec["errs"][name][st],
                           **prec["times"][name][st]}
        if name == "edge_scatter":
            out["half"][st]["d5"] = prec["times"]["edge_scatter_d5"][st]
    if name == "edge_scatter":
        out["launches_half_hps_grid"] = prec["hps_grid"]["launches"]
    return out


def kernel_times(fn, runs: int,
                 flush=None) -> dict[str, tuple[float, int]]:
    """Device milliseconds of one launch of each kernel that ``fn``
    launches, averaged over the launches the profiler recorded, and how
    many it recorded (torch.profiler over ``runs`` calls, ``flush()``
    before each; the flush's own kernel left out): by kernel name without
    namespace or template arguments; empty when the profiler records no
    device time. In a long process the profiler may record fewer launches
    than ran, so the mean is taken over the recorded ones."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    total, count = {}, {}
    for e in prof.key_averages():
        key = e.key.replace("(anonymous namespace)::", "")
        name = key.split("(")[0].split("<")[0].split("::")[-1].split()[-1]
        if e.device_time_total > 0 and "fill" not in key.lower():
            total[name] = total.get(name, 0.0) + e.device_time_total / 1e3
            count[name] = count.get(name, 0) + e.count
    return {n: (total[n] / count[n], count[n]) for n in total}


def profile_step(run, label: str, step_ms: float, steps: int = 20) -> None:
    """Device time by kernel over ``steps`` kernel-path steps
    (torch.profiler) of ``run(T)``, after min(5, steps) unprofiled ones,
    and the share of the unprofiled step time ``step_ms`` it covers."""
    import torch

    run(min(5, steps))
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        run(steps)
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
    log(f"[profile] {steps} steps of {label}: device busy "
        f"{busy:.3f} ms in {sum(r[2] for r in rows)} device ops (run set-up "
        f"included), {busy / steps:.4f} ms a step = "
        f"{busy / steps / step_ms:.3f} of the unprofiled {step_ms:.4f} ms "
        f"step; wall {wall_ms:.1f} ms with the profiler on")
    for key, ms, count in rows[:12]:
        log(f"[profile]   {ms:9.3f} ms  x{count:<5d} {key[:90]}")


def _wrappers() -> dict:
    from repro_torch.kernels.byz_trim import trim_gather_cuda
    from repro_torch.kernels.pushsum_edge import edge_scatter_cuda
    from repro_torch.kernels.social_innov import innovation_cuda
    from repro_torch.kernels.swa import attn_decode_cuda, swa_prefill_cuda
    from repro_torch.kernels.trimmed_mean import trimmed_mean_cuda
    from repro_torch.kernels.wkv6 import wkv6_cuda
    return {"edge_scatter": edge_scatter_cuda,
            "social_innov": innovation_cuda,
            "byz_trim": trim_gather_cuda,
            "attn_decode": attn_decode_cuda,
            "swa_prefill": swa_prefill_cuda,
            "wkv6": wkv6_cuda,
            "trimmed_mean": trimmed_mean_cuda}


# wrappers with two kernels: the calls on one of them, apart (count name:
# wrapper, attribute)
SUB_COUNTS = {"swa_prefill_tc": ("swa_prefill", "launches_tc"),
              "attn_decode_tc": ("attn_decode", "launches_tc"),
              "edge_scatter_tiled": ("edge_scatter", "launches_tiled"),
              "byz_trim_tensor_f": ("byz_trim", "launches_tensor_f"),
              "edge_scatter_edge_rows": ("edge_scatter",
                                         "launches_edge_rows"),
              "edge_scatter_half": ("edge_scatter", "launches_half"),
              "social_innov_half": ("social_innov", "launches_half"),
              "byz_trim_half": ("byz_trim", "launches_half")}


def _zero_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
    for name, attr in SUB_COUNTS.values():
        setattr(_wrappers()[name], attr, 0)


def _counts() -> dict[str, int]:
    """Launches of each wrapper, and of K6's and K5's tensor-core kernels,
    K1's edge-tiled one and K3's calls with F per receiver alone
    (``swa_prefill_tc``, ``attn_decode_tc``, ``edge_scatter_tiled``,
    ``byz_trim_tensor_f``, part of their wrappers' counts)."""
    out = {name: fn.launches for name, fn in _wrappers().items()}
    for key, (name, attr) in SUB_COUNTS.items():
        out[key] = getattr(_wrappers()[name], attr)
    return out


def _only(**launches) -> dict[str, int]:
    """The launch counts of a run that launched only the named kernels."""
    return {name: launches.get(name, 0)
            for name in (*_wrappers(), *SUB_COUNTS)}


def byzantine_main(model, setup, attack, dev) -> int:
    """Algorithm 2 at N = 131,072 for T = 200 rounds through the kernel and
    through the plain path -> the kernel's launches on the kernel run."""
    import torch
    from repro_torch.core import ExecutionPlan, decide, run_byzantine_runtime

    rt, extra_reps, n_reps = setup
    N = rt.byz_mask.shape[0]
    plan_k = ExecutionPlan(store="decisions")
    _zero_counts()
    t0 = time.perf_counter()
    res_k = run_byzantine_runtime(model, rt, extra_reps, n_reps, attack,
                                  T_MAIN, seed=0, plan=plan_k, device=dev)
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    counts = _counts()
    log(f"[byzantine] N={N} T={T_MAIN} F={BYZ_F} kernel path: {wall_k:.2f} "
        f"s, launches {counts}")
    require(counts == _only(byz_trim=T_MAIN),
            "the trim-gather kernel launched T times on the Byzantine path")
    t0 = time.perf_counter()
    res_p = run_byzantine_runtime(model, rt, extra_reps, n_reps, attack,
                                  T_MAIN, seed=0,
                                  plan=plan_k.replace(backend="torch"),
                                  device=dev)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    require(_counts() == counts, "the plain path launched no kernel")
    rk, rp = res_k.r, res_p.r
    require(rk.shape == (N, 3, 3) and res_k.decisions.shape == (T_MAIN, N),
            "byzantine result shapes")
    require(bool(torch.isfinite(rk).all()), "byzantine r finite")
    # Tolerance. The kernel adds each receiver's survivors one by one in
    # rank order, the plain path sums the sorted slots through PyTorch's
    # reduction, another association: about one ulp of a statistic per
    # round, averaged by the gossip, on statistics that grow to ~1.3e4
    # (one ulp there is ~1e-3). The limit atol + rtol*|r| is 1e-2 near 0
    # and ~3.6e-2 at |r| = 1.3e4; H100 runs gave a max gap of 7.8e-3
    # (about 8 ulp at the largest |r|).
    gap = (rk - rp).abs().max().item()
    torch.testing.assert_close(rk, rp, rtol=2e-6, atol=1e-2)
    normal = ~rt.byz_mask.to(dev)
    in_C = rt.in_C.to(dev)
    eye = torch.eye(3, dtype=torch.bool, device=dev)
    worst = torch.where(eye, torch.inf, rp).min(dim=-1).values
    top2 = worst.topk(2, dim=-1).values
    clear = normal & ((top2[:, 0] - top2[:, 1]) > BYZ_MARGIN)
    dk, dp = res_k.decisions[-1], res_p.decisions[-1]
    require(torch.equal(dk, decide(rk)), "final decisions follow r")
    require(torch.equal(dk[clear], dp[clear]),
            "decisions equal where the margin is clear")
    steps_differ = int((res_k.decisions != res_p.decisions).sum())
    truth = model.truth
    share_c = (dk[in_C & normal] == truth).float().mean().item()
    adopted = ~in_C & normal & (rk.abs().amax(dim=(1, 2)) > 0)
    share_adopted = (dk[adopted] == truth).float().mean().item()
    log(f"[byzantine] plain path {wall_p:.2f} s; max |r| gap kernel vs "
        f"plain {gap:.3e} (|r| up to {rp.abs().max().item():.1f}); final "
        f"decisions equal on {int(clear.sum())}/{int(normal.sum())} normal "
        f"agents with margin > {BYZ_MARGIN}; (step, agent) decisions that "
        f"differ over all {T_MAIN} steps: {steps_differ}")
    log(f"[byzantine] share of normal agents in C deciding theta*: "
        f"{share_c:.4f}; representatives outside C that adopted w_tilde: "
        f"{int(adopted.sum())}, share deciding theta* {share_adopted:.4f}")
    require(share_c > 0.99, "normal agents in C learn theta*")
    return counts["byz_trim"]


def byzantine_oracles(dev) -> None:
    """The quickstart Algorithm 2 scenario on the card, and the sparse
    kernel path against the port's dense oracle on 4x7 complete networks."""
    import torch
    from repro_torch.core import (ByzantineConfig, ExecutionPlan, attacks,
                                  make_confused_model, make_hierarchy,
                                  run_byzantine_learning)

    def scenario(sizes, attack, truth=1):
        topo = make_hierarchy(sizes, topology="complete", seed=0)
        model = make_confused_model(N=topo.N, m=3, truth=truth,
                                    confusion=0.0, seed=0)
        atk = (attacks.truth_suppression(truth, magnitude=1e3)
               if attack == "truth_suppression"
               else attacks.ATTACKS[attack]())
        cfg = ByzantineConfig(topo=topo, F=BYZ_F, byz=BYZ_AGENTS,
                              gamma_period=BYZ_GAMMA, attack=atk)
        return model, cfg, torch.from_numpy(~cfg.byz_mask()).to(dev)

    model, cfg, normal = scenario([7, 7, 7], "truth_suppression")
    _zero_counts()
    res = run_byzantine_learning(model, cfg, T=500, seed=0, device=dev)
    torch.cuda.synchronize()
    require(_counts()["byz_trim"] == 500, "quickstart launches")
    acc = (res.decisions[-1][normal] == model.truth).float().mean().item()
    log(f"[byzantine quickstart] normal-agent accuracy at T=500: {acc:.3f}")
    require(acc == 1.0, "byzantine quickstart learns theta*")

    traj = ExecutionPlan(store="trajectory")
    for attack in ("sign_flip", "large_value", "extreme_pull",
                   "truth_suppression"):
        model, cfg, _ = scenario([7] * 4, attack)
        gaps = []
        for mode in ("pairwise", "ovr"):
            sparse = run_byzantine_learning(model, cfg, 120, mode=mode,
                                            plan=traj, device=dev)
            dense = run_byzantine_learning(model, cfg, 120, mode=mode,
                                           core="dense", plan=traj,
                                           device=dev)
            require(torch.equal(sparse.decisions, dense.decisions),
                    f"{attack} {mode}: every decision equal to the dense "
                    f"oracle's")
            gaps.append((sparse.r - dense.r).abs().max().item())
        log(f"[byzantine oracle] {attack}: sparse kernel path = dense oracle "
            f"at every step (pairwise, ovr); max |r| gap {max(gaps):.3e}")
    model, cfg, normal = scenario([7] * 4, "random_noise")
    accs = []
    for core in ("sparse", "dense"):
        res = run_byzantine_learning(model, cfg, 300, core=core,
                                     plan=ExecutionPlan(store="final"),
                                     device=dev)
        accs.append((res.decisions[normal] == model.truth).float().mean()
                    .item())
    log(f"[byzantine oracle] random_noise: normal-agent accuracy at T=300 "
        f"sparse {accs[0]:.3f}, dense {accs[1]:.3f}")
    require(accs == [1.0, 1.0], "random_noise learns on both cores")


def byzantine_step_timing(model, setup, attack, dev) -> None:
    """Milliseconds per Algorithm 2 step at N = 16,384 and 131,072, kernel
    and plain path, and a profile of the kernel-path step."""
    import torch
    from repro_torch.core import ExecutionPlan, run_byzantine_runtime
    from repro_torch.core.signals import SignalModel

    cells = {N_FULL: (model, setup, attack), N_SMALL: byz_scenario(N_SMALL)}
    for n_agents in (N_SMALL, N_FULL):
        smodel, (srt, extra, n_reps), satk = cells[n_agents]
        smodel = SignalModel(tables=smodel.tables.to(dev),
                             truth=smodel.truth)
        srt = srt.to(dev)
        ms = {}
        for backend in ("auto", "torch"):
            plan = ExecutionPlan(backend=backend, store="final")

            def run(T=STEP_T):
                run_byzantine_runtime(smodel, srt, extra, n_reps, satk, T,
                                      seed=0, plan=plan)

            run()
            ms[backend] = event_ms(run, STEP_RUNS) / STEP_T
        log(f"[timing] byzantine step at N={n_agents}: kernel "
            f"{ms['auto']:.4f} ms, plain {ms['torch']:.4f} ms (median of "
            f"{STEP_RUNS} runs of {STEP_T} steps, Γ = {BYZ_GAMMA}, "
            f"store=final)")
        plan = ExecutionPlan(store="final")
        profile_step(
            lambda T: run_byzantine_runtime(smodel, srt, extra, n_reps, satk,
                                            T, seed=0, plan=plan),
            f"byzantine N={n_agents}", ms["auto"])

def n_stub_rows(stubs: dict) -> int:
    """Rows a VLM's patches prepend to the sequence (0 without)."""
    pe = stubs.get("patch_embeds")
    return 0 if pe is None else pe.shape[1]


def serve_logits(params, cfg, prompts, toks, backend: str, stubs=None):
    """The serve path's last-position logits for given tokens: prefill
    (with the family's stub inputs ``stubs``), then a decode step on each
    of ``toks[:, :-1]`` (teacher-forced) -> (B, gen, V)."""
    import torch
    from repro_torch.models import model as M
    stubs = stubs or {}
    S, gen = prompts.shape[1], toks.shape[1]
    lg, cache = M.prefill(params, cfg, prompts,
                          cache_len=S + gen + 1 + n_stub_rows(stubs),
                          backend=backend, **stubs)
    out = [lg[:, -1]]
    for i in range(gen - 1):
        lg, cache = M.decode_step(params, cfg, cache, toks[:, i:i + 1],
                                  backend=backend)
        out.append(lg[:, -1])
    return torch.stack(out, dim=1)


def full_logits(params, cfg, prompts, toks, block: int, stubs=None):
    """The plain full forward over prompt + generated tokens (after a
    VLM's patches), ``block`` requests at a time, at the positions whose
    logits chose ``toks`` -> (B, gen, V)."""
    import torch
    from repro_torch.models import model as M
    stubs = stubs or {}
    S = prompts.shape[1] + n_stub_rows(stubs)
    seq = torch.cat([prompts, toks[:, :-1]], dim=1)
    out = []
    for b0 in range(0, seq.shape[0], block):
        lg = M.forward_train(params, cfg, seq[b0:b0 + block], backend="torch",
                             **{k: v[b0:b0 + block] for k, v in stubs.items()})
        out.append(lg[:, S - 1:].clone())
        del lg
    return torch.cat(out)


def logit_gaps(got, want) -> tuple[float, float]:
    """(max abs, rms) of got - want, in float32."""
    d = got.float() - want.float()
    return d.abs().max().item(), d.pow(2).mean().sqrt().item()


def hold_logits(tag, what, toks, lk, lp, lf, min_clear=0.0) -> None:
    """Serve-path logits (kernel ``lk``, plain ``lp``) against the plain
    full forward ``lf`` over the same tokens. The plain serve path
    measures the rounding noise of serving against the full forward
    (other GEMM shapes; another attention order, or for RWKV6 another WKV
    form: chunked in prefill and a step at a time in decode, against the
    full forward's sequential scan over S + gen - 1 tokens, which no
    chunk divides); the kernel path stays within twice its rms + 1e-3 of
    the logits' rms and four times its max + one bf16 ulp of the largest
    logit, and its greedy choices equal the full forward's argmax where
    the top-2 margin exceeds twice its max gap, on at least
    ``min_clear`` of the positions."""
    import torch
    torch.cuda.synchronize()
    mk, rk = logit_gaps(lk, lf)
    mp, rp = logit_gaps(lp, lf)
    mf = lf.float().abs().max().item()
    rf = lf.float().pow(2).mean().sqrt().item()
    top2 = lf.float().topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * mk
    agree = torch.equal(toks[clear], lf.argmax(-1)[clear])
    log(f"{tag} {what}: logits against the plain full forward (|logit| up "
        f"to {mf:.3f}, rms {rf:.4f}): kernel path max {mk:.4e} rms "
        f"{rk:.4e}; plain serve path max {mp:.4e} rms {rp:.4e}; greedy "
        f"choice = full-forward argmax on {int(clear.sum())}/{clear.numel()}"
        f" positions whose top-2 margin exceeds {2 * mk:.3e}: {agree}")
    require(rk <= 2 * rp + 1e-3 * rf, f"{tag} kernel-path logit rms gap")
    require(mk <= 4 * mp + 2 ** -7 * mf, f"{tag} kernel-path logit max gap")
    require(agree, f"{tag} greedy choices agree where the margin is clear")
    require(clear.float().mean().item() >= min_clear,
            f"{tag} a clear top-2 margin on at least {min_clear} of the "
            f"positions")


def serve_times(params, cfg, prompts, toks, note: str = "",
                stubs=None) -> dict:
    """Time to prefill (median of 3 kernel-path and 2 plain-path runs) and
    ms per decode step (median of 3 and 2 runs of gen - 1 steps from a
    fresh prefill), CUDA events around the host's calls, logged beside the
    weight-read floor -> {"prefill_ms", "prefill_plain_ms", "decode_ms",
    "decode_plain_ms"}. ``note`` follows the prefill figures; ``stubs``
    are the family's stub inputs."""
    import torch
    from repro_torch.models import model as M

    stubs = stubs or {}
    B, S = prompts.shape
    GEN = toks.shape[1]

    def prefill(backend):
        return M.prefill(params, cfg, prompts,
                         cache_len=S + GEN + 1 + n_stub_rows(stubs),
                         backend=backend, **stubs)

    def decode_ms(backend, runs):
        ts = []
        for _ in range(runs):
            _, cache = prefill(backend)
            # from an idle device: the host does not run ahead into the
            # steps while the prefill still runs
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(GEN - 1):
                M.decode_step(params, cfg, cache, toks[:, i:i + 1],
                              backend=backend)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / (GEN - 1))
            del cache
        return float(np.median(ts))

    with torch.inference_mode():
        pre_k = event_ms(lambda: prefill("auto"), 3)
        pre_p = event_ms(lambda: prefill("torch"), 2)
        dec_k = decode_ms("auto", 3)
        dec_p = decode_ms("torch", 2)
    weights = nbytes(*_leaves(params))
    floor = weights / HBM_BYTES_PER_S * 1e3
    log(f"[timing] {cfg.name} serve, B={B}, prompt {S}: prefill {pre_k:.2f} "
        f"ms (plain path {pre_p:.2f}) = {B * S / pre_k:.0f} prompt tokens/ms"
        f"{note}; decode {dec_k:.3f} ms a step (plain path {dec_p:.3f}) over "
        f"{GEN - 1} steps = {B / dec_k * 1e3:.0f} tokens/s; weight-read "
        f"floor {floor:.3f} ms a step ({weights / 1e9:.3f} GB at 3.35 TB/s)")
    return {"prefill_ms": pre_k, "prefill_plain_ms": pre_p,
            "decode_ms": dec_k, "decode_plain_ms": dec_p}


def profile_decode(params, cfg, prompts, toks, step_ms: float,
                   stubs=None, steps: int = 20) -> None:
    """torch.profiler breakdown of ``steps`` kernel-path decode steps
    after one prefill of ``prompts`` (with the family's ``stubs``),
    teacher-forced on ``toks``."""
    import torch
    from repro_torch.models import model as M

    state = {}
    stubs = stubs or {}

    def run(T):
        if not state:
            _, state["cache"] = M.prefill(
                params, cfg, prompts,
                cache_len=prompts.shape[1] + toks.shape[1] + 1
                + n_stub_rows(stubs), **stubs)
        for i in range(T):
            M.decode_step(params, cfg, state["cache"], toks[:, i:i + 1])

    with torch.inference_mode():
        profile_step(run, f"{cfg.name} decode (B={prompts.shape[0]}, prompt "
                     f"{prompts.shape[1]})", step_ms, steps)


def serve_kernel_checks(dev) -> dict[str, float]:
    """Phase 8: K5 and K6 against their plain versions -> max abs error of
    each. The plain version runs in float32 on the same (bf16 or fp32)
    inputs; a bf16 kernel output is the float32 result rounded once, so it
    is held to rtol 2^-8 (a bf16 rounding is up to 2^-8 relative) + atol
    1e-5; float32 to rtol 1e-5 + atol 1e-5 (another summation order over
    at most 2,081 rows). A request with no valid row is NaN in both. K5's
    bf16 cases run on its one-launch tensor-core kernel, its float32 ones
    on split and combine; K6's bf16 cases at head sizes 64 and 128 run on
    its tensor-core kernel, the rest on its FMA kernel (each checked by the
    wrapper's tensor-core launch count). K5's ticket counters are back at
    zero after the calls."""
    import torch
    from repro_torch.kernels.swa import (attn_decode_cuda, attn_decode_ref,
                                         swa_prefill_cuda, swa_prefill_ref)
    from repro_torch.kernels.swa.ops import _TICKETS
    g = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    errs = {"attn_decode": 0.0, "swa_prefill": 0.0}

    def rn(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def hold(name, case, got, want):
        torch.cuda.synchronize()
        tol = 2 ** -8 if got.dtype == bf16 else 1e-5
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=1e-5,
                                   equal_nan=True)
        ok = ~torch.isnan(want)
        err = (got.float()[ok] - want[ok]).abs().max().item()
        errs[name] = max(errs[name], err)
        log(f"[serve kernels] {name} {case}: max_abs_err {err:.3e}")

    for case, (B, H, Hkv, Wc, dh, dtype, lens) in {
            "serve shape, first decode step": (8, 32, 8, 2081, 128, bf16,
                                               2049),
            "serve shape, last decode step": (8, 32, 8, 2081, 128, bf16,
                                              2079),
            "ragged lengths < Wc": (8, 32, 8, 2081, 128, bf16, None),
            "ragged lengths, fp32": (8, 32, 8, 2081, 128, f32, None),
            "full ring window, G=1": (3, 8, 8, 1000, 128, bf16, 1000),
            "Wc=77, G=3, dh=64, fp32": (3, 12, 4, 77, 64, f32, None),
            "dh=256, G=8, one empty request": (2, 16, 2, 300, 256, bf16, 0),
            "dh=64, G=16, lengths inside tiles": (3, 32, 2, 200, 64, bf16,
                                                  None),
            "dh=128, G=16, one empty request": (2, 32, 2, 77, 128, bf16, 0),
            "G=3, a short cache": (4, 12, 4, 5, 128, bf16, None),
    }.items():
        q, k, v = (rn(B, H, dh, dtype=dtype), rn(B, Hkv, Wc, dh, dtype=dtype,
                                                  scale=2.0),
                   rn(B, Hkv, Wc, dh, dtype=dtype))
        if lens is None or lens == 0:
            L = torch.randint(1, Wc + 1, (B,), generator=g, device=dev)
            if lens == 0:
                L[0] = 0
        else:
            L = torch.full((B,), lens, device=dev)
        L = L.to(torch.int32)
        before = attn_decode_cuda.launches_tc
        got = attn_decode_cuda(q, k, v, L)
        require(attn_decode_cuda.launches_tc - before == (dtype == bf16),
                f"K5 {case}: the kernel picked by dtype")
        hold("attn_decode", case, got,
             attn_decode_ref(q.float(), k.float(), v.float(), L))

    torch.cuda.synchronize()
    require(all(int(t.abs().sum()) == 0 for t in _TICKETS.values()),
            "K5's ticket counters are back at zero")

    for case, (B, S, H, Hkv, dh, dtype, w) in {
            "serve shape": (8, 2048, 32, 8, 128, bf16, 0),
            "S=1000 (ragged tile)": (2, 1000, 32, 8, 128, bf16, 0),
            "S=1000, window 256, fp32": (2, 1000, 32, 8, 128, f32, 256),
            "S=77, window 8, dh=64, fp32": (1, 77, 4, 4, 64, f32, 8),
            "S=130, window 100, dh=256": (1, 130, 8, 2, 256, bf16, 100),
            "training shape, G=3": (8, 1024, 12, 4, 64, bf16, 0),
            "training shape, window 256": (8, 1024, 12, 4, 64, bf16, 256),
            "S=1000, dh=64, G=1": (2, 1000, 8, 8, 64, bf16, 0),
            "S=1000, dh=128, G=3, window 300": (2, 1000, 12, 4, 128, bf16,
                                                300),
            "S=300, G=4, window 100 (edge inside query tiles)":
                (2, 300, 16, 4, 128, bf16, 100),
            "S=300, dh=64, G=4, window 100": (2, 300, 16, 4, 64, bf16, 100),
    }.items():
        q, k, v = (rn(B, S, H, dh, dtype=dtype), rn(B, S, Hkv, dh,
                                                     dtype=dtype, scale=2.0),
                   rn(B, S, Hkv, dh, dtype=dtype))
        before = swa_prefill_cuda.launches_tc
        got = swa_prefill_cuda(q, k, v, w)
        require(swa_prefill_cuda.launches_tc - before
                == (dtype == bf16 and dh in (64, 128)),
                f"K6 {case}: the kernel picked by dtype and head size")
        hold("swa_prefill", case, got,
             swa_prefill_ref(q.float(), k.float(), v.float(), w))
    # q, k, v as views of one fused projection row, read through strides
    B, S, H, Hkv, dh = 2, 300, 8, 2, 128
    x = rn(B, S, (H + 2 * Hkv) * dh, dtype=bf16)
    q = x[..., :H * dh].view(B, S, H, dh)
    k = x[..., H * dh:(H + Hkv) * dh].view(B, S, Hkv, dh)
    v = x[..., (H + Hkv) * dh:].view(B, S, Hkv, dh)
    before = swa_prefill_cuda.launches_tc
    hold("swa_prefill", "strided views of one projection",
         swa_prefill_cuda(q, k, v, 0),
         swa_prefill_ref(q.float(), k.float(), v.float(), 0))
    require(swa_prefill_cuda.launches_tc == before + 1,
            "strided views on the tensor-core kernel")
    return errs


def serve_phases(dev, flush) -> list[dict]:
    """Phases 8-11 (the serving path of Qwen3-8B) -> the JSON entries of
    K5 and K6."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.prng import prng_key, randint_n
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # ---- phase 8: the two kernels against their plain versions ----------
    errs = serve_kernel_checks(dev)

    # ---- phase 9: Qwen3-8B at full width and depth, bf16 ----------------
    cfg = get_config("qwen3_8b")
    B, S, GEN = SERVE_B, SERVE_S, SERVE_GEN
    t0 = time.perf_counter()
    params = M.init_params(0, cfg, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}; {n_params} parameters "
        f"({n_params * 2 / 1e9:.2f} GB) drawn in "
        f"{time.perf_counter() - t0:.2f} s; layout "
        f"{'groups' if 'groups' in params else 'layers'}")
    # ArchConfig.param_count leaves out the final norm and the qk norms
    require(n_params == cfg.param_count() + cfg.d_model
            + cfg.qk_norm * 2 * cfg.head_dim * cfg.n_layers,
            "parameter count")
    prompts = randint_n(prng_key(0), B * S, 0, cfg.vocab, dev).reshape(B, S)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        toks, lk = generate(params, cfg, prompts, GEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    log(f"[serve] main: {B} requests x {S} prompt tokens, {GEN} tokens each "
        f"(prefill + {GEN - 1} decode steps) in {wall:.2f} s, launches "
        f"{counts}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    L = cfg.n_layers
    require(counts == _only(swa_prefill=L, swa_prefill_tc=L,
                            attn_decode=L * (GEN - 1),
                            attn_decode_tc=L * (GEN - 1)),
            "K6 launched once per layer in prefill and K5 once per layer in "
            "every decode step, every launch of both on its tensor-core "
            "kernel")
    require(toks.shape == (B, GEN) and lk.shape == (B, GEN, cfg.vocab)
            and bool(torch.isfinite(lk).all()), "serve outputs")
    with torch.inference_mode():
        lp = serve_logits(params, cfg, prompts, toks, backend="torch")
        require(_counts() == counts, "the plain path launched no kernel")
        lf = full_logits(params, cfg, prompts, toks, block=2)
    # bf16 with float32 accumulation on every path; they differ only by
    # where a float32 sum rounds to bf16 (other GEMM shapes, another
    # attention order), and those flips grow over the 36 layers
    hold_logits("[serve]", f"{B} x {S} prompt tokens, {GEN} tokens", toks,
                lk, lp, lf)

    # ---- phase 10: timing at these shapes ---------------------------------
    times = serve_timing(params, cfg, prompts, toks, flush, dev)
    del lk, lp, lf
    profile_decode(params, cfg, prompts, toks, times["decode_ms"])
    del params
    torch.cuda.empty_cache()

    # ---- phase 11: 2 layers in float32 -----------------------------------
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params32 = M.init_params(1, cfg32, dev)
    p32 = randint_n(prng_key(1), 4 * 1000, 0, cfg.vocab, dev).reshape(4, 1000)
    counts_main = counts
    with torch.inference_mode():
        _zero_counts()
        t32, l32 = generate(params32, cfg32, p32, 16)
        require(_counts() == _only(swa_prefill=2, attn_decode=2 * 15),
                "fp32 launches")
        lp32 = serve_logits(params32, cfg32, p32, t32, backend="torch")
        lf32 = full_logits(params32, cfg32, p32, t32, block=4)
    m32, r32 = logit_gaps(l32, lf32)
    mp32, _ = logit_gaps(lp32, lf32)
    log(f"[serve fp32] 2 layers, 4 x 1000 prompt tokens, 16 tokens: kernel "
        f"path max {m32:.3e} rms {r32:.3e}, plain serve path max {mp32:.3e}, "
        f"against the plain full forward (|logit| up to "
        f"{lf32.abs().max().item():.3f})")
    # Tolerance (fp32): the same float32 math in another order (the
    # kernels' online softmax, other GEMM shapes) differs by ~1e-5 on
    # logits of size ~1-5; a bf16 computation of the same model differs by
    # ~1e-2 (8-bit mantissa). Limit: atol 1e-3 + rtol 1e-3.
    torch.testing.assert_close(l32, lf32, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(lp32, lf32, atol=1e-3, rtol=1e-3)
    require(torch.equal(t32, l32.argmax(-1)), "fp32 greedy tokens")
    del params32, l32, lp32, lf32
    torch.cuda.empty_cache()

    return [
        {"name": "attn_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/attn_decode.cu",
         "replaces": "src/repro/kernels/swa/swa.py:72",
         "launches": counts_main["attn_decode"],
         "launches_tc": counts_main["attn_decode_tc"],
         "max_abs_err": errs["attn_decode"], **times["attn_decode"]},
        {"name": "swa_prefill", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/swa_prefill.cu",
         "replaces": "src/repro/kernels/swa/prefill.py:79",
         "launches": counts_main["swa_prefill"],
         "launches_tc": counts_main["swa_prefill_tc"],
         "max_abs_err": errs["swa_prefill"], **times["swa_prefill"]},
    ]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def serve_timing(params, cfg, prompts, toks, flush, dev) -> dict:
    """K5, K6, their plain versions and SDPA at the serve shapes (medians
    of CUDA-event runs, L2 flushed), then :func:`serve_times`."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.swa import (attn_decode_cuda, attn_decode_ref,
                                         swa_prefill_cuda, swa_prefill_ref)
    from repro_torch.kernels.swa.ops import decode_splits

    B, S = prompts.shape
    GEN = toks.shape[1]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    Wc = S + GEN + 1
    g = torch.Generator(device=dev).manual_seed(2)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    out = {}
    # K5 at the last decode step: lengths S + GEN - 1 of a Wc-row cache
    n_valid = S + GEN - 1
    q, k, v = rn(B, H, dh), rn(B, Hkv, Wc, dh), rn(B, Hkv, Wc, dh)
    lens = torch.full((B,), n_valid, dtype=torch.int32, device=dev)
    mask = (torch.arange(Wc, device=dev)[None, :] < lens[:, None])[:, None,
                                                                  None, :]
    o5 = attn_decode_cuda(q, k, v, lens)
    sdpa5 = F.scaled_dot_product_attention(q[:, :, None], k, v,
                                           attn_mask=mask, enable_gqa=True)
    # device time alone (the host's enqueueing hidden), and with the
    # events around the host's call
    times5 = {}
    for hide in (True, False):
        times5[hide] = [event_ms(fn, TIMED_RUNS, flush, hide) for fn in (
            lambda: attn_decode_cuda(q, k, v, lens),
            lambda: attn_decode_ref(q, k, v, lens),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=mask, enable_gqa=True))]
    ms5, plain5, lib5 = times5[True]
    # (None where the profiler of a long process records no launch of it)
    kernel5 = kernel_times(lambda: attn_decode_cuda(q, k, v, lens), 10,
                           flush).get("attn_decode_tc_kernel", (None, 0))
    # bytes: q, the valid K and V rows, lengths and the output once each
    kv_bytes = 2 * B * Hkv * n_valid * dh * k.element_size()
    b5, by5 = bound(nbytes(q, lens, o5) + kv_bytes,
                    4 * B * H * n_valid * dh, BF16_FLOPS)
    log(f"[timing] attn_decode (B={B}, H={H}, Hkv={Hkv}, Wc={Wc}, "
        f"{n_valid} valid rows, bf16, "
        f"{decode_splits(B, Hkv, Wc, dh, n_sm)[1]} splits): device {ms5:.5f} "
        f"ms, plain {plain5:.5f}, SDPA {lib5:.5f}; host-inclusive "
        f"{times5[False][0]:.5f}, plain {times5[False][1]:.5f}, SDPA "
        f"{times5[False][2]:.5f}; kernel alone (profiler, L2 flushed) "
        + ("not measured" if kernel5[0] is None else f"{kernel5[0]:.5f}")
        + f" (mean of {kernel5[1]} launches); bound {b5:.5f} "
        f"({by5}); SDPA max diff "
        f"{(sdpa5[:, :, 0].float() - o5.float()).abs().max().item():.3e}")
    out["attn_decode"] = {"ms": ms5, "plain_ms": plain5, "bound_ms": b5,
                          "bound_by": by5, "library_ms": lib5,
                          "host_inclusive_ms": times5[False][0],
                          "kernel_ms": kernel5[0]}

    # K6 at the prefill shape, full causal
    q, k, v = rn(B, S, H, dh), rn(B, S, Hkv, dh), rn(B, S, Hkv, dh)
    o6 = swa_prefill_cuda(q, k, v, 0)
    tr = (0, 2, 1, 3)
    sdpa6 = F.scaled_dot_product_attention(
        q.permute(tr), k.permute(tr), v.permute(tr), is_causal=True,
        enable_gqa=True)
    ms6 = event_ms(lambda: swa_prefill_cuda(q, k, v, 0), 10, flush)
    plain6 = event_ms(lambda: swa_prefill_ref(q, k, v, 0), 3, flush)
    lib6 = event_ms(lambda: F.scaled_dot_product_attention(
        q.permute(tr), k.permute(tr), v.permute(tr), is_causal=True,
        enable_gqa=True), 10, flush)
    # operations: the band's S (S + 1) / 2 pairs per (request, head), 2 dh
    # FLOPs for the score and 2 dh for P.V each
    flops6 = 4 * dh * B * H * (S * (S + 1) // 2)
    b6, by6 = bound(nbytes(q, k, v, o6), flops6, BF16_FLOPS)
    log(f"[timing] swa_prefill (B={B}, S={S}, H={H}, Hkv={Hkv}, bf16, "
        f"causal): {ms6:.4f} ms = {flops6 / ms6 / 1e9:.1f} TFLOP/s, plain "
        f"{plain6:.4f}, SDPA {lib6:.4f}, bound {b6:.4f} ({by6}, "
        f"{flops6 / 1e9:.1f} GFLOP); SDPA max diff "
        f"{(sdpa6.permute(tr).float() - o6.float()).abs().max().item():.3e}")
    out["swa_prefill"] = {"ms": ms6, "plain_ms": plain6, "bound_ms": b6,
                          "bound_by": by6, "library_ms": lib6}
    del q, k, v, o5, o6, sdpa5, sdpa6

    # K6 at the training shape (a paper_sim worker's call of a layer)
    Bt, St, Ht, Hkvt = GRAD_ATTN
    q, k, v = rn(Bt, St, Ht, 64), rn(Bt, St, Hkvt, 64), rn(Bt, St, Hkvt, 64)
    ms_t = event_ms(lambda: swa_prefill_cuda(q, k, v, 0), TIMED_RUNS, flush)
    lib_t = event_ms(lambda: F.scaled_dot_product_attention(
        q.permute(tr), k.permute(tr), v.permute(tr), is_causal=True,
        enable_gqa=True), TIMED_RUNS, flush)
    flops_t = 4 * 64 * Bt * Ht * (St * (St + 1) // 2)
    log(f"[timing] swa_prefill at the training shape (B={Bt}, S={St}, "
        f"H={Ht}, Hkv={Hkvt}, dh=64, bf16, causal): {ms_t:.4f} ms = "
        f"{flops_t / ms_t / 1e9:.1f} TFLOP/s, SDPA {lib_t:.4f}, bound "
        f"{bound(0, flops_t, BF16_FLOPS)[0]:.4f} (operations)")
    out["swa_prefill"].update(train_ms=ms_t, train_library_ms=lib_t)
    del q, k, v

    out["decode_ms"] = serve_times(params, cfg, prompts, toks)["decode_ms"]
    return out


# RWKV6 serving: the chunked WKV6 scan (K7) of prefill
WKV_HEAD = 64


def wkv_inputs(g, BH, T, dtype, lw, dev):
    """Random (r, k, v, lw, u) of BH sequences of T tokens: r, k, v in
    ``dtype``; lw float32, ``"model"`` for the model's range
    -exp(clip(-0.5 + normal, -8, 4)) or a constant; u float32."""
    import torch

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    r, k, v = (rn(BH, T, WKV_HEAD).to(dtype) for _ in range(3))
    if lw == "model":
        lwa = -torch.exp(torch.clamp(-0.5 + rn(BH, T, WKV_HEAD), -8, 4))
    else:
        lwa = torch.full((BH, T, WKV_HEAD), lw, device=dev)
    return r, k, v, lwa, 0.5 * rn(BH, WKV_HEAD)


def wkv_kernel_checks(dev) -> float:
    """Phase 12: K7 against its plain chunked version (chunk 64) and the
    sequential scan -> the largest abs error against the plain chunked
    version over the cases, y and state.

    Tolerance: |got - want| <= rtol |want| + scale max|want|, in float32.
    The three are float32 sums in other orders, and the chunked forms'
    decay weights are exponentials of differences of in-chunk cumsums that
    carry a few ulp of |P|: scale = rtol = 1e-4 (the CPU tests measure
    both packages' chunked forms ~5e-6 of max|y| off a float64 scan). At
    lw = -e^4 |P| reaches ~3,500, whose ulp 2.4e-4 is a relative error of
    each decay weight: scale = rtol = 5e-4. A bf16 y is the float32 result
    rounded once on each side: rtol + 2^-7 (one bf16 ulp)."""
    import math

    import torch
    from repro_torch.kernels.wkv6 import wkv6_chunked_ref, wkv6_cuda, wkv6_ref
    from repro_torch.kernels.wkv6.ops import group_chunks
    g = torch.Generator(device=dev).manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    strong, weak = -math.exp(4.0), -math.exp(-8.0)
    worst = 0.0

    def hold(case, what, got, want, tol, extra_rtol=0.0):
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        err = (got - want).abs()
        limit = (tol + extra_rtol) * want.abs() + tol * want.abs().max()
        require(bool(torch.isfinite(got).all()), f"wkv6 {case}: finite")
        require(bool((err <= limit).all()),
                f"wkv6 {case}: {what} within the tolerance (max err "
                f"{err.max().item():.3e}, max |want| "
                f"{want.abs().max().item():.3e})")
        return err.max().item()

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for BH, T, dtype, lw, view in (
            (256, 2048, bf16, "model", False), (256, 2048, f32, "model", False),
            (1, 1, f32, "model", False), (1, 63, bf16, "model", False),
            (1, 64, f32, "model", False), (1, 65, bf16, "model", False),
            (256, 1000, bf16, "model", False), (1, 1000, f32, "model", False),
            (256, 2048, bf16, strong, False), (1, 65, f32, strong, False),
            (256, 1000, f32, strong, False), (256, 2048, bf16, weak, False),
            (1, 63, f32, weak, False), (256, 1000, f32, weak, False),
            # chunk-group edges: groups of 1 chunk at BH = 8, of 4 at 300
            (8, 127, bf16, "model", False), (8, 128, f32, strong, False),
            (8, 129, bf16, weak, False), (300, 255, bf16, "model", False),
            (300, 257, f32, "model", False),
            # one long sequence: 128 groups of one chunk
            (1, 8192, bf16, "model", False), (1, 8192, f32, strong, False),
            # (B, H, T, 64) views of (B, T, H, 64) projections, u broadcast
            (64, 1000, bf16, "model", True)):
        args = wkv_inputs(g, BH, T, dtype, lw, dev)
        if view:
            B, H = 2, BH // 2
            y, s = wkv6_cuda(
                *(a.view(B, H, T, WKV_HEAD).transpose(1, 2).contiguous()
                  .transpose(1, 2) for a in args[:4]),
                args[4][:H].expand(B, H, WKV_HEAD))
            require(y.shape == (B, H, T, WKV_HEAD)
                    and y.transpose(1, 2).is_contiguous(),
                    "wkv6 view case: y in the (B, T, H, V) layout")
            y, s = y.reshape(BH, T, WKV_HEAD), s.reshape(BH, WKV_HEAD,
                                                        WKV_HEAD)
            args = (*args[:4], args[4][:H].repeat(B, 1))
        else:
            y, s = wkv6_cuda(*args)
        tol = 5e-4 if lw == strong else 1e-4
        y_rtol = 2 ** -7 if dtype == bf16 else 0.0
        lw_name = lw if lw == "model" else f"{lw:.4g}"
        case = (f"BH={BH} T={T} {str(dtype)[6:]} lw={lw_name}"
                f"{' (B, H) views' if view else ''} G="
                f"{group_chunks(BH, T, n_sm)}")
        errs = []
        for form, (y_w, s_w) in (
                ("chunked", wkv6_chunked_ref(*args, chunk=64)),
                ("sequential", wkv6_ref(*args))):
            errs.append(hold(case, f"y vs {form}", y, y_w, tol, y_rtol))
            errs.append(hold(case, f"state vs {form}", s, s_w, tol))
        worst = max(worst, errs[0], errs[1])      # against the plain version
        log(f"[rwkv kernel] {case}: max_abs_err y {errs[0]:.3e} / "
            f"{errs[2]:.3e}, state {errs[1]:.3e} / {errs[3]:.3e} (against "
            f"chunked / sequential; max |y| "
            f"{y.float().abs().max().item():.3e})")
    return worst


def rwkv_param_count(cfg) -> int:
    """Every leaf of the RWKV6 tree: ``ArchConfig.param_count`` counts an
    extra d^2 a layer and leaves out the lerp weights, w0, u, ln_x and the
    layer norms' biases."""
    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    mixer = 5 * d + 5 * d * d + d + 2 * 64 * d + d + d
    cm = 2 * d + 2 * d * f + d * d
    return 2 * V * d + 2 * d + L * (mixer + cm + 4 * d)


def rwkv_phases(dev, flush) -> dict:
    """Phases 12-15 (the serving path of RWKV6-1.6B) -> the JSON entry of
    K7."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.prng import prng_key, randint_n
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M

    # ---- phase 12: K7 against its plain versions -------------------------
    err = wkv_kernel_checks(dev)

    # ---- phase 13: RWKV6-1.6B at full width and depth, bf16 --------------
    cfg = get_config("rwkv6_1b6")
    B, S, GEN = SERVE_B, SERVE_S, SERVE_GEN
    t0 = time.perf_counter()
    params = M.init_params(0, cfg, dev)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    weights = sum(t.numel() * t.element_size() for t in leaves)
    log(f"[rwkv] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.d_model // cfg.wkv_head_dim} wkv heads of "
        f"{cfg.wkv_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.dtype}; {n_params} parameters ({weights / 1e9:.3f} GB) drawn "
        f"in {time.perf_counter() - t0:.2f} s; layout "
        f"{'groups' if 'groups' in params else 'layers'}")
    require(n_params == rwkv_param_count(cfg), "rwkv parameter count")
    prompts = randint_n(prng_key(0), B * S, 0, cfg.vocab, dev).reshape(B, S)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        toks, lk = generate(params, cfg, prompts, GEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    state_bytes = nbytes(*_leaves(M.init_cache(params, cfg, B, S + GEN + 1)))
    log(f"[rwkv] main: {B} requests x {S} prompt tokens, {GEN} tokens each "
        f"(prefill + {GEN - 1} decode steps) in {wall:.2f} s, launches "
        f"{counts}; weights {weights / 1e9:.3f} GB, state cache "
        f"{state_bytes / 1e6:.2f} MB, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    require(counts == _only(wkv6=cfg.n_layers),
            "K7 launched once per layer in prefill and no kernel in decode")
    require(toks.shape == (B, GEN) and lk.shape == (B, GEN, cfg.vocab)
            and bool(torch.isfinite(lk).all()), "rwkv serve outputs")
    with torch.inference_mode():
        lp = serve_logits(params, cfg, prompts, toks, backend="torch")
        require(_counts() == counts, "the plain path launched no kernel")
        lf = full_logits(params, cfg, prompts, toks, block=B)
    hold_logits("[rwkv]", f"{B} x {S} prompt tokens, {GEN} tokens", toks,
                lk, lp, lf)
    del lk, lp, lf

    # ---- phase 14: timing -----------------------------------------------
    times = rwkv_timing(params, cfg, prompts, toks, flush, dev)
    profile_decode(params, cfg, prompts, toks, times["decode_ms"])
    del params
    torch.cuda.empty_cache()

    # ---- phase 15: 2 layers in float32, ragged last chunk ---------------
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params32 = M.init_params(1, cfg32, dev)
    p32 = randint_n(prng_key(1), 4 * 1000, 0, cfg.vocab, dev).reshape(4, 1000)
    with torch.inference_mode():
        _zero_counts()
        t32, l32 = generate(params32, cfg32, p32, 16)
        require(_counts() == _only(wkv6=2), "rwkv fp32 launches")
        lp32 = serve_logits(params32, cfg32, p32, t32, backend="torch")
        lf32 = full_logits(params32, cfg32, p32, t32, block=4)
    m32, r32 = logit_gaps(l32, lf32)
    mp32, _ = logit_gaps(lp32, lf32)
    log(f"[rwkv fp32] 2 layers, 4 x 1000 prompt tokens, 16 tokens: kernel "
        f"path max {m32:.3e} rms {r32:.3e}, plain serve path max {mp32:.3e}, "
        f"against the plain full forward (|logit| up to "
        f"{lf32.abs().max().item():.3f})")
    # Tolerance (fp32): float32 WKV in three forms (K7, the chunked and the
    # sequential plain scans) differs by ~1e-5 of the outputs' scale; a
    # bf16 computation by ~1e-2. Limit: atol 1e-3 + rtol 1e-3.
    torch.testing.assert_close(l32, lf32, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(lp32, lf32, atol=1e-3, rtol=1e-3)
    require(torch.equal(t32, l32.argmax(-1)), "rwkv fp32 greedy tokens")
    del params32, l32, lp32, lf32
    torch.cuda.empty_cache()

    # ---- phase 15b: full width and depth in float32 ---------------------
    # bf16 rounding noise grows with depth in this random-weight model
    # (the port rounds where the reference rounds: tests/test_torch_models
    # .py), so at 24 layers few bf16 positions have a clear top-2 margin;
    # float32 at full depth keeps one on most.
    cfg_f = dataclasses.replace(cfg, dtype="float32")
    params_f = M.init_params(2, cfg_f, dev)
    pf = randint_n(prng_key(2), 2 * S, 0, cfg.vocab, dev).reshape(2, S)
    with torch.inference_mode():
        _zero_counts()
        tf_, lkf = generate(params_f, cfg_f, pf, 8)
        require(_counts() == _only(wkv6=cfg.n_layers), "rwkv fp32 full-depth "
                "launches")
        lpf = serve_logits(params_f, cfg_f, pf, tf_, backend="torch")
        lff = full_logits(params_f, cfg_f, pf, tf_, block=2)
    hold_logits("[rwkv fp32 24 layers]", f"2 x {S} prompt tokens, 8 tokens",
                tf_, lkf, lpf, lff, min_clear=0.5)
    del params_f, lkf, lpf, lff
    torch.cuda.empty_cache()

    return {"name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6/wkv6.py:90",
            "launches": counts["wkv6"], "max_abs_err": err, **times["wkv6"]}


def wkv_ops(BH: int, T: int, G: int) -> tuple[int, int]:
    """(tensor-core FLOPs, FMA-pipe operations) of K7 over BH sequences of
    T bf16 tokens, as its three passes compute them: every chunk padded to
    64 rows, K = V = 64; a product of two split (hi + lo) operands counted
    three times, of a split one and v (exact in bf16) twice; an
    exponential counted as one operation. Per chunk, pass 1: the decayed
    keys and the state update; pass 3: the scan, the decayed keys again,
    the inter-chunk product, the anchored off-diagonal scores (sub-chunks
    1-3), the diagonal sub-blocks pairwise (4 x 120 x 64 terms of 5
    operations) with the bonus on their diagonal, scores @ v and the state
    update; pass 2: one fma per state element a group."""
    C = K = V = WKV_HEAD
    mv = 2
    n_chunks = -(-T // C)
    prior = 16 + 32 + 48                       # key rows before sub-chunks
    tc = (mv * 2 * C * K * V                   # pass 1: state
          + 3 * 2 * C * K * V                  # inter-chunk
          + 3 * 2 * 16 * K * prior             # off-diagonal scores
          + mv * 2 * 16 * V * (prior + 64)     # scores @ v, j <= the block
          + mv * 2 * C * K * V)                # pass 3: state
    fma = (2 * (C * K + 3 * C * K + K * V + K)  # scan, k_dec, decay, exp
           + 2 * C * K                         # r . exp(E)
           + 3 * 16 * K * 3 + 3 * K * prior    # decayed q and k
           + 4 * 120 * K * 5                   # diagonal sub-blocks
           + 3 * C * K)                        # bonus
    groups = -(-n_chunks // G)
    return BH * n_chunks * tc, BH * (n_chunks * fma + groups * 2 * K * V)


def wkv_floor_bytes(BH: int, T: int, itemsize: int, G: int) -> int:
    """Bytes K7's design must move: k, v and lw read by passes 1 and 3, r
    and u by pass 3, y written once; each group's state written by pass 1,
    read and rewritten by pass 2, read by pass 3, and its decay written and
    read; the final state written once."""
    K = WKV_HEAD
    groups = -(-T // (64 * G))
    seq = T * K * (2 * (2 * itemsize + 4) + 2 * itemsize)
    state = groups * (4 * K * K * 4 + 2 * K * 4) + K * K * 4 + K * 4
    return BH * (seq + state)


def rwkv_timing(params, cfg, prompts, toks, flush, dev) -> dict:
    """K7 and its plain version at the serve shape (medians of CUDA-event
    runs, L2 flushed), then :func:`serve_times`."""
    import torch
    from repro_torch.kernels.wkv6 import wkv6_chunked_ref, wkv6_cuda
    from repro_torch.kernels.wkv6.ops import group_chunks

    B, S = prompts.shape
    H = cfg.d_model // cfg.wkv_head_dim
    g = torch.Generator(device=dev).manual_seed(4)
    # the model's layout: (B, H, S, 64) views of (B, S, H, 64) projections
    r, k, v, lw, u = wkv_inputs(g, B * H, S, torch.bfloat16, "model", dev)

    def heads(a):
        return a.view(B, S, H, WKV_HEAD).transpose(1, 2)

    uh = u[:H].expand(B, H, WKV_HEAD)
    y, s = wkv6_cuda(heads(r), heads(k), heads(v), heads(lw), uh)
    # device time alone (the host's enqueueing hidden), and with the
    # events around the host's call
    ms7, host7 = (event_ms(lambda: wkv6_cuda(heads(r), heads(k), heads(v),
                                             heads(lw), uh), TIMED_RUNS,
                           flush, hide) for hide in (True, False))
    plain7 = event_ms(lambda: wkv6_chunked_ref(r, k, v, lw, u, chunk=64), 3,
                      flush)
    passes7 = kernel_times(lambda: wkv6_cuda(heads(r), heads(k), heads(v),
                                             heads(lw), uh), 5, flush)
    # bytes: r, k, v, lw, u (the (H, 64) rows read), y and the state once;
    # operations: the tensor-core products at the bf16 peak plus the FMA
    # pipes' work at the float32 peak
    bytes7 = nbytes(r, k, v, lw, y, s) + H * WKV_HEAD * 4
    G7 = group_chunks(B * H, S, torch.cuda.get_device_properties(dev)
                      .multi_processor_count)
    tc7, fma7 = wkv_ops(B * H, S, G7)
    ops_ms7 = (tc7 / BF16_FLOPS + fma7 / FP32_FLOPS) * 1e3
    bytes_ms7 = bytes7 / HBM_BYTES_PER_S * 1e3
    b7, by7 = max((bytes_ms7, "bytes"), (ops_ms7, "operations"))
    floor7 = wkv_floor_bytes(B * H, S, 2, G7)
    log(f"[timing] wkv6 (B={B}, H={H}, T={S}, K=V=64, bf16, groups of "
        f"{G7} chunks, {B * H * -(-S // (64 * G7))} blocks in passes 1 and 3)"
        f": device {ms7:.5f} ms, host-inclusive {host7:.5f}, plain "
        f"{plain7:.4f}, bound {b7:.5f} ({by7}; "
        f"{bytes7 / 1e6:.1f} MB; {tc7 / 1e9:.2f} GFLOP on the tensor cores "
        f"and {fma7 / 1e9:.2f} G operations on the FMA pipes = "
        f"{ops_ms7:.5f} ms at the peaks), design floor "
        f"{floor7 / HBM_BYTES_PER_S * 1e3:.5f} ms ({floor7 / 1e6:.1f} MB); "
        f"library: none (no single PyTorch call); a launch of each pass "
        f"(profiler, L2 flushed): " + ", ".join(
            f"{n} {t:.5f} (mean of {c})" for n, (t, c) in passes7.items()))
    del r, k, v, lw, u, y, s
    dec = serve_times(params, cfg, prompts, toks,
                      f", of which K7 {cfg.n_layers} x {ms7:.4f} ms"
                      )["decode_ms"]
    return {"wkv6": {"ms": ms7, "plain_ms": plain7, "bound_ms": b7,
                     "bound_by": by7, "library_ms": None,
                     "floor_ms": floor7 / HBM_BYTES_PER_S * 1e3,
                     "host_inclusive_ms": host7,
                     "passes_ms": {n: t for n, (t, _) in passes7.items()}},
            "decode_ms": dec}


# ---------------------------------------------------------------------------
# Phases 15c-15h: the other model families' serve paths (OLMoE-1B-7B's
# top-8 MoE, RecurrentGemma-2B's RG-LRU hybrid, Whisper-small's
# encoder-decoder, InternVL2-26B's patch projector), K6 in prefill and K5
# in decode once per attention layer
# ---------------------------------------------------------------------------

# name -> (arch, prompt tokens, layers: None for full depth). Each phase
# has ~90 s of the script's time limit; InternVL2-26B's (39.8 GB of bf16
# weights) is the longest, ~80 s at full depth on the H100
FAMILY_CELLS = {
    "olmoe": ("olmoe_1b_7b", SERVE_S, None),
    "recurrentgemma": ("recurrentgemma_2b", SERVE_S, None),
    "whisper": ("whisper_small", 64, None),
    "internvl2": ("internvl2_26b", SERVE_S, None),
}
FAMILY_PROFILE_STEPS = 10     # decode steps under the profiler a family


def family_stubs(cfg, B: int, dev, seed: int = 0) -> dict:
    """The reference CLI's stub inputs, float32, seeded: Whisper's
    frames (B, n_frames, d_model), the VLM's patches (B, n_patches,
    1024)."""
    from repro_torch.core.prng import normal, prng_key
    from repro_torch.models import model as M
    key = prng_key(seed)
    if cfg.family == "audio":
        return {"frames": normal(key, (B, cfg.n_frames, cfg.d_model), dev)}
    if cfg.family == "vlm":
        return {"patch_embeds": normal(key, (B, cfg.n_patches, M.D_VIS),
                                       dev)}
    return {}


def attn_layers(cfg) -> int:
    """The decoder's causal attention layers: K6's launches a prefill and
    K5's a decode step."""
    return sum(cfg.mixer_of(i) in ("attn", "swa") for i in range(cfg.n_layers))


def k5_256_checks(dev, flush) -> dict:
    """Phase 15a: both K5 kernels at head size 256 with 10 and 16 query
    heads per KV head against the plain version, at RecurrentGemma's
    decode shape (B = 8, a 2,048-row ring: every decode step of the serve
    main sees the full ring; 2,047 rows for a ragged last tile), with
    phase 8's tolerance (bf16 rtol 2^-8, float32 1e-5; atol 1e-5). Then K5
    and K6 timed at RecurrentGemma's shapes beside their plain versions,
    SDPA and their bounds -> {"err", "decode", "prefill"}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.swa import (attn_decode_cuda, attn_decode_ref,
                                         swa_prefill_cuda, swa_prefill_ref)
    from repro_torch.kernels.swa.ops import _TICKETS
    g = torch.Generator(device=dev).manual_seed(25)
    bf16, f32 = torch.bfloat16, torch.float32
    err = 0.0
    B, Wc, dh = SERVE_B, 2048, 256
    for H in (10, 16):
        for dtype in (bf16, f32):
            for n in (2048, 2047):
                q = torch.randn((B, H, dh), generator=g, device=dev).to(dtype)
                k = (2 * torch.randn((B, 1, Wc, dh), generator=g,
                                     device=dev)).to(dtype)
                v = torch.randn((B, 1, Wc, dh), generator=g,
                                device=dev).to(dtype)
                L = torch.full((B,), n, dtype=torch.int32, device=dev)
                before = attn_decode_cuda.launches_tc
                got = attn_decode_cuda(q, k, v, L)
                torch.cuda.synchronize()
                require(attn_decode_cuda.launches_tc - before
                        == (dtype == bf16), "K5 at 256: the kernel by dtype")
                want = attn_decode_ref(q.float(), k.float(), v.float(), L)
                tol = 2 ** -8 if dtype == bf16 else 1e-5
                torch.testing.assert_close(got.float(), want, rtol=tol,
                                           atol=1e-5)
                e = (got.float() - want).abs().max().item()
                err = max(err, e)
                log(f"[families] K5 dh=256 G={H} {str(dtype)[6:]} {n} of "
                    f"{Wc} rows: max_abs_err {e:.3e}")
    torch.cuda.synchronize()
    require(all(int(t.abs().sum()) == 0 for t in _TICKETS.values()),
            "K5's ticket counters are back at zero")

    H, Hkv, S = 10, 1, SERVE_S

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf16)

    q, k, v = rn(B, H, dh), rn(B, Hkv, Wc, dh), rn(B, Hkv, Wc, dh)
    L = torch.full((B,), Wc, dtype=torch.int32, device=dev)
    o5 = attn_decode_cuda(q, k, v, L)
    fns = (lambda: attn_decode_cuda(q, k, v, L),
           lambda: attn_decode_ref(q, k, v, L),
           lambda: F.scaled_dot_product_attention(q[:, :, None], k, v,
                                                  enable_gqa=True))
    ms5, plain5, lib5 = (event_ms(fn, TIMED_RUNS, flush, True) for fn in fns)
    host5 = event_ms(fns[0], TIMED_RUNS, flush)
    b5, by5 = bound(nbytes(q, k, v, L, o5), 4 * B * H * Wc * dh, BF16_FLOPS)
    log(f"[timing] attn_decode at RecurrentGemma's decode shape (B={B}, "
        f"H={H}, Hkv={Hkv}, dh={dh}, a full {Wc}-row ring, bf16): device "
        f"{ms5:.5f} ms, plain {plain5:.5f}, SDPA {lib5:.5f}; host-inclusive "
        f"{host5:.5f}; bound {b5:.5f} ({by5})")
    q, k, v = rn(B, S, H, dh), rn(B, S, Hkv, dh), rn(B, S, Hkv, dh)
    o6 = swa_prefill_cuda(q, k, v, Wc)
    tr = (0, 2, 1, 3)
    ms6 = event_ms(lambda: swa_prefill_cuda(q, k, v, Wc), 5, flush)
    plain6 = event_ms(lambda: swa_prefill_ref(q, k, v, Wc), 3, flush)
    lib6 = event_ms(lambda: F.scaled_dot_product_attention(
        q.permute(tr), k.permute(tr), v.permute(tr), is_causal=True,
        enable_gqa=True), 5, flush)
    flops6 = 4 * dh * B * H * (S * (S + 1) // 2)   # the window holds S
    b6, by6 = bound(nbytes(q, k, v, o6), flops6, BF16_FLOPS)
    log(f"[timing] swa_prefill at RecurrentGemma's prefill shape (B={B}, "
        f"S={S}, H={H}, Hkv={Hkv}, dh={dh}, window {Wc}, bf16, the FMA "
        f"kernel): {ms6:.4f} ms = {flops6 / ms6 / 1e9:.1f} TFLOP/s, plain "
        f"{plain6:.4f}, SDPA {lib6:.4f}, bound {b6:.4f} ({by6})")
    return {"err": err,
            "decode": {"ms": ms5, "plain_ms": plain5, "bound_ms": b5,
                       "bound_by": by5, "library_ms": lib5,
                       "host_inclusive_ms": host5},
            "prefill": {"ms": ms6, "plain_ms": plain6, "bound_ms": b6,
                        "bound_by": by6, "library_ms": lib6}}


def record_routes(fn) -> list:
    """Run ``fn()`` with ``repro_torch.models.layers.moe_route`` wrapped:
    -> the expert ids (T, k) of each MoE call, in call order."""
    from repro_torch.models import layers as L
    orig, seen = L.moe_route, []

    def rec(p, xt, k):
        out = orig(p, xt, k)
        seen.append(out[2])
        return out

    L.moe_route = rec
    try:
        fn()
    finally:
        L.moe_route = orig
    return seen


def route_flips(ids_a: list, ids_b: list) -> float:
    """The share of (token, choice) routes of one path that the other
    does not take: experts in a token's top-k set on one path and not the
    other, over all tokens, choices and layers."""
    miss = tot = 0
    for a, b in zip(ids_a, ids_b, strict=True):
        same = (a[:, :, None] == b[:, None, :]).any(-1)
        miss += int((~same).sum())
        tot += same.numel()
    return miss / tot


def family_main(name: str, dev, flush) -> dict:
    """One family's serve main at published widths, bf16, seeded weights:
    8 requests through ``launch.serve.generate`` (K6 once per attention
    layer in prefill, K5 once per attention layer a decode step, on the
    routes of phase 15a's table), logits held by phase 9's rule against
    the plain serve path and the plain full forward, then timed and the
    decode profiled -> counts and times."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.prng import prng_key, randint_n
    from repro_torch.kernels.swa.ops import prefill_kernel
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M

    arch, S, depth = FAMILY_CELLS[name]
    cfg = get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    tag = f"[{name}]"
    B, GEN = SERVE_B, SERVE_GEN
    t0 = time.perf_counter()
    params = M.init_params(0, cfg, dev)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    weights = nbytes(*leaves)
    nA = attn_layers(cfg)
    log(f"{tag} {cfg.name} ({cfg.source}): {cfg.n_layers} layers"
        + ("" if depth is None else " (depth cut)")
        + f" ({nA} attention), d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, {cfg.dtype}; {n_params} parameters "
        f"({weights / 1e9:.2f} GB; config param_count {cfg.param_count()}) "
        f"drawn in {time.perf_counter() - t0:.2f} s")
    prompts = randint_n(prng_key(0), B * S, 0, cfg.vocab, dev).reshape(B, S)
    stubs = family_stubs(cfg, B, dev)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        toks, lk = generate(params, cfg, prompts, GEN, **stubs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    log(f"{tag} main: {B} requests x {S} prompt tokens"
        + (f" after {n_stub_rows(stubs)} patches" if n_stub_rows(stubs)
           else "") + (f", {cfg.n_frames} frames" if "frames" in stubs
                       else "")
        + f", {GEN} tokens each in {wall:.2f} s, launches {counts}, peak "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    tc6 = prefill_kernel(torch.bfloat16, cfg.head_dim) == "tc"
    require(counts == _only(swa_prefill=nA, swa_prefill_tc=nA * tc6,
                            attn_decode=nA * (GEN - 1),
                            attn_decode_tc=nA * (GEN - 1)),
            f"{tag} K6 once per attention layer in prefill (on its "
            f"{'tensor-core' if tc6 else 'FMA'} kernel) and K5 once per "
            f"attention layer a decode step (tensor cores)")
    require(toks.shape == (B, GEN) and lk.shape == (B, GEN, cfg.vocab)
            and bool(torch.isfinite(lk).all()), f"{tag} serve outputs")
    what = f"{B} x {S} prompt tokens, {GEN} tokens"
    with torch.inference_mode():
        lp = serve_logits(params, cfg, prompts, toks, "torch", stubs)
        require(_counts() == counts, f"{tag} the plain path launched no "
                "kernel")
        if cfg.ffn_kind == "moe":
            moe_checks(tag, params, cfg, prompts, toks, lk, lp, stubs)
        else:
            lf = full_logits(params, cfg, prompts, toks, 2, stubs)
            hold_logits(tag, what, toks, lk, lp, lf)
            del lf
    del lk, lp
    times = serve_times(params, cfg, prompts, toks, stubs=stubs)
    profile_decode(params, cfg, prompts, toks, times["decode_ms"], stubs,
                   FAMILY_PROFILE_STEPS)
    del params, stubs
    torch.cuda.empty_cache()
    return {"launches_prefill": counts["swa_prefill"],
            "launches_decode": counts["attn_decode"],
            "layers": cfg.n_layers, **times}


def moe_checks(tag, params, cfg, prompts, toks, lk, lp, stubs) -> None:
    """OLMoE's logits. Capacity drops depend on how many tokens a call
    routes (cap = ceil(T k / E * 1.25): 2,560 a prefill of 8 x 2,048, 2 a
    decode step of 8), so the full forward, one call over each request's
    whole sequence, drops other assignments than the serve paths: it is
    held at a drop-free capacity (capacity factor E / k, cap = T), where
    serving and the full forward compute one function. At the published
    capacity the kernel path is held against the plain serve path. A
    route flips when bf16 rounding (another attention or GEMM order) moves
    a token's router probabilities across a top-8 tie; the flipped token's
    output then differs by its gate times the difference of two experts'
    outputs, and every later token sees it through attention. The rule is
    phase 9's, relative to the plain serve path's own gap (its GEMM shapes
    differ from the full forward's, so its routes flip too): the kernel
    path's rms gap within twice the plain path's + 1e-3 of the logits' rms,
    its max gap within four times + a bf16 ulp of the largest logit, and
    its greedy choices equal where the margin is clear."""
    import dataclasses

    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    S, GEN = prompts.shape[1], toks.shape[1]
    ids = {}
    for backend in ("auto", "torch"):
        ids[backend] = record_routes(lambda: M.prefill(
            params, cfg, prompts, cache_len=S + GEN + 1, backend=backend))
    flips = route_flips(ids["auto"], ids["torch"])
    T = prompts.numel()
    log(f"{tag} routes on the {T}-token prompt: {flips:.6f} of the "
        f"(token, choice) routes of {len(ids['auto'])} MoE layers differ "
        f"between the kernel and the plain serve path; capacity "
        f"{L.moe_capacity(T, cfg)} a prefill, "
        f"{L.moe_capacity(prompts.shape[0], cfg)} a decode step")
    del ids
    mk, rk = logit_gaps(lk, lp)
    rf = lp.float().pow(2).mean().sqrt().item()
    log(f"{tag} published capacity: kernel path against the plain serve "
        f"path max {mk:.4e} rms {rk:.4e} (logits rms {rf:.4f})")
    # the drop-free run: the same weights, capacity factor E / k
    cfg_df = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                 / cfg.top_k)
    _zero_counts()
    tk, lk2 = generate(params, cfg_df, prompts, GEN)
    lp2 = serve_logits(params, cfg_df, prompts, tk, "torch")
    lf2 = full_logits(params, cfg_df, prompts, tk, 2)
    hold_logits(tag, f"drop-free capacity, {prompts.shape[0]} x {S} "
                f"prompt tokens, {GEN} tokens", tk, lk2, lp2, lf2)
    del lk2, lp2, lf2


def fp32_family_checks(dev) -> None:
    """Phase 15h: each family at 2 layers in float32 (RecurrentGemma at
    3, one whole (rglru, rglru, swa) repeat, so that an attention layer
    runs; Whisper with 2 encoder layers too) on a ragged prompt (4 x 1,000
    tokens, Whisper 4 x 200 after 1,500 frames, InternVL2 after 256
    patches), 16 tokens, through the float32 kernels (K6's FMA kernel, K5's
    split kernel, at 256 with G = 10 on two blocks a split), against the
    plain serve path and the plain full forward, as phases 11 and 15 hold
    them: atol 1e-3 + rtol 1e-3. OLMoE runs at a drop-free capacity (see
    :func:`moe_checks`)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.prng import prng_key, randint_n
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M

    for name, (arch, _, _) in FAMILY_CELLS.items():
        cfg = get_config(arch)
        extra = {"n_layers": 3 if cfg.family == "hybrid" else 2,
                 "dtype": "float32"}
        if cfg.encoder_layers:
            extra["encoder_layers"] = 2
        if cfg.ffn_kind == "moe":
            extra["capacity_factor"] = cfg.n_experts / cfg.top_k
        cfg32 = dataclasses.replace(cfg, **extra)
        S = 200 if cfg.family == "audio" else 1000
        params = M.init_params(1, cfg32, dev)
        p32 = randint_n(prng_key(1), 4 * S, 0, cfg.vocab, dev).reshape(4, S)
        stubs = family_stubs(cfg32, 4, dev, seed=1)
        nA = attn_layers(cfg32)
        with torch.inference_mode():
            _zero_counts()
            t32, l32 = generate(params, cfg32, p32, 16, **stubs)
            require(_counts() == _only(swa_prefill=nA, attn_decode=nA * 15),
                    f"[{name} fp32] launches")
            lp32 = serve_logits(params, cfg32, p32, t32, "torch", stubs)
            lf32 = full_logits(params, cfg32, p32, t32, 4, stubs)
        m32, r32 = logit_gaps(l32, lf32)
        mp32, _ = logit_gaps(lp32, lf32)
        log(f"[{name} fp32] {cfg32.n_layers} layers, 4 x {S} prompt tokens, "
            f"16 tokens: kernel path max {m32:.3e} rms {r32:.3e}, plain "
            f"serve path max {mp32:.3e}, against the plain full forward "
            f"(|logit| up to {lf32.abs().max().item():.3f})")
        torch.testing.assert_close(l32, lf32, atol=1e-3, rtol=1e-3)
        torch.testing.assert_close(lp32, lf32, atol=1e-3, rtol=1e-3)
        require(torch.equal(t32, l32.argmax(-1)),
                f"[{name} fp32] greedy tokens")
        del params, l32, lp32, lf32, stubs
        torch.cuda.empty_cache()


def serve_robust_phase() -> None:
    """``examples/serve_robust_torch.py`` on the card for one family
    (RecurrentGemma at reduced size), in its own process."""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "serve_robust_torch.py"),
         "--arch", "recurrentgemma_2b"], capture_output=True, text=True,
        env=env, timeout=300)
    tail = out.stdout.strip().splitlines()[-1:] or ["(no output)"]
    log(f"[serve_robust_torch] exit {out.returncode}: {tail[0]}")
    require(out.returncode == 0 and tail[0] == "serve_robust OK",
            "examples/serve_robust_torch.py on the card:\n"
            + out.stdout[-2000:] + out.stderr[-2000:])


def family_phases(dev, flush, lap) -> dict:
    """Phases 15c-15h -> K5's and K6's figures of the families."""
    k256 = k5_256_checks(dev, flush)
    lap("phase 15c (K5 at head size 256)")
    mains = {}
    for i, name in enumerate(FAMILY_CELLS):
        mains[name] = family_main(name, dev, flush)
        lap(f"phase 15{'defg'[i]} ({name})")
    fp32_family_checks(dev)
    serve_robust_phase()
    lap("phase 15h (float32 at 2-3 layers, serve_robust_torch)")
    return {"k256": k256, "mains": mains}


# ---------------------------------------------------------------------------
# Decentralized robust training: the trimmed mean (K4) over the workers'
# gradients, and every layer's training forward through K6 (again in the
# remat recompute), its backward a plain recompute
# ---------------------------------------------------------------------------

TRAIN_W, TRAIN_F, TRAIN_BYZ = 8, 2, "2,5"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 1024, 64, 10
# a layer's shapes for the gradient checks: paper_sim's attention (B, S,
# H, Hkv, head 64) and RWKV6-1.6B's WKV scan (B, H, T, head 64)
GRAD_ATTN, GRAD_WKV = (8, 1024, 12, 4), (2, 32, 1024)
EPS32 = float(np.finfo(np.float32).eps)


def train_argv(steps: int, agg: str = "trimmed_mean", workers: int = TRAIN_W,
               byz: str = TRAIN_BYZ, backend: str = "auto",
               seq: int = TRAIN_SEQ, batch: int = TRAIN_BATCH) -> list:
    """``python -m repro_torch.launch.train``'s arguments of a run."""
    return ["--arch", "paper_sim", "--steps", str(steps), "--seq-len",
            str(seq), "--global-batch", str(batch), "--agg", agg,
            "--trim-f", str(TRAIN_F), "--byzantine", byz, "--workers",
            str(workers), "--backend", backend, "--seed", "0"]


def tmean_bound(x, F: int):
    """Per-coordinate limit for two orders of the survivors' float32 sum:
    W * eps32 * sum |x| / (W - 2F), inf and NaN counted as 0."""
    import torch
    W = x.shape[0]
    fin = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    return W * EPS32 * fin.abs().sum(dim=0) / (W - 2 * F) + 1e-30


def hold_tmean(what: str, got, want, x, F: int) -> float:
    """K4 against the plain version: the same NaN and inf, the finite
    values within :func:`tmean_bound` -> the largest finite error."""
    import torch
    torch.cuda.synchronize()
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        require(torch.equal(test(got), test(want)),
                f"trimmed_mean {what}: {test.__name__} pattern")
    fin = torch.isfinite(want)
    err = (got - want).abs()[fin]
    require(bool((err <= tmean_bound(x, F)[fin]).all()),
            f"trimmed_mean {what}: within W eps32 sum|x| / (W - 2F) (max "
            f"err {err.max().item() if err.numel() else 0.0:.3e})")
    return err.max().item() if err.numel() else 0.0


def tmean_kernel_checks(dev, D_full: int) -> float:
    """Phase 16a: K4 against the sort-based plain version (on the CPU at
    the edge cases, where its sort orders NaNs as the reference's) at the
    main path's shape (8 workers, D_full coordinates; rows 2 and 5 the attack
    -10 g) for F in {0, 2}, then at the edge cases: W in {3, 4, 8, 16,
    32, 33, 48, 64} (33 and up through the 64-wide kernel), F up to
    (W - 1) // 2, D in {1, 3, 4097}, a column offset of 1 (a misaligned
    column range read through the row stride), exact ties, a +-1e6
    Byzantine row, inf and NaN rows, rows of NaNs with the sign bit set
    (which sort last, as every NaN), +-0 ties; W <= 2F and W > 64 raise;
    then the plain version on the card bit-equal to its run on the CPU with
    sign-bit NaN rows at W = 33 and 64 -> the largest error at the main
    shape."""
    import torch
    from repro_torch.kernels.trimmed_mean import (W_MAX, trimmed_mean_cuda,
                                                  trimmed_mean_ref)
    g = torch.Generator(device=dev).manual_seed(5)
    # a NaN with its sign bit set (0xFFC00000)
    neg_nan = torch.tensor(-(1 << 22), dtype=torch.int32).view(
        torch.float32).item()
    worst = 0.0
    x = torch.randn((TRAIN_W, D_full), generator=g, device=dev).mul_(1e-3)
    for b in (2, 5):
        x[b].mul_(-10.0)
    for F in (0, TRAIN_F):
        got = trimmed_mean_cuda(x, F)
        worst = max(worst, hold_tmean(f"W=8 D={D_full} F={F}", got,
                                      trimmed_mean_ref(x, F), x, F))
        del got
    del x
    torch.cuda.empty_cache()
    main_err, worst = worst, 0.0
    n_cases = 0
    for W in (3, 4, 8, 16, 32, 33, 48, W_MAX):
        for F in sorted({0, 1, (W - 1) // 2}):
            for D in (1, 3, 4097):
                for case in ("normal", "ties", "byzantine", "non_finite",
                             "nan_sign", "signed_zero"):
                    for offset in (0, 1):
                        x = torch.randn((W, D + offset), generator=g,
                                        device=dev)
                        if case == "ties":
                            x = torch.round(x * 2) / 2
                            x[:, : (D + offset) // 2] = x[0, : (D + offset)
                                                          // 2]
                        elif case == "byzantine":
                            x[W // 2] = 1e6
                            x[0] = -1e6
                        elif case == "non_finite":
                            x[0] = float("nan")
                            x[W - 1] = float("inf")
                        elif case == "nan_sign":   # sorted last all the same
                            x[0] = neg_nan
                            x[W // 2] = neg_nan
                        elif case == "signed_zero":
                            x = torch.round(x).clamp(-1, 1)
                            x[torch.rand(x.shape, generator=g, device=dev)
                              < 0.5] *= -1.0
                        view = x[:, offset:]
                        got = trimmed_mean_cuda(view, F)
                        worst = max(worst, hold_tmean(
                            f"W={W} F={F} D={D} {case} offset={offset}",
                            got, trimmed_mean_ref(view.cpu(), F).to(dev),
                            view, F))
                        n_cases += 1
    # the plain version on the card orders every NaN as the CPU (and the
    # reference's jnp.sort) does: rows of NaNs with the sign bit set beside
    # integer values, with W - 2F a power of two, so every order of the
    # survivors' sum and the mean's division are exact on both devices
    for W, F in ((33, 16), (64, 16), (64, 30)):
        x = torch.randint(-1024, 1025, (W, 64), generator=g,
                          device=dev).float()
        x[0] = neg_nan
        x[W // 2] = neg_nan
        on_card = trimmed_mean_ref(x, F).cpu()
        require(same_bits(on_card, trimmed_mean_ref(x.cpu(), F)),
                f"trimmed_mean_ref W={W} F={F}: the card's result bit-equal "
                f"to the CPU's with sign-bit NaN rows")
    for W, F in ((4, 2), (2, 1), (W_MAX + 1, 1)):
        try:
            trimmed_mean_cuda(torch.zeros((W, 8), device=dev), F)
        except ValueError:
            continue
        raise RuntimeError(f"check failed: trimmed_mean W={W} F={F} must "
                           f"raise")
    log(f"[train kernels] trimmed_mean: at (8, {D_full}) for F in {{0, 2}} "
        f"and {n_cases} edge cases (W 3..{W_MAX}, D 1/3/4097, offset 0/1, "
        f"ties, +-1e6, inf and NaN rows, NaN rows with the sign bit set, "
        f"+-0 ties) within W eps32 sum|x| / (W - 2F) "
        f"of the plain version, NaN/inf where it has them; W <= 2F and W > "
        f"{W_MAX} raise; max_abs_err {main_err:.3e} at the main shape, "
        f"{worst:.3e} over the edge cases (the +-1e6 rows); the plain "
        f"version on the card bit-equal to the CPU's with sign-bit NaN rows "
        f"at W = 33 and 64")
    return main_err


def grad_kernel_checks(dev) -> None:
    """Phase 16b: K6's and K7's gradients through their autograd wrappers
    against autograd of their plain versions at a layer's shape
    (``GRAD_ATTN``: paper_sim's attention at the main path's 8 x 1,024
    tokens a worker; ``GRAD_WKV``: RWKV6-1.6B's 32 heads, 2 x 1,024),
    float32 and bf16. The loss is linear in the outputs
    (a fixed random cotangent), so the backward, a plain recompute, sees
    the same cotangent: the gradients must be bit-equal. The outputs are
    the kernels': held to the serve phases' limits."""
    import torch
    from repro_torch.kernels.swa import (swa_prefill, swa_prefill_cuda,
                                         swa_prefill_ref)
    from repro_torch.kernels.wkv6 import wkv6, wkv6_chunked_ref, wkv6_cuda
    g = torch.Generator(device=dev).manual_seed(6)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    Ba, Sa, Ha, Hkva = GRAD_ATTN
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        q, k, v = (rn(Ba, Sa, h, 64) for h in (Ha, Hkva, Hkva))
        up = rn(Ba, Sa, Ha, 64)
        res = {}
        for backend in ("cuda", "torch"):
            ins = [t.to(dtype).requires_grad_() for t in (q, k, v)]
            before = swa_prefill_cuda.launches
            out = swa_prefill(*ins, 0, backend=backend)
            require(swa_prefill_cuda.launches == before
                    + (backend == "cuda"), "K6 launch through the wrapper")
            (out.float() * up).sum().backward()
            res[backend] = (out.detach(), [t.grad for t in ins])
        torch.cuda.synchronize()
        # K6's output against the plain version in float32 on the same
        # inputs, as phase 8 holds it: a bf16 output is rounded once
        with torch.no_grad():
            want = swa_prefill_ref(*(t.to(dtype).float() for t in (q, k, v)),
                                   0)
        tol = 2 ** -8 if dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(res["cuda"][0].float(), want, rtol=tol,
                                   atol=1e-5)
        del want
        require(all(torch.equal(a, b) for a, b in zip(res["cuda"][1],
                                                      res["torch"][1])),
                f"K6 gradients bit-equal to plain autograd ({name})")
        del q, k, v, up, res, out, ins
        B, H, T = GRAD_WKV
        r, kk, vv = (rn(B * H, T, WKV_HEAD) for _ in range(3))
        lw = -torch.exp(torch.clamp(-0.5 + rn(B * H, T, WKV_HEAD), -8, 4))
        u = 0.5 * rn(H, WKV_HEAD)
        gy, gs = rn(B, H, T, WKV_HEAD), rn(B, H, WKV_HEAD, WKV_HEAD)
        res = {}
        for backend in ("cuda", "torch"):
            ins = [t.to(dtype).requires_grad_() for t in (r, kk, vv)] \
                + [lw.clone().requires_grad_()]
            uu = u.clone().requires_grad_()
            args = [t.view(B, H, T, WKV_HEAD) for t in ins] \
                + [uu.expand(B, H, WKV_HEAD)]
            before = wkv6_cuda.launches
            if backend == "cuda":
                y, s = wkv6(*args)
            else:
                y, s = wkv6_chunked_ref(*(a.reshape((-1,) + a.shape[2:])
                                          for a in args), chunk=64)
                y = y.view(B, H, T, WKV_HEAD)
                s = s.view(B, H, WKV_HEAD, WKV_HEAD)
            require(wkv6_cuda.launches == before + (backend == "cuda"),
                    "K7 launch through the wrapper")
            ((y.float() * gy).sum() + (s * gs).sum()).backward()
            res[backend] = [t.grad for t in ins] + [uu.grad]
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(res["cuda"],
                                                      res["torch"])),
                f"K7 gradients bit-equal to plain autograd ({name})")
        del r, kk, vv, lw, u, gy, gs, res, ins, y, s
        torch.cuda.empty_cache()
        log(f"[train kernels] K6 (B, S, H, Hkv = {GRAD_ATTN}, heads of 64) "
            f"and K7 (B, H, T = {GRAD_WKV}) through their autograd "
            f"wrappers, {name}: outputs within the kernels' limits, "
            f"gradients bit-equal to plain autograd")


def run_steps(step, params, opt, data, steps: int, dev, robust=True,
              on_step=None) -> list[float]:
    """``steps`` steps as ``launch.train.main`` runs them -> the losses."""
    import torch
    from repro_torch.core.prng import fold_in, prng_key
    key = prng_key(0)
    losses = []
    for s in range(steps):
        batch = data.batch(s, dev)
        if robust:
            params, opt, loss = step(params, opt, batch, fold_in(key, s))
        else:
            params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
        if on_step is not None:
            on_step(s, step)
    torch.cuda.synchronize()
    return losses


def rel_rms(a, b) -> float:
    return ((a.float() - b.float()).square().mean().sqrt()
            / b.float().square().mean().sqrt().clamp_min(1e-30)).item()


def train_phases(dev, flush) -> dict:
    """Phases 16-18 (decentralized robust training of paper_sim) -> the
    JSON entry of K4."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.aggregation import (GOSSIP_COLS,
                                                     AggregatorConfig)
    from repro_torch.distributed.trainer import (TrainConfig,
                                                 make_train_step,
                                                 param_spread,
                                                 replicate_for_workers,
                                                 worker_opt_init)
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.train import build, parse_args
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import leaves

    cfg = get_config("paper_sim")
    D_full = cfg.param_count() + cfg.d_model      # + the final norm

    # ---- phase 16: K4, and the K6/K7 autograd wrappers --------------------
    err = tmean_kernel_checks(dev, D_full)
    grad_kernel_checks(dev)

    # ---- phase 17: paper_sim at full width and depth, 8 workers ---------
    runs = {}
    for backend in ("auto", "torch"):
        args = parse_args(train_argv(TRAIN_STEPS, backend=backend))
        tc, data, pw, ow, step, layout = build(args, record=True)
        n_params = sum(t[0].numel() for t in leaves(pw))
        first = {}

        def keep_first(s, st, first=first):
            if s == 0:
                first["agg"] = st.aggregate[0].clone()
            del st.grads, st.aggregate

        _zero_counts()
        t0 = time.perf_counter()
        losses = run_steps(step, pw, ow, data, TRAIN_STEPS, dev,
                           on_step=keep_first)
        wall = time.perf_counter() - t0
        counts = _counts()
        spread = param_spread(pw).item()
        runs[backend] = (losses, first["agg"], counts)
        log(f"[train] {backend}: paper_sim {cfg.n_layers} layers d_model "
            f"{cfg.d_model} {cfg.n_heads}/{cfg.n_kv_heads} heads of "
            f"{cfg.head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab} {cfg.dtype}, "
            f"{n_params} parameters a copy; {TRAIN_W} workers, trimmed_mean "
            f"F={TRAIN_F}, Byzantine {TRAIN_BYZ} (scale "
            f"{tc.byzantine_scale}), {TRAIN_BATCH} x {TRAIN_SEQ} tokens a "
            f"step; {TRAIN_STEPS} steps in {wall:.2f} s; losses "
            f"{[round(x, 4) for x in losses]}; param_spread {spread!r}; "
            f"launches {counts}")
        require(n_params == D_full, "D_total == param_count + final norm")
        require(all(np.isfinite(losses)), "losses finite")
        require(spread == 0.0, "param_spread exactly 0")
        if backend == "auto":
            n_k6 = TRAIN_STEPS * TRAIN_W * cfg.n_layers * 2
            require(counts == _only(trimmed_mean=TRAIN_STEPS,
                                    swa_prefill=n_k6, swa_prefill_tc=n_k6),
                    "K4 once a step, K6 per layer, worker, forward and "
                    "remat, every launch on its tensor-core kernel")
            require(losses[-1] < losses[0], "the loss falls")
        else:
            require(counts == _only(), "the plain path launched no kernel")
        del pw, ow, step, first
        torch.cuda.empty_cache()
    (lk, ak, _), (lp, ap, _) = runs["auto"], runs["torch"]
    agg_gap = rel_rms(ak, ap)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    log(f"[train] kernel vs plain path: first-step aggregate relative rms "
        f"{agg_gap:.3e} (rms {ap.square().mean().sqrt().item():.3e}), "
        f"largest relative loss gap over {TRAIN_STEPS} steps {loss_gap:.3e}")
    # Tolerance (bf16): the two paths round the attention's bf16 output
    # differently (K6's online softmax against the plain one), ~2^-8 of an
    # entry; the flips grow through 8 layers and the backward and move
    # which worker survives a near-tied trim. A missing or wrong gradient
    # term moves the aggregate by O(1) of its rms. Limits: 0.1 relative rms
    # on the aggregate, 1e-2 on the losses.
    require(agg_gap < 0.1, "first-step aggregates agree")
    require(loss_gap < 1e-2, "losses agree")
    counts_main = runs["auto"][2]
    del runs, ak, ap

    # ---- phase 17b: 2 layers in float32, 3 steps ------------------------
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    out = {}
    for backend in ("auto", "torch"):
        args = parse_args(train_argv(3, backend=backend))
        _, data, pw, ow, step, _ = build(args, cfg32)
        _zero_counts()
        out[backend] = (run_steps(step, pw, ow, data, 3, dev), pw, _counts())
    (l32k, p32k, c32), (l32p, p32p, _) = out["auto"], out["torch"]
    require(all(torch.equal(t[0], t[w]) for t in leaves(p32k)
                for w in range(1, TRAIN_W)), "fp32 copies equal")
    require(c32 == _only(trimmed_mean=3, swa_prefill=3 * TRAIN_W * 2 * 2),
            "fp32 launches")
    lgap = max(abs(a - b) / abs(b) for a, b in zip(l32k, l32p))
    n_off = n_all = 0
    gap = 0.0
    for a, b in zip(leaves(p32k), leaves(p32p)):
        n_off += int(((a - b).abs() > 1e-4 * b.abs() + 1e-6).sum())
        n_all += b.numel()
        gap = max(gap, (a - b).abs().max().item())
    lr = parse_args(train_argv(3)).lr
    log(f"[train fp32] 2 layers, 3 steps: losses {l32k}; kernel vs plain "
        f"largest relative loss gap {lgap:.3e}; parameters off by more "
        f"than 1e-4 relative + 1e-6: {n_off} of {n_all}, largest gap "
        f"{gap:.3e}")
    # Tolerance (fp32): the same float32 math in another order (K6 against
    # the naive attention, ~1e-6 relative): losses within 1e-4 relative,
    # parameters within 1e-4 relative + 1e-6. AdamW's update m / sqrt(v)
    # is ~sign(g), so a coordinate whose gradient is within rounding of
    # zero can move the other way on one path: at most 1e-4 of the
    # coordinates may do so, and none by more than 2 lr a step.
    require(lgap < 1e-4 and n_off <= 1e-4 * n_all and gap <= 2 * lr * 3,
            "fp32 kernel path = plain path")
    del out, p32k, p32p

    # ---- phase 17c: hierarchical_trim, 2 pods x 4, one worker at ~1e6 ----
    data = SyntheticLMData(cfg.vocab, 256, 16, flavour="markov", seed=0)
    tc = TrainConfig(arch=cfg32, agg=AggregatorConfig(
        kind="hierarchical_trim", F=1), opt=AdamWConfig(
        warmup_steps=1, total_steps=2), byzantine_workers=(3,),
        byzantine_scale=1e6)
    pw = replicate_for_workers(M.init_params(0, cfg32, dev), 8)
    ow = worker_opt_init(pw)
    step = make_train_step(tc, (2, 4), record=True)
    bounded = []

    def check_bounded(s, st):
        G, agg = st.grads, st.aggregate[0]
        honest = torch.cat([G[:3], G[4:]]).abs().amax(dim=0)
        bounded.append((agg.abs() <= honest).all().item())
        log(f"[train hier] step {s}: Byzantine row |g| up to "
            f"{G[3].abs().max().item():.3e}, honest up to "
            f"{honest.max().item():.3e}, aggregate up to "
            f"{agg.abs().max().item():.3e}")
        del st.grads, st.aggregate

    _zero_counts()
    hl = run_steps(step, pw, ow, data, 2, dev, on_step=check_bounded)
    require(all(bounded), "the hierarchical trim's aggregate stays within "
            "the honest gradients, coordinate by coordinate")
    require(_counts() == _only(trimmed_mean=2 * 3,
                               swa_prefill=2 * 8 * 2 * 2),
            "K4 once per pod and once across pods a step")
    # (float32 copies are compared directly: the mean of 8 equal float32
    # values that param_spread takes need not round back to the value)
    require(all(np.isfinite(hl)) and all(
        torch.equal(t[0], t[w]) for t in leaves(pw) for w in range(1, 8)),
        "hierarchical run finite, every copy equal")
    del pw, ow, step

    # ---- phase 17d: pushsum_sparse at 2 layers, through K1 ----------------
    args = parse_args(train_argv(2, agg="pushsum_sparse", byz=""))
    tc, data, pw, ow, step, _ = build(args, cfg32)
    _zero_counts()
    pl = run_steps(step, pw, ow, data, 2, dev)
    D2 = sum(t[0].numel() for t in leaves(pw))
    passes = -(-D2 // GOSSIP_COLS)
    ps_spread = param_spread(pw).item()
    log(f"[train pushsum_sparse] 2 layers, 2 steps, D {D2} in {passes} "
        f"passes: losses {pl}, param_spread {ps_spread:.3e}, launches "
        f"{_counts()}")
    require(_counts() == _only(
        edge_scatter=2 * tc.agg.gossip_rounds * passes,
        swa_prefill=2 * TRAIN_W * 2 * 2), "K1 once a gossip round and pass")
    require(all(np.isfinite(pl)) and 0.0 < ps_spread < 1e-2,
            "pushsum_sparse: finite, copies near consensus")
    del pw, ow, step
    torch.cuda.empty_cache()

    # ---- phase 17e: a 2-layer RWKV6-1.6B training step through K7 ----------
    rcfg = dataclasses.replace(get_config("rwkv6_1b6"), n_layers=2,
                               dtype="float32")
    params = M.init_params(0, rcfg, dev)
    data = SyntheticLMData(rcfg.vocab, 512, 4, flavour="markov", seed=0)
    batch = data.batch(0, dev)
    grads = {}
    _zero_counts()
    for backend in ("auto", "torch"):
        ps = [p.detach().requires_grad_() for p in leaves(params)]
        it = iter(ps)
        tree = _refill(params, it)
        loss = M.loss_fn(tree, rcfg, batch["tokens"], batch["labels"],
                         backend)
        grads[backend] = (loss.item(), torch.autograd.grad(loss, ps))
    torch.cuda.synchronize()
    require(_counts() == _only(wkv6=2 * 2), "K7 per layer, forward and remat")
    rk, gk = grads["auto"]
    rp, gp = grads["torch"]
    from repro_torch.checkpoint.ckpt import key_paths
    names = [k for k, _ in key_paths(params)]
    gaps = sorted(((rel_rms(a, b), ((a - b).abs().max()
                                    / b.abs().max()).item(), n)
                   for a, b, n in zip(gk, gp, names)), reverse=True)
    log(f"[train rwkv] 2-layer RWKV6-1.6B, float32, 4 x 512 tokens: loss "
        f"{rk:.6f} (plain {rp:.6f}); gradient gaps to the plain path, "
        f"(relative rms, largest / the leaf's largest entry), worst leaves "
        f"first: " + "; ".join(f"{n} {r:.3e} {m:.3e}"
                               for r, m, n in gaps[:4]))
    # Tolerance (fp32): K7 agrees with the plain chunked form within ~1e-4
    # of the outputs' scale (phase 12) and the backward recomputes the
    # plain form from the same inputs, so the gradients differ only by the
    # forward's rounding carried through the groupnorm and the later layer
    # (a few 1e-3 at a leaf's worst entry); a missing or wrong gradient
    # term moves a leaf by O(1) of its rms. Limits: loss 1e-4 relative,
    # every leaf within 1e-2 relative rms.
    require(abs(rk - rp) <= 1e-4 * abs(rp) and gaps[0][0] < 1e-2,
            "RWKV6 gradients through K7 = the plain path's")
    del params, grads, gk, gp
    torch.cuda.empty_cache()

    # ---- phase 18: timing ---------------------------------------------------
    times = tmean_times(dev, flush, D_full)
    train_timing(dev, times["ms"])
    return {"name": "trimmed_mean", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/trimmed_mean.cu",
            "replaces": "src/repro/kernels/trimmed_mean/trimmed_mean.py:69",
            "launches": counts_main["trimmed_mean"], "max_abs_err": err,
            **times}


def _refill(tree, it):
    """``tree`` with its leaves, in ``leaves`` order, taken from ``it``."""
    if isinstance(tree, dict):
        out = {k: _refill(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_refill(t, it) for t in tree)
    return next(it)


def tmean_times(dev, flush, D_full: int) -> dict:
    """K4 at the main path's shape (8 workers, D_full coordinates, the
    attack rows in place) for F in {0, 2}, each :func:`three_ways`; its
    plain version (host-inclusive) and ``torch.mean`` (host hidden); its
    bound -> K4's JSON timings at F = 2, F = 0's beside them."""
    import torch
    from repro_torch.kernels.trimmed_mean import (trimmed_mean_cuda,
                                                  trimmed_mean_ref)
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((TRAIN_W, D_full), generator=g, device=dev).mul_(1e-3)
    x[2].mul_(-10.0)
    x[5].mul_(-10.0)
    out = torch.empty(D_full, device=dev)
    t = {F: three_ways(lambda F=F: trimmed_mean_cuda(x, F, out=out),
                       TIMED_RUNS, flush) for F in (0, TRAIN_F)}
    plain = {F: event_ms(lambda F=F: trimmed_mean_ref(x, F), 3, flush)
             for F in (0, TRAIN_F)}
    lib = event_ms(lambda: torch.mean(x, 0), TIMED_RUNS, flush, True)
    # bytes: x read once, the output written once; operations: per
    # coordinate 2F extraction rounds of W compares and W adds
    bnd = {F: bound(nbytes(x, out), D_full * TRAIN_W * (2 * F + 1))
           for F in (0, TRAIN_F)}
    for F in (0, TRAIN_F):
        log(f"[timing] trimmed_mean (W={TRAIN_W}, D={D_full}, F={F}): "
            f"device {t[F]['ms']:.5f} ms with the host hidden, kernel alone "
            f"{t[F]['kernel_ms']} (profiler), host-inclusive "
            f"{t[F]['host_inclusive_ms']:.5f}; plain {plain[F]:.5f} "
            f"(host-inclusive); bound {bnd[F][0]:.5f} ({bnd[F][1]})"
            + (f"; torch.mean {lib:.5f} (host hidden)" if F == 0 else
               "; library: none (no single call)")
            + "; medians, L2 flushed")
    del x, out
    torch.cuda.empty_cache()
    return {**t[TRAIN_F], "plain_ms": plain[TRAIN_F],
            "bound_ms": bnd[TRAIN_F][0], "bound_by": bnd[TRAIN_F][1],
            "library_ms": lib, "f0_ms": t[0]["ms"],
            "f0_kernel_ms": t[0]["kernel_ms"],
            "f0_host_inclusive_ms": t[0]["host_inclusive_ms"],
            "f0_plain_ms": plain[0]}


def train_timing(dev, k4_ms: float) -> None:
    """Phase 18's steps: step times of the main configuration on the kernel
    and plain paths (medians of 5, in turns), the peak memory and a
    profile of a kernel-path step; ``k4_ms`` is K4's time, put beside the
    step's."""
    import torch
    from repro_torch.core.prng import fold_in, prng_key
    from repro_torch.launch.train import build, parse_args

    # step times, kernel and plain paths in turns
    key = prng_key(0)
    setups = {}
    for backend in ("auto", "torch"):
        args = parse_args(train_argv(TRAIN_STEPS, backend=backend))
        _, data, pw, ow, step, _ = build(args)
        setups[backend] = (data, pw, ow, step)
    batches = [setups["auto"][0].batch(s, dev) for s in range(2)]

    def one(backend, s):
        _, pw, ow, step = setups[backend]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(pw, ow, batches[s % 2], fold_in(key, s))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for backend in ("auto", "torch"):
        one(backend, 0)                                  # warm-up
    walls = {"auto": [], "torch": []}
    for s in range(5):
        for backend in (("auto", "torch") if s % 2 == 0
                        else ("torch", "auto")):
            walls[backend].append(one(backend, s + 1))
    step_ms = {b: float(np.median(w)) for b, w in walls.items()}
    torch.cuda.reset_peak_memory_stats()
    one("auto", 7)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[timing] train step (paper_sim, {TRAIN_W} workers x "
        f"{TRAIN_BATCH // TRAIN_W} x {TRAIN_SEQ} tokens, trimmed_mean): "
        f"kernel path {step_ms['auto']:.2f} ms, plain path "
        f"{step_ms['torch']:.2f} ms (medians of 5, in turns: "
        f"{[round(v, 1) for v in walls['auto']]} / "
        f"{[round(v, 1) for v in walls['torch']]}); peak memory of a "
        f"kernel-path step {peak:.2f} GB; K4 {k4_ms:.4f} ms = "
        f"{k4_ms / step_ms['auto']:.2e} of the step")
    del setups["torch"]
    torch.cuda.empty_cache()
    profile_step(lambda T: [one("auto", 10 + t) for t in range(T)],
                 "paper_sim train (8 workers)", step_ms["auto"], steps=2)
    del setups
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
