"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: Algorithm 3
(social learning), Algorithm 2 (Byzantine-resilient learning), Algorithm 1
(push-sum consensus and hierarchical push-sum), grids of Algorithm 1, 2
and 3 scenarios run as one graph, the serving path of every model family
(Qwen3-8B, RWKV6-1.6B, OLMoE-1B-7B, RecurrentGemma-2B, Whisper-small,
InternVL2-26B), on one process and over model ranks, and decentralized
robust training (paper_sim; OLMoE-1B-7B, Whisper-small and
InternVL2-26B).

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
             and 64; K5's rank-partial mode on each block of a ring at
             RecurrentGemma's per-rank shape (8 requests, 10 query heads on
             one KV head of 256, 1,024 and 512 rows of a 2,048-row ring; a
             wrapped ring, empty blocks, ragged lengths; bf16 and float32)
             against its plain version, an empty block's triple exactly
             (0, -inf, 0), and the blocks' merge through K5's combine
             kernel against the plain merge and the whole decode;
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
             prefill attention (K6: its tensor-core kernel for bf16, its
             FMA kernel for float32) against their plain versions at the
             serve path's full shapes, at RecurrentGemma-2B's prefill and
             rank shapes, at the training shape, and at edge cases
             (ragged cache, lengths < Wc
             and inside 64-row tiles, a ring window, a cache shorter than a
             tile, empty requests, G in {1, 3, 4, 8, 16}; window in {0, w},
             a window edge inside a query tile, S not a multiple of the
             tile, strided views), with stated tolerances, each case on
             the kernel its dtype picks;
9. serve main — Qwen3-8B at published widths and 12 of its 36 layers
             (cut to make room for phase 24), bf16, seeded random weights:
             8 requests of 2,048-token prompts, 32 greedy tokens through
             launch.serve.generate (prefill, then 31 decode steps; K6
             launches 12 times and K5 12 x 31, all on their tensor-core
             kernels); its logits
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
13. rwkv main — RWKV6-1.6B at published widths and 8 of its 24 layers
             (cut to make room for phase 24), bf16, seeded random
             weights: 8 requests of 2,048-token prompts, 32 greedy tokens
             through launch.serve.generate (K7 launches 8 times, decode
             none); its
             logits against the plain serve path and the plain full
             forward;
14. rwkv timing — K7 (device time with the host hidden, and
             host-inclusive) and its plain version at the serve shape,
             beside its bound and its design's floor; time to prefill and
             ms per decode step, kernel and plain paths, a profile of
             decode steps;
15. rwkv fp32 — 2 layers in float32, 4 x 1,000-token prompts (a ragged
             last chunk), 16 tokens, against the plain full forward; then
             phase 13's 8 layers in float32 (2 x 2,048-token prompts, 8
             tokens) by the rule of phase 13, where the greedy choices must
             agree on at least half the positions;
15c-15h. families serve — K5 at head size 256 with G 10 and 16 against
             its plain version; OLMoE-1B-7B, RecurrentGemma-2B,
             Whisper-small and InternVL2-26B served at published widths
             (Whisper at full depth; OLMoE at 8 of 16 layers,
             RecurrentGemma at 13 of 26, InternVL2 at 6 of 48) through
             K5/K6 against
             the plain paths (OLMoE's logits at a drop-free capacity), timed
             and profiled; each at 2-3 layers in float32;
             examples/serve_robust_torch.py;
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
             both paths (medians of 3, in turns), peak memory and a
             profile of a kernel-path step;
19. family train kernels — K6's gradients through SwaPrefillFn against
             plain autograd at the three families' training shapes (bf16;
             OLMoE 4 x 1,024 at head 128, Whisper's decoder 2 x 448 at
             64, InternVL2 4 x 2,048 at 128 with G 6), held as phase 16
             holds them; K4 against its plain version at each robust
             cell's (W, D_total) (OLMoE (3, ~1.05e9) F 1, Whisper (8,
             ~2.24e8) F 2), each timed with the host hidden beside its
             byte bound and torch.mean(x, 0);
20. family train mains — through launch.train.build at published
             widths, bf16, seeded weights, 10 steps (the plain path 3),
             the stub inputs in
             each batch: OLMoE-1B-7B at 2 layers (stacked, remat),
             trimmed_mean W 3 F 1, Byzantine 1, 3 x 4 x 1,024 tokens;
             Whisper-small at 4 + 4 of its 12 + 12 layers (full depth
             before phase 26), trimmed_mean W 8 F 2, Byzantine
             2 and 5, 8 x 2 x 448 tokens with 1,500 float32 frames a row;
             InternVL2-26B at 2 layers, mean, lr 3e-5, 4 x (256 float32
             patches + 1,792 tokens). K6 workers x layers x 2 a step
             (forward and remat) on its tensor-core kernel, K4 once a
             robust step; the
             loss falls, the copies equal, the plain path agrees (losses,
             first-step aggregate; OLMoE's plain first step on the kernel
             path's routes, the recompute's routes equal the forward's);
             examples/robust_training_torch.py at 100 of its default 200
             steps (cut to make room for phase 24) runs in its own process
             beside the Whisper and InternVL2 cells (their logged walls
             are on a shared card), its loss falling;
21. family train timing — K6 at the three training shapes (host
             hidden) beside its plain version, bound and SDPA; each cell's
             step on both paths (medians of 2, in turns), a profile of a
             kernel-path step and its peak memory;
22. analysis — repro_torch.statics' lint on the kernel path (every
             engine contract's fixture under the op recorder: no (N, N)
             value, no (T, *) value in the reducing stores but the
             horizon-major key words and coins, no subnormal literal; the
             stream proofs; the signatures; no float32 carry under bf16),
             K1, K2 and K3 launched, and a synthetic (N, N) value on the
             card caught; HW() beside the card's name, power limit and
             memory;
23. multi-device engines — benchmarks/pushsum_sweep.py:285's cell (N =
             2^20, E ~ 2.1 M, d = 1) cut into 8 edge shards on the emulated
             graph axis, T = 50, float32 psum and bf16 scatter: K1 once a
             round for all 8 shards, a round from a common state against
             the unsharded round on the padded list (interior receivers
             bit-equal, boundary receivers within the order bound; bf16
             within the reduced rows' rounding), the runs side by side, the
             halo bytes the axis counts equal to the wire model, K1 at the
             (8 x 2^20)-receiver shape against its plain version and bound,
             step times; Alg. 3's main cell on 4 shards (a boundary-free
             cut) bit-equal to the unsharded run; the 2-D program on a
             1 x 1 NCCL mesh bit-equal to its one-process run; whether
             gloo takes CUDA tensors, and 2 gloo ranks on this card (a
             2-shard graph axis across processes) bit-equal to the
             emulation;
24. the model stack over ranks — gloo ranks sharing this card, each one
             process with its own copy or its model blocks: (a) which
             collectives gloo takes on CUDA tensors (the refusals must be
             what the rank communicator stages through host memory); (b)
             paper_sim at published widths and 4 of its 8 layers (8
             before phase 26) on 4 ranks, 2 robust steps of
             trimmed_mean (F 1, Byzantine 2), hierarchical_trim on 2 x 2
             (F 0), the sharded trim and pushsum_sparse, and one step of
             pushsum on 2 x 2 (its ring sends staged through host memory,
             the calls and bytes each rank staged equal to what the keys
             give), every rank's parameters, losses and first aggregate
             against row w of the one-process 4-worker step
             (bit-equality reported; parameters within one bf16 ulp of
             each leaf's largest entry, losses within 1e-3, the
             aggregate's rel rms within 1e-2), K4 on every rank (K1 for
             pushsum_sparse); (c) Qwen3-8B at 4 of 36 layers (36 before
             phase 26, then 12) tensor-parallel
             on model 2 (16 query heads on 4 KV heads a rank through K6,
             K5 at G 4), 2 x 2,048-token prompts and 8 tokens
             teacher-forced, held by phase 9's rule against the
             one-process kernel path, which phase 9's rule holds against
             the plain full forward at these layers; (d) OLMoE-1B-7B at
             8 layers expert-parallel (32 experts a rank) at a drop-free
             capacity, prefill and 4 decode steps the same way, then at 2
             layers in float32, 8 tokens, within atol 1e-3 + rtol 1e-3
             and with a clear top-2 margin on at least half the positions
             for the greedy rule; (e) paper_sim's mean
             step at 2 layers on model 2, 3 losses within 1e-2 of one
             process; (f) (c)'s requests through the mesh-taking steps on
             a 1 x 1 NCCL mesh, bit-equal to the one-process run; K4, K1,
             K5 and K6 at these shapes beside their plain versions, bounds
             and library calls;
25. the other families over model ranks — 4 gloo ranks sharing this
             card, each serving its model blocks (init_local_params) through
             the mesh-taking steps, 2 x 2,048-token prompts and 16 decode
             steps teacher-forced on the one-process bf16 kernel path's
             greedy tokens, each run in bf16 and in float32 (the same
             weights upcast): RecurrentGemma-2B at 3 layers (one (rglru,
             rglru, swa) pattern) on (data 2 x model 2) and (model 4) (its
             one KV head of 256 split over the 2,048-row ring's rows,
             which the first decode step wraps into rank 0's block; 10
             query heads as 5 and 2.5 a rank; K6 on the heads a rank
             attends with, K5's rank-partial mode and its merge once a
             decode step); RWKV6-1.6B at 4 layers (K7 on 16 heads a rank),
             Whisper-small at full depth and InternVL2-26B at 2 layers
             (K5/K6 on local heads, their odd vocabularies whole on every
             rank) on (data 2 x model 2). The float32 rank path is held
             within 1e-4 of the one-process float32 kernel path, greedy
             equal where the margin is clear on at least half the
             positions; the bf16 rank path by phase 9's bounds against the
             one-process float32 path, the one-process bf16 kernel path
             as the noise, and its greedy choices equal the one-process
             bf16 ones where the margin is clear, on at least a tenth of
             the positions. RecurrentGemma on a 1 x 1 NCCL mesh
             bit-equal to one process; the rank-partial K5, its merge, K6
             on gathered heads and K7 on local heads timed beside their
             plain versions, bounds and library calls.
26. the families trained over model ranks — 4 gloo ranks sharing this
             card train their blocks through make_train_step(mesh=), 2
             mean steps a run at published widths: RWKV6-1.6B (2 layers)
             and RecurrentGemma-2B (3 layers, model 4) in bf16 and
             float32, Whisper-small at full depth, InternVL2-26B (2
             layers) under FSDP, Qwen3-8B (2 layers) under FSDP in bf16
             and float32 (each FSDP run holding less than its whole
             blocks); float32 losses within 1e-4
             relative of the one-process float32 kernel path and the first
             step's gradients, block by block, within 2e-5 of each leaf's
             scale beyond twice the leaf's own float32 noise; bf16 losses
             by phase 9's rule; one bf16 robust trimmed_mean step of
             RecurrentGemma on (data 2 x model 2), its aggregate against
             the float32 gradient and its parameters against the first
             AdamW step of that aggregate; a 1 x 1 NCCL FSDP mesh bit-equal
             to one process; K6, K7 and K4 at the rank shapes timed.

Phases 3, 5, 6b, 6c, 9 and 18 also print their run's peak memory beside
repro_torch.analysis' memory model, and require the bytes the run itself
allocated (peak less what was allocated when it started) to be at least
the model's terms for what the run allocates: node and edge state for the
engines, the KV cache for serve, the gradient rows and residuals for a
train step. Phase 7 prints each engine step beside its H100 floor
(repro_torch.statics.memory's step bytes on HW()) and requires none under
it (a sanity bound: the steps are host-bound, hundreds of times their
floors, so only a byte model or a constant off by as much fails it);
phases 10 and 18 print the model-FLOPs utilization of Qwen3-8B's
prefill and decode and of the paper_sim train step.

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

import gc
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
TIMED_RUNS = 30
# (10 runs before phase 24, 6 before 26; 50 steps a run before the time
# limit's cut)
STEP_RUNS, STEP_T = 3, 25
BYZ_F, BYZ_AGENTS, BYZ_GAMMA = 2, (2, 9), 10
SERVE_B, SERVE_S, SERVE_GEN = 8, 2048, 32
# serve mains' depths at published widths (36 and 24 layers published; cut
# to make room for phase 24 in the script's time limit)
SERVE_QWEN_LAYERS, SERVE_RWKV_LAYERS = 12, 8
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


_HW = []


def hw():
    """The card's data-sheet constants,
    ``repro_torch.analysis.roofline.HW()``: its HBM rate (``hbm_bw``), its
    float32 rate outside the tensor cores (``fp32_flops``) and its dense
    bf16 tensor-core rate (``peak_flops``). Loaded from this checkout's
    file, so a tool that runs another tree's ``src/`` reads the same."""
    if not _HW:
        import importlib.util
        path = SRC / "repro_torch" / "analysis" / "roofline.py"
        spec = importlib.util.spec_from_file_location("_smoke_roofline",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _HW.append(mod.HW())
    return _HW[0]


def bound(bytes_moved: int, flops: int,
          peak: float | None = None) -> tuple[float, str]:
    """(ms, "bytes" | "operations"): the larger of the bytes over the HBM
    rate and the operations over ``peak`` (default the float32 rate)."""
    peak = hw().fp32_flops if peak is None else peak
    t_bytes = bytes_moved / hw().hbm_bw * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def peak_run(label: str, fn, model: tuple):
    """``fn()`` with the device's peak memory reset just before it ->
    ``fn``'s result. Prints the peak beside ``model``, a memory model's
    ``(prediction, own bytes, what they are, note)``, and requires the
    bytes the run itself allocated (the peak less what was allocated when
    it started) to be at least ``own``: the model's terms for what the run
    allocates."""
    import torch
    pred, own, what, note = model
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    terms = ", ".join(f"{k} {v}" for k, v in pred.items()
                      if k.endswith("_gb") and k != "total_gb")
    total_gb = pred["total_gb"]
    log(f"[memory] peak {label}: measured {peak / 1e9:.3f} GB (allocated at "
        f"its start {base / 1e9:.3f}, the run's own {(peak - base) / 1e9:.3f}"
        f"); predicted {total_gb:.6g} GB ({terms}); measured / predicted "
        f"{peak / 1e9 / total_gb:.3f}, the run's own / predicted "
        f"{(peak - base) / 1e9 / total_gb:.3f}; the model's {what}: "
        f"{own / 1e9:.6f} GB, the run's own / that "
        f"{(peak - base) / own:.3f}" + (f"; {note}" if note else ""))
    require(peak - base >= own, f"{label}: the run allocates at least the "
            f"model's {what}")
    return out


def engine_memory(N: int, E: int, d: int) -> tuple:
    """``peak_run``'s model of an engine run that carries push-sum's node
    and edge state (Alg. 3, HPS, push-sum): the run allocates them."""
    from repro_torch.analysis import pushsum_device_memory_gb
    pred = pushsum_device_memory_gb(N, E, d)
    own = N * (2 * d + 2) * 4 + E * (d + 1) * 4
    return pred, own, "node plus edge state", ""


def byz_memory(N: int, deg: int, m: int) -> tuple:
    """``peak_run``'s model of Alg. 2's run: push-sum's model with d + 1 =
    m^2; the run allocates its node state (the pairwise statistic r and
    the cumulative LLR). K3 reads the neighbours' r in place, so the model's
    per-slot edge term is not allocated."""
    from repro_torch.analysis import pushsum_device_memory_gb
    d = m * m - 1
    pred = pushsum_device_memory_gb(N, N * deg, d)
    return pred, N * (2 * d + 2) * 4, "node state (r, cumulative LLR)", (
        "push-sum's model with d + 1 = m^2, whose per-slot edge term K3 "
        "does not hold")


def serve_memory(cfg, B: int, S: int, cache_len: int) -> tuple:
    """``peak_run``'s model of a serve run (prefill + decode): the
    parameters are allocated before it, the run allocates the KV cache."""
    from repro_torch.analysis import serve_memory_gb
    from repro_torch.configs import InputShape
    pred = serve_memory_gb(cfg, InputShape("serve", S, B, "prefill"), {},
                           cache_len)
    cache = sum(2 * B * cfg.n_kv_heads * cache_len * cfg.head_dim * 2
                for i in range(cfg.n_layers)
                if cfg.mixer_of(i) in ("attn", "swa"))
    return pred, cache, "KV cache", ""


def train_memory(W: int) -> tuple:
    """``peak_run``'s model of one paper_sim train step of ``W`` workers:
    the workers' copies are allocated before it; the step allocates the
    (W, P) float32 gradient rows (the model's float32 gradient term, once a
    worker) and a worker's saved residuals."""
    from repro_torch.analysis import train_memory_gb
    from repro_torch.configs import InputShape, get_config
    cfg = get_config("paper_sim")
    shape = InputShape("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    pred = train_memory_gb(cfg, shape, {"data": W}, False, 1,
                           worker_axis=True)
    resid = (cfg.n_layers // max(cfg.remat_group, 1)
             * (TRAIN_BATCH // W) * TRAIN_SEQ * cfg.d_model * 2)
    return pred, W * cfg.param_count() * 4 + resid, (
        "gradient rows plus one worker's residuals"), (
        f"the reference's layout puts one worker's copy on each of {W} "
        f"devices, the port's one card holds all {W} copies: {W} x the "
        f"prediction = {W * pred['total_gb']:.3f} GB")


def hold_floor(label: str, ms: float, step_bytes: int) -> None:
    """Prints an engine step beside its H100 floor (``step_bytes`` on
    HW()) and requires the step to take at least the floor: a step under
    it means the byte model or the constants are wrong."""
    from repro_torch.statics.memory import step_floor
    floor_ms = step_floor(step_bytes)["bound_step_time_s"] * 1e3
    log(f"[floor] {label}: {step_bytes / 1e6:.3f} MB a step -> floor "
        f"{floor_ms:.5f} ms on HW(); measured {ms:.4f} ms; floor / measured "
        f"{floor_ms / ms:.5f}")
    require(ms >= floor_ms, f"{label}: the step takes at least its floor")


def log_mfu(label: str, cfg, shape, ms: float) -> None:
    """Prints the model-FLOPs utilization of a step of ``ms``: its model
    FLOPs (repro_torch.analysis.model_flops) over HW().peak_flops."""
    from repro_torch.analysis import model_flops
    mf = model_flops(cfg, shape)
    log(f"[mfu] {label}: {mf / 1e12:.3f} model TFLOP in {ms:.3f} ms = "
        f"{mf / (ms * 1e-3) / 1e12:.1f} TFLOP/s = "
        f"{mf / (ms * 1e-3 * hw().peak_flops):.4f} of HW().peak_flops")


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
    res_k = peak_run("HPS main (phase 6b)", lambda: run_hps_runtime(
        hw_d, hrt, T, seed=0, plan=plan_k),
        engine_memory(N, hrt.src.shape[0], A1_D))
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
    fin_k, traj_k = peak_run("push-sum main (phase 6c)",
                             lambda: run_pushsum_sparse(
                                 pw_d, src, dst, T, plan=plan_k, **ps_args),
                             engine_memory(N, el.E, A1_D))
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
    from repro_torch.statics import memory
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
        hold_floor(f"HPS N={n_agents}", ms[("hps", "auto")],
                   memory.hps_step_bytes(n_agents, rt.src.shape[0], A1_D))
        hold_floor(f"push-sum N={n_agents}", ms[("pushsum", "auto")],
                   memory.pushsum_step_bytes(n_agents, el.E, A1_D))
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
# script keeps well inside its time limit as phases are added (6 before
# phase 23 came)
SWEEP_RUNS = 2    # 3 before phase 26
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
    args = _pushsum_grid(el, drops, range(4), 4, plan, dev)[0]
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
PLANE_T = 100                   # rounds of 6i-6j's runs (T_MAIN until the
                                # script's time limit cut them)
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
    T, N = PLANE_T, N_FULL
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
    T = PLANE_T
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
    aT = 3 * PLANE_T            # the benchmark's 600, cut for time
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
        out["byz_trim"][name]["bound_ms"] += st.itemsize / hw().hbm_bw \
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
    from repro_torch.statics.memory import social_step_bytes

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
    started = [time.perf_counter()] * 2

    def lap(done: str) -> None:
        """Log the seconds since the last lap, which ``done`` took, and (on
        standard error too, where a run that is stopped shows how far it
        got) the seconds since the start."""
        now = time.perf_counter()
        log(f"[phase] {done}: {now - started[0]:.1f} s")
        print(f"[phase] {done} ended at {now - started[1]:.1f} s",
              file=sys.stderr, flush=True)
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
    # K4 by width, K1-K3 by storage type (float, __nv_bfloat16, __half) and
    # K6's tensor-core kernel by head size, each built with no spills
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
              for t in storage),
            *(("swa_prefill", f"swa_prefill_tc_kernelILi{dh}E")
              for dh in (64, 128, 256))):
        report = ptxas_report(built[name].log, kernel)
        log(f"[build] ptxas, {kernel}: {report}")
        require(report.count("0 bytes spill stores") == 1
                and report.count("0 bytes spill loads") == 1,
                f"{kernel} built, with no spills")
    for name, kernel in (("wkv6", "wkv6_group_statesI13__nv_bfloat16"),
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
    k5p_err = k5_partial_checks(dev)
    m_hyp = model.m

    lap("phase 2")
    # ---- phase 3: the main path at full size ----------------------------
    plan_k = ExecutionPlan(store="log_ratio", dst_sorted=True)
    plan_p = plan_k.replace(backend="torch")
    _zero_counts()
    t0 = time.perf_counter()
    res_k = peak_run("Alg. 3 main (phase 3)", lambda: run_social_runtime(
        model, rt, M, T_MAIN, seed=0, plan=plan_k),
        engine_memory(N, E, model.m))
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
        hold_floor(f"Alg. 3 N={n_agents}", step_ms[(n_agents, "auto")],
                   social_step_bytes(n_agents, srt.src.shape[0], smodel.m))
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
    ft = family_train_phases(dev, flush, lap)
    by_name["swa_prefill"]["launches_family_train"] = ft["k6_launches"]
    by_name["swa_prefill"]["family_train"] = ft["k6_times"]
    kernels[-1]["launches_family_train"] = ft["k4_launches"]
    kernels[-1]["family_train_max_abs_err"] = ft["k4_err"]
    kernels[-1]["family_train"] = ft["k4_times"]
    # ---- phase 22: the analytic models and the statics on the card -------
    analysis_phase(dev, card)
    lap("phase 22")
    # ---- phase 23: the multi-device engines --------------------------------
    md = multidevice_phase(dev, flush, model, rt, M)
    by_name["edge_scatter"].update(md)
    lap("phase 23")
    # ---- phase 24: the model stack over ranks -----------------------------
    mm = model_mesh_phase(dev, flush)
    t = mm["times"]
    by_name = {k["name"]: k for k in kernels}
    by_name["trimmed_mean"].update(
        launches_ranks=mm["k4_launches"], ranks=t["k4_rank"],
        ranks_stripe=t["k4_stripe"])
    by_name["edge_scatter"].update(
        launches_ranks=mm["robust"]["pushsum_sparse"]["launches"].get(
            "edge_scatter", 0), ranks=t["k1_rank"])
    by_name["swa_prefill"].update(ranks=t["k6_local"], launches_ranks={
        **{name: mm[name][0]["launches"].get("swa_prefill", 0)
           for name in MM_SERVES},
        "mean": mm["mean"]["launches"].get("swa_prefill", 0),
        "robust": mm["robust"]["trimmed_mean"]["launches"].get(
            "swa_prefill", 0)})
    by_name["attn_decode"].update(ranks=t["k5_local"], launches_ranks={
        name: mm[name][0]["launches"].get("attn_decode", 0)
        for name in MM_SERVES})
    lap("phase 24")
    # ---- phase 25: the other families over model ranks --------------------
    fa = family_axis_phase(dev, flush)
    ft_ = fa["times"]

    def fa_launches(name: str) -> dict:
        return {run: r["launches"].get(name, 0)
                for run, r in fa["runs"].items()
                if r["launches"].get(name, 0)}

    by_name["attn_decode"]["launches_family_ranks"] = fa_launches(
        "attn_decode")
    by_name["swa_prefill"].update(family_ranks=ft_["k6_gathered"],
                                  launches_family_ranks=fa_launches(
                                      "swa_prefill"))
    by_name["wkv6"].update(family_ranks=ft_["k7_local"],
                           launches_family_ranks=fa_launches("wkv6"))
    partial = fa_launches("attn_decode_partial")
    kernels.append({
        "name": "attn_decode_partial", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/attn_decode.cu",
        "replaces": "src/repro/kernels/swa/swa.py:72",
        "launches": sum(partial.values()), "launches_by_run": partial,
        "launches_merge": sum(fa_launches("attn_decode_merge").values()),
        "max_abs_err": k5p_err,
        **{k: ft_["k5_partial"][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")},
        "shape": ft_["k5_partial"]["shape"], "merge": ft_["k5_merge"]})
    lap("phase 25")
    # ---- phase 26: the families trained over model ranks, and FSDP --------
    tx = family_train_axis_phase(dev, flush)

    def tx_launches(name: str) -> dict:
        return {run: r["launches"].get(name, 0)
                for run, r in tx["runs"].items()
                if "launches" in r and r["launches"].get(name, 0)}

    t26 = tx["times"]
    by_name["swa_prefill"].update(
        launches_family_train_ranks=tx_launches("swa_prefill"),
        family_train_ranks={k: v for k, v in t26.items()
                            if k.startswith("k6_")})
    by_name["wkv6"].update(
        launches_family_train_ranks=tx_launches("wkv6"),
        family_train_ranks=t26["k7_rank_train"])
    by_name["trimmed_mean"].update(
        launches_family_train_ranks=tx_launches("trimmed_mean"),
        family_train_ranks=t26["k4_rank_robust"])
    lap("phase 26")
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


def profile_step(run, label: str, step_ms: float, steps: int = 20,
                 warm: bool = True) -> None:
    """Device time by kernel over ``steps`` kernel-path steps
    (torch.profiler) of ``run(T)``, after min(5, steps) unprofiled ones
    (none without ``warm``: the caller's steps warmed it), and the share
    of the unprofiled step time ``step_ms`` it covers. The profiler
    records device activity alone: averaging the host-side events of a
    step of thousands of ops took it seconds a profile (tens of seconds
    for a training step), which the script's time limit cannot spare."""
    import torch

    if warm:
        run(min(5, steps))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
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
    from repro_torch.kernels.swa import (attn_decode_cuda,
                                         attn_decode_merge_cuda,
                                         attn_decode_partial_cuda,
                                         swa_prefill_cuda)
    from repro_torch.kernels.trimmed_mean import trimmed_mean_cuda
    from repro_torch.kernels.wkv6 import wkv6_cuda
    return {"edge_scatter": edge_scatter_cuda,
            "social_innov": innovation_cuda,
            "byz_trim": trim_gather_cuda,
            "attn_decode": attn_decode_cuda,
            "attn_decode_partial": attn_decode_partial_cuda,
            "attn_decode_merge": attn_decode_merge_cuda,
            "swa_prefill": swa_prefill_cuda,
            "wkv6": wkv6_cuda,
            "trimmed_mean": trimmed_mean_cuda}


# wrappers with two kernels: the calls on one of them, apart (count name:
# wrapper, attribute)
SUB_COUNTS = {"swa_prefill_tc": ("swa_prefill", "launches_tc"),
              "attn_decode_tc": ("attn_decode", "launches_tc"),
              "attn_decode_partial_tc": ("attn_decode_partial",
                                         "launches_tc"),
              "edge_scatter_tiled": ("edge_scatter", "launches_tiled"),
              "byz_trim_tensor_f": ("byz_trim", "launches_tensor_f"),
              "edge_scatter_edge_rows": ("edge_scatter",
                                         "launches_edge_rows"),
              "edge_scatter_half": ("edge_scatter", "launches_half"),
              "edge_scatter_sharded": ("edge_scatter", "launches_sharded"),
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
    res_k = peak_run(
        "Alg. 2 main (phase 5)", lambda: run_byzantine_runtime(
            model, rt, extra_reps, n_reps, attack, T_MAIN, seed=0,
            plan=plan_k, device=dev),
        byz_memory(N, rt.nbr_idx.shape[1], model.m))
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
    from repro_torch.statics.memory import byz_sparse_step_bytes

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
        # the pairwise statistic's m^2 coordinates a slot
        hold_floor(f"Alg. 2 N={n_agents}", ms["auto"],
                   byz_sparse_step_bytes(n_agents, srt.nbr_idx.shape[1],
                                         smodel.m ** 2))
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
    floor = weights / hw().hbm_bw * 1e3
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
    on split and combine; K6's bf16 cases run on its tensor-core kernel,
    its float32 ones on its FMA kernel (each checked by the wrapper's
    tensor-core launch count). K5's ticket counters are back at zero after
    the calls."""
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
            "S=130, window 100, dh=256, fp32": (1, 130, 8, 2, 256, f32, 100),
            # RecurrentGemma-2B: 10 query heads on one KV head of 256
            "RecurrentGemma's prefill": (8, 2048, 10, 1, 256, bf16, 2048),
            "a rank's gathered heads, model 4": (1, 2048, 3, 1, 256, bf16,
                                                 2048),
            "rank training, model 4": (2, 512, 3, 1, 256, bf16, 0),
            "S=300, dh=256, G=10, window 100": (2, 300, 10, 1, 256, bf16,
                                                100),
            "S=1, dh=256, G=10": (2, 1, 10, 1, 256, bf16, 0),
    }.items():
        q, k, v = (rn(B, S, H, dh, dtype=dtype), rn(B, S, Hkv, dh,
                                                     dtype=dtype, scale=2.0),
                   rn(B, S, Hkv, dh, dtype=dtype))
        before = swa_prefill_cuda.launches_tc
        got = swa_prefill_cuda(q, k, v, w)
        require(swa_prefill_cuda.launches_tc - before
                == (dtype == bf16 and dh in (64, 128, 256)),
                f"K6 {case}: the kernel picked by dtype")
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
    # a rank's attended heads at model 4, as _HeadCut.attended slices
    # them: query heads 2-4 of RecurrentGemma's 10 (head-axis offset 512
    # bytes) and the one KV head
    B, S, dh = 1, 2048, 256
    x = rn(B, S, 12 * dh, dtype=bf16)
    q = x[..., :10 * dh].view(B, S, 10, dh)[:, :, 2:5]
    k = x[..., 10 * dh:11 * dh].view(B, S, 1, dh)
    v = x[..., 11 * dh:].view(B, S, 1, dh)
    before = swa_prefill_cuda.launches_tc
    hold("swa_prefill", "gathered heads 2-4 of 10, a view",
         swa_prefill_cuda(q, k, v, 2048),
         swa_prefill_ref(q.float(), k.float(), v.float(), 2048))
    require(swa_prefill_cuda.launches_tc == before + 1,
            "gathered heads on the tensor-core kernel")
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

    # ---- phase 9: Qwen3-8B at full width, SERVE_QWEN_LAYERS deep, bf16 ---
    cfg = dataclasses.replace(get_config("qwen3_8b"),
                              n_layers=SERVE_QWEN_LAYERS)
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
    _zero_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        toks, lk = peak_run("Qwen3-8B serve main (phase 9)",
                            lambda: generate(params, cfg, prompts, GEN),
                            serve_memory(cfg, B, S, S + GEN + 1))
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
    # attention order), and those flips grow over the layers
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
    from repro_torch.configs import InputShape
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
                    4 * B * H * n_valid * dh, hw().peak_flops)
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
    b6, by6 = bound(nbytes(q, k, v, o6), flops6, hw().peak_flops)
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
        f"{bound(0, flops_t, hw().peak_flops)[0]:.4f} (operations)")
    out["swa_prefill"].update(train_ms=ms_t, train_library_ms=lib_t)
    del q, k, v

    st = serve_times(params, cfg, prompts, toks)
    out["decode_ms"] = st["decode_ms"]
    for kind in ("prefill", "decode"):
        log_mfu(f"Qwen3-8B {kind}", cfg,
                InputShape(kind, SERVE_S, SERVE_B, kind), st[f"{kind}_ms"])
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

    # ---- phase 13: RWKV6-1.6B at full width, SERVE_RWKV_LAYERS deep, bf16 -
    cfg = dataclasses.replace(get_config("rwkv6_1b6"),
                              n_layers=SERVE_RWKV_LAYERS)
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

    # ---- phase 15b: phase 13's depth in float32 --------------------------
    # bf16 rounding noise grows with depth in this random-weight model
    # (the port rounds where the reference rounds: tests/test_torch_models
    # .py), so at 24 layers few bf16 positions have a clear top-2 margin;
    # float32 keeps one on most.
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
    hold_logits(f"[rwkv fp32 {cfg.n_layers} layers]",
                f"2 x {S} prompt tokens, 8 tokens",
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
    ops_ms7 = (tc7 / hw().peak_flops + fma7 / hw().fp32_flops) * 1e3
    bytes_ms7 = bytes7 / hw().hbm_bw * 1e3
    b7, by7 = max((bytes_ms7, "bytes"), (ops_ms7, "operations"))
    floor7 = wkv_floor_bytes(B * H, S, 2, G7)
    log(f"[timing] wkv6 (B={B}, H={H}, T={S}, K=V=64, bf16, groups of "
        f"{G7} chunks, {B * H * -(-S // (64 * G7))} blocks in passes 1 and 3)"
        f": device {ms7:.5f} ms, host-inclusive {host7:.5f}, plain "
        f"{plain7:.4f}, bound {b7:.5f} ({by7}; "
        f"{bytes7 / 1e6:.1f} MB; {tc7 / 1e9:.2f} GFLOP on the tensor cores "
        f"and {fma7 / 1e9:.2f} G operations on the FMA pipes = "
        f"{ops_ms7:.5f} ms at the peaks), design floor "
        f"{floor7 / hw().hbm_bw * 1e3:.5f} ms ({floor7 / 1e6:.1f} MB); "
        f"library: none (no single PyTorch call); a launch of each pass "
        f"(profiler, L2 flushed): " + ", ".join(
            f"{n} {t:.5f} (mean of {c})" for n, (t, c) in passes7.items()))
    del r, k, v, lw, u, y, s
    dec = serve_times(params, cfg, prompts, toks,
                      f", of which K7 {cfg.n_layers} x {ms7:.4f} ms"
                      )["decode_ms"]
    return {"wkv6": {"ms": ms7, "plain_ms": plain7, "bound_ms": b7,
                     "bound_by": by7, "library_ms": None,
                     "floor_ms": floor7 / hw().hbm_bw * 1e3,
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
# weights) took ~80 s at full depth on the H100, so it runs 12 of its 48
# layers, OLMoE 8 of its 16 and RecurrentGemma 13 of its 26 (published
# widths, the layer patterns kept; cut to make room for phase 23)
FAMILY_CELLS = {
    "olmoe": ("olmoe_1b_7b", SERVE_S, 8),
    "recurrentgemma": ("recurrentgemma_2b", SERVE_S, 13),
    "whisper": ("whisper_small", 64, None),
    "internvl2": ("internvl2_26b", SERVE_S, 6),
}
FAMILY_PROFILE_STEPS = 5      # decode steps under the profiler a family
                              # (10 before phase 26)


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
    from repro_torch.kernels.swa.ops import _TICKETS, prefill_kernel
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
    b5, by5 = bound(nbytes(q, k, v, L, o5), 4 * B * H * Wc * dh,
                    hw().peak_flops)
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
    b6, by6 = bound(nbytes(q, k, v, o6), flops6, hw().peak_flops)
    log(f"[timing] swa_prefill at RecurrentGemma's prefill shape (B={B}, "
        f"S={S}, H={H}, Hkv={Hkv}, dh={dh}, window {Wc}, bf16, the "
        f"{'tensor-core' if prefill_kernel(bf16, dh) == 'tc' else 'FMA'} "
        f"kernel): {ms6:.4f} ms = "
        f"{flops6 / ms6 / 1e9:.1f} TFLOP/s, plain {plain6:.4f}, SDPA "
        f"{lib6:.4f}, bound {b6:.4f} ({by6})")
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
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 1024, 64, 6   # 10 before phase 26
TRAIN_TIMED = 3          # phase 18's timed steps a path (5 before the time
#                          limit's cut)
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
    fin = torch.where(torch.isfinite(x), x, 0.0)
    return W * EPS32 * fin.abs_().sum(dim=0) / (W - 2 * F) + 1e-30


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


def hold_k6_grads(g, shape, dtype, dev) -> None:
    """K6's gradients through its autograd wrapper (``SwaPrefillFn``)
    against autograd of the plain version at ``shape`` (B, S, H, Hkv, dh),
    causal, in ``dtype``, inputs drawn from ``g``. The loss is linear in the
    outputs (a fixed random cotangent), so the backward, a plain
    recompute, sees the same cotangent: the gradients must be bit-equal.
    The output is the kernel's, held to phase 8's limits against the plain
    version in float32 (bf16 rtol 2^-8, float32 1e-5; atol 1e-5)."""
    import torch
    from repro_torch.kernels.swa import (swa_prefill, swa_prefill_cuda,
                                         swa_prefill_ref)
    B, S, H, Hkv, dh = shape
    name = str(dtype)[6:]
    q, k, v = (torch.randn((B, S, h, dh), generator=g, device=dev)
               for h in (H, Hkv, Hkv))
    up = torch.randn((B, S, H, dh), generator=g, device=dev)
    res = {}
    for backend in ("cuda", "torch"):
        ins = [t.to(dtype).requires_grad_() for t in (q, k, v)]
        before = swa_prefill_cuda.launches
        out = swa_prefill(*ins, 0, backend=backend)
        require(swa_prefill_cuda.launches == before + (backend == "cuda"),
                "K6 launch through the wrapper")
        (out.float() * up).sum().backward()
        res[backend] = (out.detach(), [t.grad for t in ins])
    torch.cuda.synchronize()
    with torch.no_grad():
        want = swa_prefill_ref(*(t.to(dtype).float() for t in (q, k, v)), 0)
    tol = 2 ** -8 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(res["cuda"][0].float(), want, rtol=tol,
                               atol=1e-5)
    del want
    require(all(torch.equal(a, b) for a, b in zip(res["cuda"][1],
                                                  res["torch"][1])),
            f"K6 gradients bit-equal to plain autograd at {shape} ({name})")
    del q, k, v, up, res, out, ins
    torch.cuda.empty_cache()


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
    from repro_torch.kernels.wkv6 import wkv6, wkv6_chunked_ref, wkv6_cuda
    g = torch.Generator(device=dev).manual_seed(6)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        hold_k6_grads(g, (*GRAD_ATTN, 64), dtype, dev)
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
              on_step=None, stubs=None) -> list[float]:
    """``steps`` steps as ``launch.train.main`` runs them, ``stubs`` (a
    family's frames or patches) added to every batch -> the losses."""
    import torch
    from repro_torch.core.prng import fold_in, prng_key
    key = prng_key(0)
    losses = []
    for s in range(steps):
        batch = {**data.batch(s, dev), **(stubs or {})}
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
    and plain paths (medians of :data:`TRAIN_TIMED`, in turns), the peak
    memory and a profile of a kernel-path step; ``k4_ms`` is K4's time,
    put beside the step's."""
    import torch
    from repro_torch.configs import InputShape, get_config
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
    for s in range(TRAIN_TIMED):
        for backend in (("auto", "torch") if s % 2 == 0
                        else ("torch", "auto")):
            walls[backend].append(one(backend, s + 1))
    step_ms = {b: float(np.median(w)) for b, w in walls.items()}
    log_mfu("paper_sim train step", get_config("paper_sim"),
            InputShape("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
            step_ms["auto"])
    peak_run("paper_sim train step (phase 18)", lambda: one("auto", 7),
             train_memory(TRAIN_W))
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[timing] train step (paper_sim, {TRAIN_W} workers x "
        f"{TRAIN_BATCH // TRAIN_W} x {TRAIN_SEQ} tokens, trimmed_mean): "
        f"kernel path {step_ms['auto']:.2f} ms, plain path "
        f"{step_ms['torch']:.2f} ms (medians of {TRAIN_TIMED}, in turns: "
        f"{[round(v, 1) for v in walls['auto']]} / "
        f"{[round(v, 1) for v in walls['torch']]}); peak memory of a "
        f"kernel-path step {peak:.2f} GB; K4 {k4_ms:.4f} ms = "
        f"{k4_ms / step_ms['auto']:.2e} of the step")
    del setups["torch"]
    torch.cuda.empty_cache()
    profile_step(lambda T: [one("auto", 10 + t) for t in range(T)],
                 "paper_sim train (8 workers)", step_ms["auto"], steps=1)
    del setups
    torch.cuda.empty_cache()



# ---------------------------------------------------------------------------
# Phases 19-21: training of the MoE, audio and VLM families at published
# widths (OLMoE-1B-7B, Whisper-small, InternVL2-26B): K6 in every attention
# layer's forward and remat recompute, its backward through SwaPrefillFn,
# and K4 once a robust step
# ---------------------------------------------------------------------------

# name -> (arch, layers (None: full depth), aggregator, workers, F,
# Byzantine workers, rows a worker, text tokens a row, peak lr). Depth and
# rows are the only cuts: OLMoE at 2 layers (its stacked (R, ...) layout
# with remat; 3 copies of 1.05 B parameters at 14 B each), InternVL2 at 2
# layers in the mean mode (one copy: two robust copies of its 1.14 B
# embedding and head parameters do not fit), Whisper at 4 + 4 of its 12 +
# 12 layers (full depth before phase 26; cut for the script's time). The
# CLI's lr of 3e-4 but for InternVL2: at d_model 6,144 an Adam step of
# 3e-4 on every weight moves a logit by ~1.5 and the loss oscillates
# (12.00, 11.85, 12.46, 11.76, ...); a tenth of it
FAMILY_TRAIN = {
    "olmoe": ("olmoe_1b_7b", 2, "trimmed_mean", 3, 1, "1", 4, 1024, 3e-4),
    "whisper": ("whisper_small", 4, "trimmed_mean", 8, 2, "2,5", 2, 448,
                3e-4),
    "internvl2": ("internvl2_26b", 2, "mean", 1, 0, "", 4, 1792, 3e-5),
}
FAMILY_TRAIN_STEPS = 10
FAMILY_PLAIN_STEPS = 3    # the plain path's steps, held against the first
FAMILY_TIMED_STEPS = 1    # phase 21's timed steps a path (5 before phase 23,
                          # 3 before phase 24)
# kernel path against the plain path (see family_train_main)
FAMILY_LOSS_GAP, FAMILY_AGG_GAP = 1e-3, 1e-2


def family_train_cfg(name: str):
    """A cell's config: published widths, its depth cut (an encoder's
    too)."""
    import dataclasses
    from repro_torch.configs import get_config
    arch, depth = FAMILY_TRAIN[name][:2]
    cfg = get_config(arch)
    return cfg if depth is None else dataclasses.replace(
        cfg, n_layers=depth, encoder_layers=min(cfg.encoder_layers, depth))


def family_train_argv(name: str, backend: str) -> list:
    """``python -m repro_torch.launch.train``'s arguments of a cell."""
    arch, _, agg, W, F, byz, rows, S, lr = FAMILY_TRAIN[name]
    return ["--arch", arch, "--steps", str(FAMILY_TRAIN_STEPS), "--seq-len",
            str(S), "--global-batch", str(W * rows), "--agg", agg,
            "--trim-f", str(F), "--byzantine", byz, "--workers", str(W),
            "--lr", str(lr), "--backend", backend, "--seed", "0"]


def family_k6_shape(name: str) -> tuple:
    """K6's (B, S, H, Hkv, dh) in a cell: one worker's rows, the text
    tokens after a VLM's patch rows."""
    cfg = family_train_cfg(name)
    rows, S = FAMILY_TRAIN[name][6:8]
    n_vis = cfg.n_patches if cfg.family == "vlm" else 0
    return (rows, S + n_vis, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)


def family_train_kernel_checks(dev, flush) -> dict:
    """Phase 19: K6's gradients through ``SwaPrefillFn`` against plain
    autograd at each cell's training shape (one worker's call of a layer),
    bf16, by :func:`hold_k6_grads`; then K4 against its plain version at
    each robust cell's (W, D_total), D_total the leaves of the cell's
    parameters: phase 16's data (randn x 1e-3, the Byzantine rows x -10),
    the cell's F, held by :func:`hold_tmean` on the whole row (at OLMoE's
    (3, 1.05e9) ~46 GB: x, the two results, the bound's (W, D) temporary),
    then timed with the host hidden beside its byte bound and
    ``torch.mean(x, 0)`` (medians of 10, L2 flushed) -> D_total by cell,
    K4's largest error and its times by cell."""
    import torch
    from repro_torch.kernels.trimmed_mean import (trimmed_mean_cuda,
                                                  trimmed_mean_ref)
    from repro_torch.models import model as M
    g = torch.Generator(device=dev).manual_seed(19)
    for name in FAMILY_TRAIN:
        shape = family_k6_shape(name)
        hold_k6_grads(g, shape, torch.bfloat16, dev)
        log(f"[family train kernels] K6 at {name}'s training shape (B, S, "
            f"H, Hkv, dh) = {shape}, bf16: output within phase 8's limits, "
            f"gradients through SwaPrefillFn bit-equal to plain autograd")
    d_total, worst, times = {}, 0.0, {}
    for name, (_, _, agg, W, F, byz, *_) in FAMILY_TRAIN.items():
        params = M.init_params(0, family_train_cfg(name), dev)
        D = d_total[name] = sum(t.numel() for t in _leaves(params))
        del params
        if agg == "mean":
            continue
        x = torch.randn((W, D), generator=g, device=dev).mul_(1e-3)
        for b in byz.split(","):
            x[int(b)].mul_(-10.0)
        got = trimmed_mean_cuda(x, F)
        err = hold_tmean(f"{name} (W={W}, D={D}, F={F})", got,
                         trimmed_mean_ref(x, F), x, F)
        worst = max(worst, err)
        del got
        torch.cuda.empty_cache()
        out = torch.empty(D, device=dev)
        ms = event_ms(lambda: trimmed_mean_cuda(x, F, out=out), 10, flush,
                      hide_host=True)
        lib = event_ms(lambda: torch.mean(x, 0), 10, flush, hide_host=True)
        # bytes: x read once, the output written once; operations: per
        # coordinate 2F extraction rounds of W compares and W adds
        b, by = bound(nbytes(x, out), D * W * (2 * F + 1))
        times[name] = {"ms": ms, "bound_ms": b, "bound_by": by,
                       "library_ms": lib}
        log(f"[family train kernels] trimmed_mean at {name}'s (W, D_total) "
            f"= ({W}, {D}), F = {F}, Byzantine rows {byz} at -10x: within W "
            f"eps32 sum|x| / (W - 2F) of the plain version, max_abs_err "
            f"{err:.3e}; device {ms:.5f} ms with the host hidden, bound "
            f"{b:.5f} ({by}, {nbytes(x, out) / 1e9:.3f} GB), torch.mean "
            f"{lib:.5f} (host hidden); medians of 10, L2 flushed")
        del x, out
        torch.cuda.empty_cache()
    return {"d_total": d_total, "k4_err": worst, "k4_times": times}


class RoutePin:
    """Stands in for ``repro_torch.models.layers.moe_route`` while
    installed. ``record``: keeps each call's expert ids, in call order.
    ``replay``: returns the recorded ids of the same call, the gates
    gathered from this call's own router probabilities (the top-k values
    where the ids agree, so the gradient reaches the router as through
    them), and counts the (token, choice) pairs this call's own top-k
    would route elsewhere. ``off``: the router as it is."""

    def __init__(self, layers):
        self.layers, self.route = layers, layers.moe_route
        self.mode, self.ids, self.used, self.miss, self.pairs = \
            "off", [], 0, 0, 0

    def __enter__(self):
        self.layers.moe_route = self
        return self

    def __exit__(self, *exc):
        self.layers.moe_route = self.route

    def __call__(self, p, xt, k):
        probs, gates, ids = self.route(p, xt, k)
        if self.mode == "record":
            self.ids.append(ids)
        elif self.mode == "replay":
            want = self.ids[self.used]
            self.used += 1
            same = (ids[:, :, None] == want[:, None, :]).any(-1)
            self.miss += int((~same).sum())
            self.pairs += same.numel()
            ids, gates = want, probs.gather(-1, want)
        return probs, gates, ids


def grads_rel_rms(got: list, want: list) -> float:
    """rms(got - want) / rms(want) over every coordinate of two gradient
    lists, in float32."""
    num = den = 0.0
    for a, b in zip(got, want, strict=True):
        num += (a.float() - b.float()).square().sum().item()
        den += b.float().square().sum().item()
    return (num / max(den, 1e-30)) ** 0.5


def first_batch_loss(params, cfg, batch, W: int, robust: bool) -> float:
    """The loss of ``batch`` under ``params`` (copy 0 of a robust cell's),
    each worker's rows scored apart and averaged, as a step scores
    them."""
    import torch
    from repro_torch.models import model as M
    p0 = M._tmap(lambda t: t[0], params) if robust else params
    b = batch["tokens"].shape[0] // W
    losses = []
    with torch.no_grad():
        for w in range(W):
            rows = {k: v[w * b:(w + 1) * b] for k, v in batch.items()}
            losses.append(M.loss_fn(
                p0, cfg, rows["tokens"], rows["labels"],
                patch_embeds=rows.get("patch_embeds"),
                frames=rows.get("frames")).item())
    return float(np.mean(losses))


def family_train_main(name: str, dev, shared: bool = False) -> dict:
    """Phase 20 for one cell: ``FAMILY_TRAIN_STEPS`` steps through
    ``launch.train.build(args, cfg=...)`` at published widths, bf16,
    seeded weights, the cell's stub inputs (Whisper's 1,500 float32 frames
    a row, InternVL2's 256 float32 patches a row; seeded, the same every
    step) added to each batch, on the kernel path (``backend="auto"``),
    then the first ``FAMILY_PLAIN_STEPS`` of them from the same seed on
    the plain path (``"torch"``). ``shared``: another process
    (the example) runs on the card, so the logged build and step walls
    are not step times (phase 21 times the steps).

    Required on the kernel path: finite losses that fall from step 0 to
    the last, and step 0's batch scored again after the last step below
    its step-0 loss (each step draws another batch, and a batch of a few
    markov rows moves the loss by ~0.05). For InternVL2, whose steps at
    its lr of 3e-5 swing by ~0.1 with the batch, the second is the test
    of learning: the first holds little there. A robust cell's copies
    bit-equal (one trimmed aggregate for every copy) and its
    ``param_spread`` exactly 0 where every leaf is bf16; K6 launched
    workers x attention layers x 2 (forward and remat recompute) a step,
    every launch on its tensor-core kernel, K4 once a robust step and
    nothing else; the plain path launches nothing.

    Kernel path against the plain path, a rule fixed before the run:
    each of the plain path's steps' loss within ``FAMILY_LOSS_GAP`` (1e-3)
    relative (sound runs read up to 5.1e-5), and the first step's
    aggregate (the mean cell: its gradient) within ``FAMILY_AGG_GAP``
    (1e-2) relative rms. At random weights the loss sits near ln V
    whatever attention returns, so the loss gap alone could not show a
    wrong K6: the aggregate is the check that guards the kernel (a wrong
    path's readings are not measured). The paths differ by K6's
    arithmetic: its bf16 output rounds another float32 sum, so a few
    entries move by one bf16 ulp (2^-8), and those flips travel through the
    later layers and the backward, and move near-tied survivors of the
    trim; a missing or wrong gradient term moves the aggregate by O(1) of
    its rms. OLMoE's routes also flip between the paths (0.015 of the
    serve path's (token, choice) pairs), and a flipped pair sends its token's gradient
    to another expert: so the plain path's first step takes the kernel
    path's routes (``RoutePin``: the same discrete choice, each path's own
    router probabilities and arithmetic), and the share of pairs its own
    router would have flipped is printed. The kernel path's record also
    shows that each layer's remat recompute takes its forward's routes.
    -> launches, losses, gaps, the peak memory of each path's run (the
    kept first-step aggregate or gradient included)."""
    import torch
    from repro_torch.distributed.trainer import param_spread
    from repro_torch.launch.train import build, parse_args
    from repro_torch.models import layers as L
    from repro_torch.optim.adamw import leaves

    _, depth, agg, W, F, byz, rows, S, lr = FAMILY_TRAIN[name]
    cfg = family_train_cfg(name)
    tag = f"[{name} train]"
    robust = agg != "mean"
    nA = attn_layers(cfg)
    stubs = family_stubs(cfg, W * rows, dev)
    moe = cfg.ffn_kind == "moe"
    pin = RoutePin(L)
    runs = {}
    with pin:
        for backend in ("auto", "torch"):
            n_steps = (FAMILY_TRAIN_STEPS if backend == "auto"
                       else FAMILY_PLAIN_STEPS)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tc, data, pw, ow, step, _ = build(
                parse_args(family_train_argv(name, backend)), cfg,
                record="aggregate" if robust else True)
            torch.cuda.synchronize()
            t_build = time.perf_counter() - t0
            n_params = sum(t[0].numel() if robust else t.numel()
                           for t in leaves(pw))
            first = {}

            def keep(s, st, first=first):
                """The first step's aggregate (float32 row) or gradient;
                every step's record freed; the router pinned in step 0
                only."""
                if robust:
                    if s == 0:
                        first["agg"] = st.aggregate[0].clone()
                    del st.aggregate
                else:
                    if s == 0:
                        first["agg"] = st.grads
                    del st.grads
                if s == 0:
                    pin.mode = "off"

            if moe:
                pin.mode = "record" if backend == "auto" else "replay"
            _zero_counts()
            t0 = time.perf_counter()
            losses = run_steps(step, pw, ow, data, n_steps, dev,
                               robust=robust, on_step=keep, stubs=stubs)
            wall = time.perf_counter() - t0
            counts = _counts()
            peak = torch.cuda.max_memory_allocated() / 1e9
            spread = param_spread(pw).item() if robust else None
            again = first_batch_loss(pw, cfg, {**data.batch(0, dev),
                                               **stubs}, W, robust)
            log(f"{tag} {backend}: {cfg.name} ({cfg.source}) "
                f"{cfg.n_layers} layers" + ("" if depth is None else
                                            " (depth cut)")
                + (f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers
                   else "") + f", d_model {cfg.d_model}, {cfg.n_heads}/"
                f"{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
                f"vocab {cfg.vocab}"
                + (f", {cfg.n_experts} experts top-{cfg.top_k} capacity "
                   f"factor {cfg.capacity_factor}" if moe else "")
                + f", {cfg.dtype}; {n_params} parameters a copy; "
                f"{agg}" + (f" W={W} F={F} Byzantine {byz}" if robust
                            else " (one copy)")
                + f", {W} x {rows} rows of {S} tokens a step"
                + (f" (+ {cfg.n_patches} patches a row)"
                   if "patch_embeds" in stubs else "")
                + (f" ({cfg.n_frames} frames a row)" if "frames" in stubs
                   else "") + f", lr {lr}"
                + f"; built in {t_build:.2f} s, {n_steps} steps in "
                f"{wall:.2f} s" + (" (walls beside the example's process "
                                   "on the card: not step times)"
                                   if shared else "")
                + f"; losses {[round(x, 4) for x in losses]} "
                f"(step 0's batch after the last step: {again:.4f}); "
                + (f"param_spread {spread!r}; " if robust else "")
                + f"peak memory {peak:.2f} GB; launches {counts}")
            require(all(np.isfinite(losses)), f"{tag} losses finite")
            if robust:    # (OLMoE's float32 router: the mean of W equal
                # float32 values that param_spread takes need not round
                # back to the value, so the copies are compared directly)
                require(all(torch.equal(t[0], t[w]) for t in leaves(pw)
                            for w in range(1, W)),
                        f"{tag} every copy equal (one aggregate)")
                require(spread == 0.0 or any(
                    t.dtype == torch.float32 for t in leaves(pw)),
                    f"{tag} param_spread exactly 0")
            if backend == "auto":
                n_k6 = FAMILY_TRAIN_STEPS * W * nA * 2
                require(counts == _only(
                    trimmed_mean=FAMILY_TRAIN_STEPS * robust,
                    swa_prefill=n_k6, swa_prefill_tc=n_k6),
                    f"{tag} K6 {n_k6} times (workers x attention layers x "
                    f"forward and remat a step, on its tensor-core kernel)"
                    f", K4 once a robust step")
                require(losses[-1] < losses[0] and again < losses[0],
                        f"{tag} the loss falls")
            else:
                require(counts == _only(), f"{tag} the plain path "
                        "launched no kernel")
            runs[backend] = (losses, first["agg"], counts, peak)
            del pw, ow, step, first, data
            torch.cuda.empty_cache()
    (lk, ak, counts, peak_k), (lp, ap, _, peak_p) = (runs["auto"],
                                                     runs["torch"])
    if moe:
        n_moe = cfg.n_layers
        calls = W * 2 * n_moe
        require(len(pin.ids) == calls and pin.used == calls,
                f"{tag} {calls} router calls in step 0 (forward and remat "
                f"recompute of each layer, each worker), replayed one for one")
        same = all(torch.equal(pin.ids[w * 2 * n_moe + j],
                               pin.ids[w * 2 * n_moe + 2 * n_moe - 1 - j])
                   for w in range(W) for j in range(n_moe))
        log(f"{tag} routes: each layer's remat recompute takes its "
            f"forward's routes: {same}; the plain path's own router would "
            f"route {pin.miss / pin.pairs:.6f} of step 0's (token, choice) "
            f"pairs elsewhere (pinned to the kernel path's)")
        require(same, f"{tag} the remat recompute takes the forward's "
                "routes")
    agg_gap = rel_rms(ak, ap) if robust else grads_rel_rms(ak, ap)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    log(f"{tag} kernel vs plain path: first-step "
        f"{'aggregate' if robust else 'gradient'} relative rms "
        f"{agg_gap:.3e}, largest relative loss gap over "
        f"{FAMILY_PLAIN_STEPS} steps {loss_gap:.3e} (limits "
        f"{FAMILY_AGG_GAP}, {FAMILY_LOSS_GAP})")
    require(agg_gap < FAMILY_AGG_GAP, f"{tag} first-step aggregates agree")
    require(loss_gap < FAMILY_LOSS_GAP, f"{tag} losses agree")
    del runs, ak, ap
    torch.cuda.empty_cache()
    return {"k6": counts["swa_prefill"], "k4": counts["trimmed_mean"],
            "losses": lk, "plain_losses": lp, "agg_gap": agg_gap,
            "loss_gap": loss_gap, "peak_gb": peak_k, "plain_peak_gb": peak_p}


def family_train_timing(name: str, dev) -> dict:
    """Phase 21 for one cell: the kernel and plain paths' steps over one
    state (the plain step made by ``make_train_step`` beside ``build``'s),
    CUDA-synchronized host clock, one warm-up each, then medians of
    ``FAMILY_TIMED_STEPS`` in turns; a profile of one kernel-path step and its peak memory -> the
    medians and the peak."""
    import torch
    from repro_torch.core.prng import fold_in, prng_key
    from repro_torch.distributed.trainer import make_train_step
    from repro_torch.launch.train import build, parse_args

    _, _, agg, W, _, _, rows, S, _ = FAMILY_TRAIN[name]
    cfg = family_train_cfg(name)
    robust = agg != "mean"
    tc, data, pw, ow, step_k, layout = build(
        parse_args(family_train_argv(name, "auto")), cfg)
    step_p = make_train_step(tc, layout, backend="torch")
    stubs = family_stubs(cfg, W * rows, dev)
    batches = [{**data.batch(s, dev), **stubs} for s in range(2)]
    key = prng_key(0)
    steps = {"auto": step_k, "torch": step_p}

    def one(backend, s):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        args = (pw, ow, batches[s % 2]) + ((fold_in(key, s),) if robust
                                           else ())
        steps[backend](*args)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for backend in steps:
        one(backend, 0)                                  # warm-up
    walls = {"auto": [], "torch": []}
    for s in range(FAMILY_TIMED_STEPS):
        for backend in (("auto", "torch") if s % 2 == 0
                        else ("torch", "auto")):
            walls[backend].append(one(backend, s + 1))
    step_ms = {b: float(np.median(w)) for b, w in walls.items()}
    state = torch.cuda.memory_allocated() / 1e9
    log(f"[timing] {name} train step ({agg}, {W} x {rows} x {S} tokens): "
        f"kernel path {step_ms['auto']:.2f} ms, plain path "
        f"{step_ms['torch']:.2f} ms (medians of {FAMILY_TIMED_STEPS}, in "
        f"turns: "
        f"{[round(v, 1) for v in walls['auto']]} / "
        f"{[round(v, 1) for v in walls['torch']]})")
    torch.cuda.reset_peak_memory_stats()
    profile_step(lambda T: [one("auto", 10 + t) for t in range(T)],
                 f"{name} train", step_ms["auto"], steps=1, warm=False)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[timing] {name} train: peak memory of the profiled kernel-path "
        f"step {peak:.2f} GB, {state:.2f} GB resident between steps")
    del pw, ow, steps, step_k, step_p, batches
    torch.cuda.empty_cache()
    return {"step_ms": step_ms["auto"], "plain_step_ms": step_ms["torch"],
            "step_peak_gb": peak}


def family_k6_times(dev, flush) -> dict:
    """Phase 21: K6 at each cell's training shape (bf16, causal), timed
    with the host hidden, beside its plain version, its operations bound
    and SDPA (timed only) -> K6's figures by cell."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.swa import swa_prefill_cuda, swa_prefill_ref
    g = torch.Generator(device=dev).manual_seed(21)
    out, tr = {}, (0, 2, 1, 3)
    for name in FAMILY_TRAIN:
        B, S, H, Hkv, dh = family_k6_shape(name)
        q, k, v = (torch.randn((B, S, h, dh), generator=g, device=dev)
                   .to(torch.bfloat16) for h in (H, Hkv, Hkv))
        o = swa_prefill_cuda(q, k, v, 0)
        ms = event_ms(lambda: swa_prefill_cuda(q, k, v, 0), TIMED_RUNS,
                      flush, hide_host=True)
        plain = event_ms(lambda: swa_prefill_ref(q, k, v, 0), 3, flush)
        lib = event_ms(lambda: F.scaled_dot_product_attention(
            q.permute(tr), k.permute(tr), v.permute(tr), is_causal=True,
            enable_gqa=True), TIMED_RUNS, flush, hide_host=True)
        # operations: the band's S (S + 1) / 2 pairs per (row, head), 2 dh
        # FLOPs for the score and 2 dh for P.V each
        flops = 4 * dh * B * H * (S * (S + 1) // 2)
        b, by = bound(nbytes(q, k, v, o), flops, hw().peak_flops)
        log(f"[timing] swa_prefill at {name}'s training shape (B={B}, "
            f"S={S}, H={H}, Hkv={Hkv}, dh={dh}, bf16, causal): {ms:.5f} ms "
            f"with the host hidden = {flops / ms / 1e9:.1f} TFLOP/s, plain "
            f"{plain:.5f}, SDPA {lib:.5f} (host hidden), bound {b:.5f} "
            f"({by}, {flops / 1e9:.2f} GFLOP)")
        out[name] = {"ms": ms, "plain_ms": plain, "bound_ms": b,
                     "bound_by": by, "library_ms": lib}
        del q, k, v, o
        torch.cuda.empty_cache()
    return out


EXAMPLE_STEPS = 40      # of the example's default 200 (the time limit)


def start_robust_training_example():
    """``examples/robust_training_torch.py`` on the card at
    ``EXAMPLE_STEPS`` steps (paper_sim at published widths, float32, 4
    workers, trimmed mean F = 1, worker 1 Byzantine), started in its own
    process (~8 GB of the card) -> (process, start time) for
    :func:`finish_robust_training_example`."""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / "robust_training_torch.py"),
         "--steps", str(EXAMPLE_STEPS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    return proc, time.perf_counter()


def finish_robust_training_example(started) -> None:
    """Wait for the example (at most 600 s): its first and last printed
    loss, the last below the first."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = out.strip().splitlines()
    rows = [ln.split() for ln in lines if ln.startswith("step ")]
    require(proc.returncode == 0 and lines[-1:] == ["robust_training OK"]
            and rows, "examples/robust_training_torch.py on the card:\n"
            + out[-2000:] + err[-2000:])
    first, last = float(rows[0][3]), float(rows[-1][3])
    log(f"[robust_training_torch] {lines[0]}; {len(rows)} rows, step "
        f"{rows[0][1]} loss {first} -> step {rows[-1][1]} loss {last} "
        f"(consensus_spread {rows[-1][5]}) in "
        f"{time.perf_counter() - t0:.1f} s (beside phase 20's later "
        f"cells)")
    require(last < first, f"the example's loss falls over its "
            f"{EXAMPLE_STEPS} steps")


def family_train_phases(dev, flush, lap) -> dict:
    """Phases 19-21 -> K6's and K4's figures of the three train cells."""
    checks = family_train_kernel_checks(dev, flush)
    lap("phase 19 (family train kernels)")
    mains, example = {}, None
    try:
        for name in FAMILY_TRAIN:
            mains[name] = family_train_main(name, dev,
                                            shared=example is not None)
            lap(f"phase 20 ({name} train)")
            if example is None:    # beside the cells after OLMoE's ~66 GB
                example = start_robust_training_example()
        finish_robust_training_example(example)
    finally:
        if example is not None and example[0].poll() is None:
            example[0].kill()
            example[0].wait()
    lap("phase 20 (robust_training_torch's end)")
    k6 = family_k6_times(dev, flush)
    times = {name: family_train_timing(name, dev) for name in FAMILY_TRAIN}
    lap("phase 21 (family train timing)")
    return {"k6_launches": {n: m["k6"] for n, m in mains.items()},
            "k4_launches": {n: m["k4"] for n, m in mains.items() if m["k4"]},
            "k6_times": k6, "k4_err": checks["k4_err"],
            "k4_times": checks["k4_times"],
            "cells": {n: {**mains[n], **times[n]} for n in FAMILY_TRAIN}}


# ---------------------------------------------------------------------------
# Phase 22: the port's analytic models and statics on the card
# (repro_torch.analysis, repro_torch.statics)
# ---------------------------------------------------------------------------

def analysis_phase(dev, card: str) -> None:
    """Phase 22: the constants beside the card; the statics lint on the
    kernel path (K1, K2, K3 must launch) and a synthetic (N, N) value on
    the card caught."""
    import torch
    from repro_torch.statics import cli as statics_cli
    from repro_torch.statics import dense

    # the constants beside the card
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"[analysis] HW() = {hw()}; the card: {card}, total_memory {total} "
        f"B ({total / 1e9:.2f} GB against hbm_bytes "
        f"{hw().hbm_bytes / 1e9:.0f} GB)")

    # the lint on the kernel path
    t0 = time.perf_counter()
    _zero_counts()
    findings, n_runs = statics_cli.lint("cuda")
    counts = _counts()
    for f in findings:
        log(f"[analysis] lint finding: {f}")
    require(findings == [], "the statics lint finds nothing on the kernel "
            "path (the horizon-major keys and coins exempt by name)")
    require(all(counts[k] > 0 for k in ("edge_scatter", "social_innov",
                                        "byz_trim")),
            "K1, K2 and K3 launched under the lint")
    dims = {"N": 11, "d": 2}
    caught = dense.find_forbidden(statics_cli.synthetic_dense(dims, dev),
                                  dims, (("N", "N"),),
                                  where="synthetic injection on the card")
    require(len(caught) > 0, "a synthetic (N, N) value on the card is caught")
    log(f"[analysis] lint on the kernel path: {n_runs} recorded fixture "
        f"runs, the stream proofs, the signatures and the bf16 carries: 0 "
        f"findings; launches K1 {counts['edge_scatter']} (half "
        f"{counts['edge_scatter_half']}), K2 {counts['social_innov']} (half "
        f"{counts['social_innov_half']}), K3 {counts['byz_trim']} (half "
        f"{counts['byz_trim_half']}); the synthetic (N, N) injection caught: "
        f"{caught[0].message}; {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 23: the multi-device engines. The edge-partitioned push-sum of
# benchmarks/pushsum_sweep.py:285 (N = 2^20, S = 8 shards) on the emulated
# graph axis (all shards in one K1 launch a round), Alg. 3's main cell cut
# into 4 shards, and the torch.distributed path on a 1 x 1 NCCL mesh
# ---------------------------------------------------------------------------

MD_N, MD_EXTRA, MD_S, MD_T = 1 << 20, 1.0, 8, 50
MD_DROP, MD_B = 0.2, 4
MD_SOCIAL_S = 4
MD_PRE = 3          # rounds before the one-round check


def md_scenario(n: int):
    """benchmarks/pushsum_sweep.py:285's cell: a random strongly connected
    digraph (a Hamiltonian cycle plus n extra edges, E ~ 2.1 M at 2^20) and
    its (n, 1) values, both from seed 0."""
    from repro_torch.core.graphs import random_strongly_connected_edge_list
    rng = np.random.default_rng(0)
    el = random_strongly_connected_edge_list(n, MD_EXTRA, rng)
    return el, rng.normal(size=(n, 1)).astype(np.float32)


def md_lockstep(dev, pad, sh, w, policy, halo):
    """``MD_T`` rounds of the unsharded step on the padded list and of the
    step on the emulated axis, side by side from the same start, each on
    its own state -> (a line on the one-round check, the two final
    states). The one-round check, at round ``MD_PRE``, steps the axis
    from the unsharded state: rho bit-equal; zm and sigma_zm bit-equal at
    every receiver whose in-edges lie on one shard (fp32 psum), and at
    the boundary receivers within the bound for two orders of one float32
    sum, deg 2^-23 sum |increments| (plus an ulp of the value); under
    ``"scatter"`` with half storage every receiver within the reduced
    row's rounding to storage and one storage ulp, 2^-7 (|value| + share
    sum |increments|), as well."""
    import torch
    from repro_torch.core.prng import prng_key
    from repro_torch.core.pushsum import (EmulatedAxis, edge_index_tensors,
                                          init_sparse_state,
                                          partitioned_edges, shard_edge_mask,
                                          sparse_pushsum_step,
                                          step_edge_mask)
    axis = EmulatedAxis(sh.n_shards)
    src, dst, valid, offsets = (x.to(dev) for x in edge_index_tensors(pad))
    held = [x.to(dev) for x in partitioned_edges(
        sh.src[None], sh.dst[None], sh.valid[None], sh.n, axis)]
    drop = torch.tensor(MD_DROP, device=dev)
    B = torch.tensor(MD_B, dtype=torch.int32, device=dev)
    state = init_sparse_state(torch.from_numpy(w).to(dev), pad.E, policy)
    sharded = state
    for t in range(MD_T):
        mask = step_edge_mask(prng_key(0), t, pad.E, drop, B)
        if t == MD_PRE:
            require(torch.equal(mask, shard_edge_mask(
                prng_key(0), t, sh.e_shard, drop, B, graph_axis=axis)),
                "the emulated axis' mask window is the padded draw")
            prev = state
            got = sparse_pushsum_step(state, mask, *held[:3],
                                      offsets=held[3], policy=policy,
                                      graph_axis=axis, halo=halo)
        sharded = sparse_pushsum_step(sharded, mask, *held[:3],
                                      offsets=held[3], policy=policy,
                                      graph_axis=axis, halo=halo)
        state = sparse_pushsum_step(state, mask, src, dst, valid,
                                    offsets=offsets, policy=policy)
        if t == MD_PRE:
            one = state
    torch.cuda.synchronize()
    require(torch.equal(got.rho_zm, one.rho_zm), "one round: rho_new "
            "bit-equal")
    inc = (one.rho_zm.float() - prev.rho_zm.float()).abs()
    sumabs = torch.zeros((sh.n, inc.shape[1]), device=dev).index_add_(
        0, dst, inc)
    deg = torch.bincount(dst[valid].long(), minlength=sh.n)[:, None].float()
    share = 1.0 / (torch.bincount(src[valid].long(), minlength=sh.n)
                   .float() + 1.0)[:, None]
    bnd = torch.from_numpy(sh.boundary).to(dev)
    half = one.zm.dtype != torch.float32
    worst = {}
    for f in ("zm", "sigma_zm"):
        a, b = getattr(got, f).float(), getattr(one, f).float()
        tol = deg * EPS32 * sumabs + EPS32 * b.abs()
        if half:
            # the reduced row's rounding (2^-9 of |recv| <= sum |inc|), then
            # one storage ulp of the value (2^-7 of it) either way
            tol = tol + 2.0 ** -7 * (b.abs() + share * sumabs)
        else:
            require(torch.equal(a[~bnd], b[~bnd]), f"one round: {f} "
                    f"bit-equal at the interior receivers")
        require(bool(((a - b).abs() <= tol).all()), f"one round: {f} "
                f"within the bound")
        worst[f] = (a - b).abs()[bnd].max().item() if bool(bnd.any()) \
            else 0.0
    line = (f"one round after {MD_PRE}: rho_new bit-equal; "
            + ("every receiver within the reduced rows' rounding"
               if half else "interior receivers bit-equal")
            + f"; boundary receivers {int(bnd.sum())}, largest gap zm "
            f"{worst['zm']:.3e}, sigma {worst['sigma_zm']:.3e}")
    return line, state, sharded


def gloo_cuda_probe(dev) -> dict:
    """Whether this torch's gloo takes CUDA tensors for the three
    collectives of the graph axis, on a one-rank gloo group beside the NCCL
    one -> {collective: "ok" or the error}."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.pushsum import collective
    group = dist.new_group(backend="gloo")
    x = torch.ones(8, device=dev)
    out = {}
    for name, fn in (
            ("all_reduce", lambda: dist.all_reduce(x, group=group)),
            ("reduce_scatter", lambda: collective("reduce_scatter")(
                torch.empty(8, device=dev), x, group=group)),
            ("all_gather", lambda: collective("all_gather")(
                torch.empty(8, device=dev), x, group=group))):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # the probe reports, the phase goes on
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    dist.destroy_process_group(group)
    return out


def md_gloo_rank(rank: int, port: int, out: str) -> None:
    """One of 2 gloo ranks on this card: (a)'s sweep on a 1 x 2 mesh of
    CUDA tensors (a shard a rank), psum and scatter, saved to ``out``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from repro_torch.core import ExecutionPlan
    from repro_torch.core.sweeps import run_pushsum_sweep
    from repro_torch.distributed.sharding import sweep_mesh
    torch.cuda.set_device(0)    # both ranks share the one card
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        mesh = sweep_mesh(1, 2, device_type="cuda")
        el, w = md_scenario(MD_N)
        res = {}
        for halo in ("psum", "scatter"):
            r = run_pushsum_sweep(w, el, MD_T, drop_probs=[MD_DROP],
                                  seeds=[0], B=MD_B, plan=ExecutionPlan(
                                      mesh=mesh, graph_shards=2, halo=halo))
            res[halo] = {f: getattr(r, f).cpu()
                         for f in ("err", "final_ratio", "mass_gap")}
        torch.save(res, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def md_gloo_ranks(w, el) -> str:
    """Spawn the 2 gloo ranks of :func:`md_gloo_rank` on this card and hold
    each rank's rows against the 2-shard emulation in this process: bit
    for bit (with 2 shards no receiver's sum has more than two non-zero
    operands)."""
    import multiprocessing as mp
    import tempfile

    import torch
    from repro_torch.core import ExecutionPlan
    from repro_torch.core.sweeps import run_pushsum_sweep
    port = mm_free_port()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as out:
        procs = [ctx.Process(target=md_gloo_rank, args=(r, port, out))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(300)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        require(all(p.exitcode == 0 for p in procs),
                "2 gloo ranks on the card ran to their end")
        ranks = [torch.load(Path(out) / f"rank{r}.pt") for r in range(2)]
    for halo in ("psum", "scatter"):
        want = run_pushsum_sweep(w, el, MD_T, drop_probs=[MD_DROP],
                                 seeds=[0], B=MD_B, plan=ExecutionPlan(
                                     graph_shards=2, halo=halo))
        for got in ranks:
            require(all(torch.equal(got[halo][f], getattr(want, f).cpu())
                        for f in ("err", "final_ratio", "mass_gap")),
                    f"2 gloo ranks on the card ({halo}) equal the 2-shard "
                    f"emulation bit for bit")
    return ("2 gloo ranks on this card (sweep_mesh(1, 2), CUDA tensors), "
            f"N={el.n}, T={MD_T}, psum and scatter: every rank's err, final "
            "ratios and mass gaps bit-equal to the 2-shard emulation")


def multidevice_phase(dev, flush, model, rt, M) -> dict:
    """Phase 23 -> K1's figures at the partitioned shape."""
    import torch
    import torch.distributed as dist
    from repro_torch.analysis import pushsum_device_memory_gb
    from repro_torch.analysis.roofline import pushsum_halo_wire_bytes
    from repro_torch.core import ExecutionPlan
    from repro_torch.core.graphs import EdgeList, partition_edge_list
    from repro_torch.core.prng import prng_key
    from repro_torch.core.prng import Key
    from repro_torch.core.pushsum import (EmulatedAxis, GraphAxis,
                                          edge_index_tensors,
                                          partitioned_edges, sparse_ratios)
    from repro_torch.core.social import _social_scan_core
    from repro_torch.core.sweeps import _pushsum_sweep_core, run_pushsum_sweep
    from repro_torch.distributed.sharding import sweep_mesh
    from repro_torch.kernels.pushsum_edge import (edge_scatter_cuda,
                                                  edge_scatter_ref)
    from repro_torch.statics.memory import pushsum_sharded_step_bytes

    # ---- (a) push-sum at N = 2^20, 8 shards, emulated -------------------
    t0 = time.perf_counter()
    el, w = md_scenario(MD_N)
    sh = partition_edge_list(el, MD_S)
    pad = sh.padded_edge_list()
    N, E, e, S = el.n, sh.e_pad, sh.e_shard, MD_S
    n_bnd = int(sh.boundary.sum())
    log(f"[multi] N={N} E={el.E} d=1 cut into {S} shards of {e} edges "
        f"(E_pad {E}), {n_bnd} boundary receivers; set-up "
        f"{time.perf_counter() - t0:.2f} s")
    require(0 < n_bnd <= S - 1, "at most one boundary receiver a cut")
    kw = dict(drop_probs=[MD_DROP], seeds=[0], B=MD_B)

    def sweep(edges, T, **plan):
        return run_pushsum_sweep(w, edges, T, plan=ExecutionPlan(**plan),
                                 **kw)

    pred = pushsum_device_memory_gb(N, el.E, 1, n_shards=S)
    held_own = N * 4 * 4 + E * 2 * 4     # node state, every shard's edges
    out = {}
    for tag, policy, halo in (("fp32", None, "psum"),
                              ("bf16", "bf16", "scatter")):
        sb = 4 if policy is None else 2
        line, st_u, st_s = md_lockstep(dev, pad, sh, w, policy, halo)
        # bf16: the ratios where both runs keep mass, within 4 bf16 ulps of
        # the inputs' scale (a ratio is a convex combination of the inputs;
        # phase 6k's rule for half storage: an agent whose m rounds
        # towards 0 has a ratio that says nothing)
        m_u, m_s = st_u.m.float(), st_s.m.float()
        heavy = ((m_u >= 0.1) & (m_s >= 0.1)) if sb == 2 else \
            torch.ones_like(m_u, dtype=torch.bool)
        r_u, r_s = (sparse_ratios(x)[:, 0] for x in (st_u, st_s))
        tol = (dict(rtol=1e-4, atol=1e-5) if sb == 4
               else dict(rtol=2.0 ** -6,
                         atol=2.0 ** -6 * float(np.abs(w).max())))
        torch.testing.assert_close(r_s[heavy], r_u[heavy], **tol)
        log(f"[multi] {tag} {halo}: {line}; after {MD_T} rounds side by "
            f"side: {int((r_s != r_u).sum())} of {N} ratios differ, max "
            f"{(r_s - r_u)[heavy].abs().max().item():.3e} on "
            + ("every agent" if sb == 4 else
               f"the {int(heavy.sum())} agents with m >= 0.1 in both")
            + f" (held within "
            f"rtol {tol['rtol']:.3g} atol {tol['atol']:.3g}), total mass "
            f"{m_s.sum().item():.2f} (unsharded {m_u.sum().item():.2f})")
        _zero_counts()
        GraphAxis.wire_bytes = 0.0
        res_s = peak_run(f"push-sum N={N} {tag} on {S} emulated shards",
                         lambda p=policy, h=halo: sweep(
                             el, MD_T, graph_shards=S, halo=h, policy=p),
                         (pred, held_own, "node state plus all S shards' "
                          "edge state (one process holds the axis)",
                          "the model is one device's of an S-device mesh"))
        torch.cuda.synchronize()
        counts = _counts()
        wire = GraphAxis.wire_bytes / MD_T
        require(counts == _only(edge_scatter=MD_T, edge_scatter_tiled=MD_T,
                                edge_scatter_sharded=MD_T,
                                edge_scatter_half=MD_T * (sb == 2)),
                f"{tag}: K1 once a round for all {S} shards")
        res_u = sweep(pad, MD_T, policy=policy)
        torch.cuda.synchronize()
        require(_counts()["edge_scatter_sharded"] == MD_T,
                "the unsharded run launched no sharded K1")
        fr_s, fr_u = res_s.final_ratio[0, :, 0], res_u.final_ratio[0, :, 0]
        require(torch.equal(fr_s, r_s) and torch.equal(fr_u, r_u),
                f"{tag}: the sweeps' final ratios are the side-by-side runs'")
        mgap = (res_s.mass_gap.abs().max().item(),
                res_u.mass_gap.abs().max().item())
        if sb == 4:
            torch.testing.assert_close(res_s.err, res_u.err, **tol)
            require(max(mgap) <= 1e-4 * N, "mass gap within 1e-4 N")
        model_wire = pushsum_halo_wire_bytes(N, 1, S, variant=halo,
                                             storage_bytes=sb)
        require(wire == model_wire, f"{tag}: the axis' halo bytes a round "
                f"are pushsum_halo_wire_bytes'")
        shard_model = pushsum_sharded_step_bytes(N, el.E, 1, n_shards=S,
                                                 policy=policy)
        log(f"[multi] {tag} {halo}, run_pushsum_sweep(graph_shards={S}) "
            f"T={MD_T}: launches {counts}; its final ratios are the "
            f"side-by-side run's, the unsharded sweep's too; worst "
            f"consensus error at T "
            f"{res_s.err[0, -1].item():.4e} (unsharded "
            f"{res_u.err[0, -1].item():.4e}); mass gap {mgap[0]:.4g} "
            f"(unsharded "
            f"{mgap[1]:.4g}, limit 1e-4 N = {1e-4 * N:.1f}"
            + ("" if sb == 4 else ", not held for bf16") + f"); halo "
            f"{wire:.0f} B a round = pushsum_halo_wire_bytes {model_wire:.0f}"
            f" ({halo}, storage {sb} B); per-shard step bytes "
            f"(pushsum_sharded_step_bytes) {shard_model}, the shard's held "
            f"edge state {e * 2 * sb} B and node state {N * 4 * sb} B")
        out[f"launches_{tag}"] = counts["edge_scatter"]
    # step times of the sweep's loop (its host set-up apart), sharded and
    # unsharded in turns
    axis = EmulatedAxis(S)
    src_l, dst_l, valid_l, off_l = (x.to(dev) for x in partitioned_edges(
        sh.src[None], sh.dst[None], sh.valid[None], N, axis))
    edges_u = [x.to(dev) for x in edge_index_tensors(pad)]
    w_d = torch.from_numpy(w).to(dev)
    coords = (Key(np.zeros(1, np.int64), np.zeros(1, np.int64)),)
    drop_b = torch.full((1,), MD_DROP, device=dev)
    B_b = torch.full((1,), MD_B, dtype=torch.int32, device=dev)

    def loop(edges, T, **kw_):
        _pushsum_sweep_core(*coords, *edges, drop_b, B_b, w_d, T=T,
                            backend="auto", **kw_)

    held = (src_l, dst_l, valid_l, off_l)
    ms = turns_ms({
        "sharded": lambda T: loop(held, T, graph_axis=axis),
        "unsharded": lambda T: loop(edges_u, T),
        "sharded bf16 scatter": lambda T: loop(
            held, T, graph_axis=axis, halo="scatter", policy="bf16")})
    setup = {}
    for name, edges_ in (("sharded", el), ("unsharded", pad)):
        t0 = time.perf_counter()
        sweep(edges_, 0, **({"graph_shards": S} if name == "sharded"
                            else {}))
        torch.cuda.synchronize()
        setup[name] = time.perf_counter() - t0
    log(f"[timing] push-sum N={N}, {S} emulated shards, the sweep's loop: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
        + f" a step (in turns, median of {SWEEP_RUNS} runs of {STEP_T} "
        f"steps); a call's host set-up (T = 0): sharded "
        f"{setup['sharded']:.3f} s (partition, layout, CSR over {S} N "
        f"slots), unsharded {setup['unsharded']:.3f} s")
    out["step_ms"] = ms
    # K1 at the partitioned shape: S N receivers
    g = torch.Generator(device=dev).manual_seed(23)
    sigma = torch.randn((N, 2), generator=g, device=dev)
    rho = torch.randn((E, 2), generator=g, device=dev)
    live = (torch.rand(E, generator=g, device=dev) < 0.8) & valid_l
    k1 = (sigma, rho, live, src_l, off_l)
    err = k1_hold(f"partitioned shape ({S} x {N} receivers)", k1, dst_l,
                  None)
    k1_ms = event_ms(lambda: edge_scatter_cuda(*k1, shards=S), TIMED_RUNS,
                     flush, hide_host=True)
    plain_ms = event_ms(lambda: edge_scatter_ref(*k1[:4], dst_l,
                                                  n_recv=S * N), 5, flush)
    b_ms, by = bound(nbytes(*k1, rho) + S * N * 2 * 4, 2 * E * 2)
    log(f"[timing] edge_scatter at the partitioned shape ({S} x {N} "
        f"receivers, E {E}, D 2): {k1_ms:.5f} ms with the host hidden "
        f"(median of {TIMED_RUNS}, L2 flushed), bound {b_ms:.5f} ({by}), "
        f"plain {plain_ms:.5f}; max_abs_err {err:.3e}")
    out.update(partitioned_ms=k1_ms, partitioned_bound_ms=b_ms,
               partitioned_bound_by=by, partitioned_plain_ms=plain_ms,
               partitioned_max_abs_err=err)

    # ---- (b) Alg. 3's main cell on 4 emulated shards ---------------------
    el3 = EdgeList(src=rt.src.numpy(), dst=rt.dst.numpy(), n=rt.rep_mask
                   .shape[0], valid=rt.valid.numpy())
    sh3 = partition_edge_list(el3, MD_SOCIAL_S)
    require(int(sh3.boundary.sum()) == 0 and sh3.e_pad == el3.E,
            "Alg. 3's cut into 4 shards is boundary-free")
    held = dict(zip(("src", "dst", "valid", "offsets"), partitioned_edges(
        sh3.src[None], sh3.dst[None], sh3.valid[None], el3.n,
        EmulatedAxis(MD_SOCIAL_S))))
    tables = model.tables.to(dev, torch.float32)

    def social(rt_, axis_):
        return _social_scan_core(
            prng_key(0), prng_key(0), rt_.to(dev), torch.log(tables),
            torch.cumsum(tables[:, model.truth, :], dim=-1),
            truth=model.truth, M=M, T=T_MAIN, store="log_ratio",
            backend="auto", graph_axis=axis_)

    _zero_counts()
    fs_s, (b_s, lr_s) = social(rt._replace(**held),
                               EmulatedAxis(MD_SOCIAL_S))
    torch.cuda.synchronize()
    counts = _counts()
    require(counts == _only(edge_scatter=T_MAIN, edge_scatter_tiled=T_MAIN,
                            edge_scatter_sharded=T_MAIN,
                            social_innov=T_MAIN),
            "Alg. 3 on 4 shards: K1 and K2 once a round")
    fs_u, (b_u, lr_u) = social(rt, None)
    torch.cuda.synchronize()
    same = (torch.equal(b_s, b_u) and torch.equal(lr_s, lr_u)
            and all(torch.equal(x, y) for x, y in zip(fs_s, fs_u)))
    require(same, "Alg. 3 on a boundary-free cut: beliefs, log ratios and "
            "the final state bit-equal to the unsharded run")
    log(f"[multi] Alg. 3 N={el3.n} E={el3.E} T={T_MAIN} on "
        f"{MD_SOCIAL_S} emulated shards of {sh3.e_shard} edges "
        f"(boundary-free): launches {counts}; beliefs, worst-log-ratio "
        f"curve and final state bit-equal to the unsharded run")
    out["launches_social"] = counts["edge_scatter"]

    # ---- (c) the torch.distributed path: a 1 x 1 NCCL mesh --------------
    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{mm_free_port()}", rank=0, world_size=1)
    try:
        mesh = sweep_mesh(1, 1, device_type="cuda")
        for halo in ("psum", "scatter"):
            GraphAxis.wire_bytes = 0.0
            got = sweep(el, MD_T, mesh=mesh, graph_shards=1, halo=halo)
            want = sweep(el, MD_T, graph_shards=1, halo=halo)
            torch.cuda.synchronize()
            require(all(torch.equal(getattr(got, f), getattr(want, f))
                        for f in ("err", "final_ratio", "mass_gap")),
                    f"the 1 x 1 NCCL mesh ({halo}) equals the S = 1 "
                    f"emulation bit for bit")
        probe = gloo_cuda_probe(dev)
    finally:
        dist.destroy_process_group()
    log(f"[multi] 1 x 1 NCCL mesh (sweep_mesh(1, 1)), N={N}, T={MD_T}, "
        f"psum and scatter: err, final ratios and mass gaps bit-equal to "
        f"the S = 1 emulation (NCCL all_reduce, reduce_scatter, "
        f"all_gather ran); gloo on CUDA tensors (one rank): {probe}")
    require(all(v == "ok" for v in probe.values()),
            "gloo takes CUDA tensors for the graph axis' collectives")
    log(f"[multi] {md_gloo_ranks(w, el)}")
    return out



# ---------------------------------------------------------------------------
# Phase 24: the model stack over ranks. Gloo ranks share this card (NCCL
# refuses two ranks on one GPU); each rank runs the port's entry points on
# its own copy, or its model blocks, and its kernels on the card
# ---------------------------------------------------------------------------

MM_W, MM_SEQ, MM_BATCH, MM_STEPS = 4, 1024, 8, 2    # (b): 2 rows a worker
MM_ROBUST_LAYERS = 4     # (b)'s paper_sim, of 8 since phase 26 (time limit;
#                          3 steps before it). At 2 layers pushsum_sparse's
#                          parameters came within the bound, not bit-equal
#: (b)'s runs: aggregator, F, Byzantine workers, (pods, per pod), steps.
#: The hierarchical trim of pods of 2 takes F = 0 (a trim of F needs
#: 2F + 1). pushsum's ring sends are gloo's host-staged path; it takes one
#: step, whose 16 rounds stage up to twice a rank's float32 row each
MM_RUNS = (("trimmed_mean", 1, (2,), (1, 4), MM_STEPS),
           ("hierarchical_trim", 0, (2,), (2, 2), MM_STEPS),
           ("trimmed_mean_sharded", 1, (2,), (1, 4), MM_STEPS),
           ("pushsum_sparse", 1, (), (1, 4), MM_STEPS),
           ("pushsum", 1, (), (2, 2), 1))
#: (b)'s bound on the parameters against row w: one bf16 ulp at each
#: leaf's largest entry (bit-equality is expected and reported)
MM_PARAM_REL_GAP = 2 ** -7
MM_SERVE_B, MM_SERVE_S, MM_SERVE_GEN = 2, 2048, 8    # (c)
MM_QWEN_LAYERS = 4       # of 36 (the script's time limit; 36 before
#                          phase 26, then 12)
#: (d) stays at 8 layers: at 4 its rank path's logit rms gap to one
#: process (4.86e-02, max 0.397) exceeded twice the plain serve path's
#: (8.69e-03), where 8 layers give 3.19e-02 against 1.92e-02
MM_OLMOE_LAYERS, MM_OLMOE_GEN = 8, 5                  # (d): prefill + 4
#: (d) in float32 at 2 layers, where the greedy rule has clear margins
MM_OLMOE_FP32_LAYERS, MM_OLMOE_FP32_GEN = 2, 8
MM_SERVES = ("qwen3_8b", "olmoe_1b_7b", "olmoe_fp32")
MM_MEAN_LAYERS, MM_MEAN_BATCH = 2, 8                  # (e)
MM_PROBE_OPS = ("all_reduce", "all_gather", "all_to_all", "reduce_scatter",
                "reduce_scatter_bf16", "send_recv")


def mm_free_port() -> int:
    """A free TCP port on localhost for a process group's store. It is
    drawn below Linux's ephemeral range (32768 up): a spawned rank binds
    it seconds after it is picked, and a port the kernel hands out to
    other connections meanwhile (another group's gloo pairs) could be
    taken by then."""
    import random
    import socket
    for port in random.sample(range(20_000, 32_768), 200):
        with socket.socket() as sock:
            try:
                sock.bind(("localhost", port))
            except OSError:
                continue
        return port
    raise RuntimeError("no free port in 20000-32767 on localhost")


def mm_spawn(target, world: int, out: str) -> list:
    """Start ``world`` ranks of ``target(rank, world, port, out)`` in
    spawned processes -> the processes (:func:`mm_join` waits)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    port = mm_free_port()
    procs = [ctx.Process(target=target, args=(r, world, port, out))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def mm_join(procs, timeout: float) -> list:
    """Wait up to ``timeout`` seconds for ``procs`` -> their exit codes (a
    rank still alive then is killed: None)."""
    t0 = time.perf_counter()
    for p in procs:
        p.join(max(1.0, timeout - (time.perf_counter() - t0)))
    codes = []
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return codes


def mm_init(rank: int, world: int, port: int):
    """A spawned rank: the port on the path, this card, the gloo group."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    return torch.device("cuda")


def mm_probe_rank(rank: int, world: int, port: int, out: str) -> None:
    """(a): one of 2 gloo ranks trying each collective of the rank
    communicator on CUDA tensors, checking its values, and writing its
    verdict before the next (``send_recv`` last: a refusal there may abort
    the process)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.pushsum import collective
    dev = mm_init(rank, world, port)
    x = torch.arange(8, dtype=torch.float32, device=dev) + 10 * rank
    other = torch.arange(8, dtype=torch.float32, device=dev) \
        + 10 * (1 - rank)

    def run(op):
        if op == "all_reduce":
            y = x.clone()
            dist.all_reduce(y)
            return torch.equal(y, x + other)
        if op == "all_gather":
            y = torch.empty(16, device=dev)
            collective("all_gather")(y, x)
            pair = (x, other) if rank == 0 else (other, x)
            return torch.equal(y, torch.cat(pair))
        if op == "all_to_all":
            y = torch.empty(8, device=dev)
            dist.all_to_all_single(y, x)
            mine = slice(4 * rank, 4 * rank + 4)
            pair = (x[mine], other[mine]) if rank == 0 else \
                (other[mine], x[mine])
            return torch.equal(y, torch.cat(pair))
        if op.startswith("reduce_scatter"):    # FSDP's backward (phase 26)
            dt = torch.bfloat16 if op.endswith("bf16") else torch.float32
            y = torch.empty(4, dtype=dt, device=dev)
            collective("reduce_scatter")(y, x.to(dt))
            return torch.equal(y, (x + other).to(dt)[4 * rank:4 * rank + 4])
        y = torch.empty(8, device=dev)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, 1 - rank),
                dist.P2POp(dist.irecv, y, 1 - rank)]):
            req.wait()
        return torch.equal(y, other)

    for op in MM_PROBE_OPS:
        path = Path(out) / f"probe_{op}_{rank}"
        try:
            ok = run(op)
            torch.cuda.synchronize()
            path.write_text("ok" if ok else "wrong values")
        except Exception as e:  # the probe reports, the phase goes on
            path.write_text(f"{type(e).__name__}: "
                            f"{str(e).splitlines()[0][:160]}")
            break
    dist.destroy_process_group()


def mm_probe_verdicts(out: str, codes: list) -> dict:
    verdicts = {}
    for op in MM_PROBE_OPS:
        got = [Path(out) / f"probe_{op}_{r}" for r in range(2)]
        texts = [p.read_text() if p.exists() else None for p in got]
        if all(t == "ok" for t in texts):
            verdicts[op] = "ok"
        else:
            verdicts[op] = next((t for t in texts if t and t != "ok"),
                                f"no verdict (rank exit codes {codes})")
    return verdicts


def mm_train_cfg(layers: int | None = None):
    from repro_torch.configs import get_config
    import dataclasses
    cfg = get_config("paper_sim")
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def mm_robust_tc(kind: str, F: int, byz: tuple):
    from repro_torch.distributed.aggregation import AggregatorConfig
    from repro_torch.distributed.trainer import TrainConfig
    from repro_torch.optim import AdamWConfig
    return TrainConfig(arch=mm_train_cfg(MM_ROBUST_LAYERS),
                       agg=AggregatorConfig(
        kind=kind, F=F), opt=AdamWConfig(lr=3e-4, warmup_steps=1,
                                          total_steps=MM_STEPS),
        byzantine_workers=byz)


def mm_data(cfg, W: int, batch: int = MM_BATCH):
    from repro_torch.data import SyntheticLMData
    return SyntheticLMData(cfg.vocab, MM_SEQ, batch, flavour="markov",
                           n_agents=W, seed=0)


def mm_robust_rank(rank: int, world: int, port: int, out: str) -> None:
    """(b): worker ``rank`` of 4 gloo ranks: paper_sim at published widths,
    each of ``MM_RUNS`` for its steps through the mesh step on its own
    copy, held against row w of the one-process step (saved by the
    parent): parameters, losses, the first aggregate; the communicator's
    host-staged calls and bytes."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.comm import Comm
    from repro_torch.distributed.sharding import RankMesh
    from repro_torch.distributed.trainer import make_train_step, param_spread
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import leaves
    dev = mm_init(rank, world, port)
    res = {}
    try:
        for kind, F, byz, shape, steps in MM_RUNS:
            rm = RankMesh(init_device_mesh("cuda", shape,
                                           mesh_dim_names=("pod", "data")))
            comm = Comm(rm)
            w = rm.index("pod", "data")
            tc = mm_robust_tc(kind, F, byz)
            params = M.init_params(0, tc.arch, dev)
            opt = adamw_init(params)
            step = make_train_step(tc, mesh=rm, comm=comm, record="aggregate")
            agg0 = []

            def keep(s, st):
                if s == 0:
                    agg0.append(st.aggregate.clone())

            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            t0 = time.perf_counter()
            losses = run_steps(step, params, opt, mm_data(tc.arch, MM_W),
                               steps, dev, on_step=keep)
            wall = time.perf_counter() - t0
            counts = _counts()
            spread = float(param_spread(params, rm, comm))
            exp = torch.load(Path(out) / f"exp_{kind}_{w}.pt")
            got, want = leaves(params), [x.to(dev) for x in exp["params"]]
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            gaps = [((a.float() - b.float()).abs().max(),
                     b.float().abs().max().clamp_min(1e-30))
                    for a, b in zip(got, want)]
            a0 = exp["agg0"].to(dev)
            res[kind] = {
                "params_bit_equal": same,
                "params_max_abs_gap": max(g.item() for g, _ in gaps),
                "params_rel_gap": max((g / m).item() for g, m in gaps),
                "agg0_bit_equal": torch.equal(agg0[0], a0),
                "agg0_rel_rms": rel_rms(agg0[0], a0),
                "losses": losses, "want_losses": exp["losses"],
                "loss_gap": max(abs(a - b) for a, b in
                                zip(losses, exp["losses"])),
                "spread": spread, "wall_s": wall,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": {k: v for k, v in counts.items() if v},
                "staged_calls": comm.staged_calls,
                "staged_bytes": comm.staged_bytes}
            del params, opt, step, agg0, exp, got, want
            torch.cuda.empty_cache()
        (Path(out) / f"robust_{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def mm_robust_reference(dev, out: str) -> dict:
    """(b)'s one-process runs on this card (phase 20's trainer: W stacked
    copies, ``WorkerLayout``), each row w saved for rank w -> the losses
    by run."""
    import torch
    from repro_torch.distributed.aggregation import WorkerLayout
    from repro_torch.distributed.trainer import (make_train_step,
                                                 replicate_for_workers,
                                                 worker_opt_init)
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import leaves
    losses = {}
    for kind, F, byz, (P, Wd), steps in MM_RUNS:
        tc = mm_robust_tc(kind, F, byz)
        params = replicate_for_workers(M.init_params(0, tc.arch, dev), MM_W)
        opt = worker_opt_init(params)
        step = make_train_step(tc, WorkerLayout(P, Wd), record="aggregate")
        agg0 = []

        def keep(s, st):
            if s == 0:
                agg0.append(st.aggregate.clone())

        losses[kind] = run_steps(step, params, opt, mm_data(tc.arch, MM_W),
                                 steps, dev, on_step=keep)
        for w in range(MM_W):
            torch.save({"params": [x[w].cpu() for x in leaves(params)],
                        "agg0": agg0[0][w].cpu(),
                        "losses": losses[kind]},
                       Path(out) / f"exp_{kind}_{w}.pt")
        del params, opt, step, agg0
        torch.cuda.empty_cache()
    return losses


def mm_pushsum_staged(kind: str, steps: int, shape: tuple) -> list:
    """What the ring's sends stage through host memory on each rank of
    (b)'s ``pushsum`` run -> [(calls, bytes)] by worker: from the keys
    :func:`run_steps` hands the step, each round a rank sends its (D + 1,)
    float32 cumulative when its link is up and receives when its
    predecessor's is; a round with either is one call."""
    from repro_torch.core.prng import fold_in, prng_key
    from repro_torch.distributed.aggregation import _uniform_scalar
    from repro_torch.models import model as M
    tc = mm_robust_tc(kind, 0, ())
    cfg = tc.agg
    P, Wd = shape
    row = 4 * (sum(x.numel() for x in _leaves(M.param_shapes(tc.arch))) + 1)
    out = []
    for w in range(P * Wd):
        didx = w % Wd
        prev_w = w - didx + (didx - 1) % Wd
        calls = nbytes_ = 0
        for s in range(steps):
            key = fold_in(prng_key(0), s)
            for t in range(cfg.gossip_rounds):
                kt = fold_in(key, t)
                forced = t % cfg.B == cfg.B - 1
                up, heard = (forced or _uniform_scalar(fold_in(kt, v))
                             >= cfg.drop_prob for v in (w, prev_w))
                calls += int(up or heard)
                nbytes_ += row * (int(up) + int(heard))
        out.append((calls, nbytes_))
    return out


def mm_serve_cfg(name: str):
    import dataclasses
    from repro_torch.configs import get_config
    if name == "qwen3_8b":
        return dataclasses.replace(get_config(name),
                                   n_layers=MM_QWEN_LAYERS)
    # OLMoE at phase 15d's depth (or 2 layers in float32), the
    # expert-parallel dispatch, a drop-free capacity (capacity factor
    # E / k: cap = T)
    cfg = get_config("olmoe_1b_7b")
    olmoe = dataclasses.replace(cfg, n_layers=MM_OLMOE_LAYERS,
                                moe_impl="sharded",
                                capacity_factor=cfg.n_experts / cfg.top_k)
    if name == "olmoe_fp32":
        return dataclasses.replace(olmoe, n_layers=MM_OLMOE_FP32_LAYERS,
                                   dtype="float32")
    return olmoe


def mm_serve_logits(params, cfg, prompts, toks, mesh=None, comm=None):
    """:func:`serve_logits` through the entry points (the mesh-taking step
    builders with ``mesh``): prefill, then a decode step on each of
    ``toks[:, :-1]`` -> (B, gen, V)."""
    import torch
    from repro_torch.distributed.server import (make_decode_step,
                                                make_prefill_step)
    S, gen = prompts.shape[1], toks.shape[1]
    pre = make_prefill_step(cfg, cache_len=S + gen + 1, mesh=mesh, comm=comm)
    dec = make_decode_step(cfg, mesh=mesh, comm=comm)
    with torch.inference_mode():
        lg, cache = pre(params, {"tokens": prompts})
        out = [lg[:, -1]]
        for i in range(gen - 1):
            lg, cache = dec(params, cache, toks[:, i:i + 1])
            out.append(lg[:, -1])
    return torch.stack(out, dim=1)


def mm_mean_tc(cfg):
    from repro_torch.distributed.trainer import TrainConfig
    from repro_torch.optim import AdamWConfig
    return TrainConfig(arch=cfg, opt=AdamWConfig(
        lr=3e-4, warmup_steps=1, total_steps=MM_STEPS))


def mm_model_rank(rank: int, world: int, port: int, out: str) -> None:
    """(c)-(e): model rank ``rank`` of a (data 1, model 2) mesh of 2 gloo
    ranks: Qwen3-8B and OLMoE-1B-7B (bf16, and float32 at 2 layers)
    served on their model blocks through the entry points, teacher-forced
    on the one-process tokens, and
    paper_sim's mean step; the logits and losses are saved for the
    parent."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.comm import Comm
    from repro_torch.distributed.sharding import RankMesh, param_specs
    from repro_torch.distributed.trainer import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    dev = mm_init(rank, world, port)
    rm = RankMesh(init_device_mesh("cuda", (1, 2),
                                   mesh_dim_names=("data", "model")))
    comm = Comm(rm)
    res = {}
    try:
        for name in MM_SERVES:
            cfg = mm_serve_cfg(name)
            exp = torch.load(Path(out) / f"exp_{name}.pt")
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params = M.init_local_params(
                0, cfg, param_specs(M.param_shapes(cfg), cfg, rm), rm, dev)
            torch.cuda.synchronize()
            t_init = time.perf_counter() - t0
            prompts, toks = exp["prompts"].to(dev), exp["toks"].to(dev)
            _zero_counts()
            t0 = time.perf_counter()
            lg = mm_serve_logits(params, cfg, prompts, toks, rm, comm)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            res[name] = {"launches": {k: v for k, v in _counts().items()
                                      if v},
                         "init_s": t_init, "serve_s": wall,
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                         "held_gb": sum(x.numel() * x.element_size()
                                        for x in _leaves(params)) / 1e9}
            if rank == 0:
                torch.save(lg.cpu(), Path(out) / f"rank_{name}.pt")
            del params, lg, exp
            torch.cuda.empty_cache()
        cfg = mm_train_cfg(MM_MEAN_LAYERS)
        params = M.init_local_params(
            0, cfg, param_specs(M.param_shapes(cfg), cfg, rm), rm, dev)
        opt = adamw_init(params)
        step = make_train_step(mm_mean_tc(cfg), mesh=rm, comm=comm)
        _zero_counts()
        losses = run_steps(step, params, opt, mm_data(cfg, 1, MM_MEAN_BATCH),
                           MM_STEPS, dev, robust=False)
        res["mean"] = {"losses": losses,
                       "launches": {k: v for k, v in _counts().items() if v}}
        res["staged"] = [comm.staged_calls, comm.staged_bytes]
        (Path(out) / f"model_{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def mm_serve_reference(dev, out: str, name: str) -> dict:
    """(c)/(d)'s one-process runs: ``generate`` on the kernel path, then
    the plain serve path teacher-forced on its tokens (the rounding noise
    phase 9's rule measures against); for Qwen3-8B also the plain full
    forward, which holds the one-process kernel path at its layers by
    phase 9's rule, and (f), the same requests through the mesh-taking
    steps on a 1 x 1 NCCL mesh, bit-equal to the one-process run. Saves
    prompts, tokens and logits for the ranks and the checks -> (logits,
    plain logits, tokens, launches, the NCCL line or None)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core.prng import prng_key, randint_n
    from repro_torch.distributed.comm import Comm
    from repro_torch.distributed.sharding import RankMesh
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    cfg = mm_serve_cfg(name)
    gen = {"qwen3_8b": MM_SERVE_GEN, "olmoe_1b_7b": MM_OLMOE_GEN,
           "olmoe_fp32": MM_OLMOE_FP32_GEN}[name]
    params = M.init_params(0, cfg, dev)
    prompts = randint_n(prng_key(24), MM_SERVE_B * MM_SERVE_S, 0, cfg.vocab,
                        dev).reshape(MM_SERVE_B, MM_SERVE_S)
    _zero_counts()
    with torch.inference_mode():
        toks, lk = generate(params, cfg, prompts, gen)
    torch.cuda.synchronize()
    counts = _counts()
    lp = serve_logits(params, cfg, prompts, toks, "torch")
    nccl = None
    if name == "qwen3_8b":
        with torch.inference_mode():
            lf = full_logits(params, cfg, prompts, toks, block=1)
        hold_logits(f"[ranks] (c) one process, {cfg.n_layers} layers",
                    f"{MM_SERVE_B} x {MM_SERVE_S} prompt tokens, {gen} "
                    f"tokens", toks, lk, lp, lf)
        del lf
        dist.init_process_group("nccl", init_method="tcp://localhost:"
                                f"{mm_free_port()}", rank=0, world_size=1)
        try:
            rm = RankMesh(init_device_mesh("cuda", (1, 1),
                                           mesh_dim_names=("data", "model")))
            comm = Comm(rm)
            with torch.inference_mode():
                toks_f, lk_f = generate(params, cfg, prompts, gen, mesh=rm,
                                        comm=comm)
            torch.cuda.synchronize()
            require(torch.equal(toks_f, toks) and torch.equal(lk_f, lk),
                    "(f) the 1 x 1 NCCL mesh's tokens and logits bit-equal "
                    "to the one-process run")
            nccl = (f"(f) 1 x 1 NCCL mesh, {cfg.name} at {cfg.n_layers} "
                    f"layers through the mesh-taking prefill and decode "
                    f"steps (the model axis' all_reduce and all_gather on "
                    f"NCCL): tokens and logits bit-equal to the one-process "
                    f"run; host-staged {comm.staged_calls}")
        finally:
            dist.destroy_process_group()
    torch.save({"prompts": prompts.cpu(), "toks": toks.cpu()},
               Path(out) / f"exp_{name}.pt")
    del params
    torch.cuda.empty_cache()
    return lk, lp, toks, counts, nccl


def mm_kernel_times(dev, flush) -> dict:
    """K4, K1, K5 and K6 at this phase's shapes, host hidden, beside
    their plain versions, bounds and library calls: K4 at (b)'s (4,
    99,496,704) F 1 and the sharded trim's (4, 24,874,176) stripes; K1 at
    (b)'s gossip (4 workers, a 2^24 + 1-column pass); K6 and K5 at (c)'s
    local heads (16 query heads on 4 KV heads of 128, 2 x 2,048 tokens;
    a decode step over 2,056 cache rows)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.graphs import (edge_list, random_strongly_connected,
                                         sort_by_dst)
    from repro_torch.distributed.aggregation import (GOSSIP_COLS,
                                                     AggregatorConfig)
    from repro_torch.kernels.pushsum_edge import (edge_scatter_cuda,
                                                  edge_scatter_ref)
    from repro_torch.kernels.swa import (attn_decode_cuda, attn_decode_ref,
                                         swa_prefill_cuda, swa_prefill_ref)
    from repro_torch.kernels.trimmed_mean import (trimmed_mean_cuda,
                                                  trimmed_mean_ref)
    g = torch.Generator(device=dev).manual_seed(24)
    D = mm_train_cfg().param_count()
    out = {}
    for tag, cols in (("k4_rank", D), ("k4_stripe", -(-D // MM_W))):
        x = torch.randn((MM_W, cols), generator=g, device=dev).mul_(1e-3)
        y = torch.empty(cols, device=dev)
        err = (trimmed_mean_cuda(x, 1, out=y) - trimmed_mean_ref(x, 1)
               ).abs().max().item()
        ms = event_ms(lambda: trimmed_mean_cuda(x, 1, out=y), TIMED_RUNS,
                      flush, True)
        plain = event_ms(lambda: trimmed_mean_ref(x, 1), 3, flush)
        lib = event_ms(lambda: torch.mean(x, 0), TIMED_RUNS, flush, True)
        b, by = bound(nbytes(x, y), cols * MM_W * 3)
        out[tag] = {"shape": [MM_W, cols], "ms": ms, "plain_ms": plain,
                    "bound_ms": b, "bound_by": by, "library_ms": lib,
                    "max_abs_err": err}
        del x, y
    cfg = AggregatorConfig(kind="pushsum_sparse")
    adj = random_strongly_connected(MM_W, cfg.graph_extra_edge_prob,
                                    np.random.default_rng(cfg.graph_seed))
    el, _, _, offsets = sort_by_dst(edge_list(adj), return_offsets=True)
    E, Dk = el.src.shape[0], GOSSIP_COLS + 1
    sigma = torch.randn((MM_W, Dk), generator=g, device=dev)
    rho = torch.randn((E, Dk), generator=g, device=dev)
    valid = torch.from_numpy(el.valid).to(dev)
    live = (torch.rand(E, generator=g, device=dev) < 0.9) & valid
    src = torch.from_numpy(el.src).to(dev)
    dst = torch.from_numpy(el.dst).to(dev)
    k1 = (sigma, rho, live, src, torch.from_numpy(offsets).to(dev))
    got = edge_scatter_cuda(*k1)
    want = edge_scatter_ref(sigma, rho, live, src, dst, n_recv=MM_W)
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    ms = event_ms(lambda: edge_scatter_cuda(*k1), 10, flush, True)
    plain = event_ms(lambda: edge_scatter_ref(sigma, rho, live, src, dst,
                                              n_recv=MM_W), 3, flush)
    b, by = bound(nbytes(*k1, *got), 2 * E * Dk)
    out["k1_rank"] = {"shape": [MM_W, E, Dk], "ms": ms, "plain_ms": plain,
                      "bound_ms": b, "bound_by": by, "library_ms": None,
                      "max_abs_err": err}
    del k1, got, want, sigma, rho
    B, S, H, Hkv, dh = MM_SERVE_B, MM_SERVE_S, 16, 4, 128
    bf = torch.bfloat16
    q, k, v = (torch.randn((B, S, h, dh), generator=g, device=dev).to(bf)
               for h in (H, Hkv, Hkv))
    o6 = swa_prefill_cuda(q, k, v, 0)
    err6 = (o6.float() - swa_prefill_ref(q.float(), k.float(), v.float(),
                                         0)).abs().max().item()
    tr = (0, 2, 1, 3)
    ms6 = event_ms(lambda: swa_prefill_cuda(q, k, v, 0), TIMED_RUNS, flush,
                   True)
    plain6 = event_ms(lambda: swa_prefill_ref(q, k, v, 0), 3, flush)
    lib6 = event_ms(lambda: F.scaled_dot_product_attention(
        q.permute(tr), k.permute(tr), v.permute(tr), is_causal=True,
        enable_gqa=True), TIMED_RUNS, flush, True)
    flops6 = 4 * dh * B * H * (S * (S + 1) // 2)
    b6, by6 = bound(nbytes(q, k, v, o6), flops6, hw().peak_flops)
    out["k6_local"] = {"shape": [B, S, H, Hkv, dh], "ms": ms6,
                       "plain_ms": plain6, "bound_ms": b6, "bound_by": by6,
                       "library_ms": lib6, "max_abs_err": err6}
    Wc = S + MM_SERVE_GEN
    q5 = torch.randn((B, H, dh), generator=g, device=dev).to(bf)
    k5, v5 = (torch.randn((B, Hkv, Wc, dh), generator=g, device=dev).to(bf)
              for _ in range(2))
    L = torch.full((B,), Wc, dtype=torch.int32, device=dev)
    o5 = attn_decode_cuda(q5, k5, v5, L)
    err5 = (o5.float() - attn_decode_ref(q5.float(), k5.float(), v5.float(),
                                         L)).abs().max().item()
    ms5 = event_ms(lambda: attn_decode_cuda(q5, k5, v5, L), TIMED_RUNS,
                   flush, True)
    plain5 = event_ms(lambda: attn_decode_ref(q5, k5, v5, L), TIMED_RUNS,
                      flush, True)
    lib5 = event_ms(lambda: F.scaled_dot_product_attention(
        q5[:, :, None], k5, v5, enable_gqa=True), TIMED_RUNS, flush, True)
    b5, by5 = bound(nbytes(q5, k5, v5, L, o5), 4 * B * H * Wc * dh,
                    hw().peak_flops)
    out["k5_local"] = {"shape": [B, H, Hkv, Wc, dh], "ms": ms5,
                       "plain_ms": plain5, "bound_ms": b5, "bound_by": by5,
                       "library_ms": lib5, "max_abs_err": err5}
    for tag, t in out.items():
        log(f"[timing] {tag} at {t['shape']}: {t['ms']:.5f} ms with the "
            f"host hidden, plain {t['plain_ms']:.5f}, library "
            f"{t['library_ms']}, bound {t['bound_ms']:.5f} "
            f"({t['bound_by']}); max_abs_err {t['max_abs_err']:.3e}")
    require(out["k4_rank"]["max_abs_err"] == 0.0
            and out["k4_stripe"]["max_abs_err"] == 0.0
            and out["k1_rank"]["max_abs_err"] == 0.0,
            "K4 and K1 at the rank shapes bit-equal to their plain versions")
    require(err6 <= 2 ** -8 * 4 + 1e-5 and err5 <= 2 ** -8 * 4 + 1e-5,
            "K6 and K5 at the local-head shapes within bf16 rounding")
    del q, k, v, o6, q5, k5, v5, o5
    torch.cuda.empty_cache()
    return out


def model_mesh_phase(dev, flush) -> dict:
    """Phase 24 -> the kernels line's figures of K4, K1, K5 and K6 on the
    rank paths."""
    import tempfile

    import torch
    from repro_torch.distributed.comm import GLOO_CUDA_HOST_STAGED
    from repro_torch.models import model as M
    from repro_torch.distributed.trainer import make_train_step
    from repro_torch.optim import adamw_init
    fig = {"times": mm_kernel_times(dev, flush)}
    with tempfile.TemporaryDirectory() as out:
        # (b)'s one-process rows first, then (a)'s probe pair beside (b)'s
        # four ranks
        t0 = time.perf_counter()
        want = mm_robust_reference(dev, out)
        log(f"[ranks] (b) one-process references ({MM_W} stacked copies, "
            f"phase 20's trainer): {time.perf_counter() - t0:.1f} s; losses "
            + "; ".join(f"{k} {v}" for k, v in want.items()))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        probe = mm_spawn(mm_probe_rank, 2, out)
        ranks = mm_spawn(mm_robust_rank, MM_W, out)
        codes_p = mm_join(probe, 120)
        codes = mm_join(ranks, 600)
        verdicts = mm_probe_verdicts(out, codes_p)
        refused = {op for op, v in verdicts.items() if v != "ok"}
        log(f"[ranks] (a) gloo on CUDA tensors, 2 ranks on this card: "
            f"{verdicts}; the communicator stages through host memory "
            f"{sorted(GLOO_CUDA_HOST_STAGED)}")
        require(refused == set(GLOO_CUDA_HOST_STAGED),
                "(a) gloo refuses on CUDA tensors exactly the collectives "
                "the communicator stages through host memory")
        require(codes == [0] * MM_W, f"(b) {MM_W} gloo ranks ran to their "
                f"end (exit codes {codes})")
        rows = [json.loads((Path(out) / f"robust_{r}.json").read_text())
                for r in range(MM_W)]
        k4 = {}
        for kind, F, byz, shape, steps in MM_RUNS:
            rs = [r[kind] for r in rows]
            k4[kind] = rs[0]["launches"].get("trimmed_mean", 0)
            log(f"[ranks] (b) {kind} F {F} Byzantine {byz} on (pod, data) "
                f"{shape}, paper_sim at published widths and "
                f"{MM_ROBUST_LAYERS} layers, {steps} steps "
                f"of {MM_BATCH} x {MM_SEQ} tokens, {MM_W} gloo ranks: "
                f"wall {max(r['wall_s'] for r in rs):.1f} s; parameters "
                f"bit-equal to row w of the one-process step "
                f"{[r['params_bit_equal'] for r in rs]} (max gap "
                f"{max(r['params_max_abs_gap'] for r in rs):.3e}, of the "
                f"leaf's largest entry "
                f"{max(r['params_rel_gap'] for r in rs):.3e}); first "
                f"aggregate bit-equal {[r['agg0_bit_equal'] for r in rs]} "
                f"(rel rms {max(r['agg0_rel_rms'] for r in rs):.3e}); "
                f"losses {rs[0]['losses']} (one process "
                f"{rs[0]['want_losses']}, gap "
                f"{max(r['loss_gap'] for r in rs):.3e}); spread "
                f"{rs[0]['spread']:.3e}; peaks "
                f"{[round(r['peak_gb'], 3) for r in rs]} GB; launches "
                f"rank 0 {rs[0]['launches']}; host-staged "
                f"{[r['staged_calls'] for r in rs]} calls, "
                f"{[r['staged_bytes'] for r in rs]} B")
            require(all(r["loss_gap"] <= 1e-3 for r in rs),
                    f"(b) {kind}: every rank's losses within 1e-3")
            require(all(r["agg0_rel_rms"] <= 1e-2 for r in rs),
                    f"(b) {kind}: the first aggregate within 1e-2 rel rms")
            require(all(r["params_rel_gap"] <= MM_PARAM_REL_GAP for r in rs),
                    f"(b) {kind}: every rank's parameters within one bf16 "
                    f"ulp of each leaf's largest entry of row w")
            staged = [(r["staged_calls"], r["staged_bytes"]) for r in rs]
            if kind == "pushsum":
                want_staged = mm_pushsum_staged(kind, steps, shape)
                log(f"[ranks] (b) pushsum: host-staged (calls, bytes) by "
                    f"rank {staged}, from the keys {want_staged}")
                require(staged == want_staged and all(c > 0 for c, _
                                                      in staged),
                        "(b) pushsum: the ring's sends staged through host "
                        "memory, a call a round with a send or a receive")
            else:
                require(staged == [(0, 0)] * MM_W,
                        f"(b) {kind}: nothing staged through host memory")
            if kind == "pushsum_sparse":
                require(all(r["launches"].get("edge_scatter", 0) > 0
                            for r in rs), "(b) K1 on every rank")
            elif kind != "pushsum":
                per_step = 2 if kind == "hierarchical_trim" else 1
                require(all(r["launches"].get("trimmed_mean", 0)
                            == per_step * steps for r in rs),
                        f"(b) {kind}: K4 {per_step} a step on every rank")
        fig["robust"] = {kind: {k: rows[0][kind][k] for k in (
            "params_bit_equal", "params_rel_gap", "agg0_rel_rms",
            "loss_gap", "peak_gb", "launches", "wall_s", "staged_calls",
            "staged_bytes")} for kind, *_ in MM_RUNS}
        log(f"[ranks] (a)-(b): {time.perf_counter() - t0:.1f} s")
        # (c)-(f): the one-process runs (and the NCCL mesh), then the ranks
        t0 = time.perf_counter()
        ref = {name: mm_serve_reference(dev, out, name)
               for name in MM_SERVES}
        log(f"[ranks] {ref['qwen3_8b'][4]}")
        cfg = mm_train_cfg(MM_MEAN_LAYERS)
        params = M.init_params(0, cfg, dev)
        opt = adamw_init(params)
        mean_want = run_steps(make_train_step(mm_mean_tc(cfg)), params, opt,
                              mm_data(cfg, 1, MM_MEAN_BATCH), MM_STEPS, dev,
                              robust=False)
        del params, opt
        torch.cuda.empty_cache()
        log(f"[ranks] (c)-(f) one-process runs: "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        codes = mm_join(mm_spawn(mm_model_rank, 2, out), 600)
        require(codes == [0, 0], f"(c)-(e) 2 gloo ranks ran to their end "
                f"(exit codes {codes})")
        mrows = [json.loads((Path(out) / f"model_{r}.json").read_text())
                 for r in range(2)]
        for name, what, min_clear in (
                ("qwen3_8b", "(c) tensor-parallel", 0.0),
                ("olmoe_1b_7b", "(d) expert-parallel", 0.0),
                ("olmoe_fp32", "(d) expert-parallel float32", 0.5)):
            lk, lp, toks, counts, _ = ref[name]
            lr = torch.load(Path(out) / f"rank_{name}.pt").to(dev)
            cfg = mm_serve_cfg(name)
            gen = toks.shape[1]
            layers = cfg.n_layers
            for r in mrows:
                ln = r[name]["launches"]
                require(ln.get("swa_prefill", 0) == layers
                        and ln.get("attn_decode", 0) == layers * (gen - 1),
                        f"{what}: K6 once a layer in prefill and K5 once a "
                        f"layer a decode step on every rank")
            log(f"[ranks] {what} {cfg.name} at {layers} layers, model 2 on "
                f"2 gloo ranks, {MM_SERVE_B} x {MM_SERVE_S} prompt tokens, "
                f"{gen} tokens teacher-forced: rank launches "
                f"{[r[name]['launches'] for r in mrows]} (one process "
                f"{ {k: v for k, v in counts.items() if v} }); init "
                f"{[round(r[name]['init_s'], 2) for r in mrows]} s, serve "
                f"{[round(r[name]['serve_s'], 2) for r in mrows]} s; held "
                f"{[round(r[name]['held_gb'], 3) for r in mrows]} GB, peaks "
                f"{[round(r[name]['peak_gb'], 3) for r in mrows]} GB")
            hold_logits(f"[ranks] {what}", "rank path against the "
                        "one-process kernel path (the plain serve path as "
                        "the noise)", lr.argmax(-1), lr, lp, lk, min_clear)
            if cfg.dtype == "float32":    # phase 15h's float32 limit
                torch.testing.assert_close(lr, lk, atol=1e-3, rtol=1e-3)
            same = (lr.argmax(-1) == toks).float().mean().item()
            log(f"[ranks] {what}: the rank path's greedy choice is the "
                f"one-process token at {same:.3f} of the positions")
            fig[name] = {r_: mrows[r_][name] for r_ in range(2)}
            del lk, lp, lr
        got = mrows[0]["mean"]["losses"]
        gap = max(abs(a - b) for a, b in zip(got, mean_want))
        log(f"[ranks] (e) paper_sim mean step at {MM_MEAN_LAYERS} layers, "
            f"published widths, model 2, {MM_STEPS} steps of "
            f"{MM_MEAN_BATCH} x {MM_SEQ} tokens: losses {got} (one process "
            f"{mean_want}, gap {gap:.3e}); launches "
            f"{mrows[0]['mean']['launches']}; host-staged "
            f"{[r['staged'] for r in mrows]}")
        require(gap <= 1e-2 and all(r["mean"]["losses"] == got
                                    for r in mrows),
                "(e) the mean step's losses within 1e-2 of one process, "
                "equal on both ranks")
        log(f"[ranks] (c)-(e) ranks: {time.perf_counter() - t0:.1f} s")
        fig["mean"] = mrows[0]["mean"]
        fig["k4_launches"] = k4
    return fig



# ---------------------------------------------------------------------------
# K5's rank-partial mode (phase 2) and phase 25: the other families over
# model ranks. Gloo ranks share this card; each serves its model blocks of
# RecurrentGemma-2B (a sequence-split ring: K5's rank-partial mode), RWKV6
# (K7 on its heads), Whisper-small and InternVL2-26B (K5/K6 on local heads,
# whole odd vocabularies)
# ---------------------------------------------------------------------------

#: phase 2's rank-partial K5: RecurrentGemma's per-rank decode shape (8
#: requests, 10 query heads on one KV head of 256), blocks of 1,024 and 512
#: rows of a 2,048-row ring
K5P_B, K5P_H, K5P_DH, K5P_WC = 8, 10, 256, 2048
K5P_BLOCKS = (2, 4)


def k5p_lengths(kind: str, n: int, g, dev):
    """(B,) int32 valid rows of the whole ring: "wrapped" (every row),
    "first" (rows in the first block only: the later blocks are empty),
    "ragged" (random, one request at 1)."""
    import torch
    B, Wc = K5P_B, K5P_WC
    if kind == "wrapped":
        return torch.full((B,), Wc, dtype=torch.int32, device=dev)
    hi = Wc // n if kind == "first" else Wc
    L = torch.randint(1, hi + 1, (B,), generator=g, device=dev)
    if kind == "ragged":
        L[0] = 1
    return L.to(torch.int32)


def k5_partial_checks(dev) -> float:
    """Phase 2: K5's rank-partial mode (``attn_decode_partial_cuda``) on
    each block of the ring against its plain version, and the blocks'
    merge through K5's combine kernel (``attn_decode_merge_cuda``) against
    the plain merge and the whole decode's plain version, at RecurrentGemma's
    per-rank shape, 2 and 4 blocks, a wrapped ring, empty blocks and ragged
    lengths, bf16 (the attention rule: rtol 2^-8, atol 1e-5) and float32
    (1e-5). An empty block's triple is (acc 0, m -inf, l 0) exactly ->
    the largest error of a merge against the whole decode."""
    import torch
    from repro_torch.kernels.swa import (attn_decode_cuda, attn_decode_merge,
                                         attn_decode_merge_cuda,
                                         attn_decode_merge_ref,
                                         attn_decode_partial,
                                         attn_decode_partial_cuda,
                                         attn_decode_partial_ref,
                                         attn_decode_ref)
    from repro_torch.kernels.swa.ops import _TICKETS
    g = torch.Generator(device=dev).manual_seed(30)
    B, H, dh, Wc = K5P_B, K5P_H, K5P_DH, K5P_WC
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        tol = 2 ** -8 if dtype == torch.bfloat16 else 1e-5
        q = torch.randn((B, H, dh), generator=g, device=dev).to(dtype)
        k = (2 * torch.randn((B, 1, Wc, dh), generator=g, device=dev)
             ).to(dtype)
        v = torch.randn((B, 1, Wc, dh), generator=g, device=dev).to(dtype)
        for n in K5P_BLOCKS:
            Wb = Wc // n
            for kind in ("wrapped", "first", "ragged"):
                L = k5p_lengths(kind, n, g, dev)
                before = (attn_decode_cuda.launches,
                          attn_decode_partial_cuda.launches,
                          attn_decode_merge_cuda.launches)
                parts, empty_blocks = [], 0
                for r in range(n):
                    kb, vb = (t[:, :, r * Wb:(r + 1) * Wb].contiguous()
                              for t in (k, v))
                    Lr = torch.clamp(L - r * Wb, 0, Wb).to(torch.int32)
                    acc, m, l = attn_decode_partial(q, kb, vb, Lr)
                    wa, wm, wl = attn_decode_partial_ref(
                        q.float(), kb.float(), vb.float(), Lr)
                    e = Lr == 0
                    empty_blocks += int(e.sum())
                    require(bool((m[e] == -torch.inf).all())
                            and bool((l[e] == 0).all())
                            and bool((acc[e] == 0).all()),
                            "K5 partial: an empty block's triple is "
                            "(0, -inf, 0)")
                    torch.testing.assert_close(m[~e], wm[~e], rtol=tol,
                                               atol=1e-4)
                    torch.testing.assert_close(
                        acc[~e] / l[~e, :, None], wa[~e] / wl[~e, :, None],
                        rtol=tol, atol=1e-5)
                    parts.append((acc, m, l))
                acc, m, l = (torch.stack(t) for t in zip(*parts))
                got = attn_decode_merge(acc, m, l, dtype)
                torch.cuda.synchronize()
                require((attn_decode_cuda.launches,
                         attn_decode_partial_cuda.launches,
                         attn_decode_merge_cuda.launches)
                        == (before[0], before[1] + n, before[2] + 1),
                        "K5 partial: one partial launch a block and one "
                        "merge, no whole decode")
                torch.testing.assert_close(
                    got.float(), attn_decode_merge_ref(acc, m, l), rtol=tol,
                    atol=1e-5)
                # the triples packed as the ranks gather them, read in place
                packed = torch.cat([acc, m[..., None], l[..., None]], -1)
                require(torch.equal(attn_decode_merge(
                    packed[..., :dh], packed[..., dh], packed[..., dh + 1],
                    dtype), got), "K5 merge: the packed triples' strided "
                    "views merge bit-equal to the stacked ones")
                want = attn_decode_ref(q.float(), k.float(), v.float(), L)
                torch.testing.assert_close(got.float(), want, rtol=tol,
                                           atol=1e-5)
                e = (got.float() - want).abs().max().item()
                err = max(err, e)
                log(f"[kernels] K5 rank-partial {str(dtype)[6:]} B={B} "
                    f"H={H} Hkv=1 dh={dh}, {n} blocks of {Wb} rows of a "
                    f"{Wc}-row ring, {kind} lengths "
                    f"({empty_blocks} empty (request, block) pairs): the "
                    f"merged output against the whole plain decode "
                    f"max_abs_err {e:.3e}")
    require(all(int(t.abs().sum()) == 0 for t in _TICKETS.values()),
            "K5's ticket counters are back at zero after the partial mode")
    return err


#: phase 25's runs: run -> (arch, layers (None: full depth), mesh (data,
#: model) of the 4 gloo ranks). Published widths; depth cut to one
#: RecurrentGemma pattern (rglru, rglru, swa), 4 RWKV6 layers, 2 InternVL2
#: layers (each past phase 15's cells on the time limit), Whisper whole.
#: (2, 2) serves one request a data rank on model 2. Each run serves in
#: bf16 (the config's weights) and in float32 (the same weights, upcast)
FA_RUNS = {
    "recurrentgemma_mp2": ("recurrentgemma_2b", 3, (2, 2)),
    "recurrentgemma_mp4": ("recurrentgemma_2b", 3, (1, 4)),
    "rwkv6": ("rwkv6_1b6", 4, (2, 2)),
    "whisper": ("whisper_small", None, (2, 2)),
    "internvl2": ("internvl2_26b", 2, (2, 2)),
}
FA_DTYPES = ("bfloat16", "float32")
FA_B, FA_S, FA_GEN = 2, 2048, 17      # prefill + 16 decode steps
FA_WORLD = 4
#: the float32 rank path's bound against the one-process float32 kernel
#: path (the blocks sum their products in another order)
FA_FP32_TOL = 1e-4
#: the least share of positions on which the greedy rule is held: float32
#: (against the one-process float32 path), bf16 (against the one-process
#: bf16 choices: against float32, RWKV6's bf16 gap leaves 1 clear
#: position of 34)
FA_MIN_CLEAR = {"float32": 0.5, "bfloat16": 0.1}


def fa_cfg(run: str, dtype: str = "bfloat16"):
    import dataclasses
    from repro_torch.configs import get_config
    arch, layers, _ = FA_RUNS[run]
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return dataclasses.replace(cfg, dtype=dtype)


def fa_params(params, dtype: str):
    """The bf16 weights as ``dtype``: float32 upcasts every floating leaf
    (the same model, computed in float32)."""
    from repro_torch.models import model as M
    if dtype == "bfloat16":
        return params
    return M._tmap(lambda t: t.float() if t.is_floating_point() else t,
                   params)


def fa_serve_logits(params, cfg, prompts, toks, stubs, mesh, comm,
                    backend: str = "auto"):
    """:func:`mm_serve_logits` with the family's stub inputs: the
    mesh-taking prefill, then a decode step on each of ``toks[:, :-1]``
    -> ((B, gen, V), the cache)."""
    import torch
    from repro_torch.distributed.server import (make_decode_step,
                                                make_prefill_step)
    S, gen = prompts.shape[1], toks.shape[1]
    cache_len = S + gen + 1 + n_stub_rows(stubs)
    pre = make_prefill_step(cfg, cache_len=cache_len, backend=backend,
                            mesh=mesh, comm=comm)
    dec = make_decode_step(cfg, backend=backend, cache_len=cache_len,
                           mesh=mesh, comm=comm)
    with torch.inference_mode():
        lg, cache = pre(params, {"tokens": prompts, **stubs})
        out = [lg[:, -1]]
        for i in range(gen - 1):
            lg, cache = dec(params, cache, toks[:, i:i + 1])
            out.append(lg[:, -1])
    return torch.stack(out, dim=1), cache


def fa_rank(rank: int, world: int, port: int, out: str) -> None:
    """Phase 25: model rank ``rank`` of 4 gloo ranks on this card, serving
    each of :data:`FA_RUNS` on its mesh in bf16 and in float32 through the
    mesh-taking steps, on its blocks of the one-process weights
    (``init_local_params``), teacher-forced on the one-process bf16
    tokens; K5 (whole and rank-partial), K6 and K7 counted from 0 around
    each serve."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.comm import Comm
    from repro_torch.distributed.server import rank_rows
    from repro_torch.distributed.sharding import RankMesh, param_specs
    from repro_torch.models import model as M
    dev = mm_init(rank, world, port)
    meshes = {}
    for _, _, shape in FA_RUNS.values():
        if shape not in meshes:
            meshes[shape] = RankMesh(init_device_mesh(
                "cuda", shape, mesh_dim_names=("data", "model")))
    res = {}
    try:
        for run in FA_RUNS:
            rm = meshes[FA_RUNS[run][2]]
            comm = Comm(rm)
            exp = torch.load(Path(out) / f"fa_exp_{run}.pt")
            prompts = rank_rows(exp["prompts"].to(dev), rm)
            toks = rank_rows(exp["toks"].to(dev), rm)
            for dtype in FA_DTYPES:
                cfg = fa_cfg(run, dtype)
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                params = fa_params(M.init_local_params(
                    0, fa_cfg(run), param_specs(M.param_shapes(cfg), cfg,
                                                rm), rm, dev), dtype)
                torch.cuda.synchronize()
                t_init = time.perf_counter() - t0
                stubs = {k: rank_rows(v, rm) for k, v in
                         family_stubs(cfg, FA_B, dev).items()}
                _zero_counts()
                t0 = time.perf_counter()
                lg, cache = fa_serve_logits(params, cfg, prompts, toks,
                                            stubs, rm, comm)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                kv = [c["mixer"]["k"].shape[2] for c in
                      cache.get("layers", []) + cache.get("tail", [])
                      if "k" in c["mixer"]]
                for c in cache.get("groups", []):
                    if "k" in c["mixer"]:
                        kv.append(c["mixer"]["k"].shape[3])
                res[f"{run}/{dtype}"] = {
                    "launches": {k: v for k, v in _counts().items() if v},
                    "init_s": t_init, "serve_s": wall,
                    "kv_rows": sorted(set(kv)),
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "held_gb": sum(x.numel() * x.element_size()
                                   for x in _leaves(params)) / 1e9,
                    "staged": comm.staged_calls,
                    "coordinate": list(rm.mesh.get_coordinate())}
                if rm.index("model") == 0:
                    torch.save(lg.cpu(), Path(out) /
                               f"fa_rank_{run}_{dtype}_{rm.index('data')}.pt")
                del params, lg, cache
                torch.cuda.empty_cache()
        (Path(out) / f"fa_{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def fa_reference(dev, out: str, run: str) -> dict:
    """A run's one-process serve on this card: ``generate`` in bf16 on the
    kernel path (its launches counted); the same weights upcast to float32
    teacher-forced on its tokens, on the kernel path and on the plain path
    (the float32 run's noise); for RecurrentGemma on model 2 also the bf16
    requests through the mesh-taking steps on a 1 x 1 NCCL mesh, bit-equal
    to the one-process run. Saves prompts and tokens for the ranks ->
    {lk, lk32, lp32, toks, counts, nccl}."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core.prng import prng_key, randint_n
    from repro_torch.distributed.comm import Comm
    from repro_torch.distributed.sharding import RankMesh
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    cfg = fa_cfg(run)
    params = M.init_params(0, cfg, dev)
    prompts = randint_n(prng_key(25), FA_B * FA_S, 0, cfg.vocab,
                        dev).reshape(FA_B, FA_S)
    stubs = family_stubs(cfg, FA_B, dev)
    _zero_counts()
    with torch.inference_mode():
        toks, lk = generate(params, cfg, prompts, FA_GEN, **stubs)
    torch.cuda.synchronize()
    counts = {k: v for k, v in _counts().items() if v}
    nccl = None
    if run == "recurrentgemma_mp2":
        dist.init_process_group("nccl", init_method="tcp://localhost:"
                                f"{mm_free_port()}", rank=0, world_size=1)
        try:
            rm = RankMesh(init_device_mesh("cuda", (1, 1),
                                           mesh_dim_names=("data", "model")))
            comm = Comm(rm)
            with torch.inference_mode():
                toks_f, lk_f = generate(params, cfg, prompts, FA_GEN,
                                        mesh=rm, comm=comm, **stubs)
            torch.cuda.synchronize()
            require(torch.equal(toks_f, toks) and torch.equal(lk_f, lk),
                    "(25) the 1 x 1 NCCL mesh's tokens and logits bit-equal "
                    "to the one-process run")
            nccl = (f"1 x 1 NCCL mesh, {cfg.name} at {cfg.n_layers} layers "
                    f"through the mesh-taking prefill and decode steps: "
                    f"tokens and logits bit-equal to the one-process run; "
                    f"host-staged {comm.staged_calls}")
        finally:
            dist.destroy_process_group()
    cfg32 = fa_cfg(run, "float32")
    params = fa_params(params, "float32")
    with torch.inference_mode():
        lk32 = serve_logits(params, cfg32, prompts, toks, "auto", stubs)
        lp32 = serve_logits(params, cfg32, prompts, toks, "torch", stubs)
    torch.save({"prompts": prompts.cpu(), "toks": toks.cpu()},
               Path(out) / f"fa_exp_{run}.pt")
    del params, stubs
    torch.cuda.empty_cache()
    return {"lk": lk, "lk32": lk32, "lp32": lp32, "toks": toks,
            "counts": counts, "nccl": nccl}


def fa_kernel_times(dev, flush) -> dict:
    """K5's rank-partial mode and its merge, K6 and K7 at phase 25's
    per-rank shapes, host hidden, beside their plain versions, bounds and
    the nearest library call: the partial over a rank's 1,024 rows of
    RecurrentGemma's 2,048-row ring (8 requests, 10 heads on one KV head of
    256, bf16; SDPA over the same rows, which returns no (m, l)), the merge
    of 2 ranks' triples, K6 on the 3 query heads a rank attends with at
    model 4 (1 request of 2,048 tokens, head 256: the tensor-core kernel,
    its TFLOP/s logged), K7 on
    RWKV6-1.6B's 16 heads a rank at model 2 (1 request of 2,048 tokens)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.swa import (attn_decode_merge_cuda,
                                         attn_decode_merge_ref,
                                         attn_decode_partial_cuda,
                                         attn_decode_partial_ref,
                                         swa_prefill_cuda, swa_prefill_ref)
    from repro_torch.kernels.wkv6 import wkv6_chunked_ref, wkv6_cuda
    from repro_torch.kernels.wkv6.ops import group_chunks
    g = torch.Generator(device=dev).manual_seed(31)
    bf = torch.bfloat16
    out = {}
    B, H, dh, Wb = K5P_B, K5P_H, K5P_DH, K5P_WC // 2
    q = torch.randn((B, H, dh), generator=g, device=dev).to(bf)
    k, v = (torch.randn((B, 1, Wb, dh), generator=g, device=dev).to(bf)
            for _ in range(2))
    L = torch.full((B,), Wb, dtype=torch.int32, device=dev)
    acc, m, l = attn_decode_partial_cuda(q, k, v, L)
    ms = event_ms(lambda: attn_decode_partial_cuda(q, k, v, L), TIMED_RUNS,
                  flush, True)
    plain = event_ms(lambda: attn_decode_partial_ref(q, k, v, L), TIMED_RUNS,
                     flush, True)
    lib = event_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], k, v, enable_gqa=True), TIMED_RUNS, flush, True)
    b, by = bound(nbytes(q, k, v, L, acc, m, l), 4 * B * H * Wb * dh,
                  hw().peak_flops)
    out["k5_partial"] = {"shape": [B, H, 1, Wb, dh], "ms": ms,
                         "plain_ms": plain, "bound_ms": b, "bound_by": by,
                         "library_ms": lib}
    parts = [t[None].expand(2, *t.shape).contiguous() for t in (acc, m, l)]
    o = attn_decode_merge_cuda(*parts, bf)
    ms = event_ms(lambda: attn_decode_merge_cuda(*parts, bf), TIMED_RUNS,
                  flush, True)
    plain = event_ms(lambda: attn_decode_merge_ref(*parts, bf), TIMED_RUNS,
                     flush, True)
    b, by = bound(nbytes(*parts, o), 4 * 2 * B * H * dh)
    out["k5_merge"] = {"shape": [2, B, H, dh], "ms": ms, "plain_ms": plain,
                       "bound_ms": b, "bound_by": by, "library_ms": None}
    S, Hq = FA_S, 3
    q6 = torch.randn((1, S, Hq, dh), generator=g, device=dev).to(bf)
    k6, v6 = (torch.randn((1, S, 1, dh), generator=g, device=dev).to(bf)
              for _ in range(2))
    o6 = swa_prefill_cuda(q6, k6, v6, 2048)
    tr = (0, 2, 1, 3)
    ms = event_ms(lambda: swa_prefill_cuda(q6, k6, v6, 2048), 5, flush, True)
    plain = event_ms(lambda: swa_prefill_ref(q6, k6, v6, 2048), 3, flush)
    lib = event_ms(lambda: F.scaled_dot_product_attention(
        q6.permute(tr), k6.permute(tr), v6.permute(tr), is_causal=True,
        enable_gqa=True), 5, flush, True)
    b, by = bound(nbytes(q6, k6, v6, o6), 4 * dh * Hq * (S * (S + 1) // 2),
                  hw().peak_flops)
    out["k6_gathered"] = {"shape": [1, S, Hq, 1, dh], "ms": ms,
                          "plain_ms": plain, "bound_ms": b, "bound_by": by,
                          "library_ms": lib,
                          "tflops": 4 * dh * Hq * (S * (S + 1) // 2) / ms
                          / 1e9}
    H7, T = 16, FA_S
    # the model's layout: (1, H, T, 64) views of (1, T, H, 64) projections
    r7, k7, v7, lw, u = wkv_inputs(g, H7, T, bf, "model", dev)

    def heads(a):
        return a.view(1, T, H7, WKV_HEAD).transpose(1, 2)

    uh = u.view(1, H7, WKV_HEAD)
    y7, s7 = wkv6_cuda(heads(r7), heads(k7), heads(v7), heads(lw), uh)
    ms = event_ms(lambda: wkv6_cuda(heads(r7), heads(k7), heads(v7),
                                    heads(lw), uh), 5, flush, True)
    plain = event_ms(lambda: wkv6_chunked_ref(r7, k7, v7, lw, u, chunk=64),
                     2, flush)
    tc7, fma7 = wkv_ops(H7, T, group_chunks(
        H7, T, torch.cuda.get_device_properties(dev).multi_processor_count))
    ops_ms = (tc7 / hw().peak_flops + fma7 / hw().fp32_flops) * 1e3
    bytes_ms = (nbytes(r7, k7, v7, lw, y7, s7) + H7 * WKV_HEAD * 4) \
        / hw().hbm_bw * 1e3
    b, by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    out["k7_local"] = {"shape": [1, H7, T, WKV_HEAD], "ms": ms,
                       "plain_ms": plain,
                       "bound_ms": b, "bound_by": by, "library_ms": None}
    for tag, t in out.items():
        log(f"[timing] (25) {tag} at {t['shape']}: {t['ms']:.5f} ms with the "
            f"host hidden" + (f" = {t['tflops']:.1f} TFLOP/s" if "tflops" in t
                              else "")
            + f", plain {t['plain_ms']:.5f}, library {t['library_ms']}, "
            f"bound {t['bound_ms']:.5f} ({t['bound_by']})")
    del q, k, v, acc, m, l, parts, q6, k6, v6, r7, k7, v7, lw, u, y7, s7
    torch.cuda.empty_cache()
    return out


def fa_hold_bf16(tag: str, lr, lk, l32) -> None:
    """Phase 9's rule for a bf16 rank path ``lr``: its gaps to the float32
    path ``l32`` within twice the rms and four times the max of the
    one-process bf16 kernel path's ``lk`` (+ 1e-3 of the logits' rms, + one
    bf16 ulp of the largest), and its greedy choices equal to the
    one-process ones where ``lk``'s top-2 margin exceeds twice the largest
    gap between the two, on at least ``FA_MIN_CLEAR["bfloat16"]`` of the
    positions."""
    import torch
    mk, rk = logit_gaps(lr, l32)
    mp, rp = logit_gaps(lk, l32)
    mf = l32.float().abs().max().item()
    rf = l32.float().pow(2).mean().sqrt().item()
    gap = logit_gaps(lr, lk)[0]
    top2 = lk.float().topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * gap
    agree = torch.equal(lr.argmax(-1)[clear], lk.argmax(-1)[clear])
    share = clear.float().mean().item()
    log(f"{tag}: against the one-process float32 path (|logit| up to "
        f"{mf:.3f}, rms {rf:.4f}): rank path max {mk:.4e} rms {rk:.4e}; "
        f"one-process bf16 kernel path (the noise) max {mp:.4e} rms "
        f"{rp:.4e}; greedy choice = the one-process bf16 choice on "
        f"{int(clear.sum())}/{clear.numel()} positions whose top-2 margin "
        f"exceeds {2 * gap:.3e}: {agree}")
    require(rk <= 2 * rp + 1e-3 * rf, f"{tag} rank-path logit rms gap")
    require(mk <= 4 * mp + 2 ** -7 * mf, f"{tag} rank-path logit max gap")
    require(agree, f"{tag} greedy choices agree where the margin is clear")
    require(share >= FA_MIN_CLEAR["bfloat16"],
            f"{tag} a clear top-2 margin on at least "
            f"{FA_MIN_CLEAR['bfloat16']} of the positions")


def family_axis_phase(dev, flush) -> dict:
    """Phase 25 -> the kernels line's figures: the rank-partial K5's and
    its merge's times, launches on the ranks by run, and K5, K6 and K7's
    local-head times and launches.

    Each run's float32 rank path is held within :data:`FA_FP32_TOL` of the
    one-process float32 kernel path: that bound sees any error of the
    rank layouts. Its bf16 rank path is held by :func:`fa_hold_bf16`:
    against the one-process float32 path, with the one-process bf16
    kernel path as the noise, so that no part of the noise comes from the
    rank code, and greedy against the one-process bf16 choices.
    The one-process bf16 plain path is no measure of that noise: it runs
    the same GEMMs as its kernel path and differs only in the attention
    layers, while the ranks' row-split GEMMs round each block's product to
    bf16 before the sum."""
    import tempfile

    import torch
    fig = {"times": fa_kernel_times(dev, flush), "runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ref = {run: fa_reference(dev, tmp, run) for run in FA_RUNS}
        log(f"[axis] one-process runs ({len(FA_RUNS)}, bf16 and float32): "
            f"{time.perf_counter() - t0:.1f} s; "
            f"{ref['recurrentgemma_mp2']['nccl']}")
        t0 = time.perf_counter()
        codes = mm_join(mm_spawn(fa_rank, FA_WORLD, tmp), 400)
        require(codes == [0] * FA_WORLD, f"(25) {FA_WORLD} gloo ranks ran "
                f"to their end (exit codes {codes})")
        rows = [json.loads((Path(tmp) / f"fa_{r}.json").read_text())
                for r in range(FA_WORLD)]
        log(f"[axis] {FA_WORLD} gloo ranks: {time.perf_counter() - t0:.1f} s")
        for run, (arch, layers, shape) in FA_RUNS.items():
            r = ref[run]
            lk, lk32, lp32, toks = r["lk"], r["lk32"], r["lp32"], r["toks"]
            for dtype in FA_DTYPES:
                cfg = fa_cfg(run, dtype)
                key = f"{run}/{dtype}"
                tag = f"[axis] {run} {dtype}"
                lr = torch.cat([torch.load(
                    Path(tmp) / f"fa_rank_{run}_{dtype}_{d}.pt")
                    for d in range(shape[0])]).to(dev)
                nA = attn_layers(cfg)
                steps = FA_GEN - 1
                for row in rows:
                    ln = row[key]["launches"]
                    if cfg.family == "ssm":
                        want = {"wkv6": layers}
                    elif cfg.n_kv_heads % shape[1]:      # a ring over rows
                        want = {"swa_prefill": nA,
                                "attn_decode_partial": nA * steps,
                                "attn_decode_merge": nA * steps}
                    else:                                # local KV heads
                        want = {"swa_prefill": nA, "attn_decode": nA * steps}
                    require(all(ln.get(k, 0) == n for k, n in want.items())
                            and ln.get("attn_decode", 0) == want.get(
                                "attn_decode", 0)
                            and ln.get("attn_decode_partial", 0) == want.get(
                                "attn_decode_partial", 0),
                            f"(25) {key}: every rank launched {want} (got "
                            f"{ln})")
                    require(row[key]["staged"] == 0,
                            f"(25) {key}: nothing staged through host memory")
                ranks = [row[key] for row in rows]
                log(f"{tag}: {cfg.name} at {cfg.n_layers} layers, (data, "
                    f"model) {shape} on {FA_WORLD} gloo ranks, {FA_B} x "
                    f"{FA_S} prompt tokens, {FA_GEN} tokens teacher-forced: "
                    f"K/V rows a rank {ranks[0]['kv_rows']}; rank launches "
                    f"{[x['launches'] for x in ranks]} (one process bf16 "
                    f"{r['counts']}); init "
                    f"{[round(x['init_s'], 2) for x in ranks]} s, serve "
                    f"{[round(x['serve_s'], 2) for x in ranks]} s; held "
                    f"{[round(x['held_gb'], 3) for x in ranks]} GB, peaks "
                    f"{[round(x['peak_gb'], 3) for x in ranks]} GB")
                if cfg.family == "hybrid":
                    require(ranks[0]["kv_rows"] == [2048 // shape[1]],
                            f"(25) {key}: each rank holds its block of the "
                            f"2,048-row ring")
                if dtype == "float32":
                    hold_logits(tag, "rank path against the one-process "
                                "float32 kernel path (its plain path as the "
                                "noise)", lr.argmax(-1), lr, lp32, lk32,
                                FA_MIN_CLEAR[dtype])
                    gap = logit_gaps(lr, lk32)
                    require(torch.allclose(lr, lk32, atol=FA_FP32_TOL,
                                           rtol=FA_FP32_TOL),
                            f"(25) {key}: within {FA_FP32_TOL} of the "
                            f"one-process float32 kernel path")
                else:
                    fa_hold_bf16(tag, lr, lk, lk32)
                    gap = logit_gaps(lr, lk)
                same = (lr.argmax(-1) == toks).float().mean().item()
                log(f"{tag}: against the one-process {dtype} kernel path "
                    f"max {gap[0]:.4e} rms {gap[1]:.4e}; the rank path's "
                    f"greedy choice is the one-process bf16 token at "
                    f"{same:.3f} of the positions")
                fig["runs"][key] = {
                    "launches": ranks[0]["launches"],
                    "serve_s": max(x["serve_s"] for x in ranks),
                    "logit_gap": gap[0], "greedy_same": same}
                del lr
            del lk, lk32, lp32
        torch.cuda.empty_cache()
    return fig



# ---------------------------------------------------------------------------
# Phase 26: the families trained over model ranks, and the FSDP mean step
# ---------------------------------------------------------------------------

#: phase 26's runs: run -> (arch, layers (None: full depth), mesh (data,
#: model), dtypes, fsdp, global batch, tokens a row, lr). Published
#: widths, depth cut so that the four ranks' bytes stay under ~70 GB of
#: the card (``tx_reckon``), and in tokens: every rank gathers the whole
#: (rows, tokens, vocabulary) float32 logits for the loss (RecurrentGemma's
#: 256,000 columns: 3.9 GB at 4 x 1,024 tokens on model 4, several times
#: that in its backward; two probe runs ran out of the card's memory at 4 x
#: 1,024 and 2 x 1,024), so RecurrentGemma takes 2 x 512 tokens, Qwen3-8B
#: 2 x 1,024 and InternVL2-26B 2 x (256 patches + 768); bf16 weights,
#: float32 the same weights upcast. The script's time limit leaves float32
#: to RWKV6, RecurrentGemma on model 4 and the 2-layer FSDP Qwen3-8B, whose
#: first-step gradients are held block by block (the reduce-scatter's
#: sums and rows); the CPU tests hold the other layouts in float32.
#: RecurrentGemma on data 2 x model 2 runs the robust step
#: (:data:`TX_ROBUST`). InternVL2 fits four ranks only under FSDP (its
#: whole 92,553-row embedding and head are on every rank without it).
#: The mean step without FSDP runs on the other families; an FSDP run's
#: blocks are held below the whole blocks its mesh would give a rank
TX_RUNS = {
    "rwkv6": ("rwkv6_1b6", 2, (2, 2), ("bfloat16", "float32"), False, 4,
              1024, 3e-4),
    "recurrentgemma_mp4": ("recurrentgemma_2b", 3, (1, 4),
                           ("bfloat16", "float32"), False, 2, 512, 3e-4),
    "recurrentgemma_mp2": ("recurrentgemma_2b", 3, (2, 2), (), False, 2,
                           512, 3e-4),
    "whisper": ("whisper_small", None, (2, 2), ("bfloat16",), False, 4, 448,
                3e-4),
    "internvl2_fsdp": ("internvl2_26b", 2, (2, 2), ("bfloat16",), True, 2,
                       768, 3e-5),
    "qwen3_fsdp": ("qwen3_8b", 2, (2, 2), ("bfloat16", "float32"), True, 2,
                   1024, 3e-4),
}
#: the robust rank step: RecurrentGemma on (data 2 x model 2), one bf16
#: trimmed_mean step of its 2 workers (F 0: K4 on the rank's block). Its
#: aggregate is held against the float32 mean gradient (F 0 over two
#: workers of one row each is the mean): its block's rms gap at most twice
#: the one-process bf16 robust step's whole one; its parameters against
#: the first AdamW
#: step worked out from the rank's own aggregate g, -lr (g s / (|g| s +
#: eps) + wd p) with s the clip scale, within one bf16 ulp
#: (``tx_robust_hold``)
TX_ROBUST = "recurrentgemma_mp2"
TX_STEPS, TX_WORLD = 2, 4     # 3 in development runs (the time limit)
TX_FP32_LOSS, TX_GRAD_RTOL, TX_BF16_LOSS = 1e-4, 2e-5, 1e-2
#: the float32 gradient hold: leaf i within TX_GRAD_RTOL of its scale plus
#: twice its own float32 noise (``tx_noise``, the largest over TX_NUDGES
#: seeded draws)
TX_NUDGES = 4
TX_BUDGET_GB = 70.0


def tx_cfg(run: str, dtype: str = "bfloat16"):
    import dataclasses
    from repro_torch.configs import get_config
    arch, layers = TX_RUNS[run][:2]
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return dataclasses.replace(cfg, dtype=dtype)


def tx_tc(run: str, dtype: str, agg: str = "mean"):
    import dataclasses
    from repro_torch.distributed.aggregation import AggregatorConfig
    from repro_torch.distributed.trainer import TrainConfig
    from repro_torch.optim import AdamWConfig
    lr = TX_RUNS[run][7]
    tc = TrainConfig(arch=tx_cfg(run, dtype), fsdp=TX_RUNS[run][4],
                     opt=AdamWConfig(lr=lr, warmup_steps=1,
                                     total_steps=TX_STEPS),
                     agg=AggregatorConfig(kind=agg, F=0))
    return tc if agg == "mean" else dataclasses.replace(tc, fsdp=False)


def tx_data(run: str, dev):
    """A run's data and stubs (global batch; each rank takes its rows)."""
    from repro_torch.data import SyntheticLMData
    cfg = tx_cfg(run)
    B, S = TX_RUNS[run][5:7]
    return (SyntheticLMData(cfg.vocab, S, B, seed=0),
            family_stubs(cfg, B, dev))


def tx_specs(cfg, mesh_shape: tuple, fsdp: bool):
    """The spec tree of a (data, model) mesh of ``mesh_shape`` (a stand-in:
    the rules read only the names and extents)."""
    from repro_torch.distributed.sharding import param_specs
    from repro_torch.models import model as M

    class Extents:
        axis_names = ("data", "model")
        shape = dict(zip(axis_names, mesh_shape))

    return param_specs(M.param_shapes(cfg), cfg, Extents(), fsdp=fsdp)


def tx_block_gb(cfg, mesh_shape: tuple, fsdp: bool) -> float:
    """A rank's parameters and AdamW moments (float32) from its spec
    blocks, GB."""
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import leaves
    sizes = dict(zip(("data", "model"), mesh_shape))
    total = 0
    for leaf, spec in zip(leaves(M.param_shapes(cfg)),
                          tx_spec_leaves(tx_specs(cfg, mesh_shape, fsdp))):
        n = leaf.numel()
        for e in spec:
            for a in (e if isinstance(e, tuple) else (e,)):
                n //= sizes.get(a, 1) if a is not None else 1
        total += n * (leaf.element_size() + 8)
    return total / 1e9


def tx_spec_leaves(specs):
    """The spec tuples of a spec tree in ``leaves`` order (keys sorted)."""
    if isinstance(specs, dict):
        for k in sorted(specs):
            yield from tx_spec_leaves(specs[k])
    elif isinstance(specs, list):
        for v in specs:
            yield from tx_spec_leaves(v)
    else:
        yield specs


def tx_reckon(run: str, dtype: str) -> dict:
    """A rank's bytes before the run: its blocks' parameters and moments,
    and ``train_memory_gb``'s model (params + optimizer, and its total)
    beside them; with and without FSDP."""
    from repro_torch.analysis.memory_model import train_memory_gb
    from repro_torch.configs.base import InputShape
    cfg = tx_cfg(run, dtype)
    shape, B, S = TX_RUNS[run][2], TX_RUNS[run][5], TX_RUNS[run][6]
    out = {}
    for fsdp in (False, True):
        m = train_memory_gb(cfg, InputShape("train", S, B, "train"),
                            dict(zip(("data", "model"), shape)), fsdp, 1)
        out["fsdp" if fsdp else "whole"] = {
            "blocks_gb": tx_block_gb(cfg, shape, fsdp),
            "model_params_optimizer_gb": m["params_gb"] + m["optimizer_gb"],
            "model_total_gb": m["total_gb"]}
    return out


def tx_rank(rank: int, world: int, port: int, out: str) -> None:
    """Phase 26: rank ``rank`` of 4 gloo ranks on this card, training each
    of :data:`TX_RUNS` on its mesh for :data:`TX_STEPS` mean steps through
    ``make_train_step(mesh=)`` on its blocks of the one-process weights
    (``init_local_params``, FSDP's blocks where the run says so), then
    :data:`TX_ROBUST`'s robust step; K4, K6 and K7 counted from 0 around
    each run; the first step's float32 gradients held, block by block,
    against the one-process float32 run's (saved by the parent)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.comm import Comm
    from repro_torch.distributed.sharding import (RankMesh, local_block,
                                                  param_specs)
    from repro_torch.distributed.trainer import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import leaves
    # four ranks' caching allocators share the card: segments that grow
    # in place keep each rank's unused reserve small
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    dev = mm_init(rank, world, port)
    meshes = {}
    for run in TX_RUNS.values():
        if run[2] not in meshes:
            meshes[run[2]] = RankMesh(init_device_mesh(
                "cuda", run[2], mesh_dim_names=("data", "model")))
    res = {}

    def one_run(run, dtype, agg="mean"):
        rm = meshes[TX_RUNS[run][2]]
        comm = Comm(rm)
        tc = tx_tc(run, dtype, agg)
        cfg = tc.arch
        specs = param_specs(M.param_shapes(cfg), cfg, rm, fsdp=tc.fsdp)
        torch.cuda.reset_peak_memory_stats()
        params = fa_params(M.init_local_params(0, tx_cfg(run), specs, rm,
                                               dev), dtype)
        opt = adamw_init(params)
        held = sum(x.numel() * x.element_size() for x in
                   [*leaves(params), *leaves(opt["m"]), *leaves(opt["v"])])
        fp32 = dtype == "float32" and agg == "mean"
        robust = agg != "mean"
        step = make_train_step(tc, mesh=rm, comm=comm,
                               record="aggregate" if robust else fp32)
        data, stubs = tx_data(run, dev)
        grads0, walls = [], []
        start = [p.clone() for p in leaves(params)] if robust else None
        t0 = [time.perf_counter()]

        def keep(s, st):
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0[0])
            if s == 0 and fp32:
                grads0.extend(st.grads)
            if s == 0 and robust:
                grads0.append(st.aggregate)
            t0[0] = time.perf_counter()

        _zero_counts()
        losses = run_steps(step, params, opt, data,
                           1 if agg != "mean" else TX_STEPS, dev,
                           robust=agg != "mean", on_step=keep,
                           stubs={k: v for k, v in stubs.items()})
        counts = {k: v for k, v in _counts().items() if v}
        row = {"losses": losses, "launches": counts, "walls": walls,
               "held_gb": held / 1e9,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "staged": [comm.staged_calls, comm.staged_bytes],
               "coordinate": list(rm.mesh.get_coordinate())}
        if fp32:
            exp = torch.load(tx_grads_path(out, run), mmap=True)
            # leaf by leaf: the gap and the leaf's own float32 noise,
            # relative to its scale (leaves in ``leaves`` order)
            per = []
            for i, (g, full, sc, nz, spec) in enumerate(zip(
                    grads0, exp["grads"], exp["scales"], exp["noise"],
                    tx_spec_leaves(specs))):
                gap = float((g.float() - local_block(full, spec, rm).to(dev)
                             .float()).abs().max())
                per.append((gap / max(sc, 1e-30), nz / max(sc, 1e-30), i))
            # beyond twice the leaf's noise: two paths' roundings
            row["grad_rel_gap"] = max(0.0, max(g - 2 * n for g, n, _ in per))
            row["grad_leaf_max"] = max(per)
            row["grad_leaves"] = sorted(per, key=lambda t: 2 * t[1] - t[0]
                                        )[:3]
        if robust:
            agg = grads0.pop()
            opt = step = None     # the moments' bytes, for the hold's own
            gc.collect()
            torch.cuda.empty_cache()
            row.update(tx_robust_hold(out, run, tc, specs, rm, start,
                                      leaves(params), agg, dev))
            del agg
        del params, opt, step, grads0, start
        gc.collect()     # a recording step holds itself (``step.grads``)
        torch.cuda.empty_cache()
        # gloo stages CUDA tensors through pinned host blocks, which the
        # host allocator keeps: four ranks' caches and the parent's files
        # share the machine's 96 GiB
        row["pinned_gb"] = torch.cuda.memory.host_memory_stats().get(
            "allocated_bytes.current", 0) / 1e9
        empty_host = getattr(torch._C, "_host_emptyCache", None)
        if empty_host is not None:
            empty_host()
        return row

    try:
        # the robust step first, before the mean runs' gathers fill the
        # pinned host caches
        res["robust"] = one_run(TX_ROBUST, "bfloat16", "trimmed_mean")
        for run, (_, _, _, dtypes, *_rest) in TX_RUNS.items():
            for dtype in dtypes:
                t0 = time.perf_counter()
                res[f"{run}/{dtype}"] = one_run(run, dtype)
                res[f"{run}/{dtype}"]["run_s"] = time.perf_counter() - t0
                if rank == 0:
                    log(f"[axis-train] rank 0: {run} {dtype} in "
                        f"{time.perf_counter() - t0:.1f} s, peak "
                        f"{res[f'{run}/{dtype}']['peak_gb']:.3f} GB, pinned "
                        f"host {res[f'{run}/{dtype}']['pinned_gb']:.3f} GB")
        (Path(out) / f"tx_{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def tx_robust_hold(out: str, run: str, tc, specs, rm, start: list,
                   params: list, agg, dev) -> dict:
    """:data:`TX_ROBUST`'s readings on a rank after its step: its aggregate
    block's relative rms gap to the float32 mean gradient's block; how far
    its parameters lie past the first AdamW step worked out from its own
    aggregate (``start`` the parameters before the step)."""
    import torch
    from repro_torch.distributed.sharding import local_block
    from repro_torch.optim.adamw import cosine_lr
    exp = torch.load(tx_grads_path(out, run), mmap=True)
    opt = tc.opt
    lr = float(cosine_lr(opt, torch.ones((), dtype=torch.int32)))
    scale = min(1.0, opt.clip_norm / max(exp["norm"], 1e-9))
    sq = {"rank": 0.0, "f32": 0.0}
    worst, off, chunk = 0.0, 0, 1 << 25
    for p0, p1, spec, f32 in zip(start, params, tx_spec_leaves(specs),
                                 exp["grads"]):
        n = p1.numel()
        decay = p0.dim() >= 2
        t_all = local_block(f32, spec, rm).reshape(-1)
        for i in range(0, n, chunk):      # float32 temporaries a chunk's
            j = min(n, i + chunk)
            g = agg[off + i:off + j]
            t = t_all[i:j].to(dev).float()
            sq["rank"] += float((g - t).square().sum())
            sq["f32"] += float(t.square().sum())
            g = g.to(p1.dtype).float()      # what the step hands AdamW
            # the first step: m^ = g s, v^ = (g s)^2, so the step is
            # -lr (g s / (|g| s + eps) + wd p) in float32, rounded to bf16
            gs = g * scale
            pf = p0.reshape(-1)[i:j].float()
            delta = gs / (gs.abs() + opt.eps)
            if decay:
                delta = delta + opt.weight_decay * pf
            want = (pf - lr * delta).to(p1.dtype).float()
            # one bf16 ulp of the result (2^-7 of it bounds the ulp), and
            # lr x 1e-2: the clip scale comes from the float32 gradient's
            # norm, a few 1e-3 from the bf16 aggregate's, which moves the
            # step's direction by a quarter of that at most
            bound = 2.0 ** -7 * want.abs() + lr * 1e-2
            got = p1.reshape(-1)[i:j].float()
            worst = max(worst, float(((got - want).abs() - bound).max()))
            del g, t, gs, pf, delta, want, bound, got
        off += n
    return {"agg_rms_gap": (sq["rank"] / max(sq["f32"], 1e-30)) ** 0.5,
            "update_over": worst}


def tx_grads_path(out: str, run: str) -> Path:
    arch, layers = TX_RUNS[run][:2]
    return Path(out) / f"tx_grads_{arch}_{layers}.pt"


def tx_reference(dev, out: str, run: str) -> dict:
    """The one-process steps of a run's model (the runs of one model and
    depth share them) on this card, on the same weights and batches: bf16
    on the kernel path (and for Qwen3-8B at 4 layers on a 1 x 1 NCCL mesh
    through the mesh-taking FSDP step, bit-equal to it), float32 (the
    weights upcast) on the kernel path; the float32 first step's
    gradients saved for the ranks -> {dtype: losses}."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.comm import Comm
    from repro_torch.distributed.sharding import RankMesh
    from repro_torch.distributed.trainer import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    data, stubs = tx_data(run, dev)
    out_l = {}
    twins = [r for r in TX_RUNS if TX_RUNS[r][:2] == TX_RUNS[run][:2]]
    dtypes = {d for r in twins for d in TX_RUNS[r][3]}
    for dtype in ("bfloat16", "float32"):
        if dtype not in dtypes and dtype == "bfloat16":
            continue            # a float32 run needs no bf16 reference
        tc = tx_tc(run, dtype)
        params = fa_params(M.init_params(0, tx_cfg(run), dev), dtype)
        opt = adamw_init(params)
        save = dtype in dtypes and dtype == "float32"
        step = make_train_step(tc, record=save)
        grads0 = []

        def keep(s, st):
            if s == 0 and save:
                grads0.extend(g.detach() for g in st.grads)

        _zero_counts()
        out_l[dtype] = run_steps(step, params, opt, data, TX_STEPS, dev,
                                 robust=False, on_step=keep, stubs=stubs)
        out_l[f"{dtype}_launches"] = {k: v for k, v in _counts().items()
                                      if v}
        if save:
            exp = {"grads": [g.cpu() for g in grads0],
                   "scales": [float(g.float().abs().max()) for g in grads0],
                   "norm": float(sum(g.float().square().sum()
                                     for g in grads0)) ** 0.5}
            exp["noise"] = tx_noise(run, data, stubs, grads0, dev)
            torch.save(exp, tx_grads_path(out, run))
        del params, opt, step, grads0
        gc.collect()     # a recording step holds itself (``step.grads``)
        torch.cuda.empty_cache()
    if "qwen3_fsdp" in twins:
        dist.init_process_group("nccl", init_method="tcp://localhost:"
                                f"{mm_free_port()}", rank=0, world_size=1)
        try:
            rm = RankMesh(init_device_mesh("cuda", (1, 1),
                                           mesh_dim_names=("data", "model")))
            comm = Comm(rm)
            params = M.init_params(0, tx_cfg(run), dev)
            opt = adamw_init(params)
            step = make_train_step(tx_tc("qwen3_fsdp", "bfloat16"), mesh=rm,
                                   comm=comm)
            got = run_steps(step, params, opt, data, TX_STEPS, dev,
                            robust=False, stubs=stubs)
            require(got == out_l["bfloat16"],
                    "(26) the 1 x 1 NCCL mesh's FSDP mean steps give the "
                    "one-process losses bit for bit")
            out_l["nccl"] = (f"1 x 1 NCCL mesh, {tx_cfg(run).name} at "
                             f"{tx_cfg(run).n_layers} layers, fsdp=True "
                             f"through the mesh-taking mean step: losses "
                             f"{got} bit-equal to the one-process run; "
                             f"host-staged {comm.staged_calls}")
            del params, opt, step
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    return out_l


def tx_noise(run: str, data, stubs, grads0: list, dev) -> list:
    """The float32 noise of a run's first-step gradients, leaf by leaf:
    the largest gap, over :data:`TX_NUDGES` seeded draws, between
    ``grads0`` (the one-process float32 kernel path) and the same step on
    the same weights each scaled by 1 +- 2^-22 (a few float32 ulps, a
    seeded sign an element): how far float32 rounding of the step's
    inputs moves its gradients. The rank path rounds its column-block
    products otherwise; RWKV6's chunked scan amplifies such roundings
    (its one-process gradients sit up to 1e-4 of a leaf's scale from a
    float64 run at reduced size), the other families' barely."""
    import torch
    from repro_torch.distributed.trainer import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    g = torch.Generator(device=dev).manual_seed(26)

    def nudge(t):
        if not t.is_floating_point():
            return t
        sign = torch.randint(0, 2, t.shape, generator=g, device=dev) * 2 - 1
        return t * (1 + sign.to(t.dtype) * 2.0 ** -22)

    gap = [0.0] * len(grads0)
    batch = {**data.batch(0, dev), **stubs}
    base = fa_params(M.init_params(0, tx_cfg(run), dev), "float32")
    step = make_train_step(tx_tc(run, "float32"), record=True)
    for _ in range(TX_NUDGES):
        params = M._tmap(nudge, base)
        step(params, adamw_init(params), batch)
        gap = [max(m, float((p.float() - k.float()).abs().max()))
               for m, p, k in zip(gap, step.grads, grads0)]
        del params
    del base, step
    gc.collect()
    torch.cuda.empty_cache()
    return gap


def tx_robust_reference(dev, out: str) -> list:
    """:data:`TX_ROBUST`'s one-process robust step on its 2 workers
    (``WorkerLayout(1, 2)``, stacked copies) -> (the losses, its
    aggregate's relative rms gap to the float32 mean gradient (one row:
    the trimmed mean is every worker's))."""
    import torch
    from repro_torch.distributed.aggregation import WorkerLayout
    from repro_torch.distributed.trainer import (make_train_step,
                                                 replicate_for_workers,
                                                 worker_opt_init)
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import leaves
    data, stubs = tx_data(TX_ROBUST, dev)
    params = replicate_for_workers(M.init_params(0, tx_cfg(TX_ROBUST), dev),
                                   2)
    opt = worker_opt_init(params)
    step = make_train_step(tx_tc(TX_ROBUST, "bfloat16", "trimmed_mean"),
                           WorkerLayout(1, 2), record="aggregate")
    losses = run_steps(step, params, opt, data, 1, dev, stubs=stubs)
    exp = torch.load(tx_grads_path(out, TX_ROBUST), mmap=True)
    gap, ref, off = 0.0, 0.0, 0
    for p, f32 in zip(leaves(params), exp["grads"]):
        n = p[0].numel()
        t = f32.to(dev).float().reshape(-1)
        gap += float((step.aggregate[0, off:off + n] - t).square().sum())
        ref += float(t.square().sum())
        off += n
        del t
    del params, opt, step
    gc.collect()     # a recording step holds itself (``step.aggregate``)
    torch.cuda.empty_cache()
    return losses, (gap / max(ref, 1e-30)) ** 0.5


def tx_kernel_times(dev, flush) -> dict:
    """K6 at each new rank training shape (the heads a rank attends with,
    its rows of the batch), K7 on a rank's 16 RWKV6 heads at the training
    shape and K4 on the robust rank's (2, D) block, host hidden, beside
    their plain versions, bounds and (K6) SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.swa import swa_prefill_cuda, swa_prefill_ref
    from repro_torch.kernels.trimmed_mean import (trimmed_mean_cuda,
                                                  trimmed_mean_ref)
    from repro_torch.kernels.wkv6 import wkv6_chunked_ref, wkv6_cuda
    from repro_torch.kernels.wkv6.ops import group_chunks
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import leaves
    g = torch.Generator(device=dev).manual_seed(26)
    bf = torch.bfloat16
    out = {}
    # (tag, B a rank, S, query heads attended, KV heads, head size)
    k6 = (("recurrentgemma_mp4", 2, 512, 3, 1, 256),
          ("recurrentgemma_mp2", 1, 512, 5, 1, 256),
          ("whisper", 2, 448, 6, 6, 64),
          ("internvl2", 1, 1024, 24, 4, 128),
          ("qwen3", 1, 1024, 16, 4, 128))
    tr = (0, 2, 1, 3)
    for tag, B, S, H, Hkv, dh in k6:
        q = torch.randn((B, S, H, dh), generator=g, device=dev).to(bf)
        k, v = (torch.randn((B, S, Hkv, dh), generator=g, device=dev).to(bf)
                for _ in range(2))
        o = swa_prefill_cuda(q, k, v, S)
        ms = event_ms(lambda: swa_prefill_cuda(q, k, v, S), 5, flush, True)
        plain = event_ms(lambda: swa_prefill_ref(q, k, v, S), 3, flush)
        lib = event_ms(lambda: F.scaled_dot_product_attention(
            q.permute(tr), k.permute(tr), v.permute(tr), is_causal=True,
            enable_gqa=True), 5, flush, True)
        b, by = bound(nbytes(q, k, v, o),
                      4 * B * dh * H * (S * (S + 1) // 2), hw().peak_flops)
        out[f"k6_{tag}"] = {"shape": [B, S, H, Hkv, dh], "ms": ms,
                            "plain_ms": plain, "bound_ms": b, "bound_by": by,
                            "library_ms": lib,
                            "tflops": 4 * B * dh * H * (S * (S + 1) // 2)
                            / ms / 1e9}
        del q, k, v, o
    H7, T, B7 = 16, TX_RUNS["rwkv6"][6], TX_RUNS["rwkv6"][5] // 2
    r7, k7, v7, lw, u = wkv_inputs(g, B7 * H7, T, bf, "model", dev)

    def heads(a):
        return a.view(B7, T, H7, WKV_HEAD).transpose(1, 2)

    uh = u.view(B7, H7, WKV_HEAD)
    y7, s7 = wkv6_cuda(heads(r7), heads(k7), heads(v7), heads(lw), uh)
    ms = event_ms(lambda: wkv6_cuda(heads(r7), heads(k7), heads(v7),
                                    heads(lw), uh), 5, flush, True)
    plain = event_ms(lambda: wkv6_chunked_ref(r7, k7, v7, lw, u, chunk=64),
                     2, flush)
    tc7, fma7 = wkv_ops(B7 * H7, T, group_chunks(
        B7 * H7, T, torch.cuda.get_device_properties(dev).multi_processor_count))
    ops_ms = (tc7 / hw().peak_flops + fma7 / hw().fp32_flops) * 1e3
    bytes_ms = (nbytes(r7, k7, v7, lw, y7, s7) + B7 * H7 * WKV_HEAD * 4) \
        / hw().hbm_bw * 1e3
    b, by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    out["k7_rank_train"] = {"shape": [B7, H7, T, WKV_HEAD], "ms": ms,
                            "plain_ms": plain, "bound_ms": b, "bound_by": by,
                            "library_ms": None}
    del r7, k7, v7, lw, u, y7, s7
    cfg = tx_cfg(TX_ROBUST)
    D = sum(int(np.prod(t.shape)) // (2 if "model" in sp else 1)
            for t, sp in zip(leaves(M.param_shapes(cfg)),
                             tx_spec_leaves(tx_specs(cfg, (2, 2), False))))
    G = torch.randn((2, D), generator=g, device=dev)
    t4 = trimmed_mean_cuda(G, 0)
    err = (t4 - trimmed_mean_ref(G, 0)).abs().max().item()
    ms = event_ms(lambda: trimmed_mean_cuda(G, 0), 5, flush, True)
    plain = event_ms(lambda: trimmed_mean_ref(G, 0), 3, flush, True)
    lib = event_ms(lambda: G.mean(dim=0), 5, flush, True)
    b, by = bound(nbytes(G, t4), 2 * D)
    out["k4_rank_robust"] = {"shape": [2, D], "ms": ms, "plain_ms": plain,
                             "bound_ms": b, "bound_by": by,
                             "library_ms": lib, "max_abs_err": err}
    require(err == 0.0, f"(26) K4 at (2, {D}) F 0 equals its plain version")
    del G, t4
    torch.cuda.empty_cache()
    for tag, t in out.items():
        log(f"[timing] (26) {tag} at {t['shape']}: {t['ms']:.5f} ms with the "
            f"host hidden" + (f" = {t['tflops']:.1f} TFLOP/s" if "tflops" in t
                              else "")
            + f", plain {t['plain_ms']:.5f}, library {t['library_ms']}, "
            f"bound {t['bound_ms']:.5f} ({t['bound_by']})")
    return out


def tx_expected(run: str, dtype: str, agg: str = "mean") -> dict:
    """The launches a rank makes in a run: K6 once a causal attention
    layer in the forward and once in the remat (no backward kernel), K7
    the same for RWKV6, a step; K4 once a robust step."""
    cfg = tx_cfg(run, dtype)
    steps = TX_STEPS if agg == "mean" else 1
    per = 2 if cfg.remat else 1
    if cfg.family == "ssm":
        want = {"wkv6": per * cfg.n_layers * steps}
    else:
        want = {"swa_prefill": per * attn_layers(cfg) * steps}
    if agg != "mean":
        want["trimmed_mean"] = steps
    return want


def family_train_axis_phase(dev, flush) -> dict:
    """Phase 26 -> the kernels line's figures: K6, K7 and K4's launches a
    rank by run and their times at the new rank training shapes.

    Each run's float32 rank losses are held within :data:`TX_FP32_LOSS`
    (relative) of the one-process float32 kernel path on the same weights
    and batches, and the first step's gradients, block by block, leaf i
    within :data:`TX_GRAD_RTOL` of its scale beyond twice its own float32
    noise (:func:`tx_noise`; two paths' roundings). Its bf16 losses within
    :data:`TX_BF16_LOSS` of the one-process bf16 kernel path, with a gap
    to the one-process float32 path at most twice the one-process bf16
    path's (+ 1e-3); an FSDP run's blocks less than the whole blocks
    :func:`tx_reckon` gives a rank without FSDP; every rank the same
    losses. The robust step: its loss
    within :data:`TX_BF16_LOSS` of the one-process step's, its aggregate
    and its update as :data:`TX_ROBUST` says."""
    import tempfile

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    fig = {"times": tx_kernel_times(dev, flush), "runs": {}}
    fails = []

    def check(ok, what: str) -> None:
        """Every run's holds are read before the phase fails on any."""
        if not ok:
            log(f"[axis-train] FAILED: {what}")
            fails.append(what)
    for run, spec in TX_RUNS.items():
        for dtype in spec[3]:
            r = tx_reckon(run, dtype)
            fig["runs"][f"{run}/{dtype}/reckoned"] = r
            log(f"[axis-train] {run} {dtype}: a rank's parameters and "
                f"moments from its spec blocks {r['whole']['blocks_gb']:.3f}"
                f" GB without FSDP, {r['fsdp']['blocks_gb']:.3f} GB with; "
                f"train_memory_gb params + optimizer "
                f"{r['whole']['model_params_optimizer_gb']:.3f} / "
                f"{r['fsdp']['model_params_optimizer_gb']:.3f} GB, total "
                f"{r['whole']['model_total_gb']:.3f} / "
                f"{r['fsdp']['model_total_gb']:.3f} GB (x {TX_WORLD} "
                f"ranks: {TX_WORLD * r['fsdp' if spec[4] else 'whole']['model_total_gb']:.1f} GB "
                f"of the {TX_BUDGET_GB} GB budget)")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ref, model = {}, {}
        for run in TX_RUNS:     # one model's one-process runs are shared
            key = TX_RUNS[run][:2]
            if key not in model:
                model[key] = tx_reference(dev, tmp, run)
            ref[run] = model[key]
        rob, rob_gap = tx_robust_reference(dev, tmp)
        gc.collect()     # a recording step holds itself (``step.grads``)
        torch.cuda.empty_cache()
        log(f"[axis-train] one-process runs ({len(model)} models, bf16 and "
            f"float32, and the robust step): "
            f"{time.perf_counter() - t0:.1f} s; this process holds "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB, reserves "
            f"{torch.cuda.memory_reserved() / 1e9:.3f}; "
            f"{ref['qwen3_fsdp']['nccl']}")
        t0 = time.perf_counter()
        codes = mm_join(mm_spawn(tx_rank, TX_WORLD, tmp), 600)
        require(codes == [0] * TX_WORLD, f"(26) {TX_WORLD} gloo ranks ran "
                f"to their end (exit codes {codes})")
        rows = [json.loads((Path(tmp) / f"tx_{r}.json").read_text())
                for r in range(TX_WORLD)]
        log(f"[axis-train] {TX_WORLD} gloo ranks: "
            f"{time.perf_counter() - t0:.1f} s")
    for run, (arch, layers, shape, dtypes, fsdp, B, S, lr) in TX_RUNS.items():
        for dtype in dtypes:
            key = f"{run}/{dtype}"
            tag = f"[axis-train] {run} {dtype}"
            ranks = [row[key] for row in rows]
            want = tx_expected(run, dtype)
            for rk in ranks:
                check(all(rk["launches"].get(k, 0) == n
                            for k, n in want.items()),
                        f"(26) {key}: every rank launched {want} (got "
                        f"{rk['launches']})")
                check(rk["staged"] == [0, 0],
                        f"(26) {key}: nothing staged through host memory")
                check(rk["losses"] == ranks[0]["losses"],
                        f"(26) {key}: every rank reports the same losses")
            got = ranks[0]["losses"]
            lk, l32 = ref[run].get("bfloat16"), ref[run]["float32"]
            cfg = tx_cfg(run, dtype)
            peaks = [rk["peak_gb"] for rk in ranks]
            log(f"{tag}: {cfg.name} at {cfg.n_layers} layers, (data, model)"
                f" {shape}, fsdp={fsdp}, {B} x {S} tokens, {TX_STEPS} mean "
                f"steps: losses {got} (one process bf16 {lk}, float32 "
                f"{l32}); step walls {[round(w, 3) for w in ranks[0]['walls']]}"
                f" s; held {[round(rk['held_gb'], 3) for rk in ranks]} GB, "
                f"peaks {[round(p, 3) for p in peaks]} GB (sum "
                f"{sum(peaks):.1f}); host-staged {ranks[0]['staged']}; "
                f"launches a rank {ranks[0]['launches']} (one process "
                f"{ref[run][f'{dtype}_launches']})")
            check(sum(peaks) <= 80.0, f"(26) {key}: the ranks' peaks fit "
                    f"the card")
            if dtype == "float32":
                gap = max(abs(a - b) / abs(b) for a, b in zip(got, l32))
                gg = max(rk["grad_rel_gap"] for rk in ranks)
                worst = {}
                for rk in ranks:      # a leaf's worst block over the ranks
                    for t in rk["grad_leaves"]:
                        if t[2] not in worst or t[0] - 2 * t[1] > \
                                worst[t[2]][0] - 2 * worst[t[2]][1]:
                            worst[t[2]] = t
                near = sorted(worst.values(),
                              key=lambda t: 2 * t[1] - t[0])[:3]
                big = max(rk["grad_leaf_max"] for rk in ranks)
                log(f"{tag}: losses against the one-process float32 kernel "
                    f"path: relative gap {gap:.3e} (bound {TX_FP32_LOSS}); "
                    f"first-step gradients, block by block, within "
                    f"{gg:.3e} of each leaf's scale beyond twice the leaf's "
                    f"own float32 noise (bound {TX_GRAD_RTOL}); the leaves "
                    f"nearest their bounds (gap, noise, each relative to "
                    f"the leaf's scale; leaf): "
                    + ", ".join(f"({a:.3e}, {n:.3e}; {i})"
                                for a, n, i in near)
                    + f"; the largest gap ({big[0]:.3e}, {big[1]:.3e}; "
                    f"{big[2]})")
                check(gap <= TX_FP32_LOSS, f"(26) {key}: losses within "
                        f"{TX_FP32_LOSS} of the one-process float32 path")
                check(gg <= TX_GRAD_RTOL, f"(26) {key}: first-step "
                        f"gradients within {TX_GRAD_RTOL} of each scale")
            else:
                gap = max(abs(a - b) for a, b in zip(got, lk))
                g32 = max(abs(a - b) for a, b in zip(got, l32))
                n32 = max(abs(a - b) for a, b in zip(lk, l32))
                log(f"{tag}: losses against the one-process bf16 kernel "
                    f"path: gap {gap:.3e} (bound {TX_BF16_LOSS}); against "
                    f"float32 {g32:.3e}, the one-process bf16 path's "
                    f"{n32:.3e}")
                check(gap <= TX_BF16_LOSS, f"(26) {key}: losses within "
                        f"{TX_BF16_LOSS} of the one-process bf16 path")
                check(g32 <= 2 * n32 + 1e-3, f"(26) {key}: the gap to "
                        f"float32 at most twice the one-process bf16 gap")
            fig["runs"][key] = {
                "launches": ranks[0]["launches"], "losses": got,
                "walls": ranks[0]["walls"],
                "held_gb": max(rk["held_gb"] for rk in ranks),
                "peak_gb": max(peaks)}
    for run, (_, _, _, dtypes, fsdp, *_) in TX_RUNS.items():
        for dtype in dtypes if fsdp else ():
            got = fig["runs"][f"{run}/{dtype}"]
            whole = fig["runs"][f"{run}/{dtype}/reckoned"]["whole"]
            log(f"[axis-train] {run} {dtype}: FSDP holds {got['held_gb']:.3f}"
                f" GB a rank (the most of the ranks) against "
                f"{whole['blocks_gb']:.3f} GB of whole blocks without it; "
                f"peak {got['peak_gb']:.3f} GB")
            check(got["held_gb"] < whole["blocks_gb"], f"(26) {run} "
                  f"{dtype}: FSDP holds less a rank")
    ranks = [row["robust"] for row in rows]
    want = tx_expected(TX_ROBUST, "bfloat16", "trimmed_mean")
    for rk in ranks:
        check(all(rk["launches"].get(k, 0) == n for k, n in want.items()),
                f"(26) robust: every rank launched {want} (got "
                f"{rk['launches']})")
    gap = max(abs(rk["losses"][0] - rob[0]) for rk in ranks)
    log(f"[axis-train] robust trimmed_mean step, {TX_ROBUST}: rank losses "
        f"{[rk['losses'] for rk in ranks]} (one process {rob}, gap "
        f"{gap:.3e}); aggregate's relative rms gap to the float32 mean "
        f"gradient by rank {[round(rk['agg_rms_gap'], 6) for rk in ranks]}"
        f" (the one-process bf16 step's {rob_gap:.6f}); the "
        f"parameters past the first AdamW step worked out from the "
        f"aggregate by {max(rk['update_over'] for rk in ranks):.3e} beyond "
        f"one bf16 ulp (bound 0); launches a rank {ranks[0]['launches']}; "
        f"peaks {[round(rk['peak_gb'], 3) for rk in ranks]} GB")
    check(gap <= TX_BF16_LOSS, "(26) the robust rank step's loss within "
            f"{TX_BF16_LOSS} of the one-process robust step")
    for rk in ranks:
        check(rk["agg_rms_gap"] <= 2 * rob_gap + 1e-6,
              "(26) robust: the rank's aggregate within twice the "
              "one-process bf16 step's rms gap to the float32 gradient")
        check(rk["update_over"] <= 0.0, "(26) robust: the rank's "
              "parameters are the first AdamW step of its aggregate")
    fig["runs"]["robust"] = {
        "launches": ranks[0]["launches"], "losses": ranks[0]["losses"],
        "agg_rms_gap": max(rk["agg_rms_gap"] for rk in ranks),
        "agg_rms_gap_one": rob_gap}
    require(not fails, f"(26) {len(fails)} holds failed: {fails}")
    return fig


if __name__ == "__main__":
    sys.exit(main())
