"""Milliseconds a step of the port's single-scenario engines on the kernel
path, for the port whose ``src/`` is given (default: this checkout's):
Algorithm 3 (``run_social_runtime``), Algorithm 2
(``run_byzantine_runtime``), HPS (``run_hps_runtime``) and push-sum
(``run_pushsum_sparse``) at chip_smoke.py's step set-ups, at N = 131,072
and at the grids' scenario size (N = 2,048; push-sum 4,096).
CUDA-event medians of ``--runs`` runs of ``STEP_T`` steps, store final.
Each tree runs in a process of its own, so two trees are compared on one
card by runs in turns in one command (parent, tree, tree, parent):

    python3 tools/engine_step_times.py [--src DIR] [--runs R]

The set-up code is this checkout's ``chip_smoke.py``. Prints the card and
one JSON line of the figures. Needs an NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory of the port to time")
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("engine_step_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import (ExecutionPlan, run_byzantine_runtime,
                                  run_hps_runtime, run_pushsum_sparse,
                                  run_social_runtime)
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(f"{card}; port under {src}")
    _build.build(("edge_scatter", "social_innov", "byz_trim"))
    final = ExecutionPlan(store="final", dst_sorted=True)
    runs = {}
    for n in (cs.N_FULL, 2_048):
        model, rt, M = cs.scenario(n)
        model = type(model)(tables=model.tables.to(dev), truth=model.truth)
        rt = rt.to(dev)
        runs[f"social_N{n}"] = lambda T, model=model, rt=rt, M=M: (
            run_social_runtime(model, rt, M, T, seed=0, plan=final))
        bmodel, (brt, extra, n_reps), batk = cs.byz_scenario(n)
        bmodel = type(bmodel)(tables=bmodel.tables.to(dev),
                              truth=bmodel.truth)
        brt = brt.to(dev)
        runs[f"byzantine_N{n}"] = (
            lambda T, m=bmodel, b=brt, x=extra, r=n_reps, a=batk:
            run_byzantine_runtime(m, b, x, r, a, T, seed=0,
                                  plan=ExecutionPlan(store="final")))
        hrt, hw = cs.hps_scenario(n)
        hrt, hw = hrt.to(dev), torch.from_numpy(hw).to(dev)
        runs[f"hps_N{n}"] = lambda T, hrt=hrt, hw=hw: run_hps_runtime(
            hw, hrt, T, seed=0, plan=final)
        pn = 4_096 if n == 2_048 else n
        el, pw = cs.pushsum_scenario(pn)
        src_d, dst_d, pw = (torch.from_numpy(a).to(dev)
                            for a in (el.src, el.dst, pw))
        runs[f"pushsum_N{pn}"] = (
            lambda T, s=src_d, d=dst_d, w=pw: run_pushsum_sparse(
                w, s, d, T, drop_prob=0.2, B=4, record_every=T,
                plan=ExecutionPlan(dst_sorted=True)))
    ms = {}
    for name, run in runs.items():
        run(cs.STEP_T)
        ms[name] = cs.event_ms(lambda run=run: run(cs.STEP_T),
                               args.runs) / cs.STEP_T
        cs.log(f"[timing] {name}: {ms[name]:.4f} ms a step (median of "
               f"{args.runs} runs of {cs.STEP_T} steps)")
    cs.log(json.dumps({"card": card, "src": str(src), "step_ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
