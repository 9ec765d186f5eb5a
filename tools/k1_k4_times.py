"""Device times of the engines' kernels K1-K3 and of the trimmed mean K4 at
their main paths' shapes, each three ways (``chip_smoke.three_ways``: with
the host's enqueueing hidden, the kernels alone under the profiler, and
host-inclusive; the L2 flushed before each run), for the port whose
``src/`` is given (default: this checkout's). Each tree runs in a process
of its own, so two trees are compared on one card by two runs in one
command:

    python3 tools/k1_k4_times.py [--src DIR]

Shapes: K1-K3 at Algorithm 3's and Algorithm 2's N = 131,072 (phase 2 of
``chip_smoke.py``), K1's column walk beside its edge-tiled kernel there
and at ``pushsum_sparse``'s 8 workers x 2^24 + 1 columns, K3 with
materialized lies and at deg_max 16, 32 and 64 (those the tree's
``DEG_MAX_CAP`` takes), K4 at paper_sim's 8 x 99,496,704 for F in {0, 2}.
The timing code is this checkout's ``chip_smoke.py``; the tree under
``--src`` must have K1's ``tiled=`` choice (every tree since K1's
redesign). Prints the card and one JSON line of the figures. Needs an
NVIDIA GPU and nvcc.
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
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("k1_k4_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.byz_trim import DEG_MAX_CAP

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(f"{card}; port under {src}")
    built = _build.build(("edge_scatter", "social_innov", "byz_trim",
                          "trimmed_mean"))
    for b in built.values():
        cs.log(f"[build] {b.name}: " + " | ".join(
            ln.replace("ptxas info    :", "").strip()
            for ln in b.log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln))
    model, rt, _ = cs.scenario(cs.N_FULL)
    _, bsetup, _ = cs.byz_scenario(cs.N_FULL)
    args = cs.engine_args(dev, model, rt.to(dev), bsetup[0].to(dev))
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    times = cs.engine_kernel_times(args, flush)
    times["byz_trim"]["widths"] = cs.k3_width_times(
        dev, flush, [w for w in (16, 32, 64) if w <= DEG_MAX_CAP])
    del args
    times["edge_scatter_pushsum_sparse"] = cs.k1_sparse_times(dev, flush)
    cfg = get_config("paper_sim")
    times["trimmed_mean"] = cs.tmean_times(
        dev, flush, cfg.param_count() + cfg.d_model)
    cs.log(json.dumps({"card": card, "src": str(src), "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
