"""Time to prefill of one model at its full published depth on the port's
kernel path, for the port whose ``src/`` is given (default: this
checkout's): ``SERVE_B`` requests of ``SERVE_S`` prompt tokens (chip_smoke.py's
serve shape), seeded weights, bf16; CUDA events around ``M.prefill``, the
median of ``--runs`` after one warm-up run, with the K6 launches of a run
and how many of them went to its tensor-core kernel. Each tree runs in a
process of its own, so two trees are compared on one card by runs in
turns in one command (parent, tree, tree, parent):

    python3 tools/prefill_times.py [--arch NAME] [--src DIR] [--runs R]

Prints the card and one JSON line of the figures. Needs an NVIDIA GPU and
nvcc.
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
    ap.add_argument("--arch", default="recurrentgemma_2b")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory of the port to time")
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import numpy as np
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("prefill_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core.prng import prng_key, randint_n
    from repro_torch.kernels import _build
    from repro_torch.kernels.swa import swa_prefill_cuda
    from repro_torch.models import model as M

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(f"{card}; port under {src}")
    _build.build()
    cfg = get_config(args.arch)
    B, S = cs.SERVE_B, cs.SERVE_S
    params = M.init_params(0, cfg, dev)
    prompts = randint_n(prng_key(9), B * S, 0, cfg.vocab, dev).reshape(B, S)
    stubs = cs.family_stubs(cfg, B, dev)
    ts, launches = [], None
    with torch.inference_mode():
        for _ in range(args.runs + 1):          # the first run warms up
            torch.cuda.synchronize()
            before = (swa_prefill_cuda.launches, swa_prefill_cuda.launches_tc)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, cache = M.prefill(params, cfg, prompts,
                                 cache_len=S + 1 + cs.n_stub_rows(stubs),
                                 **stubs)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
            launches = (swa_prefill_cuda.launches - before[0],
                        swa_prefill_cuda.launches_tc - before[1])
            del cache
    ms = float(np.median(ts[1:]))
    cs.log(f"[timing] {cfg.name} prefill at {cfg.n_layers} layers, B={B}, "
           f"S={S}: {ms:.2f} ms (median of {args.runs}; runs "
           f"{[round(t, 2) for t in ts[1:]]}); K6 {launches[0]} launches a "
           f"run, {launches[1]} on its tensor-core kernel")
    cs.log(json.dumps({"card": card, "src": str(src), "arch": cfg.name,
                       "layers": cfg.n_layers, "prefill_ms": ms,
                       "runs_ms": ts[1:], "k6_launches": launches[0],
                       "k6_launches_tc": launches[1]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
