"""Milliseconds a decode step of the port's one-process serve path on the
kernel path, for the port whose ``src/`` is given (default: this
checkout's): Qwen3-8B at chip_smoke.py's serve-main depth
(``SERVE_QWEN_LAYERS`` of its layers, published widths, bf16), B =
``SERVE_B`` requests of ``SERVE_S`` prompt tokens, ``SERVE_GEN - 1``
teacher-forced decode steps after a fresh prefill. The median of
``--runs`` runs of the CUDA-event time around the host's loop of steps,
from an idle device (the steps are host-bound, so this is the host's time
a step as the device sees it). Each tree runs in a process of its own, so
two trees are compared on one card by runs in turns in one command
(parent, tree, tree, parent):

    python3 tools/decode_step_times.py [--src DIR] [--runs R]

Prints the card and one JSON line of the figures. Needs an NVIDIA GPU and
nvcc.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
        print("decode_step_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core.prng import prng_key, randint_n
    from repro_torch.kernels import _build
    from repro_torch.kernels.swa import attn_decode_cuda
    from repro_torch.models import model as M

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(f"{card}; port under {src}")
    _build.build(("attn_decode", "swa_prefill"))
    cfg = dataclasses.replace(get_config("qwen3_8b"),
                              n_layers=cs.SERVE_QWEN_LAYERS)
    B, S, GEN = cs.SERVE_B, cs.SERVE_S, cs.SERVE_GEN
    params = M.init_params(0, cfg, dev)
    prompts = randint_n(prng_key(9), B * S, 0, cfg.vocab, dev).reshape(B, S)
    toks = randint_n(prng_key(10), B * GEN, 0, cfg.vocab,
                     dev).reshape(B, GEN)
    ts = []
    with torch.inference_mode():
        for _ in range(args.runs + 1):          # the first run warms up
            _, cache = M.prefill(params, cfg, prompts, cache_len=S + GEN + 1)
            torch.cuda.synchronize()
            before = attn_decode_cuda.launches
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(GEN - 1):
                M.decode_step(params, cfg, cache, toks[:, i:i + 1])
            end.record()
            end.synchronize()
            if attn_decode_cuda.launches - before != \
                    (GEN - 1) * cfg.n_layers:
                raise RuntimeError("K5 did not launch once a layer a step")
            ts.append(start.elapsed_time(end) / (GEN - 1))
            del cache
    ms = float(np.median(ts[1:]))
    cs.log(f"[timing] {cfg.name} at {cfg.n_layers} layers, B={B}, prompt "
           f"{S}: decode {ms:.4f} ms a step (median of {args.runs} runs of "
           f"{GEN - 1} steps; runs {[round(t, 4) for t in ts[1:]]})")
    cs.log(json.dumps({"card": card, "src": str(src), "decode_ms": ms,
                       "runs_ms": ts[1:]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
