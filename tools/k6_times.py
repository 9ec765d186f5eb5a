"""Device milliseconds of K6 (``swa_prefill_cuda``, bf16) at the shapes
the port's paths give it, for the port whose ``src/`` is given (default:
this checkout's), beside SDPA on the same inputs and the operations bound:
RecurrentGemma-2B's prefill (8 requests of 2,048 tokens, 10 query heads on
one KV head of 256, window 2,048), a rank's gathered heads at model 4 (1 x
2,048, 3 on 1), the two rank training shapes (2 x 512, 3 on 1; 1 x 512, 5
on 1), Qwen3-8B's prefill (8 x 2,048, 32 on 8 of 128) and paper_sim's
training shape (8 x 1,024, 12 on 4 of 64). Host hidden (a device sleep
before each run), the median of ``--runs``. Each tree runs in a process
of its own, so two trees are compared on one card by runs in turns in one
command (parent, tree, tree, parent):

    python3 tools/k6_times.py [--src DIR] [--runs R]

Prints the card and one JSON line of the figures, with the K6 kernel each
shape went to. Needs an NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name: (B, S, H, Hkv, dh, window)
SHAPES = {
    "recurrentgemma_prefill": (8, 2048, 10, 1, 256, 2048),
    "gathered_heads_model_4": (1, 2048, 3, 1, 256, 2048),
    "rank_train_model_4": (2, 512, 3, 1, 256, 0),
    "rank_train_data_2_model_2": (1, 512, 5, 1, 256, 0),
    "qwen3_8b_prefill": (8, 2048, 32, 8, 128, 0),
    "paper_sim_train": (8, 1024, 12, 4, 64, 0),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory of the port to time")
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("k6_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.swa import swa_prefill_cuda

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(f"{card}; port under {src}")
    _build.build(("swa_prefill",))
    g = torch.Generator(device=dev).manual_seed(32)
    tr = (0, 2, 1, 3)
    rows = {}
    for name, (B, S, H, Hkv, dh, w) in SHAPES.items():
        q, k, v = (torch.randn((B, S, n, dh), generator=g,
                               device=dev).to(torch.bfloat16)
                   for n in (H, Hkv, Hkv))
        before = swa_prefill_cuda.launches_tc
        swa_prefill_cuda(q, k, v, w)             # a first launch, untimed
        kernel = "tc" if swa_prefill_cuda.launches_tc > before else "fma"
        ms = cs.event_ms(lambda: swa_prefill_cuda(q, k, v, w), args.runs,
                         None, True)
        lib = cs.event_ms(lambda: F.scaled_dot_product_attention(
            q.permute(tr), k.permute(tr), v.permute(tr), is_causal=True,
            enable_gqa=True), args.runs, None, True)
        cost = cs.kcosts().swa_prefill(B, S, H, Hkv, dh, w, q.element_size())
        flops = cost.flops
        b, by = cs.cost_bound(cost)
        rows[name] = {"shape": [B, S, H, Hkv, dh, w], "kernel": kernel,
                      "ms": ms, "library_ms": lib, "bound_ms": b,
                      "bound_by": by, "tflops": flops / ms / 1e9}
        cs.log(f"[timing] K6 {name} (B={B}, S={S}, H={H}, Hkv={Hkv}, "
               f"dh={dh}, window {w}, bf16, {kernel} kernel): {ms:.5f} ms "
               f"= {flops / ms / 1e9:.1f} TFLOP/s, SDPA {lib:.5f}, bound "
               f"{b:.5f} ({by})")
    cs.log(json.dumps({"card": card, "src": str(src), "k6": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
