"""The losses of InternVL2-26B's family train cell (``chip_smoke.py`` phase
20: 2 layers at published widths, bf16, the mean mode, 4 rows of 256
seeded float32 patches + 1,792 markov tokens a step) at the training CLI's
lr of 3e-4 and at the cell's 3e-5, each on the kernel path
(``backend="auto"``: K6) and on the plain path (``"torch"``): 10 steps
from the same seed, and step 0's batch scored again after the last step.
Shows whether a loss that swings at 3e-4 swings the same way without the
kernel. Needs an NVIDIA GPU and nvcc; from the repository root:

    python3 tools/internvl2_lr_losses.py

Prints the card and one line a run.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

LRS = (3e-4, 3e-5)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.launch.train import build, parse_args

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    name = "internvl2"
    W, rows = cs.FAMILY_TRAIN[name][3], cs.FAMILY_TRAIN[name][6]
    cfg = cs.family_train_cfg(name)
    stubs = cs.family_stubs(cfg, W * rows, dev)
    for lr in LRS:
        for backend in ("auto", "torch"):
            argv = cs.family_train_argv(name, backend)
            argv[argv.index("--lr") + 1] = str(lr)
            _, data, pw, ow, step, _ = build(parse_args(argv), cfg)
            losses = cs.run_steps(step, pw, ow, data, cs.FAMILY_TRAIN_STEPS,
                                  dev, robust=False, stubs=stubs)
            again = cs.first_batch_loss(pw, cfg, {**data.batch(0, dev),
                                                  **stubs}, W, False)
            swing = float(np.max(np.abs(np.diff(losses))))
            print(f"[internvl2 lr] lr {lr} {backend}: losses "
                  f"{[round(x, 4) for x in losses]}; step 0's batch after "
                  f"the last step {again:.4f}; largest step-to-step change "
                  f"{swing:.4f}", flush=True)
            del pw, ow, step, data
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
