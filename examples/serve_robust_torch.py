"""Serving example on the PyTorch port: batched prefill + decode for any
assigned architecture at reduced scale (``examples/serve_robust.py`` on
``repro_torch``).

Run:  PYTHONPATH=src python examples/serve_robust_torch.py --arch rwkv6_1b6 --device cpu
      PYTHONPATH=src python examples/serve_robust_torch.py --arch recurrentgemma_2b --device cpu
      PYTHONPATH=src python examples/serve_robust_torch.py --arch whisper_small --device cpu

Without ``--device cpu`` it runs on the card, the attention through the
decode and prefill kernels (and the WKV6 scan through its kernel).
"""
import argparse

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.plan import resolve_device
from repro_torch.core.prng import normal, prng_key, randint_n
from repro_torch.launch.serve import generate
from repro_torch.models import model as M

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="rwkv6_1b6")
ap.add_argument("--batch", type=int, default=2)
ap.add_argument("--prompt-len", type=int, default=24)
ap.add_argument("--gen", type=int, default=12)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

cfg = reduced(get_config(args.arch))
dev = resolve_device(args.device)
key = prng_key(0)
params = M.init_params(0, cfg, dev)
B, S = args.batch, args.prompt_len

prompts = randint_n(key, B * S, 0, cfg.vocab, dev).reshape(B, S)
stubs = {}
if cfg.family == "audio":
    stubs["frames"] = normal(key, (B, cfg.n_frames, cfg.d_model), dev)
if cfg.family == "vlm":
    stubs["patch_embeds"] = normal(key, (B, cfg.n_patches, M.D_VIS), dev)

with torch.inference_mode():
    gen, _ = generate(params, cfg, prompts, args.gen, **stubs)
    n_patch = cfg.n_patches if cfg.family == "vlm" else 0
    cache = M.prefill(params, cfg, prompts,
                      cache_len=S + args.gen + 1 + n_patch, **stubs)[1]


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


state_bytes = sum(t.numel() * t.element_size() for t in _leaves(cache))
print(f"arch={cfg.name} family={cfg.family} "
      f"cache/state={state_bytes / 1e6:.2f} MB")
print("generated token ids:")
for row in gen.tolist():
    print("  ", row)
print("serve_robust OK")
