"""Serving launcher of the port: batched prefill + decode loop on one card.

    python -m repro_torch.launch.serve --arch qwen3_8b --reduced \\
        --batch 4 --prompt-len 32 --gen 16 [--device cpu] [--backend torch]

The flags are ``repro.launch.serve``'s (without ``--model-parallel``), plus
``--device`` (default ``cuda``) and ``--backend`` (``auto``: the mixers'
kernels on the card — attention, or the WKV6 scan for ``rwkv6_1b6`` — the
plain versions on the CPU). Weights are seeded
random draws; the prompts are ``jax.random.randint(PRNGKey(seed), (B, S),
0, vocab)`` bit for bit, and temperature sampling draws its Gumbel noise as
``jax.random.categorical`` does, keyed ``fold_in(PRNGKey(seed), i)`` at
decode step ``i``, through the port's threefry. The stub inputs are the
reference CLI's: Whisper's frames ``normal(PRNGKey(seed), (B, n_frames,
d_model))`` and the VLM's patches ``normal(PRNGKey(seed), (B, n_patches,
1024))``, float32, drawn by the port's ``prng.normal`` (jax's to a few
ulp). It prints the generated token ids, one row per request, then
``done``.
"""
from __future__ import annotations

import argparse

import torch

__all__ = ["generate", "main"]


def generate(params, cfg, prompts: torch.Tensor, gen: int,
             temperature: float = 0.0, seed: int = 0,
             backend: str = "auto", *, frames: torch.Tensor | None = None,
             patch_embeds: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefill ``prompts`` (B, S) (with Whisper's ``frames`` or the VLM's
    ``patch_embeds``), then ``gen - 1`` decode steps, the cache sized
    ``S + gen + 1``, plus the patches for a VLM, as the reference's CLI
    sizes it. The first token is the argmax of the prefill logits; later
    ones the argmax, or with ``temperature > 0`` a categorical draw of
    ``logits / temperature``. -> (token ids (B, gen), the last-position
    logits (B, gen, V) each token was chosen from)."""
    from ..core.prng import categorical, fold_in, prng_key
    from ..distributed.server import make_decode_step, make_prefill_step

    S = prompts.shape[1]
    n_patch = 0 if patch_embeds is None else patch_embeds.shape[1]
    prefill_step = make_prefill_step(cfg, cache_len=S + gen + 1 + n_patch,
                                     backend=backend)
    decode_step = make_decode_step(cfg, backend=backend)
    key = prng_key(seed)
    batch = {"tokens": prompts}
    if frames is not None:
        batch["frames"] = frames
    if patch_embeds is not None:
        batch["patch_embeds"] = patch_embeds
    logits, cache = prefill_step(params, batch)
    tok = logits[:, -1].argmax(-1)[:, None]
    toks, seen = [tok], [logits[:, -1]]
    for i in range(gen - 1):
        logits, cache = decode_step(params, cache, tok)
        if temperature > 0:
            tok = categorical(fold_in(key, i),
                              logits[:, -1] / temperature)[:, None]
        else:
            tok = logits[:, -1].argmax(-1)[:, None]
        toks.append(tok)
        seen.append(logits[:, -1])
    return torch.cat(toks, dim=1), torch.stack(seen, dim=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper_sim")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "torch", "cuda"))
    args = ap.parse_args(argv)

    from ..configs import get_config, reduced
    from ..core.plan import resolve_device
    from ..core.prng import normal, prng_key, randint_n
    from ..models import model as M

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = resolve_device(args.device)
    params = M.init_params(args.seed, cfg, dev)
    B, S = args.batch, args.prompt_len
    prompts = randint_n(prng_key(args.seed), B * S, 0, cfg.vocab,
                        dev).reshape(B, S)
    key = prng_key(args.seed)
    stubs = {}
    if cfg.family == "audio":
        stubs["frames"] = normal(key, (B, cfg.n_frames, cfg.d_model), dev)
    if cfg.family == "vlm":
        stubs["patch_embeds"] = normal(key, (B, cfg.n_patches, M.D_VIS), dev)
    with torch.inference_mode():
        toks, _ = generate(params, cfg, prompts, args.gen, args.temperature,
                           args.seed, args.backend, **stubs)
    print("generated token ids:")
    for row in toks.tolist():
        print("  ", row)
    print("done")


if __name__ == "__main__":
    main()
