"""Serving launcher of the port: batched prefill + decode loop.

    python -m repro_torch.launch.serve --arch qwen3_8b --reduced \\
        --batch 4 --prompt-len 32 --gen 16 [--device cpu] [--backend torch]

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
        --arch recurrentgemma_2b --reduced --model-parallel 2 [--device cpu]

The flags are ``repro.launch.serve``'s, plus ``--device`` (default
``cuda``), ``--backend`` (``auto``: the mixers' kernels on the card —
attention, or the WKV6 scan for ``rwkv6_1b6`` — the plain versions on the
CPU). Under ``torchrun`` (a world of several ranks) the ranks form the
reference's host mesh, ``(world / model_parallel, model_parallel)`` over
("data", "model"): each rank serves its rows of the batch on its model
blocks of the weights (tensor- and expert-parallel, every family:
:mod:`repro_torch.distributed.server`); the process group is NCCL on the
card (one card a rank) and gloo on the CPU. Alone, ``--model-parallel``
must be 1.

Weights are seeded random draws (a rank draws every leaf and keeps its
block); the prompts are ``jax.random.randint(PRNGKey(seed), (B, S), 0,
vocab)`` bit for bit, and temperature sampling draws its Gumbel noise as
``jax.random.categorical`` does, keyed ``fold_in(PRNGKey(seed), i)`` at
decode step ``i``, through the port's threefry. The stub inputs are the
reference CLI's: Whisper's frames ``normal(PRNGKey(seed), (B, n_frames,
d_model))`` and the VLM's patches ``normal(PRNGKey(seed), (B, n_patches,
1024))``, float32, drawn by the port's ``prng.normal`` (jax's to a few
ulp). It prints the generated token ids, one row per request, then
``done`` (rank 0 only).
"""
from __future__ import annotations

import argparse
import os

import torch

__all__ = ["generate", "init_ranks", "main"]


def generate(params, cfg, prompts: torch.Tensor, gen: int,
             temperature: float = 0.0, seed: int = 0,
             backend: str = "auto", *, frames: torch.Tensor | None = None,
             patch_embeds: torch.Tensor | None = None, mesh=None,
             comm=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefill ``prompts`` (B, S) (with Whisper's ``frames`` or the VLM's
    ``patch_embeds``), then ``gen - 1`` decode steps, the cache sized
    ``S + gen + 1``, plus the patches for a VLM, as the reference's CLI
    sizes it. The first token is the argmax of the prefill logits; later
    ones the argmax, or with ``temperature > 0`` a categorical draw of
    ``logits / temperature``. -> (token ids (B, gen), the last-position
    logits (B, gen, V) each token was chosen from). With ``mesh`` (one
    process a rank) ``prompts`` and the stubs are this rank's rows
    (``distributed.server.rank_rows``) and ``params`` its model blocks."""
    from ..core.prng import categorical, fold_in, prng_key
    from ..distributed.server import make_decode_step, make_prefill_step

    S = prompts.shape[1]
    n_patch = 0 if patch_embeds is None else patch_embeds.shape[1]
    cache_len = S + gen + 1 + n_patch
    prefill_step = make_prefill_step(cfg, cache_len=cache_len,
                                     backend=backend, mesh=mesh, comm=comm)
    decode_step = make_decode_step(cfg, backend=backend, cache_len=cache_len,
                                   mesh=mesh, comm=comm)
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


def init_ranks(model_parallel: int, device: str):
    """Join ``torchrun``'s process group (its environment names the world,
    the rank and the address) and build the host mesh -> (the
    ``RankMesh``, its ``Comm``, this rank's device), or None when this
    process is alone (a world of 1), where ``model_parallel`` must be 1.
    The backend follows the device: NCCL on the card, gloo on the CPU."""
    import torch.distributed as dist

    from ..distributed.comm import Comm
    from ..distributed.sharding import RankMesh
    from .mesh import make_host_mesh

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        if model_parallel != 1:
            raise ValueError("--model-parallel > 1 needs ranks: run the "
                             "launcher under torchrun")
        return None
    dev = torch.device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    rm = RankMesh(make_host_mesh(model_parallel, device_type=dev.type))
    return rm, Comm(rm), dev


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper_sim")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "torch", "cuda"))
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from ..configs import get_config, reduced
    from ..core.plan import resolve_device
    from ..core.prng import normal, prng_key, randint_n
    from ..distributed.server import rank_rows
    from ..distributed.sharding import param_specs
    from ..models import model as M

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = resolve_device(args.device)
    ranks = init_ranks(args.model_parallel, args.device)
    mesh = comm = None
    if ranks is None:
        params = M.init_params(args.seed, cfg, dev)
    else:
        mesh, comm, dev = ranks
        params = M.init_local_params(
            args.seed, cfg, param_specs(M.param_shapes(cfg), cfg, mesh),
            mesh, dev)
    B, S = args.batch, args.prompt_len
    prompts = randint_n(prng_key(args.seed), B * S, 0, cfg.vocab,
                        dev).reshape(B, S)
    key = prng_key(args.seed)
    stubs = {}
    if cfg.family == "audio":
        stubs["frames"] = normal(key, (B, cfg.n_frames, cfg.d_model), dev)
    if cfg.family == "vlm":
        stubs["patch_embeds"] = normal(key, (B, cfg.n_patches, M.D_VIS), dev)
    if mesh is not None:
        prompts = rank_rows(prompts, mesh)
        stubs = {k: rank_rows(v, mesh) for k, v in stubs.items()}
    with torch.inference_mode():
        toks, _ = generate(params, cfg, prompts, args.gen, args.temperature,
                           args.seed, args.backend, mesh=mesh, comm=comm,
                           **stubs)
    if mesh is not None:
        import torch.distributed as dist
        toks = comm.all_gather(toks, ("pod", "data")).reshape(B, -1)
        rank0 = dist.get_rank() == 0
        dist.destroy_process_group()
        if not rank0:
            return
        if comm.staged_calls:
            print(f"gloo host-staged {comm.staged_calls} collectives, "
                  f"{comm.staged_bytes} B (rank 0)")
    print("generated token ids:")
    for row in toks.tolist():
        print("  ", row)
    print("done")


if __name__ == "__main__":
    main()
