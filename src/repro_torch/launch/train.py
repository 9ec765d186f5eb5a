"""Training launcher of the port: decentralized robust training on one card.

    python -m repro_torch.launch.train --arch paper_sim --reduced --steps 4 \\
        --seq-len 32 --global-batch 8 --agg trimmed_mean --workers 4 \\
        --byzantine 1 [--device cpu] [--backend torch]

The flags are ``repro.launch.train``'s, with two changes: ``--workers N``
takes the place of ``--fake-devices N`` (N worker copies of the model on
one card: the data axis of the reference's host mesh), and
``--model-parallel`` is dropped (tensor parallelism waits for multi-GPU
training, ROADMAP queue 1 item 8). Added: ``--device`` (default ``cuda``)
and ``--backend`` (``auto``: the kernels on the card, K6 attention in
every layer's forward and K4 in the trimmed aggregators; the plain
versions on the CPU).

Weights are seeded random draws; the data is the reference's synthetic
markov stream, bit for bit. Robust modes print ``step N loss X
consensus_spread Y`` at the reference's cadence, the mean mode ``step N
loss X``, then ``done``. The MoE, audio and VLM families raise
NotImplementedError (ROADMAP queue 1 item 9d-2).
"""
from __future__ import annotations

import argparse

import torch

__all__ = ["build", "main"]

AGGS = ("mean", "pushsum", "pushsum_sparse", "trimmed_mean",
        "hierarchical_trim")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper_sim")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant of the arch")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--agg", default="mean", choices=AGGS)
    ap.add_argument("--byzantine", default="",
                    help="comma-separated compromised worker indices")
    ap.add_argument("--trim-f", type=int, default=1)
    ap.add_argument("--gossip-rounds", type=int, default=16)
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--drop-prob", type=float, default=0.1)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--workers", type=int, default=1,
                    help="worker copies of the model on the card")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "torch", "cuda"))
    return ap.parse_args(argv)


def build(args: argparse.Namespace, cfg=None, record: bool = False):
    """Everything a run needs, from the CLI's arguments -> (tc, data,
    params, opt_state, step function, layout or None). ``cfg`` overrides
    the ``--arch``/``--reduced`` choice (a cut-depth config, say). Robust
    modes get stacked per-worker parameters and state; ``record`` is
    :func:`~repro_torch.distributed.trainer.make_train_step`'s."""
    from ..configs import get_config, reduced
    from ..core.plan import resolve_device
    from ..data import SyntheticLMData
    from ..distributed.aggregation import AggregatorConfig, WorkerLayout
    from ..distributed.trainer import (TrainConfig, make_train_step,
                                       replicate_for_workers,
                                       worker_opt_init)
    from ..models import model as M
    from ..optim import AdamWConfig, adamw_init

    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduced(cfg)
    M.check_trainable(cfg)
    dev = resolve_device(args.device)
    n_workers = args.workers
    byz = tuple(int(b) for b in args.byzantine.split(",") if b)
    tc = TrainConfig(
        arch=cfg,
        agg=AggregatorConfig(
            kind=args.agg, F=args.trim_f, gossip_rounds=args.gossip_rounds,
            gamma_period=args.gamma, drop_prob=args.drop_prob,
            trim_backend=args.backend, pushsum_backend=args.backend),
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                        total_steps=args.steps),
        n_micro=args.n_micro,
        byzantine_workers=byz,
        seed=args.seed,
    )
    data = SyntheticLMData(cfg.vocab, args.seq_len, args.global_batch,
                           flavour="markov", n_agents=n_workers,
                           seed=args.seed)
    params = M.init_params(args.seed, cfg, dev)
    if args.agg == "mean":
        return (tc, data, params, adamw_init(params),
                make_train_step(tc, backend=args.backend), None)
    layout = WorkerLayout(1, n_workers)
    params_w = replicate_for_workers(params, n_workers)
    del params
    return (tc, data, params_w, worker_opt_init(params_w),
            make_train_step(tc, layout, backend=args.backend, record=record),
            layout)


def main(argv=None) -> None:
    args = parse_args(argv)
    from ..checkpoint import save_checkpoint
    from ..core.prng import fold_in, prng_key
    from ..distributed.trainer import param_spread

    tc, data, params, opt, step, layout = build(args)
    dev = params["embed"].device
    key = prng_key(args.seed)
    every = max(args.steps // 10, 1)
    for s in range(args.steps):
        batch = data.batch(s, dev)
        if layout is None:
            params, opt, loss = step(params, opt, batch)
        else:
            params, opt, loss = step(params, opt, batch, fold_in(key, s))
        if s % every == 0 or s == args.steps - 1:
            if layout is None:
                print(f"step {s:5d} loss {float(loss):.4f}", flush=True)
            else:
                with torch.no_grad():
                    spread = float(param_spread(params))
                print(f"step {s:5d} loss {float(loss):.4f} "
                      f"consensus_spread {spread:.3e}", flush=True)
        if args.ckpt_dir and args.ckpt_every and \
                (s + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, s + 1, params)
    print("done")


if __name__ == "__main__":
    main()
