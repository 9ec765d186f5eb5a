"""End-to-end run on the PyTorch port: decentralized training of the
~100M paper_sim model with the paper's robust aggregation, a few hundred
steps, with a live Byzantine worker (``examples/robust_training.py`` on
``repro_torch``).

Each worker holds its own model copy (the paper's per-agent belief);
gradients are fused by coordinate-wise trimmed mean (Algorithm 2's
filter), so the sign-flipping Byzantine worker cannot poison training.
The consensus spread across worker copies is the training-side analogue
of Theorem 1's consensus error.

The reference runs over a (pod 2, data devices/4, model 2) mesh; here the
``--workers`` copies share one device as a WorkerLayout(2, workers / 2),
the model axis dropped.

Run (the card; the attention through the prefill kernel, the trim
through the trimmed-mean kernel):
  PYTHONPATH=src python examples/robust_training_torch.py --steps 200
Quick check on the CPU:
  PYTHONPATH=src python examples/robust_training_torch.py --steps 20 --tiny --device cpu
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.plan import resolve_device
from repro_torch.core.prng import prng_key
from repro_torch.data import SyntheticLMData
from repro_torch.distributed.aggregation import AggregatorConfig, WorkerLayout
from repro_torch.distributed.trainer import (TrainConfig, make_train_step,
                                             param_spread,
                                             replicate_for_workers,
                                             worker_opt_init)
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_init


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--workers", type=int, default=4,
                    help="model copies: 2 pods of workers / 2")
    ap.add_argument("--agg", default="trimmed_mean",
                    choices=["mean", "trimmed_mean", "pushsum",
                             "hierarchical_trim"])
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, params=None) -> list:
    """Train as the reference example does -> the printed rows ``(step,
    loss, consensus spread)``; ``params`` (one copy) in place of the
    seeded draw."""
    cfg = get_config("paper_sim")            # ~100M params
    if args.tiny:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, attn_impl="naive", dtype="float32")
    dev = resolve_device(args.device)
    tc = TrainConfig(
        arch=cfg,
        agg=AggregatorConfig(kind=args.agg, F=1, gossip_rounds=16,
                             gamma_period=4, drop_prob=0.1),
        opt=AdamWConfig(lr=3e-4, warmup_steps=max(args.steps // 20, 1),
                        total_steps=args.steps),
        byzantine_workers=(1,),              # worker 1 sign-flips its grads
        byzantine_scale=10.0,
    )
    n_workers = args.workers
    print(f"arch={cfg.name} ({cfg.param_count() / 1e6:.0f}M params) "
          f"agg={args.agg} workers={n_workers} "
          f"byzantine={tc.byzantine_workers} device={dev}")
    data = SyntheticLMData(cfg.vocab, 32 if args.tiny else 128, 8,
                           flavour="markov", n_agents=n_workers, seed=0)
    if params is None:
        params = M.init_params(0, cfg, dev)
    robust = args.agg != "mean"
    if robust:
        step = make_train_step(tc, WorkerLayout(2, n_workers // 2))
        params = replicate_for_workers(params, n_workers)
        opt = worker_opt_init(params)
    else:
        step = make_train_step(tc)
        opt = adamw_init(params)
    rows = []
    for s in range(args.steps):
        batch = data.batch(s, dev)
        if robust:
            params, opt, loss = step(params, opt, batch, prng_key(s))
        else:
            params, opt, loss = step(params, opt, batch)
        if s % max(args.steps // 10, 1) == 0 or s == args.steps - 1:
            with torch.no_grad():
                spread = float(param_spread(params)) if robust else 0.0
            rows.append((s, float(loss), spread))
            print(f"step {s:4d}  loss {rows[-1][1]:.4f}  "
                  f"consensus_spread {spread:.3e}", flush=True)
    return rows


if __name__ == "__main__":
    run(parse_args())
    print("robust_training OK")
