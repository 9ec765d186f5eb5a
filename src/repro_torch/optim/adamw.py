"""AdamW + cosine schedule + global-norm clipping: the port of
``repro.optim.adamw``.

Trees are nested dicts and lists of tensors. Moments are stored in
``moment_dtype`` (float32 by default, or bfloat16) and every update
computes in float32, casting back where the reference does.

Decentralized training keeps one model copy per worker as *stacked*
leaves ``(W, ...)`` (``n_lead=1``): the step counter is then ``(W,)``
int32, the clip norm is each worker's own (reduced over every axis but
the worker axis), and weight decay applies where a leaf of one copy is at
least 2-D, so a stacked ``(W, d)`` norm scale still gets none. One update
covers every worker, a launch per operation and leaf rather than per
worker.

Unlike the reference, which returns new trees, the update writes the
parameters and moments in place (the returned trees hold the same
tensors), so a step needs no second copy of them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

__all__ = ["AdamWConfig", "cosine_lr", "adamw_init", "adamw_update",
           "leaves"]

Params = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"   # "bfloat16" halves optimizer residency


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict/list tree, dict keys in sorted order
    (the order ``jax.tree_util`` flattens in)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``; float32 of
    ``step``'s shape."""
    step = step.float()
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _zeros_like_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like_tree(v, dtype) for v in tree)
    return torch.zeros(tree.shape, dtype=dtype, device=tree.device)


def adamw_init(params: Params, moment_dtype: str = "float32", *,
               n_workers: int | None = None) -> Params:
    """Zero moments in ``moment_dtype`` and a step counter: ``()`` int32,
    or ``(n_workers,)`` for stacked per-worker trees."""
    dt = _DTYPES[moment_dtype]
    dev = leaves(params)[0].device
    shape = () if n_workers is None else (n_workers,)
    return {"m": _zeros_like_tree(params, dt),
            "v": _zeros_like_tree(params, dt),
            "step": torch.zeros(shape, dtype=torch.int32, device=dev)}


def _global_norm(tree: Params, n_lead: int = 0) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in float32; with
    ``n_lead`` leading worker axes, one norm per worker."""
    total = None
    for leaf in leaves(tree):
        if n_lead == 1 and leaf.stride(0) == 0:
            # one gradient shared by every worker: one sum, the same bits
            # for all (a per-row reduction may round each row differently)
            s = torch.square(leaf[0].float()).sum().expand(leaf.shape[0])
        else:
            sq = torch.square(leaf.float())
            s = sq.sum(dim=tuple(range(n_lead, sq.dim()))) \
                if sq.dim() > n_lead else sq
        total = s if total is None else total + s
    return torch.sqrt(total)


def adamw_update(cfg: AdamWConfig, grads: Params, state: Params,
                 params: Params, *, n_lead: int = 0
                 ) -> tuple[Params, Params]:
    """One AdamW step -> (params, state), both updated in place.

    ``grads`` matches ``params`` leaf for leaf (any dtype; a stride-0
    ``expand`` over the worker axis is read as it is). With ``n_lead=1``
    every leaf carries a leading worker axis and ``state["step"]`` is
    ``(W,)``."""
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    gnorm = _global_norm(grads, n_lead)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    mdt = _DTYPES[cfg.moment_dtype]
    sf = step.float()
    bc1 = 1.0 - b1 ** sf
    bc2 = 1.0 - b2 ** sf

    def per_worker(t, ndim):
        return t.reshape(t.shape + (1,) * (ndim - n_lead))

    for g, m, v, p in zip(leaves(grads), leaves(state["m"]),
                          leaves(state["v"]), leaves(params)):
        nd = p.dim()
        g32 = g.float() * per_worker(scale, nd)
        m.copy_((b1 * m.float() + (1 - b1) * g32).to(mdt))
        v.copy_((b2 * v.float() + (1 - b2) * g32 * g32).to(mdt))
        mhat = m.float() / per_worker(bc1, nd)
        vhat = v.float() / per_worker(bc2, nd)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        pf = p.float()
        if nd - n_lead >= 2:
            delta = delta + cfg.weight_decay * pf
        p.copy_((pf - per_worker(lr, nd) * delta).to(p.dtype))
    state["step"] = step.to(torch.int32)
    return params, state
