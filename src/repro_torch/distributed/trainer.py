"""Train-step builders: the port of ``repro.distributed.trainer``.

Two execution modes, as in the reference:

* ``mean`` (aggregator "mean"): one model copy trained on the whole
  global batch, the plain-production baseline (the reference's GSPMD
  step, whose gradient all-reduce is implicit).

* ``robust`` (any other aggregator): decentralized training. Every worker
  keeps its OWN model copy and evolves it by the paper's consensus +
  innovation loop: local grads (innovation) -> robust aggregation across
  workers (consensus) -> local AdamW step. Byzantine workers are simulated
  by replacing their gradient with ``-scale * g`` before aggregation (the
  strongest in-scope attack: sign flip and rescale).

The reference runs the robust step as a ``shard_map`` over a (pod, data)
mesh. Here the W = n_pods * per_pod workers share one card: parameters
are stacked leaves ``(W, ...)`` (``replicate_for_workers``' layout, so
converted trees and checkpoints line up), worker ``w = pod * per_pod +
data`` takes rows ``[w B/W, (w+1) B/W)`` of the global batch (the rows the
reference's (pod, data) batch spec gives it), and runs its loss and
backward on ``leaf[w].detach().requires_grad_()`` views, so no full-size
zero gradient is built per worker. Its gradient is written as float32
into row w of one flat ``(W, D_total)`` buffer (the reference
all-gathers it), the aggregator runs once over that buffer, each leaf's
columns are cast back to the gradient's dtype as the reference's
aggregators do, and one AdamW update covers every worker's copy.

Consensus error across worker copies is observable via ``param_spread``,
the training-side analogue of Theorem 1's consensus-error bound.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..configs.base import ArchConfig
from ..core.prng import Key
from ..models import model as M
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update, leaves
from .aggregation import AGGREGATORS, AggregatorConfig, WorkerLayout

__all__ = ["TrainConfig", "WorkerLayout", "make_train_step",
           "replicate_for_workers", "worker_opt_init", "param_spread"]

Params = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    arch: ArchConfig
    agg: AggregatorConfig = AggregatorConfig()
    opt: AdamWConfig = AdamWConfig()
    fsdp: bool = False
    n_micro: int = 1                          # gradient-accumulation steps
    byzantine_workers: tuple[int, ...] = ()   # simulated compromised workers
    byzantine_scale: float = 10.0
    seed: int = 0


def make_train_step(tc: TrainConfig, layout: WorkerLayout | None = None,
                    backend: str = "auto", record: bool | str = False):
    """The step function of ``tc``'s mode. ``backend`` is the kernel route
    of the model's mixers (``"auto"``: the kernels on the card).

    - ``mean``: ``step(params, opt_state, batch) -> (params, opt_state,
      loss)``;
    - robust: ``step(params_w, opt_w, batch, step_key) -> (params_w,
      opt_w, loss)`` over the worker ``layout`` (n_pods, per_pod), with
      ``step_key`` the threefry key the aggregator draws from
      (the reference passes ``fold_in(PRNGKey(seed), step)``).

    Parameters and optimizer state are updated in place. With ``record``
    a robust step keeps its last gradient buffer (after the Byzantine
    attack) and the aggregate, float32 (W, D_total), as ``step.grads`` and
    ``step.aggregate``, for checks; ``record="aggregate"`` keeps the
    aggregate alone (the buffer is W times its size, and is otherwise
    freed before the optimizer's update). A mean step with ``record``
    keeps its gradients, in ``leaves(params)`` order, as ``step.grads``."""
    if tc.fsdp:
        raise NotImplementedError(
            "fsdp=True shards parameters over devices: the port runs on one "
            "card until multi-GPU training (ROADMAP queue 1 item 8)")
    if tc.agg.kind == "mean":
        return _make_mean_step(tc, backend, bool(record))
    if layout is None:
        raise ValueError("a robust step needs a worker layout "
                         "(n_pods, per_pod)")
    return _make_robust_step(tc, WorkerLayout(*layout), backend, record)


def _micro_split(batch: dict, n_micro: int) -> dict:
    """(B, ...) -> (n_micro, B/n_micro, ...) with the stride-n_micro
    interleave: micro-batch i holds rows i, i + n_micro, ..."""
    def split(x):
        B = x.shape[0]
        return x.reshape((B // n_micro, n_micro) + tuple(x.shape[1:])
                         ).transpose(0, 1)
    return {k: split(v) for k, v in batch.items()}


def _loss(params: Params, cfg: ArchConfig, batch: dict, backend: str
          ) -> torch.Tensor:
    """``loss_fn`` of a batch: tokens and labels, and the stub inputs a
    batch of the audio or VLM family carries (``frames``,
    ``patch_embeds``), as the reference's ``_loss``."""
    return M.loss_fn(params, cfg, batch["tokens"], batch["labels"], backend,
                     patch_embeds=batch.get("patch_embeds"),
                     frames=batch.get("frames"))


def _grads_microbatched(params: Params, cfg: ArchConfig, batch: dict,
                        n_micro: int, backend: str
                        ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """(loss, grads in ``leaves(params)`` order). One micro-batch: the
    gradients in the parameters' dtype. Several: a float32 accumulator,
    scaled by 1 / n_micro, as the reference's scan. A leaf the loss does
    not reach (a VLM's ``vis_proj`` on a text-only batch) gets a zero
    gradient, as the reference's, so AdamW still decays it."""
    ps = leaves(params)

    def grads(loss):
        gs = torch.autograd.grad(loss, ps, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(ps, gs)]

    if n_micro <= 1:
        loss = _loss(params, cfg, batch, backend)
        return loss.detach(), grads(loss)
    micro = _micro_split(batch, n_micro)
    gacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in ps]
    loss_acc = torch.zeros((), dtype=torch.float32, device=ps[0].device)
    for i in range(n_micro):
        loss = _loss(params, cfg, {k: v[i] for k, v in micro.items()},
                     backend)
        for a, g in zip(gacc, grads(loss)):
            a.add_(g.float())
        loss_acc = loss_acc + loss.detach()
    inv = 1.0 / n_micro
    return loss_acc * inv, [g * inv for g in gacc]


def _make_mean_step(tc: TrainConfig, backend: str, record: bool):
    cfg = tc.arch

    def step(params, opt_state, batch):
        with torch.enable_grad():
            train = M._tmap(lambda p: p.detach().requires_grad_(), params)
            loss, grads = _grads_microbatched(train, cfg, batch, tc.n_micro,
                                              backend)
        if record:
            step.grads = grads
        with torch.no_grad():     # a list of grads in leaves(params) order
            adamw_update(tc.opt, grads, opt_state, params)
        return params, opt_state, loss

    return step


def _make_robust_step(tc: TrainConfig, layout: WorkerLayout, backend: str,
                      record: bool | str):
    cfg = tc.arch
    agg_fn = AGGREGATORS[tc.agg.kind]
    W = layout.n_workers
    byz = frozenset(tc.byzantine_workers)
    grad_dtype = None if tc.n_micro <= 1 else torch.float32

    def step(params_w, opt_w, batch, step_key: Key):
        ps = leaves(params_w)
        for p in ps:
            if p.shape[0] != W:
                raise ValueError(f"a leaf of shape {tuple(p.shape)} has no "
                                 f"leading axis of the {W} workers")
        sizes = [p[0].numel() for p in ps]
        D = sum(sizes)
        B = batch["tokens"].shape[0]
        if B % W:
            raise ValueError(f"global batch {B} does not split over {W} "
                             f"workers")
        b = B // W
        G = torch.empty((W, D), dtype=torch.float32, device=ps[0].device)
        losses = []
        for w in range(W):
            rows = {k: v[w * b:(w + 1) * b] for k, v in batch.items()}
            with torch.enable_grad():
                mine = M._tmap(lambda p: p[w].detach().requires_grad_(),
                             params_w)
                loss, grads = _grads_microbatched(mine, cfg, rows,
                                                  tc.n_micro, backend)
            losses.append(loss)
            off = 0
            for g in grads:
                if w in byz:      # colluding sign-flip in the grad's dtype
                    g = -tc.byzantine_scale * g
                n = g.numel()
                G[w, off:off + n] = g.reshape(-1)
                off += n
            del grads, mine
        with torch.no_grad():
            agg = agg_fn(G, tc.agg, layout, step_key)
            if record:
                step.aggregate = agg
                if record != "aggregate":
                    step.grads = G
            del G
            shared = agg.stride(0) == 0
            per_leaf, off = [], 0
            for p, n in zip(ps, sizes):
                dt = grad_dtype or p.dtype
                if shared:      # one aggregate: cast one row, expand it
                    g = agg[0, off:off + n].to(dt).reshape(p.shape[1:])
                    per_leaf.append(g.expand(p.shape))
                else:
                    per_leaf.append(agg[:, off:off + n].to(dt).reshape(
                        p.shape))
                off += n
            del agg
            adamw_update(tc.opt, per_leaf, opt_w, params_w, n_lead=1)
        return params_w, opt_w, torch.stack(losses).mean()

    return step


# ---------------------------------------------------------------------------
# worker-axis param helpers
# ---------------------------------------------------------------------------

def replicate_for_workers(params: Params, n_workers: int) -> Params:
    """Tile a single model copy into the worker-axis layout: stacked
    ``(W, ...)`` leaves, one writable copy per worker."""
    return M._tmap(lambda x: x.unsqueeze(0).expand(
        (n_workers,) + tuple(x.shape)).contiguous(), params)


def worker_opt_init(params_w: Params) -> Params:
    """Per-worker AdamW state (leading worker axis, a (W,) step counter);
    float32 moments whatever ``moment_dtype`` says, as the reference's."""
    return adamw_init(params_w, n_workers=leaves(params_w)[0].shape[0])


def param_spread(params_w: Params) -> torch.Tensor:
    """Max over leaves of max |worker_i - mean|: the consensus error. The
    mean is taken in float32 and rounded to the leaf's dtype, as the
    reference's ``mean`` of a bf16 leaf is."""
    out = None
    for x in leaves(params_w):
        mu = x.float().mean(dim=0, keepdim=True).to(x.dtype)
        s = (x.float() - mu.float()).abs().max()
        out = s if out is None else torch.maximum(out, s)
    return out
