"""Analytic per-device memory model: the port of
``repro.analysis.memory_model`` on the port's own configs.

Every byte term is the reference's, computed from the config and the
sharding layout:

    params            P * 2B   / param_shards
    adam moments      P * 2 * moment_bytes / param_shards
    grad accumulator  P * 4B   / param_shards       (n_micro > 1)
    saved residuals   (L / remat_group) * tok_micro_dev * d * 2B
    logits + CE f32   2 * tok_micro_dev * vocab/model * 4B
    transient slack   25% of params, residuals and logits

Serve holds the KV cache or recurrent state instead of optimizer terms,
and push-sum its node and edge state.

The one difference from the reference: ``fits_hbm`` judges the total
against the card's HBM (:class:`repro_torch.analysis.roofline.HW`), where
the reference's ``fits_16gb`` judged it against a TPU v5e's 16 GB.

The port runs on one card, so a mesh here describes the layout the
prediction is for, not the port's own: its trainer holds all W worker
copies on the one card, where the reference's layout puts one copy on a
device (``worker_axis=True``).
"""
from __future__ import annotations

from ..configs.base import ArchConfig, InputShape
from .roofline import HW

__all__ = ["train_memory_gb", "serve_memory_gb", "pushsum_device_memory_gb"]


def _shards(mesh_shape: dict, fsdp: bool) -> tuple[int, int]:
    model = mesh_shape.get("model", 1)
    data = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    param_shards = model * (data if fsdp else 1)
    return param_shards, data


def _fits(total: float) -> bool:
    return bool(total < HW().hbm_bytes)


def train_memory_gb(
    cfg: ArchConfig, shape: InputShape, mesh_shape: dict,
    fsdp: bool, n_micro: int, worker_axis: bool = False,
    moment_bytes: int = 4,
) -> dict:
    P = cfg.param_count()
    param_shards, data = _shards(mesh_shape, fsdp)
    model = mesh_shape.get("model", 1)
    if worker_axis:
        # decentralized layout: every worker holds a full (TP-sharded) copy
        param_shards = model
    tok_dev = shape.global_batch * shape.seq_len // data
    tok_micro = tok_dev // max(n_micro, 1)

    params_b = P * 2 / param_shards
    moments_b = P * 2 * moment_bytes / param_shards
    gacc_b = (P * 4 / param_shards) if n_micro > 1 else 0.0
    L_eff = max(cfg.n_layers // max(cfg.remat_group, 1), 1)
    resid_b = L_eff * tok_micro * cfg.d_model * 2
    logits_b = 2 * tok_micro * (cfg.vocab / model) * 4
    work_b = 0.25 * (resid_b + logits_b + params_b)

    total = params_b + moments_b + gacc_b + resid_b + logits_b + work_b
    return {
        "params_gb": round(params_b / 1e9, 3),
        "optimizer_gb": round(moments_b / 1e9, 3),
        "grad_acc_gb": round(gacc_b / 1e9, 3),
        "residuals_gb": round(resid_b / 1e9, 3),
        "logits_gb": round(logits_b / 1e9, 3),
        "total_gb": round(total / 1e9, 3),
        "fits_hbm": _fits(total),
    }


def pushsum_device_memory_gb(
    N: int, E: int, d: int = 1, n_shards: int = 1,
    scenarios_per_device: int = 1,
) -> dict:
    """Per-device residency of the (edge-partitioned) sparse push-sum.

    Terms, all float32, per scenario on the device:

        node state      N (2d + 2) * 4     z/sigma (N, d) + m/sigma_m (N,),
                                           replicated across graph shards
        edge state      ceil(E / S) (d+1) * 4    rho + rho_m, shard-local
        mask draw       S * ceil(E / S)          the full (E_pad,) keep
                                           mask, as bool
        halo operand    N (d + 1) * 4      the reduced recv/recv_m pair
        transient slack 25% of the above

    Multiply by ``scenarios_per_device`` for a batch of scenarios on one
    device. ``n_shards=1`` is the unpartitioned mode, with no halo term.
    The port's joint layout holds the same bytes: ``zm`` and ``sigma_zm``
    (N, d+1), ``rho_zm`` (E, d+1).
    """
    S = max(int(n_shards), 1)
    e_shard = -(-E // S)
    node_b = N * (2 * d + 2) * 4
    edge_b = e_shard * (d + 1) * 4
    mask_b = S * e_shard
    halo_b = N * (d + 1) * 4 if S > 1 else 0.0
    per_scenario = node_b + edge_b + mask_b + halo_b
    total = 1.25 * per_scenario * max(int(scenarios_per_device), 1)
    return {
        "node_state_gb": round(node_b / 1e9, 6),
        "edge_state_gb": round(edge_b / 1e9, 6),
        "mask_draw_gb": round(mask_b / 1e9, 6),
        "halo_gb": round(halo_b / 1e9, 6),
        "total_gb": round(total / 1e9, 6),
        "fits_hbm": _fits(total),
    }


def serve_memory_gb(
    cfg: ArchConfig, shape: InputShape, mesh_shape: dict, cache_len: int,
    weight_gathered: bool = False,
) -> dict:
    P = cfg.param_count()
    model = mesh_shape.get("model", 1)
    data = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    b_dev = max(shape.global_batch // data, 1)

    params_b = P * 2 / (model * (data if weight_gathered else 1))
    cache_b = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.mixer_of(i)
        if kind in ("attn", "swa"):
            wlen = (min(cache_len, cfg.window)
                    if (kind == "swa" and cfg.window) else cache_len)
            # heads shard over model when divisible; otherwise the cache
            # falls back to sequence-parallel sharding over model
            if cfg.n_kv_heads % model == 0:
                shard = model
            elif wlen % model == 0:
                shard = model
            else:
                shard = 1
            cache_b += 2 * b_dev * cfg.n_kv_heads * wlen * cfg.head_dim * 2 \
                / shard
        elif kind == "wkv6":
            H = cfg.d_model // cfg.wkv_head_dim
            cache_b += b_dev * max(H / model, 1) * cfg.wkv_head_dim**2 * 4
        elif kind == "rglru":
            cache_b += b_dev * (cfg.rnn_width / model) * (4 + 3 * 2)
    if cfg.encoder_layers:
        cache_b += b_dev * cfg.n_frames * cfg.d_model * 2
    if shape.kind == "prefill":
        # prefill working set: one layer's activations + q/k/v
        act_b = 6 * b_dev * shape.seq_len * cfg.d_model * 2
    else:
        act_b = 4 * b_dev * cfg.d_model * 4
    work_b = 0.25 * params_b + act_b

    total = params_b + cache_b + work_b
    return {
        "params_gb": round(params_b / 1e9, 3),
        "cache_gb": round(cache_b / 1e9, 3),
        "work_gb": round(work_b / 1e9, 3),
        "total_gb": round(total / 1e9, 3),
        "fits_hbm": _fits(total),
    }
