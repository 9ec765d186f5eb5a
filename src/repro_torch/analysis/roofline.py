"""Roofline yardsticks on the port's card: the NVIDIA H100's constants, the
model FLOPs of a step, the wire bytes of a partitioned push-sum round, and
the time lower bound of a step from its FLOPs, bytes and wire bytes.

The port of ``repro.analysis.roofline``'s analytic half. Its terms:

    compute    = FLOPs_per_device / peak_FLOPs          (989 TFLOP/s bf16)
    memory     = bytes_per_device / HBM_bw              (3.35 TB/s)
    collective = wire_bytes_per_device / link_bw        (450 GB/s NVLink 4)

and the largest is the bound. The FLOPs and bytes come from the caller:
the analytic step models of :mod:`repro_torch.statics.memory`, or a
kernel's own count. ``MODEL_FLOPS / (FLOPs * devices)`` is the share of
the counted compute that is model math.

The reference's ``parse_collectives`` reads XLA's HLO text, which the port
has none of. The port's collectives count their own bytes instead: the
model stack's through :class:`repro_torch.distributed.comm.CountingComm`,
which records each call's kind, mesh dimensions and bytes and sums the
wire bytes by ``parse_collectives``' formulas (the dry run's
``collectives``, :mod:`repro_torch.launch.dryrun`); the graph axes of the
edge-partitioned push-sum add each halo combine's ring wire bytes to
``repro_torch.core.pushsum.GraphAxis.wire_bytes``, which a run holds
against :func:`pushsum_halo_wire_bytes`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["HW", "roofline_terms", "model_flops", "pushsum_halo_wire_bytes"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One NVIDIA H100 SXM5 80 GB (as ``nvidia-smi`` names it, NVIDIA H100
    80GB HBM3, run at its 700.00 W limit): data-sheet figures."""

    peak_flops: float = 989e12     # dense bf16 on the tensor cores
    fp32_flops: float = 67e12      # float32 outside the tensor cores
    hbm_bw: float = 3.35e12        # bytes/s
    link_bw: float = 450e9         # bytes/s, NVLink 4, one direction
    hbm_bytes: float = 80e9


def model_flops(arch, shape) -> float:
    """Useful model FLOPs of the step (global, all devices).

    train:   6 * N_active * tokens  (fwd 2ND + bwd 4ND)
    prefill: 2 * N_active * tokens
    decode:  2 * N_active * batch   (one token per sequence)
    """
    n = arch.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def pushsum_halo_wire_bytes(N: int, d: int, n_shards: int, *,
                            variant: str = "psum",
                            storage_bytes: int = 4) -> float:
    """Per-device wire bytes of one edge-partitioned push-sum round.

    The halo combine merges ``recv`` (N, d) and ``recv_m`` (N,) partials —
    an N (d+1) element operand in the float32 accum dtype — across the
    graph axis, one of two ways:

    ``variant="psum"``
        two all-reduces over the float32 operand, ring factor
        ``2 (n-1)/n * N (d+1) * 4``;
    ``variant="scatter"``
        a reduce-scatter of the float32 partials, ``(n-1)/n * N (d+1) *
        4``, then an all-gather of the result after its cast to the
        storage dtype, ``(n-1)/n * N (d+1) * storage_bytes``: 3/4 of the
        psum bytes at bf16 storage, the same at float32.

    The per-round out-degree reduction is hoisted out of the loop.
    ``n_shards <= 1`` is the unpartitioned mode: no collective, 0 bytes.
    """
    if n_shards <= 1:
        return 0.0
    if variant not in ("psum", "scatter"):
        raise ValueError(
            f"variant must be 'psum' or 'scatter', got {variant!r}")
    elems = N * (d + 1)
    ring = (n_shards - 1) / n_shards
    if variant == "psum":
        return 2.0 * ring * elems * 4
    return ring * elems * (4 + float(storage_bytes))


def roofline_terms(
    cost: dict[str, float],
    coll: dict[str, Any],
    n_devices: int,
    mf: float,
    hw: HW = HW(),
) -> dict[str, Any]:
    """The three time terms of a step from ``cost`` (``"flops"`` and
    ``"bytes accessed"`` per device) and ``coll``
    (``"wire_bytes_per_device"``), the dominant one, and the share of the
    counted FLOPs that ``mf`` model FLOPs are."""
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    wire_dev = float(coll["wire_bytes_per_device"])

    t_compute = flops_dev / hw.peak_flops
    t_memory = bytes_dev / hw.hbm_bw
    t_collective = wire_dev / hw.link_bw
    terms = {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_collective,
    }
    dominant = max(terms, key=terms.get)
    useful = mf / max(flops_dev * n_devices, 1.0)
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "hlo_flops_per_device": flops_dev,
        "hlo_bytes_per_device": bytes_dev,
        "wire_bytes_per_device": wire_dev,
        "model_flops_total": mf,
        "useful_flop_ratio": useful,
        "bound_step_time_s": max(terms.values()),
    }
