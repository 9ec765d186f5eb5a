"""Static memory / byte budgeter — recorded footprints and analytic
per-engine step models on the port's card.

Two complementary views:

* :func:`footprint` — account every recorded intermediate's bytes (peak
  single value, total traffic proxy, largest offenders). This is the
  *structural* number: it scales exactly as the program does, so a peak
  of O(E d) (and not O(N^2)) at a fixture shows the program's shape.
* the ``*_step_bytes`` analytic models — closed-form per-iteration HBM
  traffic of each engine, the reference's models term for term. They feed
  :func:`repro_torch.analysis.roofline.roofline_terms` (via
  :func:`step_floor`) for a memory-bound step-time lower bound on the
  H100: a *floor*; a step measured below it means the model or the
  constants are wrong.

Persistent state is charged at the precision policy's storage width
(``policy=None`` is float32); PRNG draws, masks, sort keys and int32 ids
stay 4 B.
"""
from __future__ import annotations

from ..analysis.roofline import HW, roofline_terms
from .walk import collect_values

__all__ = [
    "footprint",
    "step_floor",
    "pushsum_step_bytes",
    "pushsum_sharded_step_bytes",
    "social_step_bytes",
    "hps_step_bytes",
    "byz_sparse_step_bytes",
    "byz_dense_bytes",
]

_F32 = 4  # accum/index width: reductions, PRNG draws, int32 ids stay 4 B


def _storage_bytes(policy) -> int:
    """Bytes per element of the policy's *storage* dtype. ``None`` = the
    default fp32 policy (4 B). Lazy import: the statics modules stay
    importable without the engines."""
    if policy is None:
        return _F32
    if isinstance(policy, str):
        from ..core.precision import resolve_policy
        return resolve_policy(policy).storage_bytes
    return int(policy.storage_bytes)


def footprint(record, dims: dict[str, int] | None = None) -> dict:
    """Byte accounting over every intermediate of a recorded program.

    ``total_bytes`` (sum over all op outputs) over-counts live memory but
    is a faithful traffic proxy; ``peak_value_bytes`` is the largest single
    intermediate — the number that must stay O(E d).
    """
    values = collect_values(record)
    sized = sorted(values, key=lambda v: v.nbytes, reverse=True)
    return {
        "n_values": len(values),
        "total_bytes": int(sum(v.nbytes for v in values)),
        "peak_value_bytes": int(sized[0].nbytes) if sized else 0,
        "top": [v.describe(dims) + f" = {v.nbytes} B" for v in sized[:5]],
    }


def step_floor(step_bytes: float, step_flops: float = 0.0, hw: HW = HW(),
               *, wire_bytes: float = 0.0, n_devices: int = 1) -> dict:
    """Roofline lower bound for one engine iteration on the card: the
    analytic byte and FLOP counts through
    :func:`repro_torch.analysis.roofline.roofline_terms`;
    ``bound_step_time_s`` is the largest of the memory, compute and (with
    ``wire_bytes`` > 0, a partitioned round's halo) collective terms."""
    return roofline_terms(
        {"flops": float(step_flops), "bytes accessed": float(step_bytes)},
        {"wire_bytes_per_device": float(wire_bytes)},
        n_devices=n_devices,
        mf=0.0,
        hw=hw,
    )


# ---------------------------------------------------------------------------
# Analytic per-iteration HBM traffic: the reads and writes of an engine's
# round. Constants are small and not tuned.
# ---------------------------------------------------------------------------

def pushsum_step_bytes(N: int, E: int, d: int = 1, *, policy=None) -> int:
    """Sparse push-sum round: gather E edge contributions of (value, mass),
    segment-sum into N nodes, plus the edge mask draw."""
    sb = _storage_bytes(policy)
    edge = E * (2 * d + 2) * sb            # relay (rho, rho_m) read + write
    node = N * (2 * d + 2) * sb            # read state, write state
    mask = E * _F32                        # per-edge Bernoulli keep mask
    return edge + node + mask


def pushsum_sharded_step_bytes(N: int, E: int, d: int = 1,
                               n_shards: int = 1, *, policy=None) -> int:
    """Per-DEVICE HBM traffic of one edge-partitioned push-sum round.

    Edge traffic drops to the shard-local ceil(E / S) slice; node traffic
    stays full (state is replicated across graph shards); the mask term is
    the FULL padded (S * ceil(E/S),) draw, which every device draws whole
    and windows. The halo's wire bytes ride the collective term of
    :func:`step_floor`
    (:func:`repro_torch.analysis.roofline.pushsum_halo_wire_bytes`).
    """
    S = max(int(n_shards), 1)
    sb = _storage_bytes(policy)
    e_shard = -(-E // S)
    edge = e_shard * (2 * d + 2) * sb
    node = N * (2 * d + 2) * sb
    mask = S * e_shard * _F32
    return edge + node + mask


def social_step_bytes(N: int, E: int, m: int, M: int = 1, *,
                      policy=None) -> int:
    """Algorithm 3 round: edge-gathered belief exchange (E x m), private
    Bayesian update (N x m likelihood row), per-edge drop mask."""
    sb = _storage_bytes(policy)
    edge = E * (m + 2) * sb
    # beliefs rw at storage width + the fp32 likelihood-table row
    node = 2 * N * m * sb + N * m * _F32
    mask = E * _F32
    return (edge + node + mask) * max(M, 1)


def hps_step_bytes(N: int, E: int, d: int = 1, *, policy=None) -> int:
    """Hierarchical push-sum round — push-sum traffic plus the fusion-layer
    pool touching every node value once more."""
    sb = _storage_bytes(policy)
    return pushsum_step_bytes(N, E, d, policy=policy) + 2 * N * d * sb


def byz_sparse_step_bytes(N: int, deg: int, m: int, *, policy=None) -> int:
    """Sparse Byzantine round: per-node neighbor gather (deg x m), trimmed
    reduce, belief rw."""
    sb = _storage_bytes(policy)
    gather = N * deg * m * sb
    trim = 2 * N * deg * m * _F32          # sort keys + gathered survivors
    node = 2 * N * m * sb
    return gather + trim + node


def byz_dense_bytes(N: int, m: int = 3) -> int:
    """Working set of the dense (N x N) trim oracle at one round: the
    all-pairs belief matrix, its sort permutation, and the gathered output.
    This is the term that rules dense out at scale — at N=4096, m=3 it is
    ~0.6 GB *per round* where the sparse core needs a few MB."""
    return 3 * N * N * m * _F32
