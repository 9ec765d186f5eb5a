"""What each of the port's seven CUDA kernels costs: the operations and the
bytes of one launch, counted as ``PERF.md``'s bound column counts them
(every input read once, every output written once; a broadcast input's
distinct elements once). A shape rule reports a launch's
:class:`KernelCost` through :func:`repro_torch.kernels.dispatch.record`.

The counts are functions of the launch's shape, so ``chip_smoke.py``'s
bounds, the shape rules and the dry run (:mod:`repro_torch.launch.dryrun`)
read the same numbers:

* ``flops``: operations on the tensor cores (bf16 products: K5 and K6 in
  bf16, K7's split products), timed against ``HW().peak_flops``;
* ``fp32_ops``: operations on the FMA pipes (K1-K4, K5's and K6's float32
  kernels, K7's scans), timed against ``HW().fp32_flops``;
* ``bytes``: the HBM bytes the function must move.

Where the work depends on the data, a shape rule cannot see it (a fake
tensor holds no values), so it counts the most the shape allows: every
cache row valid for K5, F trimmed at every receiver of a K3 call given a
per-receiver F tensor as its largest possible count.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["KernelCost", "distinct_bytes",
           "edge_scatter", "innovation", "trim_gather", "trimmed_mean",
           "attn_decode", "attn_decode_merge", "swa_prefill", "band_pairs",
           "wkv6", "wkv6_ops", "wkv6_floor_bytes", "WKV_HEAD"]

WKV_HEAD = 64         # K7's K = V
WKV_CHUNK = 64        # K7's chunk


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """One launch: the wrapper's name (as ``chip_smoke.py`` keys its
    counts) and its counts."""

    kernel: str
    flops: float
    fp32_ops: float
    bytes: float


def distinct_bytes(t) -> int:
    """The bytes of ``t``'s distinct elements: a dimension of stride 0 (a
    broadcast) counts once."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size() if t.numel() else 0


# ---------------------------------------------------------------------------
# the engines' kernels: K1-K3, and K4 of training
# ---------------------------------------------------------------------------

def edge_scatter(n: int, n_src: int, E: int, D: int,
                 storage_bytes: int = 4) -> KernelCost:
    """K1: sigma (n_src, D) and rho (E, D) in storage, live (E,) bool, src
    (E,) and the offsets (n + 1,) int32 read; rho_new (E, D) in storage and
    recv (n, D) float32 written; two operations a row element."""
    sb = storage_bytes
    moved = (n_src * D * sb + 2 * E * D * sb + E + 4 * E + 4 * (n + 1)
             + 4 * n * D)
    return KernelCost("edge_scatter", 0, 2 * E * D, moved)


def innovation(N: int, m: int, S: int, storage_bytes: int = 4
               ) -> KernelCost:
    """K2: z (N, m) and mass (N,) in storage, u (N,), cdf (N, S) and the
    log tables (N, m, S) float32 read; z_new in storage and mu (N, m)
    float32 written; a CDF search and m softmax terms an agent."""
    sb = storage_bytes
    moved = (2 * N * m * sb + N * sb + 4 * N + 4 * N * S + 4 * N * m * S
             + 4 * N * m)
    return KernelCost("social_innov", 0, N * (S + m * 8), moved)


def trim_gather(N: int, P: int, dm: int, F: int, storage_bytes: int = 4,
                lie_bytes: int = 4, f_tensor: bool = False) -> KernelCost:
    """K3: r (N, P) in storage, nbr_idx (N, dm) int32, nbr_valid and
    byz_nbr (N, dm) bool, the lies' distinct ``lie_bytes`` (4: one
    stride-0 float32) and a per-receiver F (N,) int32 read; tsum (N, P)
    and kept (N,) float32 written; a compare in each of the 2F extraction
    rounds and one add a (receiver, coordinate, slot)."""
    moved = (N * P * storage_bytes + 4 * N * dm + 2 * N * dm + lie_bytes
             + (4 * N if f_tensor else 0) + 4 * N * P + 4 * N)
    return KernelCost("byz_trim", 0, N * P * dm * (2 * F + 1),
                      moved)


def trimmed_mean(W: int, D: int, F: int) -> KernelCost:
    """K4: x (W, D) float32 read, (D,) written; a compare in each of the
    2F extraction rounds and one add a coordinate and worker."""
    return KernelCost("trimmed_mean", 0, D * W * (2 * F + 1),
                      4 * W * D + 4 * D)


# ---------------------------------------------------------------------------
# the attention kernels: K5 (decode, its rank-partial mode and merge), K6
# ---------------------------------------------------------------------------

def attn_decode(B: int, H: int, Hkv: int, rows: int, dh: int,
                itemsize: int, partial: bool = False) -> KernelCost:
    """K5 over ``rows`` valid cache rows: q (B, H, dh), the rows of K and
    V, lengths (B,) int32 read; the output (B, H, dh) written (with
    ``partial`` the float32 triple acc (B, H, dh), m and l (B, H)); 4 dh
    operations a (request, query head, row): on the tensor cores in bf16,
    the FMA pipes in float32."""
    moved = B * H * dh * itemsize + 2 * B * Hkv * rows * dh * itemsize \
        + 4 * B
    moved += (4 * B * H * dh + 8 * B * H) if partial \
        else B * H * dh * itemsize
    ops = 4 * B * H * rows * dh
    name = "attn_decode_partial" if partial else "attn_decode"
    if itemsize == 2:
        return KernelCost(name, ops, 0, moved)
    return KernelCost(name, 0, ops, moved)


def attn_decode_merge(n: int, B: int, H: int, dh: int, out_itemsize: int
                      ) -> KernelCost:
    """K5's combine over n triples: acc (n, B, H, dh), m and l (n, B, H)
    float32 read, (B, H, dh) written; 4 operations an element of acc."""
    moved = 4 * n * B * H * (dh + 2) + B * H * dh * out_itemsize
    return KernelCost("attn_decode_merge", 0, 4 * n * B * H * dh,
                      moved)


def band_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal row band holds: S (S + 1) / 2, or with
    a window w < S, w (w + 1) / 2 + (S - w) w."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def swa_prefill(B: int, S: int, H: int, Hkv: int, dh: int, window: int,
                itemsize: int) -> KernelCost:
    """K6: q (B, S, H, dh), k and v (B, S, Hkv, dh) read, the output
    (B, S, H, dh) written; 2 dh operations for a pair's score and 2 dh for
    its share of P.V: the tensor-core kernel in bf16, the FMA kernel in
    float32."""
    moved = (2 * B * S * H * dh + 2 * B * S * Hkv * dh) * itemsize
    ops = 4 * dh * B * H * band_pairs(S, window)
    if itemsize == 2:
        return KernelCost("swa_prefill", ops, 0, moved)
    return KernelCost("swa_prefill", 0, ops, moved)


# ---------------------------------------------------------------------------
# K7: the chunked WKV6 scan
# ---------------------------------------------------------------------------

def wkv6_ops(BH: int, T: int, G: int) -> tuple[int, int]:
    """(tensor-core FLOPs, FMA-pipe operations) of K7 over BH sequences of
    T bf16 tokens, as its three passes compute them: every chunk padded to
    64 rows, K = V = 64; a product of two split (hi + lo) operands counted
    three times, of a split one and v (exact in bf16) twice; an
    exponential counted as one operation. Per chunk, pass 1: the decayed
    keys and the state update; pass 3: the scan, the decayed keys again,
    the inter-chunk product, the anchored off-diagonal scores (sub-chunks
    1-3), the diagonal sub-blocks pairwise (4 x 120 x 64 terms of 5
    operations) with the bonus on their diagonal, scores @ v and the state
    update; pass 2: one fma per state element a group."""
    C = K = V = WKV_HEAD
    mv = 2
    n_chunks = -(-T // C)
    prior = 16 + 32 + 48                       # key rows before sub-chunks
    tc = (mv * 2 * C * K * V                   # pass 1: state
          + 3 * 2 * C * K * V                  # inter-chunk
          + 3 * 2 * 16 * K * prior             # off-diagonal scores
          + mv * 2 * 16 * V * (prior + 64)     # scores @ v, j <= the block
          + mv * 2 * C * K * V)                # pass 3: state
    fma = (2 * (C * K + 3 * C * K + K * V + K)  # scan, k_dec, decay, exp
           + 2 * C * K                         # r . exp(E)
           + 3 * 16 * K * 3 + 3 * K * prior    # decayed q and k
           + 4 * 120 * K * 5                   # diagonal sub-blocks
           + 3 * C * K)                        # bonus
    groups = -(-n_chunks // G)
    return BH * n_chunks * tc, BH * (n_chunks * fma + groups * 2 * K * V)


def wkv6_floor_bytes(BH: int, T: int, itemsize: int, G: int) -> int:
    """Bytes K7's design must move: k, v and lw read by passes 1 and 3, r
    and u by pass 3, y written once; each group's state written by pass 1,
    read and rewritten by pass 2, read by pass 3, and its decay written and
    read; the final state written once."""
    K = WKV_HEAD
    groups = -(-T // (WKV_CHUNK * G))
    seq = T * K * (2 * (2 * itemsize + 4) + 2 * itemsize)
    state = groups * (4 * K * K * 4 + 2 * K * 4) + K * K * 4 + K * 4
    return BH * (seq + state)


def wkv6(BH: int, T: int, itemsize: int, G: int, u_rows: int) -> KernelCost:
    """K7: r, k, v (BH, T, 64) in their dtype, lw float32 and u's
    ``u_rows`` distinct (64,) float32 rows read; y in r's dtype and the
    final state (BH, 64, 64) float32 written; :func:`wkv6_ops`."""
    K = WKV_HEAD
    moved = BH * T * K * (4 * itemsize + 4) + 4 * BH * K * K \
        + 4 * u_rows * K
    tc, fma = wkv6_ops(BH, T, G)
    return KernelCost("wkv6", tc, fma, moved)
