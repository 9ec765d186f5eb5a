"""Fast robust push-sum over packet-dropping links — the consensus half of
Algorithms 1 and 3.

The port of the synchronous path of ``repro.core.pushsum``. Each agent
keeps a value ``z`` (N, d) and a mass ``m`` (N,), its cumulative offer
``sigma`` per out-link, and each directed link keeps the cumulative value
``rho`` its receiver last heard. One round stages the send, lets every
operational link latch the sender's new cumulative, integrates the
increments at the receivers and re-stages (Su '18 Alg. 1).

Two state representations, as in the reference:

* **dense** (:class:`PushSumState`, ``rho`` (N, N, d)): the executable spec
  the sparse engine is tested against, for small N only;
* **sparse edge-list** (:class:`SparsePushSumState`, ``rho`` (E, d+1)):
  the engine; :func:`run_pushsum_sparse` runs it for T rounds with the
  delivery through the CUDA edge scatter on the card.

Layout: value and mass live in ONE (·, d+1) tensor whose last column is
the mass — ``zm`` (N, d+1), ``sigma_zm`` (N, d+1), ``rho_zm`` (E, d+1) —
so the edge scatter handles both recursions in one pass with no per-round
concat or split. ``z``/``m``/``sigma``/``sigma_m``/``rho``/``rho_m`` are
views of the reference's six fields.

The sparse step carries the fault plane (:mod:`.faults`: churn masks a
dead agent's edges and freezes its rows of ``zm`` and ``sigma_zm``) and
the async plane (:mod:`.asyncrony`: awake senders latch the per-edge
buffer, which K1 then delivers as its source rows), and the precision
policy (:mod:`.precision`: every field stored at the storage dtype, the
staging in the compute dtype, the receiver sums in the accum dtype).

**Edge partitioning** (``graph_axis=``, a :class:`GraphAxis`): the edge
index is cut into S dst-contiguous shards
(:func:`repro_torch.core.graphs.partition_edge_list`), node state stays
replicated, and each round's receiver partials are summed over the
shards, by an all-reduce (``halo="psum"``) or a reduce-scatter, a cast to
the storage dtype and an all-gather (``halo="scatter"``). Two axes run
the same program: :class:`EmulatedAxis` holds all S shards in one process
and runs them in one K1 launch (shard j's receivers offset to ``j n +
v``), :class:`GroupAxis` holds one shard a rank of a ``torch.distributed``
process group (a device mesh's ``graph`` dimension).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.pushsum_edge import dst_offsets, edge_scatter
from ..statics.contracts import contract as statics_contract
from .asyncrony import (AsyncBuffer, AsyncModel, async_stream_fold,
                        init_async_buffer, is_degenerate_async, wake_rows)
from .faults import (ENGINE_PUSHSUM, FAULT_CHURN, FAULT_EDGE, FaultModel,
                     FaultState, advance_faults, fault_stream_fold,
                     faulty_edge_mask, freeze, init_fault_state)
from .graphs import EdgeList, _dst_offsets, is_dst_sorted
from .plan import HALO_VARIANTS, ExecutionPlan, check_plan, resolve_device
from .precision import HALF_DTYPES, policy_dtypes
from .prng import Key, fold_in, fold_rounds, prng_key, uniform

__all__ = [
    "PushSumState",
    "init_state",
    "pushsum_step",
    "ratios",
    "run_pushsum",
    "mass_invariant",
    "SparsePushSumState",
    "init_sparse_state",
    "sparse_pushsum_step",
    "sparse_ratios",
    "sparse_mass_invariant",
    "run_pushsum_sparse",
    "step_edge_mask",
    "edge_mask",
    "PlaneRounds",
    "GraphAxis",
    "EmulatedAxis",
    "GroupAxis",
    "shard_edge_mask",
    "partitioned_edges",
]


# ---------------------------------------------------------------------------
# Dense reference implementation
# ---------------------------------------------------------------------------

class PushSumState(NamedTuple):
    z: torch.Tensor        # (N, d) value
    m: torch.Tensor        # (N,)   mass
    sigma: torch.Tensor    # (N, d) cumulative value offered per out-link
    sigma_m: torch.Tensor  # (N,)
    rho: torch.Tensor      # (N, N, d) cumulative value heard per in-link
    rho_m: torch.Tensor    # (N, N)


def init_state(w: torch.Tensor) -> PushSumState:
    """w: (N, d) initial values; push-sum drives z/m -> mean(w)."""
    n, d = w.shape
    zeros = functools.partial(torch.zeros, dtype=w.dtype, device=w.device)
    return PushSumState(z=w, m=torch.ones_like(w[:, 0]), sigma=zeros((n, d)),
                        sigma_m=zeros(n), rho=zeros((n, n, d)),
                        rho_m=zeros((n, n)))


def pushsum_step(
    state: PushSumState,
    mask: torch.Tensor,   # (N, N) bool — operational links this round
    adj: torch.Tensor,    # (N, N) bool — underlying topology (defines d_out)
) -> PushSumState:
    """One dense round. The mask is intersected with the topology, so a
    stray True on a non-edge never touches relay state."""
    z, m, sigma, sigma_m, rho, rho_m = state
    share = 1.0 / (adj.sum(dim=1).to(z.dtype) + 1.0)     # (N,)
    # first half: stage the cumulative send
    sigma_p = sigma + z * share[:, None]
    sigma_m_p = sigma_m + m * share
    # delivery: operational existing links latch the new cumulative
    live = mask & adj
    rho_new = torch.where(live[:, :, None], sigma_p[:, None, :], rho)
    rho_m_new = torch.where(live, sigma_m_p[:, None], rho_m)
    recv = (rho_new - rho).sum(dim=0)
    recv_m = (rho_m_new - rho_m).sum(dim=0)
    # integrate, then re-stage at once
    z_p = z * share[:, None] + recv
    m_p = m * share + recv_m
    return PushSumState(z_p * share[:, None], m_p * share,
                        sigma_p + z_p * share[:, None], sigma_m_p + m_p * share,
                        rho_new, rho_m_new)


def ratios(state: PushSumState) -> torch.Tensor:
    """The push-sum estimate z/m per agent, (N, d)."""
    return state.z / state.m.clamp_min(1e-30)[:, None]


def run_pushsum(
    w,                    # (N, d) inputs
    adj,                  # (N, N) bool topology
    masks,                # (T, N, N) bool operational-link schedule
    record_every: int = 1,
    *,
    device=None,
) -> tuple[PushSumState, torch.Tensor]:
    """Run T dense rounds -> final state and the (T // record_every, N, d)
    ratios after rounds ``record_every - 1, 2 record_every - 1, ...``.
    ``device=None`` means the card."""
    dev = resolve_device(device)
    adj = torch.as_tensor(adj, dtype=torch.bool, device=dev)
    masks = torch.as_tensor(masks, dtype=torch.bool, device=dev)
    state = init_state(torch.as_tensor(w, dtype=torch.float32, device=dev))
    traj = []
    for t in range(masks.shape[0]):
        state = pushsum_step(state, masks[t], adj)
        if (t + 1) % record_every == 0:
            traj.append(ratios(state))
    return state, _frames(traj, state.z)


def mass_invariant(state: PushSumState, adj: torch.Tensor) -> torch.Tensor:
    """sum_j z_j + sum_{(j', j) in E} (sigma_j' - rho_j'j), (d,): equal to
    sum_j w_j, the mass preservation Theorem 1 relies on."""
    adj_f = adj.to(state.z.dtype)
    in_flight = ((state.sigma[:, None, :] - state.rho)
                 * adj_f[:, :, None]).sum(dim=(0, 1))
    return state.z.sum(dim=0) + in_flight


def _frames(frames: list[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """Recorded (N, d) frames stacked to (K, N, d), (0, N, d) if none."""
    return torch.stack(frames) if frames else like.new_zeros((0, *like.shape))


# ---------------------------------------------------------------------------
# Sparse edge-list implementation
# ---------------------------------------------------------------------------


class SparsePushSumState(NamedTuple):
    zm: torch.Tensor        # (N, d+1) value columns, then the mass column
    sigma_zm: torch.Tensor  # (N, d+1) cumulative offered per out-link
    rho_zm: torch.Tensor    # (E, d+1) cumulative heard, per directed edge

    @property
    def z(self) -> torch.Tensor:
        return self.zm[:, :-1]

    @property
    def m(self) -> torch.Tensor:
        return self.zm[:, -1]

    @property
    def sigma(self) -> torch.Tensor:
        return self.sigma_zm[:, :-1]

    @property
    def sigma_m(self) -> torch.Tensor:
        return self.sigma_zm[:, -1]

    @property
    def rho(self) -> torch.Tensor:
        return self.rho_zm[:, :-1]

    @property
    def rho_m(self) -> torch.Tensor:
        return self.rho_zm[:, -1]

    def to_numpy(self) -> dict[str, np.ndarray]:
        """The reference's six fields as numpy arrays, by name."""
        return {f: getattr(self, f).detach().cpu().numpy()
                for f in ("z", "m", "sigma", "sigma_m", "rho", "rho_m")}


def init_sparse_state(w: torch.Tensor, n_edges: int,
                      policy=None) -> SparsePushSumState:
    """w: (N, d) initial values; ``n_edges`` the (padded) edge count E.
    Mass starts at 1, every cumulative at 0. ``policy`` (a
    :class:`repro_torch.core.precision.Policy`, a name or ``None``) sets
    the storage dtype of every field; ``None`` keeps ``w.dtype``."""
    n, d = w.shape
    dt = policy_dtypes(policy, w.dtype)[0]
    ones = torch.ones((n, 1), dtype=dt, device=w.device)
    return SparsePushSumState(
        zm=torch.cat([w.to(dt), ones], dim=1),
        sigma_zm=torch.zeros((n, d + 1), dtype=dt, device=w.device),
        rho_zm=torch.zeros((n_edges, d + 1), dtype=dt, device=w.device),
    )


def _out_degree(src: torch.Tensor, valid: torch.Tensor, n: int,
                dtype=torch.float32) -> torch.Tensor:
    """(N,) out-degree over valid edges."""
    return torch.zeros(n, dtype=dtype, device=src.device).index_add_(
        0, src, valid.to(dtype))


def _axis_out_degree(src, valid, n: int, graph_axis, dtype=torch.float32):
    """(n,) out-degree over the valid edges of every shard of
    ``graph_axis`` (or of the edge index, without one)."""
    d_out = _out_degree(src, valid, n, dtype)
    return d_out if graph_axis is None else graph_axis.allreduce(d_out)


def _draw_edges(n_held: int, K: int, graph_axis) -> int:
    """The edge count of one scenario's link draw: its E, or under
    ``graph_axis`` its padded E_pad (n_shards e_shard), from the ``n_held``
    edge slots a process holds for K scenarios."""
    if graph_axis is None:
        return n_held // K
    return graph_axis.n_shards * (n_held // (K * graph_axis.local))


def _receivers(dst, n: int, graph_axis):
    """Each edge's receiver node: ``dst`` itself, or under ``graph_axis``
    the node of its receiver slot (slots ``j n + v``)."""
    return dst if graph_axis is None else dst % n


def edge_index_tensors(el: EdgeList, e_max: int | None = None):
    """A single edge index as the engines' CPU tensors -> ``(src, dst,
    valid, offsets)``. ``e_max`` pads the edge axis with inert
    ``valid=False`` edges whose ``dst = N - 1``, which keeps a sorted
    layout sorted; ``offsets`` is the (N+1,) int32 CSR offsets of ``dst``
    when it is dst-sorted (the CUDA edge scatter's hoisted argument), else
    ``None``."""
    if el.is_batched:
        raise ValueError("pass one topology draw")
    src, dst, valid = el.src, el.dst, el.valid
    if e_max is not None:
        pad = e_max - el.E
        if pad < 0:
            raise ValueError(f"e_max={e_max} < edge count {el.E}")
        src = np.concatenate([src, np.zeros(pad, np.int32)])
        dst = np.concatenate([dst, np.full(pad, el.n - 1, np.int32)])
        valid = np.concatenate([valid, np.zeros(pad, bool)])
    for name, idx in (("src", src), ("dst", dst)):
        if idx.size and not (idx.min() >= 0 and idx.max() < el.n):
            raise ValueError(f"{name} indices must lie in [0, {el.n})")
    offsets = (torch.from_numpy(_dst_offsets(dst, el.n))
               if is_dst_sorted(dst) else None)
    return (torch.tensor(src, dtype=torch.int32),
            torch.tensor(dst, dtype=torch.int32),
            torch.tensor(valid, dtype=torch.bool), offsets)


class GraphAxis:
    """The graph axis of the edge-partitioned step: ``n_shards`` edge shards
    of one graph, of which this process holds ``local``, from shard
    ``first`` on.

    The edges a process holds are laid out shard-major, (local, K, e_shard)
    for K scenarios, and local shard j's receivers are the slots ``j n +
    v`` of the replicated node rows v (``n = K N``), so one K1 launch over
    ``local n`` receivers gives every local shard's partials
    (:func:`partitioned_edges` builds the layout). :meth:`psum` and
    :meth:`scatter` sum the (local, n, D) partials in shard order and then
    over the processes of the axis; :meth:`allreduce` sums a value over
    the processes (the out-degree, the in-flight mass).

    ``GraphAxis.wire_bytes`` counts the wire bytes of the halo combines,
    every call on every axis, as a ring over S members moves them: ``2
    (S-1)/S`` of the combined partials for the all-reduce, ``(S-1)/S`` of
    the accum-dtype partials in and of the storage-dtype block out for
    the reduce-scatter and the all-gather; an emulated axis counts what a
    mesh of S would move."""

    wire_bytes = 0.0

    n_shards: int
    local: int
    first: int

    def window(self, x: torch.Tensor) -> torch.Tensor:
        """A draw over the full padded edge axis, (..., S e_shard), as the
        held shards' slots in their layout, (local, ..., e_shard)."""
        S = self.n_shards
        x = x.unflatten(-1, (S, x.shape[-1] // S))
        return x[..., self.first:self.first + self.local, :].movedim(-2, 0)

    def allreduce(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _reduce_scatter_gather(self, x: torch.Tensor,
                               storage: torch.dtype) -> torch.Tensor:
        raise NotImplementedError

    def psum(self, parts: torch.Tensor) -> torch.Tensor:
        """(local, n, D) receiver partials -> (n, D), summed over every
        shard of the axis."""
        out = _shard_order_sum(parts)
        S = self.n_shards
        GraphAxis.wire_bytes += 2 * (S - 1) / S * out.numel() * \
            out.element_size()
        return self.allreduce(out)

    def scatter(self, parts: torch.Tensor,
                storage: torch.dtype) -> torch.Tensor:
        """(local, n, D) receiver partials -> (n, D) in their dtype: the sum
        over every shard, reduce-scattered in row blocks of ``ceil(n / S)``,
        each block cast to ``storage``, then all-gathered and cast back."""
        out = _shard_order_sum(parts)
        n, S = out.shape[0], self.n_shards
        pad = (-n) % S
        if pad:
            out = torch.cat([out, out.new_zeros((pad, out.shape[1]))])
        ring = (S - 1) / S * out.numel()
        GraphAxis.wire_bytes += ring * (
            out.element_size() + torch.empty((), dtype=storage).element_size())
        return self._reduce_scatter_gather(out, storage).to(out.dtype)[:n]


def _shard_order_sum(parts: torch.Tensor) -> torch.Tensor:
    """(local, n, D) -> (n, D), added shard after shard."""
    out = parts[0]
    for j in range(1, parts.shape[0]):
        out = out + parts[j]
    return out


class EmulatedAxis(GraphAxis):
    """All ``n_shards`` shards in this process: the reference's one-device
    emulation of the mesh program. Its collectives are the shard-order
    sums; every shard's partials come from one K1 launch."""

    def __init__(self, n_shards: int):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards, self.local, self.first = int(n_shards), int(n_shards), 0

    def allreduce(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def _reduce_scatter_gather(self, x, storage):
        return x.to(storage)

    def __repr__(self) -> str:
        return f"EmulatedAxis({self.n_shards})"


class GroupAxis(GraphAxis):
    """One shard a rank of a ``torch.distributed`` process group (a device
    mesh's graph dimension, ``mesh["graph"].get_group()``): the shard of
    its rank in the group, combined by ``all_reduce``, or by
    ``reduce_scatter_tensor`` and ``all_gather_into_tensor``. A failed
    collective raises."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group
        self.n_shards = dist.get_world_size(group)
        self.local, self.first = 1, dist.get_rank(group)

    def allreduce(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        x = x.contiguous()
        dist.all_reduce(x, group=self.group)
        return x

    def _reduce_scatter_gather(self, x, storage):
        S = self.n_shards
        part = x.new_empty((x.shape[0] // S, x.shape[1]))
        collective("reduce_scatter")(part, x.contiguous(), group=self.group)
        out = x.new_empty(x.shape, dtype=storage)
        collective("all_gather")(out, part.to(storage), group=self.group)
        return out

    def __repr__(self) -> str:
        return f"GroupAxis(shard {self.first} of {self.n_shards})"


def collective(op: str):
    """``torch.distributed``'s one-tensor ``"all_gather"`` or
    ``"reduce_scatter"`` (``*_single``, named ``*_into_tensor`` /
    ``*_tensor`` before torch 2.13): ``fn(output, input, group=...)``."""
    import torch.distributed as dist

    old = {"all_gather": "all_gather_into_tensor",
           "reduce_scatter": "reduce_scatter_tensor"}[op]
    return getattr(dist, f"{op}_single", None) or getattr(dist, old)


def partitioned_edges(src, dst, valid, n: int, graph_axis: GraphAxis):
    """K scenarios' edge shards, (K, S, e_shard) numpy arrays of one
    :class:`repro_torch.core.graphs.EdgeShards` layout each (node ids in
    ``[0, n)``), as the held shards' CPU tensors -> ``(src, dst, valid,
    offsets)`` over K n replicated node rows.

    The layout is shard-major, (local, K, e_shard): ``src`` holds node
    ids ``k n + u``, ``dst`` the receiver slots ``(j K + k) n + v`` of
    local shard j, and ``offsets`` the (local K n + 1,) CSR offsets of
    ``dst``, which is sorted."""
    src, dst, valid = (np.asarray(a)[:, graph_axis.first:
                                     graph_axis.first + graph_axis.local]
                       for a in (src, dst, valid))
    K, local = src.shape[:2]
    k = np.arange(K, dtype=np.int64)[:, None, None] * n
    j = np.arange(local, dtype=np.int64)[None, :, None] * (K * n)

    def flat(a):
        return np.ascontiguousarray(a.transpose(1, 0, 2)).reshape(-1)

    slots = flat(dst + k + j)
    if slots.size and slots.max() >= 2**31:
        raise ValueError("the partitioned receivers exceed int32")
    return (torch.from_numpy(flat(src + k).astype(np.int32)),
            torch.from_numpy(slots.astype(np.int32)),
            torch.from_numpy(flat(valid)),
            torch.from_numpy(_dst_offsets(slots, local * K * n)))


def sparse_pushsum_step(
    state: SparsePushSumState,
    mask: torch.Tensor,    # (E,) bool — operational edges this round
    src: torch.Tensor,     # (E,) int32 sender per edge
    dst: torch.Tensor,     # (E,) int32 receiver per edge
    valid: torch.Tensor,   # (E,) bool — False on padding edges
    backend: str = "auto",
    *,
    share: torch.Tensor | None = None,
    offsets: torch.Tensor | None = None,
    faults: FaultState | None = None,
    awake: torch.Tensor | None = None,
    abuf: AsyncBuffer | None = None,
    staleness: torch.Tensor | None = None,
    policy=None,
    graph_axis: GraphAxis | None = None,
    halo: str = "psum",
) -> SparsePushSumState | tuple[SparsePushSumState, AsyncBuffer]:
    """One fast-robust-push-sum round on edge-list state.

    ``share`` optionally supplies the hoisted (N,) ``1 / (d_out + 1)``
    factors of the fixed edge index. ``offsets`` optionally supplies the
    hoisted (N+1,) CSR offsets of a dst-sorted index for the CUDA edge
    scatter (:func:`repro_torch.kernels.pushsum_edge.edge_scatter`). The
    mask is intersected with ``valid``, so padding edges never carry mass.

    ``faults`` (a :class:`repro_torch.core.faults.FaultState`): an edge
    with a dead end is down and a dead agent's rows of ``zm`` and
    ``sigma_zm`` are frozen; per-edge ``rho`` needs no freeze (a masked
    edge never latches).

    ``awake`` (N,) bool + ``abuf`` + ``staleness`` (0-d, or (E,) per
    edge), all three together, run one async tick and return ``(state,
    abuf)``: awake (and live) senders latch ``sigma_p[src]`` into their
    edges' buffer slots, and K1 delivers the slots (its source rows, with
    the identity source index) where the link is up, the receiver awake
    and the slot at most ``staleness`` ticks old; asleep agents' rows are
    frozen. The degenerate model gives the synchronous step bit for bit.

    ``policy`` (:mod:`repro_torch.core.precision`) keeps the reference's
    cast points: the send is staged in the compute dtype and quantized to
    storage before delivery, K1 sums each receiver's increments in the
    accum dtype, the integration adds them in accum, and the re-stage
    reads the quantized send back, so a receiver latches exactly what the
    sender keeps and the telescoping sums re-measure the rounding every
    round. ``None`` keeps the state's dtype throughout (the pre-policy
    program; ``"fp32"`` is the same program).

    ``graph_axis`` (a :class:`GraphAxis`) runs the round edge-partitioned:
    the edge arguments and ``rho_zm`` hold the axis' shards in the layout
    of :func:`partitioned_edges` (``dst`` the receiver slots), node state
    is replicated, and the (local, n, D) receiver partials of the one K1
    launch are summed over the shards, by :meth:`GraphAxis.psum`
    (``halo="psum"``) or :meth:`GraphAxis.scatter` (``"scatter"``: the
    reduced rows cast to the storage dtype before the gather, so not bit
    for bit the ``"psum"`` round). A receiver whose in-edges lie on at most
    two shards gets the same sum on either axis; against the unsharded
    round on the padded edge list it is the same where its in-edges lie
    on one shard. Without ``share`` the out-degree is summed over the
    axis. The async plane does not go with a graph axis (``ValueError``).
    """
    if halo not in HALO_VARIANTS:
        raise ValueError(f"halo={halo!r} not in {HALO_VARIANTS}")
    if graph_axis is not None and abuf is not None:
        raise ValueError(
            "async mode does not compose with graph_axis edge partitioning "
            "(the per-edge buffer would need halo state)")
    zm, sigma_zm, rho_zm = state
    n = zm.shape[0]
    st, cp, ac = policy_dtypes(policy, zm.dtype)
    if share is None:
        share = 1.0 / (_axis_out_degree(src, valid, n, graph_axis, cp) + 1.0)
    share = share.to(cp)[:, None]
    # first half: stage the cumulative send (compute), quantize to storage;
    # the quantized value is delivered AND re-staged
    sigma_p = (sigma_zm.to(cp) + zm.to(cp) * share).to(st)
    if faults is not None:
        # a dead endpoint takes the edge down in both directions
        receiver = _receivers(dst, n, graph_axis)
        mask = mask & faults.node_live[src] & faults.node_live[receiver]
    live = mask & valid
    abuf_new = None
    if abuf is not None:
        send = awake[src] & valid
        if faults is not None:
            send = send & faults.node_live[src]
        snap = torch.where(send[:, None], sigma_p[src], abuf.snap)
        age = torch.where(send, 0, abuf.age + 1)
        abuf_new = AsyncBuffer(snap=snap, age=age)
        live = live & awake[dst] & (age <= staleness)
        ident = torch.arange(src.shape[0], dtype=torch.int32,
                             device=src.device)
        rho_new, recv = edge_scatter(snap, rho_zm, live, ident, dst, backend,
                                     offsets=offsets, n_recv=n,
                                     accum_dtype=ac)
    else:
        # delivery + integration: operational edges latch the new cumulative
        local = 1 if graph_axis is None else graph_axis.local
        rho_new, recv = edge_scatter(sigma_p, rho_zm, live, src, dst,
                                     backend, offsets=offsets,
                                     n_recv=local * n, shards=local,
                                     accum_dtype=ac)
        if graph_axis is not None:
            # the halo combine: a receiver on one shard adds exact +0.0
            # partials from the others
            parts = recv.view(local, n, -1)
            recv = (graph_axis.psum(parts) if halo == "psum"
                    else graph_axis.scatter(parts, st))
    zm_p = (zm.to(cp) * share).to(ac) + recv
    # second half: re-stage at once, down to storage
    zm_pc = zm_p.to(cp)
    zm_n = (zm_pc * share).to(st)
    sigma_n = (sigma_p.to(cp) + zm_pc * share).to(st)
    for on in (awake, None if faults is None else faults.node_live):
        if on is not None:
            # asleep or dead agents do nothing: their rows carry over
            zm_n = freeze(on, zm_n, zm)
            sigma_n = freeze(on, sigma_n, sigma_zm)
    new = SparsePushSumState(zm=zm_n, sigma_zm=sigma_n, rho_zm=rho_new)
    return new if abuf is None else (new, abuf_new)


def _full(x: torch.Tensor) -> torch.Tensor:
    """A half-storage tensor upcast to float32; others as they are."""
    return x.float() if x.dtype in HALF_DTYPES else x


def sparse_ratios(state: SparsePushSumState) -> torch.Tensor:
    """The push-sum estimate z/m per agent, (N, d). A half-storage state
    is upcast to float32 first (the 1e-30 mass floor underflows in half
    precision), as in the reference."""
    zm = _full(state.zm)
    return zm[:, :-1] / zm[:, -1].clamp_min(1e-30)[:, None]


def sparse_mass_invariant(
    state: SparsePushSumState, src: torch.Tensor, valid: torch.Tensor,
    *, graph_axis: GraphAxis | None = None,
) -> torch.Tensor:
    """sum_j zm_j + sum_{e valid} (sigma_zm[src[e]] - rho_zm[e]), (d+1,).

    The first d entries are the reference's invariant (``sum_j w_j``); the
    last is the total mass, which push-sum conserves at N. A half-storage
    state is upcast to float32 before the sums. Under ``graph_axis`` the
    in-flight term of the held shards is summed over the axis, the
    replicated node sum counted once."""
    zm, sigma, rho = (_full(x) for x in state)
    held = (sigma[src] - rho) * valid.to(zm.dtype)[:, None]
    if graph_axis is None:
        return zm.sum(dim=0) + held.sum(dim=0)
    in_flight = _shard_order_sum(
        held.view(graph_axis.local, -1, held.shape[1]).sum(dim=1))
    return zm.sum(dim=0) + graph_axis.allreduce(in_flight)


def step_edge_mask(
    key: Key,
    t: int,
    n_edges: int,
    drop_prob: torch.Tensor,
    B: torch.Tensor,
    fold_t: int | None = None,
) -> torch.Tensor:
    """(E,) operational mask for round t: i.i.d. Bernoulli keep with forced
    delivery at ``t % B == B - 1`` (the paper's B-connectivity window).

    ``fold_t`` overrides the fold-in value (default ``t``) so an engine
    with several streams per iteration gives the link mask its own fold
    domain while the B-window still runs on the iteration ``t``.
    ``drop_prob`` and ``B`` are 0-d tensors on the device the mask is drawn
    on; nothing is read back to the host. A batch of K scenarios passes a
    tensor of K keys of shape (K, 1) with ``drop_prob`` and ``B`` of shape
    (K,), and gets their (K·E,) masks, scenario k's at ``[k E, (k+1) E)``.
    """
    return edge_mask(fold_in(key, t if fold_t is None else fold_t), t,
                     n_edges, drop_prob, B)


def edge_mask(kt: Key, t: int, n_edges: int, drop_prob: torch.Tensor,
              B: torch.Tensor,
              graph_axis: GraphAxis | None = None) -> torch.Tensor:
    """:func:`step_edge_mask` from the round's already-folded key ``kt``
    (one key, or a (K, 1) tensor of keys with (K,) ``drop_prob`` and
    ``B``) -> (E,) or (K·E,). Under ``graph_axis``, ``n_edges`` is the
    padded E_pad of one scenario and the result the held shards' window in
    their layout, (local·K·e_shard,)."""
    up = uniform(kt, n_edges, drop_prob.device) >= drop_prob[..., None]
    mask = up | ((t % B) == (B - 1))[..., None]
    if graph_axis is not None:
        mask = graph_axis.window(mask)
    return mask.reshape(-1)


def shard_edge_mask(key: Key, t: int, e_shard: int, drop_prob: torch.Tensor,
                    B: torch.Tensor, *, graph_axis: GraphAxis,
                    fold_t: int | None = None) -> torch.Tensor:
    """The held shards' window of round t's operational mask: the full
    padded (n_shards e_shard,) draw of :func:`step_edge_mask`, then the
    held shards' slots, so a sharded run masks every edge slot as the
    unsharded run on ``EdgeShards.padded_edge_list()`` does."""
    return edge_mask(fold_in(key, t if fold_t is None else fold_t), t,
                     graph_axis.n_shards * e_shard, drop_prob, B, graph_axis)


class PlaneRounds(NamedTuple):
    """The fault and async planes of one engine loop, set up once: the
    models on the device as (1 | K,) columns, every round's fault and
    wake keys folded on the host up front, and the per-edge staleness.
    ``None`` fields are planes that are off."""

    faults: FaultModel | None
    edge_keys: Key | None     # (T, K, 1) FAULT_EDGE keys
    churn_keys: Key | None    # (T, K, 1) FAULT_CHURN keys
    async_: AsyncModel | None
    wake_keys: Key | None     # (T, K, 1) wake keys
    staleness: torch.Tensor | None   # (K·E,) int32, each edge's bound

    @staticmethod
    def build(key: Key, T: int, engine: int, faults: FaultModel | None,
              async_: AsyncModel | None, n_edges: int,
              device) -> "PlaneRounds":
        """``n_edges`` is one scenario's E; ``key`` one key or K words."""
        fe = fc = wk = stale = None
        if faults is not None:
            faults = faults.to(device)
            fe, fc = (fold_rounds(key, [fault_stream_fold(t, engine, s)
                                        for t in range(T)], device)
                      for s in (FAULT_EDGE, FAULT_CHURN))
        if async_ is not None:
            async_ = async_.to(device)
            wk = fold_rounds(key, [async_stream_fold(t, engine)
                                   for t in range(T)], device)
            stale = async_.staleness.reshape(-1, 1).expand(
                -1, n_edges).reshape(-1)
        return PlaneRounds(faults, fe, fc, async_, wk, stale)

    def init(self, n_nodes: int, n_edges: int, d: int, device,
             dtype: torch.dtype = torch.float32):
        """The loop's initial fault state and async buffer (``None`` for a
        plane that is off); sizes are the stacked K·N and K·E, ``dtype``
        the buffer's (the state's storage dtype)."""
        fs = (None if self.faults is None
              else init_fault_state(n_nodes, n_edges, device))
        abuf = (None if self.async_ is None
                else init_async_buffer(n_edges, d, dtype, device=device))
        return fs, abuf

    def step(self, t: int, fs: FaultState | None, n_nodes: int,
             graph_axis: GraphAxis | None = None):
        """Round t's fault state (advanced; the edge chain windowed under
        ``graph_axis``) and wake mask (or ``None``)."""
        if fs is not None:
            fs = advance_faults(_row(self.edge_keys, t),
                                _row(self.churn_keys, t), self.faults, fs,
                                graph_axis=graph_axis)
        awake = None
        if self.async_ is not None:
            K = self.wake_keys.k0.shape[1]
            awake = wake_rows(_row(self.wake_keys, t), n_nodes // K,
                              self.async_.wake_prob)
        return fs, awake


def _row(keys: Key, t: int) -> Key:
    return Key(keys.k0[t], keys.k1[t])


def plane_step(state, mask, src, dst, valid, backend, *, share, offsets,
               fs, awake, abuf, planes: PlaneRounds, policy=None,
               graph_axis: GraphAxis | None = None, halo: str = "psum"):
    """One round of :func:`sparse_pushsum_step` with the planes that are
    on, under ``policy`` (and ``graph_axis``) -> ``(state, abuf)``."""
    if abuf is None:
        return sparse_pushsum_step(state, mask, src, dst, valid, backend,
                                   share=share, offsets=offsets,
                                   faults=fs, policy=policy,
                                   graph_axis=graph_axis, halo=halo), None
    return sparse_pushsum_step(state, mask, src, dst, valid, backend,
                               share=share, offsets=offsets, faults=fs,
                               awake=awake, abuf=abuf,
                               staleness=planes.staleness, policy=policy)


def round_mask(kt: Key, t: int, n_edges: int, drop: torch.Tensor,
               B: torch.Tensor, fm: FaultModel | None, fs,
               src, dst, graph_axis: GraphAxis | None = None
               ) -> torch.Tensor:
    """Round t's (K·E,) link mask from its folded link key(s): the
    Bernoulli mask of :func:`edge_mask`, or the fault plane's on the same
    link uniforms (the degenerate model gives the same mask). Under
    ``graph_axis`` the uniforms are the full padded draw's window and
    ``dst`` holds receiver node ids (not slots)."""
    if fm is None:
        return edge_mask(kt, t, n_edges, drop, B, graph_axis)
    u = uniform(kt, n_edges, drop.device)
    if graph_axis is not None:
        u = graph_axis.window(u)
    return faulty_edge_mask(u, t, fm, fs, src, dst, drop, B)


@statics_contract(
    name="pushsum",
    # The sparse core's reason to exist: no (N, N) value may ever appear
    # in the program (the trajectory output is (T, N, d) — fine).
    forbidden={"*": (("N", "N"),)},
    # One PRNG stream, folded at the plain iteration index; engines that
    # add more streams must move to a strided domain (see social/byzantine).
    streams=(("link", lambda t: t),),
)
def run_pushsum_sparse(
    w,                     # (N, d) inputs
    src,                   # (E,) int32
    dst,                   # (E,) int32
    T: int,
    *,
    drop_prob: float = 0.0,
    B: int = 1,
    key: Key | None = None,
    valid=None,
    masks=None,            # optional explicit (T, E) bool schedule
    record_every: int = 1,
    plan: ExecutionPlan | None = None,
    device=None,
) -> tuple[SparsePushSumState, torch.Tensor]:
    """Run T synchronous rounds of the edge-list core.

    Masks are (E,) Bernoulli draws from ``key`` (default ``prng_key(0)``)
    folded at the plain round index ``t``, with forced delivery at ``t %
    B == B - 1``: the reference's draws bit for bit. An explicit ``masks``
    (T, E) schedule replaces them (see :func:`graphs.edge_masks`); its
    length must be T. ``valid`` (default all True) marks padding edges.

    Returns the final state and the ratios recorded after rounds
    ``record_every - 1, 2 record_every - 1, ...``: only those frames are
    kept, so ``record_every = T`` holds one (N, d) frame.

    ``plan.backend`` picks the delivery route and ``plan.dst_sorted``
    asserts (and checks) a dst-sorted index; the share factors and the
    CSR offsets of a sorted index are computed once, before the loop.
    ``plan.faults`` (a :class:`repro_torch.core.faults.FaultModel`) runs
    the fault plane on the link uniforms of the same fold ``t``;
    ``plan.async_`` (an :class:`repro_torch.core.asyncrony.AsyncModel`)
    the async plane, whose delivery runs through K1 on the per-edge
    buffer (a degenerate model runs the synchronous loop). Neither goes
    with an explicit ``masks`` schedule. ``plan.policy`` stores the state
    at the policy's storage dtype (K1 on half storage on the card); the
    recorded ratios are float32. ``device=None`` means the card, and
    raises where there is none.
    """
    plan = check_plan(plan, "run_pushsum_sparse",
                      ("backend", "dst_sorted", "faults", "async_",
                       "policy"))
    faults = plan.faults
    async_ = None if is_degenerate_async(plan.async_) else plan.async_
    dev = resolve_device(device)
    w = torch.as_tensor(w, dtype=torch.float32, device=dev)
    src = torch.as_tensor(src, dtype=torch.int32, device=dev)
    dst = torch.as_tensor(dst, dtype=torch.int32, device=dev)
    N, E = w.shape[0], src.shape[0]
    valid = (torch.ones(E, dtype=torch.bool, device=dev) if valid is None
             else torch.as_tensor(valid, dtype=torch.bool, device=dev))
    if masks is not None:
        for name, m in (("faults", faults), ("async_", async_)):
            if m is not None:
                raise ValueError(
                    f"plan.{name} needs key-driven masks; an explicit masks "
                    f"schedule already fixes the link realization")
        masks = torch.as_tensor(masks, dtype=torch.bool, device=dev)
        if masks.shape[0] != T:
            raise ValueError(
                f"masks schedule has {masks.shape[0]} rounds but T={T}")
    # loop invariants of the fixed edge index, read back once
    offsets = None
    if E and bool((dst[1:] >= dst[:-1]).all()):
        offsets = dst_offsets(dst, N)
    elif plan.dst_sorted:
        raise ValueError("plan.dst_sorted=True but the edge index is not "
                         "dst-sorted")
    share = 1.0 / (_out_degree(src, valid, N) + 1.0)
    key = prng_key(0) if key is None else key
    drop = torch.tensor(drop_prob, dtype=torch.float32, device=dev)
    Bt = torch.tensor(B, dtype=torch.int32, device=dev)
    state = init_sparse_state(w, E, plan.policy)
    planes = PlaneRounds.build(key, T, ENGINE_PUSHSUM, faults, async_, E,
                               dev)
    fs, abuf = planes.init(N, E, w.shape[1], dev, state.zm.dtype)
    traj = []
    for t in range(T):
        if masks is not None:
            mask, awake = masks[t], None
        else:
            fs, awake = planes.step(t, fs, N)
            mask = round_mask(fold_in(key, t), t, E, drop, Bt,
                              planes.faults, fs, src, dst)
        state, abuf = plane_step(state, mask, src, dst, valid, plan.backend,
                                 share=share, offsets=offsets, fs=fs,
                                 awake=awake, abuf=abuf, planes=planes,
                                 policy=plan.policy)
        if (t + 1) % record_every == 0:
            traj.append(sparse_ratios(state))
    return state, _frames(traj, w)
