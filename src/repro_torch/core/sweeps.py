"""Scenario sweeps — grids of (topology × M × Γ × drop) × seed scenarios run
in lockstep.

The port of the synchronous, single-device part of ``repro.core.sweeps``.
The reference runs a grid as one ``jax.vmap`` over its scan; torch has no
``vmap`` over hand-written kernels, so the port stacks the K scenarios of
a call into **one block-diagonal graph** (:func:`stack_runtimes`): scenario
k's nodes are ``[k N, (k+1) N)`` and its edges ``[k E, (k+1) E)``, in the
reference's padded, dst-sorted order, with one CSR ``offsets`` over the
K·N receivers; the per-scenario scalars (drop, Γ, B, M) become (K,)
tensors. The engines' own loops (:func:`repro_torch.core.hps._hps_scan_core`,
:func:`repro_torch.core.social._social_scan_core`, of which a single run
is the K = 1 case) then take one consensus step a round for all K
scenarios, so the CUDA edge scatter launches once a round whatever K is,
and the social innovation kernel once a round over the K·N agents. Link
masks are drawn for all K keys in one threefry pass, (K, E) then (K·E,),
on the engines' own fold domains. Algorithm 2 stacks its neighbor lists
the same way (:func:`stack_runtimes` of ``ByzRuntime`` runtimes: one
block-diagonal neighbor-list graph of K·N receivers), and its loop
(:func:`repro_torch.core.byzantine._scan_core`) launches the trim-gather
kernel once a round for all K scenarios, each receiver trimming its own
scenario's F.

Seven entry points:

* :func:`run_pushsum_sweep` — Theorem 1 dynamics (Alg. 1 consensus) over
  topology draw × drop × seed grids;
* :func:`run_hps_grid` / :func:`run_hps_sweep` — Algorithm 1 over
  (topology, M, Γ, drop) × seed grids; M varies per scenario;
* :func:`run_social_grid` / :func:`run_social_sweep` — Algorithm 3 over
  (topology, drop, Γ) × seed grids; M is shared;
* :func:`run_byzantine_sweep` — Algorithm 2 on one config over a seed
  batch, for each of a list of attacks;
* :func:`run_byzantine_grid` — Algorithm 2 over (topology, F, Byzantine
  set, Γ) × seed grids; N and M are shared.

Every result row is one scenario on the leading K axis, in the
reference's order: config or graph major, then drop, Γ, seed, then the
fault axis (``plan.faults``: a model or a list, fault-minor) and the async
axis (``plan.async_``, minor-most). A crossed grid is still one
block-diagonal graph; its fault and async models ride as (K,) tensors and
K1, K2 and K3 still launch once a round for all K. A single degenerate
async model adds no axis (the synchronous loop). Every entry point takes
``plan.policy``, the precision policy of the whole block-diagonal graph
(one policy for all K scenarios, so the kernels still launch once a round
on half storage). The Byzantine grid and
sweep take one fault model over every scenario (the grid's ``fault``
column all zeros) and no async model. Not ported: the jit and runtime
caches and their registry.

**Multi-device** (``plan.mesh``, a ``torch.distributed`` ``DeviceMesh``
of :func:`repro_torch.distributed.sharding.sweep_mesh`; SPMD: every rank
calls the entry point with the same arguments). Every entry point but
:func:`run_byzantine_sweep` splits its K scenarios over the mesh's
``plan.data_axis``: K is padded to a multiple of the axis extent by
repeating the last scenario, each rank runs its contiguous block through
the same block-diagonal loop, and the blocks are all-gathered over the
axis, so every rank returns the full result (pad rows sliced off). A row
is the one the unsharded grid gives. :func:`run_pushsum_sweep` also cuts
the graph into ``plan.graph_shards`` edge shards
(:func:`repro_torch.core.graphs.partition_edge_list`, or an
:class:`~repro_torch.core.graphs.EdgeShards` passed as ``el``): without a
mesh the S shards run in one process (:class:`repro_torch.core.pushsum.
EmulatedAxis`, K1 still once a round), with one the mesh's
``plan.graph_axis`` carries one shard a rank (:class:`repro_torch.core.
pushsum.GroupAxis`); ``plan.halo`` picks the combine. That is the 2-D
(data x graph) program. The backend follows the device: NCCL meshes run
``cuda`` entry points, gloo meshes ``cpu`` ones; a mesh of another device
type than the run raises.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..statics.contracts import contract as statics_contract
from .asyncrony import (AsyncModel, is_degenerate_async,
                        stack_async_models)
from .attacks import Attack
from .byzantine import (
    ByzantineConfig,
    ByzantineResult,
    ByzRuntime,
    _build_scan,
    make_byzantine_runtime,
)
from .faults import ENGINE_PUSHSUM, FaultModel, stack_fault_models
from .graphs import (EdgeList, EdgeShards, _dst_offsets, is_dst_sorted,
                     partition_edge_list)
from .hps import HPS_STORES, HPSConfig, HPSRuntime, _hps_scan_core
from .hps import make_hps_runtime
from .plan import ExecutionPlan, check_plan, resolve_device
from .prng import Key, fold_rounds
from .pushsum import (
    EmulatedAxis,
    GraphAxis,
    GroupAxis,
    PlaneRounds,
    _axis_out_degree,
    _draw_edges,
    _full,
    _receivers,
    _shard_order_sum,
    collective,
    init_sparse_state,
    partitioned_edges,
    plane_step,
    round_mask,
    sparse_ratios,
)
from .signals import SignalModel
from .social import (
    SOCIAL_STORES,
    SocialRuntime,
    _social_scan_core,
    make_social_runtime,
)

__all__ = [
    "PushSumSweepResult",
    "HPSSweepResult",
    "SocialSweepResult",
    "ByzantineGridResult",
    "stack_runtimes",
    "run_pushsum_sweep",
    "run_hps_grid",
    "run_hps_sweep",
    "run_social_grid",
    "run_social_sweep",
    "run_byzantine_sweep",
    "run_byzantine_grid",
]

_M32 = 0xFFFFFFFF

#: Index-column order of the shared ``describe()``: scenario coordinates
#: first, then ``fault``, then ``async_`` (minor-most), as the reference.
_AXIS_ORDER = ("graph", "cfg", "drop_prob", "gamma", "M", "F", "seed",
               "fault", "async_")

#: Fields of the result tuples that are payload, not index columns.
_PAYLOAD_FIELDS = frozenset({
    "err", "final_ratio", "mass_gap", "beliefs", "log_ratio", "ratio",
    "gap", "r", "decisions",
})


def _describe_result(res) -> str:
    """Shared ``describe()``: one line per index column in the fixed
    scenario -> fault -> async order, naming levels and payload shapes."""
    lines = [
        f"{type(res).__name__}: K={res.K} scenarios "
        "(row order: scenario coords -> fault -> async_, async minor-most)"
    ]
    for name in _AXIS_ORDER:
        if name not in res._fields:
            continue
        v = getattr(res, name)
        if v is None:
            lines.append(f"  {name:<9} absent (no axis)")
            continue
        uniq = np.unique(np.asarray(v))
        preview = ", ".join(str(x) for x in uniq[:6])
        if uniq.size > 6:
            preview += ", ..."
        lines.append(f"  {name:<9} {uniq.size} level(s): [{preview}]")
    payload = [f"{n}{tuple(getattr(res, n).shape)}" for n in res._fields
               if n in _PAYLOAD_FIELDS and getattr(res, n) is not None]
    lines.append("  payload: " + ", ".join(payload))
    return "\n".join(lines)


class PushSumSweepResult(NamedTuple):
    """One row per (graph, drop, seed) scenario, leading axis K. Payload on
    the run's device, index columns on the CPU."""

    err: torch.Tensor          # (K, T) max-agent consensus error per round
    final_ratio: torch.Tensor  # (K, N, d) z/m estimates at T
    mass_gap: torch.Tensor     # (K, d) value invariant minus sum(w) at T
    drop_prob: torch.Tensor    # (K,) scenario coordinates
    seed: torch.Tensor         # (K,)
    graph: torch.Tensor        # (K,) topology-draw index
    fault: torch.Tensor | None = None   # (K,) fault-model index, or no axis
    async_: torch.Tensor | None = None  # (K,) async-model index, minor-most

    @property
    def K(self) -> int:
        return int(self.err.shape[0])

    def describe(self) -> str:
        return _describe_result(self)


class SocialSweepResult(NamedTuple):
    """One row per (config, seed) scenario, leading axis K; ``beliefs`` /
    ``log_ratio`` have the shapes of
    :class:`repro_torch.core.social.SocialLearningResult` for the store
    with a leading K. ``cfg`` indexes into the (expanded) config list."""

    beliefs: torch.Tensor
    log_ratio: torch.Tensor
    drop_prob: torch.Tensor  # (K,)
    gamma: torch.Tensor      # (K,)
    seed: torch.Tensor       # (K,)
    cfg: torch.Tensor        # (K,) config index
    fault: torch.Tensor | None = None
    async_: torch.Tensor | None = None

    @property
    def K(self) -> int:
        return int(self.seed.shape[0])

    def describe(self) -> str:
        return _describe_result(self)


class HPSSweepResult(NamedTuple):
    """One row per (config, seed) scenario, leading axis K; ``ratio`` /
    ``gap`` have the shapes of :class:`repro_torch.core.hps.HPSResult` for
    the store with a leading K. ``M`` is each scenario's sub-network
    count."""

    ratio: torch.Tensor
    gap: torch.Tensor
    drop_prob: torch.Tensor  # (K,)
    gamma: torch.Tensor      # (K,)
    M: torch.Tensor          # (K,)
    seed: torch.Tensor       # (K,)
    cfg: torch.Tensor        # (K,) config index
    fault: torch.Tensor | None = None
    async_: torch.Tensor | None = None

    @property
    def K(self) -> int:
        return int(self.seed.shape[0])

    def describe(self) -> str:
        return _describe_result(self)


# ---------------------------------------------------------------------------
# Stacking K scenarios into one block-diagonal graph
# ---------------------------------------------------------------------------

def _block_diagonal(src, dst, valid, offsets, n: int):
    """(K, E) edge rows of K graphs over ``n`` nodes each (``offsets``
    (K, n+1) or ``None``) -> the (K·E,) edge index and (K·n+1,) CSR offsets
    of one graph of K·n nodes, node ids of row k shifted by k·n."""
    K, E = src.shape
    shift = torch.arange(K, dtype=torch.int32, device=src.device)[:, None]
    src_b = (src + shift * n).reshape(-1)
    dst_b = (dst + shift * n).reshape(-1)
    if offsets is not None:
        offsets = torch.cat([(offsets[:, :-1] + shift * E).reshape(-1),
                             offsets.new_tensor([K * E])])
    return src_b, dst_b, valid.reshape(-1), offsets


def stack_runtimes(rts: Sequence[HPSRuntime] | Sequence[SocialRuntime]
                   | Sequence[ByzRuntime]):
    """K single-scenario runtimes of one type, node count N and (padded)
    edge count E -> one runtime of the same type over K·N nodes and K·E
    edges, its scalars (K,) tensors.

    Scenario k keeps its edges' order at ``[k E, (k+1) E)``, so its (E,)
    link-mask draw lines up edge for edge. Each scenario's receivers lie
    in its own block, so a dst-sorted index stays sorted (the ``e_max``
    pads sit at ``dst = N - 1`` of their block) and the offsets are one
    CSR over the K·N receivers; ``None`` unless every runtime has them.
    ``ByzRuntime`` runtimes of one N and network count stack as
    :func:`_stack_byz_runtimes` sets out."""
    rts = list(rts)
    if not rts:
        raise ValueError("need at least one runtime")
    kind = type(rts[0])
    if kind is ByzRuntime:
        return _stack_byz_runtimes(rts)
    N, E = rts[0].rep_mask.shape[0], rts[0].src.shape[0]
    if any(type(r) is not kind or r.rep_mask.shape[0] != N
           or r.src.shape[0] != E or r.drop_prob.ndim for r in rts):
        raise ValueError("stack single-scenario runtimes of one type, node "
                         "count and edge count")
    offsets = (None if any(r.offsets is None for r in rts)
               else torch.stack([r.offsets for r in rts]))
    edges = _block_diagonal(*(torch.stack([getattr(r, f) for r in rts])
                              for f in ("src", "dst", "valid")), offsets, N)
    rest = {f: torch.cat([getattr(r, f).reshape(-1) for r in rts])
            for f in kind._fields[4:]}
    return kind(*edges, **rest)


def _stack_byz_runtimes(rts: Sequence[ByzRuntime]) -> ByzRuntime:
    """K single-scenario Algorithm 2 runtimes of one agent count N and
    network count M -> the stacked runtime of one block-diagonal
    neighbor-list graph of K·N receivers: rows padded to the common
    ``deg_max`` with invalid slots, as the reference pads a grid, then
    scenario k's senders and network offsets shifted by k·N; ``F`` and
    ``gamma`` (K,) int numpy arrays."""
    N, M = rts[0].byz_mask.shape[0], rts[0].offsets.shape[0]
    if any(type(r) is not ByzRuntime or r.byz_mask.shape[0] != N
           or r.offsets.shape[0] != M or not isinstance(r.F, int)
           for r in rts):
        raise ValueError("stack single-scenario runtimes of one agent "
                         "count and network count")
    dm = max(int(r.nbr_idx.shape[1]) for r in rts)

    def pad(x):
        return torch.cat([x, x.new_zeros((N, dm - x.shape[1]))], dim=1)

    return ByzRuntime(
        nbr_idx=torch.cat([pad(r.nbr_idx) + k * N
                           for k, r in enumerate(rts)]),
        nbr_valid=torch.cat([pad(r.nbr_valid) for r in rts]),
        byz_nbr=torch.cat([pad(r.byz_nbr) for r in rts]),
        byz_mask=torch.cat([r.byz_mask for r in rts]),
        active=torch.cat([r.active for r in rts]),
        in_C=torch.cat([r.in_C for r in rts]),
        offsets=torch.cat([r.offsets + k * N for k, r in enumerate(rts)]),
        sizes=torch.cat([r.sizes for r in rts]),
        F=np.asarray([r.F for r in rts], np.int64),
        gamma=np.asarray([r.gamma for r in rts], np.int64),
    )


def _seeds(seeds) -> np.ndarray:
    """Seeds as the uint32 words of their keys, int64."""
    return np.atleast_1d(np.asarray(seeds, dtype=np.int64)) & _M32


def _keys(seeds: np.ndarray) -> Key:
    """``prng_key(s)`` for every seed, as a Key of K words."""
    return Key(np.zeros_like(seeds), seeds)


def _cross(coords, models, kind, stack):
    """Cross a model list (or one model) into the flattened (K,)
    coordinates, model-minor -> (coords, model index (K·NM,), the models
    stacked to (NM,) leaves); ``(coords, None, None)`` without models."""
    if models is None:
        return coords, None, None
    ml = [models] if isinstance(models, kind) else list(models)
    if not ml:
        raise ValueError(f"a {kind.__name__} axis needs at least one model")
    k = coords[0].shape[0]
    return (tuple(np.repeat(c, len(ml)) for c in coords),
            np.tile(np.arange(len(ml), dtype=np.int32), k), stack(ml))


def _plane_axes(coords, plan: ExecutionPlan):
    """The fault axis, then the async axis (minor-most), crossed into the
    coordinates as the reference crosses them -> (coords, fault index,
    per-row fault models, async index, per-row async models), the models
    with (K,) leaves. A single degenerate async model is no axis."""
    async_ = plan.async_
    if isinstance(async_, AsyncModel) and is_degenerate_async(async_):
        async_ = None
    coords, fi, fm = _cross(coords, plan.faults, FaultModel,
                            stack_fault_models)
    n = len(coords)
    if fi is not None:
        coords = coords + (fi,)
    coords, ai, am = _cross(coords, async_, AsyncModel, stack_async_models)
    coords, fi = coords[:n], (None if fi is None else coords[n])

    def rows(models, idx):
        if models is None:
            return None
        sel = torch.from_numpy(idx).long()
        return type(models)(*(x[sel] for x in models))

    return coords, fi, rows(fm, fi), ai, rows(am, ai)


def _index(x):
    return None if x is None else torch.from_numpy(x)


# ---------------------------------------------------------------------------
# Multi-device: the data and graph dimensions of a device mesh
# ---------------------------------------------------------------------------

class _DataSplit(NamedTuple):
    """One rank's block of a grid's K scenario rows over the data axis."""

    rows: np.ndarray    # indices of this block's rows (pad rows repeat K-1)
    K: int              # the grid's scenario count
    group: object       # the data axis' process group; None without a mesh
    n_data: int         # the data axis' extent


def _mesh_group(plan: ExecutionPlan, axis: str, dev: torch.device):
    """The process group of the mesh dimension ``axis``, after checking
    that the mesh has it and runs on ``dev``'s device type."""
    mesh = plan.mesh
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh's device type {mesh.device_type!r} is "
                         f"not the run's device {dev}")
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no dimension {axis!r} (its "
                         f"dimensions: {mesh.mesh_dim_names})")
    return mesh.get_group(axis)


def _data_split(K: int, plan: ExecutionPlan, dev) -> _DataSplit:
    """This rank's contiguous block of the K rows padded to a multiple of
    the mesh's data extent (all K rows without a mesh)."""
    if plan.mesh is None:
        return _DataSplit(np.arange(K), K, None, 1)
    import torch.distributed as dist

    group = _mesh_group(plan, plan.data_axis, dev)
    n = dist.get_world_size(group)
    padded = np.minimum(np.arange(-(-K // n) * n), K - 1)
    kb = padded.shape[0] // n
    i = dist.get_rank(group)
    return _DataSplit(padded[i * kb:(i + 1) * kb], K, group, n)


def _gather(x: torch.Tensor, split: _DataSplit) -> torch.Tensor:
    """Every rank's (Kb, ...) block of a result, gathered over the data
    axis -> the (K, ...) rows."""
    if split.group is None:
        return x
    x = x.contiguous()
    out = x.new_empty((split.n_data * x.shape[0], *x.shape[1:]))
    collective("all_gather")(out, x, group=split.group)
    return out[:split.K]


def _block_models(models, rows: np.ndarray):
    """Per-row fault or async models (with (K,) leaves) at ``rows``."""
    if models is None:
        return None
    sel = torch.from_numpy(rows).long()
    return type(models)(*(x[sel] for x in models))


def _graph_axis(plan: ExecutionPlan, n_shards: int, dev) -> GraphAxis:
    """The emulated axis of ``n_shards`` shards without a mesh, else the
    mesh's graph dimension, whose extent must be ``n_shards``."""
    if plan.mesh is None:
        return EmulatedAxis(n_shards)
    axis = GroupAxis(_mesh_group(plan, plan.graph_axis, dev))
    if axis.n_shards != n_shards:
        raise ValueError(
            f"mesh {plan.graph_axis} axis has {axis.n_shards} devices but "
            f"the edge list is cut into {n_shards} shards")
    return axis


# ---------------------------------------------------------------------------
# Algorithm 1 consensus: graph draws x drop x seed
# ---------------------------------------------------------------------------

def _scenario_grid(n_graphs: int, drop_probs, seeds):
    """Flatten the (graph x drop x seed) grid into K-long coordinate arrays."""
    drop_probs = np.atleast_1d(np.asarray(drop_probs, np.float32))
    g, d, s = np.meshgrid(np.arange(n_graphs, dtype=np.int32), drop_probs,
                          _seeds(seeds), indexing="ij")
    return g.ravel(), d.ravel(), s.ravel()


@statics_contract(
    name="pushsum_sharded",
    # The per-process law of the edge-partitioned mode: nothing (N, N),
    # and no rank >= 2 value over the whole padded edge axis; (e_shard, d)
    # state a shard is the budget. (The rank-1 (E_pad,) draw that every
    # shard windows is exempt by construction.)
    forbidden={"*": (("N", "N"), ("E", "*"))},
    streams=(("link", lambda t: t),),
)
def _pushsum_sweep_core(keys: Key, src, dst, valid, offsets, drop, B,
                        w: torch.Tensor, *, T: int, backend: str,
                        faults: FaultModel | None = None,
                        async_=None, policy=None,
                        graph_axis: GraphAxis | None = None,
                        halo: str = "psum"):
    """K push-sum scenarios on one block-diagonal graph of K·N nodes, from
    ``w`` each -> (err (K, T), final ratios (K, N, d), value invariant minus
    sum(w), (K, d)). ``faults`` / ``async_`` carry (K,) leaves; ``policy``
    is the precision policy (the invariant is summed in float32).

    With ``graph_axis`` this is the edge-partitioned (2-D mesh) program of
    one process: the edge arguments hold the axis' shards of every
    scenario (:func:`repro_torch.core.pushsum.partitioned_edges`), node
    state is replicated, the link masks and fault chains are windows of
    each scenario's full padded draw, the receiver partials are combined
    every round by ``halo``, and the out-degree and the in-flight mass are
    summed over the axis, so every shard returns the same rows."""
    N, d = w.shape
    K = drop.numel()
    E = _draw_edges(src.shape[0], K, graph_axis)
    state = init_sparse_state(w.repeat(K, 1), src.shape[0], policy)
    share = 1.0 / (_axis_out_degree(src, valid, K * N, graph_axis, w.dtype)
                   + 1.0)
    receivers = _receivers(dst, K * N, graph_axis)
    target = w.mean(dim=0)
    kts = fold_rounds(keys, range(T), w.device)
    planes = PlaneRounds.build(keys, T, ENGINE_PUSHSUM, faults, async_, E,
                               w.device)
    fs, abuf = planes.init(K * N, src.shape[0], d, w.device, state.zm.dtype)
    errs = []
    for t in range(T):
        fs, awake = planes.step(t, fs, K * N, graph_axis)
        mask = round_mask(Key(kts.k0[t], kts.k1[t]), t, E, drop, B,
                          planes.faults, fs, src, receivers, graph_axis)
        state, abuf = plane_step(state, mask, src, dst, valid, backend,
                                 share=share, offsets=offsets, fs=fs,
                                 awake=awake, abuf=abuf, planes=planes,
                                 policy=policy, graph_axis=graph_axis,
                                 halo=halo)
        errs.append((sparse_ratios(state).view(K, N, d) - target).abs()
                    .amax(dim=(1, 2)))
    err = torch.stack(errs, dim=1) if errs else w.new_zeros((K, 0))
    z, sigma, rho = (_full(x) for x in (state.z, state.sigma, state.rho))
    held = (sigma[src] - rho) * valid.to(w.dtype)[:, None]
    if graph_axis is None:
        in_flight = held.view(K, E, d).sum(dim=1)
    else:
        # shard-major (local, K, e_shard) slots: each shard's sum, then
        # the shards in order
        in_flight = graph_axis.allreduce(_shard_order_sum(
            held.view(graph_axis.local, K, -1, d).sum(dim=2)))
    invariant = z.view(K, N, d).sum(dim=1) + in_flight
    return err, sparse_ratios(state).view(K, N, d), invariant - w.sum(dim=0)


def run_pushsum_sweep(
    w,                     # (N, d) initial values, shared by scenarios
    el: EdgeList | EdgeShards,   # one graph or stacked draws (leading G)
    T: int,
    *,
    drop_probs: Sequence[float] | float = 0.0,
    seeds: Sequence[int] | int = 0,
    B: int = 4,
    plan: ExecutionPlan | None = None,
    device=None,
) -> PushSumSweepResult:
    """Every topology draw of ``el`` (see :func:`graphs.stack_edge_lists`)
    × every drop probability × every seed, K = G·|drop_probs|·|seeds|
    scenarios, as one block-diagonal graph.

    Each row is :func:`repro_torch.core.pushsum.run_pushsum_sparse` on its
    draw's edge index with ``key=prng_key(seed)``: link masks folded at the
    plain round index, forced delivery at ``t % B == B - 1``. ``err`` is the
    worst ``|z/m - mean(w)|`` after each round, ``mass_gap`` the value
    invariant minus ``sum(w)`` at T. ``plan.backend`` picks the delivery
    route (the CUDA edge scatter needs every draw dst-sorted, see
    :func:`graphs.sort_by_dst`) and ``plan.dst_sorted`` asserts that they
    are. ``plan.faults`` and ``plan.async_`` (a model or a list) cross the
    fault and async axes, model-minor; the ``fault`` and ``async_``
    columns index the lists. ``plan.mesh`` splits the rows over its
    ``plan.data_axis`` (module docstring).

    **Edge-partitioned** (``plan.graph_shards=S``, or ``el`` an
    :class:`~repro_torch.core.graphs.EdgeShards`): each draw is cut into S
    dst-contiguous shards, per-edge state is the shards', and each round's
    receiver partials are summed over them (``plan.halo``): in this
    process (no mesh), or over the mesh's ``plan.graph_axis``, whose
    extent must be S. The rows equal the unsharded sweep's on
    ``EdgeShards.padded_edge_list()`` (not on ``el``: the masks index the
    padded slots) at every receiver whose in-edges lie on one shard, and
    within float reduce order elsewhere. Not with ``plan.async_``.
    ``device=None`` means the card, and raises where there is none.
    """
    plan = check_plan(plan, "run_pushsum_sweep",
                      ("backend", "dst_sorted", "faults", "async_",
                       "policy", "mesh", "data_axis", "graph_axis",
                       "graph_shards", "halo"))
    dev = resolve_device(device)
    w = torch.as_tensor(w, dtype=torch.float32, device=dev)
    if w.shape[0] != el.n:
        raise ValueError(f"w has {w.shape[0]} rows but the graph {el.n} "
                         f"nodes")
    if plan.graph_shards is not None or isinstance(el, EdgeShards):
        return _pushsum_sweep_sharded(w, el, T, drop_probs, seeds, B, plan,
                                      dev)
    args, (gi, dp, sd), (fi, fm, ai, am), split = _pushsum_grid(
        el, drop_probs, seeds, B, plan, dev)
    err, final, gap = _pushsum_sweep_core(*args, w, T=T, backend=plan.backend,
                                          faults=fm, async_=am,
                                          policy=plan.policy)
    return PushSumSweepResult(
        err=_gather(err, split), final_ratio=_gather(final, split),
        mass_gap=_gather(gap, split),
        drop_prob=torch.from_numpy(dp), seed=torch.from_numpy(sd),
        graph=torch.from_numpy(gi), fault=_index(fi), async_=_index(ai))


def _pushsum_grid(el: EdgeList, drop_probs, seeds, B: int,
                  plan: ExecutionPlan, dev):
    """The (graph x drop x seed [x fault x async]) scenarios of ``el``,
    this rank's block of them stacked into one block-diagonal graph on
    ``dev`` -> (the arguments of :func:`_pushsum_sweep_core` before ``w``,
    the (K,) coordinates, the fault and async indices and the block's
    models, the data split)."""
    src, dst, valid = (np.atleast_2d(a) for a in (el.src, el.dst, el.valid))
    offsets = None
    if is_dst_sorted(dst):
        offsets = torch.from_numpy(_dst_offsets(dst, el.n))
    elif plan.dst_sorted:
        raise ValueError("plan.dst_sorted=True but the edge index is not "
                         "dst-sorted")
    gi, dp, sd = _scenario_grid(src.shape[0], drop_probs, seeds)
    (gi, dp, sd), fi, fm, ai, am = _plane_axes((gi, dp, sd), plan)
    split = _data_split(gi.shape[0], plan, dev)
    r = split.rows
    rows = torch.from_numpy(gi[r]).long()
    edges = _block_diagonal(
        torch.from_numpy(src)[rows], torch.from_numpy(dst)[rows],
        torch.from_numpy(valid)[rows],
        None if offsets is None else offsets[rows], el.n)
    args = (_keys(sd[r]), *(None if x is None else x.to(dev) for x in edges),
            torch.from_numpy(dp[r]).to(dev),
            torch.full((r.shape[0],), B, dtype=torch.int32, device=dev))
    return (args, (gi, dp, sd),
            (fi, _block_models(fm, r), ai, _block_models(am, r)), split)


def _pushsum_sweep_sharded(w, el, T: int, drop_probs, seeds, B: int,
                           plan: ExecutionPlan, dev) -> PushSumSweepResult:
    """:func:`run_pushsum_sweep`'s edge-partitioned mode."""
    if plan.async_ is not None and not (
            isinstance(plan.async_, AsyncModel)
            and is_degenerate_async(plan.async_)):
        raise ValueError(
            "async_ is incompatible with the edge-partitioned mode "
            "(graph_shards): the per-edge stale buffer is not partitioned")
    shards = (el if isinstance(el, EdgeShards)
              else partition_edge_list(el, plan.graph_shards))
    if plan.graph_shards is not None and \
            shards.n_shards != plan.graph_shards:
        raise ValueError(f"EdgeShards has {shards.n_shards} shards, "
                         f"graph_shards={plan.graph_shards}")
    src, dst, valid = (a if shards.is_batched else a[None]
                       for a in (shards.src, shards.dst, shards.valid))
    gi, dp, sd = _scenario_grid(src.shape[0], drop_probs, seeds)
    (gi, dp, sd), fi, fm, _, _ = _plane_axes(
        (gi, dp, sd), plan.replace(async_=None))
    split = _data_split(gi.shape[0], plan, dev)
    axis = _graph_axis(plan, shards.n_shards, dev)
    r = split.rows
    edges = partitioned_edges(src[gi[r]], dst[gi[r]], valid[gi[r]],
                              shards.n, axis)
    err, final, gap = _pushsum_sweep_core(
        _keys(sd[r]), *(x.to(dev) for x in edges),
        torch.from_numpy(dp[r]).to(dev),
        torch.full((r.shape[0],), B, dtype=torch.int32, device=dev), w,
        T=T, backend=plan.backend, faults=_block_models(fm, r),
        policy=plan.policy, graph_axis=axis, halo=plan.halo)
    return PushSumSweepResult(
        err=_gather(err, split), final_ratio=_gather(final, split),
        mass_gap=_gather(gap, split), drop_prob=torch.from_numpy(dp),
        seed=torch.from_numpy(sd), graph=torch.from_numpy(gi),
        fault=_index(fi))


# ---------------------------------------------------------------------------
# Algorithms 1 and 3: (config) x seed grids
# ---------------------------------------------------------------------------

def _config_grid(cfgs, seeds, make_runtime, dev, plan: ExecutionPlan):
    """The configs' runtimes padded to the widest E (as the reference pads
    a mixed-E grid), one per (config, seed [, fault [, async]]) scenario in
    config-major order; this rank's block of them stacked -> (runtime on
    ``dev``, config index (K,), seeds (K,), the fault and async indices
    and the block's models, the data split)."""
    e_max = max(int(np.count_nonzero(c.topo.adj)) for c in cfgs)
    runtimes = [make_runtime(c, e_max=e_max) for c in cfgs]
    gi, sd = np.meshgrid(np.arange(len(cfgs), dtype=np.int32),
                         _seeds(seeds), indexing="ij")
    (gi, sd), fi, fm, ai, am = _plane_axes((gi.ravel(), sd.ravel()), plan)
    split = _data_split(gi.shape[0], plan, dev)
    r = split.rows
    return (stack_runtimes([runtimes[g] for g in gi[r]]).to(dev), gi, sd,
            (fi, _block_models(fm, r), ai, _block_models(am, r)), split)


def _coords(cfgs, gi):
    """Per-scenario drop and Γ columns of the configs ``gi`` index."""
    drops = np.asarray([c.drop_prob for c in cfgs], np.float32)
    gammas = np.asarray([c.gamma_period for c in cfgs], np.int32)
    return torch.from_numpy(drops[gi]), torch.from_numpy(gammas[gi])


def _expand(cfg, drop_probs, gammas) -> list[HPSConfig]:
    """Cross each base config with every drop and every Γ (defaults: the
    base's own), base-major, then drop, then Γ."""
    bases = [cfg] if isinstance(cfg, HPSConfig) else list(cfg)
    expanded = []
    for base in bases:
        dps = ([base.drop_prob] if drop_probs is None
               else np.atleast_1d(np.asarray(drop_probs, np.float32)).tolist())
        gms = ([base.gamma_period] if gammas is None
               else np.atleast_1d(np.asarray(gammas, np.int32)).tolist())
        for dp in dps:
            for g in gms:
                expanded.append(dataclasses.replace(
                    base, drop_prob=float(dp), gamma_period=int(g)))
    return expanded


def run_hps_grid(
    w,
    cfgs: Sequence[HPSConfig],
    T: int,
    seeds: Sequence[int] | int,
    *,
    plan: ExecutionPlan | None = None,
    device=None,
) -> HPSSweepResult:
    """Algorithm 1 over every (config, seed) pair, K = |cfgs|·|seeds|
    scenarios, as one block-diagonal graph through the HPS loop.

    Configs share N (and ``w`` (N, d) is shared by every scenario); the
    sub-network count M varies per scenario through its ``1 / 2M`` fusion
    weight. Edge lists are padded to the widest E as
    :func:`repro_torch.core.hps.make_hps_runtime` pads them, so a row is
    ``run_hps_runtime(w, make_hps_runtime(cfg, e_max=E_max), T, seed=s)``,
    which is ``run_hps(w, cfg, T, seed=s)`` when the config's E is the
    grid's. ``plan.store`` defaults to ``"gap"`` (the (K, T) worst
    consensus-error curves and the final (K, N, d) ratios); the other
    stores are ``"trajectory"`` and ``"final"``. ``plan.faults`` and
    ``plan.async_`` cross the fault and async axes (model-minor, async
    minor-most). ``plan.mesh`` splits the rows over its ``plan.data_axis``
    (module docstring). ``device=None`` means the card, and raises where
    there is none.
    """
    plan = check_plan(plan, "run_hps_grid",
                      ("backend", "store", "faults", "async_", "policy",
                       "mesh", "data_axis"))
    store = "gap" if plan.store is None else plan.store
    cfgs = list(cfgs)
    if not cfgs:
        raise ValueError("need at least one config")
    if store not in HPS_STORES:
        raise ValueError(f"store must be one of {HPS_STORES}, got {store!r}")
    N = cfgs[0].topo.N
    if any(c.topo.N != N for c in cfgs) or np.shape(w)[0] != N:
        raise ValueError("grid configs (and w) must share the node count N")
    dev = resolve_device(device)
    rt, gi, sd, (fi, fm, ai, am), split = _config_grid(
        cfgs, seeds, make_hps_runtime, dev, plan)
    _, (ratio, gap) = _hps_scan_core(
        _keys(sd[split.rows]), rt,
        torch.as_tensor(w, dtype=torch.float32, device=dev),
        T=T, store=store, backend=plan.backend, faults=fm, async_=am,
        policy=plan.policy)
    drops, gammas = _coords(cfgs, gi)
    Ms = np.asarray([c.topo.M for c in cfgs], np.int32)
    return HPSSweepResult(
        ratio=_gather(ratio, split), gap=_gather(gap, split),
        drop_prob=drops, gamma=gammas,
        M=torch.from_numpy(Ms[gi]), seed=torch.from_numpy(sd),
        cfg=torch.from_numpy(gi), fault=_index(fi), async_=_index(ai))


def run_hps_sweep(
    w,
    cfg: HPSConfig | Sequence[HPSConfig],
    T: int,
    *,
    drop_probs: Sequence[float] | float | None = None,
    gammas: Sequence[int] | int | None = None,
    seeds: Sequence[int] | int = 0,
    plan: ExecutionPlan | None = None,
    device=None,
) -> HPSSweepResult:
    """Cross-product (config × drop × Γ × seed) Algorithm 1 sweep: each base
    config crossed with every ``drop_probs`` value and every ``gammas``
    period (defaults: the base's own), run by :func:`run_hps_grid`. Row
    order: base-major, then drop, then Γ, then seed, then fault, then
    async."""
    check_plan(plan, "run_hps_sweep",
               ("backend", "store", "faults", "async_", "policy", "mesh",
                "data_axis"))
    return run_hps_grid(w, _expand(cfg, drop_probs, gammas), T, seeds,
                        plan=plan, device=device)


def run_social_grid(
    model: SignalModel,
    cfgs: Sequence[HPSConfig],
    T: int,
    seeds: Sequence[int] | int,
    *,
    plan: ExecutionPlan | None = None,
    device=None,
) -> SocialSweepResult:
    """Algorithm 3 over every (config, seed) pair, K = |cfgs|·|seeds|
    scenarios, as one block-diagonal graph through the social loop.

    Configs (and the model) share N and M. A scenario's seed drives both of
    its streams (link masks and signals, on their disjoint fold domains),
    so a row is ``run_social_runtime(model, make_social_runtime(cfg,
    e_max=E_max), M, T, seed=s, signal_seed=s)``, which is
    ``run_social_learning(model, cfg, T, seed=s, signal_seed=s)`` when the
    config's E is the grid's. ``plan.store`` defaults to ``"log_ratio"``
    (the (K, T) worst log-ratio curves and the final (K, N, m) beliefs);
    the other stores are ``"trajectory"`` and ``"final"``. ``plan.faults``
    and ``plan.async_`` cross the fault and async axes (model-minor, async
    minor-most). ``plan.mesh`` splits the rows over its ``plan.data_axis``
    (module docstring). ``device=None`` means the card, and raises where
    there is none.
    """
    plan = check_plan(plan, "run_social_grid",
                      ("backend", "store", "faults", "async_", "policy",
                       "mesh", "data_axis"))
    store = "log_ratio" if plan.store is None else plan.store
    cfgs = list(cfgs)
    if not cfgs:
        raise ValueError("need at least one config")
    if store not in SOCIAL_STORES:
        raise ValueError(f"store must be one of {SOCIAL_STORES}, got {store!r}")
    N, M = cfgs[0].topo.N, cfgs[0].topo.M
    if any(c.topo.N != N or c.topo.M != M for c in cfgs) or model.N != N:
        raise ValueError("grid configs (and the model) must share (N, M)")
    dev = resolve_device(device)
    rt, gi, sd, (fi, fm, ai, am), split = _config_grid(
        cfgs, seeds, make_social_runtime, dev, plan)
    tables = model.tables.to(dev, torch.float32)
    keys = _keys(sd[split.rows])
    _, (beliefs, log_ratio) = _social_scan_core(
        keys, keys, rt, torch.log(tables),
        torch.cumsum(tables[:, model.truth, :], dim=-1),
        truth=model.truth, M=M, T=T, store=store, backend=plan.backend,
        faults=fm, async_=am, policy=plan.policy)
    drops, gammas = _coords(cfgs, gi)
    return SocialSweepResult(
        beliefs=_gather(beliefs, split), log_ratio=_gather(log_ratio, split),
        drop_prob=drops,
        gamma=gammas, seed=torch.from_numpy(sd), cfg=torch.from_numpy(gi),
        fault=_index(fi), async_=_index(ai))


def run_social_sweep(
    model: SignalModel,
    cfg: HPSConfig | Sequence[HPSConfig],
    T: int,
    *,
    drop_probs: Sequence[float] | float | None = None,
    gammas: Sequence[int] | int | None = None,
    seeds: Sequence[int] | int = 0,
    plan: ExecutionPlan | None = None,
    device=None,
) -> SocialSweepResult:
    """Cross-product (config × drop × Γ × seed) Algorithm 3 sweep: each base
    config crossed with every ``drop_probs`` value and every ``gammas``
    period (defaults: the base's own), run by :func:`run_social_grid`. Row
    order: base-major, then drop, then Γ, then seed, then fault, then
    async."""
    check_plan(plan, "run_social_sweep",
               ("backend", "store", "faults", "async_", "policy", "mesh",
                "data_axis"))
    return run_social_grid(model, _expand(cfg, drop_probs, gammas), T, seeds,
                           plan=plan, device=device)


# ---------------------------------------------------------------------------
# Algorithm 2: seed sweeps and (config) x seed grids
# ---------------------------------------------------------------------------

class ByzantineGridResult(NamedTuple):
    """One row per (config, seed) scenario, leading axis K; ``r`` /
    ``decisions`` have the shapes of
    :class:`repro_torch.core.byzantine.ByzantineResult` for the store with
    a leading K. ``cfg`` indexes into the configs passed to
    :func:`run_byzantine_grid`, ``F`` and ``seed`` are the scenario
    coordinates."""

    r: torch.Tensor
    decisions: torch.Tensor
    cfg: torch.Tensor        # (K,) config index
    F: torch.Tensor          # (K,) trim count of that config
    seed: torch.Tensor       # (K,)
    fault: torch.Tensor | None = None
    async_: torch.Tensor | None = None

    @property
    def K(self) -> int:
        return int(self.decisions.shape[0])

    def describe(self) -> str:
        return _describe_result(self)


def run_byzantine_sweep(
    model: SignalModel,
    cfg: ByzantineConfig,
    T: int,
    seeds: Sequence[int] | int,
    attacks: Sequence[Attack] | None = None,
    *,
    mode: str = "pairwise",
    core: str = "sparse",
    plan: ExecutionPlan | None = None,
    device=None,
) -> dict[str, ByzantineResult]:
    """Algorithm 2 on one config over a seed batch, for each attack
    (default: just ``cfg.attack``) -> ``{attack.name: ByzantineResult}``
    with a leading seed axis: with ``store="trajectory"`` (the default)
    ``r`` is (S, T, N, m, m) and ``decisions`` (S, T, N).

    Row s is ``run_byzantine_learning(model, cfg, T, seed=seeds[s])``
    with that attack. On the sparse core the S scenarios run as one
    block-diagonal neighbor-list graph of S·N receivers through one loop
    (one trim-gather launch a round for all of them); the M < 2F+1
    representative branch draws each scenario's extra representatives
    from its own key. ``core="dense"`` is the oracle and runs one
    scenario at a time. ``plan.backend`` selects the trim route and
    ``plan.store`` what is kept; ``plan.faults`` lays one fault model over
    every seed (sparse core); ``plan.async_`` raises (no async mode).
    ``device=None`` means the card, and raises where there is none.
    """
    plan = check_plan(plan, "run_byzantine_sweep",
                      ("backend", "store", "faults", "policy"))
    store = "trajectory" if plan.store is None else plan.store
    dev = resolve_device(device)
    sd = _seeds(seeds)
    keys = _keys(sd)
    rt, extra_reps, n_reps = make_byzantine_runtime(model, cfg)
    if core == "sparse":
        rt = stack_runtimes([rt] * sd.shape[0]).to(dev)
    out = {}
    for atk in attacks if attacks is not None else [cfg.attack]:
        run = _build_scan(model, rt, extra_reps, n_reps, atk, T, mode=mode,
                          core=core, backend=plan.backend, store=store,
                          device=dev, faults=plan.faults,
                          policy=plan.policy)
        if core == "sparse":
            out[atk.name] = run(keys)
            continue
        rows = [run(Key(keys.k0[s:s + 1], keys.k1[s:s + 1]))
                for s in range(sd.shape[0])]
        out[atk.name] = ByzantineResult(
            r=torch.cat([x.r for x in rows]),
            decisions=torch.cat([x.decisions for x in rows]))
    return out


def run_byzantine_grid(
    model: SignalModel,
    cfgs: Sequence[ByzantineConfig],
    T: int,
    seeds: Sequence[int] | int,
    *,
    attack: Attack | None = None,
    mode: str = "pairwise",
    plan: ExecutionPlan | None = None,
    device=None,
) -> ByzantineGridResult:
    """Algorithm 2 over every (config, seed) pair, K = |cfgs|·|seeds|
    scenarios in config-major order, as one block-diagonal neighbor-list
    graph of K·N receivers through one loop.

    Configs (and the model) share N and the network count M, and each
    must satisfy M >= 2F+1 (one representative per network; the M < 2F+1
    branch is the sweep's). Topology, F, the Byzantine set and Γ vary per
    scenario: neighbor rows are padded to the widest ``deg_max``, the
    trim-gather kernel takes F per receiver and each scenario fuses on
    its own Γ. ``attack`` overrides every config's attack (default: the
    first config's). A row is ``run_byzantine_learning(model, cfg, T,
    seed=s)`` with that attack and ``deg_max`` padding, which leaves the
    trim unchanged. ``plan.store`` defaults to ``"decisions"`` (the (K, T,
    N) decision curves and the final (K, N, *pair) statistics).
    ``plan.faults`` lays one fault model over every scenario (the
    ``fault`` column then all zeros); ``plan.async_`` raises (no async
    mode). ``plan.mesh`` splits the rows over its ``plan.data_axis``
    (module docstring). ``device=None`` means the card, and raises where
    there is none.
    """
    plan = check_plan(plan, "run_byzantine_grid",
                      ("backend", "store", "faults", "policy", "mesh",
                       "data_axis"))
    store = "decisions" if plan.store is None else plan.store
    cfgs = list(cfgs)
    if not cfgs:
        raise ValueError("need at least one config")
    atk = attack if attack is not None else cfgs[0].attack
    N, M = cfgs[0].topo.N, cfgs[0].topo.M
    if any(c.topo.N != N or c.topo.M != M for c in cfgs) or model.N != N:
        raise ValueError("grid configs (and the model) must share (N, M)")
    dev = resolve_device(device)
    runtimes = []
    for c in cfgs:
        rt, extra_reps, _ = make_byzantine_runtime(model, c)
        if extra_reps is not None:
            raise ValueError(
                "grid configs must satisfy M >= 2F+1 (the all-networks "
                f"representative rule); config with F={c.F}, M={M} needs "
                "the static extra-reps branch")
        runtimes.append(rt)
    gi, sd = np.meshgrid(np.arange(len(cfgs), dtype=np.int32),
                         _seeds(seeds), indexing="ij")
    gi, sd = gi.ravel(), sd.ravel()
    split = _data_split(gi.shape[0], plan, dev)
    rt = stack_runtimes([runtimes[g] for g in gi[split.rows]])
    run = _build_scan(model, rt, None, M, atk, T, mode=mode, core="sparse",
                      backend=plan.backend, store=store, device=dev,
                      faults=plan.faults, policy=plan.policy)
    res = run(_keys(sd[split.rows]))
    Fs = np.asarray([c.F for c in cfgs], np.int32)
    return ByzantineGridResult(
        r=_gather(res.r, split), decisions=_gather(res.decisions, split),
        cfg=torch.from_numpy(gi),
        F=torch.from_numpy(Fs[gi]), seed=torch.from_numpy(sd),
        fault=None if plan.faults is None
        else torch.zeros(gi.shape[0], dtype=torch.int32))
