"""Directed-graph set-up for the hierarchical multi-agent system (host side).

A numpy copy of the builders of ``repro.core.graphs`` that the port's
engines use, kept here so that the port never imports the JAX package.
Every builder returns the same arrays as its reference for the same
arguments and seed.

Conventions
-----------
* ``adj[i, j] = True`` means a directed edge ``i -> j`` (i sends to j).
* Self-loops are never stored; every algorithm adds the implicit
  self-contribution separately (the ``+1`` in ``d_j + 1``).
* A hierarchical system is a block-diagonal adjacency over ``M``
  sub-networks; the parameter server is the only cross-network channel.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, Sequence

import numpy as np

__all__ = [
    "ring",
    "complete",
    "random_strongly_connected",
    "is_strongly_connected",
    "diameter",
    "has_single_source_component",
    "beta_i",
    "HierTopology",
    "make_hierarchy",
    "EdgeList",
    "edge_list",
    "stack_edge_lists",
    "sort_by_dst",
    "is_dst_sorted",
    "random_strongly_connected_edge_list",
    "hier_edge_list",
    "block_complete_edge_list",
    "strongly_connected_components",
    "source_components",
    "reduced_graphs",
    "check_assumption3",
    "NeighborList",
    "neighbor_lists",
    "edge_neighbor_lists",
    "stack_neighbor_lists",
    "edge_masks",
    "link_schedule",
]


# ---------------------------------------------------------------------------
# Basic topologies
# ---------------------------------------------------------------------------

def ring(n: int, bidirectional: bool = False) -> np.ndarray:
    """Directed ring ``0 -> 1 -> ... -> n-1 -> 0``."""
    adj = np.zeros((n, n), dtype=bool)
    for i in range(n):
        adj[i, (i + 1) % n] = True
        if bidirectional:
            adj[(i + 1) % n, i] = True
    return adj


def complete(n: int) -> np.ndarray:
    adj = np.ones((n, n), dtype=bool)
    np.fill_diagonal(adj, False)
    return adj


def random_strongly_connected(
    n: int, extra_edge_prob: float, rng: np.random.Generator
) -> np.ndarray:
    """A random digraph guaranteed strongly connected: a random Hamiltonian
    cycle plus Bernoulli extra edges."""
    perm = rng.permutation(n)
    adj = np.zeros((n, n), dtype=bool)
    for k in range(n):
        adj[perm[k], perm[(k + 1) % n]] = True
    extra = rng.random((n, n)) < extra_edge_prob
    np.fill_diagonal(extra, False)
    adj |= extra
    return adj


def _reach(adj: np.ndarray, start: int) -> np.ndarray:
    """Boolean reachability vector from ``start`` (BFS)."""
    n = adj.shape[0]
    seen = np.zeros(n, dtype=bool)
    seen[start] = True
    frontier = [start]
    while frontier:
        nxt = []
        for u in frontier:
            for v in np.nonzero(adj[u])[0]:
                if not seen[v]:
                    seen[v] = True
                    nxt.append(int(v))
        frontier = nxt
    return seen


def is_strongly_connected(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    if n == 0:
        return False
    return bool(_reach(adj, 0).all() and _reach(adj.T, 0).all())


def diameter(adj: np.ndarray) -> int:
    """Diameter of a strongly connected digraph (max shortest-path length)."""
    n = adj.shape[0]
    dist = np.where(adj, 1, np.inf)
    np.fill_diagonal(dist, 0)
    for k in range(n):  # Floyd–Warshall; n is small in all our sims
        dist = np.minimum(dist, dist[:, k : k + 1] + dist[k : k + 1, :])
    if np.isinf(dist).any():
        raise ValueError("graph is not strongly connected")
    return int(dist.max())


def strongly_connected_components(adj: np.ndarray) -> list[list[int]]:
    """Tarjan's SCC algorithm, iterative (host-side, small graphs)."""
    n = adj.shape[0]
    index = [-1] * n
    low = [0] * n
    on_stack = [False] * n
    stack: list[int] = []
    comps: list[list[int]] = []
    counter = 0
    succ = [list(np.nonzero(adj[u])[0]) for u in range(n)]

    for root in range(n):
        if index[root] != -1:
            continue
        work = [(root, 0)]
        while work:
            u, pi = work[-1]
            if pi == 0:
                index[u] = low[u] = counter
                counter += 1
                stack.append(u)
                on_stack[u] = True
            advanced = False
            for i in range(pi, len(succ[u])):
                v = int(succ[u][i])
                if index[v] == -1:
                    work[-1] = (u, i + 1)
                    work.append((v, 0))
                    advanced = True
                    break
                elif on_stack[v]:
                    low[u] = min(low[u], index[v])
            if advanced:
                continue
            work.pop()
            if work:
                low[work[-1][0]] = min(low[work[-1][0]], low[u])
            if low[u] == index[u]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == u:
                        break
                comps.append(sorted(comp))
    return comps


def source_components(adj: np.ndarray) -> list[list[int]]:
    """SCCs with no incoming edges from outside (sources of the condensation)."""
    comps = strongly_connected_components(adj)
    comp_of = {}
    for ci, comp in enumerate(comps):
        for v in comp:
            comp_of[v] = ci
    has_in = [False] * len(comps)
    rows, cols = np.nonzero(adj)
    for u, v in zip(rows, cols):
        cu, cv = comp_of[int(u)], comp_of[int(v)]
        if cu != cv:
            has_in[cv] = True
    return [comps[ci] for ci in range(len(comps)) if not has_in[ci]]


def has_single_source_component(adj: np.ndarray) -> bool:
    return len(source_components(adj)) == 1


# ---------------------------------------------------------------------------
# Reduced graphs (Definition 1) and Assumption 3
# ---------------------------------------------------------------------------

def reduced_graphs(
    adj: np.ndarray,
    faulty: Sequence[int],
    F: int,
    max_graphs: int | None = None,
    rng: np.random.Generator | None = None,
) -> Iterator[tuple[np.ndarray, list[int]]]:
    """Yield reduced graphs per Definition 1.

    (1) remove faulty nodes and incident links, (2) for each non-faulty node
    remove F additional incoming links (all combinations; sampled when the
    enumeration would exceed ``max_graphs``).

    Yields ``(reduced_adj, good_nodes)`` where ``reduced_adj`` is indexed by
    position in ``good_nodes``.
    """
    n = adj.shape[0]
    faulty_set = set(int(f) for f in faulty)
    good = [v for v in range(n) if v not in faulty_set]
    g = len(good)
    base = adj[np.ix_(good, good)].copy()

    per_node_choices: list[list[tuple[int, ...]]] = []
    for j in range(g):
        incoming = list(np.nonzero(base[:, j])[0])
        if len(incoming) <= F:
            per_node_choices.append([tuple(incoming)])
        else:
            per_node_choices.append(list(itertools.combinations(incoming, F)))

    total = 1
    for c in per_node_choices:
        total *= len(c)
        if max_graphs is not None and total > max_graphs:
            break

    def build(choice_per_node) -> np.ndarray:
        red = base.copy()
        for j, removed in enumerate(choice_per_node):
            for r in removed:
                red[r, j] = False
        return red

    if max_graphs is not None and total > max_graphs:
        rng = rng or np.random.default_rng(0)
        for _ in range(max_graphs):
            choice = [c[rng.integers(len(c))] for c in per_node_choices]
            yield build(choice), good
    else:
        for choice in itertools.product(*per_node_choices):
            yield build(choice), good


def check_assumption3(
    adj: np.ndarray, F: int, max_fault_sets: int = 64, max_graphs: int = 256
) -> bool:
    """Check Assumption 3: every reduced graph has exactly one source component.

    Exhaustive for small graphs, sampled otherwise. A complete graph with
    ``n >= 3F + 1`` always passes (classical result) — we still verify.
    """
    n = adj.shape[0]
    rng = np.random.default_rng(0)
    fault_sets = list(itertools.combinations(range(n), F)) if F > 0 else [()]
    if len(fault_sets) > max_fault_sets:
        idx = rng.choice(len(fault_sets), size=max_fault_sets, replace=False)
        fault_sets = [fault_sets[i] for i in idx]
    for fs in fault_sets:
        for red, _good in reduced_graphs(adj, fs, F, max_graphs=max_graphs, rng=rng):
            if len(source_components(red)) != 1:
                return False
    return True


def beta_i(adj: np.ndarray) -> float:
    """beta_i = 1 / max_j (d_j + 1)^2 — the per-network contraction constant."""
    d_out = adj.sum(axis=1)
    return 1.0 / float((d_out.max() + 1) ** 2)


# ---------------------------------------------------------------------------
# Hierarchical system
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HierTopology:
    """M sub-networks glued block-diagonally; reps exchange with the PS.

    adj: (N, N) bool block-diagonal adjacency; sizes: per-network agent
    counts; offsets: start index of each block; reps: global index of each
    network's designated agent.
    """

    adj: np.ndarray
    sizes: tuple[int, ...]
    offsets: tuple[int, ...]
    reps: tuple[int, ...]

    @property
    def N(self) -> int:
        return int(self.adj.shape[0])

    @property
    def M(self) -> int:
        return len(self.sizes)

    def network_of(self) -> np.ndarray:
        """(N,) network index of every agent."""
        out = np.zeros(self.N, dtype=np.int32)
        for i, (off, sz) in enumerate(zip(self.offsets, self.sizes)):
            out[off : off + sz] = i
        return out

    def block(self, i: int) -> np.ndarray:
        off, sz = self.offsets[i], self.sizes[i]
        return self.adj[off : off + sz, off : off + sz]

    def d_star(self) -> int:
        """D*: the largest sub-network diameter (Theorem 1)."""
        return max(diameter(self.block(i)) for i in range(self.M))

    def min_beta(self) -> float:
        """min_i beta_i over the sub-networks (Theorem 1)."""
        return min(beta_i(self.block(i)) for i in range(self.M))

    def rep_mask(self) -> np.ndarray:
        mask = np.zeros(self.N, dtype=bool)
        for r in self.reps:
            mask[r] = True
        return mask


def make_hierarchy(
    sizes: Sequence[int],
    topology: str = "ring+",
    extra_edge_prob: float = 0.3,
    seed: int = 0,
    rep_choice: str = "first",
) -> HierTopology:
    """Build an M-network hierarchical system.

    topology: "ring" | "complete" | "ring+" (ring + random extra edges).
    """
    rng = np.random.default_rng(seed)
    blocks = []
    for n in sizes:
        if topology == "ring":
            b = ring(n)
        elif topology == "complete":
            b = complete(n)
        elif topology == "ring+":
            b = random_strongly_connected(n, extra_edge_prob, rng)
        else:
            raise ValueError(f"unknown topology {topology!r}")
        if not is_strongly_connected(b):
            raise ValueError(f"block of size {n} is not strongly connected")
        blocks.append(b)
    N = int(sum(sizes))
    adj = np.zeros((N, N), dtype=bool)
    offsets = []
    off = 0
    for b, n in zip(blocks, sizes):
        adj[off : off + n, off : off + n] = b
        offsets.append(off)
        off += n
    if rep_choice == "first":
        reps = tuple(offsets)
    elif rep_choice == "random":
        reps = tuple(int(o + rng.integers(n)) for o, n in zip(offsets, sizes))
    else:
        raise ValueError(rep_choice)
    return HierTopology(
        adj=adj, sizes=tuple(int(s) for s in sizes), offsets=tuple(offsets),
        reps=reps,
    )


# ---------------------------------------------------------------------------
# Sparse edge-list representation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EdgeList:
    """Sparse directed graph: edge ``e`` is ``src[e] -> dst[e]``.

    ``valid`` is False on padding edges, which carry no mass.
    """

    src: np.ndarray    # (E,) int32 sender of each edge
    dst: np.ndarray    # (E,) int32 receiver of each edge
    n: int             # number of nodes
    valid: np.ndarray  # (E,) bool

    @property
    def E(self) -> int:
        return int(self.src.shape[-1])

    @property
    def is_batched(self) -> bool:
        return self.src.ndim == 2

    def out_degree(self) -> np.ndarray:
        """(N,) out-degree over valid edges (the ``d_j`` of ``d_j + 1``)."""
        deg = np.zeros(self.n, dtype=np.int32)
        np.add.at(deg, self.src[self.valid], 1)
        return deg

    def to_dense(self) -> np.ndarray:
        """(N, N) bool adjacency of the valid edges."""
        if self.is_batched:
            raise ValueError("pass one topology draw")
        adj = np.zeros((self.n, self.n), dtype=bool)
        adj[self.src[self.valid], self.dst[self.valid]] = True
        return adj


def edge_list(adj: np.ndarray) -> EdgeList:
    """Dense (N, N) bool adjacency -> :class:`EdgeList` in C order (sorted
    by src, then dst)."""
    src, dst = np.nonzero(np.asarray(adj, dtype=bool))
    return EdgeList(
        src=src.astype(np.int32),
        dst=dst.astype(np.int32),
        n=int(adj.shape[0]),
        valid=np.ones(src.shape[0], dtype=bool),
    )


def stack_edge_lists(adjs: Sequence[np.ndarray]) -> EdgeList:
    """Batch G topology draws of one node count into a padded
    :class:`EdgeList` whose src/dst/valid are (G, E_max).

    Padding edges point ``0 -> 0`` with ``valid=False``; the sparse core
    intersects every mask with ``valid``, so they never carry mass."""
    els = [edge_list(a) for a in adjs]
    n = els[0].n
    if any(el.n != n for el in els):
        raise ValueError("all topology draws must have the same node count")
    E = max(el.E for el in els)
    src = np.zeros((len(els), E), dtype=np.int32)
    dst = np.zeros((len(els), E), dtype=np.int32)
    valid = np.zeros((len(els), E), dtype=bool)
    for g, el in enumerate(els):
        src[g, : el.E] = el.src
        dst[g, : el.E] = el.dst
        valid[g, : el.E] = True
    return EdgeList(src=src, dst=dst, n=n, valid=valid)


def sort_by_dst(el: EdgeList, return_offsets: bool = False):
    """Stable-sort an edge index by receiver -> ``(sorted, perm, inv)``.

    ``perm`` maps a sorted position to its original edge and ``inv`` the
    reverse. With ``return_offsets=True`` a fourth value is returned: the
    (..., N+1) int32 CSR offsets, ``offsets[..., v] : offsets[..., v + 1]``
    being the run of sorted edges whose receiver is ``v``. The CUDA
    edge-scatter kernel walks exactly these runs.

    A batched index (G, E) sorts each draw on its own (``perm``, ``inv``
    and ``offsets`` gain the leading G axis); the padding edges of
    :func:`stack_edge_lists` keep ``dst = 0`` and sort into the ``dst == 0``
    run, after its real edges.
    """
    perm = np.argsort(el.dst, axis=-1, kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    np.put_along_axis(inv, perm, np.broadcast_to(
        np.arange(perm.shape[-1], dtype=np.int32), perm.shape), axis=-1)
    sorted_el = EdgeList(
        src=np.take_along_axis(el.src, perm, axis=-1),
        dst=np.take_along_axis(el.dst, perm, axis=-1),
        n=el.n,
        valid=np.take_along_axis(el.valid, perm, axis=-1),
    )
    if not return_offsets:
        return sorted_el, perm, inv
    return sorted_el, perm, inv, _dst_offsets(sorted_el.dst, el.n)


def is_dst_sorted(dst: np.ndarray) -> bool:
    """Whether every row of ``dst`` (E,) or (G, E) is non-decreasing."""
    return bool(np.all(dst[..., 1:] >= dst[..., :-1]))


def _dst_offsets(sorted_dst: np.ndarray, n: int) -> np.ndarray:
    """(..., N+1) int32 CSR offsets of a dst-sorted edge index."""
    grid = np.arange(n + 1)
    if sorted_dst.ndim == 1:
        return np.searchsorted(sorted_dst, grid, side="left").astype(np.int32)
    return np.stack([np.searchsorted(row, grid, side="left")
                     for row in sorted_dst]).astype(np.int32)


def random_strongly_connected_edge_list(
    n: int,
    extra_edges_per_node: float,
    rng: np.random.Generator,
    sort: bool = True,
) -> EdgeList:
    """A random strongly connected digraph built directly as an EdgeList:
    a random Hamiltonian cycle plus ``round(n * extra_edges_per_node)``
    uniform extra edges, deduplicated, without self-loops."""
    perm = rng.permutation(n).astype(np.int64)
    cyc_src = perm
    cyc_dst = np.roll(perm, -1)
    n_extra = int(round(n * extra_edges_per_node))
    ex_src = rng.integers(0, n, size=n_extra)
    ex_dst = rng.integers(0, n, size=n_extra)
    keep = ex_src != ex_dst
    src = np.concatenate([cyc_src, ex_src[keep]])
    dst = np.concatenate([cyc_dst, ex_dst[keep]])
    _, uniq = np.unique(src * np.int64(n) + dst, return_index=True)
    src, dst = src[uniq], dst[uniq]
    el = EdgeList(
        src=src.astype(np.int32),
        dst=dst.astype(np.int32),
        n=int(n),
        valid=np.ones(src.shape[0], dtype=bool),
    )
    if sort:
        el, _, _ = sort_by_dst(el)
    return el


def hier_edge_list(
    sizes: Sequence[int],
    topology: str = "complete",
    extra_edge_prob: float = 0.3,
    seed: int = 0,
    rep_choice: str = "first",
) -> tuple[EdgeList, np.ndarray]:
    """Hierarchical M-network system built directly as a dst-sorted edge
    list, with no (N, N) array: returns ``(el, rep_mask)``.

    "ring+" blocks are a random Hamiltonian cycle plus
    ``~extra_edge_prob * n^2`` uniform extra edges (deduplicated).
    """
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    off = 0
    offsets = []
    for sz in sizes:
        idx = np.arange(sz, dtype=np.int64)
        if topology == "ring":
            s, d = idx, (idx + 1) % sz
        elif topology == "complete":
            s = np.repeat(idx, sz)
            d = np.tile(idx, sz)
            keep = s != d
            s, d = s[keep], d[keep]
        elif topology == "ring+":
            perm = rng.permutation(sz).astype(np.int64)
            n_extra = int(round(sz * sz * extra_edge_prob))
            ex_s = rng.integers(0, sz, size=n_extra)
            ex_d = rng.integers(0, sz, size=n_extra)
            keep = ex_s != ex_d
            s = np.concatenate([perm, ex_s[keep]])
            d = np.concatenate([np.roll(perm, -1), ex_d[keep]])
            _, uniq = np.unique(s * np.int64(sz) + d, return_index=True)
            s, d = s[uniq], d[uniq]
        else:
            raise ValueError(f"unknown topology {topology!r}")
        srcs.append(off + s)
        dsts.append(off + d)
        offsets.append(off)
        off += int(sz)
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    el = EdgeList(src=src, dst=dst, n=off,
                  valid=np.ones(src.shape[0], dtype=bool))
    el, _, _ = sort_by_dst(el)
    rep_mask = np.zeros(off, dtype=bool)
    if rep_choice == "first":
        reps = np.asarray(offsets)
    elif rep_choice == "random":
        reps = np.asarray([o + rng.integers(sz)
                           for o, sz in zip(offsets, sizes)])
    else:
        raise ValueError(rep_choice)
    rep_mask[reps] = True
    return el, rep_mask


def block_complete_edge_list(
    sizes: Sequence[int],
) -> tuple[EdgeList, np.ndarray]:
    """Hierarchical system of complete sub-networks, built dense-free."""
    return hier_edge_list(sizes, topology="complete")


# ---------------------------------------------------------------------------
# Padded neighbor lists (receiver-major sparse view)
# ---------------------------------------------------------------------------
#
# The Byzantine gossip core (:mod:`repro_torch.core.byzantine`) trims per
# *receiver* over the set of in-neighbor values, so its natural sparse layout
# is receiver-major: one row of in-neighbor indices per agent, padded to the
# maximum in-degree. An :class:`EdgeList` is the edge-major dual used by
# push-sum's per-link state; a :class:`NeighborList` has no per-edge state at
# all — it is a pure gather index consumed by the trim-gather kernel
# (:mod:`repro_torch.kernels.byz_trim`).

@dataclasses.dataclass(frozen=True)
class NeighborList:
    """Padded in-neighbor lists: slot ``(j, k)`` is the k-th in-neighbor of j.

    ``idx[j, k]`` is a *sender* index (``adj[idx[j, k], j]`` is True for
    valid slots); rows are padded to a common ``deg_max`` with ``idx = 0``,
    ``valid = False`` slots, which consumers mask out before trimming.
    Batched/stacked lists (see :func:`stack_neighbor_lists`) carry a leading
    scenario axis on ``idx``/``valid``, topology draws of different degree
    profiles padded to one ``deg_max``.
    """

    idx: np.ndarray    # (N, deg_max) int32 sender per slot, 0 on padding
    valid: np.ndarray  # (N, deg_max) bool — False on padding slots
    n: int             # number of nodes

    @property
    def deg_max(self) -> int:
        """Padded slot count."""
        return int(self.idx.shape[-1])

    def in_degree(self) -> np.ndarray:
        """In-degree per receiver over valid slots (the trim's ``d_j``)."""
        return self.valid.sum(axis=-1).astype(np.int32)


def neighbor_lists(
    topo_or_adj, deg_max: int | None = None, shuffle_seed: int | None = None
) -> NeighborList:
    """Dense (N, N) bool adjacency (or :class:`HierTopology`) -> padded
    in-neighbor lists.

    Slots are emitted in ascending sender order; ``shuffle_seed`` permutes
    each row's valid slots instead (slot order is irrelevant to trimming —
    the equivalence tests exercise both). ``deg_max`` pads beyond the actual
    maximum in-degree, e.g. to align scenario batches.
    """
    adj = topo_or_adj.adj if isinstance(topo_or_adj, HierTopology) else topo_or_adj
    adj = np.asarray(adj, dtype=bool)
    n = adj.shape[0]
    degs = adj.sum(axis=0)
    dm = int(degs.max()) if degs.size else 0
    if deg_max is not None:
        if deg_max < dm:
            raise ValueError(f"deg_max={deg_max} < actual max in-degree {dm}")
        dm = deg_max
    dm = max(dm, 1)  # keep the slot axis non-empty for edgeless graphs
    rng = None if shuffle_seed is None else np.random.default_rng(shuffle_seed)
    idx = np.zeros((n, dm), dtype=np.int32)
    valid = np.zeros((n, dm), dtype=bool)
    for j in range(n):
        nb = np.nonzero(adj[:, j])[0]
        if rng is not None:
            nb = rng.permutation(nb)
        idx[j, : nb.shape[0]] = nb
        valid[j, : nb.shape[0]] = True
    return NeighborList(idx=idx, valid=valid, n=n)


def edge_neighbor_lists(el: EdgeList, deg_max: int | None = None
                        ) -> NeighborList:
    """Padded in-neighbor lists straight from a sparse edge index, with no
    (N, N) array: receiver j's slots are the distinct senders of j's valid
    edges in ascending order, the rows :func:`neighbor_lists` builds from
    the dense adjacency of the same graph. Any edge order is accepted."""
    if el.is_batched:
        raise ValueError("pass one topology draw")
    n = el.n
    pairs = np.unique(el.dst[el.valid].astype(np.int64) * n
                      + el.src[el.valid])       # receiver-major, deduplicated
    dst, src = pairs // n, pairs % n
    deg = np.bincount(dst, minlength=n)
    dm = int(deg.max()) if deg.size else 0
    if deg_max is not None:
        if deg_max < dm:
            raise ValueError(f"deg_max={deg_max} < actual max in-degree {dm}")
        dm = deg_max
    dm = max(dm, 1)  # keep the slot axis non-empty for edgeless graphs
    slot = np.arange(pairs.size) - (np.cumsum(deg) - deg)[dst]
    idx = np.zeros((n, dm), dtype=np.int32)
    valid = np.zeros((n, dm), dtype=bool)
    idx[dst, slot] = src
    valid[dst, slot] = True
    return NeighborList(idx=idx, valid=valid, n=n)


def stack_neighbor_lists(nls: Sequence[NeighborList]) -> NeighborList:
    """Batch neighbor lists onto a leading scenario axis, padded to the
    widest ``deg_max`` with ``idx = 0``, ``valid = False`` slots; ``n``
    must agree across entries."""
    n = nls[0].n
    if any(nl.n != n for nl in nls):
        raise ValueError("all neighbor lists must have the same node count")
    dm = max(nl.deg_max for nl in nls)
    idx = np.zeros((len(nls), n, dm), dtype=np.int32)
    valid = np.zeros((len(nls), n, dm), dtype=bool)
    for g, nl in enumerate(nls):
        idx[g, :, : nl.deg_max] = nl.idx
        valid[g, :, : nl.deg_max] = nl.valid
    return NeighborList(idx=idx, valid=valid, n=n)


def edge_masks(masks: np.ndarray, el: EdgeList) -> np.ndarray:
    """Project a dense (T, N, N) link schedule onto the edge list -> (T, E),
    False on padding edges. The sparse<->dense equivalence tests use it;
    the engines draw (E,) masks per round and never build the schedule."""
    if el.is_batched:
        raise ValueError("pass one topology draw")
    masks = np.asarray(masks)
    return masks[:, el.src, el.dst] & el.valid[None, :]


# ---------------------------------------------------------------------------
# Packet-drop schedules
# ---------------------------------------------------------------------------

def link_schedule(
    adj: np.ndarray,
    T: int,
    drop_prob: float,
    B: int,
    seed: int = 0,
) -> np.ndarray:
    """(T, N, N) bool operational-link masks with guaranteed B-connectivity.

    Each existing link drops packets i.i.d. with ``drop_prob``, but is forced
    operational at every ``t`` with ``t % B == B - 1`` so the paper's fault
    model ("operational at least once every B iterations") holds exactly.
    """
    rng = np.random.default_rng(seed)
    up = rng.random((T, *adj.shape)) >= drop_prob
    t_idx = np.arange(T) % B == B - 1
    up[t_idx] = True
    return up & adj[None, :, :]
