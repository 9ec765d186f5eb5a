"""The port's numpy graph builders and signal model against the reference:
the same arguments and seeds give equal arrays."""
import numpy as np
import pytest

import repro.core.graphs as jg
import repro.core.signals as js
from repro.core.hps import HPSConfig as JaxHPSConfig
import repro_torch.core.graphs as tg
import repro_torch.core.signals as ts
from repro_torch.core.hps import HPSConfig


def _same_edge_list(a, b):
    assert a.n == b.n
    for f in ("src", "dst", "valid"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n", [1, 2, 7])
def test_dense_builders(n):
    np.testing.assert_array_equal(tg.ring(n), jg.ring(n))
    np.testing.assert_array_equal(tg.ring(n, True), jg.ring(n, True))
    np.testing.assert_array_equal(tg.complete(n), jg.complete(n))
    a = tg.random_strongly_connected(n, 0.3, np.random.default_rng(n))
    b = jg.random_strongly_connected(n, 0.3, np.random.default_rng(n))
    np.testing.assert_array_equal(a, b)
    assert tg.is_strongly_connected(a) == jg.is_strongly_connected(b)


def test_is_strongly_connected_negative():
    adj = np.zeros((3, 3), bool)
    adj[0, 1] = adj[1, 2] = True
    assert not tg.is_strongly_connected(adj)
    assert not tg.is_strongly_connected(np.zeros((0, 0), bool))


@pytest.mark.parametrize("topology", ["ring", "complete", "ring+"])
@pytest.mark.parametrize("rep_choice", ["first", "random"])
def test_make_hierarchy(topology, rep_choice):
    a = tg.make_hierarchy([4, 6, 5], topology, seed=3, rep_choice=rep_choice)
    b = jg.make_hierarchy([4, 6, 5], topology, seed=3, rep_choice=rep_choice)
    np.testing.assert_array_equal(a.adj, b.adj)
    assert (a.sizes, a.offsets, a.reps) == (b.sizes, b.offsets, b.reps)
    assert (a.N, a.M) == (b.N, b.M)
    np.testing.assert_array_equal(a.rep_mask(), b.rep_mask())
    _same_edge_list(HPSConfig(a, 4).edge_index(),
                    JaxHPSConfig(b, 4).edge_index())


def test_edge_list_sort_and_offsets():
    adj = jg.random_strongly_connected(9, 0.4, np.random.default_rng(1))
    a, b = tg.edge_list(adj), jg.edge_list(adj)
    _same_edge_list(a, b)
    np.testing.assert_array_equal(a.out_degree(), b.out_degree())
    out_a = tg.sort_by_dst(a, return_offsets=True)
    out_b = jg.sort_by_dst(b, return_offsets=True)
    _same_edge_list(out_a[0], out_b[0])
    for x, y in zip(out_a[1:], out_b[1:]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert tg.is_dst_sorted(out_a[0].dst) and not tg.is_dst_sorted(a.dst)


@pytest.mark.parametrize("n,p,G", [(12, 0.1, 3), (32, 0.02, 2), (5, 0.5, 1)])
def test_stack_edge_lists_and_batched_sort_match_reference(n, p, G):
    """Padding edges 0 -> 0 with valid False; a batched sort sorts each
    draw on its own (the pads into the dst == 0 run) with perm, inv and
    offsets gaining the leading G axis."""
    rng = np.random.default_rng(n)
    adjs = [jg.random_strongly_connected(n, p, rng) for _ in range(G)]
    a, b = tg.stack_edge_lists(adjs), jg.stack_edge_lists(adjs)
    _same_edge_list(a, b)
    assert a.is_batched and a.src.shape == (G, max(x.sum() for x in adjs))
    pad = ~a.valid
    assert (a.src[pad] == 0).all() and (a.dst[pad] == 0).all()
    out_a = tg.sort_by_dst(a, return_offsets=True)
    out_b = jg.sort_by_dst(b, return_offsets=True)
    _same_edge_list(out_a[0], out_b[0])
    for x, y in zip(out_a[1:], out_b[1:]):
        assert x.dtype == y.dtype and x.shape[0] == G
        np.testing.assert_array_equal(x, y)
    assert tg.is_dst_sorted(out_a[0].dst)
    for g in range(G):       # each row as the single-draw sort of its row
        row = tg.EdgeList(src=a.src[g], dst=a.dst[g], n=n, valid=a.valid[g])
        one = tg.sort_by_dst(row, return_offsets=True)
        _same_edge_list(one[0], tg.EdgeList(
            src=out_a[0].src[g], dst=out_a[0].dst[g], n=n,
            valid=out_a[0].valid[g]))
        for x, y in zip(one[1:], out_a[1:]):
            np.testing.assert_array_equal(x, y[g])
        # the pads sort in after the real dst == 0 edges
        zero = out_a[0].valid[g][:out_a[3][g, 1]]
        assert (np.diff(zero.astype(int)) <= 0).all()


def test_stack_edge_lists_needs_one_node_count():
    with pytest.raises(ValueError, match="same node count"):
        tg.stack_edge_lists([tg.ring(4), tg.ring(5)])


@pytest.mark.parametrize("sort", [True, False])
def test_random_strongly_connected_edge_list(sort):
    a = tg.random_strongly_connected_edge_list(
        40, 1.5, np.random.default_rng(2), sort=sort)
    b = jg.random_strongly_connected_edge_list(
        40, 1.5, np.random.default_rng(2), sort=sort)
    _same_edge_list(a, b)


@pytest.mark.parametrize("topology", ["ring", "complete", "ring+"])
@pytest.mark.parametrize("rep_choice", ["first", "random"])
def test_hier_edge_list(topology, rep_choice):
    a, ra = tg.hier_edge_list([5, 3, 8], topology, seed=4,
                              rep_choice=rep_choice)
    b, rb = jg.hier_edge_list([5, 3, 8], topology, seed=4,
                              rep_choice=rep_choice)
    _same_edge_list(a, b)
    np.testing.assert_array_equal(ra, rb)


def test_block_complete_edge_list():
    a, ra = tg.block_complete_edge_list([8] * 5)
    b, rb = jg.block_complete_edge_list([8] * 5)
    _same_edge_list(a, b)
    np.testing.assert_array_equal(ra, rb)


@pytest.mark.parametrize("N,m,S,truth,confusion,seed", [
    (18, 3, 4, 1, 0.5, 0), (64, 3, 4, 0, 0.75, 1), (10, 5, 6, 2, 0.0, 7),
    (4, 4, 3, 3, 1.0, 2),
])
def test_make_confused_model(N, m, S, truth, confusion, seed):
    a = ts.make_confused_model(N, m, S, truth, confusion, seed=seed)
    b = js.make_confused_model(N, m, S, truth, confusion, seed=seed)
    assert a.truth == b.truth and (a.N, a.m, a.S) == (b.N, b.m, b.S)
    np.testing.assert_array_equal(a.tables.numpy(), np.asarray(b.tables))
    t = np.asarray(b.tables)
    np.testing.assert_array_equal(ts.pairwise_kl(t), js.pairwise_kl(t))
    assert ts.check_global_observability(t) == js.check_global_observability(t)
    assert ts.log_ratio_bound(t) == js.log_ratio_bound(t)


def test_confused_model_needs_N_at_least_m():
    with pytest.raises(ValueError):
        ts.make_confused_model(2, 3)


@pytest.mark.parametrize("N,m,S,truth,seed,t_steps", [
    (18, 3, 4, 1, 0, 25), (64, 3, 4, 0, 7, 1), (10, 5, 6, 4, 2**32 - 1, 40)])
def test_signal_model_sample_and_log_lik(N, m, S, truth, seed, t_steps):
    """``sample`` draws the reference's signals bit for bit for the same
    seed (jax.random.choice with p, through split keys); ``log_lik``
    gathers the same table entries (the logs within one ulp: torch's and
    XLA's ``log``)."""
    import jax
    import torch

    from repro_torch import convert
    from repro_torch.core.prng import prng_key

    jm = js.make_confused_model(N, m, S, truth, confusion=0.3, seed=1)
    tm = convert.signal_model_from_numpy(np.asarray(jm.tables), truth)
    got = tm.sample(prng_key(seed), t_steps)
    want = np.asarray(jm.sample(jax.random.PRNGKey(seed), t_steps))
    assert got.shape == want.shape == (t_steps, N)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 <= want.min() and want.max() < S
    for row in got:
        ll = tm.log_lik(row).numpy()
        ref = np.asarray(jm.log_lik(jax.numpy.asarray(row.numpy())))
        assert ll.shape == ref.shape == (N, m)
        np.testing.assert_allclose(ll, ref, rtol=2e-7, atol=0)
        np.testing.assert_array_equal(
            ll, tm.log_tables().numpy()[np.arange(N), :, row.numpy()])
    assert torch.equal(tm.log_lik(got[0].long()), tm.log_lik(got[0]))


# ---- Algorithm 2's graph analysis: components, reduced graphs, A3, and
# the padded neighbor lists ----

def _digraphs():
    rng = np.random.default_rng(5)
    yield jg.ring(6)
    yield jg.complete(5)
    yield jg.random_strongly_connected(9, 0.2, rng)
    two = np.zeros((7, 7), bool)          # two SCCs feeding a third node
    two[0, 1] = two[1, 0] = two[2, 3] = two[3, 2] = True
    two[1, 6] = two[3, 6] = two[6, 5] = True
    yield two
    yield np.zeros((4, 4), bool)
    yield rng.random((10, 10)) < 0.15


@pytest.mark.parametrize("g", range(6))
def test_components_match_reference(g):
    adj = list(_digraphs())[g]
    np.fill_diagonal(adj, False)
    assert (tg.strongly_connected_components(adj)
            == jg.strongly_connected_components(adj))
    assert tg.source_components(adj) == jg.source_components(adj)


@pytest.mark.parametrize("F,max_graphs", [(0, None), (1, None), (1, 20),
                                          (2, 40)])
def test_reduced_graphs_match_reference(F, max_graphs):
    adj = jg.random_strongly_connected(6, 0.5, np.random.default_rng(F))
    for faulty in ([], [2], [0, 4][:F]):
        a = list(tg.reduced_graphs(adj, faulty, F, max_graphs,
                                   np.random.default_rng(9)))
        b = list(jg.reduced_graphs(adj, faulty, F, max_graphs,
                                   np.random.default_rng(9)))
        assert len(a) == len(b) > 0
        for (ra, ga), (rb, gb) in zip(a, b):
            np.testing.assert_array_equal(ra, rb)
            assert ga == gb


@pytest.mark.parametrize("n,topology,F", [
    (7, "complete", 2), (6, "complete", 2), (4, "complete", 1),
    (8, "complete", 2), (6, "ring", 1), (7, "ring+", 1), (9, "ring+", 2),
    (5, "ring", 0),
])
def test_assumption3_verdicts_match_reference(n, topology, F):
    topo = jg.make_hierarchy([n], topology, seed=n)
    assert (tg.check_assumption3(topo.adj, F)
            == jg.check_assumption3(topo.adj, F))


def test_network_of_and_block_match_reference():
    a = tg.make_hierarchy([4, 6, 5], "ring+", seed=3)
    b = jg.make_hierarchy([4, 6, 5], "ring+", seed=3)
    np.testing.assert_array_equal(a.network_of(), b.network_of())
    for i in range(3):
        np.testing.assert_array_equal(a.block(i), b.block(i))


@pytest.mark.parametrize("deg_max,shuffle_seed", [(None, None), (12, None),
                                                  (None, 4), (9, 1)])
def test_neighbor_lists_match_reference(deg_max, shuffle_seed):
    topo = jg.make_hierarchy([5, 7, 3], "ring+", seed=2)
    a = tg.neighbor_lists(topo.adj, deg_max, shuffle_seed)
    b = jg.neighbor_lists(topo.adj, deg_max, shuffle_seed)
    for x, y in ((a.idx, b.idx), (a.valid, b.valid)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert (a.n, a.deg_max) == (b.n, b.deg_max)
    np.testing.assert_array_equal(a.in_degree(), b.in_degree())
    with pytest.raises(ValueError, match="deg_max"):
        tg.neighbor_lists(topo.adj, deg_max=1)


def test_stack_neighbor_lists_matches_reference():
    """Lists of three topologies of one node count (deg_max 1, 4 and the
    widest) batched on a leading axis, padded to the widest deg_max; a
    node-count mismatch raises."""
    topos = [jg.make_hierarchy([5, 5, 5], "ring", seed=0),
             jg.make_hierarchy([5, 5, 5], "complete", seed=0),
             jg.make_hierarchy([5, 7, 3], "ring+", seed=2)]
    got = tg.stack_neighbor_lists([tg.neighbor_lists(t.adj) for t in topos])
    want = jg.stack_neighbor_lists([jg.neighbor_lists(t.adj) for t in topos])
    assert got.n == want.n and got.deg_max == want.deg_max
    for x, y in ((got.idx, want.idx), (got.valid, want.valid)):
        assert x.dtype == y.dtype and x.shape == (3, 15, want.deg_max)
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(got.in_degree(), want.in_degree())
    with pytest.raises(ValueError, match="node count"):
        tg.stack_neighbor_lists([tg.neighbor_lists(topos[0].adj),
                                 tg.neighbor_lists(jg.ring(4))])


@pytest.mark.parametrize("topology", ["ring", "complete", "ring+"])
def test_edge_neighbor_lists_equal_dense_neighbor_lists(topology):
    """The dense-free rows from an edge index equal the reference's rows
    from the dense adjacency, in any edge order, with padding edges and
    duplicate edges ignored."""
    el, _ = tg.hier_edge_list([5, 8, 3, 6], topology, seed=1)
    adj = np.zeros((el.n, el.n), bool)
    adj[el.src, el.dst] = True
    ref = jg.neighbor_lists(adj)
    rng = np.random.default_rng(0)
    perm = rng.permutation(el.E)
    dup = rng.integers(0, el.E, size=5)
    shuffled = tg.EdgeList(
        src=np.concatenate([el.src[perm], el.src[dup], [0, 3]]).astype(
            np.int32),
        dst=np.concatenate([el.dst[perm], el.dst[dup], [1, 1]]).astype(
            np.int32),
        n=el.n, valid=np.concatenate([np.ones(el.E + 5, bool),
                                      [False, False]]))
    for edges in (el, shuffled):
        got = tg.edge_neighbor_lists(edges)
        np.testing.assert_array_equal(got.idx, ref.idx)
        np.testing.assert_array_equal(got.valid, ref.valid)
    wide = tg.edge_neighbor_lists(el, deg_max=ref.deg_max + 3)
    np.testing.assert_array_equal(
        wide.idx, jg.neighbor_lists(adj, deg_max=ref.deg_max + 3).idx)
    empty = tg.EdgeList(src=np.zeros(0, np.int32), dst=np.zeros(0, np.int32),
                        n=4, valid=np.zeros(0, bool))
    assert tg.edge_neighbor_lists(empty).idx.shape == (4, 1)


# ---- Algorithm 1's graph helpers: diameters, contraction constants,
# source components, and the dense link schedules ----

@pytest.mark.parametrize("g", range(6))
def test_algorithm1_helpers_match_reference(g):
    adj = list(_digraphs())[g]
    np.fill_diagonal(adj, False)
    assert (tg.has_single_source_component(adj)
            == jg.has_single_source_component(adj))
    if adj.any():
        assert tg.beta_i(adj) == jg.beta_i(adj)
    if jg.is_strongly_connected(adj):
        assert tg.diameter(adj) == jg.diameter(adj)
    else:
        with pytest.raises(ValueError, match="strongly connected"):
            tg.diameter(adj)


@pytest.mark.parametrize("sizes,topology", [
    ([4, 6, 5], "ring+"), ([24], "ring"), ([6, 6, 6, 6], "ring"),
    ([4, 4], "complete"), ([3, 9], "ring+")])
def test_topology_constants_match_reference(sizes, topology):
    a = tg.make_hierarchy(sizes, topology, seed=3)
    b = jg.make_hierarchy(sizes, topology, seed=3)
    assert a.d_star() == b.d_star()
    assert a.min_beta() == b.min_beta()


@pytest.mark.parametrize("drop,B,seed", [(0.0, 1, 0), (0.4, 3, 1),
                                         (0.9, 5, 2)])
def test_link_schedule_and_edge_masks_match_reference(drop, B, seed):
    adj = jg.random_strongly_connected(11, 0.3, np.random.default_rng(seed))
    a = tg.link_schedule(adj, 17, drop, B, seed=seed)
    b = jg.link_schedule(adj, 17, drop, B, seed=seed)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    for el_t, el_j in ((tg.edge_list(adj), jg.edge_list(adj)),
                       (tg.sort_by_dst(tg.edge_list(adj))[0],
                        jg.sort_by_dst(jg.edge_list(adj))[0])):
        np.testing.assert_array_equal(tg.edge_masks(a, el_t),
                                      jg.edge_masks(b, el_j))
        np.testing.assert_array_equal(el_t.to_dense(), el_j.to_dense())
        np.testing.assert_array_equal(el_t.to_dense(), adj)
    # padding edges are never operational
    padded = tg.EdgeList(src=np.array([0, 3], np.int32),
                         dst=np.array([1, 0], np.int32), n=11,
                         valid=np.array([True, False]))
    masks = tg.edge_masks(np.ones((2, 11, 11), bool), padded)
    np.testing.assert_array_equal(masks, [[True, False]] * 2)
    assert padded.to_dense().sum() == 1
