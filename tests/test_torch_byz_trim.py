"""The port's Byzantine trim-gather (kernel K3's plain version) against the
reference's plain version (``trim_gather_ref``) and its TPU kernel in
interpret mode (``trim_gather_pallas``), the PS-side trimmed pool, and the
route rules of the wrapper. The CUDA kernel itself is held against the
plain version on the card in ``test_torch_kernels_cuda.py``, on the same
problems.

A numpy emulation of the CUDA kernel's arithmetic (its slot table and the
degrees its warp votes count, ordered keys, its sorting network at each
width, the rank-order sum) is held
against the same references, against the float32 rank-order sum bit for
bit, and against the port's plain version.

Tolerances: ``kept`` is a count, so it is equal. ``tsum`` is a sum of the
same survivors; the port and the reference's plain version add them in
sorted order, the Pallas kernel in slot order, so ``tsum`` agrees within
``trim_sum_bound`` (deg_max * eps32 * the sum of the survivors' absolute
values, a bound for any order of the additions). The trimmed pool divides
such a sum by the survivor count (rtol 1e-6 on top)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

from repro.core.hps import ps_trimmed_pool as jax_pool
from repro.kernels.byz_trim.byz_trim import trim_gather_pallas
from repro.kernels.byz_trim.ref import trim_gather_ref as jax_ref
from repro.kernels.trimmed_mean.ref import trimmed_mean_ref as jax_tmean
from repro_torch.core.hps import ps_trimmed_pool
from repro_torch.kernels.byz_trim import (
    trim_gather,
    trim_gather_cuda,
    trim_gather_pairs,
    trim_gather_ref,
)
from repro_torch.kernels.trimmed_mean import trimmed_mean_ref
from test_torch_kernels_cuda import (
    K3_CASES,
    NON_FINITE,
    TRIM_CASES,
    trim_problem,
    trim_rank_order_sum,
    trim_sum_bound,
)
from test_torch_trimmed_mean import key_values, order_keys, sort_network


@pytest.mark.parametrize("case", TRIM_CASES)
@pytest.mark.parametrize("P", [9, 3])
@pytest.mark.parametrize("F", [0, 1, 2, 3])
def test_plain_matches_reference_and_pallas(case, P, F):
    prob = trim_problem(case, P, F, seed=F)
    tsum, kept = trim_gather_ref(*map(torch.from_numpy, prob), F)
    args = tuple(map(jnp.asarray, prob))
    ref = jax_ref(*args, F)
    pal = trim_gather_pallas(*args, F, block_n=16, interpret=True)
    bound = trim_sum_bound(*prob, F)
    for other in (ref, pal):
        np.testing.assert_array_equal(kept.numpy(), np.asarray(other[1]))
        err = np.abs(tsum.numpy() - np.asarray(other[0]))
        assert (err <= bound).all(), err.max()
    assert np.isfinite(tsum.numpy()).all()
    assert (tsum.numpy()[kept.numpy() == 0] == 0).all()


def test_survivor_sum_does_not_cancel_at_attack_scale():
    """Watch-list: survivors are summed through a keep mask. Six +-1e7 lies
    and one honest 0.5 with F = 3: the survivor is 0.5 exactly, which
    total-minus-extremes loses to cancellation in fp32."""
    r = torch.tensor([[0.5]])
    idx = torch.zeros((1, 7), dtype=torch.int32)
    valid = torch.ones((1, 7), dtype=torch.bool)
    msgs = torch.tensor([1e7, -1e7, 1e7, 0.0, -1e7, 1e7, -1e7])[None, :, None]
    byz = torch.tensor([[True, True, True, False, True, True, True]])
    tsum, kept = trim_gather_ref(r, idx, valid, msgs, byz, 3)
    assert tsum.item() == 0.5 and kept.item() == 1.0
    maxima, minima = torch.tensor(3e7), torch.tensor(-3e7)
    total = maxima + torch.tensor(0.5) + minima
    assert (total - maxima - minima).item() != 0.5


def test_broadcast_messages_are_read_through_their_strides():
    r, idx, valid, _, byz_nbr = map(torch.from_numpy,
                                    trim_problem("random", 9, 2))
    view = (torch.arange(9.0) * 1e3).expand(idx.shape + (9,))
    assert view.stride() == (0, 0, 1)
    got = trim_gather_ref(r, idx, valid, view, byz_nbr, 2)
    ref = trim_gather_ref(r, idx, valid, view.contiguous(), byz_nbr, 2)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_pairs_wrapper_and_routes():
    r, idx, valid, msgs, byz_nbr = map(torch.from_numpy,
                                       trim_problem("random", 9, 1))
    flat = trim_gather(r, idx, valid, msgs, byz_nbr, 1)          # auto, CPU
    assert all(torch.equal(a, b) for a, b in
               zip(flat, trim_gather_ref(r, idx, valid, msgs, byz_nbr, 1)))
    tsum, kept = trim_gather_pairs(r.reshape(-1, 3, 3), idx, valid,
                                   msgs.reshape(*msgs.shape[:2], 3, 3),
                                   byz_nbr, 1, backend="torch")
    assert tsum.shape == (r.shape[0], 3, 3)
    assert torch.equal(tsum.reshape(r.shape), flat[0])
    assert torch.equal(kept, flat[1])
    with pytest.raises(ValueError, match="CUDA tensors"):
        trim_gather(r, idx, valid, msgs, byz_nbr, 1, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        trim_gather_cuda(r, idx, valid, msgs, byz_nbr, 1)
    with pytest.raises(ValueError, match="backend"):
        trim_gather(r, idx, valid, msgs, byz_nbr, 1, backend="pallas")


@pytest.mark.parametrize("R,F", [(5, 2), (9, 2), (16, 1), (7, 0), (4, 2)])
def test_ps_trimmed_pool_matches_reference(R, F):
    rng = np.random.default_rng(R + F)
    pool = rng.normal(size=(R, 3, 3)).astype(np.float32)
    pool[0] = 1e6                                  # a lying representative
    valid = rng.random(R) < 0.8
    valid[:2] = True
    got = ps_trimmed_pool(torch.from_numpy(pool), torch.from_numpy(valid), F)
    ref = np.asarray(jax_pool(jnp.asarray(pool), jnp.asarray(valid), F))
    assert got.shape == ref.shape == (3, 3)
    kept = max(int(valid.sum()) - 2 * F, 1)
    bound = R * np.finfo(np.float32).eps * np.abs(pool).sum(0) / kept
    assert (np.abs(got.numpy() - ref) <= bound + 1e-6 * np.abs(ref)).all()


# ---------------------------------------------------------------------------
# K3's arithmetic (csrc/byz_trim.cu), emulated in numpy: each block's slot
# table (where each slot is read: its sender's row of r, its message, or a
# NaN for an invalid or empty slot) with the degrees counted from the
# table's warp votes, one load a slot, ordered keys, Batcher's network at
# the smallest width in {8, 16, 32, 64} that holds deg_max, and ranks
# F .. deg - F - 1 added in float32 in rank order
# ---------------------------------------------------------------------------

K3_WIDTHS = (8, 16, 32, 64)
THREADS, SLOTS = 64, 512            # a block's most threads, table entries


def k3_blocks(n, dm, P):
    """The kernel's launch (``launch<CAP>``): rb = max(1, min(64 // P, 512
    // CAP)) receivers a block, its threads the warps that hold rb * P
    coordinates, at most 64 (a coordinate a thread where P <= 64) ->
    (CAP, threads, [(v0, nv)])."""
    cap = next(w for w in K3_WIDTHS if w >= dm)
    rb = max(1, min(THREADS // P, SLOTS // cap))
    threads = min(THREADS, (rb * P + 31) // 32 * 32)
    return cap, threads, [(v0, min(rb, n - v0)) for v0 in range(0, n, rb)]


def k3_table(valid, byz, cap, threads):
    """A block's slot table, as the kernel's threads build it: in round s0
    (a step of ``threads`` entries), lane l of warp w takes entry e = s0 +
    32 w + l = (jl, k) of its nv receivers' cap slots; kind 0 (invalid or
    k >= deg_max: read a NaN), 1 (honest: the sender's row) or 2
    (Byzantine: the message); the lane of slot k % 32 == 0 counts its
    receiver's degree, part k // 32, by a popcount of its lanes of the
    warp's vote on ``valid`` (a receiver of 64 slots has two parts, from
    two warps, or from two rounds of one warp in a 32-thread block) ->
    (kind (nv, cap), deg (nv,))."""
    nv, dm = valid.shape
    entries = nv * cap
    parts = max(1, cap // 32)
    kind = np.zeros(entries, np.int64)
    deg = np.zeros(nv * parts, np.int64)
    for s0 in range(0, entries, threads):
        for w in range(threads // 32):
            e = s0 + 32 * w + np.arange(32)
            jl, k = e // cap, e % cap
            on = (e < entries) & (k < dm)
            v = np.zeros(32, bool)
            b = np.zeros(32, bool)
            v[on], b[on] = valid[jl[on], k[on]], byz[jl[on], k[on]]
            vote = int((v.astype(np.uint64) << np.arange(32, dtype=np.uint64))
                       .sum())
            live = e < entries
            kind[e[live]] = np.where(v, np.where(b, 2, 1), 0)[live]
            for lane in np.flatnonzero(live & (k % 32 == 0)):
                seg = 0xFFFFFFFF if cap >= 32 else ((1 << cap) - 1) << lane
                deg[jl[lane] * parts + k[lane] // 32] = \
                    bin(vote & seg).count("1")
    return kind.reshape(nv, cap), deg.reshape(nv, parts).sum(axis=1)


def k3_emulate(r, idx, valid, msgs, byz_nbr, F):
    """K3 in numpy -> (tsum, kept), block by block through
    :func:`k3_table`. ``F`` is an int or (N,) per receiver: each receiver
    (each thread of a block) builds its rank window from its own F,
    clamped to [0, CAP]."""
    n, dm = idx.shape
    P = r.shape[1]
    cap, threads, blocks = k3_blocks(n, dm, P)
    f_all = np.clip(np.broadcast_to(np.asarray(F, np.int64), (n,)), 0, cap)
    tsum = np.zeros((n, P), np.float32)
    kept = np.zeros(n, np.float32)
    for v0, nv in blocks:
        F = f_all[v0:v0 + nv]
        kind, deg = k3_table(valid[v0:v0 + nv], byz_nbr[v0:v0 + nv], cap,
                             threads)
        vals = np.full((nv, cap, P), np.nan, np.float32)
        src = np.zeros((nv, cap), np.int64)
        src[:, :dm] = idx[v0:v0 + nv]
        honest = kind == 1
        vals[honest] = r[src[honest]]
        pad = np.full((nv, cap - dm, P), np.nan, np.float32)
        lies = np.concatenate([msgs[v0:v0 + nv], pad], axis=1)
        vals[kind == 2] = lies[kind == 2]
        keys = order_keys(vals).transpose(1, 0, 2).reshape(cap, -1)
        keys = sort_network(keys, cap).reshape(cap, nv, P)
        s = np.zeros((nv, P), np.float32)
        with np.errstate(all="ignore"):
            for q in range(cap):
                on = ((q >= F) & (q < deg - F))[:, None]
                s = np.where(on, s + key_values(keys[q]), s)
        tsum[v0:v0 + nv] = s
        kept[v0:v0 + nv] = np.maximum(deg - 2 * F, 0)
    return tsum, kept


def same_bits(a, b):
    """Bit-equal arrays, every NaN taken as one value."""
    nan = np.isnan(a)
    return np.array_equal(nan, np.isnan(b)) and np.array_equal(
        a.view(np.int32)[~nan], b.view(np.int32)[~nan])


def finite_rows(r, idx, valid, msgs, byz_nbr):
    vals = np.where(byz_nbr[:, :, None], msgs, r[idx])
    return np.where(valid[:, :, None], np.isfinite(vals), True).all((1, 2))


@pytest.mark.parametrize("n,dm,P,threads", [
    (37, 7, 9, 64), (131, 64, 1, 32), (77, 32, 1, 32), (1001, 33, 3, 32),
    (5, 1, 300, 64), (300, 16, 9, 64), (77, 20, 3, 64), (50, 8, 3, 64)])
def test_k3_blocks_and_table_degrees(n, dm, P, threads):
    """The block partition covers every receiver once within the kernel's
    table and thread limits (a coordinate a thread where P <= 64; 32-thread
    blocks where rb * P <= 32, so a 64-slot receiver's two votes come from
    successive rounds of one warp), and the degrees the table's warp votes
    give are each row's count of valid slots, at every width."""
    rng = np.random.default_rng(3)
    cap, got_threads, blocks = k3_blocks(n, dm, P)
    assert got_threads == threads
    assert [v for v0, nv in blocks for v in range(v0, v0 + nv)] \
        == list(range(n))
    assert all(nv * cap <= SLOTS for _, nv in blocks)
    assert all(nv * P <= threads or nv == 1 for _, nv in blocks)
    valid = rng.random((n, dm)) < 0.6
    byz = rng.random((n, dm)) < 0.3
    for v0, nv in blocks:
        kind, deg = k3_table(valid[v0:v0 + nv], byz[v0:v0 + nv], cap,
                             threads)
        np.testing.assert_array_equal(deg, valid[v0:v0 + nv].sum(1))
        np.testing.assert_array_equal(kind[:, :dm] > 0, valid[v0:v0 + nv])
        np.testing.assert_array_equal(
            kind[:, :dm] == 2, valid[v0:v0 + nv] & byz[v0:v0 + nv])
        assert (kind[:, dm:] == 0).all()


@pytest.mark.parametrize("case", TRIM_CASES + K3_CASES)
@pytest.mark.parametrize("F", [0, 1, 2, 3, 4])
def test_k3_arithmetic_is_the_rank_order_sum(case, F):
    """The emulated kernel, at every width of its network, equals the
    float32 rank-order sum bit for bit (NaN where it is NaN); its survivors
    are the port's plain version's (the sorted window, bit for bit, on
    rows whose values are finite) and so is kept; its sum is within the
    order bound of the plain version's, and bit-equal to it where the
    values are integers (every order of the sum exact)."""
    P = 3 if case in ("wide", "deg_max_64") else 9
    prob = trim_problem(case, P, F, seed=F + 20)
    tsum, kept = k3_emulate(*prob, F)
    assert same_bits(tsum, trim_rank_order_sum(*prob, F))
    t_ref, k_ref = trim_gather_ref(*map(torch.from_numpy, prob), F)
    np.testing.assert_array_equal(kept, k_ref.numpy())
    fin = finite_rows(*prob)
    err = np.abs(tsum[fin] - t_ref.numpy()[fin])
    assert (err <= trim_sum_bound(*prob, F)[fin]).all()
    if case == "ties":
        np.testing.assert_array_equal(tsum, t_ref.numpy())
    assert (tsum[kept == 0] == 0).all()


@pytest.mark.parametrize("dm,F,case", [
    (1, 0, "single_slot"), (7, 2, "random"), (7, 3, "scattered"),
    (20, 4, "wide"), (33, 1, "deg_max_33"), (33, 4, "deg_max_33"),
    (64, 2, "scattered_64"), (64, 3, "deg_max_64"), (64, 4, "huge_64"),
    (64, 0, "under_trimmed_64")])
def test_k3_arithmetic_matches_reference_and_pallas(dm, F, case):
    """The emulated kernel against the reference's plain version and its
    TPU kernel in interpret mode (slot-order sums) within the order bound,
    at deg_max 1, 7, 20, 33 and 64, shuffled and padded rows, +-1e6 lies."""
    if case == "huge_64":
        r, idx, valid, _, byz = trim_problem("deg_max_64", 9, F, seed=5)
        msgs = np.where(np.random.default_rng(5).random(idx.shape + (9,))
                        < 0.5, -1e6, 1e6).astype(np.float32)
        byz = valid & (np.cumsum(valid, axis=1) <= F)
        prob = (r, idx, valid, msgs, byz)
    else:
        prob = trim_problem(case, 9, F, seed=dm + F)
    assert prob[1].shape[1] == dm
    tsum, kept = k3_emulate(*prob, F)
    args = tuple(map(jnp.asarray, prob))
    bound = trim_sum_bound(*prob, F)
    for want in (jax_ref(*args, F),
                 trim_gather_pallas(*args, F, block_n=16, interpret=True)):
        np.testing.assert_array_equal(kept, np.asarray(want[1]))
        assert (np.abs(tsum - np.asarray(want[0])) <= bound).all()


@pytest.mark.parametrize("case", ["nan", "nan_sign", "inf"])
@pytest.mark.parametrize("F", [1, 3])
def test_k3_trims_non_finite_lies_as_the_tpu_kernel(case, F):
    """Rows with at most F NaN, sign-bit NaN or +-inf lies: the TPU kernel
    (interpret mode) extracts them as extremes (``argmax`` takes a NaN as
    the largest value) and sums the survivors through ``where(keep, vals,
    0)``; the emulated K3 selects the same survivors by rank, within the
    order bound. The reference's plain version sums ``s * keep``, and a
    trimmed NaN or inf times 0 is NaN: its row is NaN, and the port's plain
    version keeps that quirk."""
    prob = trim_problem(case, 9, F, seed=F)
    tsum, kept = k3_emulate(*prob, F)
    args = tuple(map(jnp.asarray, prob))
    pal = trim_gather_pallas(*args, F, block_n=16, interpret=True)
    np.testing.assert_array_equal(kept, np.asarray(pal[1]))
    assert np.isfinite(tsum).all()
    assert (np.abs(tsum - np.asarray(pal[0]))
            <= trim_sum_bound(*prob, F)).all()
    r, idx, valid, msgs, byz = prob
    vals = np.where(byz[:, :, None], msgs, r[idx])
    lied = (valid[:, :, None] & ~np.isfinite(vals)).any(axis=1)
    assert lied.any()
    ref = np.asarray(jax_ref(*args, F)[0])
    plain = trim_gather_ref(*map(torch.from_numpy, prob), F)[0].numpy()
    np.testing.assert_array_equal(np.isnan(ref), lied)
    np.testing.assert_array_equal(np.isnan(plain), lied)


@pytest.mark.parametrize("dm", [33, 48, 64])
def test_plain_trims_order_sign_bit_nans_as_jnp_sort(dm):
    """The plain trim-gather and trimmed mean at widths 33-64 with NaNs
    that have the sign bit set, against the reference's jnp.sort-based
    versions: every NaN sorts last, so at most F such values are trimmed
    away and more leave NaN."""
    F = 3
    prob = trim_problem("nan_sign", 9, F, seed=dm, n=41)
    r, idx, valid, msgs, byz = prob
    pad = np.zeros((41, dm - 33), bool)
    prob = (r, np.concatenate([idx, pad.astype(np.int32)], 1),
            np.concatenate([valid, ~pad], 1),
            np.concatenate([msgs, np.ones((41, dm - 33, 9), np.float32)], 1),
            np.concatenate([byz, pad], 1))
    tsum, kept = trim_gather_ref(*map(torch.from_numpy, prob), F)
    want = jax_ref(*map(jnp.asarray, prob), F)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(np.isnan(tsum.numpy()),
                                  np.isnan(np.asarray(want[0])))
    fin = ~np.isnan(np.asarray(want[0]))
    assert (np.abs(tsum.numpy() - np.asarray(want[0]))[fin]
            <= trim_sum_bound(*prob, F)[fin]).all()
    neg_nan = NON_FINITE["nan_sign"][0]
    x = np.random.default_rng(dm).normal(size=(dm, 50)).astype(np.float32)
    for count in (F, F + 1):
        x[:count] = neg_nan
        got = trimmed_mean_ref(torch.from_numpy(x), F).numpy()
        ref = np.asarray(jax_tmean(jnp.asarray(x), F))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        assert np.isnan(got).all() == (count > F)
        fin = np.isfinite(ref)
        bound = dm * np.finfo(np.float32).eps * np.where(
            np.isfinite(x), np.abs(x), 0).sum(0) / (dm - 2 * F)
        assert (np.abs(got - ref)[fin] <= bound[fin]).all()


# ---------------------------------------------------------------------------
# F per receiver: a grid of scenarios stacked into one graph trims each
# scenario's receivers by its own F
# ---------------------------------------------------------------------------

def mixed_f(n, seed, top=4):
    """(N,) int32 trim counts 0..top, neighbours in a block differing,
    every fifth 0."""
    f = np.random.default_rng(seed).integers(0, top + 1, size=n)
    f[::5] = 0
    return f.astype(np.int32)


@pytest.mark.parametrize("case", TRIM_CASES + K3_CASES)
def test_plain_with_tensor_f_is_each_rows_own_f(case):
    """The plain version with an (N,) tensor F equals the reference's plain
    version called with each F on its own rows (kept equal, tsum within
    the order bound, bit-equal to the port's own int-F call on those
    rows); a uniform tensor F equals the int call bit for bit."""
    P = 3 if case in ("wide", "deg_max_64") else 9
    prob = trim_problem(case, P, 2, seed=7)
    n = prob[0].shape[0]
    Fr = mixed_f(n, 1)
    args = tuple(map(torch.from_numpy, prob))
    tsum, kept = trim_gather_ref(*args, torch.from_numpy(Fr))
    fin = finite_rows(*prob)
    for F in np.unique(Fr):
        rows = Fr == F
        want = jax_ref(*map(jnp.asarray, prob), int(F))
        np.testing.assert_array_equal(kept.numpy()[rows],
                                      np.asarray(want[1])[rows])
        on = rows & fin
        err = np.abs(tsum.numpy()[on] - np.asarray(want[0])[on])
        assert (err <= trim_sum_bound(*prob, int(F))[on]).all()
        own = trim_gather_ref(*args, int(F))
        assert same_bits(tsum.numpy()[rows], own[0].numpy()[rows])
        assert torch.equal(kept[rows], own[1][rows])
    uniform = trim_gather_ref(*args, torch.full((n,), 2, dtype=torch.int32))
    assert all(same_bits(a.numpy(), b.numpy()) for a, b in
               zip(uniform, trim_gather_ref(*args, 2)))
    assert (tsum.numpy()[(kept.numpy() == 0) & fin] == 0).all()


@pytest.mark.parametrize("case", TRIM_CASES + K3_CASES)
def test_k3_arithmetic_with_f_per_receiver(case):
    """The emulated kernel with a per-receiver F (0 .. deg_max / 2 + 1, so
    F = 0 rows and rows with deg <= 2F sit beside trimmed rows in one
    block) is, row by row, its own run at that row's F, and equals the
    float32 rank-order sum at that F bit for bit."""
    P = 3 if case in ("wide", "deg_max_64") else 9
    prob = trim_problem(case, P, 2, seed=11)
    n, dm = prob[1].shape
    Fr = mixed_f(n, 2, top=max(4, dm // 2 + 1))
    tsum, kept = k3_emulate(*prob, Fr)
    for F in np.unique(Fr):
        rows = Fr == F
        t1, k1 = k3_emulate(*prob, int(F))
        assert same_bits(tsum[rows], t1[rows])
        np.testing.assert_array_equal(kept[rows], k1[rows])
        assert same_bits(tsum[rows],
                         trim_rank_order_sum(*prob, int(F))[rows])
    deg = prob[2].sum(1)
    assert ((deg <= 2 * Fr) & (deg > 0)).any() and (Fr == 0).any()
    assert (tsum[kept == 0] == 0).all()


def test_k3_clamps_f_past_the_slot_count():
    """An F past the network's width keeps nothing, as F = CAP does."""
    prob = trim_problem("random", 9, 2, seed=3)
    n = prob[0].shape[0]
    big = k3_emulate(*prob, np.full(n, 1000, np.int32))
    assert (big[0] == 0).all() and (big[1] == 0).all()
    ref = trim_gather_ref(*map(torch.from_numpy, prob),
                          torch.full((n,), 1000, dtype=torch.int32))
    assert (ref[0] == 0).all() and (ref[1] == 0).all()


def test_pairs_wrapper_takes_a_tensor_f():
    prob = trim_problem("random", 9, 1)
    r, idx, valid, msgs, byz_nbr = map(torch.from_numpy, prob)
    Fr = torch.from_numpy(mixed_f(r.shape[0], 3))
    flat = trim_gather(r, idx, valid, msgs, byz_nbr, Fr)
    tsum, kept = trim_gather_pairs(r.reshape(-1, 3, 3), idx, valid,
                                   msgs.reshape(*msgs.shape[:2], 3, 3),
                                   byz_nbr, Fr, backend="torch")
    assert torch.equal(tsum.reshape(r.shape), flat[0])
    assert torch.equal(kept, flat[1])
    with pytest.raises(ValueError, match="CUDA tensors"):
        trim_gather_cuda(r, idx, valid, msgs, byz_nbr, Fr)
