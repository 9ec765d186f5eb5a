"""The port's coordinate-wise trimmed mean (``repro_torch.kernels.
trimmed_mean``) against the JAX package's on the CPU: its plain version
against ``trimmed_mean_ref`` and against the TPU kernel
``trimmed_mean_pallas`` run in interpret mode, a numpy emulation of the
CUDA kernel's arithmetic (ordered keys, its sorting networks, the
rank-order sum) against both, the route dispatch, and
``trimmed_mean_pytree``'s dtype round trip.

Tolerances: both sides sum the same survivors in float32, in another
order (a sorted slice on both plain versions; worker order in the TPU
kernel), so they agree within ``tmean_bound`` of the CUDA tests: W * eps32
* sum |x| / (W - 2F) per coordinate, a bound for any order of the
additions (the CUDA kernel is held to the same bound on the card). Where
inf or NaN survives the trim both sides give inf or NaN.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

from repro.kernels.trimmed_mean.ops import (
    trimmed_mean_pytree as jax_trimmed_mean_pytree,
)
from repro.kernels.trimmed_mean.ref import trimmed_mean_ref as jax_ref
from repro.kernels.trimmed_mean.trimmed_mean import trimmed_mean_pallas
from repro_torch.kernels.trimmed_mean import (
    W_MAX,
    trimmed_mean,
    trimmed_mean_cuda,
    trimmed_mean_pytree,
    trimmed_mean_ref,
)
from test_torch_kernels_cuda import TMEAN_CASES
from test_torch_kernels_cuda import tmean_bound as trim_bound
from test_torch_kernels_cuda import tmean_problem as problem

CASES = [(3, 1, 17, "normal"), (4, 1, 64, "ties"), (5, 2, 333, "normal"),
         (8, 0, 100, "normal"), (8, 2, 1000, "byzantine"),
         (8, 3, 129, "ties"), (16, 7, 257, "huge_scale"),
         (16, 3, 500, "byzantine"), (32, 15, 96, "ties"),
         (32, 7, 130, "byzantine"), (33, 16, 40, "byzantine"),
         (48, 5, 70, "ties"), (64, 31, 64, "normal"),
         (64, 2, 33, "byzantine")]


@pytest.mark.parametrize("W,F,D,case", CASES)
def test_plain_matches_reference_and_tpu_kernel(W, F, D, case):
    x = problem(W, D, case)
    got = trimmed_mean(torch.from_numpy(x), F).numpy()
    bound = trim_bound(x, F)
    for want in (np.asarray(jax_ref(jnp.asarray(x), F)),
                 np.asarray(trimmed_mean_pallas(jnp.asarray(x), F,
                                                block_d=128))):
        assert got.shape == (D,) and got.dtype == np.float32
        assert (np.abs(got - want) <= bound).all(), \
            float(np.abs(got - want).max())


# ---------------------------------------------------------------------------
# K4's arithmetic (csrc/trimmed_mean.cu), emulated in numpy: ordered keys,
# Batcher's sorting network at each compile-time width, the rank-order sum
# ---------------------------------------------------------------------------

WIDTHS = (4, 8, 16, 32, 64)     # the kernel's instantiations (WMAX)
SIGN = np.uint32(0x80000000)


@functools.lru_cache(maxsize=None)
def batcher_pairs(n):
    """Batcher's odd-even merge sort on n = 2^k slots, the compare-exchanges
    in the order of the kernel's compile-time loops (``batcher_pair``)."""
    pairs, p = [], 1
    while p < n:
        k = p
        while k >= 1:
            j = k % p
            while j + k < n:
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
                j += 2 * k
            k //= 2
        p *= 2
    return pairs


def order_keys(x):
    """float32 -> uint32 keys whose unsigned order is the sort order, every
    NaN made the positive quiet NaN first (the kernel's ``order_key``)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32).copy()
    bits[np.isnan(x)] = 0x7FC00000
    return bits ^ ((bits.view(np.int32) >> 31).view(np.uint32) | SIGN)


def key_values(k):
    """The kernel's ``key_value``: a key back to its float, bit for bit."""
    return (k ^ (((~k).view(np.int32) >> 31).view(np.uint32) | SIGN)).view(
        np.float32)


def sort_network(keys, n):
    """Apply the n-slot network to (n, D) keys, column by column."""
    keys = keys.copy()
    for a, b in batcher_pairs(n):
        lo = np.minimum(keys[a], keys[b])
        keys[b] = np.maximum(keys[a], keys[b])
        keys[a] = lo
    return keys


def k4_emulate(x, F):
    """K4 in numpy: F = 0 the worker-order float32 sum / W; else keys
    padded with the largest key to the smallest width that holds W, the
    network, and ranks F .. W-F-1 added in rank order in float32."""
    W, D = x.shape
    s = np.zeros(D, np.float32)
    if F == 0:
        for w in range(W):
            s = s + x[w]
        return s / np.float32(W)
    wmax = next(m for m in WIDTHS if m >= W)
    keys = np.concatenate([order_keys(x), np.full((wmax - W, D), 0xFFFFFFFF,
                                                  np.uint32)])
    vals = key_values(sort_network(keys, wmax))
    for r in range(F, W - F):
        s = s + vals[r]
    return s / np.float32(W - 2 * F)


@pytest.mark.parametrize("n,size", [(4, 5), (8, 19), (16, 63), (32, 191),
                                    (64, 543)])
def test_sorting_network_sorts(n, size):
    """Each width's network: its size (19 compare-exchanges of depth 6 at
    8 slots), and it sorts every 0-1 input up to 16 slots (so every input,
    by the 0-1 principle) and random 0-1 and integer inputs at 32 and 64."""
    pairs = batcher_pairs(n)
    assert len(pairs) == size and all(a < b < n for a, b in pairs)
    if n == 8:
        depth = [0] * n
        for a, b in pairs:
            depth[a] = depth[b] = max(depth[a], depth[b]) + 1
        assert max(depth) == 6
    rng = np.random.default_rng(n)
    if n <= 16:
        bits = (np.arange(2 ** n)[None, :] >> np.arange(n)[:, None]) & 1
        cols = [bits.astype(np.uint32)]
    else:
        cols = [rng.integers(0, 2, size=(n, 20000)).astype(np.uint32),
                rng.integers(0, 2 ** 32, size=(n, 2000), dtype=np.uint32)]
    for keys in cols:
        np.testing.assert_array_equal(sort_network(keys, n),
                                      np.sort(keys, axis=0))


def test_order_keys_sort_as_torch_sort():
    """Keys sort every float32 as torch.sort does, NaNs of either sign
    last (a key of the raw bits would put 0xFFC00000 below -inf), and
    decode back bit for bit (every NaN as the positive quiet NaN)."""
    rng = np.random.default_rng(7)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                        3.4e38, -3.4e38], np.float32)
    nans = np.array([0xFFC00000, 0xFF800001, 0x7FC00001], np.uint32).view(
        np.float32)
    scaled = rng.normal(size=500) * 10.0 ** rng.integers(-44, 37, size=500)
    x = np.concatenate([special, nans, scaled.astype(np.float32)])
    k = order_keys(x)
    assert (order_keys(nans) == order_keys(np.float32(np.nan))).all()
    np.testing.assert_array_equal(key_values(np.sort(k)),
                                  torch.sort(torch.from_numpy(x)).values)
    fin = ~np.isnan(x)
    np.testing.assert_array_equal(key_values(k)[fin].view(np.uint32),
                                  x[fin].view(np.uint32))
    assert (key_values(k)[~fin].view(np.uint32) == 0x7FC00000).all()


@pytest.mark.parametrize("W,F,D,case,offset", TMEAN_CASES)
def test_kernel_arithmetic_matches_plain_and_tpu_kernel(W, F, D, case,
                                                        offset):
    """The emulated K4, at every width it is instantiated for, against the
    port's plain version, the reference's and the TPU kernel in interpret
    mode: the same NaN and inf, the finite values within ``trim_bound``.

    The TPU kernel ranks a NaN as unordered, so a NaN that survives the
    trim (``too_many_nan``; ``nan_sign`` at F = 1) drops out of its sum,
    where the reference's sort keeps it last and the result is NaN: it is
    held only on the coordinates where the reference gives no NaN."""
    x = problem(W, D + offset, case)[:, offset:]
    got = k4_emulate(x, F)
    bound = trim_bound(x, F)
    ref = np.asarray(jax_ref(jnp.asarray(x), F))
    pal = np.asarray(trimmed_mean_pallas(jnp.asarray(x), F, block_d=1024))
    keep = ~np.isnan(ref)
    for want, on in ((trimmed_mean_ref(torch.from_numpy(
            np.ascontiguousarray(x)), F).numpy(), slice(None)),
                     (ref, slice(None)), (pal, keep)):
        g, w = got[on], want[on]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_array_equal(np.isposinf(g), np.isposinf(w))
        np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w))
        fin = np.isfinite(w)
        assert (np.abs(g - w)[fin] <= bound[on][fin]).all()


@pytest.mark.parametrize("case", ["normal", "ties", "nan_sign"])
def test_kernel_arithmetic_at_every_width_and_trim(case):
    """The emulated K4 against the port's plain version for every W from 1
    to 64 and every F up to (W - 1) // 2, as the CUDA test runs the kernel
    on the card."""
    for W in range(1, W_MAX + 1):
        x = problem(W, 37, case, seed=W)
        for F in range((W - 1) // 2 + 1):
            got = k4_emulate(x, F)
            want = trimmed_mean_ref(torch.from_numpy(x), F).numpy()
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            fin = np.isfinite(want)
            assert (np.abs(got - want)[fin] <= trim_bound(x, F)[fin]).all()


def test_keep_mask_survives_byzantine_magnitudes():
    """F = 2 rows at +-1e6 beside O(1) honest values: the trimmed mean is
    the honest values' trimmed mean, with no cancellation error."""
    W, F, D = 8, 2, 64
    rng = np.random.default_rng(3)
    honest = rng.normal(size=(W - 2, D)).astype(np.float32)
    x = np.concatenate([honest, np.full((1, D), 1e6, np.float32),
                        np.full((1, D), -1e6, np.float32)])
    got = trimmed_mean(torch.from_numpy(x), F).numpy()
    s = np.sort(honest, axis=0)
    want = s[1:-1].mean(axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("value", [np.inf, -np.inf, np.nan])
@pytest.mark.parametrize("count", [1, 2, 3])
def test_non_finite_rows_match_the_reference(value, count):
    """inf and NaN sort past the ends as in ``jnp.sort`` (NaN above +inf):
    up to F such rows are trimmed away; more leave inf or NaN, as in the
    reference."""
    W, F, D = 7, 2, 33
    x = problem(W, D, "normal", seed=4)
    x[:count] = value
    got = trimmed_mean(torch.from_numpy(x), F).numpy()
    want = np.asarray(jax_ref(jnp.asarray(x), F))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert (np.abs(got[fin] - want[fin]) <= trim_bound(x, F)[fin]).all()


@pytest.mark.parametrize("W,F", [(2, 1), (4, 2), (5, 3), (1, 1)])
def test_w_at_most_2f_raises(W, F):
    x = torch.zeros((W, 8))
    with pytest.raises(ValueError, match="W > 2F"):
        trimmed_mean(x, F)
    with pytest.raises(ValueError):
        jax_ref(jnp.zeros((W, 8)), F)


def test_routes_on_the_cpu():
    x = torch.from_numpy(problem(8, 40, "normal"))
    assert torch.equal(trimmed_mean(x, 2, backend="torch"),
                       trimmed_mean_ref(x, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        trimmed_mean(x, 2, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        trimmed_mean_cuda(x, 2)
    with pytest.raises(ValueError, match="out="):
        trimmed_mean(x, 2, out=torch.empty(40))
    with pytest.raises(ValueError, match="backend"):
        trimmed_mean(x, 2, backend="pallas")
    assert W_MAX == 64


@pytest.mark.parametrize("as_dict", [True, False])
def test_pytree_round_trips_each_leaf_dtype(as_dict):
    """Leaves are trimmed in float32 as one (W, D_total) matrix and each
    comes back in its own dtype: bf16 leaves as bf16, the reference's
    values rounded once."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(8, 3, 5)).astype(np.float32)
    b = rng.normal(size=(8, 7)).astype(np.float32)
    c = rng.normal(size=(8, 4)).astype(np.float32)
    jt = {"a": jnp.asarray(a), "b": jnp.asarray(b, jnp.bfloat16),
          "c": jnp.asarray(c)}
    tt = {"a": torch.from_numpy(a), "b": torch.from_numpy(b).bfloat16(),
          "c": torch.from_numpy(c)}
    want = jax_trimmed_mean_pytree(jt, 2, backend="xla")
    if as_dict:
        got = trimmed_mean_pytree(tt, 2)
    else:
        got = dict(zip("abc", trimmed_mean_pytree([tt[k] for k in "abc"],
                                                  2)))
    for k in "abc":
        assert got[k].dtype == tt[k].dtype
        assert tuple(got[k].shape) == tt[k].shape[1:]
        w = np.asarray(want[k], np.float32)
        g = got[k].float().numpy()
        tol = 2 ** -8 * np.abs(w) + 1e-6 if k == "b" else 1e-6
        assert (np.abs(g - w) <= tol).all(), k


def test_train_cli_takes_48_workers_through_the_trimmed_mean(capsys):
    """``launch.train --workers 48 --agg trimmed_mean`` takes a step (the
    reference's kernel takes up to 64 workers; on the card the same run
    goes through K4's 64-wide instantiation)."""
    from repro_torch.launch.train import main
    main(["--arch", "paper_sim", "--reduced", "--steps", "1", "--seq-len",
          "32", "--global-batch", "48", "--agg", "trimmed_mean", "--trim-f",
          "2", "--workers", "48", "--byzantine", "1,7", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "done" and lines[0].startswith("step     0 loss ")
    assert np.isfinite(float(lines[0].split()[3]))
