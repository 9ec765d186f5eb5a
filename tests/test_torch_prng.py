"""The port's threefry PRNG against ``jax.random``: keys, fold-ins and
uniform draws are bit-equal, so the port draws the reference's link masks
and private signals exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

from repro.core.pushsum import step_edge_mask as jax_step_edge_mask
from repro_torch.core.prng import fold_in, prng_key, random_bits, uniform
from repro_torch.core.pushsum import step_edge_mask

SEEDS = [0, 3, 100, 2**31 - 1]
FOLDS = [0, 1, 7, 12345, np.int32(-5), ~np.int32(9), -(12 * 7 + 3) - 2**21]


def _key_words(k):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_bit_equal(seed):
    assert tuple(prng_key(seed)) == _key_words(jax.random.PRNGKey(seed))
    for d in FOLDS:
        ref = jax.random.fold_in(jax.random.PRNGKey(seed), np.int32(d))
        assert tuple(fold_in(prng_key(seed), d)) == _key_words(ref), d


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 6, 1000])
def test_uniform_bit_equal(seed, n):
    for d in FOLDS:
        ref = np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.PRNGKey(seed), np.int32(d)), (n,)))
        got = uniform(fold_in(prng_key(seed), d), n, "cpu").numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_bits_bit_equal():
    key = fold_in(prng_key(11), 4)
    ref = np.asarray(jax.random.bits(
        jax.random.fold_in(jax.random.PRNGKey(11), 4), (257,)))
    np.testing.assert_array_equal(random_bits(key, 257, "cpu").numpy(),
                                  ref.astype(np.int64))


def test_seed_range_checked():
    with pytest.raises(ValueError):
        prng_key(2**32)


@pytest.mark.parametrize("drop,B", [(0.0, 1), (0.3, 3), (0.7, 4)])
def test_step_edge_mask_bit_equal(drop, B):
    E = 333
    for t in range(7):
        for fold_t in (None, 2 * t):
            ref = np.asarray(jax_step_edge_mask(
                jax.random.PRNGKey(5), jnp.int32(t), E, jnp.float32(drop),
                jnp.int32(B), fold_t=fold_t))
            got = step_edge_mask(
                prng_key(5), t, E, torch.tensor(drop, dtype=torch.float32),
                torch.tensor(B, dtype=torch.int32), fold_t=fold_t)
            np.testing.assert_array_equal(got.numpy(), ref)


# ---- the draws of Algorithm 2: split, randint over a tensor of keys,
# choice without replacement, and normal ----

from repro_torch.core.prng import choice, normal, randint, split  # noqa: E402


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 7, 300])
def test_split_bit_equal(seed, n):
    keys = split(prng_key(seed), n, "cpu")
    ref = np.asarray(jax.random.key_data(
        jax.random.split(jax.random.PRNGKey(seed), n)))
    np.testing.assert_array_equal(keys.k0.numpy(), ref[:, 0])
    np.testing.assert_array_equal(keys.k1.numpy(), ref[:, 1])
    for i in (0, n - 1):     # split(k, n)[i] == fold_in(k, i)
        assert (keys.k0[i].item(), keys.k1[i].item()) == tuple(
            fold_in(prng_key(seed), i))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("minval", [0, 5])
def test_randint_over_a_tensor_of_keys_bit_equal(seed, minval):
    """One draw per key, as the fusion draws one representative per
    network under vmap; maxval per key, spans from empty to 2^31 - 1
    (the uint32 wrap of jax's multiplier above 2^16 included)."""
    rng = np.random.default_rng(seed % 1000)
    maxval = rng.integers(1, 2**31 - 1, size=400).astype(np.int32)
    maxval[:12] = [1, 2, 3, 7, 8, 0, -3, 5, 65536, 65537, 2**20 + 3,
                   2**31 - 1]
    ks = jax.random.split(jax.random.PRNGKey(seed), maxval.size)
    ref = np.asarray(jax.vmap(
        lambda k, s: jax.random.randint(k, (), minval, s))(
            ks, jnp.asarray(maxval)))
    got = randint(split(prng_key(seed), maxval.size, "cpu"), minval,
                  torch.from_numpy(maxval))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed", [0, 1, 9])
@pytest.mark.parametrize("n", [1, 2, 5, 30, 1625, 1626, 5000])
def test_choice_without_replacement_bit_equal(seed, n):
    """n = 1626 is the first size whose permutation takes two sort rounds."""
    a = np.arange(n, dtype=np.int32) * 3 + 7
    for k in sorted({1, min(n, 3), n}):
        ref = np.asarray(jax.random.choice(
            jax.random.PRNGKey(seed), jnp.asarray(a), (k,), replace=False))
        got = choice(prng_key(seed), torch.from_numpy(a), k)
        np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError):
        choice(prng_key(seed), torch.from_numpy(a), n + 1)


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("shape", [(7,), (50, 7, 3, 3), (1, 5, 3)])
def test_normal_within_four_ulp(seed, shape):
    """The uniform under normal is jax's bit for bit; the inverse error
    function is XLA's float32 polynomial evaluated op by op, which XLA may
    contract into fused multiply-adds: at most 4 ulp apart (most values
    are equal). torch.erfinv, a different approximation, is ~100 ulp off."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    ref = np.asarray(jax.random.normal(key, shape))
    got = normal(fold_in(prng_key(seed), 3), shape, "cpu").numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - ref.view(np.int32).astype(np.int64))
    assert ulp.max() <= 4
