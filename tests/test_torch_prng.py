"""The port's threefry PRNG against ``jax.random``: keys, fold-ins and
uniform draws are bit-equal, so the port draws the reference's link masks
and private signals exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
