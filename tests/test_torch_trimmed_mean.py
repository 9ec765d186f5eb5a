"""The port's coordinate-wise trimmed mean (``repro_torch.kernels.
trimmed_mean``) against the JAX package's on the CPU: its plain version
against ``trimmed_mean_ref`` and against the TPU kernel
``trimmed_mean_pallas`` run in interpret mode, the route dispatch, and
``trimmed_mean_pytree``'s dtype round trip.

Tolerances: both sides sum the same survivors in float32, in another
order (a sorted slice on both plain versions; worker order in the TPU
kernel), so they agree within ``tmean_bound`` of the CUDA tests: W * eps32
* sum |x| / (W - 2F) per coordinate, a bound for any order of the
additions (the CUDA kernel is held to the same bound on the card). Where
inf or NaN survives the trim both sides give inf or NaN.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
