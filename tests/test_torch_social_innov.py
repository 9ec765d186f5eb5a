"""The port's innovation + belief step (kernel K2) against the reference's
plain version (``innovation_ref``) and its TPU kernel in interpret mode
(``innovation_pallas``), including uniforms at or above the last CDF value
and vanishing mass. The CUDA kernel is held against the plain version on
the card in ``test_torch_kernels_cuda.py``, on the same problems.

Tolerances: the sampled letter and ``z_new`` (one fp32 add of the gathered
row) are bit-equal. ``mu`` is a softmax whose exp and sum are evaluated by
different libraries (XLA's polynomial exp against PyTorch's), so it agrees
to a few fp32 ulps (rtol 1e-6, atol 1e-7)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.social_innov.ref import innovation_ref as jax_ref
from repro.kernels.social_innov.social_innov import innovation_pallas
from repro_torch.kernels.social_innov import (
    innovation_cuda,
    innovation_ref,
    innovation_step,
    sample_signals,
)
from test_torch_kernels_cuda import INNOV_CASES, innov_problem


@pytest.mark.parametrize("N,m,S,edge", INNOV_CASES)
def test_plain_matches_reference_and_pallas(N, m, S, edge):
    arrays = innov_problem(N, m, S, seed=N, edge=edge)
    z_t, mu_t = innovation_ref(*map(torch.from_numpy, arrays))
    args = tuple(map(jnp.asarray, arrays))
    for z_r, mu_r in (jax_ref(*args),
                      innovation_pallas(*args, block_n=8, interpret=True)):
        np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_r))
        np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_r),
                                   rtol=1e-6, atol=1e-7)
    assert np.isfinite(mu_t.numpy()).all()


def test_sampled_letters_and_clamp():
    z, mass, u, cdf, lt = innov_problem(18, 3, 4, seed=1, edge="u_at_top")
    sig = sample_signals(torch.from_numpy(u), torch.from_numpy(cdf))
    assert (sig.numpy() == 3).all()
    z, mass, u, cdf, lt = innov_problem(50, 3, 4, seed=2)
    sig = sample_signals(torch.from_numpy(u), torch.from_numpy(cdf)).numpy()
    np.testing.assert_array_equal(sig, np.minimum(
        np.array([np.searchsorted(c, x, side="left")
                  for c, x in zip(cdf, u)]), 3))


def test_routes_on_cpu():
    args = tuple(map(torch.from_numpy, innov_problem(29, 3, 4, seed=3)))
    for x, y in zip(innovation_step(*args), innovation_ref(*args)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="CUDA"):
        innovation_step(*args, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        innovation_cuda(*args)
