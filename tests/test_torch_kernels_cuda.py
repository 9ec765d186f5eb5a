"""The port's CUDA kernels against their plain PyTorch versions on the card.

This file imports neither JAX nor the JAX package, so it runs on a machine
with a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Every test needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The problem builders here are shared with the CPU tests that hold the
plain versions against the JAX reference.

Tolerances: ``rho_new``, the sampled letters and ``z_new`` are a select or
one fp32 add, so bit-equal. ``recv`` sums each receiver's run in edge
order in the kernel and through atomics in ``index_add_``, and ``mu`` is a
softmax evaluated in another order: rtol 1e-5, atol 1e-6."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.pushsum_edge import (
    edge_scatter,
    edge_scatter_cuda,
    edge_scatter_ref,
)
from repro_torch.kernels.social_innov import (
    innovation_cuda,
    innovation_ref,
    innovation_step,
    sample_signals,
)

EDGE_CASES = ["ragged", "no_in_edges", "all_live", "none_live", "padding"]
INNOV_CASES = [(29, 3, 4, None), (64, 5, 7, None), (18, 3, 4, "u_at_top"),
               (40, 3, 4, "mass_to_zero"), (33, 2, 3, None)]


def edge_problem(case, seed=0, D=4):
    """(sigma, rho, live, src, dst) numpy arrays on a dst-sorted index."""
    rng = np.random.default_rng(seed)
    n = 23
    if case == "ragged":          # in-degrees 0..9, some receivers empty
        deg = rng.integers(0, 10, size=n)
    elif case == "no_in_edges":   # most receivers hear nobody
        deg = np.where(rng.random(n) < 0.7, 0, rng.integers(1, 5, size=n))
    else:
        deg = rng.integers(1, 6, size=n)
    dst = np.repeat(np.arange(n), deg).astype(np.int32)
    E = dst.shape[0]
    src = rng.integers(0, n, size=E).astype(np.int32)
    valid = np.ones(E, bool)
    if case == "padding":         # inert tail edges: dst = N-1, invalid
        pad = 17
        dst = np.concatenate([dst, np.full(pad, n - 1, np.int32)])
        src = np.concatenate([src, np.zeros(pad, np.int32)])
        valid = np.concatenate([valid, np.zeros(pad, bool)])
        E += pad
    if case == "all_live":
        live = np.ones(E, bool)
    elif case == "none_live":
        live = np.zeros(E, bool)
    else:
        live = rng.random(E) < 0.6
    sigma = rng.normal(size=(n, D)).astype(np.float32)
    rho = rng.normal(size=(E, D)).astype(np.float32)
    return sigma, rho, live & valid, src, dst


def innov_problem(N, m, S, seed, edge=None):
    """(z, mass, u, cdf, log_tables) numpy arrays; ``edge`` selects the
    uniforms-at-the-top or vanishing-mass variants."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(N, m)).astype(np.float32)
    mass = np.abs(rng.normal(size=(N,))).astype(np.float32)
    u = rng.random(N).astype(np.float32)
    probs = rng.dirichlet(np.ones(S), size=N).astype(np.float32)
    cdf = np.cumsum(probs, axis=-1, dtype=np.float32)
    lt = np.log(np.maximum(rng.dirichlet(np.ones(S), size=(N, m)), 2e-2)
                ).astype(np.float32)
    if edge == "u_at_top":
        # an fp32 cumsum can end below 1.0: uniforms at or above the last
        # CDF value must clamp to the last letter
        cdf[:, -1] = np.float32(0.999)
        u[: N // 2] = cdf[: N // 2, -1]
        u[N // 2 :] = np.float32(0.9999999)
    elif edge == "mass_to_zero":
        mass[::2] = 0.0
        mass[1::4] = np.float32(1e-30)
    return z, mass, u, cdf, lt


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES)
def test_edge_scatter_kernel_matches_plain(cuda_device, case):
    args = [torch.from_numpy(a) for a in edge_problem(case)]
    before = edge_scatter_cuda.launches
    got = edge_scatter(*[a.to(cuda_device) for a in args], backend="auto")
    torch.cuda.synchronize()
    assert edge_scatter_cuda.launches == before + 1
    ref = edge_scatter_ref(*args)
    assert torch.equal(got[0].cpu(), ref[0])
    torch.testing.assert_close(got[1].cpu(), ref[1], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_edge_scatter_kernel_rejects_bad_arguments(cuda_device):
    sigma, rho, live, src, dst = [torch.from_numpy(a).to(cuda_device)
                                  for a in edge_problem("ragged")]
    with pytest.raises(ValueError, match="dst-sorted"):
        edge_scatter(sigma, rho, live, src, dst.flip(0), backend="cuda")
    with pytest.raises(ValueError, match="dtype"):
        edge_scatter(sigma.double(), rho, live, src, dst, backend="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        edge_scatter(sigma, rho.t().contiguous().t(), live, src, dst,
                     backend="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("N,m,S,edge", INNOV_CASES)
def test_innovation_kernel_matches_plain(cuda_device, N, m, S, edge):
    args = [torch.from_numpy(a) for a in innov_problem(N, m, S, N, edge)]
    before = innovation_cuda.launches
    z_k, mu_k = innovation_step(*[a.to(cuda_device) for a in args])
    torch.cuda.synchronize()
    assert innovation_cuda.launches == before + 1
    z_r, mu_r = innovation_ref(*args)
    assert torch.equal(z_k.cpu(), z_r)
    torch.testing.assert_close(mu_k.cpu(), mu_r, rtol=1e-5, atol=1e-6)
    assert torch.isfinite(mu_k).all()


@pytest.mark.cuda
def test_innovation_kernel_samples_the_plain_letters(cuda_device):
    z, mass, u, cdf, _ = (torch.from_numpy(a) for a in
                          innov_problem(64, 3, 4, 5, "u_at_top"))
    letters = torch.arange(4.0).expand(64, 3, 4).contiguous()
    z_k, _ = innovation_cuda(*[a.to(cuda_device) for a in
                               (torch.zeros_like(z), mass, u, cdf, letters)])
    assert torch.equal(z_k[:, 0].long().cpu(), sample_signals(u, cdf))
