"""The port's innovation + belief step (kernel K2) against the reference's
plain version (``innovation_ref``) and its TPU kernel in interpret mode
(``innovation_pallas``), including uniforms at or above the last CDF value
and vanishing mass. The CUDA kernel is held against the plain version on
the card in ``test_torch_kernels_cuda.py``, on the same problems.

A numpy emulation of the CUDA kernel's block partition (each block's
ranges staged with 16-byte vectors over their aligned body and bytes at
the ragged ends, fewer agents a block where rows are long) and of its
per-agent arithmetic is held against the same references.

Tolerances: the sampled letter and ``z_new`` (one fp32 add of the gathered
row) are bit-equal. ``mu`` is a softmax whose exp and sum are evaluated by
different libraries (XLA's polynomial exp against PyTorch's), so it agrees
to a few fp32 ulps (rtol 1e-6, atol 1e-7)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

from repro.kernels.social_innov.ref import innovation_ref as jax_ref
from repro.kernels.social_innov.social_innov import innovation_pallas
from repro_torch.kernels.social_innov import (
    innovation_cuda,
    innovation_ref,
    innovation_step,
    sample_signals,
    staged_agents,
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


# ---------------------------------------------------------------------------
# K2's block partition (csrc/social_innov.cu), emulated in numpy
# ---------------------------------------------------------------------------

def stage_plan(addr, n):
    """The kernel's ``stage`` (and ``unstage``): the n bytes at byte
    address ``addr`` as (offset, width) pieces, 16-byte vectors over the
    aligned body and single bytes at the ragged ends, or bytes throughout
    where no aligned vector fits."""
    b0, b1 = (addr + 15) // 16 * 16, (addr + n) // 16 * 16
    if b0 >= b1:
        return [(i, 1) for i in range(n)]
    head, tail = b0 - addr, addr + n - b1
    return ([(i, 1) for i in range(head)]
            + [(c - addr, 16) for c in range(b0, b1, 16)]
            + [(n - tail + i, 1) for i in range(tail)])


def k2_emulate(z, mass, u, cdf, lt, base=0):
    """K2 in numpy -> (z_new, mu, blocks). Blocks of A =
    :func:`staged_agents` agents (the last one ragged) copy their ranges of
    the five inputs through :func:`stage_plan`, every array taken to start
    ``base`` bytes past a 16-byte boundary, and store z_new and mu back the
    same way. Each agent: the clamped inverse-CDF letter, z_new = z + the
    table's column, the ratios z_new / max(mass, 1e-30), their running
    maximum, the sum of exp(ratio - top) in hypothesis order, then
    exp(ratio - top) / total."""
    n, m = z.shape
    A = staged_agents(m, S := cdf.shape[1])
    blocks = [(j0, min(A, n - j0)) for j0 in range(0, n, A)]
    z_new, mu = np.empty_like(z), np.empty_like(z)

    def agents(z, mass, u, cdf, lt):
        sig = np.minimum((u[:, None] > cdf).sum(axis=1), S - 1)
        zn = (z + lt[np.arange(len(z)), :, sig]).astype(np.float32)
        den = np.maximum(mass, np.float32(1e-30))[:, None]
        ratio = zn / den
        top = np.full(len(z), -np.inf, np.float32)
        total = np.zeros(len(z), np.float32)
        for k in range(m):
            top = np.maximum(top, ratio[:, k])
        for k in range(m):
            total = total + np.exp(ratio[:, k] - top)
        return zn, np.exp(ratio - top[:, None]) / total[:, None]

    for j0, na in blocks:
        staged = []
        for a in (z, mass, u, cdf, lt):
            row = int(np.prod(a.shape[1:]))
            flat = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
            lo, nb = 4 * j0 * row, 4 * na * row
            buf = np.zeros(nb, np.uint8)
            for off, w in stage_plan(base + lo, nb):
                buf[off:off + w] = flat[lo + off:lo + off + w]
            staged.append(buf.view(np.float32).reshape((na,) + a.shape[1:]))
        zo, mo = agents(*staged)
        for out, res in ((z_new, zo), (mu, mo)):
            flat = out.reshape(-1).view(np.uint8)
            lo, nb = 4 * j0 * m, 4 * na * m
            src = np.ascontiguousarray(res, np.float32).reshape(-1).view(
                np.uint8)
            for off, w in stage_plan(base + lo, nb):
                flat[lo + off:lo + off + w] = src[off:off + w]
    return z_new, mu, blocks


def test_staged_agents_picks_the_block_by_row_length():
    """32 agents a block where their rows fit in 48 KB, the largest power
    of two that fits for longer rows, one agent in up to 227 KB past that,
    and 0 (the wrapper raises) where one agent's rows do not fit."""
    assert [staged_agents(m, S) for m, S in
            ((3, 4), (5, 7), (2, 3), (10, 10), (16, 16), (16, 32),
             (64, 64), (128, 128), (256, 256))] \
        == [32, 32, 32, 32, 32, 16, 2, 1, 0]


@pytest.mark.parametrize("N", [1, 255, 256, 257, 4097])
@pytest.mark.parametrize("m,S,edge", sorted({(m, S, e) for _, m, S, e in
                                              INNOV_CASES}, key=str))
def test_block_partition_matches_reference_and_pallas(N, m, S, edge):
    """The emulated kernel (blocks of A agents with a ragged last one,
    ranges off the 16-byte alignment for odd N) against the port's plain
    version, the reference's and its TPU kernel in interpret mode: z_new
    bit-equal, mu within rtol 1e-5 atol 1e-6 (numpy's exp and the
    softmax's order, the tolerance the kernels keep on the card)."""
    arrays = innov_problem(N, m, S, seed=N + m, edge=edge)
    z_new, mu, blocks = k2_emulate(*arrays, base=4 * (N % 4))
    A = staged_agents(m, S)
    assert [j0 for j0, _ in blocks] == list(range(0, N, A))
    assert sum(na for _, na in blocks) == N
    z_t, mu_t = innovation_ref(*map(torch.from_numpy, arrays))
    args = tuple(map(jnp.asarray, arrays))
    for z_r, mu_r in ((z_t.numpy(), mu_t.numpy()), jax_ref(*args),
                      innovation_pallas(*args, block_n=256, interpret=True)):
        np.testing.assert_array_equal(z_new, np.asarray(z_r))
        np.testing.assert_allclose(mu, np.asarray(mu_r), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("N,m,S,A", [(300, 16, 32, 16), (5, 128, 128, 1)])
def test_long_rows_take_smaller_blocks(N, m, S, A):
    """Rows of (16, 32) take blocks of 16 agents, rows of (128, 128) one
    agent a block (past 48 KB of shared memory): the same arithmetic."""
    arrays = innov_problem(N, m, S, seed=9, edge="u_at_top")
    z_new, mu, blocks = k2_emulate(*arrays, base=4)
    assert blocks == [(j0, min(A, N - j0)) for j0 in range(0, N, A)]
    z_t, mu_t = innovation_ref(*map(torch.from_numpy, arrays))
    np.testing.assert_array_equal(z_new, z_t.numpy())
    np.testing.assert_allclose(mu, mu_t.numpy(), rtol=1e-5, atol=1e-6)
