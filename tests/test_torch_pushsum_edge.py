"""The port's push-sum edge scatter (kernel K1) against the reference's
plain version (``edge_scatter_ref``) and its TPU kernel in interpret mode
(``edge_scatter_pallas``), plus the route and argument rules of the
wrapper. The CUDA kernel itself is held against the plain version on the
card in ``test_torch_kernels_cuda.py``, on the same problems.

Tolerances: ``rho_new`` is a select, so it is bit-equal. ``recv`` sums the
increments of each receiver's run; the port's CPU ``index_add_`` and the
CUDA kernels add them in edge order (``edge_order_recv`` emulates that
sum, which the CUDA kernels give bit for bit on the card), while the
Pallas kernel uses a segmented tree scan, so ``recv`` agrees to fp32
reduction order (rtol 1e-6, atol 1e-6 on O(1) values)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

from repro.kernels.pushsum_edge.pushsum_edge import edge_scatter_pallas
from repro.kernels.pushsum_edge.ref import edge_scatter_ref as jax_ref
from repro_torch.kernels.pushsum_edge import (
    dst_offsets,
    edge_scatter,
    edge_scatter_cuda,
    edge_scatter_ref,
)
from test_torch_kernels_cuda import (
    EDGE_CASES,
    K1_CASES,
    edge_order_recv,
    edge_problem,
)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_plain_matches_reference_and_pallas(case):
    sigma, rho, live, src, dst = edge_problem(case)
    got = edge_scatter_ref(*map(torch.from_numpy, (sigma, rho, live, src, dst)))
    args = tuple(map(jnp.asarray, (sigma, rho, live, src, dst)))
    ref = jax_ref(*args, indices_sorted=True)
    pal = edge_scatter_pallas(*args, block_e=16, interpret=True)
    for other in (ref, pal):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(other[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(other[1]),
                                   rtol=1e-6, atol=1e-6)
    if case == "none_live":
        assert not got[1].numpy().any()


@pytest.mark.parametrize("case", K1_CASES)
def test_edge_order_sum_matches_plain_and_pallas(case):
    """The float32 edge-order sum that K1's kernels give (``hub``: a
    receiver's run over more than two of the edge-tiled kernel's tiles,
    the partial sum carried from tile to tile) against the port's plain
    version and the TPU kernel in interpret mode.

    The Pallas kernel adds a run as partial sums of 16-edge blocks; over
    the hub's 1,300 increments that order differs from edge order by more
    than rtol 1e-6 (1.2e-6 measured), so there it is held to the bound for
    two orders of one sum, (n - 1) * eps32 * sum |increments| per run."""
    sigma, rho, live, src, dst = edge_problem(case)
    n = sigma.shape[0]
    rho_new = np.where(live[:, None], sigma[src], rho)
    want = edge_order_recv(rho_new, rho, dst, n)
    got = edge_scatter_ref(*map(torch.from_numpy, (sigma, rho, live, src,
                                                   dst)))[1].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    pal = np.asarray(edge_scatter_pallas(
        *map(jnp.asarray, (sigma, rho, live, src, dst)), block_e=16,
        interpret=True)[1])
    if case != "hub":
        np.testing.assert_allclose(pal, want, rtol=1e-6, atol=1e-6)
        return
    deg = np.bincount(dst, minlength=n)[:, None]
    mag = np.zeros_like(want)
    np.add.at(mag, dst, np.abs(rho_new - rho))
    order = np.maximum(deg - 1, 0) * np.finfo(np.float32).eps * mag
    assert (np.abs(pal - want) <= order + 1e-6).all()


def test_auto_on_cpu_is_plain_and_ignores_offsets():
    sigma, rho, live, src, dst = map(torch.from_numpy, edge_problem("ragged"))
    a = edge_scatter(sigma, rho, live, src, dst)
    b = edge_scatter(sigma, rho, live, src, dst, "torch",
                     offsets=dst_offsets(dst, sigma.shape[0]))
    c = edge_scatter_ref(sigma, rho, live, src, dst)
    for x, y in zip(a + b, c + c):
        assert torch.equal(x, y)


def test_cuda_route_on_cpu_tensors_raises():
    args = tuple(map(torch.from_numpy, edge_problem("ragged")))
    with pytest.raises(ValueError, match="CUDA"):
        edge_scatter(*args, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        edge_scatter_cuda(*args[:4], dst_offsets(args[4], args[0].shape[0]))
    with pytest.raises(ValueError, match="backend"):
        edge_scatter(*args, backend="pallas")


def test_dst_offsets_match_graphs_and_reject_unsorted():
    from repro_torch.core.graphs import _dst_offsets

    dst = edge_problem("no_in_edges")[4]
    got = dst_offsets(torch.from_numpy(dst), 23)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _dst_offsets(dst, 23))
    with pytest.raises(ValueError, match="dst-sorted"):
        dst_offsets(torch.tensor([0, 2, 1], dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="dst-sorted"):
        dst_offsets(torch.tensor([0, 1, 3], dtype=torch.int32), 3)
