"""The port's Byzantine trim-gather (kernel K3's plain version) against the
reference's plain version (``trim_gather_ref``) and its TPU kernel in
interpret mode (``trim_gather_pallas``), the PS-side trimmed pool, and the
route rules of the wrapper. The CUDA kernel itself is held against the
plain version on the card in ``test_torch_kernels_cuda.py``, on the same
problems.

Tolerances: ``kept`` is a count, so it is equal. ``tsum`` is a sum of the
same survivors; the port and the reference's plain version add them in
sorted order, the Pallas kernel in slot order, so ``tsum`` agrees within
``trim_sum_bound`` (deg_max * eps32 * the row's sum of absolute values, a
bound for any order of the additions). The trimmed pool divides such a sum
by the survivor count (rtol 1e-6 on top)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hps import ps_trimmed_pool as jax_pool
from repro.kernels.byz_trim.byz_trim import trim_gather_pallas
from repro.kernels.byz_trim.ref import trim_gather_ref as jax_ref
from repro_torch.core.hps import ps_trimmed_pool
from repro_torch.kernels.byz_trim import (
    trim_gather,
    trim_gather_cuda,
    trim_gather_pairs,
    trim_gather_ref,
)
from test_torch_kernels_cuda import TRIM_CASES, trim_problem, trim_sum_bound


@pytest.mark.parametrize("case", TRIM_CASES)
@pytest.mark.parametrize("P", [9, 3])
@pytest.mark.parametrize("F", [0, 1, 2, 3])
def test_plain_matches_reference_and_pallas(case, P, F):
    prob = trim_problem(case, P, F, seed=F)
    tsum, kept = trim_gather_ref(*map(torch.from_numpy, prob), F)
    args = tuple(map(jnp.asarray, prob))
    ref = jax_ref(*args, F)
    pal = trim_gather_pallas(*args, F, block_n=16, interpret=True)
    bound = trim_sum_bound(*prob)
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
