"""The port's CUDA kernels against their plain PyTorch versions on the card.

This file imports neither JAX nor the JAX package, so it runs on a machine
with a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Every test needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The problem builders here are shared with the CPU tests that hold the
plain versions against the JAX reference.

Tolerances: ``rho_new``, the sampled letters and ``z_new`` are a select or
one fp32 add, so bit-equal. ``recv`` sums each receiver's run in edge
order in both of K1's kernels, so it is bit-equal to the float32
edge-order sum of :func:`edge_order_recv`; against ``index_add_``, which
adds through atomics on the card, and ``mu``, a softmax evaluated in
another order: rtol 1e-5, atol 1e-6. The trim-gather
``kept`` is a count, so bit-equal; ``tsum`` adds the same survivors in slot
order in the kernel and in sorted order in the plain version, so it agrees
within the bound of :func:`trim_sum_bound` (deg_max * eps32 * the sum of
the survivors' absolute values, a bound for any order of the additions). The
attention kernels (``attn_decode``, ``swa_prefill``) are held against
their plain versions run in float32 on the same inputs: a float32 output
to rtol 1e-5 + atol 1e-5 (another summation order over the cache or the
band), a bf16 output, which is the float32 result rounded once, to rtol
2^-8 + atol 1e-5. The WKV6 kernel K7 is held against the chunked plain
version at the same chunk (64) and against the sequential scan: both are
float32 sums in another order, and the chunked form's decay weights are
exponentials of differences of in-chunk cumsums that differ by a few ulp
of |P| with the cumsum's order, so ``tests/test_torch_wkv6.py``'s chunked
limit applies, atol = rtol = 1e-3 on outputs up to ~100; at lw = -e^4,
where |P| reaches ~3,500 (ulp 2.4e-4), rtol 5e-4 + atol 5e-3. A bf16 y is
the float32 result rounded once on each side: rtol 2^-7 + atol 1e-3.
The trimmed mean K4 sums the same survivors as its sort-based plain
version in another order, so it agrees within :func:`tmean_bound` (W *
eps32 * the column's sum of absolute values / (W - 2F)); where inf or NaN
survives the trim both give inf or NaN. The autograd wrappers of K6 and
K7 recompute the plain versions in their backward, so for a loss linear in
their outputs the gradients equal plain autograd's bit for bit; through a
model (the forward's rounding reaches the upstream gradient) they are
held within 1e-4 of each leaf's largest entry (float32). On bf16 and
fp16 storage (the precision policy) K1-K3 keep their float32 sums, so
the same rules hold on the upcast storage values: rho_new and z_new
bit-equal, recv and tsum bit-equal to the float32 edge-order and
rank-order sums; the engines under ``policy="bf16"`` agree with their
plain path on the decisions of clear agents and, for the consensus
engines, within 4 bf16 ulps of the input spread (another summation
order can flip a bf16 rounding)."""
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

from repro_torch.core import attacks
from repro_torch.core.byzantine import ByzantineConfig, run_byzantine_learning
from repro_torch.core.graphs import (make_hierarchy,
                                     random_strongly_connected_edge_list,
                                     sort_by_dst, stack_edge_lists)
from repro_torch.core.hps import HPSConfig, run_hps
from repro_torch.core.social import run_social_learning
from repro_torch.core.sweeps import (run_byzantine_grid, run_hps_grid,
                                     run_pushsum_sweep, run_social_grid,
                                     stack_runtimes)
from repro_torch.core.pushsum import run_pushsum_sparse, sparse_mass_invariant
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.prng import prng_key
from repro_torch.core.signals import make_confused_model
from repro_torch.kernels.byz_trim import (
    DEG_MAX_CAP,
    trim_gather,
    trim_gather_cuda,
    trim_gather_ref,
)
from repro_torch.kernels.pushsum_edge import (
    dst_offsets,
    edge_scatter,
    edge_scatter_cuda,
    edge_scatter_ref,
)
from repro_torch.kernels.swa import (
    SwaPrefillFn,
    attn_decode,
    attn_decode_cuda,
    attn_decode_merge,
    attn_decode_merge_cuda,
    attn_decode_merge_ref,
    attn_decode_partial,
    attn_decode_partial_cuda,
    attn_decode_partial_ref,
    attn_decode_ref,
    swa_prefill,
    swa_prefill_cuda,
    swa_prefill_ref,
)
from repro_torch.kernels.swa.ops import _TICKETS, prefill_kernel
from repro_torch.kernels.wkv6 import (
    Wkv6Fn,
    wkv6,
    wkv6_chunked_ref,
    wkv6_cuda,
    wkv6_ref,
)
from repro_torch.kernels.trimmed_mean import (
    W_MAX,
    trimmed_mean,
    trimmed_mean_cuda,
    trimmed_mean_ref,
)
from repro_torch.kernels.social_innov import (
    innovation_cuda,
    innovation_ref,
    innovation_step,
    sample_signals,
    staged_agents,
)

EDGE_CASES = ["ragged", "no_in_edges", "all_live", "none_live", "padding"]
# with a receiver whose run spans more than two of K1's edge tiles
K1_CASES = EDGE_CASES + ["hub"]
INNOV_CASES = [(29, 3, 4, None), (64, 5, 7, None), (18, 3, 4, "u_at_top"),
               (40, 3, 4, "mass_to_zero"), (33, 2, 3, None)]
# K2 over several blocks with a ragged last one, rows of (16, 32) in
# blocks of 16 agents and rows of (128, 128) one agent a block (past 48 KB
# of shared memory)
K2_CASES = INNOV_CASES + [(1001, 3, 4, "u_at_top"), (4097, 2, 3, None),
                          (300, 16, 32, None), (40, 128, 128, None)]


def edge_problem(case, seed=0, D=4):
    """(sigma, rho, live, src, dst) numpy arrays on a dst-sorted index.
    ``hub`` gives one receiver an in-degree of 1,300, more than two of the
    edge-tiled kernel's tiles (2,048 floats: 512 edges at D = 4)."""
    rng = np.random.default_rng(seed)
    n = 23
    if case == "ragged":          # in-degrees 0..9, some receivers empty
        deg = rng.integers(0, 10, size=n)
    elif case == "no_in_edges":   # most receivers hear nobody
        deg = np.where(rng.random(n) < 0.7, 0, rng.integers(1, 5, size=n))
    else:
        deg = rng.integers(1, 6, size=n)
    if case == "hub":
        deg[n // 2] = 1300
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


def edge_order_recv(rho_new, rho, dst, n):
    """(n, D) float32: each receiver's increments rho_new - rho added in
    edge order, one float32 addition at a time from 0, the sum both of
    K1's kernels give bit for bit (numpy arrays)."""
    recv = np.zeros((n, rho.shape[1]), np.float32)
    delta = (rho_new - rho).astype(np.float32)
    for e, v in enumerate(dst):
        recv[v] = recv[v] + delta[e]
    return recv


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


TRIM_CASES = ["random", "ties", "under_trimmed", "huge", "scattered",
              "padded", "single_slot", "wide"]
# K3's wider networks and non-finite lies (at most F a row on the first
# valid slots; ``too_many`` on any Byzantine slot)
K3_CASES = ["deg_max_33", "deg_max_64", "scattered_64", "under_trimmed_64",
            "nan", "nan_sign", "inf", "too_many"]
NON_FINITE = {"nan": (np.nan,), "nan_sign": (np.uint32(0xFFC00000).view(
    np.float32),), "inf": (np.inf, -np.inf)}
ORACLE_ATTACKS = ["sign_flip", "large_value", "extreme_pull",
                  "truth_suppression"]


def trim_problem(case, P, F, seed=0, n=37):
    """(r, nbr_idx, nbr_valid, byz_msgs, byz_nbr) numpy arrays of a
    trim-gather over N = 37 receivers (not a multiple of any block size).

    Invalid slots carry idx 0 and NaN messages, and some are flagged
    Byzantine: a kernel that read them would show it. ``ties`` draws values
    from {0, 1, 2} (whole rows equal among them), ``under_trimmed`` keeps
    every degree <= 2F, ``huge`` puts +-1e6 lies beside O(1) honest values,
    ``scattered`` spreads the valid slots over the row, ``padded`` leaves
    the last slots of every row empty and some rows with no slot at all,
    ``single_slot`` is deg_max = 1 and ``wide`` deg_max = 20. Of
    ``K3_CASES``: deg_max 33 and 64 (``scattered_64`` and
    ``under_trimmed_64`` with those layouts), and NaN, sign-bit NaN and
    +-inf lies (``nan``, ``nan_sign``, ``inf``: at most F a row, on the
    first valid slots, deg_max 33; ``too_many``: a mix of them on any
    Byzantine slot, deg_max 20)."""
    rng = np.random.default_rng(seed)
    dm = {"single_slot": 1, "wide": 20, "padded": 12, "deg_max_33": 33,
          "deg_max_64": 64, "scattered_64": 64, "under_trimmed_64": 64,
          "nan": 33, "nan_sign": 33, "inf": 33, "too_many": 20}.get(case, 7)
    if case.startswith("scattered"):
        valid = rng.random((n, dm)) < 0.7
    else:
        under = case.startswith("under_trimmed")
        top = min(2 * F, dm) if under else dm - 4 if case == "padded" else dm
        deg = rng.integers(0 if case == "padded" or under else 1, top + 1,
                           size=n)
        valid = np.arange(dm)[None, :] < deg[:, None]
    idx = np.where(valid, rng.integers(0, n, size=(n, dm)), 0)
    if case == "ties":
        r = rng.integers(0, 3, size=(n, P)).astype(np.float32)
        r[::5] = 1.0
        msgs = rng.integers(0, 3, size=(n, dm, P)).astype(np.float32)
    else:
        r = rng.normal(size=(n, P)).astype(np.float32)
        msgs = (1e3 * rng.normal(size=(n, dm, P))).astype(np.float32)
    if case == "huge":
        msgs = np.where(rng.random((n, dm, P)) < 0.5, -1e6, 1e6).astype(
            np.float32)
    byz_nbr = rng.random((n, dm)) < 0.3
    if case in NON_FINITE or case == "too_many":
        pick = np.array(NON_FINITE.get(case, sum(NON_FINITE.values(), ())),
                        np.float32)
        odd = pick[rng.integers(0, len(pick), size=(n, dm, P))]
        msgs = np.where(rng.random((n, dm, P)) < 0.7, odd, msgs)
        if case != "too_many":
            byz_nbr = valid & (np.cumsum(valid, axis=1) <= F)
    msgs[~valid] = np.nan
    return r, idx.astype(np.int32), valid, msgs, byz_nbr


def trim_sorted(r, idx, valid, msgs, byz_nbr):
    """The slots' values sorted with every NaN last (as the positive NaN)
    and the invalid slots after them -> (sorted (N, deg_max, P) float32,
    deg (N,)) (numpy arrays)."""
    vals = np.where(byz_nbr[:, :, None], msgs, r[idx]).astype(np.float32)
    vals[np.isnan(vals)] = np.nan
    bits = vals.view(np.uint32)
    keys = (bits ^ ((bits.view(np.int32) >> 31).view(np.uint32)
                    | np.uint32(0x80000000))).astype(np.int64)
    keys[~valid] = 2 ** 32
    s = np.take_along_axis(vals, np.argsort(keys, axis=1, kind="stable"), 1)
    return s, valid.sum(axis=1)


def survivors(deg, F, dm):
    """(N, deg_max) bool: the ranks F .. deg - F - 1 of each sorted row
    (``F`` an int, or (N,) per row)."""
    q = np.arange(dm)[None, :]
    f = np.reshape(F, (-1, 1))
    return (q >= f) & (q < deg[:, None] - f)


def trim_sum_bound(r, idx, valid, msgs, byz_nbr, F):
    """Per-row absolute bound on the difference of two sums of the same
    survivors taken in different orders: deg_max * eps32 * the sum of the
    survivors' |values| (ranks F .. deg - F - 1 of the sorted row, its
    finite values). Trimmed slots add exactly 0 to a sum of ``s * keep``
    where they are finite."""
    s, deg = trim_sorted(r, idx, valid, msgs, byz_nbr)
    on = survivors(deg, F, idx.shape[1])[:, :, None] & np.isfinite(s)
    mag = np.where(on, np.abs(s), 0.0).sum(axis=1)
    return idx.shape[1] * np.finfo(np.float32).eps * mag


def trim_rank_order_sum(r, idx, valid, msgs, byz_nbr, F):
    """(N, P) float32: the sorted survivors of :func:`trim_sorted` added in
    float32 in rank order from 0 -- the tsum K3 gives bit for bit (numpy
    arrays)."""
    s, deg = trim_sorted(r, idx, valid, msgs, byz_nbr)
    on = survivors(deg, F, idx.shape[1])
    tsum = np.zeros(r.shape, np.float32)
    with np.errstate(all="ignore"):
        for q in range(idx.shape[1]):
            tsum = np.where(on[:, q, None], tsum + s[:, q], tsum)
    return tsum


def byzantine_oracle_scenario(attack, T=120):
    """examples/quickstart.py's Algorithm 2 set-up on four complete
    7-agent networks: F = 2, Byzantine agents 2 and 9, Γ = 10."""
    topo = make_hierarchy([7] * 4, topology="complete", seed=0)
    model = make_confused_model(N=topo.N, m=3, truth=1, confusion=0.0,
                                seed=0)
    atk = (attacks.truth_suppression(model.truth, 1e3)
           if attack == "truth_suppression" else attacks.ATTACKS[attack]())
    cfg = ByzantineConfig(topo=topo, F=2, byz=(2, 9), gamma_period=10,
                          attack=atk)
    return model, cfg, T


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
    sigma, rho, live, src, dst = edge_problem(case)
    want = edge_order_recv(ref[0].numpy(), rho, dst, sigma.shape[0])
    np.testing.assert_array_equal(got[1].cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K1_CASES)
@pytest.mark.parametrize("D,tiled", [(4, None), (4, False), (3, None),
                                     (5, None), (40, None), (40, False)])
def test_edge_scatter_kernels_give_the_edge_order_sum(cuda_device, case, D,
                                                      tiled):
    """Both kernels, as the wrapper picks them by D (the edge-tiled one at
    D <= 32: its vector path at D = 4, its scalar path at D = 3 and at
    D = 5, the Algorithm 1 engines' width; the
    column walk at D = 40) and as asked for: rho_new bit-equal to the plain
    version, recv bit-equal to the float32 edge-order sum."""
    from repro_torch.kernels.pushsum_edge.ops import TILED_D_MAX
    sigma, rho, live, src, dst = edge_problem(case, D=D)
    n = sigma.shape[0]
    offsets = np.searchsorted(dst, np.arange(n + 1)).astype(np.int32)
    dev_args = [torch.from_numpy(a).to(cuda_device)
                for a in (sigma, rho, live, src, offsets)]
    before = (edge_scatter_cuda.launches, edge_scatter_cuda.launches_tiled)
    rho_new, recv = edge_scatter_cuda(*dev_args, tiled=tiled)
    torch.cuda.synchronize()
    on_tiled = D <= TILED_D_MAX if tiled is None else tiled
    assert (edge_scatter_cuda.launches,
            edge_scatter_cuda.launches_tiled) == (before[0] + 1,
                                                  before[1] + int(on_tiled))
    ref = edge_scatter_ref(*map(torch.from_numpy, (sigma, rho, live, src,
                                                   dst)))
    assert torch.equal(rho_new.cpu(), ref[0])
    np.testing.assert_array_equal(
        recv.cpu().numpy(), edge_order_recv(ref[0].numpy(), rho, dst, n))


@pytest.mark.cuda
def test_edge_scatter_tiled_kernel_reads_unaligned_rows(cuda_device):
    """Contiguous rows that start one float off the 16-byte vector: the
    edge-tiled kernel's scalar path, with the same results."""
    sigma, rho, live, src, dst = edge_problem("ragged", D=4)
    n, E = sigma.shape[0], rho.shape[0]
    offsets = np.searchsorted(dst, np.arange(n + 1)).astype(np.int32)

    def shifted(a):
        buf = torch.zeros(a.size + 1, device=cuda_device)
        buf[1:] = torch.from_numpy(a.reshape(-1)).to(cuda_device)
        return buf[1:].view(a.shape)

    args = [shifted(sigma), shifted(rho)] + [
        torch.from_numpy(a).to(cuda_device) for a in (live, src, offsets)]
    assert args[1].data_ptr() % 16 != 0
    before = edge_scatter_cuda.launches_tiled
    rho_new, recv = edge_scatter_cuda(*args)
    torch.cuda.synchronize()
    assert edge_scatter_cuda.launches_tiled == before + 1
    ref = edge_scatter_ref(*map(torch.from_numpy, (sigma, rho, live, src,
                                                   dst)))
    assert torch.equal(rho_new.cpu(), ref[0]) and E == rho_new.shape[0]
    np.testing.assert_array_equal(
        recv.cpu().numpy(), edge_order_recv(ref[0].numpy(), rho, dst, n))


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
    wide = [torch.zeros((sigma.shape[0], 33), device=cuda_device),
            torch.zeros((rho.shape[0], 33), device=cuda_device)]
    with pytest.raises(ValueError, match="D <= 32"):
        edge_scatter_cuda(*wide, live, src, dst_offsets(dst, 23), tiled=True)


@pytest.mark.cuda
@pytest.mark.parametrize("N,m,S,edge", K2_CASES)
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
def test_innovation_kernel_reads_unaligned_ranges(cuda_device):
    """Every input one float off the 16-byte alignment: the kernel moves
    the ragged ends of each block's ranges one byte at a time."""
    arrays = innov_problem(1001, 3, 4, 7, "u_at_top")

    def shifted(a):
        flat = torch.cat([torch.zeros(1), torch.from_numpy(a).reshape(-1)])
        return flat.to(cuda_device)[1:].view(a.shape)

    args = [shifted(a) for a in arrays]
    assert args[0].data_ptr() % 16 != 0 and args[0].is_contiguous()
    z_r, mu_r = innovation_ref(*map(torch.from_numpy, arrays))
    z_k, mu_k = innovation_cuda(*args)
    assert torch.equal(z_k.cpu(), z_r)
    torch.testing.assert_close(mu_k.cpu(), mu_r, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_innovation_kernel_rejects_rows_too_long(cuda_device):
    """Rows of (256, 256), 256 KB an agent, do not fit a block's shared
    memory: the wrapper raises and launches nothing."""
    assert staged_agents(256, 256) == 0
    args = [torch.from_numpy(a).to(cuda_device)
            for a in innov_problem(2, 256, 256, 0)]
    before = innovation_cuda.launches
    with pytest.raises(ValueError, match="do not fit"):
        innovation_cuda(*args)
    assert innovation_cuda.launches == before


@pytest.mark.cuda
def test_innovation_kernel_samples_the_plain_letters(cuda_device):
    z, mass, u, cdf, _ = (torch.from_numpy(a) for a in
                          innov_problem(64, 3, 4, 5, "u_at_top"))
    letters = torch.arange(4.0).expand(64, 3, 4).contiguous()
    z_k, _ = innovation_cuda(*[a.to(cuda_device) for a in
                               (torch.zeros_like(z), mass, u, cdf, letters)])
    assert torch.equal(z_k[:, 0].long().cpu(), sample_signals(u, cdf))


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRIM_CASES)
@pytest.mark.parametrize("P", [9, 3])
@pytest.mark.parametrize("F", [0, 1, 2, 3])
def test_trim_gather_kernel_matches_plain(cuda_device, case, P, F):
    prob = trim_problem(case, P, F, seed=F)
    args = [torch.from_numpy(a) for a in prob]
    before = trim_gather_cuda.launches
    tsum, kept = trim_gather(*[a.to(cuda_device) for a in args], F)
    torch.cuda.synchronize()
    assert trim_gather_cuda.launches == before + 1
    t_ref, k_ref = trim_gather_ref(*args, F)
    assert torch.equal(kept.cpu(), k_ref)
    err = (tsum.cpu() - t_ref).abs().numpy()
    assert (err <= trim_sum_bound(*prob, F)).all(), err.max()
    assert torch.isfinite(tsum).all()
    # rows with deg <= 2F keep nothing and sum to exactly 0
    assert (tsum.cpu()[k_ref == 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRIM_CASES + K3_CASES)
@pytest.mark.parametrize("F", [0, 1, 2, 3])
def test_trim_gather_kernel_gives_the_rank_order_sum(cuda_device, case, F):
    """tsum bit-equal to the float32 rank-order sum of the sorted survivors
    (NaN where it is NaN), at every width of the kernel's network and with
    non-finite lies; kept bit-equal and tsum within the order bound of the
    plain version on rows whose values are finite (the plain version sums
    ``s * keep``, so a trimmed NaN or inf makes its row NaN)."""
    prob = trim_problem(case, 9, F, seed=F + 10)
    args = [torch.from_numpy(a) for a in prob]
    tsum, kept = trim_gather_cuda(*[a.to(cuda_device) for a in args], F)
    tsum, kept = tsum.cpu().numpy(), kept.cpu().numpy()
    want = trim_rank_order_sum(*prob, F)
    np.testing.assert_array_equal(np.isnan(tsum), np.isnan(want))
    np.testing.assert_array_equal(tsum.view(np.int32)[~np.isnan(want)],
                                  want.view(np.int32)[~np.isnan(want)])
    t_ref, k_ref = trim_gather_ref(*args, F)
    np.testing.assert_array_equal(kept, k_ref.numpy())
    vals = np.where(prob[4][:, :, None], prob[3], prob[0][prob[1]])
    finite = np.where(prob[2][:, :, None], np.isfinite(vals), True).all((1, 2))
    err = np.abs(tsum[finite] - t_ref.numpy()[finite])
    assert (err <= trim_sum_bound(*prob, F)[finite]).all()
    assert (tsum[k_ref.numpy() == 0] == 0).all()


@pytest.mark.cuda
def test_trim_gather_kernel_reads_broadcast_messages(cuda_device):
    r, idx, valid, _, byz_nbr = (torch.from_numpy(a).to(cuda_device)
                                 for a in trim_problem("random", 9, 2))
    val = torch.arange(9.0, device=cuda_device) * 1e3
    view = val.expand(idx.shape + (9,))            # stride 0, no copy
    assert view.stride() == (0, 0, 1)
    got = trim_gather_cuda(r, idx, valid, view, byz_nbr, 2)
    ref = trim_gather_cuda(r, idx, valid, view.contiguous(), byz_nbr, 2)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.cuda
def test_trim_gather_kernel_rejects_bad_arguments(cuda_device):
    r, idx, valid, msgs, byz_nbr = (torch.from_numpy(a).to(cuda_device)
                                    for a in trim_problem("random", 9, 1))
    with pytest.raises(ValueError, match="dtype"):
        trim_gather_cuda(r.double(), idx, valid, msgs, byz_nbr, 1)
    with pytest.raises(ValueError, match="dtype"):
        trim_gather_cuda(r, idx.long(), valid, msgs, byz_nbr, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        trim_gather_cuda(r.cpu(), idx, valid, msgs, byz_nbr, 1)
    with pytest.raises(ValueError, match="is on"):
        trim_gather_cuda(r, idx.cpu(), valid, msgs, byz_nbr, 1)
    with pytest.raises(ValueError, match="contiguous"):
        trim_gather_cuda(r, idx.t().contiguous().t(), valid, msgs,
                         byz_nbr, 1)
    with pytest.raises(ValueError, match="deg_max"):
        wide = DEG_MAX_CAP + 1
        trim_gather_cuda(r, idx[:, :1].expand(-1, wide).contiguous(),
                         valid[:, :1].expand(-1, wide).contiguous(),
                         msgs[:, :1].expand(-1, wide, -1),
                         byz_nbr[:, :1].expand(-1, wide).contiguous(), 1)
    with pytest.raises(ValueError, match="F must"):
        trim_gather_cuda(r, idx, valid, msgs, byz_nbr, -1)
    n = r.shape[0]
    Fr = torch.ones(n, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        trim_gather_cuda(r, idx, valid, msgs, byz_nbr, Fr.long())
    with pytest.raises(ValueError, match="shape"):
        trim_gather_cuda(r, idx, valid, msgs, byz_nbr, Fr[:-1])
    with pytest.raises(ValueError, match="is on"):
        trim_gather_cuda(r, idx, valid, msgs, byz_nbr, Fr.cpu())
    Fr[3] = -1
    with pytest.raises(ValueError, match="F must"):
        trim_gather_cuda(r, idx, valid, msgs, byz_nbr, Fr)


def mixed_trim_counts(n, dm, seed):
    """(N,) int32 trim counts 0 .. deg_max / 2 + 1, every fifth 0: F = 0
    rows, trimmed rows and rows with deg <= 2F side by side in a block."""
    f = np.random.default_rng(seed).integers(0, max(4, dm // 2 + 1) + 1,
                                             size=n)
    f[::5] = 0
    return f.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRIM_CASES + K3_CASES)
def test_trim_gather_kernel_with_f_per_receiver(cuda_device, case):
    """A per-receiver F: tsum bit-equal to the float32 rank-order sum at
    each row's own F, kept bit-equal to the plain version's, through the
    kernel (one launch, counted as a tensor-F launch)."""
    prob = trim_problem(case, 9, 2, seed=21)
    n, dm = prob[1].shape
    Fr = mixed_trim_counts(n, dm, dm)
    args = [torch.from_numpy(a).to(cuda_device) for a in prob]
    before = (trim_gather_cuda.launches, trim_gather_cuda.launches_tensor_f)
    tsum, kept = trim_gather(*args, torch.from_numpy(Fr).to(cuda_device))
    torch.cuda.synchronize()
    assert (trim_gather_cuda.launches, trim_gather_cuda.launches_tensor_f) \
        == (before[0] + 1, before[1] + 1)
    tsum, kept = tsum.cpu().numpy(), kept.cpu().numpy()
    want = trim_rank_order_sum(*prob, Fr)
    np.testing.assert_array_equal(np.isnan(tsum), np.isnan(want))
    np.testing.assert_array_equal(tsum.view(np.int32)[~np.isnan(want)],
                                  want.view(np.int32)[~np.isnan(want)])
    k_ref = trim_gather_ref(*map(torch.from_numpy, prob),
                            torch.from_numpy(Fr))[1].numpy()
    np.testing.assert_array_equal(kept, k_ref)
    assert (tsum[k_ref == 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("F", [0, 1, 3])
def test_trim_gather_kernel_uniform_tensor_f_is_the_int_call(cuda_device, F):
    args = [torch.from_numpy(a).to(cuda_device)
            for a in trim_problem("scattered", 9, F, seed=F)]
    Fr = torch.full((args[0].shape[0],), F, dtype=torch.int32,
                    device=cuda_device)
    got = trim_gather_cuda(*args, Fr)
    want = trim_gather_cuda(*args, F)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_byzantine_grid_kernel_path_matches_plain(cuda_device):
    """benchmarks/byzantine_bench.py's grid (3 ring+ topologies of 3 x 5
    agents x F 0|1, here Γ 3 and 4) x 2 seeds: K3 launched once a round
    for all scenarios, with F per receiver; decisions equal to the plain
    path's on the card and r within the dense oracle's limits."""
    model = make_confused_model(N=15, m=3, truth=0, confusion=0.0, seed=0)
    cfgs = [ByzantineConfig(make_hierarchy([5, 5, 5], topology="ring+",
                                           extra_edge_prob=0.9, seed=s),
                            F, byz, 3 + F, attacks.sign_flip())
            for s in range(3) for F, byz in ((0, ()), (1, (1,)))]
    before = (trim_gather_cuda.launches, trim_gather_cuda.launches_tensor_f)
    got = run_byzantine_grid(model, cfgs, 60, [0, 5])
    torch.cuda.synchronize()
    assert (trim_gather_cuda.launches, trim_gather_cuda.launches_tensor_f) \
        == (before[0] + 60, before[1] + 60)
    plain = run_byzantine_grid(model, cfgs, 60, [0, 5],
                               plan=ExecutionPlan(backend="torch"))
    assert torch.equal(got.decisions, plain.decisions)
    torch.testing.assert_close(got.r, plain.r, rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("attack", ORACLE_ATTACKS)
@pytest.mark.parametrize("mode", ["pairwise", "ovr"])
def test_byzantine_kernel_path_matches_dense_oracle(cuda_device, attack,
                                                    mode):
    """The sparse core through the kernel against the port's dense oracle
    on the card: every decision at every step equal."""
    model, cfg, T = byzantine_oracle_scenario(attack)
    plan = ExecutionPlan(store="trajectory")
    before = trim_gather_cuda.launches
    sparse = run_byzantine_learning(model, cfg, T, seed=0, mode=mode,
                                    plan=plan)
    torch.cuda.synchronize()
    assert trim_gather_cuda.launches == before + T
    dense = run_byzantine_learning(model, cfg, T, seed=0, mode=mode,
                                   core="dense", plan=plan)
    assert torch.equal(sparse.decisions, dense.decisions)
    torch.testing.assert_close(sparse.r, dense.r, rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
def test_byzantine_random_noise_learns_on_both_cores(cuda_device):
    """random_noise draws per slot on the sparse core and per (sender,
    receiver) on the dense one, so only the outcome is compared."""
    model, cfg, T = byzantine_oracle_scenario("random_noise", T=300)
    normal = torch.from_numpy(~cfg.byz_mask()).to(cuda_device)
    for core in ("sparse", "dense"):
        res = run_byzantine_learning(model, cfg, T, seed=0, core=core,
                                     plan=ExecutionPlan(store="final"))
        acc = (res.decisions[normal] == model.truth).float().mean().item()
        assert acc == 1.0, (core, acc)


# (B, H, Hkv, Wc, dh, dtype, lengths: "full" | "ragged" | "empty_one")
DECODE_CASES = [
    (2, 32, 8, 77, 128, "bf16", "full"),
    (3, 32, 8, 77, 128, "bf16", "ragged"),
    (3, 8, 8, 1000, 128, "bf16", "full"),       # G = 1, a full ring window
    (2, 12, 4, 33, 64, "fp32", "ragged"),       # G = 3
    (2, 16, 2, 300, 256, "bf16", "empty_one"),  # G = 8
    (1, 32, 2, 40, 128, "fp32", "ragged"),      # G = 16
    # the one-launch tensor-core kernel: lengths inside 64-row tiles, G = 16
    (3, 32, 2, 200, 64, "bf16", "ragged"),
    (2, 32, 2, 77, 128, "bf16", "empty_one"),
    (4, 12, 4, 5, 128, "bf16", "ragged"),       # a cache shorter than a tile
    (8, 32, 8, 2081, 128, "bf16", "ragged"),    # the serve shape
]
# (B, S, H, Hkv, dh, dtype, window)
PREFILL_CASES = [
    (2, 128, 8, 2, 128, "bf16", 0),
    (2, 100, 8, 2, 128, "bf16", 0),             # S not a multiple of 64
    (1, 150, 4, 4, 64, "fp32", 16),
    (1, 70, 8, 2, 256, "bf16", 64),
    (2, 1, 4, 1, 64, "fp32", 0),
    (1, 130, 4, 2, 256, "fp32", 100),
    # the tensor-core kernel (bf16 at head sizes 64, 128 and 256)
    (8, 1024, 12, 4, 64, "bf16", 0),            # the training shape, G = 3
    (8, 1024, 12, 4, 64, "bf16", 256),
    (2, 1000, 8, 8, 64, "bf16", 0),             # ragged S, G = 1
    (2, 1000, 12, 4, 128, "bf16", 0),           # ragged S, G = 3
    (1, 300, 8, 2, 128, "bf16", 100),           # G = 4, the window edge
    (1, 300, 8, 2, 64, "bf16", 100),            #   inside query tiles
    (2, 1, 4, 1, 128, "bf16", 0),
    (2, 300, 10, 1, 256, "bf16", 0),            # G = 10, ragged S
    (1, 300, 10, 1, 256, "bf16", 100),          # the window edge inside
    (2, 512, 3, 1, 256, "bf16", 0),             #   query tiles; a rank's
    (2, 1, 10, 1, 256, "bf16", 0),              #   heads at model 4; S = 1
]
_DT = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _attn_tol(dtype):
    return 2 ** -8 if dtype == torch.bfloat16 else 1e-5


def decode_problem(B, H, Hkv, Wc, dh, lengths, seed=0):
    """float32 numpy (q, k, v, lengths) of one decode-attention call."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, dh)).astype(np.float32)
    k = (2 * rng.normal(size=(B, Hkv, Wc, dh))).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Wc, dh)).astype(np.float32)
    if lengths == "full":
        L = np.full(B, Wc)
    else:
        L = rng.integers(1, Wc + 1, size=B)
        if lengths == "empty_one":
            L[0] = 0
    return q, k, v, L.astype(np.int32)


def prefill_problem(B, S, H, Hkv, dh, seed=0):
    """float32 numpy (q, k, v) in the (B, S, heads, dh) layout."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    k = (2 * rng.normal(size=(B, S, Hkv, dh))).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES)
def test_attn_decode_kernel_matches_plain(cuda_device, case):
    B, H, Hkv, Wc, dh, dt, lens = case
    q, k, v, L = decode_problem(B, H, Hkv, Wc, dh, lens)
    dtype = _DT[dt]
    tq, tk, tv = (torch.from_numpy(a).to(cuda_device, dtype)
                  for a in (q, k, v))
    tl = torch.from_numpy(L).to(cuda_device)
    before = attn_decode_cuda.launches, attn_decode_cuda.launches_tc
    got = attn_decode(tq, tk, tv, tl)
    torch.cuda.synchronize()
    assert attn_decode_cuda.launches == before[0] + 1
    assert attn_decode_cuda.launches_tc == before[1] + (dt == "bf16")
    assert all(int(t.abs().sum()) == 0 for t in _TICKETS.values())
    assert got.dtype == dtype and got.shape == (B, H, dh)
    want = attn_decode_ref(tq.float(), tk.float(), tv.float(), tl)
    torch.testing.assert_close(got.float(), want, rtol=_attn_tol(dtype),
                               atol=1e-5, equal_nan=True)
    assert bool(torch.isnan(got).any()) == (lens == "empty_one")


@pytest.mark.cuda
def test_attn_decode_kernel_ignores_rows_past_the_length(cuda_device):
    q, k, v, L = (torch.from_numpy(a).to(cuda_device) for a in
                  decode_problem(2, 8, 2, 50, 128, "ragged", seed=3))
    k2, v2 = k.clone(), v.clone()
    for b in range(2):
        k2[b, :, L[b]:] = float("nan")
        v2[b, :, L[b]:] = 1e30
    assert torch.equal(attn_decode_cuda(q, k, v, L),
                       attn_decode_cuda(q, k2, v2, L))


# K5's rank-partial mode over n blocks of a ring: RecurrentGemma's shape
# (10 query heads on one KV head of 256) and G 4 at head size 128; lengths
# "wrapped" (every row valid), "first" (valid rows in the first block only:
# the later blocks are empty) and "ragged"
PARTIAL_CASES = [(2, 10, 1, 512, 256), (3, 8, 2, 256, 128)]


def _partial_lengths(B, Wc, n, lens, seed):
    rng = np.random.default_rng(seed)
    if lens == "wrapped":
        return np.full(B, Wc, dtype=np.int32)
    if lens == "first":
        return rng.integers(1, Wc // n + 1, size=B).astype(np.int32)
    return rng.integers(1, Wc + 1, size=B).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("lens", ["wrapped", "first", "ragged"])
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("dt", ["bf16", "fp32"])
@pytest.mark.parametrize("shape", PARTIAL_CASES)
def test_attn_decode_partial_kernel_matches_plain(cuda_device, shape, dt, n,
                                                  lens):
    """Each block's triple against the plain partial (an empty block: m =
    -inf, l = 0, acc = 0 exactly), the merge of the n blocks through the
    combine kernel against the plain merge and the whole decode."""
    B, H, Hkv, Wc, dh = shape
    q, k, v, _ = decode_problem(B, H, Hkv, Wc, dh, "full", seed=n)
    L = torch.from_numpy(_partial_lengths(B, Wc, n, lens, n)).to(cuda_device)
    dtype = _DT[dt]
    tq, tk, tv = (torch.from_numpy(a).to(cuda_device, dtype)
                  for a in (q, k, v))
    Wb, tol = Wc // n, _attn_tol(dtype)
    before = (attn_decode_cuda.launches, attn_decode_partial_cuda.launches,
              attn_decode_merge_cuda.launches)
    parts = []
    for r in range(n):
        kb, vb = (t[:, :, r * Wb:(r + 1) * Wb].contiguous() for t in (tk, tv))
        Lr = torch.clamp(L - r * Wb, 0, Wb).to(torch.int32)
        acc, m, l = attn_decode_partial(tq, kb, vb, Lr)
        wa, wm, wl = attn_decode_partial_ref(tq.float(), kb.float(),
                                             vb.float(), Lr)
        empty = Lr == 0
        assert bool((m[empty] == -torch.inf).all()) and \
            bool((l[empty] == 0).all()) and bool((acc[empty] == 0).all())
        torch.testing.assert_close(m[~empty], wm[~empty], rtol=tol, atol=1e-4)
        torch.testing.assert_close(acc[~empty] / l[~empty, :, None],
                                   wa[~empty] / wl[~empty, :, None],
                                   rtol=tol, atol=1e-5)
        parts.append((acc, m, l))
    acc, m, l = (torch.stack(t) for t in zip(*parts))
    got = attn_decode_merge(acc, m, l, dtype)
    torch.cuda.synchronize()
    assert (attn_decode_cuda.launches, attn_decode_partial_cuda.launches,
            attn_decode_merge_cuda.launches) == (before[0], before[1] + n,
                                                 before[2] + 1)
    assert all(int(t.abs().sum()) == 0 for t in _TICKETS.values())
    assert got.dtype == dtype and got.shape == (B, H, dh)
    torch.testing.assert_close(got.float(),
                               attn_decode_merge_ref(acc, m, l), rtol=tol,
                               atol=1e-5)
    want = attn_decode_ref(tq.float(), tk.float(), tv.float(), L)
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=1e-5)
    # the triples packed as the ranks gather them: strided views
    packed = torch.cat([acc, m[..., None], l[..., None]], dim=-1)
    assert torch.equal(attn_decode_merge(packed[..., :dh], packed[..., dh],
                                         packed[..., dh + 1], dtype), got)


@pytest.mark.cuda
def test_attn_decode_kernel_rejects_bad_arguments(cuda_device):
    q, k, v, L = (torch.from_numpy(a).to(cuda_device) for a in
                  decode_problem(2, 8, 2, 20, 128, "full"))
    with pytest.raises(ValueError, match="head size"):
        attn_decode_cuda(q[..., :96].contiguous(), k[..., :96].contiguous(),
                         v[..., :96].contiguous(), L)
    with pytest.raises(ValueError, match="dtype"):
        attn_decode_cuda(q.half(), k.half(), v.half(), L)
    with pytest.raises(ValueError, match="dtype"):
        attn_decode_cuda(q, k, v, L.long())
    with pytest.raises(ValueError, match="contiguous"):
        attn_decode_cuda(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                         v, L)
    with pytest.raises(ValueError, match="query heads per KV head"):
        wide = q.repeat(1, 8, 1)                  # 64 heads over 2: G = 32
        attn_decode_cuda(wide, k, v, L)
    with pytest.raises(ValueError, match="CUDA tensors"):
        attn_decode_cuda(q.cpu(), k.cpu(), v.cpu(), L.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("case", PREFILL_CASES)
def test_swa_prefill_kernel_matches_plain(cuda_device, case):
    B, S, H, Hkv, dh, dt, window = case
    dtype = _DT[dt]
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in prefill_problem(B, S, H, Hkv, dh))
    before = swa_prefill_cuda.launches
    before_tc = swa_prefill_cuda.launches_tc
    got = swa_prefill(q, k, v, window)
    torch.cuda.synchronize()
    assert swa_prefill_cuda.launches == before + 1
    tc = dtype == torch.bfloat16 and dh in (64, 128, 256)
    assert prefill_kernel(dtype, dh) == ("tc" if tc else "fma")
    assert swa_prefill_cuda.launches_tc == before_tc + tc
    assert got.dtype == dtype and got.shape == (B, S, H, dh)
    want = swa_prefill_ref(q.float(), k.float(), v.float(), window)
    torch.testing.assert_close(got.float(), want, rtol=_attn_tol(dtype),
                               atol=1e-5)


@pytest.mark.cuda
def test_swa_prefill_kernel_reads_strided_views(cuda_device):
    """q, k, v as views of one fused projection row, as the model hands
    them over: the same result as from contiguous copies."""
    B, S, H, Hkv, dh = 2, 90, 8, 2, 128
    x = torch.randn(B, S, (H + 2 * Hkv) * dh, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0))
    q = x[..., :H * dh].view(B, S, H, dh)
    k = x[..., H * dh:(H + Hkv) * dh].view(B, S, Hkv, dh)
    v = x[..., (H + Hkv) * dh:].view(B, S, Hkv, dh)
    assert not q.is_contiguous()
    assert torch.equal(swa_prefill_cuda(q, k, v, 7),
                       swa_prefill_cuda(q.contiguous(), k.contiguous(),
                                        v.contiguous(), 7))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128, 256])
def test_swa_prefill_tc_kernel_reads_strided_views(cuda_device, dh):
    """The tensor-core kernel's tensor maps over views of one fused bf16
    projection row: the same result as from contiguous copies, and the
    float32 plain version's within the bf16 limit."""
    B, S, H, Hkv = 2, 300, 8, 2
    x = torch.randn(B, S, (H + 2 * Hkv) * dh, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0))
    x = x.to(torch.bfloat16)
    q = x[..., :H * dh].view(B, S, H, dh)
    k = x[..., H * dh:(H + Hkv) * dh].view(B, S, Hkv, dh)
    v = x[..., (H + Hkv) * dh:].view(B, S, Hkv, dh)
    before = swa_prefill_cuda.launches_tc
    got = swa_prefill_cuda(q, k, v, 0)
    assert swa_prefill_cuda.launches_tc == before + 1
    assert torch.equal(got, swa_prefill_cuda(q.contiguous(), k.contiguous(),
                                             v.contiguous(), 0))
    torch.testing.assert_close(got.float(), swa_prefill_ref(
        q.float(), k.float(), v.float(), 0), rtol=2 ** -8, atol=1e-5)


@pytest.mark.cuda
def test_swa_prefill_kernel_rejects_bad_arguments(cuda_device):
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in prefill_problem(1, 16, 4, 2, 64))
    with pytest.raises(ValueError, match="window"):
        swa_prefill_cuda(q, k, v, -1)
    with pytest.raises(ValueError, match="dtype"):
        swa_prefill_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="strides"):
        swa_prefill_cuda(q.transpose(1, 3).contiguous().transpose(1, 3),
                         k, v)
    with pytest.raises(ValueError, match="head size"):
        swa_prefill_cuda(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError, match="CUDA tensors"):
        swa_prefill_cuda(q.cpu(), k.cpu(), v.cpu())
    # TMA needs strides that are multiples of 16 bytes: a row of 4 x 64 + 4
    # bf16 passes the FMA kernel's check (multiples of 4) but not this one
    x = torch.zeros((1, 16, 4 * 64 + 4), dtype=torch.bfloat16,
                    device=cuda_device)
    qb = x[..., :4 * 64].view(1, 16, 4, 64)
    with pytest.raises(ValueError, match="multiples of 8"):
        swa_prefill_cuda(qb, k.bfloat16(), v.bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("arch,extra", [
    ("qwen3_8b", {}),
    ("qwen3_8b", {"n_layers": 4, "scan_layers": True}),
    ("qwen3_8b", {"block_pattern": ("swa",), "window": 8}),
    ("command_r_35b", {}),
])
def test_serve_path_through_the_kernels_matches_plain(cuda_device, arch,
                                                      extra):
    """Reduced float32 models on the card: prefill + decode through K6 and
    K5 against the plain path, and both against the full forward
    (float32, another summation order: atol = rtol = 1e-4)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    cfg = dataclasses.replace(reduced(get_config(arch)), **extra)
    params = M.init_params(0, cfg, cuda_device)
    toks = torch.randint(0, cfg.vocab, (2, 20), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    S, steps = 15, 5
    full = M.forward_train(params, cfg, toks, backend="torch")
    for backend in ("auto", "torch"):
        k6, k5 = swa_prefill_cuda.launches, attn_decode_cuda.launches
        lg, cache = M.prefill(params, cfg, toks[:, :S], cache_len=S + steps,
                              backend=backend)
        got = [lg[:, 0]]
        for i in range(steps - 1):
            lg, cache = M.decode_step(params, cfg, cache,
                                      toks[:, S + i:S + i + 1],
                                      backend=backend)
            got.append(lg[:, 0])
        torch.cuda.synchronize()
        n = cfg.n_layers if backend == "auto" else 0
        assert swa_prefill_cuda.launches == k6 + n
        assert attn_decode_cuda.launches == k5 + n * (steps - 1)
        torch.testing.assert_close(torch.stack(got, 1),
                                   full[:, S - 1:S + steps - 1],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bf16", "fp32"])
@pytest.mark.parametrize("case", [
    (8, 10, 1, 2048, "full"),        # RecurrentGemma's decode: G = 10
    (8, 10, 1, 2048, "ragged"),
    (3, 16, 1, 300, "ragged"),       # G = 16
    (2, 20, 2, 77, "empty_one"),     # G = 10 over two KV heads
])
def test_attn_decode_kernels_take_ten_and_sixteen_heads_at_256(cuda_device,
                                                                 case, dt):
    """Both K5 kernels at head size 256 with 9-16 query heads per KV head
    (the tensor-core kernel's 16-row product with q in shared memory; the
    split kernel's two blocks a split) against the plain version."""
    B, H, Hkv, Wc, lens = case
    q, k, v, L = decode_problem(B, H, Hkv, Wc, 256, lens, seed=H)
    dtype = _DT[dt]
    tq, tk, tv = (torch.from_numpy(a).to(cuda_device, dtype)
                  for a in (q, k, v))
    tl = torch.from_numpy(L).to(cuda_device)
    before = attn_decode_cuda.launches_tc
    got = attn_decode_cuda(tq, tk, tv, tl)
    torch.cuda.synchronize()
    assert attn_decode_cuda.launches_tc == before + (dt == "bf16")
    assert all(int(t.abs().sum()) == 0 for t in _TICKETS.values())
    want = attn_decode_ref(tq.float(), tk.float(), tv.float(), tl)
    torch.testing.assert_close(got.float(), want, rtol=_attn_tol(dtype),
                               atol=1e-5, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,extra", [
    ("olmoe_1b_7b", {}),
    ("recurrentgemma_2b", {"window": 8}),
    ("whisper_small", {}),
    ("internvl2_26b", {}),
])
def test_family_serve_path_through_the_kernels_matches_plain(
        cuda_device, arch, extra):
    """Reduced float32 models of the other families on the card: prefill
    + decode through K6 (once per attention layer) and K5 (once per
    attention layer a step) against the plain path (float32, another
    summation order: atol = rtol = 1e-4)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    cfg = dataclasses.replace(reduced(get_config(arch)), **extra)
    params = M.init_params(0, cfg, cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 20), device=cuda_device,
                         generator=gen)
    stubs = {}
    if cfg.family == "audio":
        stubs["frames"] = torch.randn((2, cfg.n_frames, cfg.d_model),
                                      device=cuda_device, generator=gen)
    if cfg.family == "vlm":
        stubs["patch_embeds"] = torch.randn((2, cfg.n_patches, M.D_VIS),
                                            device=cuda_device,
                                            generator=gen)
    S, steps = 15, 5
    n_attn = sum(cfg.mixer_of(i) in ("attn", "swa")
                 for i in range(cfg.n_layers))
    outs = {}
    for backend in ("auto", "torch"):
        k6, k5 = swa_prefill_cuda.launches, attn_decode_cuda.launches
        lg, cache = M.prefill(params, cfg, toks[:, :S],
                              cache_len=S + steps + cfg.n_patches,
                              backend=backend, **stubs)
        got = [lg[:, 0]]
        for i in range(steps - 1):
            lg, cache = M.decode_step(params, cfg, cache,
                                      toks[:, S + i:S + i + 1],
                                      backend=backend)
            got.append(lg[:, 0])
        torch.cuda.synchronize()
        n = n_attn if backend == "auto" else 0
        assert swa_prefill_cuda.launches == k6 + n
        assert attn_decode_cuda.launches == k5 + n * (steps - 1)
        outs[backend] = torch.stack(got, 1)
    torch.testing.assert_close(outs["auto"], outs["torch"], rtol=1e-4,
                               atol=1e-4)



@pytest.mark.cuda
@pytest.mark.parametrize("arch,extra", [
    ("olmoe_1b_7b", {"scan_layers": True, "capacity_factor": 1.0}),
    ("whisper_small", {}),
    ("internvl2_26b", {"scan_layers": True}),
])
def test_family_loss_gradients_through_k6_match_plain(cuda_device, arch,
                                                      extra):
    """Reduced float32 models of the MoE (capacity drops), audio and VLM
    families with remat on the card: ``loss_fn`` with the aux, frames or
    patches, and every gradient, K6 in each attention layer's forward and
    remat recompute (its backward through ``SwaPrefillFn``), against the
    plain path (float32, another summation order: the loss rtol 1e-5,
    each gradient leaf within 1e-4 of its largest entry)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import leaves
    cfg = dataclasses.replace(reduced(get_config(arch)), remat=True,
                              **extra)
    params = M.init_params(0, cfg, cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (2, 21), device=cuda_device,
                         generator=gen)
    stubs = {}
    if cfg.family == "audio":
        stubs["frames"] = torch.randn((2, cfg.n_frames, cfg.d_model),
                                      device=cuda_device, generator=gen)
    if cfg.family == "vlm":
        stubs["patch_embeds"] = torch.randn((2, cfg.n_patches, M.D_VIS),
                                            device=cuda_device,
                                            generator=gen)
    n_attn = sum(cfg.mixer_of(i) in ("attn", "swa")
                 for i in range(cfg.n_layers))
    res = {}
    for backend in ("auto", "torch"):
        tree = M._tmap(lambda p: p.detach().requires_grad_(), params)
        ps = leaves(tree)
        k6 = swa_prefill_cuda.launches
        loss = M.loss_fn(tree, cfg, toks[:, :-1], toks[:, 1:], backend,
                         **stubs)
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
        torch.cuda.synchronize()
        n = 2 * n_attn if backend == "auto" else 0
        assert swa_prefill_cuda.launches == k6 + n
        res[backend] = (loss.item(), grads)
    (lk, gk), (lp, gp) = res["auto"], res["torch"]
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for a, b in zip(gk, gp):
        assert (a is None) == (b is None)
        if b is not None:
            torch.testing.assert_close(
                a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item())

# (BH, T, dtype, lw: "model" | a constant log-decay)
WKV_CASES = [
    (1, 1, "fp32", "model"), (5, 63, "bf16", "model"),
    (5, 64, "fp32", "model"), (1, 65, "bf16", "model"),
    (5, 200, "fp32", "model"), (5, 200, "bf16", "model"),
    (3, 130, "fp32", -float(np.exp(4.0))), (3, 130, "bf16",
                                            -float(np.exp(4.0))),
    (3, 300, "fp32", -float(np.exp(-8.0))),
    # chunk-group edges: groups of 1 chunk at 8 sequences, of 4 at 300
    (8, 127, "bf16", "model"), (8, 128, "fp32", -float(np.exp(4.0))),
    (8, 129, "bf16", -float(np.exp(-8.0))), (300, 255, "bf16", "model"),
    (300, 257, "fp32", "model"),
    (1, 8192, "bf16", "model"),                 # 128 groups of one chunk
]


def wkv_problem(BH, T, lw, seed=0, K=64):
    """float32 numpy (r, k, v, lw, u); ``lw="model"`` draws the model's
    range, -exp(clip(-0.5 + normal, -8, 4))."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(BH, T, K)).astype(np.float32)
               for _ in range(3))
    if lw == "model":
        lwa = -np.exp(np.clip(-0.5 + rng.normal(size=(BH, T, K)), -8, 4))
    else:
        lwa = np.full((BH, T, K), lw)
    u = (0.5 * rng.normal(size=(BH, K))).astype(np.float32)
    return r, k, v, lwa.astype(np.float32), u


def _wkv_tols(dtype, lw):
    """(rtol of y, rtol of the state, atol)."""
    strong = lw != "model" and lw < -50
    rtol = 5e-4 if strong else 1e-3
    atol = 5e-3 if strong else 1e-3
    return (2 ** -7 if dtype == torch.bfloat16 else rtol), rtol, atol


@pytest.mark.cuda
@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv6_kernel_matches_plain(cuda_device, case):
    BH, T, dt, lw = case
    dtype = _DT[dt]
    r, k, v, lwa, u = (torch.from_numpy(a).to(cuda_device)
                       for a in wkv_problem(BH, T, lw))
    r, k, v = (a.to(dtype) for a in (r, k, v))
    before = wkv6_cuda.launches
    y, s = wkv6(r, k, v, lwa, u)
    torch.cuda.synchronize()
    assert wkv6_cuda.launches == before + 1
    assert y.dtype == dtype and y.shape == (BH, T, 64)
    assert s.dtype == torch.float32 and s.shape == (BH, 64, 64)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    y_rtol, s_rtol, atol = _wkv_tols(dtype, lw)
    for y_w, s_w in (wkv6_chunked_ref(r, k, v, lwa, u, chunk=64),
                     wkv6_ref(r, k, v, lwa, u)):
        torch.testing.assert_close(y.float(), y_w.float(), rtol=y_rtol,
                                   atol=atol)
        torch.testing.assert_close(s, s_w, rtol=s_rtol, atol=atol)


@pytest.mark.cuda
def test_wkv6_kernel_reads_head_layout_views(cuda_device):
    """(B, H, T, K) views of (B, T, H, K) projections, as the model hands
    them over, with u a broadcast: the flat contiguous call's result,
    and y comes back in the (B, T, H, V) layout."""
    B, H, T = 2, 3, 100
    r, k, v, lwa, _ = (torch.from_numpy(a).to(cuda_device)
                       for a in wkv_problem(B * H, T, "model", seed=1))
    u = torch.randn(H, 64, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(2))

    def heads(a):
        return a.view(B, H, T, 64).transpose(1, 2).contiguous() \
            .transpose(1, 2)

    y4, s4 = wkv6_cuda(heads(r), heads(k), heads(v), heads(lwa),
                       u.expand(B, H, 64))
    y3, s3 = wkv6_cuda(r, k, v, lwa, u.expand(B, H, 64).reshape(B * H, 64))
    assert y4.shape == (B, H, T, 64) and y4.transpose(1, 2).is_contiguous()
    assert torch.equal(y4.reshape(B * H, T, 64), y3)
    assert torch.equal(s4.reshape(B * H, 64, 64), s3)


@pytest.mark.cuda
def test_wkv6_kernel_rejects_bad_arguments(cuda_device):
    r, k, v, lwa, u = (torch.from_numpy(a).to(cuda_device)
                       for a in wkv_problem(2, 16, "model"))
    with pytest.raises(ValueError, match="dtype"):
        wkv6_cuda(r.half(), k.half(), v.half(), lwa, u)
    with pytest.raises(ValueError, match="float32"):
        wkv6_cuda(r.bfloat16(), k.bfloat16(), v.bfloat16(), lwa.bfloat16(),
                  u)
    with pytest.raises(ValueError, match="K = V = 64"):
        wkv6_cuda(*(a[..., :32].contiguous() for a in (r, k, v, lwa, u)))
    with pytest.raises(ValueError, match="shape"):
        wkv6_cuda(r, k, v[:, :8].contiguous(), lwa, u)
    with pytest.raises(ValueError, match="contiguous channel"):
        wkv6_cuda(r.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                  lwa, u)
    with pytest.raises(ValueError, match="T >= 1"):
        wkv6_cuda(*(a[:, :0] for a in (r, k, v, lwa)), u)
    with pytest.raises(ValueError, match="chunk"):
        wkv6(r, k, v, lwa, u, chunk=32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wkv6_cuda(*(a.cpu() for a in (r, k, v, lwa, u)))
    rg = r.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        wkv6_cuda(rg, k, v, lwa, u)           # the raw launcher
    y, _ = wkv6(rg, k, v, lwa, u)             # through Wkv6Fn
    assert y.grad_fn is not None
    with torch.no_grad():
        wkv6_cuda(rg, k, v, lwa, u)           # no graph: the kernel runs


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [{}, {"n_layers": 4, "scan_layers": True}])
def test_rwkv6_serve_path_through_the_kernel_matches_plain(cuda_device,
                                                           extra):
    """Reduced float32 RWKV6 on the card: prefill through K7 (a ragged
    last chunk at S = 70) and plain decode steps against the plain path,
    and both against the full forward (float32, another summation order,
    the chunked limit: atol = rtol = 1e-3)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    cfg = dataclasses.replace(reduced(get_config("rwkv6_1b6")), **extra)
    params = M.init_params(0, cfg, cuda_device)
    toks = torch.randint(0, cfg.vocab, (2, 75), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    S, steps = 70, 5
    with torch.inference_mode():
        full = M.forward_train(params, cfg, toks, backend="torch")
        for backend in ("auto", "torch"):
            k7 = wkv6_cuda.launches
            lg, cache = M.prefill(params, cfg, toks[:, :S], backend=backend)
            got = [lg[:, 0]]
            for i in range(steps - 1):
                lg, cache = M.decode_step(params, cfg, cache,
                                          toks[:, S + i:S + i + 1],
                                          backend=backend)
                got.append(lg[:, 0])
            torch.cuda.synchronize()
            n = cfg.n_layers if backend == "auto" else 0
            assert wkv6_cuda.launches == k7 + n
            torch.testing.assert_close(torch.stack(got, 1),
                                       full[:, S - 1:S + steps - 1],
                                       rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# the trimmed mean K4, and training through the kernels
# ---------------------------------------------------------------------------

EPS32 = float(np.finfo(np.float32).eps)
# (W, F, D, case, column offset)
TMEAN_CASES = [
    (3, 0, 1, "normal", 0), (3, 1, 3, "ties", 1), (3, 1, 4097, "normal", 0),
    (4, 1, 4097, "byzantine", 1), (4, 0, 3, "normal", 0),
    (8, 0, 4097, "normal", 0), (8, 2, 4097, "byzantine", 0),
    (8, 3, 4097, "ties", 1), (8, 2, 1, "byzantine", 1),
    (16, 7, 4097, "byzantine", 0), (16, 4, 3, "ties", 0),
    (16, 1, 4097, "huge_scale", 1), (32, 15, 4097, "ties", 0),
    (32, 7, 4097, "byzantine", 1), (32, 0, 1, "normal", 1),
    (8, 2, 4097, "non_finite", 0), (7, 2, 1000, "too_many_nan", 1),
    # the 64-wide instantiation (two coordinates a thread, a 64-bit mask)
    (33, 16, 4097, "byzantine", 0), (33, 1, 1000, "too_many_nan", 1),
    (48, 2, 4097, "normal", 1), (48, 23, 3, "ties", 0),
    (64, 31, 4097, "ties", 0), (64, 2, 4097, "non_finite", 1),
    (64, 0, 1, "normal", 1), (64, 7, 4097, "huge_scale", 0),
    # NaNs with the sign bit set (sorted last, as by torch.sort), +-0 ties
    (8, 2, 4097, "nan_sign", 0), (5, 1, 1000, "nan_sign", 1),
    (64, 7, 4097, "nan_sign", 0), (8, 2, 4097, "signed_zero", 0),
    (33, 5, 3, "signed_zero", 1), (16, 3, 1000, "signed_zero", 0),
]


def tmean_problem(W, D, case, seed=0):
    """float32 numpy (W, D) worker values: ``ties`` (half the columns one
    value, the rest on a half-integer grid), ``byzantine`` (a +1e6 and a
    -1e6 row), ``huge_scale`` (one row 1e6 times the rest), ``non_finite``
    (an inf, a -inf and a NaN row with F = 2: all trimmed),
    ``too_many_nan`` (three NaN rows with F = 2: NaN survives),
    ``nan_sign`` (two rows of NaNs with the sign bit set, 0xFFC00000 and
    0xFF800001, which sort above +inf: trimmed at F >= 2, one survives at
    F = 1) and ``signed_zero`` (values from {-1, -0, +0, 1}: +-0 ties)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(W, D)).astype(np.float32)
    if case == "ties":
        x = (np.round(x * 2) / 2).astype(np.float32)
        x[:, : D // 2] = x[0, : D // 2]
    elif case == "byzantine":
        x[1] = 1e6
        x[W - 1] = -1e6
    elif case == "huge_scale":
        x[0] *= 1e6
    elif case == "non_finite":
        x[0], x[3], x[5] = np.inf, -np.inf, np.nan
    elif case == "too_many_nan":
        x[1:4] = np.nan
    elif case == "nan_sign":
        x[0] = np.array(0xFFC00000, np.uint32).view(np.float32)
        x[min(2, W - 1)] = np.array(0xFF800001, np.uint32).view(np.float32)
    elif case == "signed_zero":
        x = rng.choice(np.array([-1.0, -0.0, 0.0, 1.0], np.float32),
                       size=(W, D))
    return x


def tmean_bound(x, F):
    """Per-coordinate limit for two orders of the survivors' sum."""
    W = x.shape[0]
    fin = np.where(np.isfinite(x), x, 0.0)
    return W * EPS32 * np.abs(fin).sum(axis=0) / (W - 2 * F) + 1e-30


def _hold_tmean(got, want, x, F):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    err = np.abs(got - want)[fin]
    assert (err <= tmean_bound(x, F)[fin]).all(), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("W,F,D,case,offset", TMEAN_CASES)
def test_trimmed_mean_kernel_matches_plain(cuda_device, W, F, D, case,
                                           offset):
    """A column offset of 1 reads a misaligned column range of a wider
    buffer through its row stride (the scalar path), as an aggregator
    hands over a leaf's columns. The plain version runs on the CPU, whose
    sort puts every NaN last as the reference's ``jnp.sort`` does; on the
    card ``torch.sort`` puts NaNs with the sign bit set first once a
    column holds more than 32 values."""
    x = tmean_problem(W, D + offset, case)
    buf = torch.from_numpy(x).to(cuda_device)
    view = buf[:, offset:]
    before = trimmed_mean_cuda.launches
    got = trimmed_mean(view, F)
    torch.cuda.synchronize()
    assert trimmed_mean_cuda.launches == before + 1
    assert got.shape == (D,) and got.dtype == torch.float32
    _hold_tmean(got, trimmed_mean_ref(view.cpu(), F), x[:, offset:], F)
    out = torch.full((D + 1,), 7.0, device=cuda_device)
    trimmed_mean_cuda(view, F, out=out[:D])   # into a caller's buffer
    torch.cuda.synchronize()
    torch.testing.assert_close(out[:D], got, rtol=0, atol=0,
                               equal_nan=True)
    assert out[D].item() == 7.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["normal", "ties", "nan_sign"])
def test_trimmed_mean_kernel_at_every_width_and_trim(cuda_device, case):
    """Every W from 1 to 64 (all five compile-time widths of the sorting
    network, each slot count padded with the largest key) and every F up
    to (W - 1) // 2, at D = 37 (a ragged last vector), against the plain
    version on the CPU."""
    for W in range(1, W_MAX + 1):
        x = tmean_problem(W, 37, case, seed=W)
        buf = torch.from_numpy(x).to(cuda_device)
        for F in range((W - 1) // 2 + 1):
            got = trimmed_mean_cuda(buf, F)
            _hold_tmean(got, trimmed_mean_ref(torch.from_numpy(x), F), x, F)


@pytest.mark.cuda
def test_trimmed_mean_kernel_rejects_bad_arguments(cuda_device):
    x = torch.zeros((8, 16), device=cuda_device)
    with pytest.raises(ValueError, match="W > 2F"):
        trimmed_mean_cuda(x[:4], 2)
    with pytest.raises(ValueError, match="W > 2F"):
        trimmed_mean(x[:2], 1)
    with pytest.raises(ValueError, match=f"at most {W_MAX}"):
        trimmed_mean_cuda(torch.zeros((W_MAX + 1, 4), device=cuda_device), 1)
    with pytest.raises(ValueError, match="float32"):
        trimmed_mean_cuda(x.bfloat16(), 1)
    with pytest.raises(ValueError, match="unit column stride"):
        trimmed_mean_cuda(x[:, ::2], 1)
    with pytest.raises(ValueError, match="shape"):
        trimmed_mean_cuda(x, 1, out=torch.empty(15, device=cuda_device))
    with pytest.raises(ValueError, match="CUDA tensors"):
        trimmed_mean_cuda(x.cpu(), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 24])
def test_swa_prefill_grads_through_the_kernel(cuda_device, dtype, window):
    """K6 forward, plain-recompute backward: for a loss linear in the
    output the gradients are plain autograd's bit for bit, and the output
    is K6's (held against the plain version in float32 on the same
    inputs, as the kernel tests hold it)."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in prefill_problem(2, 100, 8, 2, 64, seed=3))
    up = torch.randn((2, 100, 8, 64), device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(4))
    res = {}
    for name in ("kernel", "plain"):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        before = swa_prefill_cuda.launches
        out = swa_prefill(*ins, window, backend="auto" if name == "kernel"
                          else "torch")
        assert swa_prefill_cuda.launches == before + (name == "kernel")
        (out.float() * up).sum().backward()
        res[name] = (out.detach(), [t.grad for t in ins])
    out_k, g_k = res["kernel"]
    _, g_p = res["plain"]
    want = swa_prefill_ref(q.float(), k.float(), v.float(), window)
    torch.testing.assert_close(out_k.float(), want, rtol=_attn_tol(dtype),
                               atol=1e-5)
    for a, b in zip(g_k, g_p):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="no backward"):
        swa_prefill_cuda(*(t.clone().requires_grad_() for t in (q, k, v)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_grads_through_the_kernel(cuda_device, dtype):
    """K7 forward, chunk-64 plain backward through y and the state, in the
    model's (B, H, T, K) view layout with u a broadcast."""
    B, H, T = 2, 3, 130
    r, k, v, lw, _ = (torch.from_numpy(a).to(cuda_device)
                      for a in wkv_problem(B * H, T, "model", seed=5))
    u = torch.randn((H, 64), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(6))
    gen = torch.Generator(cuda_device).manual_seed(7)
    gy = torch.randn((B, H, T, 64), device=cuda_device, generator=gen)
    gs = torch.randn((B, H, 64, 64), device=cuda_device, generator=gen)
    res = {}
    for name in ("kernel", "plain"):
        ins = [t.to(dtype).clone().requires_grad_() for t in (r, k, v)] + \
            [lw.clone().requires_grad_()]
        uu = u.clone().requires_grad_()
        args = [t.view(B, H, T, 64) for t in ins] + [uu.expand(B, H, 64)]
        if name == "kernel":
            before = wkv6_cuda.launches
            y, s = wkv6(*args)
            assert wkv6_cuda.launches == before + 1
        else:
            y, s = wkv6_chunked_ref(*(a.reshape((-1,) + a.shape[2:])
                                      for a in args), chunk=64)
            y, s = y.view(B, H, T, 64), s.view(B, H, 64, 64)
        ((y.float() * gy).sum() + (s * gs).sum()).backward()
        res[name] = [t.grad for t in ins] + [uu.grad]
    for a, b in zip(res["kernel"], res["plain"]):
        assert torch.equal(a, b)


def _model_grads(cfg, params, toks, backend):
    from repro_torch.models import model as M
    leaves = [p.detach().clone().requires_grad_() for p in
              params["layers"][0]["mixer"].values()]
    mixer = dict(zip(params["layers"][0]["mixer"].keys(), leaves))
    p = dict(params, layers=[dict(params["layers"][0], mixer=mixer)]
             + params["layers"][1:])
    loss = M.loss_fn(p, cfg, toks, toks, backend)
    loss.backward()
    return {k: t.grad for k, t in mixer.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_attention_gradients_through_k6_equal_the_plain_path(cuda_device,
                                                             remat):
    """The regression test of the K6 gradient fault: ``loss_fn`` through
    ``forward_train(backend="auto")`` (K6, and K6 again in the remat
    recompute) gives the first layer's wq, wk, wv, wo and qk-norm
    gradients of the plain path. Before the autograd wrapper the kernel's
    output had no graph and wq got no gradient from the attention."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    cfg = dataclasses.replace(reduced(get_config("qwen3_8b")), remat=remat)
    assert cfg.head_dim == 64 and cfg.qk_norm
    params = M.init_params(0, cfg, cuda_device)
    toks = torch.randint(0, cfg.vocab, (2, 96), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    before = swa_prefill_cuda.launches
    got = _model_grads(cfg, params, toks, "auto")
    torch.cuda.synchronize()
    assert swa_prefill_cuda.launches == before + cfg.n_layers * (1 + remat)
    want = _model_grads(cfg, params, toks, "torch")
    assert sorted(got) == sorted(want) and "q_norm" in got
    for name in want:
        assert got[name] is not None, name
        scale = want[name].abs().max().item()
        assert scale > 0, name
        torch.testing.assert_close(got[name], want[name], rtol=1e-4,
                                   atol=1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("agg", ["trimmed_mean", "hierarchical_trim"])
def test_robust_train_step_through_the_kernels_matches_plain(cuda_device,
                                                             agg):
    """Two robust steps of reduced paper_sim (float32, head size 64) on
    the card, 2 pods x 3 workers, worker 4 Byzantine: K4 (one launch a
    step, or one per pod and one across pods) and K6 (every layer and
    worker) against the plain path; every copy equal."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.prng import fold_in, prng_key
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed.aggregation import AggregatorConfig
    from repro_torch.distributed.trainer import (TrainConfig,
                                                 make_train_step,
                                                 replicate_for_workers,
                                                 worker_opt_init)
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import leaves
    cfg = reduced(get_config("paper_sim"))
    assert cfg.head_dim == 64
    data = SyntheticLMData(cfg.vocab, 32, 6, flavour="markov", seed=0)
    out = {}
    for backend in ("auto", "torch"):
        tc = TrainConfig(arch=cfg, agg=AggregatorConfig(
            kind=agg, F=1, trim_backend=backend),
            opt=AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=2),
            byzantine_workers=(4,))
        pw = replicate_for_workers(M.init_params(0, cfg, cuda_device), 6)
        ow = worker_opt_init(pw)
        step = make_train_step(tc, (2, 3), backend=backend)
        k4, k6 = trimmed_mean_cuda.launches, swa_prefill_cuda.launches
        losses = []
        for s in range(2):
            pw, ow, loss = step(pw, ow, data.batch(s, cuda_device),
                                fold_in(prng_key(0), s))
            losses.append(float(loss))
        torch.cuda.synchronize()
        per_step = 1 if agg == "trimmed_mean" else 3
        on = backend == "auto"
        assert trimmed_mean_cuda.launches == k4 + 2 * per_step * on
        assert swa_prefill_cuda.launches == k6 + 2 * 6 * cfg.n_layers * on
        out[backend] = (losses, pw)
    np.testing.assert_allclose(out["auto"][0], out["torch"][0], rtol=1e-5)
    for a, b in zip(leaves(out["auto"][1]), leaves(out["torch"][1])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=5e-5)
        assert all(torch.equal(a[0], a[w]) for w in range(1, 6))


@pytest.mark.cuda
def test_train_cli_takes_48_workers_through_k4(cuda_device, capsys):
    """``launch.train --workers 48 --agg trimmed_mean`` on the card: one
    step of reduced (2-layer, float32) paper_sim through K4's 64-wide
    instantiation (one launch) and K6 (every layer and worker)."""
    from repro_torch.launch.train import main
    k4, k6 = trimmed_mean_cuda.launches, swa_prefill_cuda.launches
    main(["--arch", "paper_sim", "--reduced", "--steps", "1", "--seq-len",
          "32", "--global-batch", "48", "--agg", "trimmed_mean", "--trim-f",
          "2", "--workers", "48", "--byzantine", "1,7"])
    torch.cuda.synchronize()
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "done" and lines[0].startswith("step     0 loss ")
    assert np.isfinite(float(lines[0].split()[3]))
    assert trimmed_mean_cuda.launches == k4 + 1
    assert swa_prefill_cuda.launches == k6 + 48 * 2


# ---- Algorithm 1's engines through K1 at D = 5 ----

@pytest.mark.cuda
@pytest.mark.parametrize("F", [0, 1])
def test_hps_kernel_path_matches_plain(cuda_device, F):
    """run_hps through K1 (T launches, all on the edge-tiled kernel) against
    the plain path on the card: the gap curves and final ratios within
    1e-4 (the two paths add a receiver's increments in other orders)."""
    cfg = HPSConfig(make_hierarchy([6, 6, 6], "ring+", seed=1), 8, B=2,
                    drop_prob=0.3)
    w = np.random.default_rng(0).normal(size=(18, 4)).astype(np.float32)
    plan = ExecutionPlan(store="gap")
    before = edge_scatter_cuda.launches_tiled
    k = run_hps(w, cfg, 60, F=F, plan=plan, device=cuda_device)
    torch.cuda.synchronize()
    assert edge_scatter_cuda.launches_tiled == before + 60
    p = run_hps(w, cfg, 60, F=F, plan=plan.replace(backend="torch"),
                device=cuda_device)
    assert edge_scatter_cuda.launches_tiled == before + 60
    torch.testing.assert_close(k.gap, p.gap, rtol=0, atol=1e-4)
    torch.testing.assert_close(k.ratio, p.ratio, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_pushsum_engine_kernel_path_matches_plain(cuda_device):
    """run_pushsum_sparse through K1 against the plain path on the card,
    on pushsum_sweep's kind of graph: states within 1e-4 and the value
    and mass invariants held."""
    rng = np.random.default_rng(0)
    el = random_strongly_connected_edge_list(500, 2.0, rng)
    w = rng.normal(size=(500, 4)).astype(np.float32)
    before = edge_scatter_cuda.launches_tiled
    k, tk = run_pushsum_sparse(w, el.src, el.dst, 40, drop_prob=0.2, B=4,
                               record_every=8, device=cuda_device)
    torch.cuda.synchronize()
    assert edge_scatter_cuda.launches_tiled == before + 40
    p, tp = run_pushsum_sparse(w, el.src, el.dst, 40, drop_prob=0.2, B=4,
                               record_every=8, device=cuda_device,
                               plan=ExecutionPlan(backend="torch"))
    assert tk.shape == (5, 500, 4)
    torch.testing.assert_close(k.zm, p.zm, rtol=0, atol=1e-4)
    inv = sparse_mass_invariant(k, torch.from_numpy(el.src).to(cuda_device),
                                torch.ones(el.E, dtype=torch.bool,
                                           device=cuda_device)).cpu()
    np.testing.assert_allclose(inv[:-1].numpy(), w.sum(axis=0), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(inv[-1].item(), 500, rtol=1e-5)


# ---- scenario grids: K scenarios as one block-diagonal graph ----

@pytest.mark.cuda
def test_k1_on_a_block_diagonal_graph_equals_each_block(cuda_device):
    """K1 over K stacked graphs gives each block's rho_new and recv bit for
    bit as over that block alone (each receiver's run in edge order)."""
    from repro_torch.core.hps import make_hps_runtime
    cfgs = [HPSConfig(make_hierarchy(s, "ring+", seed=i), 4)
            for i, s in enumerate(([6, 6, 6], [9, 9], [3] * 6))]
    e_max = max(int(np.count_nonzero(c.topo.adj)) for c in cfgs)
    rts = [make_hps_runtime(c, e_max=e_max).to(cuda_device) for c in cfgs]
    st = stack_runtimes(rts)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    sigma = torch.randn((54, 5), generator=g, device=cuda_device)
    rho = torch.randn((3 * e_max, 5), generator=g, device=cuda_device)
    live = (torch.rand(3 * e_max, generator=g, device=cuda_device) < 0.6
            ) & st.valid
    rho_b, recv_b = edge_scatter_cuda(sigma, rho, live, st.src, st.offsets)
    for k, rt in enumerate(rts):
        n, e = slice(18 * k, 18 * (k + 1)), slice(e_max * k, e_max * (k + 1))
        rho_1, recv_1 = edge_scatter_cuda(sigma[n].contiguous(),
                                          rho[e].contiguous(),
                                          live[e].contiguous(), rt.src,
                                          rt.offsets)
        assert torch.equal(rho_b[e], rho_1) and torch.equal(recv_b[n], recv_1)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["hps", "social", "pushsum"])
def test_grid_rows_equal_single_runs_on_the_card(cuda_device, engine):
    """A grid of 8 scenarios through K1 (and K2) on the card, one launch a
    round for all of them; each row against the single run of its
    scenario on the card within the limits tests/test_torch_sweeps.py
    states for the reference (the fusion pool reduces (K, N, d+1) where
    the single run reduces (N, d+1), which the card may order
    otherwise)."""
    topo = make_hierarchy([6, 6, 6], "ring+", seed=1)
    cfgs = [HPSConfig(topo, gamma_period=g, B=2, drop_prob=d)
            for d in (0.0, 0.4) for g in (3, 8)]
    T = 40
    k1, k2 = edge_scatter_cuda.launches_tiled, innovation_cuda.launches
    if engine == "hps":
        w = np.random.default_rng(0).normal(size=(18, 4)).astype(np.float32)
        res = run_hps_grid(w, cfgs, T, [0, 5], device=cuda_device)
    elif engine == "social":
        model = make_confused_model(N=18, m=3, truth=1, confusion=0.3, seed=0)
        res = run_social_grid(model, cfgs, T, [0, 5], device=cuda_device)
    else:
        rng = np.random.default_rng(0)
        draws = [random_strongly_connected_edge_list(200, 2.0, rng)
                 for _ in range(2)]
        w = rng.normal(size=(200, 4)).astype(np.float32)
        el = sort_by_dst(stack_edge_lists([d.to_dense() for d in draws]))[0]
        res = run_pushsum_sweep(w, el, T, drop_probs=[0.0, 0.4],
                                seeds=[0, 5], device=cuda_device)
    torch.cuda.synchronize()
    assert edge_scatter_cuda.launches_tiled == k1 + T
    assert innovation_cuda.launches == k2 + T * (engine == "social")
    for k in range(res.K):
        seed = int(res.seed[k])
        if engine == "pushsum":
            g = int(res.graph[k])
            _, traj = run_pushsum_sparse(
                w, el.src[g], el.dst[g], T, drop_prob=float(res.drop_prob[k]),
                B=4, key=prng_key(seed), valid=el.valid[g],
                device=cuda_device)
            torch.testing.assert_close(res.final_ratio[k], traj[-1],
                                       rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(
                res.err[k], (traj - torch.from_numpy(w).to(cuda_device)
                             .mean(0)).abs().amax(dim=(1, 2)),
                rtol=1e-4, atol=1e-5)
            continue
        cfg = cfgs[int(res.cfg[k])]
        if engine == "hps":
            one = run_hps(w, cfg, T, seed=seed, device=cuda_device,
                          plan=ExecutionPlan(store="gap"))
            torch.testing.assert_close(res.ratio[k], one.ratio, rtol=1e-4,
                                       atol=1e-5)
            torch.testing.assert_close(res.gap[k], one.gap, rtol=1e-4,
                                       atol=1e-5)
        else:
            one = run_social_learning(model, cfg, T, seed=seed,
                                      signal_seed=seed, device=cuda_device,
                                      plan=ExecutionPlan(store="log_ratio"))
            torch.testing.assert_close(res.beliefs[k], one.beliefs, rtol=0,
                                       atol=1e-3)
            torch.testing.assert_close(res.log_ratio[k], one.log_ratio,
                                       rtol=1e-3, atol=1e-2)
            assert torch.equal(res.beliefs[k].argmax(-1),
                               one.beliefs.argmax(-1))


# ---------------------------------------------------------------------------
# The fault and async planes on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", K1_CASES)
@pytest.mark.parametrize("D", [4, 5])
def test_edge_scatter_kernel_with_per_edge_source_rows(cuda_device, case, D):
    """The async delivery route: K1 with the (E, D) snapshot as its source
    rows and the identity source index, the receiver count from the
    offsets; rho_new bit-equal to the plain version and recv to the
    float32 edge-order sum."""
    _, rho, live, _, dst = edge_problem(case, seed=D, D=D)
    n, E = 23, rho.shape[0]
    snap = np.random.default_rng(D).normal(size=(E, D)).astype(np.float32)
    ident = np.arange(E, dtype=np.int32)
    offsets = np.searchsorted(dst, np.arange(n + 1)).astype(np.int32)
    before = edge_scatter_cuda.launches_tiled
    rho_new, recv = edge_scatter_cuda(*[
        torch.from_numpy(a).to(cuda_device)
        for a in (snap, rho, live, ident, offsets)])
    torch.cuda.synchronize()
    assert edge_scatter_cuda.launches_tiled == before + 1
    assert recv.shape == (n, D)
    ref = edge_scatter_ref(*map(torch.from_numpy, (snap, rho, live, ident,
                                                   dst)), n_recv=n)
    assert torch.equal(rho_new.cpu(), ref[0])
    np.testing.assert_array_equal(
        recv.cpu().numpy(), edge_order_recv(ref[0].numpy(), rho, dst, n))
    got = edge_scatter(*[torch.from_numpy(a).to(cuda_device)
                         for a in (snap, rho, live, ident, dst)], n_recv=n)
    assert torch.equal(got[1], recv)


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRIM_CASES)
@pytest.mark.parametrize("F", [1, 2])
def test_trim_gather_kernel_under_a_fault_masked_valid(cuda_device, case, F):
    """K3 with a round's fault-masked slot validity (dropped slots and
    dead senders and receivers off): tsum bit-equal to the rank-order sum,
    kept to the plain version."""
    r, idx, valid, msgs, byz_nbr = trim_problem(case, 9, F, seed=F + 30)
    rng = np.random.default_rng(F)
    live = rng.random(r.shape[0]) < 0.8
    masked = valid & (rng.random(valid.shape) >= 0.3) & live[idx] \
        & live[:, None]
    prob = (r, idx, masked, msgs, byz_nbr)
    tsum, kept = trim_gather(*[torch.from_numpy(a).to(cuda_device)
                               for a in prob], F)
    want = trim_rank_order_sum(*prob, F)
    tsum = tsum.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(tsum), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(tsum.view(np.int32)[ok],
                                  want.view(np.int32)[ok])
    np.testing.assert_array_equal(
        kept.cpu().numpy(),
        trim_gather_ref(*map(torch.from_numpy, prob), F)[1].numpy())


def _plane_runs(engine, plan):
    """One engine on the card under ``plan`` -> its outputs."""
    topo = make_hierarchy([6, 6, 6], topology="complete", seed=0)
    if engine == "pushsum":
        el = sort_by_dst(random_strongly_connected_edge_list(
            64, 2.0, np.random.default_rng(0)))[0]
        w = np.random.default_rng(1).normal(size=(64, 4)).astype(np.float32)
        st, traj = run_pushsum_sparse(w, el.src, el.dst, 40, drop_prob=0.2,
                                      B=4, record_every=10, plan=plan)
        return (*st, traj)
    if engine == "hps":
        w = np.random.default_rng(2).normal(size=(18, 4)).astype(np.float32)
        res = run_hps(w, HPSConfig(topo, 4, B=2, drop_prob=0.2), 40,
                      plan=plan.replace(store="gap"))
        return (res.ratio, res.gap, *res.final_state)
    model = make_confused_model(N=18, m=3, truth=1, confusion=0.3, seed=0)
    if engine == "social":
        res = run_social_learning(model, HPSConfig(topo, 4, B=2,
                                                   drop_prob=0.3), 40,
                                  plan=plan.replace(store="log_ratio"))
        return (res.beliefs, res.log_ratio, *res.final_state)
    bmodel, cfg, _ = byzantine_oracle_scenario("large_value")
    res = run_byzantine_learning(bmodel, cfg, 40,
                                 plan=plan.replace(store="final"))
    return tuple(res)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["pushsum", "hps", "social", "byzantine"])
def test_degenerate_planes_are_bit_identical_on_the_card(cuda_device,
                                                         engine):
    """The degenerate fault model (and, but for Alg. 2, the degenerate
    async model) through the kernels equal the plane-free run bit for bit;
    a real model launches the engine's kernels once a round."""
    from repro_torch.core.asyncrony import make_async_model
    from repro_torch.core.faults import make_fault_model
    base = _plane_runs(engine, ExecutionPlan())
    plans = [ExecutionPlan(faults=make_fault_model())]
    if engine != "byzantine":
        plans.append(ExecutionPlan(async_=make_async_model()))
    for plan in plans:
        got = _plane_runs(engine, plan)
        assert all(torch.equal(a, b) for a, b in zip(base, got)), plan
    counter = trim_gather_cuda if engine == "byzantine" else edge_scatter_cuda
    before = counter.launches, innovation_cuda.launches
    severe = make_fault_model(p_gb=0.125, p_bg=0.125, leave_prob=0.1,
                              join_prob=0.25, ps_crash_prob=0.5)
    out = _plane_runs(engine, ExecutionPlan(
        faults=severe, async_=None if engine == "byzantine"
        else make_async_model(0.6, 8)))
    torch.cuda.synchronize()
    assert counter.launches == before[0] + 40
    assert innovation_cuda.launches == before[1] + 40 * (engine == "social")
    assert all(torch.isfinite(x).all() for x in out if x.is_floating_point())


# ---------------------------------------------------------------------------
# The precision policy: K1-K3 on half storage (bf16 and fp16), the engines
# under policy bf16
# ---------------------------------------------------------------------------

HALF_STORAGE = {"bf16": torch.bfloat16, "fp16": torch.float16}


def _half(a, st):
    """A numpy float32 array rounded to ``st`` -> (the CPU tensor in
    ``st``, its values upcast to float32 as numpy)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(st)
    return t, t.float().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("st", sorted(HALF_STORAGE))
@pytest.mark.parametrize("case", K1_CASES)
@pytest.mark.parametrize("D,tiled", [(4, None), (4, False), (5, None),
                                     (40, None)])
def test_edge_scatter_half_kernels_give_the_edge_order_sum(cuda_device, st,
                                                           case, D, tiled):
    """Half storage on both kernels (the tiled kernel's 8-byte vector path
    at D = 4, its scalar path at D = 5, the column walk at D = 40 and as
    asked for): rho_new bit-equal to the plain version's, recv float32 and
    bit-equal to the float32 edge-order sum of the upcast differences; one
    launch, counted as a half-storage one."""
    sigma, rho, live, src, dst = edge_problem(case, D=D)
    n = sigma.shape[0]
    offsets = np.searchsorted(dst, np.arange(n + 1)).astype(np.int32)
    (sig_h, _), (rho_h, rho_f) = (_half(a, HALF_STORAGE[st])
                                  for a in (sigma, rho))
    dev_args = [sig_h.to(cuda_device), rho_h.to(cuda_device)] + [
        torch.from_numpy(a).to(cuda_device) for a in (live, src, offsets)]
    before = edge_scatter_cuda.launches_half
    rho_new, recv = edge_scatter_cuda(*dev_args, tiled=tiled)
    torch.cuda.synchronize()
    assert edge_scatter_cuda.launches_half == before + 1
    assert rho_new.dtype == HALF_STORAGE[st] and recv.dtype == torch.float32
    ref = edge_scatter_ref(sig_h, rho_h, *map(torch.from_numpy, (live, src,
                                                                 dst)),
                           accum_dtype=torch.float32)
    assert torch.equal(rho_new.cpu(), ref[0])
    np.testing.assert_array_equal(
        recv.cpu().numpy(),
        edge_order_recv(ref[0].float().numpy(), rho_f, dst, n))


@pytest.mark.cuda
@pytest.mark.parametrize("st", sorted(HALF_STORAGE))
def test_edge_scatter_half_identity_route_and_unaligned_rows(cuda_device,
                                                              st):
    """The async delivery's per-edge source rows (identity index) on half
    storage, and half rows two bytes off the 8-byte vector (the scalar
    path): the same results as the plain version and the edge-order sum."""
    dt = HALF_STORAGE[st]
    sigma, rho, live, src, dst = edge_problem("ragged", D=4)
    n, E = sigma.shape[0], rho.shape[0]
    offsets = np.searchsorted(dst, np.arange(n + 1)).astype(np.int32)
    snap = np.random.default_rng(4).normal(size=(E, 4)).astype(np.float32)
    ident = np.arange(E, dtype=np.int32)
    for rows, index in ((snap, ident), (sigma, src)):
        (rows_h, _), (rho_h, rho_f) = (_half(a, dt) for a in (rows, rho))

        def shifted(t):
            buf = torch.zeros(t.numel() + 1, dtype=dt, device=cuda_device)
            buf[1:] = t.reshape(-1).to(cuda_device)
            return buf[1:].view(t.shape)

        for shift in (False, True):
            put = shifted if shift else (lambda t: t.to(cuda_device))
            args = [put(rows_h), put(rho_h)] + [
                torch.from_numpy(a).to(cuda_device)
                for a in (live, index, offsets)]
            rho_new, recv = edge_scatter_cuda(*args)
            ref = edge_scatter_ref(rows_h, rho_h, torch.from_numpy(live),
                                   torch.from_numpy(index),
                                   torch.from_numpy(dst), n_recv=n,
                                   accum_dtype=torch.float32)
            torch.cuda.synchronize()
            assert torch.equal(rho_new.cpu(), ref[0])
            np.testing.assert_array_equal(
                recv.cpu().numpy(),
                edge_order_recv(ref[0].float().numpy(), rho_f, dst, n))


@pytest.mark.cuda
def test_half_storage_routes_raise_on_what_they_do_not_take(cuda_device):
    """A half input on the CUDA route needs a float32 accumulation, and
    sigma and rho of different dtypes raise: nothing reroutes to the plain
    version."""
    sigma, rho, live, src, dst = [torch.from_numpy(a).to(cuda_device)
                                  for a in edge_problem("ragged")]
    h = torch.bfloat16
    with pytest.raises(ValueError, match="float32"):
        edge_scatter(sigma.to(h), rho.to(h), live, src, dst, backend="cuda")
    with pytest.raises(ValueError, match="dtype"):
        edge_scatter(sigma.to(h), rho, live, src, dst, backend="cuda",
                     accum_dtype=torch.float32)
    z, mass, u, cdf, lt = [torch.from_numpy(a).to(cuda_device)
                           for a in innov_problem(29, 3, 4, 0)]
    with pytest.raises(ValueError, match="float32"):
        innovation_step(z.to(h), mass.to(h), u, cdf, lt, backend="cuda")
    with pytest.raises(ValueError, match="dtype"):
        innovation_step(z.to(h), mass, u, cdf, lt, backend="cuda",
                        accum_dtype=torch.float32)
    r, idx, valid, msgs, byz = [torch.from_numpy(a).to(cuda_device)
                                for a in trim_problem("random", 9, 1)]
    with pytest.raises(ValueError, match="float32"):
        trim_gather(r.to(h), idx, valid, msgs.to(h), byz, 1, "cuda")
    with pytest.raises(ValueError, match="byz_msgs"):
        trim_gather(r.to(h), idx, valid, msgs, byz, 1, "cuda",
                    accum_dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("st", sorted(HALF_STORAGE))
@pytest.mark.parametrize("N,m,S,edge", K2_CASES)
def test_innovation_half_kernel_matches_plain(cuda_device, st, N, m, S,
                                              edge):
    """Half z and mass (the staging moves their byte ranges): z_new at
    storage bit-equal to the plain version's (the float32 sum rounded
    once), mu float32 within the softmax's order."""
    z, mass, u, cdf, lt = innov_problem(N, m, S, N, edge)
    (z_h, _), (m_h, _) = (_half(a, HALF_STORAGE[st]) for a in (z, mass))
    rest = [torch.from_numpy(a) for a in (u, cdf, lt)]
    before = innovation_cuda.launches_half
    z_k, mu_k = innovation_step(z_h.to(cuda_device), m_h.to(cuda_device),
                                *[a.to(cuda_device) for a in rest],
                                accum_dtype=torch.float32)
    torch.cuda.synchronize()
    assert innovation_cuda.launches_half == before + 1
    z_r, mu_r = innovation_ref(z_h, m_h, *rest, accum_dtype=torch.float32)
    assert z_k.dtype == HALF_STORAGE[st] and mu_k.dtype == torch.float32
    assert torch.equal(z_k.cpu(), z_r)
    torch.testing.assert_close(mu_k.cpu(), mu_r, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("st", sorted(HALF_STORAGE))
def test_innovation_half_kernel_reads_unaligned_ranges(cuda_device, st):
    """Half z and mass starting 2 bytes off 16: ragged ends in every
    block."""
    dt = HALF_STORAGE[st]
    z, mass, u, cdf, lt = innov_problem(1001, 3, 4, 3)
    (z_h, _), (m_h, _) = (_half(a, dt) for a in (z, mass))

    def shifted(t):
        buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=cuda_device)
        buf[1:] = t.reshape(-1).to(cuda_device)
        return buf[1:].view(t.shape)

    rest = [torch.from_numpy(a) for a in (u, cdf, lt)]
    z_k, mu_k = innovation_cuda(shifted(z_h), shifted(m_h),
                                *[shifted(a) for a in rest])
    z_r, mu_r = innovation_ref(z_h, m_h, *rest, accum_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(z_k.cpu(), z_r)
    torch.testing.assert_close(mu_k.cpu(), mu_r, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("st", sorted(HALF_STORAGE))
@pytest.mark.parametrize("case", TRIM_CASES + K3_CASES)
@pytest.mark.parametrize("F", [0, 2, "per_receiver"])
def test_trim_gather_half_kernel_gives_the_rank_order_sum(cuda_device, st,
                                                          case, F):
    """Half r and lies (a lie past fp16's range becomes inf): kept
    bit-equal to the plain version's, tsum float32 and bit-equal to the
    float32 rank-order sum of the upcast values, for an int F and F per
    receiver."""
    dt = HALF_STORAGE[st]
    r, idx, valid, msgs, byz = trim_problem(case, 9, 2, seed=5)
    n, dm = idx.shape
    FF = mixed_trim_counts(n, dm, dm) if F == "per_receiver" else F
    (r_h, r_f), (m_h, m_f) = (_half(a, dt) for a in (r, msgs))
    rest = [torch.from_numpy(a) for a in (idx, valid)]
    Ft = torch.from_numpy(FF) if F == "per_receiver" else FF
    before = trim_gather_cuda.launches_half
    tsum, kept = trim_gather(
        r_h.to(cuda_device), *[a.to(cuda_device) for a in rest],
        m_h.to(cuda_device), torch.from_numpy(byz).to(cuda_device),
        Ft.to(cuda_device) if F == "per_receiver" else Ft,
        accum_dtype=torch.float32)
    torch.cuda.synchronize()
    assert trim_gather_cuda.launches_half == before + 1
    assert tsum.dtype == kept.dtype == torch.float32
    want = trim_rank_order_sum(r_f, idx, valid, m_f, byz, FF)
    got = tsum.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got.view(np.int32)[~np.isnan(want)],
                                  want.view(np.int32)[~np.isnan(want)])
    k_ref = trim_gather_ref(r_h, *rest, m_h, torch.from_numpy(byz), Ft,
                            accum_dtype=torch.float32)[1]
    assert torch.equal(kept.cpu(), k_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("st", sorted(HALF_STORAGE))
def test_trim_gather_half_kernel_reads_broadcast_lies(cuda_device, st):
    dt = HALF_STORAGE[st]
    r, idx, valid, msgs, byz = (torch.from_numpy(a).to(cuda_device)
                                for a in trim_problem("random", 9, 1))
    lie = torch.full((), 500.0, dtype=dt, device=cuda_device).expand(
        msgs.shape)
    got = trim_gather_cuda(r.to(dt), idx, valid, lie, byz, 1)
    want = trim_gather_cuda(r.to(dt), idx, valid, lie.contiguous(), byz, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["pushsum", "hps", "social", "byzantine"])
def test_policy_on_the_card(cuda_device, engine):
    """``policy="fp32"`` through the kernels is the pre-policy program bit
    for bit; ``policy="bf16"`` launches the engine's kernels once a round
    on half storage, and its kernel path agrees with its plain path on the
    card: the same decisions (Alg. 3 where the top two beliefs are more
    than 2e-2 apart; Alg. 2 on the normal agents), and the ratios of the
    consensus engines within 4 bf16 ulps of the input spread (the two
    paths order the receiver sums and the fusion pools differently, which
    flips a bf16 rounding now and then)."""
    base = _plane_runs(engine, ExecutionPlan())
    fp32 = _plane_runs(engine, ExecutionPlan(policy="fp32"))
    assert all(torch.equal(a, b) for a, b in zip(base, fp32))
    counters = ([trim_gather_cuda] if engine == "byzantine"
                else [edge_scatter_cuda]
                + ([innovation_cuda] if engine == "social" else []))
    before = [c.launches_half for c in counters]
    got = _plane_runs(engine, ExecutionPlan(policy="bf16"))
    torch.cuda.synchronize()
    assert [c.launches_half for c in counters] == [b + 40 for b in before]
    plain = _plane_runs(engine, ExecutionPlan(policy="bf16",
                                              backend="torch"))
    assert all(torch.isfinite(x.float()).all() for x in got
               if x.is_floating_point())
    if engine == "social":
        bk, bp = got[0], plain[0]
        top2 = bp.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2e-2
        assert torch.equal(bk.argmax(-1)[clear], bp.argmax(-1)[clear])
    elif engine == "byzantine":
        eye = torch.eye(3, dtype=torch.bool, device=cuda_device)
        worst = torch.where(eye, torch.inf, plain[0]).min(dim=-1).values
        top2 = worst.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 16.0
        assert torch.equal(got[1][clear], plain[1][clear])
    else:
        # _plane_runs' inputs: normal draws of seed 1 (push-sum, 64 x 4)
        # and 2 (HPS, 18 x 4)
        w = np.random.default_rng(1 if engine == "pushsum" else 2).normal(
            size=(64 if engine == "pushsum" else 18, 4))
        at = -1 if engine == "pushsum" else 0
        torch.testing.assert_close(got[at], plain[at], rtol=0,
                                   atol=4 * 2.0 ** -8 * float(np.ptp(w)))
