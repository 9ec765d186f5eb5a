"""The plain versions of the WKV6 scan (``repro_torch.kernels.wkv6``) against
the JAX package on the CPU: the sequential scan, the chunked form and the
decode step against ``repro.kernels.wkv6.ref``, the chunked form against
the TPU kernel ``wkv6_chunked_pallas`` (interpret mode), and the route
dispatch against ``repro.kernels.wkv6.ops.wkv6``. The CUDA kernel K7 is
held against these plain versions on the card
(``tests/test_torch_kernels_cuda.py``).

Tolerances (float32 unless stated; outputs of size up to ~80). The
sequential scan and the decode step against their JAX twins add the same
terms in another order: atol = rtol = 2e-5. Anything that involves the
chunked form gets ``tests/test_kernels.py``'s limit for the TPU kernel
against the scan, 1e-3 for chunks up to 64 (2e-3 at 128): its decay
weights are exponentials of differences of in-chunk cumsums, which carry
a few ulp of |P| (P reaches ~100 here) and differ with the cumsum's order
(a float64 scan puts both packages' chunked forms ~2e-4 - 4e-4 off, the
scans ~2e-5). At lw = -e^4 |P| reaches ~3,500, whose ulp is 2.4e-4, so
each decay weight is off by up to that much relative in both packages
(both are 4.2e-3 off a float64 scan): rtol 5e-4 + atol 5e-3 there.
bfloat16 inputs: y is rounded to bfloat16 once on both sides, one bf16
ulp (rtol 2^-7) + the chunked atol; the float32 state to the chunked
limit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import ops as jax_ops
from repro.kernels.wkv6.ref import wkv6_chunked_jnp
from repro.kernels.wkv6.ref import wkv6_decode_step as jax_decode_step
from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.kernels.wkv6.wkv6 import wkv6_chunked_pallas
from repro_torch.kernels.wkv6 import (wkv6, wkv6_chunked_ref, wkv6_cuda,
                                      wkv6_decode_step, wkv6_ref)
from repro_torch.kernels.wkv6.ops import _plain_chunk

SAME_FORM = 2e-5


def chunk_tol(C):
    return 1e-3 * max(C // 64, 1)


SHAPES = [(2, 64, 32, 32, 16), (3, 128, 64, 64, 64), (1, 96, 16, 48, 32)]


def wkv_problem(BH, T, K, V, seed=0, lw=None):
    """(r, k, v, lw, u) float32 numpy arrays; ``lw`` a constant log-decay
    or, by default, ``-exp(normal)`` as ``tests/test_kernels.py`` draws
    it."""
    rng = np.random.default_rng(seed)
    r, k = (rng.normal(size=(BH, T, K)).astype(np.float32) for _ in "rk")
    v = rng.normal(size=(BH, T, V)).astype(np.float32)
    if lw is None:
        lwa = -np.exp(rng.normal(size=(BH, T, K))).astype(np.float32)
    else:
        lwa = np.full((BH, T, K), lw, np.float32)
    u = rng.normal(size=(BH, K)).astype(np.float32)
    return r, k, v, lwa, u


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("BH,T,K,V,C", SHAPES)
def test_sequential_scan_matches_jax(BH, T, K, V, C):
    p = wkv_problem(BH, T, K, V)
    y, s = wkv6_ref(*_t(p))
    y_j, s_j = jax_wkv6_ref(*_j(p))
    _close(y.numpy(), y_j, SAME_FORM)
    _close(s.numpy(), s_j, SAME_FORM)


@pytest.mark.parametrize("BH,T,K,V,C", SHAPES)
def test_chunked_form_matches_jax(BH, T, K, V, C):
    """Against ``wkv6_chunked_jnp`` at the same chunk (and with a start
    state), and against the sequential scan."""
    p = wkv_problem(BH, T, K, V, seed=1)
    s0 = np.random.default_rng(2).normal(size=(BH, K, V)).astype(np.float32)
    y, s = wkv6_chunked_ref(*_t(p), chunk=C, s0=torch.from_numpy(s0))
    y_j, s_j = wkv6_chunked_jnp(*_j(p), chunk=C, s0=jnp.asarray(s0))
    _close(y.numpy(), y_j, chunk_tol(C))
    _close(s.numpy(), s_j, chunk_tol(C))
    y_seq, s_seq = jax_wkv6_ref(*_j(p), s0=jnp.asarray(s0))
    _close(y.numpy(), y_seq, chunk_tol(C))
    _close(s.numpy(), s_seq, chunk_tol(C))


def test_chunked_form_matches_the_tpu_kernel_interpreted():
    BH, T, K, V, C = SHAPES[1]
    p = wkv_problem(BH, T, K, V, seed=3)
    y, s = wkv6_chunked_ref(*_t(p), chunk=C)
    y_j, s_j = wkv6_chunked_pallas(*_j(p), chunk=C, interpret=True)
    _close(y.numpy(), y_j, chunk_tol(C))
    _close(s.numpy(), s_j, chunk_tol(C))


def test_decode_steps_match_jax_and_the_scan():
    BH, T, K, V = 2, 16, 16, 16
    r, k, v, lw, u = wkv_problem(BH, T, K, V, seed=4)
    s_t = torch.zeros((BH, K, V))
    s_j = jnp.zeros((BH, K, V))
    ys = []
    for t in range(T):
        args = (r[:, t], k[:, t], v[:, t], lw[:, t], u)
        y_t, s_t = wkv6_decode_step(*_t(args), s_t)
        y_j, s_j = jax_decode_step(*_j(args), s_j)
        _close(y_t.numpy(), y_j, SAME_FORM)
        _close(s_t.numpy(), s_j, SAME_FORM)
        ys.append(y_t)
    y_seq, s_seq = wkv6_ref(*_t((r, k, v, lw, u)))
    _close(torch.stack(ys, 1).numpy(), y_seq.numpy(), SAME_FORM)
    _close(s_t.numpy(), s_seq.numpy(), SAME_FORM)


@pytest.mark.parametrize("T,chunk,want", [
    (17, None, 1), (100, None, 4), (96, None, 32), (128, None, 64),
    (2048, None, 64), (4096, None, 128), (100, 50, 50), (64, 16, 16)])
def test_dispatch_takes_the_reference_chunk(T, chunk, want):
    """The reference's off-TPU choice: chunk max(64, T // 32) halved until
    it divides T; the sequential scan below 16 (T = 17 and 100 here). The
    route gives exactly that plain function's result, and matches the
    JAX package's dispatcher."""
    assert _plain_chunk(T, chunk) == want
    p = wkv_problem(2, T, 16, 16, seed=T)
    y, s = wkv6(*_t(p), chunk=chunk)
    if want >= 16:
        y_w, s_w = wkv6_chunked_ref(*_t(p), chunk=want)
    else:
        y_w, s_w = wkv6_ref(*_t(p))
    assert torch.equal(y, y_w) and torch.equal(s, s_w)
    y_j, s_j = jax_ops.wkv6(*_j(p), chunk=chunk, backend="xla")
    tol = chunk_tol(want) if want >= 16 else SAME_FORM
    _close(y.numpy(), y_j, tol)
    _close(s.numpy(), s_j, tol)


@pytest.mark.parametrize("T", [1, 63, 65, 100])
def test_ragged_last_chunk_matches_the_scan(T):
    """The port's chunked form also takes T not a multiple of the chunk
    (its last chunk is short), as K7 does; the JAX chunked form asserts
    T % chunk == 0, so it is held to the JAX sequential scan."""
    p = wkv_problem(2, T, 64, 64, seed=5)
    y, s = wkv6_chunked_ref(*_t(p), chunk=64)
    y_j, s_j = jax_wkv6_ref(*_j(p))
    assert y.shape == (2, T, 64)
    _close(y.numpy(), y_j, chunk_tol(64))
    _close(s.numpy(), s_j, chunk_tol(64))


@pytest.mark.parametrize("lw", [-8.0, -float(np.exp(4.0)),
                                -float(np.exp(-8.0))])
def test_decay_at_the_clip_ends_stays_finite(lw):
    """lw = -e^4 (the model's strongest decay) drives the in-chunk cumsum
    to about -3,500: a factored exp(E_i) exp(-P_j) would overflow to
    inf * 0 = NaN. lw = -8 as in the reference's property test; lw = -e^-8
    (the weakest decay) lets the state grow over the sequence."""
    p = wkv_problem(2, 128, 64, 64, seed=6, lw=lw)
    y, s = wkv6_chunked_ref(*_t(p), chunk=64)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    y_j, s_j = jax_wkv6_ref(*_j(p))
    y_c, s_c = wkv6_chunked_jnp(*_j(p), chunk=64)
    rtol, atol = (5e-4, 5e-3) if lw < -50 else (chunk_tol(64),) * 2
    for want_y, want_s in ((y_j, s_j), (y_c, s_c)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=rtol,
                                   atol=atol)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=rtol,
                                   atol=atol)


def test_bfloat16_inputs():
    BH, T, K, V = 2, 128, 64, 64
    r, k, v, lw, u = wkv_problem(BH, T, K, V, seed=7)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (r, k, v)]
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (r, k, v)]
    y, s = wkv6_chunked_ref(*tb, *_t((lw, u)), chunk=64)
    y_j, s_j = wkv6_chunked_jnp(*jb, *_j((lw, u)), chunk=64)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(y_j.astype(jnp.float32)),
                               rtol=2 ** -7, atol=chunk_tol(64))
    _close(s.numpy(), s_j, chunk_tol(64))
    y_d, _ = wkv6_decode_step(*(t[:, 0] for t in tb),
                              torch.from_numpy(lw[:, 0]),
                              torch.from_numpy(u), torch.zeros((BH, K, V)))
    assert y_d.dtype == torch.bfloat16


def test_head_layout_views_give_the_flat_result():
    """(B, H, T, K) views (the model's transposed projections, u a
    broadcast) give the (BH, T, K) result, reshaped."""
    B, H, T, K = 2, 3, 64, 16
    r, k, v, lw, _ = wkv_problem(B * H, T, K, K, seed=8)
    u = np.random.default_rng(9).normal(size=(H, K)).astype(np.float32)

    def heads(a):
        return torch.from_numpy(a).view(B, H, T, K).transpose(1, 2) \
            .contiguous().transpose(1, 2)

    uh = torch.from_numpy(u).expand(B, H, K)
    y4, s4 = wkv6(heads(r), heads(k), heads(v), heads(lw), uh)
    y3, s3 = wkv6(*_t((r, k, v, lw)), uh.reshape(B * H, K))
    assert y4.shape == (B, H, T, K) and s4.shape == (B, H, K, K)
    assert torch.equal(y4.reshape(B * H, T, K), y3)
    assert torch.equal(s4.reshape(B * H, K, K), s3)


def test_cpu_tensors_never_reach_the_kernel():
    p = _t(wkv_problem(1, 8, 64, 64))
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_cuda(*p)
    with pytest.raises(ValueError, match="cuda"):
        wkv6(*p, backend="cuda")
    # the plain route keeps autograd (K7's backward comes with training)
    r = p[0].clone().requires_grad_()
    y, _ = wkv6(r, *p[1:])
    y.sum().backward()
    assert r.grad is not None and bool(torch.isfinite(r.grad).all())


def test_jax_stays_on_the_cpu():
    assert jax.default_backend() == "cpu"
