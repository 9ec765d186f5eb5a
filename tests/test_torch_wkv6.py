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
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

from repro.kernels.wkv6 import ops as jax_ops
from repro.kernels.wkv6.ref import wkv6_chunked_jnp
from repro.kernels.wkv6.ref import wkv6_decode_step as jax_decode_step
from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.kernels.wkv6.wkv6 import wkv6_chunked_pallas
from repro_torch.kernels.wkv6 import (wkv6, wkv6_chunked_ref, wkv6_cuda,
                                      wkv6_decode_step, wkv6_ref)
from repro_torch.kernels.wkv6.ops import _plain_chunk, group_chunks

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


# K7's arithmetic (csrc/wkv6.cu), emulated in float32 on the CPU: three
# passes over groups of G chunks (each group's own state from zero and its
# decay, a scan over the groups, each group's outputs from its start
# state); the intra-chunk decay factored per 16-row sub-chunk through the
# anchor a = i0 - 1 with both exponents <= 0, and only the diagonal 16 x 16
# sub-blocks formed pairwise, the bonus (r_i . u . k_i) on the scores'
# diagonal, so scores @ v adds it; every product on bf16 operands with float32
# sums, a float32 operand split into bf16 parts (hi + lo for bf16 inputs;
# hi + mid + lo for float32 ones) and the product taken over the part pairs
# (i, j) with i + j < parts (hi.hi + hi.lo + lo.hi for two). The card holds
# the kernel within chip_smoke.py phase 12's limits: |got - want| <= (tol +
# y_rtol) |want| + tol max|want|, tol = 1e-4 (5e-4 at lw = -e^4), y_rtol =
# 2^-7 for a bf16 y (its own rounding), 0 for float32 and for the state;
# and within tests/test_torch_kernels_cuda.py's, which for float32 at the
# weakest decay takes the third part. With every operand rounded once to
# bf16 the same emulation exceeds phase 12's limit.
K7_TOL, K7_TOL_STRONG = 1e-4, 5e-4
STRONG, WEAK = -float(np.exp(4.0)), -float(np.exp(-8.0))
SUB = 16


def _bf(x):
    return x.to(torch.bfloat16).float()


def _split(x, parts):
    """x as ``parts`` bf16 parts, each the rounding of what the parts
    before it leave."""
    out = []
    for _ in range(parts):
        out.append(_bf(x))
        x = x - out[-1]
    return out


def _mm(a, b, parts):
    """a @ b on bf16 tensor-core operands: the products of the part pairs
    (i, j) with i + j < parts, the smallest first (an operand exact in
    bf16 has one nonzero part; ``parts = 1`` rounds each once)."""
    A, B = _split(a, parts), _split(b, parts)
    out = 0.0
    for s in range(parts - 1, -1, -1):
        for i in range(max(0, s - parts + 1), min(s, parts - 1) + 1):
            out = out + A[i] @ B[s - i]
    return out


def _chunk_decay(lwc):
    """P (inclusive, in row order) and E (exclusive: E_i = P_{i-1})."""
    P = torch.cumsum(lwc, dim=1)
    E = torch.cat([torch.zeros_like(P[:, :1]), P[:, :-1]], dim=1)
    return P, E


def _state_update(S, kc, vc, P, parts):
    p_last = P[:, -1]
    k_dec = kc * torch.exp(p_last[:, None, :] - P)
    return (torch.exp(p_last)[:, :, None] * S
            + _mm(k_dec.transpose(1, 2), vc, parts))


def k7_parts(dtype):
    """The kernel's bf16 parts of a float32 operand for inputs of dtype."""
    return 3 if dtype == torch.float32 else 2


def emulate_k7(r, k, v, lw, u, G, parts=None):
    """(BH, T, 64) inputs -> (y in r.dtype, final state), K7's way, its
    operands in ``parts`` bf16 parts (the kernel's by default)."""
    parts = parts or k7_parts(r.dtype)
    BH, T, K = r.shape
    C = 64
    nc = -(-T // C)
    pad = nc * C - T
    rf, kf, vf, lwf = (torch.nn.functional.pad(a.float(), (0, 0, 0, pad))
                       for a in (r, k, v, lw))
    uf = u.float()
    chunks = [tuple(a[:, c * C:(c + 1) * C] for a in (rf, kf, vf, lwf))
              for c in range(nc)]
    groups = [list(range(g0, min(g0 + G, nc))) for g0 in range(0, nc, G)]
    # pass 1: each group's own state contribution and its total decay
    dS, dec = [], []
    for grp in groups:
        S = torch.zeros((BH, K, K))
        d = torch.ones((BH, K))
        for c in grp:
            _, kc, vc, lwc = chunks[c]
            P, _ = _chunk_decay(lwc)
            S = _state_update(S, kc, vc, P, parts)
            d = d * torch.exp(P[:, -1])
        dS.append(S)
        dec.append(d)
    # pass 2: the scan over groups
    S, starts = torch.zeros((BH, K, K)), []
    for d, s in zip(dec, dS):
        starts.append(S)
        S = d[:, :, None] * S + s
    final = S
    # pass 3: outputs from each group's start state
    causal = torch.ones((SUB, SUB), dtype=torch.bool).tril(-1)[None, :, :,
                                                                  None]
    ys = []
    for grp, S in zip(groups, starts):
        for c in grp:
            rc, kc, vc, lwc = chunks[c]
            P, E = _chunk_decay(lwc)
            y = _mm(rc * torch.exp(E), S, parts)
            scores = torch.zeros((BH, C, C))
            for i0 in range(0, C, SUB):
                rows = slice(i0, i0 + SUB)
                if i0:
                    pa = P[:, i0 - 1:i0]
                    q = rc[:, rows] * torch.exp(E[:, rows] - pa)
                    kt = kc[:, :i0] * torch.exp(pa - P[:, :i0])
                    scores[:, rows, :i0] = _mm(q, kt.transpose(1, 2), parts)
                D = E[:, rows, None, :] - P[:, None, rows, :]
                A = torch.where(causal, torch.exp(torch.where(causal, D, 0.0)),
                                0.0)
                scores[:, rows, rows] = torch.einsum(
                    "bik,bjk,bijk->bij", rc[:, rows], kc[:, rows], A)
            # the bonus (r_i . u . k_i) v_i rides on the scores' diagonal
            idx = torch.arange(C)
            scores[:, idx, idx] = (rc * uf[:, None, :] * kc).sum(-1)
            y = y + _mm(scores, vc, parts)
            S = _state_update(S, kc, vc, P, parts)
            ys.append(y)
    y = torch.cat(ys, dim=1)[:, :T]
    return y.to(r.dtype), final


def k7_problem(BH, T, lw, seed=0):
    """float32 numpy (r, k, v, lw, u) as chip_smoke.py phase 12 draws them:
    lw ``"model"`` is -exp(clip(-0.5 + normal, -8, 4)), the model's range;
    else a constant."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(BH, T, 64)).astype(np.float32)
               for _ in range(3))
    if lw == "model":
        lwa = -np.exp(np.clip(-0.5 + rng.normal(size=(BH, T, 64)), -8, 4))
    else:
        lwa = np.full((BH, T, 64), lw)
    u = (0.5 * rng.normal(size=(BH, 64))).astype(np.float32)
    return r, k, v, lwa.astype(np.float32), u


def k7_limit_ratio(got, want, tol, y_rtol=0.0):
    """The largest |got - want| / ((tol + y_rtol) |want| + tol max|want|):
    at most 1 passes phase 12."""
    got, want = (torch.as_tensor(np.array(a, np.float32)) for a in (got, want))
    limit = (tol + y_rtol) * want.abs() + tol * want.abs().max()
    return ((got - want).abs() / limit).max().item()


_K7_WANT = {}


def _k7_case(lw, T, dtype):
    """Inputs (in ``dtype``) and the JAX package's sequential scan on them
    (and its Pallas kernel, interpreted, where T is a multiple of 64)."""
    key = (lw, T, dtype)
    if key not in _K7_WANT:
        r, k, v, lwa, u = k7_problem(8, T, lw, seed=T)
        tr, tk, tv = (torch.from_numpy(a).to(dtype) for a in (r, k, v))
        ins = (tr, tk, tv, torch.from_numpy(lwa), torch.from_numpy(u))
        j = [jnp.asarray(t.float().numpy()) for t in ins]
        wants = {"sequential": jax_wkv6_ref(*j)}
        if T % 64 == 0:
            wants["pallas"] = wkv6_chunked_pallas(*j, chunk=64,
                                                  interpret=True)
        _K7_WANT[key] = (ins, wants)
    return _K7_WANT[key]


def _k7_ratios(lw, T, dtype, G, parts=None):
    ins, wants = _k7_case(lw, T, dtype)
    y, s = emulate_k7(*ins, G=G, parts=parts)
    tol = K7_TOL_STRONG if lw == STRONG else K7_TOL
    y_rtol = 2 ** -7 if dtype == torch.bfloat16 else 0.0
    out = {}
    for form, (y_w, s_w) in wants.items():
        y_w = np.asarray(jnp.asarray(y_w, jnp.float32))
        if dtype == torch.bfloat16:     # y is rounded once on both sides
            y_w = torch.from_numpy(y_w).to(dtype).float().numpy()
        out[form] = (k7_limit_ratio(y.float(), y_w, tol, y_rtol),
                     k7_limit_ratio(s, s_w, tol))
    return out


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 129, 300])
@pytest.mark.parametrize("lw,dtype", [
    ("model", torch.float32), ("model", torch.bfloat16),
    (STRONG, torch.float32), (WEAK, torch.float32)])
def test_k7_emulation_meets_phase_12(lw, dtype, T, G):
    """K7's three passes with hi/lo bf16 products, at every chunk-group
    size, against the reference's sequential scan at every T and its
    interpreted Pallas kernel where T is a multiple of 64."""
    ratios = _k7_ratios(lw, T, dtype, G)
    assert ratios.keys() == ({"sequential", "pallas"} if T % 64 == 0
                             else {"sequential"})
    for form, (ry, rs) in ratios.items():
        assert ry <= 1.0 and rs <= 1.0, (form, ry, rs)


@pytest.mark.parametrize("lw,dtype,factor", [
    ("model", torch.float32, 10.0), ("model", torch.bfloat16, 4.0),
    (STRONG, torch.float32, 2.0), (WEAK, torch.float32, 10.0)])
def test_k7_needs_the_operand_split(lw, dtype, factor):
    """Operands rounded once to bf16 exceed phase 12's limit by at least
    ``factor`` at T = 300, G = 4 (measured: 22.3, 9.2, 5.2 and 25.8 times
    it, in the order of the cases); the kernel's parts meet it (0.009,
    0.86, 0.001 and 0.013 of it)."""
    once = max(max(r) for r in _k7_ratios(lw, 300, dtype, 4,
                                          parts=1).values())
    split = max(max(r) for r in _k7_ratios(lw, 300, dtype, 4).values())
    assert split <= 1.0 < factor <= once, (split, once)


def test_k7_float32_takes_three_parts():
    """tests/test_torch_kernels_cuda.py holds float32 K7 to atol = rtol =
    1e-3 against the sequential scan. At the weakest decay (8 sequences
    of 300 tokens, outputs up to ~620) hi + lo products exceed that (1.76
    times it); hi + mid + lo meet it (0.24)."""
    ins, wants = _k7_case(WEAK, 300, torch.float32)
    want = torch.from_numpy(np.array(wants["sequential"][0]))

    def ratio(parts):
        y, _ = emulate_k7(*ins, G=4, parts=parts)
        return ((y - want).abs() / (1e-3 + 1e-3 * want.abs())).max().item()

    assert ratio(3) <= 0.5 and ratio(2) > 1.0


@pytest.mark.parametrize("BH,T,n_sm,want", [
    (256, 2048, 132, 4),     # the serve shape: 2,048 blocks a pass
    (1, 8192, 132, 1),       # one long sequence: 128 blocks of one chunk
    (64, 1000, 132, 2),      # 16 chunks: 4 x 64 < 264, 8 x 64 = 512
    (1, 1, 132, 1), (1000, 300, 132, 4)])
def test_k7_group_size(BH, T, n_sm, want):
    """Groups of 4 chunks unless that leaves fewer than two blocks an SM."""
    assert group_chunks(BH, T, n_sm) == want
