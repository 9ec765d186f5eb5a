"""The plain versions of the serve path's attention kernels
(``repro_torch.kernels.swa``) against the JAX package on the CPU: the
decode attention against ``repro.kernels.swa.ref.attn_decode_ref`` and the
TPU kernel ``attn_decode_pallas`` (interpret mode), the prefill attention
against ``swa_prefill_pallas`` (interpret mode) and the model's
``_naive_attention``. The CUDA kernels are held against these plain
versions on the card (``tests/test_torch_kernels_cuda.py``).

Tolerances: float32 throughout; the softmax sums and the P.V products add
in another order (and the TPU kernel's online softmax in another
association): atol 1e-5, rtol 1e-5 on outputs of size ~1. bfloat16 inputs
round the float32 result once on both sides: one bf16 ulp, rtol 2^-7.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

from repro.kernels.swa.prefill import swa_prefill_pallas
from repro.kernels.swa.ref import attn_decode_ref as jax_attn_decode_ref
from repro.kernels.swa.swa import attn_decode_pallas
from repro.models.layers import _naive_attention as jax_naive_attention
from repro_torch.kernels.swa import (attn_decode, attn_decode_ref,
                                     swa_prefill, swa_prefill_ref)
from repro_torch.kernels.swa.ops import (decode_kernel, decode_splits,
                                         prefill_kernel, tma_strides)
from repro_torch.models import layers as TL

TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def decode_problem(B, H, Hkv, Wc, dh, lengths, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, dh)).astype(np.float32)
    k = (2 * rng.normal(size=(B, Hkv, Wc, dh))).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Wc, dh)).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


def prefill_problem(B, S, H, Hkv, dh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    k = (2 * rng.normal(size=(B, S, Hkv, dh))).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, dh)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("Wc,lengths", [
    (64, [64, 64, 64]),          # full cache
    (64, [1, 37, 64]),           # partial lengths, one slab skipped
    (77, [77, 5, 40]),           # ragged Wc (the serve path's S + gen + 1)
    (9, [9, 9, 3]),              # short ring-buffer window
])
def test_decode_ref_matches_jax(H, Hkv, Wc, lengths):
    q, k, v, L = decode_problem(3, H, Hkv, Wc, 16, lengths)
    want = jax_attn_decode_ref(q, k, v, L)
    got = attn_decode_ref(*_t(q, k, v, L))
    _close(got.numpy(), want)
    _close(attn_decode(*_t(q, k, v, L), backend="torch").numpy(), want)
    if Wc % 32 == 0:   # the TPU kernel takes whole slabs only
        pallas = attn_decode_pallas(q, k, v, L, block_w=32, interpret=True)
        _close(got.numpy(), pallas)


def test_decode_ref_bf16_and_scale():
    q, k, v, L = decode_problem(2, 8, 2, 40, 32, [40, 17], seed=3)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = attn_decode_ref(tq, tk, tv, torch.from_numpy(L))
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(),
           jax_attn_decode_ref(jq, jk, jv, L).astype(jnp.float32), 2 ** -7)
    _close(attn_decode_ref(*_t(q, k, v, L), scale=0.3).numpy(),
           jax_attn_decode_ref(q, k, v, L, scale=0.3))


def test_decode_ref_zero_length_is_nan_as_in_jax():
    q, k, v, L = decode_problem(2, 4, 2, 8, 16, [0, 8])
    want = np.asarray(jax_attn_decode_ref(q, k, v, L))
    got = attn_decode_ref(*_t(q, k, v, L)).numpy()
    assert np.isnan(want[0]).all() and np.isnan(got[0]).all()
    _close(got[1], want[1])


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("H,Hkv,dh", [
    pytest.param(4, 4, 16, id="4-4"),
    pytest.param(4, 2, 16, id="4-2"),
    pytest.param(10, 1, 256, id="10-1-256"),   # RecurrentGemma's heads
])
def test_prefill_ref_matches_the_tpu_kernel(window, H, Hkv, dh):
    q, k, v = prefill_problem(2, 64, H, Hkv, dh, seed=window + H)
    got = swa_prefill_ref(*_t(q, k, v), window=window)
    tr = (0, 2, 1, 3)    # the TPU kernel's (B, heads, S, dh) layout
    pallas = swa_prefill_pallas(q.transpose(tr), k.transpose(tr),
                                v.transpose(tr), window=window, bq=16,
                                bk=16, interpret=True)
    _close(got.numpy(), np.asarray(pallas).transpose(tr))


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("S", [1, 13, 64])
def test_prefill_ref_matches_naive_attention(window, S):
    q, k, v = prefill_problem(2, S, 8, 2, 16, seed=S)
    want = jax_naive_attention(q, k, v, causal=True, window=window)
    _close(swa_prefill_ref(*_t(q, k, v), window=window).numpy(), want)
    _close(swa_prefill(*_t(q, k, v), window, backend="torch").numpy(), want)


def test_prefill_ref_reads_strided_views_and_bf16():
    """The model hands the projection's views over; bf16 in, bf16 out."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 10, (4 + 2 * 2) * 16)).astype(np.float32)
    tx = torch.from_numpy(x)
    q = tx[..., :64].view(2, 10, 4, 16)
    k = tx[..., 64:96].view(2, 10, 2, 16)
    v = tx[..., 96:].view(2, 10, 2, 16)
    want = jax_naive_attention(*(np.ascontiguousarray(t.numpy())
                                 for t in (q, k, v)), causal=True, window=0)
    _close(swa_prefill_ref(q, k, v).numpy(), want)
    got = swa_prefill_ref(*(t.to(torch.bfloat16) for t in (q, k, v)), 3)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 10, 4, 16)


def test_model_attention_routes():
    """``causal_attention`` with backend="torch" is the reference's plain
    path (chunked from S = 2048 on when ``attn_impl="auto"``); the CUDA
    route refuses CPU tensors instead of falling back."""
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config("qwen3_8b"))
    q, k, v = prefill_problem(1, 16, 4, 2, 16)
    tq, tk, tv = _t(q, k, v)
    want = jax_naive_attention(q, k, v, causal=True, window=4)
    _close(TL.causal_attention(tq, tk, tv, cfg, window=4,
                               backend="torch").numpy(), want)
    _close(TL._chunked_attention(tq, tk, tv, causal=True, window=4,
                                 q_chunk=4, kv_chunk=8).numpy(), want)
    for fn in (lambda: TL.causal_attention(tq, tk, tv, cfg, window=0,
                                           backend="cuda"),
               lambda: swa_prefill(tq, tk, tv, backend="cuda"),
               lambda: attn_decode(tq[:, 0], tk.transpose(1, 2),
                                   tv.transpose(1, 2),
                                   torch.tensor([16], dtype=torch.int32),
                                   backend="cuda")):
        with pytest.raises(ValueError, match="CUDA"):
            fn()


# The tensor-core prefill kernel's arithmetic (csrc/swa_prefill.cu,
# swa_prefill_tc), emulated in float32 on the CPU: bf16 q, k, v; float32
# Q.K^T (bf16 products are exact in float32) multiplied by scale after the
# product; an online softmax over key tiles with -1e30 masking; P.V as
# P_hi.V + P_lo.V with P_hi = bf16(P) and P_lo = bf16(P - P_hi); the output
# rounded once to bf16. The card's check holds the kernel to the float32
# plain version on the same bf16 inputs within rtol 2^-8 + atol 1e-5
# (chip_smoke.py phase 8, tests/test_torch_kernels_cuda.py); the bf16
# output rounding alone may use up to 2^-8 relative, so the split's P must
# carry more than bf16's 8 bits. With P rounded once to bf16 (a one-product
# design) the same emulation exceeds that limit.
K6_RTOL, K6_ATOL = 2 ** -8, 1e-5


def emulate_tc_prefill(q, k, v, window, bk, split):
    """(B, S, H, dh) bf16 in -> bf16 out, by the kernel's arithmetic."""
    B, S, H, dh = q.shape
    G = H // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)                       # (B, H, S, dh)
    kf = k.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    qpos = torch.arange(S)[:, None]
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros((B, H, S, 1))
    o = torch.zeros((B, H, S, dh))
    for k0 in range(0, S, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        s = (qf @ kt.transpose(-1, -2)) * dh ** -0.5
        kpos = k0 + torch.arange(kt.shape[2])[None, :]
        ok = kpos <= qpos
        if window:
            ok &= kpos > qpos - window
        s = torch.where(ok, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi = p.to(torch.bfloat16).float()
        o = o * alpha + p_hi @ vt
        if split:
            o = o + (p - p_hi).to(torch.bfloat16).float() @ vt
        m = m_new
    out = o / torch.clamp_min(l, 1e-30)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def _k6_limit_ratio(got, want):
    """The largest |got - want| / (atol + rtol |want|): at most 1 passes."""
    return ((got.float() - want).abs()
            / (K6_ATOL + K6_RTOL * want.abs())).max().item()


@pytest.mark.parametrize("S,window,dh,H,Hkv,bk", [
    (256, 0, 64, 4, 4, 128),      # G = 1, the training head size
    (130, 100, 128, 4, 2, 64),    # G = 2, a window, a ragged last tile
    # RecurrentGemma's 10 query heads on one KV head of 256
    (200, 0, 256, 10, 1, 64),     # a ragged last tile
    (150, 100, 256, 10, 1, 64),   # the window edge inside a tile
])
def test_tc_prefill_numerics_need_the_p_split(S, window, dh, H, Hkv, bk):
    """P kept float32-exact as two bf16 terms meets the card's limit; P
    rounded once to bf16 does not."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in prefill_problem(2, S, H, Hkv, dh, seed=S + dh))
    want = swa_prefill_ref(q.float(), k.float(), v.float(), window)
    split = emulate_tc_prefill(q, k, v, window, bk, split=True)
    torch.testing.assert_close(split.float(), want, rtol=K6_RTOL,
                               atol=K6_ATOL)
    assert _k6_limit_ratio(split, want) <= 1.0
    one = emulate_tc_prefill(q, k, v, window, bk, split=False)
    assert _k6_limit_ratio(one, want) > 10.0


def test_prefill_kernel_choice_and_tma_strides():
    """K6's wrapper takes its tensor-core kernel for bf16 at every head
    size and its FMA kernel for float32, and hands the tensor-core
    kernel's tensor maps the (b, s, head) strides TMA accepts: positive
    multiples of 8 elements from a 16-byte aligned base; an axis of size 1
    gets a stride past the whole view. Anything else raises instead of
    falling back to the FMA kernel."""
    assert [prefill_kernel(dt, dh) for dt, dh in (
        (torch.bfloat16, 64), (torch.bfloat16, 128), (torch.bfloat16, 256),
        (torch.float32, 64), (torch.float32, 128), (torch.float32, 256))] == [
        "tc", "tc", "tc", "fma", "fma", "fma"]
    x = torch.zeros((2, 10, (4 + 2 * 2) * 64), dtype=torch.bfloat16)
    q = x[..., :256].view(2, 10, 4, 64)      # a view of a fused projection
    assert tma_strides("q", q) == (5120, 512, 64)
    one = torch.zeros((1, 10, 1, 64), dtype=torch.bfloat16)
    assert tma_strides("k", one) == (640, 64, 640)
    odd = torch.zeros((1, 16, 4 * 64 + 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        tma_strides("q", odd[..., :256].view(1, 16, 4, 64))
    with pytest.raises(ValueError, match="16-byte boundary"):
        tma_strides("q", x[..., 4:260].view(2, 10, 4, 64))


# K5's tensor-core kernel (csrc/attn_decode.cu, attn_decode_tc), emulated
# in float32 on the CPU: bf16 q, k, v; each split of whole 64-row tiles
# walked by 4 warps, warp w taking rows 16w..16w+15 of every tile with its
# own online softmax (one max and one rescale a tile, rows at or past the
# length masked); q.K^T of bf16 operands with float32 sums, multiplied by
# the scale after the product; O += P_hi.V + P_lo.V; the warps' and then
# the splits' (m, l, acc) merged; the output rounded once to bf16; a
# request of length 0 gives NaN. The card holds the kernel to the float32
# plain version on the same bf16 inputs within rtol 2^-8 + atol 1e-5
# (chip_smoke.py phase 8), as for K6: with P rounded once to bf16 the
# same emulation exceeds that limit.
K5_WARPS, K5_SUB = 4, 16


def emulate_tc_decode(q, k, v, lengths, chunk, split=True, scale=None):
    """(B, H, dh) bf16 q and (B, Hkv, Wc, dh) bf16 k, v -> bf16 (B, H, dh),
    by the kernel's arithmetic."""
    B, H, dh = q.shape
    Hkv, Wc = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = dh ** -0.5 if scale is None else scale
    out = torch.full((B, H, dh), float("nan"))

    def merge(states):
        M = torch.stack([m for m, _, _ in states]).amax(0)
        L, A = 0.0, 0.0
        for m, l, a in states:
            c = torch.exp(m - M)            # 0 for a warp that saw no row
            L, A = L + c * l, A + c[..., None] * a
        return M, L, A

    for b in range(B):
        n = min(max(int(lengths[b]), 0), Wc)
        qf = q[b].float().view(Hkv, G, dh)
        splits = []
        for start in range(0, n, chunk):
            end = min(start + chunk, n)
            warps = []
            for w in range(K5_WARPS):
                m = torch.full((Hkv, G), -float("inf"))
                l, acc = torch.zeros((Hkv, G)), torch.zeros((Hkv, G, dh))
                for t0 in range(start + K5_SUB * w, end, 64):
                    t1 = min(t0 + K5_SUB, end)
                    kt, vt = k[b, :, t0:t1].float(), v[b, :, t0:t1].float()
                    s = (qf @ kt.transpose(-1, -2)) * scale
                    m_new = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(s - m_new[..., None])
                    l = l * alpha + p.sum(-1)
                    p_hi = p.to(torch.bfloat16).float()
                    acc = acc * alpha[..., None] + p_hi @ vt
                    if split:
                        acc = acc + (p - p_hi).to(torch.bfloat16).float() @ vt
                    m = m_new
                warps.append((m, l, acc))
            splits.append(merge(warps))
        if splits:
            _, L, A = merge(splits)
            out[b] = (A / L[..., None]).reshape(H, dh)
    return out.to(torch.bfloat16)


# (B, H, Hkv, Wc, dh, lengths)
K5_CASES = [
    (2, 8, 2, 200, 64, [200, 130]),        # G = 4, a length inside a tile
    (3, 32, 8, 300, 128, [0, 77, 300]),    # the serve head size, one empty
    (2, 16, 1, 150, 128, [150, 65]),       # G = 16
    (2, 16, 2, 130, 256, [129, 1]),        # G = 8 at head size 256
    (1, 3, 3, 64, 64, [64]),               # G = 1, one whole tile
]


def _k5_inputs(B, H, Hkv, Wc, dh, lengths):
    q, k, v, L = decode_problem(B, H, Hkv, Wc, dh, lengths, seed=Wc + dh)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    want = np.array(jax_attn_decode_ref(*(t.float().numpy()
                                            for t in (tq, tk, tv)), L))
    return tq, tk, tv, L, torch.from_numpy(want)


@pytest.mark.parametrize("n_sm", [132, 2])
@pytest.mark.parametrize("case", K5_CASES)
def test_tc_decode_numerics_meet_phase_8(case, n_sm):
    """The one-launch kernel's arithmetic, at the splits the wrapper picks
    on a 132-SM card (one tile a split here) and on a 2-SM one (several
    tiles a split), against the reference's attn_decode_ref: within rtol
    2^-8 + atol 1e-5, NaN for a request of length 0."""
    B, H, Hkv, Wc, dh, lengths = case
    tq, tk, tv, L, want = _k5_inputs(*case)
    chunk, n_split = decode_splits(B, Hkv, Wc, dh, n_sm)
    assert chunk % 64 == 0 and (n_split - 1) * chunk < Wc <= n_split * chunk
    got = emulate_tc_decode(tq, tk, tv, L, chunk)
    empty = torch.from_numpy(L == 0)
    assert bool(torch.isnan(got[empty]).all())
    assert bool(torch.isnan(want[empty]).all())
    torch.testing.assert_close(got[~empty].float(), want[~empty],
                               rtol=K6_RTOL, atol=K6_ATOL)


@pytest.mark.parametrize("case", K5_CASES[:3])
def test_tc_decode_needs_the_p_split(case):
    """P rounded once to bf16 exceeds the limit that the split meets (28 to
    37 times it over the five cases, against 0.94-0.98 of it)."""
    tq, tk, tv, L, want = _k5_inputs(*case)
    chunk, _ = decode_splits(case[0], case[2], case[3], case[4], 2)
    ok = torch.from_numpy(L > 0)
    split = emulate_tc_decode(tq, tk, tv, L, chunk)[ok]
    one = emulate_tc_decode(tq, tk, tv, L, chunk, split=False)[ok]
    assert _k6_limit_ratio(split, want[ok]) <= 1.0
    assert _k6_limit_ratio(one, want[ok]) > 10.0


def test_decode_kernel_choice_and_splits():
    """bf16 goes to the one-launch tensor-core kernel, float32 to split and
    combine. Splits are whole 64-row tiles, as many as keep the blocks
    within one wave: two an SM up to head size 128, one at 256."""
    assert [decode_kernel(dt) for dt in (torch.bfloat16, torch.float32)] \
        == ["tc", "split"]
    assert decode_splits(8, 8, 2081, 128, 132) == (576, 4)   # 256 blocks
    assert decode_splits(2, 2, 300, 256, 132) == (64, 5)
    assert decode_splits(64, 8, 2081, 128, 132) == (2112, 1)
    assert decode_splits(1, 1, 5, 64, 132) == (64, 1)
