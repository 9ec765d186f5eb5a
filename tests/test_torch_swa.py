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

from repro.kernels.swa.prefill import swa_prefill_pallas
from repro.kernels.swa.ref import attn_decode_ref as jax_attn_decode_ref
from repro.kernels.swa.swa import attn_decode_pallas
from repro.models.layers import _naive_attention as jax_naive_attention
from repro_torch.kernels.swa import (attn_decode, attn_decode_ref,
                                     swa_prefill, swa_prefill_ref)
from repro_torch.kernels.swa.ops import prefill_kernel, tma_strides
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
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
def test_prefill_ref_matches_the_tpu_kernel(window, H, Hkv):
    q, k, v = prefill_problem(2, 64, H, Hkv, 16, seed=window + H)
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
    """K6's wrapper takes its tensor-core kernel for bf16 at head sizes 64
    and 128 only, and hands that kernel's tensor maps the (b, s, head)
    strides TMA accepts: positive multiples of 8 elements from a 16-byte
    aligned base; an axis of size 1 gets a stride past the whole view.
    Anything else raises instead of falling back to the FMA kernel."""
    assert [prefill_kernel(dt, dh) for dt, dh in (
        (torch.bfloat16, 64), (torch.bfloat16, 128), (torch.bfloat16, 256),
        (torch.float32, 64), (torch.float32, 128))] == [
        "tc", "tc", "fma", "fma", "fma"]
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
