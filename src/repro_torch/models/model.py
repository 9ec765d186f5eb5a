"""Model assembly: the port of ``repro.models.model`` (decoder-only,
encoder-decoder and patterned hybrid stacks).

Param layout (the reference's, so converted trees line up):

- ``cfg.scan_layers`` with more than one repeat of ``block_pattern``
  (Qwen3-8B, RWKV6-1.6B, the MoE decoders, RecurrentGemma-2B's
  (rglru, rglru, swa) pattern, InternVL2-26B): one dict of *stacked*
  leaves ``(R, ...)`` per pattern position under ``params["groups"]``
  (R = n_layers // P) plus unstacked ``params["tail"]`` layers for the
  remainder (RecurrentGemma's last two RG-LRU layers);
- otherwise (``reduced`` configs, Whisper-small): a list
  ``params["layers"]``.

Whisper adds ``params["encoder"]`` (a list of attention blocks) and
``enc_norm``, and a cross-attention (``xattn``, ``norm_x``) in each
decoder block; the VLM adds the patch projection ``vis_proj``.

The reference scans the stacked layout with ``lax.scan``; here it is a
Python loop over per-layer views (``leaf[r]``), repeat-major as the scan
applies it, and no layer is ever copied out.

Entry points:
  ``forward_train`` — full-sequence logits (``forward_hidden`` the trunk);
                      ``with_aux=True`` adds the MoE aux loss, summed over
                      layers
  ``loss_fn``       — mean next-token cross-entropy (full or streamed)
                      plus the MoE aux, differentiable: training's
                      objective (every family)
  ``prefill``       — last-position logits + the primed caches
  ``decode_step``   — one token through the caches

``frames=`` (Whisper: the stub frontend's (B, n_frames, d) float32
output) and ``patch_embeds=`` (the VLM: (B, n_patches, 1024) ViT features,
prepended as tokens) are the reference's stub inputs.

``backend=`` picks the kernel route of the mixers: on the card prefill
and the forward run the ``swa_prefill`` kernel (causal attention) or the
``wkv6`` kernel (RWKV6) once per layer, and a decode step the
``attn_decode`` kernel once per attention layer (RWKV6 and RG-LRU decode
steps are plain torch); ``backend="torch"`` runs the plain versions.
Projections, the MLP, the MoE experts, the RG-LRU scan, non-causal
attention and the LM head are plain torch.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.plan import resolve_device
from . import layers as L

Params = dict[str, Any]

_MIXERS = ("attn", "swa", "wkv6", "rglru")
_MIXER_INIT = {"attn": L.init_attention, "swa": L.init_attention,
               "wkv6": L.init_wkv6, "rglru": L.init_rglru}
_FFN_INIT = {"mlp": L.init_mlp, "moe": L.init_moe, "rwkv_cm": L.init_rwkv_cm}


def _tmap(fn, *trees):
    """Apply ``fn`` leaf-wise over nested dicts/lists of tensors."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tmap(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tmap(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ArchConfig, kind: str,
                with_xattn: bool = False) -> Params:
    p: Params = {"norm1": L.init_norm(gen, cfg),
                 "mixer": _MIXER_INIT[kind](gen, cfg)}
    if not cfg.parallel_block:
        p["norm2"] = L.init_norm(gen, cfg)
    if with_xattn:
        p["xattn"] = L.init_cross_attention(gen, cfg)
        p["norm_x"] = L.init_norm(gen, cfg)
    p["ffn"] = _FFN_INIT[cfg.ffn_kind](gen, cfg)
    return p


def _apply_ffn(p: Params, x: torch.Tensor, cfg: ArchConfig
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """-> (y, the MoE aux loss or None)."""
    if cfg.ffn_kind == "moe":
        return L.moe_block(p, x, cfg)
    if cfg.ffn_kind == "mlp":
        return L.mlp_block(p, x, cfg), None
    return L.rwkv_cm_block(p, x, cfg), None


def _window(cfg: ArchConfig, kind: str) -> int:
    return cfg.window if kind == "swa" else 0


def _mixer_train(p, x, cfg: ArchConfig, kind: str, positions, backend):
    if kind == "wkv6":
        return L.wkv6_block(p, x, cfg, backend)
    if kind == "rglru":
        return L.rglru_block(p, x, cfg)
    return L.attention_block(p, x, cfg, positions,
                             window=_window(cfg, kind), backend=backend)


def block_train(p: Params, x: torch.Tensor, cfg: ArchConfig, kind: str,
                positions: torch.Tensor, backend: str = "auto",
                enc: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Pre-norm residual block over a whole sequence -> (x, the MoE aux
    loss or None). ``enc``: the encoder output the cross-attention of an
    encoder-decoder's block reads."""
    h = L.apply_norm(p["norm1"], x, cfg)
    mix = _mixer_train(p["mixer"], h, cfg, kind, positions, backend)
    if cfg.parallel_block:
        y, aux = _apply_ffn(p["ffn"], h, cfg)
        return x + mix + y, aux
    x = x + mix
    if "xattn" in p:
        hx = L.apply_norm(p["norm_x"], x, cfg)
        x = x + L.cross_attention_block(p["xattn"], hx, enc, cfg)
    y, aux = _apply_ffn(p["ffn"], L.apply_norm(p["norm2"], x, cfg), cfg)
    return x + y, aux


# ---------------------------------------------------------------------------
# stack structure helpers
# ---------------------------------------------------------------------------

D_VIS = 1024       # InternViT's feature width (the stub frontend's output)


def _stack_plan(cfg: ArchConfig) -> tuple[int, int]:
    """(repeats, tail): n_layers = repeats * len(pattern) + tail."""
    P = len(cfg.block_pattern)
    return cfg.n_layers // P, cfg.n_layers % P


def init_params(seed: int, cfg: ArchConfig, device=None) -> Params:
    """Seeded random parameters on ``device`` (``None``: the card), drawn
    leaf by leaf in float32 and cast, in the reference's shapes and layout.
    A stacked group is filled layer by layer into its ``(R, ...)`` leaves,
    so the peak is the parameters plus one layer's float32 draw."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    d, V, dt = cfg.d_model, cfg.vocab, L._dt(cfg)
    params: Params = {
        "embed": L._dense_init(gen, (V, d), dt, scale=0.02),
        "final_norm": L.init_norm(gen, cfg),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._dense_init(gen, (d, V), dt)
    if cfg.family == "vlm":
        params["vis_proj"] = {"w1": L._dense_init(gen, (D_VIS, d), dt),
                              "w2": L._dense_init(gen, (d, d), dt)}
    if cfg.encoder_layers:
        params["encoder"] = [_init_block(gen, cfg, "attn")
                             for _ in range(cfg.encoder_layers)]
        params["enc_norm"] = L.init_norm(gen, cfg)
    with_x = cfg.encoder_layers > 0
    P = len(cfg.block_pattern)
    R, tail = _stack_plan(cfg)
    if cfg.scan_layers and R > 1:
        groups = []
        for pos in range(P):
            stacked = None
            for r in range(R):
                blk = _init_block(gen, cfg, cfg.block_pattern[pos], with_x)
                if stacked is None:
                    stacked = _tmap(lambda a: a.new_empty((R,) + a.shape), blk)
                _tmap(lambda s, a, r=r: s[r].copy_(a), stacked, blk)
            groups.append(stacked)
        params["groups"] = groups
        params["tail"] = [_init_block(gen, cfg, cfg.block_pattern[i % P],
                                      with_x) for i in range(tail)]
    else:
        params["layers"] = [_init_block(gen, cfg, cfg.mixer_of(i), with_x)
                            for i in range(cfg.n_layers)]
    return params


def _layers(params: Params, cfg: ArchConfig, cache: Params | None = None):
    """(block params, mixer kind, block cache) per layer in the reference's
    order; stacked leaves and caches are handed out as ``[r]`` views."""
    P = len(cfg.block_pattern)
    if "groups" in params:
        R = params["groups"][0]["norm1"]["scale"].shape[0]
        for r in range(R):
            for pos in range(P):
                c = None if cache is None else _tmap(
                    lambda a, r=r: a[r], cache["groups"][pos])
                yield (_tmap(lambda a, r=r: a[r], params["groups"][pos]),
                       cfg.block_pattern[pos], c)
        for i, blk in enumerate(params["tail"]):
            yield (blk, cfg.block_pattern[i % P],
                   None if cache is None else cache["tail"][i])
    else:
        for i, blk in enumerate(params["layers"]):
            yield (blk, cfg.mixer_of(i),
                   None if cache is None else cache["layers"][i])


# ---------------------------------------------------------------------------
# embedding / head / train forward
# ---------------------------------------------------------------------------

def embed_inputs(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                 patch_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """The token embeddings (B, S, d); a VLM prepends its projected
    patches: ``gelu(patch_embeds @ w1)`` in float32 (``patch_embeds`` is
    float32, so the product is promoted as in the reference), cast to the
    embeddings' dtype, then ``@ w2``."""
    emb = params["embed"]
    x = emb[tokens.to(emb.device)]                    # (B, S, d) gather
    if cfg.family == "vlm" and patch_embeds is not None:
        p = params["vis_proj"]
        vis = L._gelu(L._matmul(patch_embeds.to(emb.device), p["w1"])
                      .float()).to(x.dtype) @ p["w2"]
        x = torch.cat([vis, x], dim=1)                # patches prepended
    return x


def encode(params: Params, frames: torch.Tensor,
           cfg: ArchConfig) -> torch.Tensor:
    """Whisper's encoder over the stub frontend's frames (B, T, d): pre-norm
    blocks of non-causal self-attention (plain torch) and the MLP, then
    ``enc_norm``. The reference multiplies float32 frames by bf16 weights,
    which JAX promotes to float32, so its whole encoder runs in float32;
    here each block's weights are cast to the promoted dtype first (exact
    for bf16), and the output keeps the frames' (promoted) dtype. bf16
    frames with float32 weights: the first norm's output stays bf16 and
    each of its products promotes, as in the reference.
    ``frames=None`` raises ValueError (the reference fails later, with an
    AttributeError)."""
    if frames is None:
        raise ValueError(f"{cfg.name}: the audio family's encoder needs "
                         f"frames= (B, n_frames, d_model); got frames=None")
    x = frames.to(params["embed"].device)
    pos = torch.arange(x.shape[1], device=x.device)
    for blk in params["encoder"]:
        blk = _tmap(lambda w: w.to(torch.promote_types(w.dtype, x.dtype)),
                    blk)
        h = L.apply_norm(blk["norm1"], x, cfg)
        x = x + L.attention_block(blk["mixer"], h, cfg, pos, causal=False)
        y, _ = _apply_ffn(blk["ffn"], L.apply_norm(blk["norm2"], x, cfg),
                          cfg)
        x = x + y
    return L.apply_norm(params["enc_norm"], x, cfg)


def lm_logits(params: Params, cfg: ArchConfig,
              x: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(params["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits.float() / c).to(logits.dtype)
    return logits


def forward_hidden(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                   backend: str = "auto", *,
                   patch_embeds: torch.Tensor | None = None,
                   frames: torch.Tensor | None = None,
                   with_aux: bool = False):
    """The decoder trunk without the LM head: the pre-head hidden (B, S,
    d), S counting a VLM's prepended patches; with ``with_aux`` also the
    MoE aux loss summed over the layers in their order (a float32 scalar,
    0 without MoE), as the reference returns it. Under grad mode with
    ``cfg.remat`` each block runs under ``torch.utils.checkpoint``
    (non-reentrant), as the reference runs it under ``jax.checkpoint``:
    its activations are recomputed in the backward, which launches the
    block's mixer kernel a second time. The stacked layout with one
    pattern position and ``remat_group`` G > 1 dividing R checkpoints G
    layers at a time; tail layers run without remat, as in the
    reference."""
    x = embed_inputs(params, cfg, tokens, patch_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    enc = encode(params, frames, cfg) if cfg.encoder_layers else None
    remat = cfg.remat and torch.is_grad_enabled()
    group = 1
    if remat and "groups" in params and len(cfg.block_pattern) == 1:
        R = params["groups"][0]["norm1"]["scale"].shape[0]
        G = max(cfg.remat_group, 1)
        group = G if R % G == 0 else 1
    n_stacked = cfg.n_layers - len(params.get("tail", ()))
    auxes = []

    def run(x, *blocks):
        """-> (x, the blocks' MoE aux terms...)."""
        out = []
        for blk, kind in blocks:
            x, aux = block_train(blk, x, cfg, kind, positions, backend, enc)
            if aux is not None:
                out.append(aux)
        return (x, *out)

    pending = []
    for i, (blk, kind, _) in enumerate(_layers(params, cfg)):
        if not remat or i >= n_stacked:
            x, *aux = run(x, (blk, kind))
            auxes += aux
            continue
        pending.append((blk, kind))
        if len(pending) == group:
            x, *aux = checkpoint(run, x, *pending, use_reentrant=False)
            auxes += aux
            pending = []
    if not with_aux:
        return x
    total = x.new_zeros((), dtype=torch.float32)
    for aux in auxes:
        total = total + aux
    return x, total


def forward_train(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                  backend: str = "auto", *,
                  patch_embeds: torch.Tensor | None = None,
                  frames: torch.Tensor | None = None,
                  with_aux: bool = False):
    """Logits (B, S, V) of the full sequence; with ``with_aux`` the pair
    (logits, aux) the reference returns (aux 0 without MoE)."""
    out = forward_hidden(params, cfg, tokens, backend,
                         patch_embeds=patch_embeds, frames=frames,
                         with_aux=with_aux)
    if with_aux:
        return lm_logits(params, cfg, out[0]), out[1]
    return lm_logits(params, cfg, out)


def _ce_from_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Summed token cross-entropy, in float32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).sum()


def loss_fn(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            labels: torch.Tensor, backend: str = "auto", *,
            patch_embeds: torch.Tensor | None = None,
            frames: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy plus the MoE aux loss summed over the
    layers (0 without MoE), as the reference's ``loss_fn``. A VLM with
    ``patch_embeds`` scores only the text positions: the patch rows are
    sliced off the hidden states before the head (the reference slices
    its full path's logits: the same values, less work). An
    encoder-decoder takes ``frames`` (ValueError without them).

    With ``cfg.ce_chunk`` C > 0 the loss is streamed as in the reference:
    the trunk runs once, then each chunk of C positions is projected to
    the vocabulary and scored under ``torch.utils.checkpoint``, so the
    (B, S, V) logits never exist at once (the backward recomputes them a
    chunk at a time). A ragged last chunk is scored as it is; the
    reference pads it and masks the padding out, which adds zeros."""
    labels = labels.to(params["embed"].device)
    n_vis = patch_embeds.shape[1] \
        if cfg.family == "vlm" and patch_embeds is not None else 0
    hidden, aux = forward_hidden(params, cfg, tokens, backend,
                                 patch_embeds=patch_embeds, frames=frames,
                                 with_aux=True)
    hidden = hidden[:, n_vis:]
    B, S, _ = hidden.shape
    if cfg.ce_chunk <= 0:
        return _ce_from_logits(lm_logits(params, cfg, hidden),
                               labels) / (B * S) + aux
    C = cfg.ce_chunk

    def chunk_ce(h, lab):
        return _ce_from_logits(lm_logits(params, cfg, h), lab)

    total = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, S, C):
        h, lab = hidden[:, c0:c0 + C], labels[:, c0:c0 + C]
        if torch.is_grad_enabled():
            total = total + checkpoint(chunk_ce, h, lab, use_reentrant=False)
        else:
            total = total + chunk_ce(h, lab)
    return total / (B * S) + aux


# ---------------------------------------------------------------------------
# serve: prefill + decode
# ---------------------------------------------------------------------------

def _cache_spec(cfg: ArchConfig, kind: str, B: int, cache_len: int,
                device) -> Params:
    if kind not in _MIXERS:
        raise ValueError(kind)
    if kind == "wkv6":
        c = {"mixer": L.init_wkv6_cache(cfg, B, device)}
    elif kind == "rglru":
        c = {"mixer": L.init_rglru_cache(cfg, B, device)}
    else:
        wlen = min(cache_len, cfg.window) \
            if (kind == "swa" and cfg.window) else cache_len
        c = {"mixer": L.init_attn_cache(cfg, B, wlen, device)}
    if cfg.ffn_kind == "rwkv_cm":
        # channel-mix token-shift state (previous post-norm2 activation)
        c["cm_prev"] = torch.zeros((B, cfg.d_model), dtype=L._dt(cfg),
                                   device=device)
    return c


def init_cache(params: Params, cfg: ArchConfig, B: int, cache_len: int,
               enc: torch.Tensor | None = None) -> Params:
    """An all-zeros cache on the parameters' device (callers set ``pos``);
    an encoder-decoder's carries the encoder output as ``enc``."""
    dev = params["embed"].device
    P = len(cfg.block_pattern)
    cache: Params = {}
    if "groups" in params:
        R, tail = _stack_plan(cfg)
        cache["groups"] = [
            _tmap(lambda a: a.new_zeros((R,) + a.shape),
                  _cache_spec(cfg, cfg.block_pattern[pos], B, cache_len, dev))
            for pos in range(P)]
        cache["tail"] = [_cache_spec(cfg, cfg.block_pattern[i % P], B,
                                     cache_len, dev) for i in range(tail)]
    else:
        cache["layers"] = [_cache_spec(cfg, cfg.mixer_of(i), B, cache_len,
                                       dev) for i in range(cfg.n_layers)]
    if enc is not None:
        cache["enc"] = enc
    return cache


def _mixer_decode(p, x, cfg: ArchConfig, kind: str, cache, backend: str):
    if kind not in _MIXERS:
        raise ValueError(kind)
    if kind == "wkv6":
        return L.wkv6_decode(p, x, cfg, cache)
    if kind == "rglru":
        return L.rglru_decode(p, x, cfg, cache)
    return L.attention_decode(p, x, cfg, cache, backend=backend)


def block_decode(p: Params, x: torch.Tensor, cfg: ArchConfig, kind: str,
                 cache: Params, backend: str = "auto",
                 enc: torch.Tensor | None = None) -> torch.Tensor:
    """One token through one block; the block's cache is updated in
    place. ``enc``: the encoder output the cross-attention reads."""
    h = L.apply_norm(p["norm1"], x, cfg)
    mix, _ = _mixer_decode(p["mixer"], h, cfg, kind, cache["mixer"], backend)
    if cfg.parallel_block:
        return x + mix + _apply_ffn(p["ffn"], h, cfg)[0]
    x = x + mix
    if "xattn" in p and enc is not None:
        hx = L.apply_norm(p["norm_x"], x, cfg)
        x = x + L.cross_attention_block(p["xattn"], hx, enc, cfg)
    h2 = L.apply_norm(p["norm2"], x, cfg)
    if cfg.ffn_kind == "rwkv_cm":
        ffn_out = L.rwkv_cm_block(p["ffn"], h2, cfg,
                                  x_prev=cache["cm_prev"][:, None])
        cache["cm_prev"].copy_(h2[:, 0])
        return x + ffn_out
    return x + _apply_ffn(p["ffn"], h2, cfg)[0]


def decode_step(params: Params, cfg: ArchConfig, cache: Params,
                token: torch.Tensor, backend: str = "auto"
                ) -> tuple[torch.Tensor, Params]:
    """token: (B, 1) int -> (logits (B, 1, V), cache). The cache is
    updated in place (the new K/V row and ``pos``, the RWKV6 state and
    token-shift rows, or the RG-LRU state and conv history) and returned;
    the reference returns a new one."""
    x = embed_inputs(params, cfg, token)
    enc = cache.get("enc")
    for blk, kind, c in _layers(params, cfg, cache):
        x = block_decode(blk, x, cfg, kind, c, backend, enc)
    return lm_logits(params, cfg, x), cache


def _prime(dst: torch.Tensor, src: torch.Tensor, S: int) -> None:
    """Write the last ``min(S, wlen)`` K or V rows ``src`` (B, S, Hkv, dh)
    into a layer cache ``dst`` (B, Hkv, wlen, dh) as the reference primes
    it: appended from slot 0 while S <= wlen; once S >= wlen, token t at
    slot t % wlen (the reference's roll by S % wlen)."""
    wlen = dst.shape[2]
    n = min(S, wlen)
    rows = src[:, S - n:].transpose(1, 2)            # (B, Hkv, n, dh) view
    shift = S % wlen if S >= wlen else 0
    if shift == 0:
        dst[:, :, :n].copy_(rows)
    else:
        dst[:, :, shift:].copy_(rows[:, :, :wlen - shift])
        dst[:, :, :shift].copy_(rows[:, :, wlen - shift:])


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            cache_len: int | None = None, backend: str = "auto", *,
            patch_embeds: torch.Tensor | None = None,
            frames: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, Params]:
    """Full-sequence prefill -> (last-position logits (B, 1, V), primed
    cache). ``cache_len`` is the KV capacity (default S, counting a VLM's
    patches; an ``swa`` layer holds ``min(cache_len, window)`` rows as a
    ring). Each attention layer projects K/V once, primes its cache from
    them and runs causal attention over the prompt (the ``swa_prefill``
    kernel on the card); each RWKV6 layer runs the chunked scan over the
    prompt (the ``wkv6`` kernel on the card) and keeps its final state and
    the last normed token; each RG-LRU layer keeps the scan's last row and
    the last three rows of its input projection (zeros before a short
    prompt); the channel mix keeps its last input. An encoder-decoder
    encodes ``frames`` once and keeps the output in the cache."""
    x = embed_inputs(params, cfg, tokens, patch_embeds)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    enc = encode(params, frames, cfg) if cfg.encoder_layers else None
    cache = init_cache(params, cfg, B, cache_len or S, enc)
    for blk, kind, c in _layers(params, cfg, cache):
        h = L.apply_norm(blk["norm1"], x, cfg)
        if kind == "wkv6":
            mix, state = L.wkv6_mix(blk["mixer"], h, L._shift(h), cfg,
                                    backend)
            c["mixer"]["state"].copy_(state)
            c["mixer"]["x_prev"].copy_(h[:, -1])
        elif kind == "rglru":
            mix, xw, hh = L.rglru_mix(blk["mixer"], h)
            hist = c["mixer"]["conv"]
            c["mixer"]["h"].copy_(hh[:, -1])
            c["mixer"]["conv"].copy_(
                F.pad(xw, (0, 0, hist.shape[1], 0))[:, -hist.shape[1]:])
        else:
            q, k, v = L._qk_project(blk["mixer"], h, cfg, positions)
            _prime(c["mixer"]["k"], k, S)
            _prime(c["mixer"]["v"], v, S)
            c["mixer"]["pos"].fill_(S)
            out = L.causal_attention(q, k, v, cfg,
                                     window=_window(cfg, kind),
                                     backend=backend)
            mix = out.reshape(B, S, -1) @ blk["mixer"]["wo"]
        if cfg.parallel_block:
            x = x + mix + _apply_ffn(blk["ffn"], h, cfg)[0]
            continue
        x = x + mix
        if "xattn" in blk and enc is not None:
            hx = L.apply_norm(blk["norm_x"], x, cfg)
            x = x + L.cross_attention_block(blk["xattn"], hx, enc, cfg)
        h2 = L.apply_norm(blk["norm2"], x, cfg)
        x = x + _apply_ffn(blk["ffn"], h2, cfg)[0]
        if cfg.ffn_kind == "rwkv_cm":
            c["cm_prev"].copy_(h2[:, -1])
    return lm_logits(params, cfg, x[:, -1:]), cache
