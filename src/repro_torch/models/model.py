"""Model assembly for the dense decoders and RWKV6: the port of the
dense-decoder and RWKV6 subsets of ``repro.models.model``.

Param layout (the reference's, so converted trees line up):

- ``cfg.scan_layers`` with more than one repeat of ``block_pattern``
  (Qwen3-8B, RWKV6-1.6B): one dict of *stacked* leaves ``(R, ...)`` per
  pattern position under ``params["groups"]`` (R = n_layers // P) plus
  unstacked ``params["tail"]`` layers for the remainder;
- otherwise (``reduced`` configs): a list ``params["layers"]``.

The reference scans the stacked layout with ``lax.scan``; here it is a
Python loop over per-layer views (``leaf[r]``), repeat-major as the scan
applies it, and no layer is ever copied out.

Entry points:
  ``forward_train`` — full-sequence logits (``forward_hidden`` the trunk)
  ``loss_fn``       — mean next-token cross-entropy (full or streamed),
                      differentiable: training's objective
  ``prefill``       — last-position logits + the primed KV cache
  ``decode_step``   — one token through the cache

``backend=`` picks the kernel route of the mixers: on the card prefill
and the forward run the ``swa_prefill`` kernel (attention) or the ``wkv6``
kernel (RWKV6) once per layer, and a decode step the ``attn_decode``
kernel once per attention layer (an RWKV6 decode step is plain torch);
``backend="torch"`` runs the plain versions. Projections, the MLP, the
channel mix and the LM head are ``torch.matmul``.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.plan import resolve_device
from . import layers as L

Params = dict[str, Any]

_MIXERS = ("attn", "swa", "wkv6")
_FFNS = ("mlp", "rwkv_cm")


def _tmap(fn, *trees):
    """Apply ``fn`` leaf-wise over nested dicts/lists of tensors."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tmap(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tmap(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _check_supported(cfg: ArchConfig) -> None:
    bad = sorted(set(cfg.block_pattern) - set(_MIXERS))
    if bad or cfg.ffn_kind not in _FFNS or cfg.encoder_layers \
            or cfg.family == "vlm":
        raise NotImplementedError(
            f"{cfg.name}: the port runs attn/swa/wkv6 mixers with a dense "
            f"MLP or the rwkv channel mix (mixers {cfg.block_pattern}, ffn "
            f"{cfg.ffn_kind!r}, family {cfg.family!r}); see ROADMAP queue 1 "
            f"item 9d")


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ArchConfig, kind: str) -> Params:
    init_mixer = L.init_wkv6 if kind == "wkv6" else L.init_attention
    p: Params = {"norm1": L.init_norm(gen, cfg), "mixer": init_mixer(gen, cfg)}
    if not cfg.parallel_block:
        p["norm2"] = L.init_norm(gen, cfg)
    init_ffn = L.init_mlp if cfg.ffn_kind == "mlp" else L.init_rwkv_cm
    p["ffn"] = init_ffn(gen, cfg)
    return p


def _apply_ffn(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.ffn_kind == "mlp":
        return L.mlp_block(p, x, cfg)
    return L.rwkv_cm_block(p, x, cfg)


def _window(cfg: ArchConfig, kind: str) -> int:
    return cfg.window if kind == "swa" else 0


def block_train(p: Params, x: torch.Tensor, cfg: ArchConfig, kind: str,
                positions: torch.Tensor, backend: str = "auto"
                ) -> torch.Tensor:
    """Pre-norm residual block over a whole sequence."""
    h = L.apply_norm(p["norm1"], x, cfg)
    if kind == "wkv6":
        mix = L.wkv6_block(p["mixer"], h, cfg, backend)
    else:
        mix = L.attention_block(p["mixer"], h, cfg, positions,
                                window=_window(cfg, kind), backend=backend)
    if cfg.parallel_block:
        return x + mix + _apply_ffn(p["ffn"], h, cfg)
    x = x + mix
    h2 = L.apply_norm(p["norm2"], x, cfg)
    return x + _apply_ffn(p["ffn"], h2, cfg)


# ---------------------------------------------------------------------------
# stack structure helpers
# ---------------------------------------------------------------------------

def _stack_plan(cfg: ArchConfig) -> tuple[int, int]:
    """(repeats, tail): n_layers = repeats * len(pattern) + tail."""
    P = len(cfg.block_pattern)
    return cfg.n_layers // P, cfg.n_layers % P


def init_params(seed: int, cfg: ArchConfig, device=None) -> Params:
    """Seeded random parameters on ``device`` (``None``: the card), drawn
    leaf by leaf in float32 and cast, in the reference's shapes and layout.
    A stacked group is filled layer by layer into its ``(R, ...)`` leaves,
    so the peak is the parameters plus one layer's float32 draw."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    d, V, dt = cfg.d_model, cfg.vocab, L._dt(cfg)
    params: Params = {
        "embed": L._dense_init(gen, (V, d), dt, scale=0.02),
        "final_norm": L.init_norm(gen, cfg),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._dense_init(gen, (d, V), dt)
    P = len(cfg.block_pattern)
    R, tail = _stack_plan(cfg)
    if cfg.scan_layers and R > 1:
        groups = []
        for pos in range(P):
            stacked = None
            for r in range(R):
                blk = _init_block(gen, cfg, cfg.block_pattern[pos])
                if stacked is None:
                    stacked = _tmap(lambda a: a.new_empty((R,) + a.shape), blk)
                _tmap(lambda s, a, r=r: s[r].copy_(a), stacked, blk)
            groups.append(stacked)
        params["groups"] = groups
        params["tail"] = [_init_block(gen, cfg, cfg.block_pattern[i % P])
                          for i in range(tail)]
    else:
        params["layers"] = [_init_block(gen, cfg, cfg.mixer_of(i))
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

def embed_inputs(params: Params, cfg: ArchConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    return emb[tokens.to(emb.device)]                 # (B, S, d) gather


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
                   backend: str = "auto") -> torch.Tensor:
    """The decoder trunk without the LM head: the pre-head hidden (B, S,
    d). Under grad mode with ``cfg.remat`` each block runs under
    ``torch.utils.checkpoint`` (non-reentrant), as the reference runs it
    under ``jax.checkpoint``: its activations are recomputed in the
    backward, which launches the block's mixer kernel a second time. The
    stacked layout with one pattern position and ``remat_group`` G > 1
    dividing R checkpoints G layers at a time; tail layers run without
    remat, as in the reference."""
    x = embed_inputs(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    group = 1
    if remat and "groups" in params and len(cfg.block_pattern) == 1:
        R = params["groups"][0]["norm1"]["scale"].shape[0]
        G = max(cfg.remat_group, 1)
        group = G if R % G == 0 else 1
    n_stacked = cfg.n_layers - len(params.get("tail", ()))

    def run(x, *blocks):
        for blk, kind in blocks:
            x = block_train(blk, x, cfg, kind, positions, backend)
        return x

    pending = []
    for i, (blk, kind, _) in enumerate(_layers(params, cfg)):
        if not remat or i >= n_stacked:
            x = run(x, (blk, kind))
            continue
        pending.append((blk, kind))
        if len(pending) == group:
            x = checkpoint(run, x, *pending, use_reentrant=False)
            pending = []
    return x


def forward_train(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                  backend: str = "auto") -> torch.Tensor:
    """Logits (B, S, V) of the full sequence (the reference also returns
    an aux loss, 0 for dense models)."""
    return lm_logits(params, cfg, forward_hidden(params, cfg, tokens,
                                                 backend))


def _ce_from_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Summed token cross-entropy, in float32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).sum()


def loss_fn(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            labels: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Mean next-token cross-entropy (the dense models' aux loss is 0).

    With ``cfg.ce_chunk`` C > 0 the loss is streamed as in the reference:
    the trunk runs once, then each chunk of C positions is projected to
    the vocabulary and scored under ``torch.utils.checkpoint``, so the
    (B, S, V) logits never exist at once (the backward recomputes them a
    chunk at a time). A ragged last chunk is scored as it is; the
    reference pads it and masks the padding out, which adds zeros."""
    labels = labels.to(params["embed"].device)
    if cfg.ce_chunk <= 0:
        logits = forward_train(params, cfg, tokens, backend)
        n_tok = logits.shape[0] * logits.shape[1]
        return _ce_from_logits(logits, labels) / n_tok
    hidden = forward_hidden(params, cfg, tokens, backend)
    B, S, _ = hidden.shape
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
    return total / (B * S)


# ---------------------------------------------------------------------------
# serve: prefill + decode
# ---------------------------------------------------------------------------

def _cache_spec(cfg: ArchConfig, kind: str, B: int, cache_len: int,
                device) -> Params:
    if kind not in _MIXERS:
        raise ValueError(kind)
    if kind == "wkv6":
        c = {"mixer": L.init_wkv6_cache(cfg, B, device)}
    else:
        wlen = min(cache_len, cfg.window) \
            if (kind == "swa" and cfg.window) else cache_len
        c = {"mixer": L.init_attn_cache(cfg, B, wlen, device)}
    if cfg.ffn_kind == "rwkv_cm":
        # channel-mix token-shift state (previous post-norm2 activation)
        c["cm_prev"] = torch.zeros((B, cfg.d_model), dtype=L._dt(cfg),
                                   device=device)
    return c


def init_cache(params: Params, cfg: ArchConfig, B: int,
               cache_len: int) -> Params:
    """An all-zeros cache on the parameters' device (callers set ``pos``)."""
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
    return cache


def _mixer_decode(p, x, cfg: ArchConfig, kind: str, cache, backend: str):
    if kind not in _MIXERS:
        raise ValueError(kind)
    if kind == "wkv6":
        return L.wkv6_decode(p, x, cfg, cache)
    return L.attention_decode(p, x, cfg, cache, backend=backend)


def block_decode(p: Params, x: torch.Tensor, cfg: ArchConfig, kind: str,
                 cache: Params, backend: str = "auto") -> torch.Tensor:
    """One token through one block; the block's cache is updated in
    place."""
    h = L.apply_norm(p["norm1"], x, cfg)
    mix, _ = _mixer_decode(p["mixer"], h, cfg, kind, cache["mixer"], backend)
    if cfg.parallel_block:
        return x + mix + _apply_ffn(p["ffn"], h, cfg)
    x = x + mix
    h2 = L.apply_norm(p["norm2"], x, cfg)
    if cfg.ffn_kind == "rwkv_cm":
        ffn_out = L.rwkv_cm_block(p["ffn"], h2, cfg,
                                  x_prev=cache["cm_prev"][:, None])
        cache["cm_prev"].copy_(h2[:, 0])
        return x + ffn_out
    return x + _apply_ffn(p["ffn"], h2, cfg)


def decode_step(params: Params, cfg: ArchConfig, cache: Params,
                token: torch.Tensor, backend: str = "auto"
                ) -> tuple[torch.Tensor, Params]:
    """token: (B, 1) int -> (logits (B, 1, V), cache). The cache is
    updated in place (the new K/V row and ``pos``, or the RWKV6 state and
    token-shift rows) and returned; the reference returns a new one."""
    x = embed_inputs(params, cfg, token)
    for blk, kind, c in _layers(params, cfg, cache):
        x = block_decode(blk, x, cfg, kind, c, backend)
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
            cache_len: int | None = None, backend: str = "auto"
            ) -> tuple[torch.Tensor, Params]:
    """Full-sequence prefill -> (last-position logits (B, 1, V), primed
    cache). ``cache_len`` is the KV capacity (default S; an ``swa`` layer
    holds ``min(cache_len, window)`` rows as a ring). Each attention layer
    projects K/V once, primes its cache from them and runs causal
    attention over the prompt (the ``swa_prefill`` kernel on the card);
    each RWKV6 layer runs the chunked scan over the prompt (the ``wkv6``
    kernel on the card) and keeps its final state and the last normed
    token; the channel mix keeps its last input."""
    x = embed_inputs(params, cfg, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    cache = init_cache(params, cfg, B, cache_len or S)
    for blk, kind, c in _layers(params, cfg, cache):
        h = L.apply_norm(blk["norm1"], x, cfg)
        if kind == "wkv6":
            mix, state = L.wkv6_mix(blk["mixer"], h, L._shift(h), cfg,
                                    backend)
            c["mixer"]["state"].copy_(state)
            c["mixer"]["x_prev"].copy_(h[:, -1])
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
            x = x + mix + _apply_ffn(blk["ffn"], h, cfg)
            continue
        x = x + mix
        h2 = L.apply_norm(blk["norm2"], x, cfg)
        x = x + _apply_ffn(blk["ffn"], h2, cfg)
        if cfg.ffn_kind == "rwkv_cm":
            c["cm_prev"].copy_(h2[:, -1])
    return lm_logits(params, cfg, x[:, -1:]), cache
