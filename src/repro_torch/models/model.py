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

``tp=`` (a :class:`~repro_torch.models.model_axis.ModelAxis`) runs every
family over a model axis: the parameters are a rank's blocks
(``init_local_params``), the caches its blocks under ``cache_specs``
(``init_cache``), attention runs on the rank's local heads (or, where a
block ends inside a head, on gathered blocks), RWKV6 on its heads, the
RG-LRU on its channels, the MoE on its experts, and the logits come back
whole (a vocabulary that does not split is whole on every rank).

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
from .model_axis import layer_dims

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


def _apply_ffn(p: Params, x: torch.Tensor, cfg: ArchConfig, tp=None
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """-> (y, the MoE aux loss or None)."""
    if cfg.ffn_kind == "moe":
        return L.moe_block(p, x, cfg, tp)
    if cfg.ffn_kind == "mlp":
        return L.mlp_block(p, x, cfg, tp), None
    return L.rwkv_cm_block(p, x, cfg, tp=tp), None


def _window(cfg: ArchConfig, kind: str) -> int:
    return cfg.window if kind == "swa" else 0


def _mixer_train(p, x, cfg: ArchConfig, kind: str, positions, backend,
                 tp=None):
    if kind == "wkv6":
        return L.wkv6_block(p, x, cfg, backend, tp)
    if kind == "rglru":
        return L.rglru_block(p, x, cfg, tp)
    return L.attention_block(p, x, cfg, positions,
                             window=_window(cfg, kind), backend=backend,
                             tp=tp)


def block_train(p: Params, x: torch.Tensor, cfg: ArchConfig, kind: str,
                positions: torch.Tensor, backend: str = "auto",
                enc: torch.Tensor | None = None, tp=None
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Pre-norm residual block over a whole sequence -> (x, the MoE aux
    loss or None). ``enc``: the encoder output the cross-attention of an
    encoder-decoder's block reads; ``tp``: the model axis
    (:mod:`repro_torch.models.model_axis`)."""
    h = L.apply_norm(p["norm1"], x, cfg)
    mix = _mixer_train(p["mixer"], h, cfg, kind, positions, backend, tp)
    if cfg.parallel_block:
        y, aux = _apply_ffn(p["ffn"], h, cfg, tp)
        return x + mix + y, aux
    x = x + mix
    if "xattn" in p:
        hx = L.apply_norm(p["norm_x"], x, cfg)
        x = x + L.cross_attention_block(p["xattn"], hx, enc, cfg, tp)
    y, aux = _apply_ffn(p["ffn"], L.apply_norm(p["norm2"], x, cfg), cfg, tp)
    return x + y, aux


# ---------------------------------------------------------------------------
# stack structure helpers
# ---------------------------------------------------------------------------

D_VIS = 1024       # InternViT's feature width (the stub frontend's output)


def _stack_plan(cfg: ArchConfig) -> tuple[int, int]:
    """(repeats, tail): n_layers = repeats * len(pattern) + tail."""
    P = len(cfg.block_pattern)
    return cfg.n_layers // P, cfg.n_layers % P


class _ShapeGen:
    """The generator of :func:`param_shapes`: ``_dense_init`` draws
    nothing on the meta device."""

    device = torch.device("meta")


def _taken(take, path: tuple, tree, lead: int = 0):
    """``take(path names, leaf, lead)`` over a freshly drawn subtree."""
    if take is None:
        return tree
    if isinstance(tree, dict):
        return {k: _taken(take, path + (str(k),), v, lead)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_taken(take, path + (str(i),), v, lead)
                          for i, v in enumerate(tree))
    return take(list(path), tree, lead)


def init_params(seed: int, cfg: ArchConfig, device=None, *,
                take=None) -> Params:
    """Seeded random parameters on ``device`` (``None``: the card), drawn
    leaf by leaf in float32 and cast, in the reference's shapes and layout.
    A stacked group is filled layer by layer into its ``(R, ...)`` leaves,
    so the peak is the parameters plus one layer's float32 draw.

    ``take(path names, leaf, lead)`` keeps a block of each leaf as it is
    drawn (``lead`` = 1 for a layer of a stacked group, whose names are the
    group's and whose spec has the stack's leading dimension): a rank
    draws every leaf in order, so its blocks are those of the one-process
    tree, and holds its blocks plus one layer's leaves
    (:func:`init_local_params`)."""
    dev = resolve_device(device)
    gen = _ShapeGen() if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(int(seed))
    d, V, dt = cfg.d_model, cfg.vocab, L._dt(cfg)

    def top(name, tree):
        return _taken(take, (name,), tree)

    params: Params = {
        "embed": top("embed", L._dense_init(gen, (V, d), dt, scale=0.02)),
        "final_norm": top("final_norm", L.init_norm(gen, cfg)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = top("lm_head", L._dense_init(gen, (d, V), dt))
    if cfg.family == "vlm":
        params["vis_proj"] = top("vis_proj", {
            "w1": L._dense_init(gen, (D_VIS, d), dt),
            "w2": L._dense_init(gen, (d, d), dt)})
    if cfg.encoder_layers:
        params["encoder"] = [
            _taken(take, ("encoder", str(i)), _init_block(gen, cfg, "attn"))
            for i in range(cfg.encoder_layers)]
        params["enc_norm"] = top("enc_norm", L.init_norm(gen, cfg))
    with_x = cfg.encoder_layers > 0
    P = len(cfg.block_pattern)
    R, tail = _stack_plan(cfg)
    if cfg.scan_layers and R > 1:
        groups = []
        for pos in range(P):
            stacked = None
            for r in range(R):
                blk = _taken(take, ("groups", str(pos)), _init_block(
                    gen, cfg, cfg.block_pattern[pos], with_x), lead=1)
                if stacked is None:
                    stacked = _tmap(lambda a: a.new_empty((R,) + a.shape), blk)
                _tmap(lambda s, a, r=r: s[r].copy_(a), stacked, blk)
            groups.append(stacked)
        params["groups"] = groups
        params["tail"] = [
            _taken(take, ("tail", str(i)), _init_block(
                gen, cfg, cfg.block_pattern[i % P], with_x))
            for i in range(tail)]
    else:
        params["layers"] = [
            _taken(take, ("layers", str(i)), _init_block(
                gen, cfg, cfg.mixer_of(i), with_x))
            for i in range(cfg.n_layers)]
    return params


def param_shapes(cfg: ArchConfig) -> Params:
    """The parameter tree of ``cfg`` as meta tensors: shapes and dtypes at
    any size, nothing allocated (the port's ``jax.eval_shape`` of
    ``init_params``)."""
    return init_params(0, cfg, "meta")


def init_local_params(seed: int, cfg: ArchConfig, specs: Params, mesh,
                      device=None) -> Params:
    """This rank's blocks of ``init_params(seed, cfg, device)`` under the
    spec tree ``specs`` (``distributed.sharding.param_specs`` of
    :func:`param_shapes`) on ``mesh`` (a ``RankMesh``), each leaf cut as
    it is drawn."""
    from ..distributed.sharding import local_block

    def spec_of(names):
        t = specs
        for n in names:
            t = t[int(n)] if isinstance(t, list) else t[n]
        return t

    def take(names, leaf, lead):
        return local_block(leaf, spec_of(names)[lead:], mesh)

    return init_params(seed, cfg, device, take=take)


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
                 patch_embeds: torch.Tensor | None = None,
                 tp=None, fsdp=None) -> torch.Tensor:
    """The token embeddings (B, S, d); a VLM prepends its projected
    patches: ``gelu(patch_embeds @ w1)`` in float32 (``patch_embeds`` is
    float32, so the product is promoted as in the reference), cast to the
    embeddings' dtype, then ``@ w2``. Over a model axis ``tp`` each rank
    holds a block of vocabulary rows: it looks up the tokens in its block,
    zeros the others, and the ranks' rows are summed (exact: one non-zero
    term a token); a vocabulary that does not split (Whisper's 51,865,
    InternVL2's 92,553) is whole on every rank and looked up as is. The
    projector's ``w1`` is column-split and ``w2`` row-split: the ranks'
    products are summed. ``fsdp`` (a :class:`~repro_torch.models.
    model_axis.DataShards`) gathers the projector's data-split blocks."""
    emb = params["embed"]
    tokens = tokens.to(emb.device)
    if L._is_split(tp, emb.shape[0], cfg.vocab):
        V_loc = emb.shape[0]
        local = tokens.long() - tp.rank * V_loc
        mine = (local >= 0) & (local < V_loc)
        x = emb[local.clamp(0, V_loc - 1)]
        x = tp.reduce_out(torch.where(mine[..., None], x, x.new_zeros(())))
    else:
        x = emb[tokens]                               # (B, S, d) gather
    if cfg.family == "vlm" and patch_embeds is not None:
        p = params["vis_proj"]
        if fsdp is not None:
            p = fsdp.gather(p, fsdp.dims["vis_proj"])
        vis = L._gelu(L._matmul(patch_embeds.to(emb.device), p["w1"])
                      .float()).to(x.dtype) @ p["w2"]
        vis = L._row_out(vis, tp, L._is_split(tp, p["w2"].shape[0],
                                              cfg.d_model))
        x = torch.cat([vis, x], dim=1)                # patches prepended
    return x


def encode(params: Params, frames: torch.Tensor,
           cfg: ArchConfig, tp=None, fsdp=None) -> torch.Tensor:
    """Whisper's encoder over the stub frontend's frames (B, T, d): pre-norm
    blocks of non-causal self-attention (plain torch) and the MLP, then
    ``enc_norm``. The reference multiplies float32 frames by bf16 weights,
    which JAX promotes to float32, so its whole encoder runs in float32;
    here each block's weights are cast to the promoted dtype first (exact
    for bf16), and the output keeps the frames' (promoted) dtype. bf16
    frames with float32 weights: the first norm's output stays bf16 and
    each of its products promotes, as in the reference. Over a model axis
    ``tp`` each block attends with the rank's heads and runs its MLP
    blocks, the outputs summed; ``fsdp`` gathers each block's data-split
    blocks before it runs.
    ``frames=None`` raises ValueError (the reference fails later, with an
    AttributeError)."""
    if frames is None:
        raise ValueError(f"{cfg.name}: the audio family's encoder needs "
                         f"frames= (B, n_frames, d_model); got frames=None")
    x = frames.to(params["embed"].device)
    pos = torch.arange(x.shape[1], device=x.device)
    for i, blk in enumerate(params["encoder"]):
        if fsdp is not None:
            blk = fsdp.gather(blk, fsdp.dims["encoder"][i])
        blk = _tmap(lambda w: w.to(torch.promote_types(w.dtype, x.dtype)),
                    blk)
        h = L.apply_norm(blk["norm1"], x, cfg)
        x = x + L.attention_block(blk["mixer"], h, cfg, pos, causal=False,
                                  tp=tp)
        y, _ = _apply_ffn(blk["ffn"], L.apply_norm(blk["norm2"], x, cfg),
                          cfg, tp)
        x = x + y
    return L.apply_norm(params["enc_norm"], x, cfg)


def _head_split(params: Params, cfg: ArchConfig, tp) -> bool:
    """Whether the LM head's vocabulary columns are split over ``tp``."""
    head = params["embed"].shape[0] if cfg.tie_embeddings \
        else params["lm_head"].shape[1]
    return L._is_split(tp, head, cfg.vocab)


def lm_logits(params: Params, cfg: ArchConfig, x: torch.Tensor,
              tp=None) -> torch.Tensor:
    """The logits of the hidden states x; over a model axis ``tp`` this
    rank's block of vocabulary columns (``tp.gather_last`` joins them), or
    all of them where the vocabulary does not split."""
    x = L.apply_norm(params["final_norm"], x, cfg)
    if _head_split(params, cfg, tp):
        x = tp.copy_in(x)
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
                   with_aux: bool = False, tp=None, fsdp=None):
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
    reference. ``fsdp`` (:class:`~repro_torch.models.model_axis.
    DataShards`): each layer gathers its data-split blocks inside the
    function the checkpoint runs, so the remat gathers them again and no
    layer's whole weights outlive its forward."""
    x = embed_inputs(params, cfg, tokens, patch_embeds, tp, fsdp)
    positions = torch.arange(x.shape[1], device=x.device)
    enc = encode(params, frames, cfg, tp, fsdp) if cfg.encoder_layers \
        else None
    remat = cfg.remat and torch.is_grad_enabled()
    group = 1
    if remat and "groups" in params and len(cfg.block_pattern) == 1:
        R = params["groups"][0]["norm1"]["scale"].shape[0]
        G = max(cfg.remat_group, 1)
        group = G if R % G == 0 else 1
    n_stacked = cfg.n_layers - len(params.get("tail", ()))
    auxes = []
    dims = [None] * cfg.n_layers if fsdp is None else list(layer_dims(
        fsdp.dims, cfg, _stack_plan(cfg)[0] if "groups" in params else None))

    def run(x, *blocks):
        """-> (x, the blocks' MoE aux terms...)."""
        out = []
        for blk, kind, dim in blocks:
            if dim is not None:
                blk = fsdp.gather(blk, dim)
            x, aux = block_train(blk, x, cfg, kind, positions, backend, enc,
                                 tp)
            if aux is not None:
                out.append(aux)
        return (x, *out)

    pending = []
    for i, (blk, kind, _) in enumerate(_layers(params, cfg)):
        if not remat or i >= n_stacked:
            x, *aux = run(x, (blk, kind, dims[i]))
            auxes += aux
            continue
        pending.append((blk, kind, dims[i]))
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
                  with_aux: bool = False, tp=None, fsdp=None):
    """Logits (B, S, V) of the full sequence; with ``with_aux`` the pair
    (logits, aux) the reference returns (aux 0 without MoE). Over a model
    axis ``tp`` the vocabulary blocks are gathered; ``fsdp`` gathers the
    data-split blocks (:func:`forward_hidden`, :func:`_head_gathered`)."""
    out = forward_hidden(params, cfg, tokens, backend,
                         patch_embeds=patch_embeds, frames=frames,
                         with_aux=with_aux, tp=tp, fsdp=fsdp)
    params = _head_gathered(params, fsdp)
    hidden = out[0] if with_aux else out
    logits = _full_logits(params, cfg, hidden, tp)
    return (logits, out[1]) if with_aux else logits


def _head_gathered(params: Params, fsdp) -> Params:
    """``params`` with an untied LM head's data-split block gathered whole
    over "data" (a tied head is the embedding, which FSDP leaves whole)."""
    if fsdp is None or "lm_head" not in params:
        return params
    return {**params, "lm_head": fsdp.gather(params["lm_head"],
                                             fsdp.dims["lm_head"])}


def _full_logits(params: Params, cfg: ArchConfig, x: torch.Tensor,
                 tp=None) -> torch.Tensor:
    logits = lm_logits(params, cfg, x, tp)
    return tp.gather_last(logits) if _head_split(params, cfg, tp) \
        else logits


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
            frames: torch.Tensor | None = None, tp=None,
            fsdp=None) -> torch.Tensor:
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
    reference pads it and masks the padding out, which adds zeros.

    Over a model axis ``tp`` the vocabulary-split logits are gathered
    into the same cross-entropy on every rank (the gather's backward
    keeps each rank's columns). ``fsdp`` (FSDP's :class:`~repro_torch.
    models.model_axis.DataShards`) gathers each data-split block where it
    is used: a layer's in the layer, the LM head's once for the loss."""
    labels = labels.to(params["embed"].device)
    n_vis = patch_embeds.shape[1] \
        if cfg.family == "vlm" and patch_embeds is not None else 0
    hidden, aux = forward_hidden(params, cfg, tokens, backend,
                                 patch_embeds=patch_embeds, frames=frames,
                                 with_aux=True, tp=tp, fsdp=fsdp)
    params = _head_gathered(params, fsdp)
    hidden = hidden[:, n_vis:]
    B, S, _ = hidden.shape
    if cfg.ce_chunk <= 0:
        return _ce_from_logits(_full_logits(params, cfg, hidden, tp),
                               labels) / (B * S) + aux
    C = cfg.ce_chunk

    def chunk_ce(h, lab):
        return _ce_from_logits(_full_logits(params, cfg, h, tp), lab)

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

def _ring(cfg: ArchConfig, kind: str, cache_len: int) -> int:
    """The K/V rows of an attention layer's cache: ``min(cache_len,
    window)`` for an ``swa`` layer, ``cache_len`` otherwise."""
    return min(cache_len, cfg.window) if (kind == "swa" and cfg.window) \
        else cache_len


def _cache_spec(cfg: ArchConfig, kind: str, B: int, cache_len: int,
                device) -> Params:
    if kind not in _MIXERS:
        raise ValueError(kind)
    if kind == "wkv6":
        c = {"mixer": L.init_wkv6_cache(cfg, B, device)}
    elif kind == "rglru":
        c = {"mixer": L.init_rglru_cache(cfg, B, device)}
    else:
        c = {"mixer": L.init_attn_cache(cfg, B, _ring(cfg, kind, cache_len),
                                        device)}
    if cfg.ffn_kind == "rwkv_cm":
        # channel-mix token-shift state (previous post-norm2 activation)
        c["cm_prev"] = torch.zeros((B, cfg.d_model), dtype=L._dt(cfg),
                                   device=device)
    return c


def _cache_tree(cfg: ArchConfig, stacked: bool, B: int, cache_len: int,
                device) -> Params:
    """The zeros of every layer's cache, in the parameters' layout."""
    P = len(cfg.block_pattern)
    cache: Params = {}
    if stacked:
        R, tail = _stack_plan(cfg)
        cache["groups"] = [
            _tmap(lambda a: a.new_zeros((R,) + a.shape),
                  _cache_spec(cfg, cfg.block_pattern[pos], B, cache_len,
                              device))
            for pos in range(P)]
        cache["tail"] = [_cache_spec(cfg, cfg.block_pattern[i % P], B,
                                     cache_len, device) for i in range(tail)]
    else:
        cache["layers"] = [_cache_spec(cfg, cfg.mixer_of(i), B, cache_len,
                                       device) for i in range(cfg.n_layers)]
    return cache


def init_cache(params: Params, cfg: ArchConfig, B: int, cache_len: int,
               enc: torch.Tensor | None = None, tp=None) -> Params:
    """An all-zeros cache on the parameters' device (callers set ``pos``);
    an encoder-decoder's carries the encoder output as ``enc``. Over a
    model axis ``tp`` (``B``: this rank's requests) every leaf is the
    rank's block of the one-process cache under
    ``distributed.sharding.cache_specs``: its KV heads, or its block of a
    ring's rows where the KV heads do not split, its RWKV6 heads, its
    RG-LRU channels."""
    dev = params["embed"].device
    stacked = "groups" in params
    if tp is None:
        cache = _cache_tree(cfg, stacked, B, cache_len, dev)
    else:
        from ..distributed.sharding import cache_specs, shard_tree
        mesh = tp.comm.mesh
        full = _cache_tree(cfg, stacked, B * mesh.size("pod", "data"),
                           cache_len, "meta")
        cache = _tmap(lambda a: torch.zeros(a.shape, dtype=a.dtype,
                                            device=dev),
                      shard_tree(full, cache_specs(full, cfg, mesh), mesh))
    if enc is not None:
        cache["enc"] = enc
    return cache


def _mixer_decode(p, x, cfg: ArchConfig, kind: str, cache, backend: str,
                  tp=None, cache_len: int | None = None):
    if kind not in _MIXERS:
        raise ValueError(kind)
    if kind == "wkv6":
        return L.wkv6_decode(p, x, cfg, cache, tp)
    if kind == "rglru":
        return L.rglru_decode(p, x, cfg, cache, tp)
    ring = None if cache_len is None else _ring(cfg, kind, cache_len)
    return L.attention_decode(p, x, cfg, cache, backend=backend, tp=tp,
                              ring=ring)


def block_decode(p: Params, x: torch.Tensor, cfg: ArchConfig, kind: str,
                 cache: Params, backend: str = "auto",
                 enc: torch.Tensor | None = None, tp=None,
                 cache_len: int | None = None) -> torch.Tensor:
    """One token through one block; the block's cache is updated in
    place. ``enc``: the encoder output the cross-attention reads;
    ``cache_len``: the capacity prefill built the cache with (a rank's
    block of a sequence-split ring needs the ring's length)."""
    h = L.apply_norm(p["norm1"], x, cfg)
    mix, _ = _mixer_decode(p["mixer"], h, cfg, kind, cache["mixer"], backend,
                           tp, cache_len)
    if cfg.parallel_block:
        return x + mix + _apply_ffn(p["ffn"], h, cfg, tp)[0]
    x = x + mix
    if "xattn" in p and enc is not None:
        hx = L.apply_norm(p["norm_x"], x, cfg)
        x = x + L.cross_attention_block(p["xattn"], hx, enc, cfg, tp)
    h2 = L.apply_norm(p["norm2"], x, cfg)
    if cfg.ffn_kind == "rwkv_cm":
        ffn_out = L.rwkv_cm_block(p["ffn"], h2, cfg,
                                  x_prev=cache["cm_prev"][:, None], tp=tp)
        cache["cm_prev"].copy_(h2[:, 0])
        return x + ffn_out
    return x + _apply_ffn(p["ffn"], h2, cfg, tp)[0]


def decode_step(params: Params, cfg: ArchConfig, cache: Params,
                token: torch.Tensor, backend: str = "auto", tp=None,
                cache_len: int | None = None
                ) -> tuple[torch.Tensor, Params]:
    """token: (B, 1) int -> (logits (B, 1, V), cache). The cache is
    updated in place (the new K/V row and ``pos``, the RWKV6 state and
    token-shift rows, or the RG-LRU state and conv history) and returned;
    the reference returns a new one. Over a model axis ``tp`` the logits
    are gathered from the vocabulary blocks; a cache whose K/V rings are
    split over their rows needs the ``cache_len`` prefill was given."""
    x = embed_inputs(params, cfg, token, tp=tp)
    enc = cache.get("enc")
    for blk, kind, c in _layers(params, cfg, cache):
        x = block_decode(blk, x, cfg, kind, c, backend, enc, tp, cache_len)
    return _full_logits(params, cfg, x, tp), cache


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            cache_len: int | None = None, backend: str = "auto", *,
            patch_embeds: torch.Tensor | None = None,
            frames: torch.Tensor | None = None, tp=None
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
    encodes ``frames`` once and keeps the output in the cache. Over a
    model axis ``tp`` each rank primes its blocks of the caches (its KV
    heads, or its block of a ring's rows, its RWKV6 heads, its RG-LRU
    channels) and the logits are gathered from the vocabulary blocks."""
    x = embed_inputs(params, cfg, tokens, patch_embeds, tp)
    B, S, _ = x.shape
    cache_len = cache_len or S
    positions = torch.arange(S, device=x.device)
    enc = encode(params, frames, cfg, tp) if cfg.encoder_layers else None
    cache = init_cache(params, cfg, B, cache_len, enc, tp)
    for blk, kind, c in _layers(params, cfg, cache):
        h = L.apply_norm(blk["norm1"], x, cfg)
        if kind == "wkv6":
            mix, state = L.wkv6_mix(blk["mixer"], h, L._shift(h), cfg,
                                    backend, tp)
            c["mixer"]["state"].copy_(state)
            c["mixer"]["x_prev"].copy_(h[:, -1])
        elif kind == "rglru":
            mix, xw, hh = L.rglru_mix(blk["mixer"], h, tp)
            hist = c["mixer"]["conv"]
            c["mixer"]["h"].copy_(hh[:, -1])
            c["mixer"]["conv"].copy_(
                F.pad(xw, (0, 0, hist.shape[1], 0))[:, -hist.shape[1]:])
        else:
            mix = L.attention_prefill(
                blk["mixer"], h, cfg, positions, c["mixer"],
                window=_window(cfg, kind), backend=backend, tp=tp,
                ring=_ring(cfg, kind, cache_len))
        if cfg.parallel_block:
            x = x + mix + _apply_ffn(blk["ffn"], h, cfg, tp)[0]
            continue
        x = x + mix
        if "xattn" in blk and enc is not None:
            hx = L.apply_norm(blk["norm_x"], x, cfg)
            x = x + L.cross_attention_block(blk["xattn"], hx, enc, cfg, tp)
        h2 = L.apply_norm(blk["norm2"], x, cfg)
        x = x + _apply_ffn(blk["ffn"], h2, cfg, tp)[0]
        if cfg.ffn_kind == "rwkv_cm":
            c["cm_prev"].copy_(h2[:, -1])
    return _full_logits(params, cfg, x[:, -1:], tp), cache
