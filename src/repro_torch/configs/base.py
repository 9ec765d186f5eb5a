"""Architecture + run configuration: a copy of ``repro.configs.base``.

The port keeps its own copy so that it imports nothing of the JAX package;
the fields, defaults and ``reduced()`` are the reference's, so a config
built here and one built there describe the same model. Fields that only
the JAX package reads (``moe_impl``, ``remat``, ``remat_group``,
``ce_chunk``, ``use_pallas``) are kept for that parity; the port's kernels
are chosen by the ``backend=`` argument of its entry points instead.

``block_pattern`` drives heterogeneous stacks: a layer's mixer kind is
``pattern[i % len(pattern)]``. Kinds:
  "attn"   — global GQA attention (RoPE, optional qk_norm)
  "swa"    — sliding-window GQA attention (local)
  "wkv6"   — RWKV6 time-mix (data-dependent decay linear recurrence)
  "rglru"  — RG-LRU temporal block (conv4 + gated linear recurrence)
The FFN kind is "moe" when n_experts > 0 for that arch, else "mlp"
("rwkv_cm" channel-mix for the rwkv family).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "reduced"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    source: str                      # citation: arXiv id or HF model card
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_impl: str = "gspmd"          # "gspmd" | "sharded" (shard_map EP)

    # --- attention options ---
    pad_heads_to: int = 0            # zero-pad q heads for TP divisibility
    qk_norm: bool = False
    rope_theta: float = 1e4
    window: int = 0                  # sliding window size for "swa" mixers
    logit_softcap: float = 0.0

    # --- stack structure ---
    block_pattern: tuple[str, ...] = ("attn",)
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    act: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    parallel_block: bool = False     # command-r style parallel attn+mlp
    tie_embeddings: bool = False

    # --- enc-dec / multimodal stubs ---
    encoder_layers: int = 0          # whisper encoder depth
    n_frames: int = 0                # stubbed audio frontend output length
    n_patches: int = 0               # stubbed ViT patch embeddings per image

    # --- ssm/hybrid dims ---
    rnn_width: int = 0               # RG-LRU recurrence width (0 -> d_model)
    wkv_head_dim: int = 64           # RWKV6 head size

    # --- execution ---
    scan_layers: bool = True         # lax.scan over the repeated pattern
    remat: bool = True               # checkpoint each scanned block
    remat_group: int = 1             # layers per checkpoint group (>1 saves
                                     # residuals every G layers only)
    ce_chunk: int = 0                # >0: streamed cross-entropy over
                                     # position chunks (never materializes
                                     # the full (T, vocab) logits)
    dtype: str = "bfloat16"
    use_pallas: bool = False         # engage Pallas kernels (TPU runtime)
    attn_impl: Literal["auto", "naive", "chunked"] = "auto"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.rnn_width == 0:
            object.__setattr__(self, "rnn_width", self.d_model)
        assert self.n_heads % self.n_kv_heads == 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def ffn_kind(self) -> str:
        if self.family == "ssm":
            return "rwkv_cm"
        return "moe" if self.is_moe else "mlp"

    def mixer_of(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    def supports_long_decode(self) -> bool:
        """long_500k runs iff decode state is O(1) or windowed (sub-quadratic)."""
        return True  # every family here decodes with O(window) or O(1) state

    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec

    def param_count(self) -> int:
        """Total parameters (embedding included) — used for 6ND model FLOPs."""
        d, f, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd, H, Hkv = self.head_dim, self.n_heads, self.n_kv_heads
        total = V * d * (1 if self.tie_embeddings else 2)
        for i in range(L):
            kind = self.mixer_of(i)
            if kind in ("attn", "swa"):
                total += d * hd * (H + 2 * Hkv) + H * hd * d
            elif kind == "wkv6":
                total += 5 * d * d + d * 64 * 2 + d * d  # r,k,v,g,w-lora,out
            elif kind == "rglru":
                w = self.rnn_width
                total += 2 * d * w + 4 * w + w * d + w * 3  # in/gate, conv4, out, lru
            if self.ffn_kind == "moe":
                total += self.n_experts * 3 * d * f + d * self.n_experts
            elif self.ffn_kind == "mlp":
                mult = 3 if self.act in ("swiglu", "geglu") else 2
                total += mult * d * f
            else:  # rwkv channel mix
                total += 2 * d * f + d * d
            total += 2 * d  # norms
        if self.encoder_layers:
            mult = 3 if self.act in ("swiglu", "geglu") else 2
            total += self.encoder_layers * (4 * d * d + mult * d * f + 2 * d)
            total += L * 2 * d * d  # decoder cross-attn extra (q,o approx)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE counts top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        dense = self.param_count() - L * self.n_experts * 3 * d * f
        return int(dense + L * self.top_k * 3 * d * f)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ArchConfig, seq_cap: int = 128) -> ArchConfig:
    """The CPU smoke-test variant: same family/pattern, tiny dims."""
    pat = len(cfg.block_pattern)
    n_layers = max(2, pat)  # at least one full pattern, >= 2 layers
    d_model = min(cfg.d_model, 256)
    n_heads = max(2, min(4, cfg.n_heads))
    ratio = max(1, cfg.n_heads // cfg.n_kv_heads)
    n_kv = max(1, n_heads // min(ratio, n_heads))
    head_dim = max(16, d_model // n_heads)
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512),
        vocab=min(cfg.vocab, 512),
        n_experts=min(cfg.n_experts, 4) if cfg.is_moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.is_moe else 0,
        # drop-free capacity so train/serve paths agree exactly in tests
        capacity_factor=(min(cfg.n_experts, 4) / min(cfg.top_k, 2))
        if cfg.is_moe
        else cfg.capacity_factor,
        window=min(cfg.window, seq_cap // 2) if cfg.window else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        n_frames=min(cfg.n_frames, 64) if cfg.n_frames else 0,
        n_patches=min(cfg.n_patches, 16) if cfg.n_patches else 0,
        rnn_width=min(cfg.rnn_width, 256),
        scan_layers=False,
        remat=False,
        dtype="float32",
        use_pallas=False,
    )
