"""The attention kernels of the serve path, for the dense GQA models:

- ``attn_decode``: one query token per request over a (ring-buffer) KV
  cache with a per-request valid length — every decode step, once per
  layer;
- ``swa_prefill``: causal, optionally sliding-window, attention over the
  prompt — prefill and the training forward, once per layer; its
  gradient recomputes the plain attention (``SwaPrefillFn``).

:mod:`.ref` holds the plain PyTorch versions and :mod:`.ops` the route
dispatch and the CUDA kernels' wrappers.
"""
from .ops import (SwaPrefillFn, attn_decode, attn_decode_cuda, swa_prefill,
                  swa_prefill_cuda)
from .ref import attn_decode_ref, swa_prefill_ref

__all__ = ["attn_decode", "attn_decode_cuda", "attn_decode_ref",
           "swa_prefill", "swa_prefill_cuda", "swa_prefill_ref",
           "SwaPrefillFn"]
