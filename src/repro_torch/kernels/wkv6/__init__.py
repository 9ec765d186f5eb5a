"""The WKV6 scan of RWKV6 (Finch), the recurrent mixer of the ``ssm``
family:

- ``wkv6``: the chunked scan over a whole sequence from a zero state —
  prefill and the full forward, once per layer (kernel K7 on the card;
  its gradient recomputes the plain chunked scan, ``Wkv6Fn``);
- ``wkv6_decode_step``: one token against the carried state — every
  decode step, plain PyTorch (O(K V) a head, no kernel).

:mod:`.ref` holds the plain PyTorch versions and :mod:`.ops` the route
dispatch and the CUDA kernel's wrapper.
"""
from .ops import Wkv6Fn, wkv6, wkv6_cuda
from .ref import wkv6_chunked_ref, wkv6_decode_step, wkv6_ref

__all__ = ["wkv6", "wkv6_cuda", "wkv6_ref", "wkv6_chunked_ref",
           "wkv6_decode_step", "Wkv6Fn"]
