"""PyTorch/CUDA port of the hierarchical social-learning system.

It mirrors the layout of the JAX package ``repro`` (``core/``,
``kernels/<family>/{ref,ops}.py``) and imports neither JAX nor ``repro``.
Entry points run on the card unless the caller passes another device; the
per-round kernels are hand-written CUDA for Hopper (``kernels/csrc``),
each beside its plain PyTorch version.
"""
