"""PyTorch/CUDA port of the hierarchical social-learning system.

It mirrors the layout of the JAX package ``repro`` (``core/``,
``kernels/<family>/{ref,ops}.py``, ``configs/``, ``models/``,
``distributed/``, ``launch/``) and imports neither JAX nor ``repro``.
Entry points run on the card unless the caller passes another device; the
engines' per-round kernels and the serve path's attention kernels are
hand-written CUDA for Hopper (``kernels/csrc``), each beside its plain
PyTorch version.
"""
