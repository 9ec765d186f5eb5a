"""Counter-based random bits that reproduce ``jax.random`` exactly.

The engines draw every link mask and private signal from threefry2x32
keys folded per iteration (``fold_in``) and expanded into per-edge or
per-agent uniforms. This module rebuilds those three operations bit for
bit under jax's default ``jax_threefry_partitionable=True``, so a port run
and a reference run with the same seed see the same masks and signals:

* ``prng_key(s)`` is the key ``(0, s)``;
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, uint32(d)))``;
* the bits of an ``(n,)`` draw are ``out0 ^ out1`` of
  ``threefry2x32(k, (zeros(n), arange(n)))``;
* a uniform is ``bitcast_f32((bits >> 9) | 0x3F800000) - 1``.

A key is two uint32 words held as Python ints. Folding therefore runs on
the host in a few microseconds and needs no device work and no device
sync, while a draw runs as int64 tensor arithmetic masked to 32 bits on
the device it is asked for (torch's uint32 operator coverage is partial).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Key", "prng_key", "fold_in", "threefry2x32", "random_bits",
           "uniform"]

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


class Key(NamedTuple):
    """A threefry2x32 key: two uint32 words."""

    k0: int
    k1: int


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds, as ``jax.random`` implements it.

    The key words are Python ints; the counter words may be Python ints or
    int64 tensors holding uint32 values (the same code serves both)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in the int32 or uint32 range."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError(f"seed {seed} is outside the 32-bit range")
    return Key(0, seed & _M32)


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in(key, data)``. ``data`` is any 32-bit integer;
    a negative int32 (the ``~t`` and negative fold bands of the engines)
    is reinterpreted as its uint32 bit pattern, as jax does."""
    return Key(*threefry2x32(key.k0, key.k1, 0, int(data) & _M32))


def random_bits(key: Key, n: int, device) -> torch.Tensor:
    """(n,) int64 tensor of the uint32 bits ``jax.random.bits(key, (n,))``."""
    if not 0 <= n < (1 << 32):
        raise ValueError(f"draw size {n} is outside the 32-bit counter")
    lo = torch.arange(n, dtype=torch.int64, device=device)
    out0, out1 = threefry2x32(key.k0, key.k1, torch.zeros_like(lo), lo)
    return out0 ^ out1


def uniform(key: Key, n: int, device) -> torch.Tensor:
    """(n,) float32 ``jax.random.uniform(key, (n,))`` in [0, 1)."""
    bits = (random_bits(key, n, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
