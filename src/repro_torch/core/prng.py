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
* a uniform is ``bitcast_f32((bits >> 9) | 0x3F800000) - 1``;
* ``split(k, n)[i]`` is ``fold_in(k, i)``: one threefry over the counters
  ``(0, arange(n))``;
* ``randint`` draws two words per value from ``split(k, 2)`` and folds
  them into the range as jax does: ``(hi % span) * mult + lo % span``
  modulo ``span``, with ``mult = (2^16 % span)^2`` in wrapping uint32;
* ``choice(replace=False)`` is a prefix of ``permutation``, which sorts by
  fresh 32-bit keys, stably, ``ceil(3 ln n / ln(2^32 - 1))`` times;
* ``normal`` is ``sqrt(2) * erfinv(u)`` with ``u`` uniform on
  ``(nextafter(-1, 0), 1)``;
* ``gumbel`` is ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)`` in
  the draw's dtype (bfloat16 from 8 bits a word), and ``categorical`` the
  argmax of ``logits + gumbel``, as the serve CLI samples.

A key is two uint32 words held as Python ints. Folding therefore runs on
the host in a few microseconds and needs no device work and no device
sync, while a draw runs as int64 tensor arithmetic masked to 32 bits on
the device it is asked for (torch's uint32 operator coverage is partial).
A *tensor of keys* (what ``split`` returns) holds its words as two int64
tensors; ``fold_in``, ``threefry2x32`` and ``randint`` take it as they take
a single key, so a draw per key is one vectorized pass, not a loop. A
tensor of keys of shape (K, 1) draws (K, n) in one pass
(``random_bits``, ``uniform``): the scenario batches draw every
scenario's round this way, their keys folded for all rounds up front by
:func:`fold_rounds`. A key whose words are numpy arrays of K words folds
on the host (``fold_in`` of K keys in microseconds, no device work) and
draws as the (K, 1) tensor of those keys on the draw's device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Key", "prng_key", "fold_in", "fold_rounds", "threefry2x32",
           "random_bits",
           "uniform", "split", "randint", "randint_n", "choice", "normal",
           "gumbel", "categorical"]

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


class Key(NamedTuple):
    """A threefry2x32 key: two uint32 words, as Python ints, or as int64
    tensors of equal shape for a tensor of keys."""

    k0: int | torch.Tensor
    k1: int | torch.Tensor


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds, as ``jax.random`` implements it.

    Every word may be a Python int, an int64 numpy array or an int64
    tensor holding uint32 values; arrays broadcast (the same code serves
    all cases)."""
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
    is reinterpreted as its uint32 bit pattern, as jax does. A tensor of
    keys folds every key with the same ``data``."""
    return Key(*threefry2x32(key.k0, key.k1, 0, int(data) & _M32))


def fold_rounds(key: Key, folds, device) -> Key:
    """``fold_in(k, f)`` for each fold value ``f`` of ``folds`` (T,) and
    each key ``k`` of ``key`` (words that are Python ints, or arrays of K
    words), computed on the host in one vectorized threefry -> a Key of
    (T, K, 1) int64 tensors on ``device``. Row ``t`` is a tensor of K keys
    whose draws broadcast to (K, n), so an engine's loop folds nothing and
    reads nothing back. ``device=None`` keeps the words on the host, (T,
    K) numpy arrays: row ``t`` is then a key of K numpy words, which
    folds further on the host."""
    k0, k1 = (np.atleast_1d(np.asarray(k, dtype=np.int64))[None, :]
              for k in key)
    data = (np.asarray(folds, dtype=np.int64).reshape(-1) & _M32)[:, None]
    words = threefry2x32(k0, k1, 0, data)
    if device is None:
        return Key(*words)
    return Key(*(torch.from_numpy(np.ascontiguousarray(w[..., None])).to(
        device) for w in words))


def _words(key: Key, device) -> Key:
    """A key as a draw takes it: numpy arrays of K words become the (K,
    1) int64 tensor of those keys on ``device`` (to a card from pinned
    memory, so the copy does not wait for the device); ints and tensors
    stay."""
    cuda = torch.device(device).type == "cuda"

    def word(w):
        if not isinstance(w, np.ndarray):
            return w
        t = torch.from_numpy(np.ascontiguousarray(w, np.int64)[..., None])
        return (t.pin_memory().to(device, non_blocking=True) if cuda
                else t.to(device))

    return Key(word(key.k0), word(key.k1))


def random_bits(key: Key, n: int, device) -> torch.Tensor:
    """(n,) int64 tensor of the uint32 bits ``jax.random.bits(key, (n,))``;
    a tensor of keys of shape (K, 1), or a key of K numpy words, gives (K,
    n), one row a key."""
    if not 0 <= n < (1 << 32):
        raise ValueError(f"draw size {n} is outside the 32-bit counter")
    key = _words(key, device)
    lo = torch.arange(n, dtype=torch.int64, device=device)
    out0, out1 = threefry2x32(key.k0, key.k1, torch.zeros_like(lo), lo)
    return out0 ^ out1


def uniform(key: Key, n: int, device) -> torch.Tensor:
    """(n,) float32 ``jax.random.uniform(key, (n,))`` in [0, 1); (K, n) for
    a tensor of keys of shape (K, 1)."""
    bits = (random_bits(key, n, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def split(key: Key, n: int, device) -> Key:
    """``jax.random.split(key, n)`` as a tensor of ``n`` keys on ``device``;
    key ``i`` equals ``fold_in(key, i)``. K keys (a (K, 1) tensor of keys,
    or K numpy words) split into (K, n)."""
    if not 0 <= n < (1 << 32):
        raise ValueError(f"split count {n} is outside the 32-bit counter")
    key = _words(key, device)
    lo = torch.arange(n, dtype=torch.int64, device=device)
    return Key(*threefry2x32(key.k0, key.k1, torch.zeros_like(lo), lo))


def randint(keys: Key, minval, maxval) -> torch.Tensor:
    """One ``jax.random.randint(k, (), minval, maxval)`` (int32) per key of a
    tensor of keys, as an int64 tensor of the keys' shape. ``minval`` and
    ``maxval`` broadcast against the keys and lie in the int32 range; an
    empty range (``maxval <= minval``) gives ``minval``, as in jax."""
    k0, k1 = torch.broadcast_tensors(torch.as_tensor(keys.k0),
                                     torch.as_tensor(keys.k1))
    which = torch.arange(2, dtype=torch.int64, device=k0.device).reshape(
        (2,) + (1,) * k0.dim())
    # split each key in two (fold_in 0 and 1), then one bits word from each
    s0, s1 = threefry2x32(k0, k1, torch.zeros_like(which), which)
    b0, b1 = threefry2x32(s0, s1, 0, 0)
    hi, lo = b0 ^ b1
    return _in_range(hi, lo, minval, maxval)


def randint_n(key: Key, n: int, minval: int, maxval: int,
              device) -> torch.Tensor:
    """(n,) int64 tensor of ``jax.random.randint(key, (n,), minval,
    maxval)`` (int32): the bits of ``split(key, 2)``'s two keys, folded into
    the range as :func:`randint` folds them. Reshape for an n-d draw."""
    hi = random_bits(fold_in(key, 0), n, device)
    lo = random_bits(fold_in(key, 1), n, device)
    return _in_range(hi, lo, minval, maxval)


def _in_range(hi, lo, minval, maxval) -> torch.Tensor:
    """jax's fold of two uint32 words into [minval, maxval):
    ``(hi % span) * mult + lo % span`` modulo ``span``, with
    ``mult = (2^16 % span)^2`` in wrapping uint32."""
    minval = torch.as_tensor(minval, device=hi.device).to(torch.int64)
    maxval = torch.as_tensor(maxval, device=hi.device).to(torch.int64)
    span = torch.where(maxval <= minval, torch.ones_like(maxval),
                       (maxval - minval) & _M32)
    mult = ((((1 << 16) % span) ** 2) & _M32) % span   # uint32 wrap, as jax
    offset = ((((hi % span) * mult) & _M32) + lo % span) & _M32
    return minval + offset % span


def choice(key: Key, a: torch.Tensor, k: int) -> torch.Tensor:
    """``jax.random.choice(key, a, (k,), replace=False)`` for a 1-D tensor
    ``a``: the first ``k`` entries of ``jax.random.permutation(key, a)``."""
    n = a.shape[0]
    if not 0 <= k <= n:
        raise ValueError(f"cannot take {k} of {n} without replacement")
    if k == 0:
        return a[:0]
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(_M32))
    for _ in range(rounds):
        key, sub = fold_in(key, 0), fold_in(key, 1)
        order = torch.sort(random_bits(sub, n, a.device), stable=True).indices
        a = a[order]
    return a[:k]


def normal(key: Key, shape, device) -> torch.Tensor:
    """float32 ``jax.random.normal(key, shape)``. The uniform is jax's bit
    for bit; the inverse error function is XLA's single-precision
    polynomial (Giles' approximation), evaluated op by op here, so a
    value may differ from jax's by the rounding of those ops (a few ulp;
    ``tests/test_torch_prng.py`` states the bound). K keys (see
    :func:`random_bits`) draw (K, *shape), one draw a key."""
    shape = tuple(shape)
    n = math.prod(shape)
    bits = (random_bits(key, n, device) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(-0.99999994, dtype=torch.float32)   # nextafter(-1, 0)
    u = torch.maximum(f * 2.0 + lo.to(device), lo.to(device))
    return (_SQRT2 * _erfinv_f32(u)).reshape(tuple(bits.shape[:-1]) + shape)


def gumbel(key: Key, shape, dtype: torch.dtype, device) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, dtype)`` (the default "low" mode):
    ``-log(-log(u))`` of a uniform on ``[tiny, 1)`` drawn in ``dtype``.
    float32 takes 23 random mantissa bits of each word, as :func:`uniform`;
    bfloat16, as jax does, the low 8 bits of the word, of which 7 fill the
    mantissa. The logs run in ``dtype`` (bfloat16 rounds after each op, as
    XLA does)."""
    shape = tuple(shape)
    bits = random_bits(key, math.prod(shape), device)
    if dtype == torch.float32:
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    elif dtype == torch.bfloat16:
        f = (((bits & 0xFF) >> 1) | 0x3F80).to(torch.int16).view(
            torch.bfloat16)
    else:
        raise ValueError(f"gumbel draws float32 or bfloat16, not {dtype}")
    tiny = torch.finfo(dtype).tiny
    u = torch.clamp_min((f - 1.0) * (1.0 - tiny) + tiny, tiny)
    return (-torch.log(-torch.log(u))).reshape(shape)


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    argmax (first on ties) of ``logits + gumbel`` drawn in the logits'
    dtype. -> int64 tensor of the leading shape."""
    g = gumbel(key, logits.shape, logits.dtype, logits.device)
    return torch.argmax(g + logits, dim=-1)


_SQRT2 = float(np.float32(np.sqrt(2)))
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: a degree-8 polynomial in
    ``w = -log1p(-x^2)`` (``w - 2.5`` below 5, ``sqrt(w) - 3`` above),
    times ``x``; ``+-inf`` at ``+-1``."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = torch.where(small, cs, cl) + p * w
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)
