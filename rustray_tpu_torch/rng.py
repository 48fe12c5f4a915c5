"""Threefry-2x32 random keys and uniforms with the bits of ``jax.random``.

The JAX package draws its Monte-Carlo numbers with the default threefry
PRNG (``jax_threefry_partitionable=True``).  This module reproduces
``PRNGKey``, ``fold_in`` and ``uniform`` bit for bit, so a port render and a
JAX render of the same scene consume the same random numbers.  uint32
arithmetic is carried in int64 tensors masked to 32 bits.

A key is an explicit int64 tensor of shape (2,) holding the two uint32
key words; nothing here keeps global state.  A key on the CPU folds on the
host; a key on a device (or a fold of tensor data) folds there, with the
same bits, so a captured CUDA graph draws from the key in its input buffer
rather than from words frozen at capture.
"""
from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of count words (x0, x1) under key
    (k1, k2); all int64 tensors (or ints) holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey`` for a 32-bit integer seed: words (0, seed)."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of counts (0, data) under ``key``.
    ``data`` is an int or a 0-dim integer tensor; the result lies on the
    data's device when it is a tensor, else on the key's."""
    if key.device.type == "cpu" and not isinstance(data, torch.Tensor):
        k1, k2 = (int(k) for k in key.tolist())
        y0, y1 = threefry2x32(k1, k2, 0, int(data) & _M32)
        return torch.tensor([y0, y1], dtype=torch.int64)
    if isinstance(data, torch.Tensor):
        key = key.to(data.device)
        data = data.to(torch.int64) & _M32
    else:
        data = int(data) & _M32
    k1, k2 = key.to(torch.int64).unbind()
    return torch.stack(threefry2x32(k1, k2, 0, data))


def uniform(key: torch.Tensor, shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1) on ``device``.

    Partitionable bits: element i (row-major) hashes the 64-bit counter i,
    split into (hi, lo) words, and takes the xor of the two output words;
    the top 23 bits become the mantissa of a float in [1, 2)."""
    if key.device.type == "cpu":
        k1, k2 = (int(k) for k in key.tolist())
    else:
        k1, k2 = key.to(torch.int64).unbind()
    return uniform_words(k1, k2, shape, device)


def uniform_words(k1, k2, shape, device) -> torch.Tensor:
    """:func:`uniform` under key words k1, k2: ints, or 0-dim int64 tensors
    on ``device``."""
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k1, k2, i >> 32, i & _M32)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(floats, min=0.0).reshape(shape)
