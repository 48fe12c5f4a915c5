"""Threefry-2x32 keys and uniforms, frozen for the benchmark's reference.

The renderer under test draws its Monte-Carlo numbers as ``jax.random``
does with ``jax_threefry_partitionable``: a key is two uint32 words,
``fold_in(key, d)`` hashes the count words (0, d) under the key, and the
uniform at flat index i of a draw hashes the 64-bit count i and keeps the
top 23 bits of the xor of the two output words.  This module computes the
same numbers from the seed alone, element by element, so that the
reference can give a ray the number that its queue position draws.
uint32 arithmetic is carried in int64 tensors masked to 32 bits.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x0, x1):
    """The 20-round Threefry-2x32 hash of count words (x0, x1) under key
    words (k1, k2): Python ints or int64 tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def seed_key(seed: int):
    """The key of an integer seed: words (0, seed mod 2**32)."""
    return 0, int(seed) & M32


def fold_in(key, data):
    """The key folded with ``data`` (an int, or an int64 tensor of counts;
    the key's words may be tensors of the same shape)."""
    if isinstance(data, int):
        data = data & M32
    else:
        data = data & M32
    return threefry2x32(key[0], key[1], 0, data)


def uniform_at(key, index):
    """float64 uniforms in [0, 1): the element at flat index ``index``
    (int64 tensor) of a float32 draw under ``key`` (words as int64 tensors
    broadcastable to ``index``)."""
    y0, y1 = threefry2x32(key[0], key[1], index >> 32, index & M32)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(f, min=0.0).to(torch.float64)
