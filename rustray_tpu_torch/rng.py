"""Threefry-2x32 random keys and uniforms with the bits of ``jax.random``.

The JAX package draws its Monte-Carlo numbers with the default threefry
PRNG (``jax_threefry_partitionable=True``).  This module reproduces
``PRNGKey``, ``fold_in`` and ``uniform`` bit for bit, so a port render and a
JAX render of the same scene consume the same random numbers.  uint32
arithmetic is carried in int64 tensors masked to 32 bits.

A key is an explicit int64 tensor of shape (2,) holding the two uint32
key words; nothing here keeps random state.  A key on the CPU folds on the
host; a key on a device (or a fold of tensor data) folds there, with the
same bits, so a captured CUDA graph draws from the key in its input buffer
rather than from words frozen at capture.

On CUDA tensors the hash runs in the hand-written kernels of
``csrc/threefry.cu``, one launch per :func:`fold_in` and per
:func:`uniform` (:func:`fold_in_cuda`, :func:`uniform_words_cuda`), which
read the key words from device memory.  On the CPU the plain torch code
below (:func:`fold_in_twin`, :func:`uniform_words_twin`) computes the same
bits; the CPU tests hold it to ``jax.random`` and the card's tests and
``chip_smoke.py`` hold the kernels to it.  :data:`launches` counts the
kernel launches the wrappers make and ``words`` the floats they draw:
host integers, bumped once per call, so under CUDA graph capture once per
capture and not per replay.
"""
from __future__ import annotations

import ctypes
import math

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# the kernels of csrc/threefry.cu: launches by kind, and the floats drawn
launches = {"fold_in": 0, "uniform": 0, "words": 0}


def reset_launches() -> None:
    """Zero :data:`launches`."""
    for k in launches:
        launches[k] = 0


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


def _check_key(key) -> None:
    if not (isinstance(key, torch.Tensor) and key.dtype == torch.int64
            and tuple(key.shape) == (2,)):
        got = (f"{key.dtype} {tuple(key.shape)}"
               if isinstance(key, torch.Tensor) else type(key).__name__)
        raise ValueError(f"threefry: a key is an int64 tensor of shape (2,) "
                         f"holding two uint32 words; got {got}")


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of counts (0, data) under ``key``.
    ``data`` is an int or a 0-dim integer tensor; the result lies on the
    data's device when it is a tensor, else on the key's: on a CUDA device
    by :func:`fold_in_cuda`, else by :func:`fold_in_twin`."""
    _check_key(key)
    dev = data.device if isinstance(data, torch.Tensor) else key.device
    if dev.type == "cuda":
        return fold_in_cuda(key.to(dev), data)
    return fold_in_twin(key, data)


def fold_in_cuda(key: torch.Tensor, data) -> torch.Tensor:
    """:func:`fold_in_twin` by ``threefry_fold_in_kernel`` on the current
    stream, for a key on a CUDA device and an int datum (an argument of the
    launch) or a 0-dim integer tensor on the key's device (read there).
    Raises on what the kernel does not take, before any CUDA call."""
    _check_key(key)
    dev = key.device
    if dev.type != "cuda":
        raise ValueError(f"threefry fold_in: the kernel takes a CUDA key; "
                         f"got one on {dev}")
    if isinstance(data, torch.Tensor):
        if (data.dim() != 0 or data.device != dev or data.is_floating_point()
                or data.is_complex() or data.dtype == torch.bool):
            raise ValueError(f"threefry fold_in: tensor data must be a 0-dim "
                             f"integer tensor on {dev}; got {data.dtype} "
                             f"{tuple(data.shape)} on {data.device}")
        data = data.to(torch.int64)
        ptr, datum = data.data_ptr(), 0
    else:
        ptr, datum = None, int(data) & _M32
    from .build import load_kernel_lib
    fn = load_kernel_lib("threefry").rr_threefry_fold_in
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_uint32] \
        + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    out = torch.empty((2,), dtype=torch.int64, device=dev)
    step = key.stride(0) * key.element_size()
    with torch.cuda.device(dev):
        err = fn(key.data_ptr(), key.data_ptr() + step, ptr, datum,
                 out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry fold_in kernel launch failed: CUDA "
                           f"error {err}")
    launches["fold_in"] += 1
    return out


def fold_in_twin(key: torch.Tensor, data) -> torch.Tensor:
    """:func:`fold_in` in plain torch (or on the host, for a CPU key and an
    int datum), on any device."""
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
    _check_key(key)
    if key.device.type == "cpu":
        k1, k2 = (int(k) for k in key.tolist())
    else:
        k1, k2 = key.to(torch.int64).unbind()
    return uniform_words(k1, k2, shape, device)


def uniform_words(k1, k2, shape, device) -> torch.Tensor:
    """:func:`uniform` under key words k1, k2: ints, or 0-dim int64 tensors
    on ``device``; on a CUDA device by :func:`uniform_words_cuda`, else by
    :func:`uniform_words_twin`."""
    if torch.device(device).type == "cuda":
        return uniform_words_cuda(k1, k2, shape, device)
    return uniform_words_twin(k1, k2, shape, device)


def uniform_words_cuda(k1, k2, shape, device) -> torch.Tensor:
    """:func:`uniform_words_twin` by ``threefry_uniform_kernel`` on the
    current stream of the CUDA ``device``.  Tensor words are read on the
    device; int words (a key folded on the host) become arguments of the
    launch, which this refuses under stream capture, where they would be
    frozen into the graph.  Raises on what the kernel does not take, before
    any launch."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"threefry uniform: the kernel draws on a CUDA "
                         f"device; got {device}")
    out = torch.empty(shape, dtype=torch.float32, device=device)
    dev = out.device
    words = (k1, k2)
    if all(isinstance(w, torch.Tensor) for w in words):
        if not all(w.dim() == 0 and w.dtype == torch.int64
                   and w.device == dev for w in words):
            raise ValueError(
                f"threefry uniform: tensor key words must be 0-dim int64 "
                f"tensors on {dev}; got " + ", ".join(
                    f"{w.dtype} {tuple(w.shape)} on {w.device}"
                    for w in words))
        ptrs, imm = (k1.data_ptr(), k2.data_ptr()), (0, 0)
    elif not any(isinstance(w, torch.Tensor) for w in words):
        if torch.cuda.is_current_stream_capturing():
            raise ValueError("threefry uniform: host key words under CUDA "
                             "graph capture would be frozen into the "
                             "graph; pass the key as a device tensor")
        ptrs, imm = (None, None), (int(k1) & _M32, int(k2) & _M32)
    else:
        raise ValueError("threefry uniform: the key words are both ints or "
                         "both tensors")
    n = out.numel()
    if n == 0:
        return out
    from .build import load_kernel_lib
    fn = load_kernel_lib("threefry").rr_threefry_uniform
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_uint32] * 2 \
        + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(*ptrs, *imm, out.data_ptr(), n,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry uniform kernel launch failed: CUDA "
                           f"error {err}")
    launches["uniform"] += 1
    launches["words"] += n
    return out


def uniform_words_twin(k1, k2, shape, device) -> torch.Tensor:
    """:func:`uniform_words` in plain torch on any device."""
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k1, k2, i >> 32, i & _M32)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(floats, min=0.0).reshape(shape)
