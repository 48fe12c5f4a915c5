"""The threefry generator of the port (``rustray_tpu_torch/rng.py``).

On CUDA tensors ``fold_in`` and ``uniform`` launch the kernels of
``csrc/threefry.cu``; on the CPU they run the plain torch twin.

CPU part (counts in tier-1): the twin's ``fold_in`` and ``uniform_words``
against ``jax.random`` bit for bit under keys with extreme words, at sizes
that are no multiple of the kernel's vector width (0, 1, 3, 5, 4,097), with
tensor and int fold data giving one key; the wrappers' argument checks
(ValueError before any CUDA call); CPU tensors launch nothing.

CUDA part (``cuda`` marker; skips without a card): the kernels bit for bit
against the twin on the card at the still frame's shapes (a chunk of
65,536 pixels at queue factors 1 and 4, with 3 lights) and at the odd
sizes, from device keys and from host key words, the launch counter, and a
captured CUDA graph whose key buffer is rewritten between replays:

    python -m pytest tests/test_torch_rng.py -q -m cuda

This file imports JAX only inside the CPU tests, so the card's tests run
where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from rustray_tpu_torch import rng

torch.set_num_threads(1)

M32 = 0xFFFFFFFF
KEYS = [(0, 0), (M32, M32), (0, 2 ** 31 - 1)]
ODD_SIZES = [0, 1, 3, 5, 4097]
STILL_SHAPES = [(65536, 2), (262144, 2), (65536, 3, 2), (262144, 3, 2)]
needs_card = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs an NVIDIA GPU: the CUDA kernel "
                                "has no CPU mode")


def _jax_key(words):
    import jax.numpy as jnp
    return jnp.asarray(np.array(words, dtype=np.uint32))


def _jax_uniform(words, shape):
    import jax
    import jax.numpy as jnp
    return np.asarray(jax.random.uniform(_jax_key(words), shape,
                                         jnp.float32))


def _jax_fold_in(words, data):
    import jax
    return np.asarray(jax.random.fold_in(_jax_key(words), data)).astype(
        np.int64)


def _bits(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                      np.float32).view(np.uint32)


# ---------------------------------------------------------------- the twin

@pytest.mark.parametrize("n", ODD_SIZES)
@pytest.mark.parametrize("words", KEYS, ids=["zero", "ones", "max_i32"])
def test_twin_uniform_extreme_keys_odd_sizes(words, n):
    """uniform_words and uniform under a key of extreme words, n floats."""
    ref = _jax_uniform(words, (n,))
    key = torch.tensor(words, dtype=torch.int64)
    by_words = rng.uniform_words_twin(*words, (n,), "cpu")
    by_tensors = rng.uniform_words(*key.unbind(), (n,), "cpu")
    by_key = rng.uniform(key, (n,), "cpu")
    for got in (by_words, by_tensors, by_key):
        assert got.shape == (n,) and got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("shape", [(5, 3, 2), (1, 1), (4097, 3)])
def test_twin_uniform_shapes(shape):
    """Row-major counters over a multi-dimensional shape."""
    words = (0x9E3779B9, 0x7F4A7C15)
    got = rng.uniform(torch.tensor(words, dtype=torch.int64), shape, "cpu")
    np.testing.assert_array_equal(_bits(got), _bits(_jax_uniform(words,
                                                                 shape)))


@pytest.mark.parametrize("words", KEYS, ids=["zero", "ones", "max_i32"])
def test_twin_fold_in_extreme_keys(words):
    """Int and tensor fold data (int64 and int32) give the same key, and
    jax.random's, under a key of extreme words; a folded key draws
    jax.random's floats."""
    key = torch.tensor(words, dtype=torch.int64)
    for data in (0, 1, 17, 23, 2 ** 31 - 1, M32):
        ref = _jax_fold_in(words, data)
        host = rng.fold_in(key, data)
        np.testing.assert_array_equal(host.numpy(), ref)
        for dt in (torch.int64, torch.int32):
            if dt == torch.int32 and data > 2 ** 31 - 1:
                continue
            tens = rng.fold_in(key, torch.tensor(data, dtype=dt))
            np.testing.assert_array_equal(tens.numpy(), ref)
        np.testing.assert_array_equal(
            rng.fold_in_twin(key, data).numpy(), ref)
    folded = tuple(int(w) for w in _jax_fold_in(words, 23))
    np.testing.assert_array_equal(
        _bits(rng.uniform(rng.fold_in(key, 23), (5, 2), "cpu")),
        _bits(_jax_uniform(folded, (5, 2))))


BAD_KEYS = {
    "int32": torch.tensor([1, 2], dtype=torch.int32),
    "three_words": torch.tensor([1, 2, 3], dtype=torch.int64),
    "row": torch.tensor([[1, 2]], dtype=torch.int64),
    "float": torch.tensor([1.0, 2.0]),
    "list": [1, 2],
}


@pytest.mark.parametrize("call", ["fold_in", "uniform", "fold_in_cuda"])
@pytest.mark.parametrize("bad", list(BAD_KEYS))
def test_wrappers_refuse_bad_keys(call, bad):
    """A key that is not a (2,) int64 tensor raises ValueError, on every
    path, before any hash or CUDA call."""
    key = BAD_KEYS[bad]
    with pytest.raises(ValueError, match="int64 tensor of shape"):
        if call == "fold_in":
            rng.fold_in(key, 3)
        elif call == "uniform":
            rng.uniform(key, (4,), "cpu")
        else:
            rng.fold_in_cuda(key, 3)


def test_cuda_wrappers_refuse_cpu_keys_and_devices():
    """The kernel wrappers raise ValueError on a CPU key or a CPU device,
    before any CUDA call."""
    key = rng.PRNGKey(7)
    with pytest.raises(ValueError, match="CUDA key"):
        rng.fold_in_cuda(key, 3)
    with pytest.raises(ValueError, match="CUDA key"):
        rng.fold_in_cuda(key, torch.tensor(3))
    with pytest.raises(ValueError, match="CUDA device"):
        rng.uniform_words_cuda(1, 2, (4,), "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        rng.uniform_words_cuda(*key.unbind(), (4,), torch.device("cpu"))


def test_cpu_tensors_launch_nothing():
    """fold_in and uniform on CPU tensors take the twin: the kernel counter
    stays at zero."""
    rng.reset_launches()
    key = rng.fold_in(rng.fold_in(rng.PRNGKey(3), 65536), torch.tensor(2))
    rng.uniform(key, (33, 3, 2), "cpu")
    rng.uniform_words(*key.unbind(), (7,), "cpu")
    assert rng.launches == {"fold_in": 0, "uniform": 0, "words": 0}


# --------------------------------------------------------------- the card

def _twin_draw(key, shape):
    return rng.uniform_words_twin(*key.unbind(), shape, key.device)


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("shape", STILL_SHAPES)
def test_kernel_uniform_equals_twin_at_still_shapes(shape):
    """A level's jitter draws at the still frame's shapes, from a device
    key (the captured program's) and from host words (the eager gradient's
    chunk key): bit for bit the twin's on the card."""
    for seed in (0, 2 ** 31 + 12345, 2 ** 32 - 1):
        host_key = rng.fold_in(rng.PRNGKey(seed), 65536)
        dev_key = host_key.cuda()
        want = _twin_draw(dev_key, shape)
        got = rng.uniform(dev_key, shape, "cuda")
        got_host = rng.uniform(host_key, shape, "cuda")
        torch.cuda.synchronize()
        assert got.shape == shape and got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(got_host.view(torch.int32),
                           want.view(torch.int32))


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("n", ODD_SIZES + [2 ** 20 + 7])
def test_kernel_uniform_odd_sizes(n):
    """Sizes that end in a ragged group, and n = 0, under extreme keys."""
    for words in KEYS:
        key = torch.tensor(words, dtype=torch.int64, device="cuda")
        rng.reset_launches()
        got = rng.uniform(key, (n,), "cuda")
        assert rng.launches == {"fold_in": 0, "uniform": int(n > 0),
                                "words": n}
        want = _twin_draw(key, (n,))
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@needs_card
def test_kernel_fold_in_equals_twin():
    """fold_in on the card, with int data and with 0-dim int64 and int32
    tensor data, under extreme and drawn keys, and a tensor key's view of
    a (S, 2) key table: the twin's words."""
    keys = [torch.tensor(w, dtype=torch.int64, device="cuda") for w in KEYS]
    table = torch.tensor([[5, 6], [7, M32]], dtype=torch.int64,
                         device="cuda")
    keys += [table[1], rng.fold_in(rng.PRNGKey(9), 3).cuda()]
    rng.reset_launches()
    calls = 0
    for key in keys:
        for data in (0, 1, 4, 17, 23, 65536, M32):
            want = rng.fold_in_twin(key, data)
            got = rng.fold_in(key, data)
            assert got.device == key.device
            assert torch.equal(got, want), (key, data)
            for dt in (torch.int64, torch.int32):
                if dt == torch.int32 and data > 2 ** 31 - 1:
                    continue
                d = torch.tensor(data, dtype=dt, device="cuda")
                assert torch.equal(rng.fold_in(key, d), want)
                calls += 1
            calls += 1
    assert rng.launches["fold_in"] == calls
    # a CPU key folding CUDA tensor data folds on the data's device
    got = rng.fold_in(rng.PRNGKey(4), torch.tensor(23, device="cuda"))
    assert got.is_cuda and torch.equal(
        got.cpu(), rng.fold_in(rng.PRNGKey(4), 23))


@pytest.mark.cuda
@needs_card
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """Tensor data that is not a 0-dim integer, words that mix ints and
    tensors or are not int64, raise ValueError before any launch."""
    key = rng.PRNGKey(7).cuda()
    rng.reset_launches()
    for data in (torch.tensor([3], device="cuda"),
                 torch.tensor(3.0, device="cuda"), torch.tensor(3)):
        with pytest.raises(ValueError, match="0-dim integer"):
            rng.fold_in_cuda(key, data)
    k1, k2 = key.unbind()
    for words in ((int(k1), k2), (k1, int(k2)), (k1.int(), k2.int()),
                  (k1.cpu(), k2.cpu())):
        with pytest.raises(ValueError, match="both|0-dim int64"):
            rng.uniform_words_cuda(*words, (4,), "cuda")
    assert rng.launches == {"fold_in": 0, "uniform": 0, "words": 0}


@pytest.mark.cuda
@needs_card
def test_kernel_in_a_graph_reads_the_rewritten_key():
    """A captured graph of a level's draws (fold_in by an int, then two
    uniforms) reads its key from the input buffer: each replay after the
    buffer is rewritten equals the twin under the new key."""
    buf = torch.zeros(2, dtype=torch.int64, device="cuda")

    def program():
        lkey = rng.fold_in(buf, 3)
        return (rng.uniform(rng.fold_in(lkey, 17), (4097, 2), "cuda"),
                rng.uniform(rng.fold_in(lkey, 23), (4097, 3, 2), "cuda"))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        program()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = program()
    for seed in (1, 2 ** 31 + 7):
        key = rng.fold_in(rng.PRNGKey(seed), 65536)
        buf.copy_(key.cuda())
        graph.replay()
        torch.cuda.synchronize()
        lkey = rng.fold_in_twin(key.cuda(), 3)
        for out, data in zip(outs, (17, 23)):
            want = _twin_draw(rng.fold_in_twin(lkey, data), out.shape)
            assert torch.equal(out.view(torch.int32), want.view(torch.int32))
