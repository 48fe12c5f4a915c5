"""The block-list kernel (csrc/block_lists.cu) on a GPU, against its twin.

The kernel computes the interval test of ``ops/block_trace._block_lists``
(every ray block against every cluster box); ``_list_keys_twin`` is its
plain torch version.  On the same CUDA inputs the kernel's keys,
descriptors and counts, and so the sorted visit lists, must equal the
twin's bit for bit.  These tests build the kernel with nvcc and skip
without a card; they import only the port:

    python -m pytest tests/test_torch_block_lists.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from rustray_tpu_torch import EngineConfig, render, to_torch
from rustray_tpu_torch.models.procedural import bench_scene
from rustray_tpu_torch.ops import block_trace as bt
from rustray_tpu_torch.ops.cluster_trace import world_cluster_aabbs

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs an NVIDIA GPU: the CUDA kernel has no "
                       "CPU mode"),
]


@pytest.fixture(scope="module")
def boxes():
    """The bench scene's cluster boxes (2,593 clusters in 2,600 rows, the
    padding rows not ok), a fifth of the clusters also not ok."""
    sc = bench_scene(grid=6, lat=52, lon=68, width=128, height=72)
    sa, _ = to_torch(*sc.compile(), "cuda")
    w_lo, w_hi = world_cluster_aabbs(sa)
    rng = np.random.default_rng(11)
    off = torch.tensor(rng.uniform(size=w_lo.shape[0]) < 0.2, device="cuda")
    return w_lo, w_hi, sa.cl_valid & ~off


def _rays(boxes, nb, block_n, kind, seed):
    """Coherent blocks of rays over the scene: per block an origin and a
    direction, jittered per ray, so that most sub-blocks have one sign per
    axis as coherence-sorted rays do.  A fifth of the blocks are
    incoherent, a tenth all dead, 30% of the other lanes dead; a tenth of
    the blocks have one direction component under 1e-12 in every ray (0.0,
    -0.0, 1e-13 or -1e-13), and a tenth have their origins on a cluster's
    box planes.  Block 0 is none of these: its live rays start 2 units
    from an ok cluster's centre and head for it.  ``kind`` "closest" gives
    no t_max, "shadow" a t_max of 0.1-30 per ray."""
    w_lo, w_hi, cl_ok = boxes
    rng = np.random.default_rng(seed)
    lo = w_lo.amin(0).cpu().numpy()
    hi = w_hi.amax(0).cpu().numpy()
    n = nb * block_n
    blk = np.repeat(np.arange(nb), block_n)
    o = rng.uniform(lo, hi, (nb, 3))[blk] + rng.normal(0, 0.3, (n, 3))
    d = rng.normal(size=(nb, 3))[blk] + rng.normal(0, 0.05, (n, 3))
    wild = (rng.uniform(size=nb) < 0.2)[blk]
    d[wild] = rng.normal(size=(int(wild.sum()), 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tiny = rng.uniform(size=nb) < 0.1
    for b in np.flatnonzero(tiny):
        d[blk == b, rng.integers(3)] = rng.choice([0.0, -0.0, 1e-13, -1e-13])
    plane = np.flatnonzero(rng.uniform(size=nb) < 0.1)
    corners = np.concatenate([w_lo.cpu().numpy(), w_hi.cpu().numpy()])
    for b in plane:
        o[blk == b] = corners[rng.integers(len(corners))]
    alive = rng.uniform(size=n) < 0.7
    alive[(rng.uniform(size=nb) < 0.1)[blk]] = False
    ok = np.flatnonzero(cl_ok.cpu().numpy())
    centre = 0.5 * (w_lo + w_hi)[rng.choice(ok)].cpu().numpy()
    aim = rng.normal(size=3)
    aim /= np.linalg.norm(aim)
    o[:block_n] = centre - 2.0 * aim + rng.normal(0, 0.05, (block_n, 3))
    d[:block_n] = aim + rng.normal(0, 0.02, (block_n, 3))
    d[:block_n] /= np.linalg.norm(d[:block_n], axis=1, keepdims=True)
    alive[:block_n] = rng.uniform(size=block_n) < 0.7
    o = torch.tensor(o, dtype=torch.float32, device="cuda")
    d = torch.tensor(d, dtype=torch.float32, device="cuda")
    alive = torch.tensor(alive, device="cuda")
    t_max = None
    if kind == "shadow":
        t_max = torch.tensor(rng.uniform(0.1, 30.0, n), dtype=torch.float32,
                             device="cuda")
    return bt.pad_rays(o, d, alive, t_max, block_n)


@pytest.mark.parametrize("block_n,nb", [(128, 1), (128, 333), (128, 6144),
                                        (512, 1), (512, 96), (512, 1536)])
@pytest.mark.parametrize("kind", ["closest", "shadow"])
def test_kernel_matches_twin(boxes, block_n, nb, kind):
    """Keys, descriptors and counts of the kernel equal the twin's, and so
    do the sorted lists (order, entry, count) padded to cpad > C; one
    launch counted, the twin none."""
    w_lo, w_hi, cl_ok = boxes
    o, d, alive, t_max, nb_ = _rays(boxes, nb, block_n, kind, seed=nb)
    assert nb_ == nb
    args = (o, d, alive, t_max, w_lo, w_hi, cl_ok, nb, block_n)
    before = bt.list_launches["any"]
    key_k, cid_k, count_k = bt._list_keys_cuda(*args, mode="any")
    assert bt.list_launches["any"] == before + 1
    key_t, cid_t, count_t = bt._list_keys_twin(*args)
    torch.cuda.synchronize()
    assert torch.equal(count_k, count_t)
    assert torch.equal(cid_k, cid_t)
    assert torch.equal(key_k.view(torch.int32), key_t.view(torch.int32))
    assert int(count_t[0]) > 0
    cpad = -(-w_lo.shape[0] // 128) * 128
    assert cpad > w_lo.shape[0]
    got = bt._block_lists(*args, cpad)
    want = bt._block_lists(*args, cpad, interpret=True)
    assert bt.list_launches["any"] == before + 1
    assert bt.list_launches["closest"] > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_dead_blocks_and_unusable_axes_take_the_twins_path(boxes):
    """The kernel's shortcuts against the twin: whole dead blocks (count
    0, keys INF, descriptors c), and blocks whose every axis is unusable
    (|d| under 1e-12: every ok cluster within t_max listed at entry 0)."""
    w_lo, w_hi, cl_ok = boxes
    nb, block_n = 4, 128
    n = nb * block_n
    o = torch.zeros((n, 3), device="cuda")
    d = torch.zeros((n, 3), device="cuda")
    alive = torch.ones((n,), dtype=torch.bool, device="cuda")
    alive[:block_n] = False
    alive[2 * block_n:2 * block_n + 7] = False
    o, d, alive, t_max, _ = bt.pad_rays(o, d, alive, None, block_n)
    args = (o, d, alive, t_max, w_lo, w_hi, cl_ok, nb, block_n)
    key_k, cid_k, count_k = bt._list_keys_cuda(*args)
    key_t, cid_t, count_t = bt._list_keys_twin(*args)
    torch.cuda.synchronize()
    assert torch.equal(key_k.view(torch.int32), key_t.view(torch.int32))
    assert torch.equal(cid_k, cid_t) and torch.equal(count_k, count_t)
    C = w_lo.shape[0]
    assert int(count_k[0]) == 0
    assert torch.equal(cid_k[0], torch.arange(C, dtype=torch.int32,
                                              device="cuda"))
    assert int(count_k[1]) == int(cl_ok.sum())


def _frame_scene():
    sc = bench_scene(grid=2, lat=10, lon=14, width=96, height=64,
                     monte_carlo=True, samples=2)
    sa, static = to_torch(*sc.compile(), "cuda")
    return sa, static, sc.raytracing_config


@pytest.mark.parametrize("algo", ["block", "octet"])
def test_list_launches_equal_walk_launches(algo):
    """In an eager and in a replayed frame, each walk's lists come from
    one launch of the list kernel: list_launches equals launches +
    ungated_launches, per mode."""
    from rustray_tpu_torch.render import wavefront
    sa, static, cfg = _frame_scene()
    eng = EngineConfig(accel="on", chunk_pixels=2048, pallas_algo=algo)
    wavefront._RENDERER_CACHE.clear()
    render(sa, static, cfg, eng)

    def counted(capture):
        bt.reset_launches()
        if capture:
            render(sa, static, cfg, eng)
        else:
            with wavefront.eager():
                render(sa, static, cfg, eng)
        return (dict(bt.list_launches), dict(bt.launches),
                dict(bt.ungated_launches))

    try:
        for capture in (True, False):
            lists, k1, k2 = counted(capture)
            assert lists == {m: k1[m] + k2[m] for m in lists}, capture
            if algo == "block":
                assert lists["closest"] > 0 and lists["any"] > 0, capture
    finally:
        wavefront._RENDERER_CACHE.clear()
