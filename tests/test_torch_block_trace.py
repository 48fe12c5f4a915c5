"""The block walk: its host parts and its torch twin against the JAX package.

The twin (``rustray_tpu_torch.ops.block_trace._walk_twin``, what
``trace_tris_blocks`` runs on CPU tensors) is held against the JAX Pallas
kernel in interpret mode and against the dense scan, with the thresholds
of tests/test_accel.py: found masks at least 99.9% equal and the selected
triangle's t allclose at rtol=1e-4, atol=1e-5; any-hit mode compares only
the found mask (the occluder may legitimately differ), except for the
ungated walk (K2, packs over 64 MB), whose occluder is its contract.  The
CUDA kernel is held against the twin by tests/test_torch_cuda.py, which
runs on a GPU.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rustray_tpu.models.procedural import bench_scene
from rustray_tpu.ops import block_trace as j_bt
from rustray_tpu.ops import rays as j_rays
from rustray_tpu.ops.cluster_trace import world_cluster_aabbs as j_aabbs
from rustray_tpu.ops.intersect import closest_tri, prepare_triangles
from rustray_tpu_torch import to_torch
from rustray_tpu_torch.ops import block_trace as bt
from rustray_tpu_torch.ops.cluster_trace import world_cluster_aabbs
from rustray_tpu_torch.ops.intersect import INF
from rustray_tpu_torch.ops.intersect import prepare_triangles as t_prep


# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core oversubscribes them
torch.set_num_threads(1)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def accel():
    scene = bench_scene(grid=2, lat=10, lon=14, width=96, height=64,
                        monte_carlo=False, samples=1)
    sa, static = scene.compile()
    prep = prepare_triangles(sa)
    prep = prep.replace(pallas_pack=j_bt.pack_cluster_tris(
        prep, sa.tri_valid, static.n_clusters, static.cluster_size,
        int(sa.cl_lo.shape[0])))
    w_lo, w_hi = j_aabbs(sa)
    tri_ok = jnp.asarray(sa.tri_valid & sa.inst_visible[sa.tri_inst])
    cl_ok = np.asarray(sa.cl_valid & sa.inst_visible[sa.cl_inst])
    sa_t, static_t = to_torch(sa, static, "cpu")
    prep_t = t_prep(sa_t)
    prep_t = prep_t.replace(pallas_pack=bt.pack_cluster_tris(
        prep_t, sa_t.tri_valid, static.n_clusters, static.cluster_size,
        int(sa.cl_lo.shape[0])))
    return dict(sa=sa, static=static, prep=prep, w_lo=w_lo, w_hi=w_hi,
                tri_ok=tri_ok, cl_ok=cl_ok, prep_t=prep_t,
                boxes_t=world_cluster_aabbs(sa_t))


def _batches(sa, n, seed=3):
    """The camera and random ray batches of tests/test_accel.py."""
    rng = np.random.default_rng(seed)
    px = jnp.asarray(rng.integers(0, 96, n), jnp.int32)
    py = jnp.asarray(rng.integers(0, 64, n), jnp.int32)
    o_cam, d_cam = j_rays.primary_rays(sa.camera, 96, 64, px, py,
                                       jnp.int32(0), jnp.int32(0), 1,
                                       1.0, 1.0, 1)
    o_rnd = jnp.asarray(rng.uniform(-6, 6, (n, 3)), jnp.float32)
    d_rnd = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    d_rnd = d_rnd / jnp.linalg.norm(d_rnd, axis=1, keepdims=True)
    alive = rng.uniform(size=n) < 0.7
    return [("camera", np.asarray(o_cam), np.asarray(d_cam),
             np.ones((n,), bool)),
            ("random", np.asarray(o_rnd), np.asarray(d_rnd), alive)]


def _tri_t(prep, o, d, idx):
    n = np.asarray(prep.n)[idx]
    an = np.asarray(prep.an)[idx]
    dn = (np.asarray(d) * n).sum(1)
    dn = np.where(np.abs(dn) > 1e-30, dn, 1.0)
    return (an - (np.asarray(o) * n).sum(1)) / dn


def _trace(acc, o, d, alive, tmax=None, mode="closest", block_n=256):
    """The port's trace_tris_blocks on CPU tensors (the twin); returns
    numpy (found, idx, t)."""
    f, i, t = bt.trace_tris_blocks(
        _t(o), _t(d), None if alive is None else _t(alive),
        None if tmax is None else _t(tmax), acc["prep_t"], *acc["boxes_t"],
        _t(acc["cl_ok"]), acc["static"].cluster_size, block_n=block_n,
        mode=mode)
    return f.numpy(), i.numpy(), t.numpy()


def test_pack_and_world_boxes(accel):
    np.testing.assert_allclose(accel["prep_t"].pallas_pack.numpy(),
                               np.asarray(accel["prep"].pallas_pack),
                               rtol=1e-5, atol=1e-5)
    for got, ref in zip(accel["boxes_t"], (accel["w_lo"], accel["w_hi"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-6, atol=1e-6)


def test_spread3_and_coherence_key(accel):
    x = np.random.default_rng(0).integers(0, 2**12, 4096).astype(np.int32)
    np.testing.assert_array_equal(bt._spread3(_t(x)).numpy(),
                                  np.asarray(j_bt._spread3(jnp.asarray(x))))
    lo = np.asarray(accel["w_lo"]).min(0)
    hi = np.asarray(accel["w_hi"]).max(0)
    for name, o, d, alive in _batches(accel["sa"], 1024):
        ref = j_bt.coherence_key(o, d, alive, lo, hi)
        got = bt.coherence_key(_t(o), _t(d), _t(alive), _t(lo), _t(hi))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), name)


@pytest.mark.parametrize("batch", [0, 1])
def test_block_lists_match(accel, batch):
    """count, the sorted entry distances and, per block, the set of
    (cluster, quad mask) descriptors — the order among equal entry
    distances is not part of the contract."""
    name, o, d, alive = _batches(accel["sa"], 1024)[batch]
    tmax = np.where(alive, 6.0, -1.0).astype(np.float32)
    o = np.where(alive[:, None], o, bt.DEAD_ORIGIN).astype(np.float32)
    nb, cpad = 4, 128
    ref = j_bt._block_lists(o, d, alive, tmax, accel["w_lo"], accel["w_hi"],
                            jnp.asarray(accel["cl_ok"]), nb, 256, cpad)
    got = bt._block_lists(_t(o), _t(d), _t(alive), _t(tmax),
                          *accel["boxes_t"], _t(accel["cl_ok"]), nb, 256,
                          cpad)
    order_r = np.asarray(ref[0]).reshape(nb, cpad)
    entry_r = np.asarray(ref[1]).reshape(nb, cpad)
    count = np.asarray(ref[2])
    np.testing.assert_array_equal(got[2].numpy(), count)
    assert count.sum() > 0
    np.testing.assert_allclose(got[1].numpy(), entry_r, rtol=1e-6, atol=0)
    for b in range(nb):
        assert set(got[0].numpy()[b, :count[b]]) == \
            set(order_r[b, :count[b]])


@pytest.mark.parametrize("batch", [0, 1])
def test_twin_matches_kernel_and_dense(accel, batch):
    name, o, d, alive = _batches(accel["sa"], 1024)[batch]
    prep = accel["prep"]
    t_d, i_d = closest_tri(o, d, prep, accel["tri_ok"], 1024)
    found_d = (np.asarray(t_d) < 3e38) & alive
    f_j, i_j, _ = j_bt.trace_tris_blocks(
        o, d, alive, None, prep, accel["w_lo"], accel["w_hi"],
        jnp.asarray(accel["cl_ok"]), accel["static"].cluster_size,
        block_n=256, interpret=True)
    f_j = np.asarray(f_j) & alive
    f_p, i_p, t_p = _trace(accel, o, d, alive)
    f_p = f_p & alive
    for ref_f, ref_i in ((found_d, np.asarray(i_d)), (f_j, np.asarray(i_j))):
        assert (f_p == ref_f).mean() >= 0.999, name
        both = f_p & ref_f
        np.testing.assert_allclose(_tri_t(prep, o, d, i_p)[both],
                                   _tri_t(prep, o, d, ref_i)[both],
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_p[f_p], _tri_t(prep, o, d, i_p)[f_p],
                               rtol=1e-4, atol=1e-5)


def test_twin_tmax_and_anyhit(accel):
    name, o, d, alive = _batches(accel["sa"], 512)[0]
    prep = accel["prep"]
    t_d, _ = closest_tri(o, d, prep, accel["tri_ok"], 1024)
    tmax = np.full((512,), 4.0, np.float32)
    found_ref = np.asarray(t_d) < 4.0
    for mode in ("closest", "any"):
        f, i, t = _trace(accel, o, d, None, tmax, mode=mode)
        assert (f == found_ref).mean() >= 0.999, mode
        assert (_tri_t(prep, o, d, i)[f] <= 4.0 + 1e-4).all(), mode
        f_j, _, _ = j_bt.trace_tris_blocks(
            o, d, None, tmax, prep, accel["w_lo"], accel["w_hi"],
            jnp.asarray(accel["cl_ok"]), accel["static"].cluster_size,
            block_n=256, mode=mode, interpret=True)
        assert (f == np.asarray(f_j)).mean() >= 0.999, mode


@pytest.mark.parametrize("block_n", [128, 256])
def test_twin_dead_blocks(accel, block_n):
    name, o, d, _ = _batches(accel["sa"], 256)[0]
    f, _, t = _trace(accel, o, d, np.zeros((256,), bool), block_n=block_n)
    assert not f.any() and (t >= INF).all()


def test_walk_refuses_other_devices(accel):
    """No silent fallback: a tensor on neither the CPU nor CUDA raises."""
    meta = torch.empty((1, 128, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        bt.block_walk(torch.zeros(1, dtype=torch.int32, device="meta"), meta,
                      torch.zeros((1, 128), dtype=torch.int32,
                                  device="meta"),
                      torch.zeros((1, 128), device="meta"),
                      accel["prep_t"].pallas_pack.to("meta"))


def _force_ungated(monkeypatch):
    """Both packages select their large-pack walk (K2) at any pack size,
    as tests/test_accel.py:220-238 does for the JAX package."""
    monkeypatch.setattr(j_bt, "_VMEM_PACK_BUDGET", 0)
    monkeypatch.setattr(bt, "_VMEM_PACK_BUDGET", 0)


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_ungated_twin_matches_jax_k2(accel, monkeypatch, mode):
    """With the budget at 0 the port runs the ungated walk and matches the
    JAX K2 kernel (interpret): found masks and t in closest mode; found
    masks and the occluder (the group's nearest hit) in any mode."""
    _force_ungated(monkeypatch)
    prep = accel["prep"]
    for name, o, d, alive in _batches(accel["sa"], 512):
        f_j, i_j, _ = j_bt.trace_tris_blocks(
            o, d, alive, None, prep, accel["w_lo"], accel["w_hi"],
            jnp.asarray(accel["cl_ok"]), accel["static"].cluster_size,
            block_n=256, mode=mode, interpret=True)
        f_j, i_j = np.asarray(f_j) & alive, np.asarray(i_j)
        bt.reset_launches()
        f_p, i_p, t_p = _trace(accel, o, d, alive, mode=mode)
        assert bt.selected == {"gated": 0, "ungated": 1}
        assert bt.launches == bt.ungated_launches == {"closest": 0, "any": 0}
        f_p = f_p & alive
        assert (f_p == f_j).mean() >= 0.999, (name, mode)
        both = f_p & f_j
        assert both.any()
        if mode == "closest":
            np.testing.assert_allclose(_tri_t(prep, o, d, i_p)[both],
                                       _tri_t(prep, o, d, i_j)[both],
                                       rtol=1e-4, atol=1e-5)
        else:
            assert (i_p[both] == i_j[both]).mean() >= 0.999, name
        np.testing.assert_allclose(t_p[f_p], _tri_t(prep, o, d, i_p)[f_p],
                                   rtol=1e-4, atol=1e-5)


def test_gated_and_ungated_agree_in_closest_mode(accel, monkeypatch):
    """K1's quad gating never changes a closest-mode winner: the gated and
    ungated twins select the same triangles on the same rays."""
    for name, o, d, alive in _batches(accel["sa"], 512):
        bt.reset_launches()
        f_1, i_1, t_1 = _trace(accel, o, d, alive)
        with monkeypatch.context() as m:
            m.setattr(bt, "_VMEM_PACK_BUDGET", 0)
            f_2, i_2, t_2 = _trace(accel, o, d, alive)
        assert bt.selected == {"gated": 1, "ungated": 1}
        assert (f_1 == f_2).mean() >= 0.999, name
        both = f_1 & f_2
        assert (i_1[both] == i_2[both]).mean() >= 0.999, name
        np.testing.assert_allclose(t_1[both], t_2[both], rtol=1e-4,
                                   atol=1e-5)


def test_ungated_any_takes_the_groups_nearest_hit():
    """One block, one ray, a group of two slabs that both hold a hit: the
    gated walk freezes at the first slab's (farther) hit, the ungated walk
    at the group's nearest one."""
    K = 4
    pack = torch.zeros((3, 16, K))
    # slab 0: plane z = 5 (t = 5); slab 1: plane z = 2 (t = 2), lane 0
    for c, z in ((0, 5.0), (1, 2.0)):
        pack[c, 2, 0] = 1.0                     # n = (0, 0, 1)
        pack[c, 3, 0] = z                       # a.n
        pack[c, 4, 0] = 1.0                     # u = x + 0.25
        pack[c, 7, 0] = 0.25
        pack[c, 9, 0] = 1.0                     # v = y + 0.25
        pack[c, 11, 0] = 0.25
    rays = torch.zeros((1, 4, 8))
    rays[0, :, 5] = 1.0                         # d = +z, o = 0
    rays[0, :, 6] = 100.0
    count = torch.tensor([2], dtype=torch.int32)
    order = torch.tensor([[0 | (15 << 16), 1 | (15 << 16)]],
                         dtype=torch.int32)
    entry = torch.tensor([[0.0, 0.0]])
    for gated, want_t, want_i in ((True, 5.0, 0), (False, 2.0, K)):
        t, i = bt.block_walk(count, rays, order, entry, pack, "any",
                             gated=gated)
        assert (t == want_t).all() and (i == want_i).all(), gated
        t, i = bt.block_walk(count, rays, order, entry, pack, "closest",
                             gated=gated)
        assert (t == 2.0).all() and (i == K).all(), gated


def _cut_lists(acc, case):
    """Visit lists at block_n 128 for the two-pass tests.  "camera": the
    camera rays that hit, with two all-dead blocks (count 0); the any-hit
    walk stops early there.  "synthetic": hand-made lists over the pack's
    clusters (lengths 0..40, random quad masks, entry distances rising by
    up to 4 per position) for the same rays, so the early exit also cuts
    closest-mode lists."""
    _, o, d, _ = _batches(acc["sa"], 1024)[0]
    args = (*acc["boxes_t"], _t(acc["cl_ok"]), 128)
    lists = bt.prepare_walk(_t(o), _t(d), None, None, *args)
    t, _ = bt._walk_twin(*lists, acc["prep_t"].pallas_pack, "closest")
    alive = (t < INF).reshape(-1)
    alive[256:512] = False
    lists = bt.prepare_walk(_t(o), _t(d), alive, None, *args)
    if case == "camera":
        return lists
    rng = np.random.default_rng(7)
    nb, cpad = lists[2].shape
    count = rng.integers(0, 41, nb).astype(np.int32)
    count[2] = 0
    cid = rng.integers(0, acc["static"].n_clusters, (nb, cpad))
    order = cid | (rng.integers(1, 16, (nb, cpad)) << 16)
    entry = np.cumsum(rng.uniform(0, 4.0, (nb, cpad)), axis=1)
    listed = np.arange(cpad)[None] < count[:, None]
    return (_t(count), lists[1], _t(np.where(listed, order, 0)
                                    .astype(np.int32)),
            _t(np.where(listed, entry, INF).astype(np.float32)))


@pytest.mark.parametrize("case", ["camera", "synthetic"])
@pytest.mark.parametrize("mode", ["closest", "any"])
@pytest.mark.parametrize("gated", [True, False])
def test_units_twin_matches_walk_twin(accel, gated, mode, case):
    """The kernel's two-pass decomposition (pass A per unit of GROUP
    entries, pass B per block in list order) gives the serial walk's t,
    idx and visited entries bit for bit, on lists the early exit cuts and
    on blocks with count 0."""
    lists = _cut_lists(accel, case)
    count = lists[0]
    pack = accel["prep_t"].pallas_pack
    t_w, i_w, v_w = bt._walk_twin(*lists, pack, mode, gated,
                                  return_visited=True)
    t_u, i_u, v_u = bt._walk_units_twin(*lists, pack, mode, gated,
                                        return_visited=True)
    assert (count == 0).any() and bool((t_w < INF).any())
    if case == "synthetic" or mode == "any":
        assert (v_w < count).any()
    assert torch.equal(t_u, t_w) and torch.equal(i_u, i_w)
    assert torch.equal(v_u, v_w)
    t_b, i_b = bt.block_walk(*lists, pack, mode, gated=gated)
    assert torch.equal(t_b, t_w) and torch.equal(i_b, i_w)


def test_unit_list_on_hand_made_counts():
    count = torch.tensor([0, 1, 8, 9, 17, 0, 16], dtype=torch.int32)
    units, ustart = bt.unit_list(count)
    assert units.tolist() == [0, 1, 1, 2, 3, 0, 2]
    assert ustart.tolist() == [0, 1, 2, 4, 7, 7, 9]
    assert units.dtype == ustart.dtype == torch.int32
    blk, grp = bt.unit_blocks(count)
    assert blk.tolist() == [1, 2, 3, 3, 4, 4, 4, 6, 6]
    assert grp.tolist() == [0, 0, 0, 1, 0, 1, 2, 0, 1]
    blk, grp = bt.unit_blocks(torch.zeros(3, dtype=torch.int32))
    assert blk.numel() == grp.numel() == 0


def test_walk_cuda_refuses_other_slab_widths():
    """The kernel is compiled for K = 128: any other width raises before
    a build or a launch (CPU tensors reach no CUDA call)."""
    K = 64
    count = torch.zeros(1, dtype=torch.int32)
    rays = torch.zeros((1, 128, 8))
    order = torch.zeros((1, 128), dtype=torch.int32)
    entry = torch.zeros((1, 128))
    with pytest.raises(ValueError, match="K=128"):
        bt._walk_cuda(count, rays, order, entry, torch.zeros((2, 16, K)),
                      "closest")
    assert bt.launches == bt.ungated_launches == {"closest": 0, "any": 0}


def _census():
    """The port's census as {mode: (calls, blocks, entries)}."""
    return {m: (c["calls"], c["blocks"], int(c["entries"]))
            for m, c in bt.census.items()}


def test_census_matches_jax(accel, monkeypatch):
    """The census: per mode, the walks' calls, their blocks and the visit
    lists' entries, equal to the sums over the JAX package's
    RUSTRAY_TRACE_STATS tuples (mode, nb, sum, max, mean) on the same
    rays (the JAX package's through jax.debug.callback on the CPU)."""
    import jax
    monkeypatch.setenv("RUSTRAY_TRACE_STATS", "1")
    monkeypatch.setattr(j_bt, "_TRACE_STATS", [])
    bt.reset_launches()
    for name, o, d, alive in _batches(accel["sa"], 512):
        for mode in ("closest", "any"):
            j_bt.trace_tris_blocks(
                o, d, alive, None, accel["prep"], accel["w_lo"],
                accel["w_hi"], jnp.asarray(accel["cl_ok"]),
                accel["static"].cluster_size, block_n=256, mode=mode,
                interpret=True)
            _trace(accel, o, d, alive, mode=mode)
    jax.effects_barrier()
    want = {m: (0, 0, 0) for m in ("closest", "any")}
    for mode, nb, total, _, _ in j_bt._TRACE_STATS:
        c, b, e = want[mode]
        want[mode] = (c + 1, b + nb, e + total)
    assert want["closest"][0] == want["any"][0] == 2
    assert all(e > 0 for _, _, e in want.values())
    assert _census() == want


def test_census_counts_under_a_capture(accel):
    """While a capture runs (here its unconditional warm-up), the census
    counts without a host sync and without raising: the same counts as
    the eager walks on the same rays."""
    from rustray_tpu_torch import graphs
    counts = []
    for unconditional in (False, True):
        bt.reset_launches()
        for _, o, d, alive in _batches(accel["sa"], 64):
            if unconditional:
                with graphs.unconditional():
                    _trace(accel, o, d, alive)
            else:
                _trace(accel, o, d, alive)
        counts.append(_census())
    assert counts[0] == counts[1]
    assert counts[0]["closest"][0] == 2 and counts[0]["closest"][2] > 0


def test_block_lists_run_the_twin_on_cpu(accel, monkeypatch):
    """On CPU tensors, and under ``interpret=True``, the lists come from
    the torch twin: the CUDA wrapper is never called and no list launch is
    counted."""
    calls = []
    twin = bt._list_keys_twin

    def counted_twin(*args):
        calls.append(args[7])
        return twin(*args)

    def no_kernel(*args, **kw):
        raise AssertionError("the CUDA list kernel was called")

    monkeypatch.setattr(bt, "_list_keys_twin", counted_twin)
    monkeypatch.setattr(bt, "_list_keys_cuda", no_kernel)
    bt.reset_launches()
    _, o, d, alive = _batches(accel["sa"], 512)[1]
    args = (*accel["boxes_t"], _t(accel["cl_ok"]), 128)
    for interpret in (False, True):
        count, _, order, entry = bt.prepare_walk(
            _t(o), _t(d), _t(alive), None, *args, mode="any",
            interpret=interpret)
        assert count.shape == (4,) and int(count.sum()) > 0
    for mode in ("closest", "any"):
        _trace(accel, o, d, alive, mode=mode)
    assert calls == [4, 4, 2, 2]
    assert bt.list_launches == {"closest": 0, "any": 0}


def _list_args(n=512, block=128, dtype=torch.float32, C=8):
    """CPU inputs of the list kernel's wrapper: n rays, C boxes."""
    return (torch.zeros((n, 3), dtype=dtype), torch.ones((n, 3)),
            torch.ones((n,), dtype=torch.bool), torch.ones((n,)),
            torch.zeros((C, 3)), torch.ones((C, 3)),
            torch.ones((C,), dtype=torch.bool), n // block, block)


@pytest.mark.parametrize("case,match", [
    ("refine2", "4 sub-blocks"), ("block130", "4 sub-blocks"),
    ("block2048", "at most 1024"), ("f64", "o must be"),
    ("strided", "w_lo must be"), ("cl_ok_u8", "cl_ok must be")])
def test_list_kernel_refuses_what_it_does_not_take(case, match):
    """The CUDA wrapper raises on a call the kernel does not take (another
    sub-block count, a block over 1024 rays, another type or a strided
    tensor) before it builds or launches anything, so the checks run
    without a card; the twin takes every one of the sub-block counts."""
    kw = {}
    if case == "refine2":
        args = _list_args()
        kw["refine"] = 2
    elif case == "block130":
        args = _list_args(n=520, block=130)
    elif case == "block2048":
        args = _list_args(n=2048, block=2048)
    elif case == "f64":
        args = _list_args(dtype=torch.float64)
    elif case == "strided":
        args = list(_list_args())
        args[4] = torch.zeros((3, 8)).t()
        args = tuple(args)
    else:
        args = list(_list_args())
        args[6] = torch.ones((8,), dtype=torch.uint8)
        args = tuple(args)
    bt.reset_launches()
    with pytest.raises(ValueError, match=match):
        bt._list_keys_cuda(*args, **kw)
    assert bt.list_launches == {"closest": 0, "any": 0}
    if case in ("refine2", "block130"):
        key, cid, count = bt._list_keys_twin(*args, **kw)
        assert ((cid >> 16) == 15).all() and (count == 8).all()
