"""The port's CUDA kernels on a GPU, against their torch twins.

These tests need an NVIDIA GPU with nvcc: they build the kernels of
``rustray_tpu_torch/csrc/`` (the block walk, gated and ungated; the two
octet rounds; the octet bench variants) and skip without a card.  They
import only the port (no JAX package), so they run on a machine without
JAX or flax:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Thresholds of tests/test_accel.py: found masks at least 99.9% equal and t
allclose at rtol=1e-4, atol=1e-5; renders: color within rtol=2e-3,
atol=2e-3 on at least 99.5% of pixels and object ids equal on at least
99.5%.  The octet rounds, the walk and the octet bench are held to their
twins exactly.
"""
import numpy as np
import pytest
import torch

from rustray_tpu_torch import EngineConfig, render, to_torch
from rustray_tpu_torch.models.procedural import bench_scene
from rustray_tpu_torch.ops import block_trace as bt
from rustray_tpu_torch.ops import octet_trace as ot
from rustray_tpu_torch.ops import rays
from rustray_tpu_torch.ops.intersect import INF, safe_normalize
from rustray_tpu_torch.render.wavefront import prepare_frame

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs an NVIDIA GPU: the CUDA kernel has no "
                       "CPU mode"),
]

W, H = 96, 64


@pytest.fixture(scope="module")
def scene():
    sc = bench_scene(grid=2, lat=10, lon=14, width=W, height=H,
                     monte_carlo=True, samples=2)
    sa, static = to_torch(*sc.compile(), "cuda")
    return sa, static, sc.raytracing_config


def _batches(sa, n, seed=3):
    """Camera rays and random rays (30% dead), as in tests/test_accel.py."""
    rng = np.random.default_rng(seed)
    px = torch.tensor(rng.integers(0, W, n), dtype=torch.int32, device="cuda")
    py = torch.tensor(rng.integers(0, H, n), dtype=torch.int32, device="cuda")
    o_cam, d_cam = rays.primary_rays(sa.camera, W, H, px, py, 0, 0, 1, 1.0,
                                     1.0, 1)
    o_rnd = torch.tensor(rng.uniform(-6, 6, (n, 3)), dtype=torch.float32,
                         device="cuda")
    d_rnd = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32,
                         device="cuda")
    alive = torch.tensor(rng.uniform(size=n) < 0.7, device="cuda")
    return [(o_cam, safe_normalize(d_cam), torch.ones_like(alive)),
            (o_rnd, safe_normalize(d_rnd), alive)]


def _agree(t_k, i_k, t_p, i_p):
    torch.cuda.synchronize()
    f_k, f_p = t_k < INF, t_p < INF
    assert (f_k == f_p).float().mean() >= 0.999
    both = f_k & f_p
    torch.testing.assert_close(t_k[both], t_p[both], rtol=1e-4, atol=1e-5)
    if both.any():
        assert (i_k[both] == i_p[both]).float().mean() >= 0.999


@pytest.mark.parametrize("gated", [True, False])
def test_kernel_matches_twin(scene, gated):
    """Both modes of the gated (K1) and ungated (K2) walk on the same visit
    lists, with the entries each block visited equal to the twin's; each
    kernel call counts one launch of its variant, the twin none."""
    sa, static, _ = scene
    prep, (w_lo, w_hi) = prepare_frame(sa, static,
                                       EngineConfig(accel="on"))
    count = bt.launches if gated else bt.ungated_launches
    for o, d, alive in _batches(sa, 1024):
        lists = bt.prepare_walk(o, d, alive, None, w_lo, w_hi, sa.cl_valid,
                                128)
        for mode in ("closest", "any"):
            before = count[mode]
            t_k, i_k, v_k = bt.block_walk(*lists, prep.pallas_pack, mode,
                                          gated=gated, return_visited=True)
            assert count[mode] == before + 1
            t_p, i_p, v_p = bt.block_walk(*lists, prep.pallas_pack, mode,
                                          interpret=True, gated=gated,
                                          return_visited=True)
            assert count[mode] == before + 1
            _agree(t_k, i_k, t_p, i_p)
            assert torch.equal(v_k, v_p)


def _tool_batches(sa, n=4096):
    """validate_accel's random and half-dead batches, drawn as the tool
    draws them (after its camera batch)."""
    from rustray_tpu_torch.tools.validate_accel import _batch
    rng = np.random.default_rng(0)
    _batch("camera", rng, n, sa, "cuda")
    return [_batch(k, rng, n, sa, "cuda") for k in ("random", "halfdead")]


def test_k1_block512_matches_twin(scene):
    """K1 at block_n 512 (pass A's pair compaction at 128 pairs per stage,
    its shared memory at 128 KB) on random and half-dead rays: t, winners
    and visited entries equal to the twin's, both modes."""
    sa, static, _ = scene
    prep, (w_lo, w_hi) = prepare_frame(sa, static,
                                       EngineConfig(accel="on"))
    for o, d, alive in _tool_batches(sa):
        lists = bt.prepare_walk(o, d, alive, None, w_lo, w_hi, sa.cl_valid,
                                512)
        for mode in ("closest", "any"):
            t_k, i_k, v_k = bt.block_walk(*lists, prep.pallas_pack, mode,
                                          return_visited=True)
            t_p, i_p, v_p = bt.block_walk(*lists, prep.pallas_pack, mode,
                                          interpret=True,
                                          return_visited=True)
            torch.cuda.synchronize()
            found = t_p < INF
            assert torch.equal(t_k, t_p) and torch.equal(v_k, v_p)
            assert torch.equal(i_k[found], i_p[found])


def test_octets_on_random_rays_match_twin(scene):
    """K3 (trace_tris_octets, with its K1 fallback) on the random batch:
    t bit for bit and the same winners as the twin."""
    sa, static, _ = scene
    prep, (w_lo, w_hi) = prepare_frame(sa, static,
                                       EngineConfig(accel="on"))
    o, d, alive = _tool_batches(sa)[0]
    before = ot.launches[1]
    f_k, i_k, t_k = ot.trace_tris_octets(o, d, alive, None, prep, w_lo,
                                         w_hi, sa.cl_valid,
                                         static.cluster_size)
    assert ot.launches[1] > before
    f_p, i_p, t_p = ot.trace_tris_octets(o, d, alive, None, prep, w_lo,
                                         w_hi, sa.cl_valid,
                                         static.cluster_size, interpret=True)
    torch.cuda.synchronize()
    assert torch.equal(t_k, t_p) and torch.equal(f_k, f_p)
    assert torch.equal(i_k[f_p], i_p[f_p])


@pytest.mark.parametrize("slots", [1, 4])
def test_octet_round_matches_twin(scene, slots):
    """The fused round kernels against their twins, exactly: round 0
    (``slots`` 1: e, c0, t, idx) and round 1 (``slots`` 4: t, idx, over,
    slots, remaining, both modes) on the twin's round-0 outputs; each
    kernel call counts one launch, the twin none."""
    sa, static, _ = scene
    prep, (w_lo, w_hi) = prepare_frame(sa, static,
                                       EngineConfig(accel="on"))
    pack = prep.pallas_pack
    for o, d, alive in _batches(sa, 1024):
        tmax = torch.where(alive, INF, -1.0)
        o = torch.where(alive[:, None], o, bt.DEAD_ORIGIN)
        d = torch.where(alive[:, None], d, 1.0)
        r0 = ot.round0(o, d, tmax, w_lo, w_hi, sa.cl_valid, pack,
                       interpret=True)
        for mode in ("closest", "any") if slots == 4 else (None,):
            before = ot.launches[slots]
            if slots == 1:
                got = ot.round0(o, d, tmax, w_lo, w_hi, sa.cl_valid, pack)
                want = r0
            else:
                got = ot.round1(o, d, tmax, *r0, pack, mode)
                want = ot.round1(o, d, tmax, *r0, pack, mode,
                                 interpret=True)
            assert ot.launches[slots] == before + 1
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w)


def test_octet_rounds_stage_boxes_in_chunks(scene):
    """More clusters than one shared-memory stage of round 0 holds (4,096):
    the scene's clusters repeated past 4,200, both rounds still equal to
    their twins."""
    sa, static, _ = scene
    prep, (w_lo, w_hi) = prepare_frame(sa, static,
                                       EngineConfig(accel="on"))
    pack = prep.pallas_pack
    real = pack.shape[0] - 1
    reps = 4200 // real + 1
    pack = torch.cat([pack[:real]] * reps + [pack[-1:]])
    boxes = (w_lo[:real].repeat(reps, 1).contiguous(),
             w_hi[:real].repeat(reps, 1).contiguous())
    cl_ok = sa.cl_valid[:real].repeat(reps)
    for o, d, alive in _batches(sa, 1024):
        tmax = torch.where(alive, INF, -1.0)
        o = torch.where(alive[:, None], o, bt.DEAD_ORIGIN)
        d = torch.where(alive[:, None], d, 1.0)
        r0 = ot.round0(o, d, tmax, *boxes, cl_ok, pack, interpret=True)
        pairs = [(ot.round0(o, d, tmax, *boxes, cl_ok, pack), r0)]
        for mode in ("closest", "any"):
            pairs.append((ot.round1(o, d, tmax, *r0, pack, mode),
                          ot.round1(o, d, tmax, *r0, pack, mode,
                                    interpret=True)))
        torch.cuda.synchronize()
        for got, want in pairs:
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w)


def test_octet_bench_variants_match_twins(scene):
    """Every K4 variant against its twin on the probe rays (every variant
    finds hits there) with the last 28 of 128 octets past nlive, exactly:
    t and idx equal."""
    from rustray_tpu_torch.tools import octet_kernel_bench as okb
    sa, static, _ = scene
    prep, boxes = prepare_frame(sa, static, EngineConfig(accel="on"))
    _, rays_, aabb = okb.probe_inputs(sa, boxes, 1024)
    nlive = torch.tensor([100], dtype=torch.int32, device="cuda")
    assert prep.pallas_pack.shape[0] >= 16
    for v in okb.VARIANTS:
        before = okb.launches[v]
        t_k, i_k = okb.bench_kernel(nlive, rays_, aabb, prep.pallas_pack, v)
        t_p, i_p = okb.bench_kernel(nlive, rays_, aabb, prep.pallas_pack, v,
                                    interpret=True)
        assert okb.launches[v] == before + 1
        torch.cuda.synchronize()
        assert torch.equal(t_k, t_p) and torch.equal(i_k, i_p), v
        assert v == "v1" or bool((t_k < INF).any()), v
        assert bool((t_k[800:] >= INF).all())


def test_octet_bench_stages_boxes_in_chunks(scene):
    """A box table wider than one shared-memory stage (4,096 clusters):
    the table's columns repeated to 4,480, every variant still equal to
    its twin."""
    from rustray_tpu_torch.tools import octet_kernel_bench as okb
    sa, static, _ = scene
    prep, boxes = prepare_frame(sa, static, EngineConfig(accel="on"))
    nlive, rays_, aabb = okb.probe_inputs(sa, boxes, 1024)
    reps = -(-4480 // aabb.shape[1])
    aabb = aabb.repeat(1, reps)[:, :4480].contiguous()
    for v in okb.VARIANTS:
        t_k, i_k = okb.bench_kernel(nlive, rays_, aabb, prep.pallas_pack, v)
        t_p, i_p = okb.bench_kernel(nlive, rays_, aabb, prep.pallas_pack, v,
                                    interpret=True)
        torch.cuda.synchronize()
        assert torch.equal(t_k, t_p) and torch.equal(i_k, i_p), v


def test_render_through_kernel_matches_twin(scene):
    """A 2-spp Monte-Carlo render through the kernel against the same
    render through the twin; both modes of the kernel launch."""
    sa, static, cfg = scene
    bt.reset_launches()
    k_out = render(sa, static, cfg,
                   EngineConfig(accel="on", chunk_pixels=4096))
    launches = dict(bt.launches)
    p_out = render(sa, static, cfg,
                   EngineConfig(accel="on", chunk_pixels=4096, pallas="on",
                                pallas_interpret=True))
    assert launches["closest"] > 0 and launches["any"] > 0
    assert bt.launches == launches
    frac = np.isclose(k_out["color"], p_out["color"], rtol=2e-3,
                      atol=2e-3).mean()
    assert frac >= 0.995, frac
    assert (k_out["object_id"] == p_out["object_id"]).mean() >= 0.995
    assert k_out["dropped_rays"] == 0


def test_octet_render_through_kernels_matches_block_walk(scene):
    """pallas_algo="octet" through the round kernels (and the block walk
    as its fallback) against the default block walk."""
    sa, static, cfg = scene
    ot.reset_counts()
    o_out = render(sa, static, cfg, EngineConfig(
        accel="on", chunk_pixels=4096, pallas_algo="octet"))
    assert ot.launches[1] > 0 and ot.launches[4] > 0
    b_out = render(sa, static, cfg,
                   EngineConfig(accel="on", chunk_pixels=4096))
    frac = np.isclose(o_out["color"], b_out["color"], rtol=2e-3,
                      atol=2e-3).mean()
    assert frac >= 0.995, frac
    assert (o_out["object_id"] == b_out["object_id"]).mean() >= 0.995
    assert o_out["device_rays"] == b_out["device_rays"]


FRAME_KEYS = ("image", "color", "depth", "normal", "object_id",
              "device_rays", "dropped_rays")


def _eager(fn):
    """``fn()`` with the chunk program run eagerly (no CUDA graph)."""
    from rustray_tpu_torch.render import wavefront
    with wavefront.eager():
        return fn()


def _assert_same_frame(a, b):
    for k in FRAME_KEYS:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("algo", ["block", "octet"])
def test_frame_path_replays_equal_eager(scene, algo):
    """The frame path's CUDA graphs against the eager chunk program, bit
    for bit, with two groups of one cell: one capture, one replay per
    chunk and cell."""
    from rustray_tpu_torch.render import wavefront
    sa, static, cfg = scene
    eng = EngineConfig(accel="on", chunk_pixels=4096, pallas_algo=algo,
                       samples_per_dispatch=1)
    # an earlier test may have cached this key's graphs
    wavefront._RENDERER_CACHE.clear()
    wavefront.reset_graph_stats()
    got = render(sa, static, cfg, eng)
    assert wavefront.graph_stats["captures"] >= 1
    assert wavefront.graph_stats["replays"] >= 2 * cfg.samples
    _assert_same_frame(got, _eager(lambda: render(sa, static, cfg, eng)))


def test_frame_path_two_scenes_one_static():
    """Two scenes that share one static, back to back through the frame
    path (a glass variant raises its queue factor): each equals its own
    eager frame."""
    outs = []
    for glass in (True, False):
        sc = bench_scene(grid=2, lat=10, lon=14, width=W, height=H)
        if glass:
            for m in sc.materials:
                m.reflectivity, m.alpha, m.refraction_index = 0.5, 0.5, 1.5
        sa, static = to_torch(*sc.compile(), "cuda")
        outs.append((sa, static, sc.raytracing_config))
    assert outs[0][1] == outs[1][1]
    static = outs[0][1]
    eng = EngineConfig(accel="on", chunk_pixels=2048, queue_factor=1.0)
    frames = [render(sa, static, cfg, eng) for sa, _, cfg in outs]
    for (sa, _, cfg), got in zip(outs, frames):
        _assert_same_frame(got, _eager(lambda: render(sa, static, cfg, eng)))
    assert not np.array_equal(frames[0]["color"], frames[1]["color"])
    # the per-chunk path replays the first factor's graph after a raised
    # factor's was captured in the same pool
    sa, _, cfg = outs[0]
    _assert_same_frame(render(sa, static, cfg, eng, max_chunks=3),
                       frames[0])


# ---- the renderer cache on the card (the CPU twins: test_torch_cache.py)

def _fresh(fn):
    """``fn()`` from an empty renderer cache, which it leaves empty."""
    from rustray_tpu_torch.render import wavefront
    wavefront._RENDERER_CACHE.clear()
    try:
        return fn()
    finally:
        wavefront._RENDERER_CACHE.clear()


def _cache_scene(glass=False, texture=None):
    sc = bench_scene(grid=2, lat=10, lon=14, width=W, height=H)
    if glass:
        for m in sc.materials:
            m.reflectivity, m.alpha, m.refraction_index = 0.5, 0.5, 1.5
    if texture is not None:
        from rustray_tpu_torch.scene.material import TextureType
        sc.materials[0].set_texture(TextureType.Base, texture)
    sa, static = to_torch(*sc.compile(), "cuda")
    return sa, static, sc.raytracing_config


def _counted_render(sa, static, cfg, eng):
    """render() with the launch and graph counts reset just before;
    returns (output, graph counts, K1 launches, K3 launches)."""
    from rustray_tpu_torch.render import wavefront
    bt.reset_launches()
    ot.reset_counts()
    wavefront.reset_graph_stats()
    out = render(sa, static, cfg, eng)
    return (out, dict(wavefront.graph_stats), dict(bt.launches),
            dict(ot.launches))


@pytest.mark.parametrize("algo", ["block", "octet"])
def test_second_render_makes_no_capture(algo):
    """The second render() of a key replays the first one's graphs: no
    capture, the same replays, the launches of the eager frame (its IF
    nodes skip what eager skips; the first call's warm-up ran every
    branch on top), the same frame, which is the eager one."""
    sa, static, cfg = _cache_scene()
    eng = EngineConfig(accel="on", chunk_pixels=2048, pallas_algo=algo)
    from rustray_tpu_torch.render import wavefront
    wavefront._RENDERER_CACHE.clear()
    first, g1, k1, k3 = _counted_render(sa, static, cfg, eng)
    second, g2, k1b, k3b = _counted_render(sa, static, cfg, eng)
    assert g1["captures"] == 1 and g2["captures"] == 0
    assert g2["replays"] == g1["replays"]
    eager, _, k1e, k3e = _eager(lambda: _counted_render(sa, static, cfg,
                                                        eng))
    assert (k1b, k3b) == (k1e, k3e)
    for once, again in ((k1, k1b), (k3, k3b)):
        assert all(once[m] >= again[m] for m in once)
    assert any(k1b.values())
    _assert_same_frame(second, first)
    _assert_same_frame(second, eager)


@pytest.mark.parametrize("algo", ["block", "octet"])
def test_replayed_frame_launches_what_eager_launches(scene, algo):
    """Every counter of a replayed frame (no capture) equals the eager
    chunk program's, the octet fallback's calls and rays included, and
    the captures hold IF nodes."""
    from rustray_tpu_torch import graphs
    from rustray_tpu_torch.render import wavefront
    sa, static, cfg = scene
    eng = EngineConfig(accel="on", chunk_pixels=2048, pallas_algo=algo)
    wavefront._RENDERER_CACHE.clear()
    wavefront.reset_graph_stats()
    render(sa, static, cfg, eng)
    assert sum(wavefront.graph_stats["if_nodes"].values()) > 0

    def counted(fn):
        bt.reset_launches()
        ot.reset_counts()
        graphs.reset_launches()
        out = fn()
        return out, graphs.snapshot(), int(ot.fallback["rays"])

    got, n, rays = counted(lambda: render(sa, static, cfg, eng))
    want, e_n, e_rays = counted(lambda: _eager(
        lambda: render(sa, static, cfg, eng)))
    _assert_same_frame(got, want)
    assert n[:-1] == e_n[:-1] and rays == e_rays
    assert n[-1] > 0 and e_n[-1] == 0          # set_if: replays only


@pytest.mark.parametrize("algo", ["block", "octet"])
def test_replayed_frame_census_equals_eager(scene, algo):
    """The block walks' census of a replayed frame (no capture) equals the
    eager chunk program's: calls and blocks, settled at the fetch, and the
    entries that the graphs add on the device."""
    from rustray_tpu_torch.render import wavefront
    sa, static, cfg = scene
    eng = EngineConfig(accel="on", chunk_pixels=2048, pallas_algo=algo)
    wavefront._RENDERER_CACHE.clear()
    render(sa, static, cfg, eng)

    def census(fn):
        bt.reset_launches()
        fn()
        return {m: (c["calls"], c["blocks"], int(c["entries"]))
                for m, c in bt.census.items()}

    got = census(lambda: render(sa, static, cfg, eng))
    want = census(lambda: _eager(lambda: render(sa, static, cfg, eng)))
    assert got == want
    if algo == "block":
        assert all(c > 0 and e > 0 for c, _, e in got.values())


@pytest.mark.parametrize("pattern", [("dead", "dead"), ("live", "dead"),
                                     ("some", "some"), ("live", "live")])
def test_nested_if_nodes(pattern):
    """Two gates nested in a captured graph, replayed under a mask
    pattern: the eager gates' outputs and the run counts."""
    from rustray_tpu_torch import graphs
    from rustray_tpu_torch.render import wavefront
    dev = torch.device("cuda")
    x = torch.rand(4096, device=dev)
    masks = [torch.zeros(4096, dtype=torch.bool, device=dev)
             for _ in range(2)]

    def program():
        def outer():
            y, = graphs.cond(masks[1], lambda: (x * 3.0,),
                             lambda: (torch.zeros_like(x),), "inner")
            return x + y, torch.where(masks[1], y, -1.0)

        return graphs.cond(masks[0], outer, lambda: (
            torch.zeros_like(x), torch.full_like(x, 7.0)), "outer")

    census = wavefront._warm_up(program, dev)
    with graphs.recording(dev, census) as rec:
        out, replay = wavefront._capture_graph(
            program, torch.cuda.graph_pool_handle())
    values = {"dead": 0.0, "some": 0.01, "live": 1.0}
    for m, v in zip(masks, pattern):
        m.copy_(torch.rand(4096, device=dev) < values[v])
    want = program()
    rec.runs.zero_()
    replay()
    for o, w in zip(out, want):
        assert torch.equal(o, w)
    ran = [bool(m.any()) for m in masks]
    assert rec.runs.tolist() == [int(ran[0]), int(ran[0] and ran[1])]


def test_tensor_changed_in_place_shows_on_the_card():
    from rustray_tpu_torch.render import wavefront
    sa, static, cfg = _cache_scene()
    eng = EngineConfig(accel="on", chunk_pixels=2048)
    wavefront._RENDERER_CACHE.clear()
    before = render(sa, static, cfg, eng)
    sa.lights.intensity.mul_(0.25)
    changed, g, _, _ = _counted_render(sa, static, cfg, eng)
    assert g["captures"] == 0
    assert not np.array_equal(changed["color"], before["color"])
    _assert_same_frame(changed, _eager(lambda: render(sa, static, cfg, eng)))


def test_changed_shape_captures_anew_on_the_card():
    from rustray_tpu_torch.models.procedural import checkerboard_texture
    from rustray_tpu_torch.render import wavefront
    sa, static, cfg = _cache_scene()
    sa2, static2, _ = _cache_scene(texture=checkerboard_texture(64, 4))
    assert static2 == static and sa2.tex_texels.shape != sa.tex_texels.shape
    eng = EngineConfig(accel="on", chunk_pixels=2048)
    wavefront._RENDERER_CACHE.clear()
    first, g1, _, _ = _counted_render(sa, static, cfg, eng)
    other, g2, _, _ = _counted_render(sa2, static, cfg, eng)
    again, g3, _, _ = _counted_render(sa, static, cfg, eng)
    assert g1["captures"] >= 1 and g2["captures"] >= 1
    assert g3["captures"] == 0
    _assert_same_frame(again, first)
    assert not np.array_equal(other["color"], first["color"])
    _assert_same_frame(other, _fresh(lambda: render(sa2, static, cfg, eng)))


def test_alternating_keys_share_the_pool():
    """The glass scene (its queue factor raised) at two chunk sizes, A, B,
    A, in one pool: each render equals a fresh render of its key, and the
    third captures nothing."""
    sa, static, cfg = _cache_scene(glass=True)
    a = EngineConfig(accel="on", chunk_pixels=2048, queue_factor=1.0)
    b = EngineConfig(accel="on", chunk_pixels=1024, queue_factor=1.0)
    want = [_fresh(lambda: render(sa, static, cfg, e)) for e in (a, b)]
    from rustray_tpu_torch.render import wavefront
    wavefront._RENDERER_CACHE.clear()
    runs = [_counted_render(sa, static, cfg, e) for e in (a, b, a)]
    for (out, _, _, _), ref in zip(runs, want + want[:1]):
        _assert_same_frame(out, ref)
    assert runs[0][1]["captures"] >= 2 and runs[1][1]["captures"] >= 2
    assert runs[2][1]["captures"] == 0
    assert runs[0][0]["dropped_rays"] == 0
