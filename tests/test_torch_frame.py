"""The frame path of the port's render() (the JAX package's device loop):
every chunk of the frame per group of ``samples_per_dispatch`` cells, the
chunk program run as CUDA graphs on the card and eagerly on the CPU.

On the CPU (small scenes: the bench mini-scene and the demo spheres):
(a) the frame path against the JAX package's ``render()``, whose device
loop runs two groups with ``samples_per_dispatch=1`` as the port's does,
at the thresholds of tests/test_accel.py and with equal device rays;
(b) the frame path against the per-chunk (checkpoint/preview) path, bit
for bit; (c) with ``graphs.capturing`` patched to True, every branch that
replaces a host sync (a dead level, a dead traversal, a dead octet slice,
an octet slice with no fallback ray) runs its work and gives the skipping
branch's frame bit for bit, on the dense scan, the block-walk twin and the
octet twin; (d) device-key ``fold_in``/``uniform`` against the int-key
forms and ``jax.random``, and tensor-cell against int-cell
``primary_rays``, bit for bit; (e) a glass sphere that raises its queue
factor over three chunks, frame path against per-chunk path; (f) the
chunk renderer's replay machinery (input buffers, the reduction over
cells, counters added at every replay) with an eager stand-in for the
CUDA graph, against the eager frame.  The CUDA-graph twins are in
tests/test_torch_cuda.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustray_tpu.config import EngineConfig as JaxEngineConfig
from rustray_tpu.models.procedural import bench_scene as jax_bench_scene
from rustray_tpu.render.wavefront import render as jax_render
from rustray_tpu_torch import EngineConfig, graphs, render, rng, to_torch
from rustray_tpu_torch.models.procedural import (bench_scene,
                                                 demo_spheres_scene)
from rustray_tpu_torch.ops import block_trace as bt
from rustray_tpu_torch.ops import octet_trace as ot
from rustray_tpu_torch.ops import rays
from rustray_tpu_torch.render import wavefront

from test_torch_render import DENSE, TWIN, assert_render_close

torch.set_num_threads(1)

KEYS = ("image", "color", "depth", "normal", "object_id", "device_rays",
        "dropped_rays")
OCTET = dict(TWIN, pallas_algo="octet")


def assert_same_frame(a, b):
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def _mini(width=64, height=48, glass=False, **kw):
    """The bench mini-scene (64x48: two chunks of CHUNK pixels); ``glass``
    makes every material reflect and refract, so that queue factor 1.0
    drops rays."""
    sc = bench_scene(grid=2, lat=10, lon=14, width=width, height=height,
                     **kw)
    if glass:
        for m in sc.materials:
            m.reflectivity, m.alpha, m.refraction_index = 0.5, 0.5, 1.5
    sa, static = to_torch(*sc.compile(), "cpu")
    return sa, static, sc.raytracing_config


CHUNK = dict(chunk_pixels=2048)


@pytest.fixture(scope="module")
def mc_scene():
    return _mini(monte_carlo=True, samples=2)


def _counts():
    return (dict(bt.selected), dict(ot.rounds), ot.fallback["calls"],
            int(ot.fallback["rays"]))


def _reset():
    bt.reset_launches()
    ot.reset_counts()


# ------------------------------------------------------------------ (a)

@pytest.mark.parametrize("engine", ["dense", "twin"])
def test_frame_path_matches_jax_device_loop(engine):
    """Two groups of one cell in both packages (samples_per_dispatch=1):
    the JAX package's jitted frame program against the port's frame
    path."""
    scene = jax_bench_scene(grid=2, lat=10, lon=14, width=96, height=64,
                            monte_carlo=True, samples=2)
    sa, static = scene.compile()
    cfg = scene.raytracing_config
    ref = jax_render(sa, static, cfg,
                     JaxEngineConfig(**DENSE, samples_per_dispatch=1))
    sa_t, static_t = to_torch(sa, static, "cpu")
    eng = dict(DENSE if engine == "dense" else TWIN, samples_per_dispatch=1)
    out = render(sa_t, static_t, cfg, EngineConfig(**eng))
    assert_render_close(out, ref)
    assert out["dropped_rays"] == 0
    if engine == "dense":
        assert out["device_rays"] == ref["device_rays"]


# ------------------------------------------------------------------ (b)

@pytest.mark.parametrize("engine", ["dense", "twin", "octet"])
def test_frame_path_equals_per_chunk_path(mc_scene, engine):
    """``max_chunks`` selects the per-chunk path; the frame path runs two
    groups of one cell."""
    sa, static, cfg = mc_scene
    eng = EngineConfig(**{**{"dense": DENSE, "twin": TWIN,
                             "octet": OCTET}[engine], **CHUNK},
                       samples_per_dispatch=1)
    frame = render(sa, static, cfg, eng)
    per_chunk = render(sa, static, cfg, eng, max_chunks=100)
    assert_same_frame(frame, per_chunk)
    if engine == "dense":
        # the frame path with one group of both cells: the same sums and
        # counts
        one = render(sa, static, cfg,
                     dataclasses.replace(eng, samples_per_dispatch=2))
        assert_same_frame(one, per_chunk)
        assert one["dropped_rays"] == 0


# ------------------------------------------------------------------ (c)

@pytest.mark.parametrize("engine", ["dense", "twin", "octet"])
def test_capture_branches_equal_the_skipping_branches(monkeypatch, engine):
    """Deep levels die in the demo spheres at max_recursion 4 (dense scan)
    and in the bench mini-scene at 7 levels (the walks); the octet twin
    falls back in some of its slices and not in others.  Patched, the
    branches run more work and give the same frame."""
    if engine == "dense":
        sc = demo_spheres_scene(48, 32)
        sc.raytracing_config.max_recursion = 4
        sa, static = to_torch(*sc.compile(), "cpu")
        cfg = sc.raytracing_config
        cfg.samples = 2
        eng = EngineConfig(chunk_pixels=512)
    else:
        sa, static, cfg = _mini(monte_carlo=True, samples=2)
        eng = EngineConfig(**{**(TWIN if engine == "twin" else OCTET),
                              **CHUNK}, queue_factor=1.0)
    levels = []
    shade = wavefront._shade_level
    monkeypatch.setattr(wavefront, "_shade_level",
                        lambda *a, **k: levels.append(1) or shade(*a, **k))
    _reset()
    skipping = render(sa, static, cfg, eng)
    eager_counts, eager_levels = _counts(), len(levels)
    monkeypatch.setattr(graphs, "capturing", lambda: True)
    _reset()
    capture = render(sa, static, cfg, eng)
    assert_same_frame(capture, skipping)
    assert len(levels) - eager_levels > eager_levels   # dead levels shaded
    selected, rounds, calls, fb_rays = _counts()
    if engine == "twin":
        assert sum(selected.values()) > sum(eager_counts[0].values())
    if engine == "octet":
        assert rounds[1] > eager_counts[1][1]             # dead slices
        assert calls > eager_counts[2] > 0                # no-ray fallbacks
        assert fb_rays == eager_counts[3] > 0


# ------------------------------------------------------------------ (d)

@pytest.mark.parametrize("seed", [0, 42, 2 ** 31 - 1])
def test_device_key_fold_in_and_uniform(seed):
    """Tensor data folds through the tensor form of the hash; tensor key
    words draw through uniform_words: both the int forms' bits and
    jax.random's."""
    key, jkey = rng.PRNGKey(seed), jax.random.PRNGKey(seed)
    for data in (0, 5, 17, 23, 32768, 2 ** 32 - 1):
        host = rng.fold_in(key, data)
        dev = rng.fold_in(key, torch.tensor(data, dtype=torch.int64))
        ref = np.asarray(jax.random.fold_in(jkey, data)).astype(np.int64)
        np.testing.assert_array_equal(dev.numpy(), host.numpy())
        np.testing.assert_array_equal(dev.numpy(), ref)
        # a tensor key folds tensor data again (the level keys in a graph)
        k2 = rng.fold_in(dev, torch.tensor(3))
        np.testing.assert_array_equal(
            k2.numpy(), np.asarray(jax.random.fold_in(
                jax.random.fold_in(jkey, data), 3)).astype(np.int64))
        for shape in ((7,), (33, 2)):
            u_host = rng.uniform(host, shape, "cpu")
            u_dev = rng.uniform_words(*dev.unbind(), shape, "cpu")
            u_ref = np.asarray(jax.random.uniform(
                jax.random.fold_in(jkey, data), shape, jnp.float32))
            np.testing.assert_array_equal(u_dev.numpy(), u_host.numpy())
            np.testing.assert_array_equal(u_dev.numpy(), u_ref)


@pytest.mark.parametrize("dof", [False, True])
def test_tensor_cell_primary_rays_equal_int_cell(dof):
    """The offset cells of a 4-sample pattern, DOF on and off."""
    sa, static, _ = _mini(96, 64)
    r = np.random.default_rng(5)
    px = torch.tensor(r.integers(0, 96, 500), dtype=torch.int32)
    py = torch.tensor(r.integers(0, 64, 500), dtype=torch.int32)
    ap, fl = (8.0, 6.0) if dof else (1.0, 1.0)
    for cell in ((0, 0), (1, 0), (0, 1), (1, 1)):
        args = (sa.camera, 96, 64, px, py)
        want = rays.primary_rays(*args, *cell, 2, ap, fl, 4)
        cell_t = torch.tensor(cell, dtype=torch.int64)
        got = rays.primary_rays(*args, cell_t[0], cell_t[1], 2, ap, fl, 4)
        for g, w in zip(got, want):
            assert torch.equal(g, w), cell


# ------------------------------------------------------------------ (e)

def _glass_sphere_scene():
    """tests/test_torch_render_mc.py's view-filling glass sphere, built
    with the port's classes: every hit spawns reflection and refraction."""
    from rustray_tpu_torch import Material, Scene, Sphere
    from rustray_tpu_torch.scene.light import LightType
    scene = Scene()
    m = Material(id=scene.get_next_id(), name="glass")
    m.base_color = np.array([0.4, 0.7, 0.9], np.float32)
    m.reflectivity, m.alpha, m.refraction_index = 0.5, 0.5, 1.5
    s = Sphere("big", m, 0.0, 0.0, -5.0, 4.8)
    s.basic.id = scene.get_next_id()
    scene.items.append(s)
    scene.materials.append(m)
    scene.add_light("key", (-4.0, 8.0, 2.0), (0, -1, 0), (1, 1, 1), 200.0,
                    np.pi / 2, LightType.Point)
    scene.cam.init(32, 24)
    scene.raytracing_config.max_recursion = 3
    scene.init()
    scene.update()
    return scene


def test_glass_raise_frame_path_equals_per_chunk(capsys):
    scene = _glass_sphere_scene()
    sa, static = to_torch(*scene.compile(), "cpu")
    cfg = scene.raytracing_config
    cfg.samples = 2
    eng = EngineConfig(queue_factor=1.0, chunk_pixels=256)   # 3 chunks
    frame = render(sa, static, cfg, eng)
    assert capsys.readouterr().out.count("re-rendering chunk") >= 2
    per_chunk = render(sa, static, cfg, eng, max_chunks=100)
    assert frame["dropped_rays"] == 0
    assert_same_frame(frame, per_chunk)
    full = render(sa, static, cfg, EngineConfig(queue_factor=8.0,
                                                chunk_pixels=256))
    # the dropped attempts' rays are counted too
    assert frame["device_rays"] > full["device_rays"]


# ------------------------------------------------------------------ (f)

def _eager_graph(fn, pool):
    """A stand-in for wavefront._capture_graph on the CPU: 'capture' runs
    fn as a capture records it, a 'replay' runs it again into the same
    output tensors and leaves the counters to the renderer, as a replay
    does."""
    with graphs.unconditional():
        out = fn()

    def replay():
        before = graphs.snapshot()
        with graphs.unconditional():
            new = fn()
        graphs.restore(before)
        for o, n in zip(out, new):
            o.copy_(n)

    return out, replay


def _stand_in(monkeypatch):
    monkeypatch.setattr(wavefront, "captures", lambda *a: True)
    monkeypatch.setattr(wavefront, "_capture_graph", _eager_graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    # no cached program of another test's stand-in
    wavefront._RENDERER_CACHE.clear()
    wavefront.reset_graph_stats()
    _reset()


def test_replay_machinery_equals_eager_frame(monkeypatch, mc_scene):
    """Two groups of one cell over two chunks, through the block-walk
    twin: one capture, four replays.  Each replay adds what the capture
    counted, so the counts are the unconditional eager frame's times
    (replays + warm-up) / replays."""
    sa, static, cfg = mc_scene
    eng = EngineConfig(**{**TWIN, **CHUNK}, samples_per_dispatch=1)
    _reset()
    with graphs.unconditional():
        want = render(sa, static, cfg, eng)
    unconditional = sum(bt.selected.values())
    _stand_in(monkeypatch)
    got = render(sa, static, cfg, eng)
    assert_same_frame(got, want)
    assert wavefront.graph_stats["captures"] == 1
    replays = wavefront.graph_stats["replays"]
    assert replays == 2 * 2                      # 2 chunks x 2 cells
    assert sum(bt.selected.values()) * replays == \
        unconditional * (replays + 1)
    # the cached chunk program replays over other scene tensors of its key
    # (copied into its buffers) and refuses tensors of another shape
    prep, boxes = wavefront.prepare_frame(sa, static, eng)
    fn = wavefront.make_chunk_renderer(static, cfg, eng,
                                       wavefront.frame_levels(sa, cfg),
                                       (sa, prep, boxes))
    pix = torch.arange(CHUNK["chunk_pixels"], dtype=torch.int32)
    args = (pix % 64, pix // 64, pix >= 0, np.zeros((1, 2), np.int64), [0],
            [True], rng.PRNGKey(0))
    want = [x.clone() for x in fn(sa, prep, boxes, *args)]
    prep2, boxes2 = wavefront.prepare_frame(sa, static, eng)
    for got, w in zip(fn(sa, prep2, boxes2, *args), want):
        assert torch.equal(got, w)
    other = (boxes2[0][:-1], boxes2[1][:-1])
    with pytest.raises(ValueError, match="make_chunk_renderer"):
        fn(sa, prep2, other, *args)


def test_replay_machinery_raises_the_queue(monkeypatch, capsys):
    """The glass mini-scene at queue factor 1.0 in three chunks, through
    the octet twin: the frame's graph and one more per raised factor,
    sharing the frame's pool, equal to the eager frame."""
    sa, static, cfg = _mini(glass=True)
    cfg.samples = 1
    eng = EngineConfig(**{**OCTET, "chunk_pixels": 1024}, queue_factor=1.0)
    want = render(sa, static, cfg, eng)
    raised = capsys.readouterr().out.count("re-rendering chunk")
    assert raised >= 1
    _stand_in(monkeypatch)
    got = render(sa, static, cfg, eng)
    assert_same_frame(got, want)
    assert wavefront.graph_stats["captures"] == 1 + raised
