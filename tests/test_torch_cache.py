"""The renderer cache of the port's render() (``_config_key``,
``_RENDERER_CACHE``) against the JAX package's.

On the CPU, at small size: (1) the port's key holds every item of the JAX
``_config_key`` for the same scene and configs, and an item changes the
port's key exactly where it changes JAX's; (2) over one sequence of
render() calls (the same frame twice, a seed change, a glass scene whose
queue factor is raised, a chunk size change) the port's cache and the JAX
package's chunk programs grow on the same calls by the same counts; (3)
an animated RenderSession of 3 frames gives images that the JAX
package's session matches at the thresholds of tests/test_accel.py,
each frame bit for bit an uncached port render of
that frame, the frames differing from each other; (4) a scene tensor
changed in place shows in the next render(); (5) a changed tensor shape
makes a new entry, and the old entry stays for its own scene.  (3)-(5)
run the eager chunk program (what the cache holds on the CPU) and the
CUDA-graph machinery with tests/test_torch_frame.py's eager stand-in for
a graph (captures, the cached scene buffers refreshed per call, replays).
The CUDA twins are in tests/test_torch_cuda.py.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import rustray_tpu.run as j_run
from rustray_tpu.config import EngineConfig as JaxEngineConfig
from rustray_tpu.models.procedural import bench_scene as j_bench_scene
from rustray_tpu.render import wavefront as j_wavefront
from rustray_tpu_torch import EngineConfig, render, to_torch
from rustray_tpu_torch import run as t_run
from rustray_tpu_torch.models.procedural import (bench_scene,
                                                 checkerboard_texture,
                                                 ensure_bench_assets)
from rustray_tpu_torch.render import wavefront
from rustray_tpu_torch.scene.material import TextureType

from test_torch_frame import _stand_in, assert_same_frame
from test_torch_render import assert_render_close

torch.set_num_threads(1)

W, H = 24, 18
# the JAX key's items after the static, in its order
JAX_ITEMS = 21


@pytest.fixture(autouse=True)
def empty_caches():
    wavefront._RENDERER_CACHE.clear()
    yield
    wavefront._RENDERER_CACHE.clear()


def _jax_scene(glass=False):
    sc = j_bench_scene(grid=2, lat=10, lon=14, width=W, height=H,
                       monte_carlo=True, samples=1)
    sc.raytracing_config.max_recursion = 1
    if glass:
        for m in sc.materials:
            m.reflectivity, m.alpha, m.refraction_index = 0.5, 0.5, 1.5
    sa, static = sc.compile()
    return sa, static, sc.raytracing_config


def _port_scene():
    sc = bench_scene(grid=2, lat=10, lon=14, width=W, height=H,
                     monte_carlo=True, samples=1)
    sc.raytracing_config.max_recursion = 1
    return sc


def _mode(monkeypatch, mode):
    """"eager": the chunk program the cache holds on the CPU; "graphs": the
    CUDA-graph machinery with an eager stand-in for the graph."""
    if mode == "graphs":
        _stand_in(monkeypatch)


# ------------------------------------------------------------------ (1)

ITEM_CHANGES = [
    ("cfg", "monte_carlo", False), ("cfg", "samples", 4),
    ("cfg", "focal_length", 2.0), ("cfg", "aperture_size", 3.0),
    ("cfg", "fog_density", 0.1), ("cfg", "fog_color", (0.1, 0.2, 0.3)),
    ("cfg", "max_recursion", 2), ("cfg", "gamma_correction", True),
    ("engine", "chunk_pixels", 256), ("engine", "queue_factor", 2.0),
    ("engine", "tri_tile", 512), ("engine", "seed", 3),
    ("engine", "accel", "on"), ("engine", "accel_block", 256),
    ("engine", "accel_gather", 8), ("engine", "accel_min_tris", 64),
    ("engine", "pallas", "off"), ("engine", "pallas_block", 256),
    ("engine", "pallas_interpret", True), ("engine", "pallas_algo", "octet"),
    ("engine", "samples_per_dispatch", 1), ("engine", "deterministic", False),
]


def test_key_holds_every_jax_item():
    j_sa, j_static, cfg = _jax_scene()
    sa, static = to_torch(j_sa, j_static, "cpu")
    engine = EngineConfig()
    n_levels = wavefront.frame_levels(sa, cfg)

    def keys(cfg, eng):
        scene = wavefront.prepare_frame(sa, static, eng)
        key = wavefront._config_key(static, cfg, eng, n_levels,
                                    (sa, *scene))
        jkey = j_wavefront._config_key(
            j_static, cfg, JaxEngineConfig(**dataclasses.asdict(eng)),
            n_levels)
        return key, jkey

    key, jkey = keys(cfg, engine)
    assert len(jkey) == 1 + JAX_ITEMS
    assert dataclasses.astuple(key[0]) == dataclasses.astuple(jkey[0])
    assert key[1:1 + JAX_ITEMS] == jkey[1:]
    # the implicit items: device, captured or not, the walk, the signature
    dev, captured, gated, signature = key[1 + JAX_ITEMS:]
    assert dev == torch.device("cpu") and not captured and not gated
    assert (tuple(sa.verts.shape), torch.float32) in signature
    for where, name, value in ITEM_CHANGES:
        c = dataclasses.replace(cfg, **{name: value}) if where == "cfg" \
            else cfg
        e = dataclasses.replace(engine, **{name: value}) \
            if where == "engine" else engine
        k2, j2 = keys(c, e)
        assert (k2 != key) == (j2 != jkey), name


# ------------------------------------------------------------------ (2)

def test_caches_grow_on_the_same_calls(capsys):
    j_plain, j_glass = _jax_scene(), _jax_scene(glass=True)
    calls = [("the frame", j_plain, {}), ("the same frame", j_plain, {}),
             ("another seed", j_plain, dict(seed=1)),
             ("a raised queue factor", j_glass, dict(queue_factor=1.0)),
             ("another chunk size", j_plain, dict(chunk_pixels=128))]
    def jax_chunk_programs():
        # the port's render() loops the chunk program itself and caches no
        # frame program
        return sum(k[-3] != "frame" for k in j_wavefront._RENDERER_CACHE)

    for what, (j_sa, j_static, cfg), eng in calls:
        sa, static = to_torch(j_sa, j_static, "cpu")
        n_j, n_t = jax_chunk_programs(), len(wavefront._RENDERER_CACHE)
        ref = j_wavefront.render(j_sa, j_static, cfg, JaxEngineConfig(**eng))
        out = render(sa, static, cfg, EngineConfig(**eng))
        assert_render_close(out, ref)
        grew_j = jax_chunk_programs() - n_j
        grew_t = len(wavefront._RENDERER_CACHE) - n_t
        assert grew_t == grew_j, (what, grew_t, grew_j)
        assert (grew_t == 0) == (what == "the same frame"), what
    assert capsys.readouterr().out.count("re-rendering chunk") == 2


# ------------------------------------------------------------------ (3)

@pytest.fixture(scope="module")
def animated_json(tmp_path_factory):
    """The tests' small bench GLB with one ball moving up over 3 frames
    (fps 3, keyframes at 0 and 1000 ms); every other item stays."""
    d = tmp_path_factory.mktemp("anim")
    bench = ensure_bench_assets(str(d), grid=2, lat=10, lon=14, width=W,
                                height=H, samples=1)
    with open(bench) as f:
        glb = json.load(f)["objects"][0]["path"]
    move = [{"time": t, "objects": [{"name": "ball1_1", "transformation": {
        "translation": {"x": 0.0, "y": y, "z": 0.0}}}]}
        for t, y in ((0, 0.0), (1000, 1.5))]
    spec = {"name": "animated",
            "config": {"monte_carlo": True, "samples": 1, "max_recursion": 1},
            "objects": [{"type": "gltf", "path": glb}],
            "animation": {"enabled": True, "fps": 3, "keyframes": move}}
    path = os.path.join(str(d), "animated.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return path


def _recorded_session(monkeypatch, module, make):
    """Run ``make()``'s session with ``module.render`` recording each
    frame's scene, result and the cache's growth."""
    frames = []
    real = module.render

    def recording(sa, static, cfg, engine, **kw):
        cache = (wavefront if module is t_run else j_wavefront)._RENDERER_CACHE
        n = len(cache)
        out = real(sa, static, cfg, engine, **kw)
        frames.append(dict(sa=sa, static=static, cfg=cfg.copy(),
                           engine=engine, out=out, grew=len(cache) - n))
        return out

    monkeypatch.setattr(module, "render", recording)
    sess = make()
    sess.init()
    sess.run(save=False)
    return frames


@pytest.fixture(scope="module")
def jax_frames(animated_json):
    # its first frame's key may be cached by another test's render
    j_wavefront._RENDERER_CACHE.clear()
    with pytest.MonkeyPatch.context() as mp:
        return _recorded_session(mp, j_run, lambda: j_run.RenderSession(
            W, H, [animated_json], animate=True))


@pytest.mark.parametrize("mode", ["eager", "graphs"])
def test_animated_session_matches_jax_and_uncached(monkeypatch, mode,
                                                   animated_json, jax_frames):
    _mode(monkeypatch, mode)
    frames = _recorded_session(monkeypatch, t_run, lambda: t_run.RenderSession(
        W, H, [animated_json], animate=True, device="cpu"))
    assert len(frames) == len(jax_frames) == 3
    assert len({f["static"] for f in frames}) == 1
    if mode == "graphs":
        # one capture for the whole session, replayed by every frame
        assert wavefront.graph_stats["captures"] == 1
        assert wavefront.graph_stats["replays"] == 3
    # the cache grows on the first frame only, as the JAX package's does
    assert [f["grew"] > 0 for f in frames] == [True, False, False]
    assert [f["grew"] > 0 for f in jax_frames] == [True, False, False]
    for i, (f, j) in enumerate(zip(frames, jax_frames)):
        assert_render_close(f["out"], j["out"])
        assert f["out"]["dropped_rays"] == 0
        wavefront._RENDERER_CACHE.clear()
        fresh = render(f["sa"], f["static"], f["cfg"], f["engine"])
        assert_same_frame(f["out"], fresh)
        if i:
            prev = frames[i - 1]["out"]
            assert not (np.array_equal(f["out"]["color"], prev["color"])
                        and np.array_equal(f["out"]["object_id"],
                                           prev["object_id"])), i


# ------------------------------------------------------------------ (4)

@pytest.mark.parametrize("mode", ["eager", "graphs"])
def test_tensor_changed_in_place_shows_next_render(monkeypatch, mode):
    _mode(monkeypatch, mode)
    sc = _port_scene()
    sa, static = to_torch(*sc.compile(), "cpu")
    cfg, eng = sc.raytracing_config, EngineConfig()
    first = render(sa, static, cfg, eng)
    n = len(wavefront._RENDERER_CACHE)
    sa.lights.intensity.mul_(0.25)
    changed = render(sa, static, cfg, eng)
    assert len(wavefront._RENDERER_CACHE) == n
    assert not np.array_equal(changed["color"], first["color"])
    wavefront._RENDERER_CACHE.clear()
    assert_same_frame(changed, render(sa, static, cfg, eng))
    if mode == "graphs":
        # the first render's capture and the uncached render's
        assert wavefront.graph_stats["captures"] == 2


# ------------------------------------------------------------------ (5)

@pytest.mark.parametrize("mode", ["eager", "graphs"])
def test_changed_shape_makes_a_new_entry(monkeypatch, mode):
    """A smaller, coarser texture on one material: the same SceneStatic,
    another atlas length."""
    _mode(monkeypatch, mode)
    sc = _port_scene()
    sa, static = to_torch(*sc.compile(), "cpu")
    sc.materials[0].set_texture(TextureType.Base, checkerboard_texture(64, 4))
    sa2, static2 = to_torch(*sc.compile(), "cpu")
    assert static2 == static
    assert sa2.tex_texels.shape != sa.tex_texels.shape
    cfg, eng = sc.raytracing_config, EngineConfig()
    first = render(sa, static, cfg, eng)
    n = len(wavefront._RENDERER_CACHE)
    other = render(sa2, static, cfg, eng)
    assert len(wavefront._RENDERER_CACHE) > n
    assert not np.array_equal(other["color"], first["color"])
    n = len(wavefront._RENDERER_CACHE)
    assert_same_frame(render(sa, static, cfg, eng), first)
    assert len(wavefront._RENDERER_CACHE) == n
    if mode == "graphs":
        assert wavefront.graph_stats["captures"] == 2
    wavefront._RENDERER_CACHE.clear()
    assert_same_frame(render(sa2, static, cfg, eng), other)
