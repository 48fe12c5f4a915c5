"""``render_loss_and_grad`` over a frame larger than one chunk.

- Demo spheres at 96x64, Whitted (no random number is drawn): chunks of
  1,024 pixels (6 per frame) give the one-chunk loss and gradients at
  rtol 1e-5, the sums over pixels only regrouped by chunk.
- The Monte-Carlo bench scene: the image the chunked call returns is
  ``render()``'s for the same engine and seed (the chunk start is folded
  into each chunk's key), and the gradients of the loss weighted 1 on a
  pixel set S and 1 off it add up to the unweighted gradient.
- The sponza-class scene of the benchmark (``perfbench/scenes``) against
  the plain differentiable reference (``perfbench/reference/grad.py``,
  float64) at seeded material and light values: the gradient of the loss
  restricted to S over the materials' base colour, roughness and
  reflectivity and the lights' colour and intensity.
- ``grad_stats`` and the ``grad`` spans under a profiler.
- Queue factor 1, so every level's children are compacted: the fold's
  expansion, which autograd differentiates through ``index_copy``, gives
  plain indexing's loss and gradients bit for bit.
"""
import json
import os

import numpy as np
import pytest
import torch

from perfbench import named
from perfbench.reference import grad as ref_grad
from rustray_tpu_torch import EngineConfig, render, spans, to_torch
from rustray_tpu_torch.models.procedural import bench_scene, \
    demo_spheres_scene
from rustray_tpu_torch.parallel import shard
from rustray_tpu_torch.render import wavefront

torch.set_num_threads(1)

W, H = 96, 64
CHUNK = 1024


def _scene(scene):
    sa, static = to_torch(*scene.compile(), "cpu")
    return sa, static, scene.raytracing_config


@pytest.fixture(scope="module")
def demo():
    scene = demo_spheres_scene(W, H)
    scene.raytracing_config.max_recursion = 2
    scene.raytracing_config.samples = 2
    return _scene(scene)


@pytest.fixture(scope="module")
def bench():
    scene = bench_scene(grid=2, lat=10, lon=14, width=W, height=H,
                        monte_carlo=True, samples=2)
    scene.raytracing_config.max_recursion = 2
    return _scene(scene)


def _target(seed):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (H, W, 3)) \
        .astype(np.float32)


def _flat(grads):
    return {(g, k): v.numpy() for g, d in grads.items() for k, v in d.items()}


def test_chunked_gradient_equals_one_chunk(demo):
    sa, static, cfg = demo
    assert not cfg.monte_carlo
    target = _target(1)
    one = shard.render_loss_and_grad(sa, static, cfg, target,
                                     EngineConfig(queue_factor=8.0))
    shard.reset_grad_stats()
    many = shard.render_loss_and_grad(
        sa, static, cfg, target, EngineConfig(queue_factor=8.0,
                                              chunk_pixels=CHUNK))
    assert shard.grad_stats["chunks"] == W * H // CHUNK == 6
    np.testing.assert_allclose(float(many[0]), float(one[0]), rtol=1e-5)
    a, b = _flat(many[1]), _flat(one[1])
    assert any(np.abs(v).max() > 0 for v in b.values())
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-9,
                                   err_msg=str(k))


@pytest.fixture(scope="module")
def bench_grads(bench):
    """The chunked call on the bench scene, unweighted with its image,
    and weighted 1 on S (512 seeded pixels) and 1 off S."""
    sa, static, cfg = bench
    engine = EngineConfig(seed=2**31 + 5, chunk_pixels=CHUNK)
    target = _target(2)
    w = np.zeros(W * H, np.float32)
    w[np.random.default_rng(3).choice(W * H, 512, replace=False)] = 1.0
    shard.reset_dropped()
    full = shard.render_loss_and_grad(sa, static, cfg, target, engine,
                                      return_color=True)
    inside = shard.render_loss_and_grad(sa, static, cfg, target, engine,
                                        pixel_weight=w)
    outside = shard.render_loss_and_grad(sa, static, cfg, target, engine,
                                         pixel_weight=1.0 - w)
    return dict(engine=engine, full=full, inside=inside, outside=outside)


def test_chunked_color_is_renders_image(bench, bench_grads):
    sa, static, cfg = bench
    assert cfg.monte_carlo and cfg.samples == 2
    out = render(sa, static, cfg, bench_grads["engine"])
    assert out["dropped_rays"] == 0 and shard.dropped["rays"] == 0
    color = bench_grads["full"][2]
    assert color.shape == (W * H, 3)
    np.testing.assert_array_equal(color.numpy().reshape(H, W, 3),
                                  out["color"])


def test_weighted_gradients_add_up(bench_grads):
    loss, full = bench_grads["full"][:2]
    li, gi = bench_grads["inside"]
    lo, go = bench_grads["outside"]
    np.testing.assert_allclose(float(li) + float(lo), float(loss), rtol=1e-5)
    a, b, c = _flat(gi), _flat(go), _flat(full)
    assert any(np.abs(v).max() > 0 for v in a.values())
    for k in c:
        np.testing.assert_allclose(a[k] + b[k], c[k], rtol=1e-4, atol=1e-8,
                                   err_msg=str(k))


def _sponza_class(tmp_path):
    """The benchmark's sponza-class scene at W x H, 2 spp: the program's
    (its JSON and GLB through the port's loaders) and the reference's."""
    from rustray_tpu_torch.run import RenderSession
    gen = named.find("scenes", "sponza_class")
    config = {"width": W, "height": H, "monte_carlo": True,
              "max_recursion": 4, "aperture_size": 0.0, "focal_length": 0.0,
              "fog_density": 0.0,
              "scene": {"generator": "sponza_class", "grid": 2, "lat": 10,
                        "lon": 14, "variant": "uniform"}}
    path = os.path.join(str(tmp_path), "scene.json")
    with open(path, "w") as f:
        json.dump(gen.program_scene(config, 2), f)
    sess = RenderSession(W, H, [path], animate=False, device="cpu")
    sess.init()
    sa, static = to_torch(*sess.scene.compile(W, H), "cpu")
    ref = gen.reference_scene(config, gen.reference_data(config), 2)
    return sa, static, sess.scene.raytracing_config, ref


def test_gradient_matches_the_reference(tmp_path):
    """The queue factor is 16, the cap of five levels, so that no level is
    compacted and every draw of the reference is the program's; the
    reference differs from the program only in precision.  Tolerance:
    relative L2 error 1e-5 over the compared leaves, eight times the
    1.2e-6 that the program's float32 reads against float64 here (the
    reference in bfloat16 reads about 1)."""
    sa, static, cfg, ref = _sponza_class(tmp_path)
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for leaf, lo, hi in ((sa.materials.base_color, 0.2, 1.0),
                             (sa.materials.roughness, 0.0, 0.1),
                             (sa.materials.reflectivity, 0.0, 0.5),
                             (sa.lights.color, 0.5, 1.0)):
            leaf.copy_(torch.as_tensor(rng.uniform(lo, hi, leaf.shape)
                                       .astype(np.float32)))
        sa.lights.intensity.mul_(torch.as_tensor(
            rng.uniform(0.5, 1.5, sa.lights.intensity.shape)
            .astype(np.float32)))
    ids, mats = sa.inst_obj_id.numpy(), sa.inst_mat.numpy()
    rows = {it.material: int(mats[ids == it.obj_id][0]) for it in ref.items}
    for m, row in rows.items():
        mat = ref.materials[m]
        mat.base = sa.materials.base_color[row].double().numpy()
        mat.roughness = float(sa.materials.roughness[row])
        mat.reflectivity = float(sa.materials.reflectivity[row])
    for li, light in enumerate(ref.lights):
        light.color = sa.lights.color[li].double().numpy()
        light.intensity = float(sa.lights.intensity[li])

    engine = EngineConfig(seed=2**31 + 9, chunk_pixels=CHUNK,
                          queue_factor=16.0)
    target = _target(5).reshape(-1, 3)
    pixels = np.sort(rng.choice(W * H, 256, replace=False))
    w = np.zeros(W * H, np.float32)
    w[pixels] = 1.0
    loss, grads = shard.render_loss_and_grad(sa, static, cfg, target, engine,
                                             pixel_weight=w)
    r = ref_grad.loss_and_grad(ref, pixels, target[pixels], engine.seed,
                               CHUNK, engine.queue_factor)
    np.testing.assert_allclose(float(loss), r["loss"], rtol=1e-4)
    order = [rows[m] for m in range(len(rows))]
    prog = np.concatenate([grads[g][f].double().numpy()[
        order if g == "materials" else slice(None)].reshape(-1)
        for g, f in ref_grad.LEAVES])
    want = np.concatenate([r["grads"][k].reshape(-1)
                           for k in ref_grad.LEAVES])
    assert np.abs(want).max() > 0
    rel = np.linalg.norm(prog - want) / np.linalg.norm(want)
    assert rel < 1e-5, rel


def test_grad_stats_and_spans(demo, tmp_path):
    sa, static, cfg = demo
    engine = EngineConfig(queue_factor=8.0, chunk_pixels=2048)
    shard.reset_grad_stats()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        shard.render_loss_and_grad(sa, static, cfg, _target(6), engine)
    # no device clock on the CPU
    assert shard.grad_stats == {"calls": 1, "chunks": 3, "cells": 6,
                                "forward_ms": 0.0, "backward_ms": 0.0}
    trace = str(tmp_path / "trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    names = [e["name"] for e in events]
    assert names.count("grad") == 1 and names.count("grad.reduce") == 1
    assert names.count("grad.forward") == names.count("grad.backward") == 3
    assert names.count("chunk.dispatch") == 3
    (call,) = [e for e in events if e["name"] == "grad"]
    t0, t1 = call["ts"], call["ts"] + call["dur"]
    assert all(t0 <= e["ts"] and e["ts"] + e["dur"] <= t1 for e in events
               if e["name"].startswith(("grad.", "chunk.")))
    assert spans.last["grad"] > spans.last["grad.reduce"] > 0


def test_compaction_gradient_equals_plain_indexing(monkeypatch):
    scene = bench_scene(grid=2, lat=10, lon=14, width=48, height=32,
                        monte_carlo=True, samples=1)
    scene.raytracing_config.max_recursion = 3
    sa, static, cfg = _scene(scene)
    target = np.random.default_rng(6).uniform(0.0, 1.0, (32, 48, 3)) \
        .astype(np.float32)
    engine = EngineConfig(seed=2**31 + 11, queue_factor=1.0)
    expand, calls = wavefront._expand, []
    monkeypatch.setattr(wavefront, "_expand",
                        lambda *a: calls.append(a[3] is not None)
                        or expand(*a))
    loss, grads = shard.render_loss_and_grad(sa, static, cfg, target, engine)
    assert calls == [True] * 3
    monkeypatch.setattr(wavefront, "_expand",
                        lambda acc, kept, take, perm: torch.where(
                            kept[:, None], acc[take], 0.0))
    p_loss, p_grads = shard.render_loss_and_grad(sa, static, cfg, target,
                                                 engine)
    assert float(loss) == float(p_loss)
    a, b = _flat(grads), _flat(p_grads)
    assert any(np.abs(v).max() > 0 for v in b.values())
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
