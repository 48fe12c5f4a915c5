"""The rays × samples split over two gloo ranks on the CPU, against the
JAX package's sharded render on the same mesh shape and against the
single-device gradient.

``python -m rustray_tpu_torch.parallel.dryrun 2 --device cpu`` starts two
ranks (the twin of tests/test_multihost.py's two processes); each mesh's
outputs come back as an .npz.  Demo spheres 16×12, 2 spp, max_recursion 2,
queue factor 8, ``chunk_pixels`` 64, so every mesh renders the frame in 2
or 3 sharded chunks.  Thresholds of tests/test_sharding.py and
tests/test_multihost.py: color within 1e-5 on every pixel, depth within
1e-4, ids and device rays equal; loss and gradients against the port's
single-device run at rtol 1e-5 (loss 1e-6) / atol 1e-7.  The JAX
package's gradients on the (1, 2) mesh are twice the true ones (it
differentiates through its psum over "samples" and then sums the
gradients over both axes), so the port's equal JAX's ÷ 2 there, at rtol
1e-4 / atol 1e-6, every leaf but the camera's: that one is
ill-conditioned on this frame, and JAX's sharded program rounds the rays
of an offset sample cell one ulp differently (tests/test_torch_grad.py).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import assert_images_close
from rustray_tpu.config import EngineConfig as JaxEngineConfig
from rustray_tpu.models.procedural import demo_spheres_scene
from rustray_tpu.parallel import shard as j_shard
from rustray_tpu_torch import EngineConfig, render, to_torch
from rustray_tpu_torch.parallel import dryrun, shard
from rustray_tpu_torch.render import wavefront

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((2, 1), (1, 2))
CHUNK = 64


def _dryrun(out, *args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "rustray_tpu_torch.parallel.dryrun", "2",
         "--device", "cpu", "--out", str(out), "--timeout", "240", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    runs = {m: dict(np.load(os.path.join(out, f"mesh_{m[0]}x{m[1]}.npz")))
            for m in MESHES}
    return runs, proc.stdout


def _grads(runs):
    return {k: v for k, v in runs.items() if k.startswith("g.")}


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    runs, _ = _dryrun(tmp_path_factory.mktemp("demo"), "--scene", "demo",
                      "--queue-factor", "8", "--chunk-pixels", str(CHUNK))
    scene = demo_spheres_scene(16, 12)
    scene.raytracing_config.max_recursion = 2
    scene.raytracing_config.samples = 2
    sa, static = scene.compile()
    cfg = scene.raytracing_config
    assert CHUNK * max(r for r, _ in MESHES) < static.width * static.height
    j_eng = JaxEngineConfig(queue_factor=8.0, chunk_pixels=CHUNK)
    jax_render = {}
    for r, s in MESHES:
        devices = jax.devices()[:r * s]
        jax_render[(r, s)] = j_shard.render_sharded(
            sa, static, cfg, j_eng, j_shard.make_mesh(devices, sample_axis=s))
    target = np.zeros((static.height, static.width, 3), np.float32)
    j_loss, j_grads = j_shard.render_loss_and_grad(
        sa, static, cfg, target, j_eng,
        j_shard.make_mesh(jax.devices()[:2], sample_axis=2))
    jax_12 = {f"g.{g}.{k}": np.asarray(v) for g, d in j_grads.items()
              for k, v in d.items()}
    jax_12["loss"] = float(j_loss)
    sa_t, static_t = to_torch(sa, static, "cpu")
    single = dryrun.run_mesh(sa_t, static_t, cfg,
                             EngineConfig(queue_factor=8.0,
                                          chunk_pixels=CHUNK),
                             shard.make_mesh())
    return dict(runs=runs, jax_render=jax_render, jax_12=jax_12,
                single=single)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_render_matches_jax(demo, mesh):
    out, ref = demo["runs"][mesh], demo["jax_render"][mesh]
    assert_images_close(out["color"], ref["color"], atol=1e-5, frac=1.0,
                        name=f"{mesh} color")
    np.testing.assert_allclose(out["depth"], ref["depth"], atol=1e-4)
    np.testing.assert_array_equal(out["object_id"], ref["object_id"])
    assert int(out["device_rays"]) == ref["device_rays"]
    assert int(out["dropped_rays"]) == 0


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_grads_equal_single_device(demo, mesh):
    out, single = demo["runs"][mesh], demo["single"]
    np.testing.assert_allclose(float(out["loss"]), float(single["loss"]),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(float(out["loss"]), demo["jax_12"]["loss"],
                               rtol=1e-5)
    grads = _grads(out)
    assert set(grads) == set(_grads(single)) == set(_grads(demo["jax_12"]))
    for k, g in grads.items():
        np.testing.assert_allclose(g, single[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
        if not k.startswith("g.camera."):
            # the JAX package's (1, 2) gradients carry a factor of 2
            np.testing.assert_allclose(g, demo["jax_12"][k] / 2.0,
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    assert np.abs(grads["g.materials.base_color"]).max() > 0.0
    assert int(out["grad_dropped"]) == 0


def test_sgd_step(demo):
    """One step through apply_diff_params lowers the loss of a black
    target, equally on every mesh."""
    steps = [float(demo["runs"][m]["loss_after_step"]) for m in MESHES]
    single = float(demo["single"]["loss_after_step"])
    assert np.isfinite(single) and single < float(demo["single"]["loss"])
    np.testing.assert_allclose(steps, single, rtol=1e-6)


def test_sharded_low_queue_auto_raises(tmp_path):
    """Both ranks re-render a chunk that drops rays at a doubled queue
    factor, together, until the tree fits: equal to a queue factor of 8.
    At 1 spp the (1, 2) mesh's second rank holds only a padding cell, and
    every AOV is still the one rank's."""
    runs, printed = _dryrun(tmp_path, "--scene", "glass", "--queue-factor",
                            "1")
    assert "re-rendering sharded chunk" in printed
    sa, static, cfg = dryrun.load_scene("glass", "cpu")
    full = shard.render_sharded(sa, static, cfg,
                                EngineConfig(queue_factor=8.0))
    assert full["dropped_rays"] == 0
    for mesh in MESHES:
        low = runs[mesh]
        for k in ("color", "normal", "depth"):
            np.testing.assert_allclose(low[k], full[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{mesh} {k}")
        np.testing.assert_array_equal(low["object_id"], full["object_id"])
        assert int(low["dropped_rays"]) == 0


def test_pad_helpers_are_the_jax_packages():
    """The chunk walk's pixel slabs and sample cells, every shard's
    concatenated in rank order, are the JAX package's padded ones."""
    scene = demo_spheres_scene(16, 12)
    scene.raytracing_config.samples = 3
    _, static = scene.compile()
    cfg = scene.raytracing_config
    n_pix = static.width * static.height
    for n, start, count in ((4, 0, n_pix), (3, 100, 64), (1, 190, 64)):
        px, py, valid, _ = j_shard._pad_pixels(static, n, start, count)
        slabs = [wavefront.chunk_slab(static, start, count, "cpu", r, n)
                 for r in range(n)]
        pix = start + np.arange(px.shape[0])
        for a, b in zip(zip(*slabs), (px, py, valid, pix)):
            np.testing.assert_array_equal(torch.cat(a).numpy(), b)
    for n in (1, 2, 4):
        cells = [wavefront.chunk_cells(cfg, EngineConfig().seed, i, n)
                 for i in range(n)]
        for a, b in zip(zip(*cells),
                        j_shard._pad_cells(cfg, JaxEngineConfig(), n)):
            np.testing.assert_array_equal(np.concatenate(a), b)


def test_one_rank_render_sharded_is_render():
    """On the one-rank mesh render_sharded is render() bit for bit: three
    chunks, the last one partial, both sample cells in one group and a
    queue factor at which nothing drops (so the two raise rules agree)."""
    sa, static, cfg = dryrun.load_scene("demo", "cpu")
    eng = EngineConfig(queue_factor=8.0, chunk_pixels=80)
    assert 2 * 80 < static.width * static.height < 3 * 80
    assert cfg.samples <= eng.samples_per_dispatch
    full = render(sa, static, cfg, eng)
    assert full["dropped_rays"] == 0
    sharded = shard.render_sharded(sa, static, cfg, eng)
    for k in ("image", "color", "depth", "normal", "object_id",
              "device_rays", "dropped_rays"):
        np.testing.assert_array_equal(np.asarray(sharded[k]),
                                      np.asarray(full[k]), err_msg=k)


def test_mesh_without_process_group():
    mesh = shard.make_mesh()
    assert mesh.shape == {"rays": 1, "samples": 1}
    assert (mesh.ray, mesh.sample, mesh.groups) == (0, 0, {})
    with pytest.raises(ValueError):
        shard.make_mesh(sample_axis=2)
    assert dryrun.meshes(2) == list(MESHES)
    assert dryrun.meshes(4) == [(4, 1), (2, 2), (1, 4)]
