"""The port's user entry points: the CLI's arguments, RenderSession on the
CPU (render, save, post-processing), ``python -m rustray_tpu_torch``,
the CUDA default with no fallback, and picking against the JAX package.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rustray_tpu.models.procedural import demo_spheres_scene as j_demo
from rustray_tpu.render.picking import pick as j_pick
from rustray_tpu_torch import to_torch
from rustray_tpu_torch.cli import parse_args
from rustray_tpu_torch.models.procedural import (demo_spheres_scene,
                                                 ensure_bench_assets)
from rustray_tpu_torch.render.picking import pick
from rustray_tpu_torch.run import RenderSession

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_arg_parsing():
    opts = parse_args(["cmd", "scene/spheres.json", "800x600", "samples=16",
                       "monte_carlo=1", "no-animation", "start=1",
                       "device=cpu"])
    assert not opts["window"]
    assert opts["scenes"] == ["scene/spheres.json"]
    assert opts["width"] == 800 and opts["height"] == 600
    assert opts["samples"] == 16
    assert opts["monte_carlo"] is True
    assert not opts["animation"]
    assert opts["start"]
    assert opts["device"] == "cpu"


def test_cli_defaults():
    opts = parse_args([])
    assert opts["window"] and opts["animation"]
    assert opts["monte_carlo"] is None and opts["samples"] is None
    assert opts["device"] == "cuda"


@pytest.fixture(scope="module")
def bench_json(tmp_path_factory):
    return ensure_bench_assets(str(tmp_path_factory.mktemp("bench")),
                               grid=2, lat=10, lon=14, width=24, height=18,
                               samples=1)


def test_session_renders_saves_and_posts_on_cpu(bench_json, tmp_path):
    from PIL import Image
    from rustray_tpu_torch.render.post import run_post_processing
    sess = RenderSession(24, 18, [bench_json], animate=False,
                         out_dir=str(tmp_path), device="cpu")
    sess.init()
    sess.scene.raytracing_config.max_recursion = 1
    sess.scene.post_processing.cavity = True
    sess.scene.post_processing.outline = True
    sess.run()
    pngs = sorted(f for f in os.listdir(tmp_path) if f.endswith(".png"))
    plain = [f for f in pngs if not f.endswith("_post.png")]
    post = [f for f in pngs if f.endswith("_post.png")]
    assert len(plain) == 1 and len(post) == 1, pngs
    img = np.asarray(Image.open(tmp_path / plain[0]))
    assert img.shape == (18, 24, 3) and img.max() > 0
    # the post pass replaced the session's image with the processed one
    processed = np.asarray(Image.open(tmp_path / post[0]))
    np.testing.assert_array_equal(processed, sess.result["image"])
    np.testing.assert_array_equal(processed, run_post_processing(
        sess.scene.post_processing, img, sess.result["normal"],
        sess.result["depth"], sess.result["object_id"], device="cpu"))
    assert sess.result["dropped_rays"] == 0


def test_module_entry_point_renders_on_cpu(bench_json, tmp_path):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "rustray_tpu_torch", "cmd", bench_json,
         "24x18", "samples=1", "no-animation", f"out={tmp_path}",
         "device=cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    pngs = [f for f in os.listdir(tmp_path) if f.endswith(".png")]
    assert len(pngs) == 1 and pngs[0].startswith("output_"), pngs
    assert "done" in proc.stdout


def test_default_device_without_cuda_raises(monkeypatch):
    """RenderSession renders on CUDA unless the caller asks for the CPU;
    with no CUDA device it raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RenderSession(24, 18, [])
    RenderSession(24, 18, [], device="cpu")


@pytest.mark.parametrize("xy", [(16, 12), (0, 0)])
def test_pick_matches_jax(xy):
    j_scene = j_demo(32, 24)
    scene = demo_spheres_scene(32, 24)
    j_sa, j_static = j_scene.compile()
    sa, static = to_torch(*scene.compile(), "cpu")
    ref = j_pick(j_scene, j_sa, j_static, *xy)
    got = pick(scene, sa, static, *xy)
    assert (got is None) == (ref is None)
    if ref is not None:
        assert got[:2] == ref[:2]
        np.testing.assert_allclose(got[2], ref[2], rtol=1e-5)


def test_session_pick_on_cpu(bench_json):
    sess = RenderSession(24, 18, [bench_json], animate=False, device="cpu")
    sess.init()
    obj_id, name, dist = sess.pick(12, 9)
    assert name and dist > 0
    assert sess.scene.get_obj_by_id(obj_id).basic.name == name
