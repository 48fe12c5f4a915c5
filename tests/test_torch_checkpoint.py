"""Checkpoint/resume and the progressive preview of the port's render().

Twins of tests/test_checkpoint.py and of tests/test_session.py's preview
test, on CPU tensors: a render interrupted after one chunk and resumed
from its checkpoint equals the port's uninterrupted render bit for bit in
every key (dropped rays included), also when the queue factor was raised
before the checkpoint; a checkpoint of another configuration is ignored,
and the last preview PNG equals the finished image.
"""
import os

import numpy as np
import pytest
import torch

from rustray_tpu_torch import EngineConfig, render, to_torch
from rustray_tpu_torch.models.procedural import demo_spheres_scene

torch.set_num_threads(1)


def _scene(w, h):
    scene = demo_spheres_scene(w, h)
    sa, static = to_torch(*scene.compile(), "cpu")
    return sa, static, scene.raytracing_config


@pytest.mark.parametrize("case", ["twin", "raised"])
def test_kill_and_resume_bit_exact(tmp_path, case):
    """"twin": tests/test_checkpoint.py's render.  "raised": glass spheres
    at queue factor 1, so that the factor is raised before the checkpoint
    (chunk 4 of 6) and again after it."""
    if case == "twin":
        sa, static, cfg = _scene(64, 48)
        cfg.samples = 2
        eng = EngineConfig(chunk_pixels=1024)   # 3 chunks
        cut, qf = 1, 4.0
    else:
        scene = demo_spheres_scene(32, 24)
        for m in scene.materials:
            m.reflectivity, m.alpha = 0.5, 0.5
        sa, static = to_torch(*scene.compile(), "cpu")
        cfg = scene.raytracing_config
        eng = EngineConfig(chunk_pixels=128, queue_factor=1.0)
        cut, qf = 4, 2.0
    ckpt = str(tmp_path / "render.ckpt.npz")

    full = render(sa, static, cfg, eng)

    # "kill" after the cut: the checkpoint must exist and hold the cursor
    render(sa, static, cfg, eng, checkpoint_path=ckpt, max_chunks=cut)
    assert os.path.exists(ckpt)
    z = np.load(ckpt)
    assert int(z["cursor"]) == cut * eng.chunk_pixels
    assert float(z["queue_factor"]) == qf

    # resume: completes the frame and removes the checkpoint
    resumed = render(sa, static, cfg, eng, checkpoint_path=ckpt)
    assert not os.path.exists(ckpt)
    assert resumed.keys() == full.keys()
    for k in ("image", "color", "depth", "normal", "object_id"):
        np.testing.assert_array_equal(resumed[k], full[k], err_msg=k)
    assert resumed["device_rays"] == full["device_rays"]
    assert resumed["dropped_rays"] == full["dropped_rays"]


def test_mismatched_checkpoint_ignored(tmp_path):
    sa, static, cfg = _scene(32, 24)
    eng = EngineConfig(chunk_pixels=512)
    ckpt = str(tmp_path / "render.ckpt.npz")

    render(sa, static, cfg, eng, checkpoint_path=ckpt, max_chunks=1)
    assert os.path.exists(ckpt)

    # different sample count -> different fingerprint -> fresh render
    cfg2 = cfg.copy()
    cfg2.samples = 2
    full2 = render(sa, static, cfg2, eng)
    out2 = render(sa, static, cfg2, eng, checkpoint_path=ckpt)
    np.testing.assert_array_equal(out2["color"], full2["color"])
    assert out2["device_rays"] == full2["device_rays"]
    assert not os.path.exists(ckpt)


def test_preview_writes_progressive_png(tmp_path):
    from PIL import Image
    scene = demo_spheres_scene(32, 24)
    scene.raytracing_config.max_recursion = 1
    sa, static = to_torch(*scene.compile(), "cpu")
    path = str(tmp_path / "preview.png")
    out = render(sa, static, scene.raytracing_config,
                 EngineConfig(queue_factor=4.0, chunk_pixels=256),
                 preview_path=path, preview_every=1)
    img = np.asarray(Image.open(path))
    assert img.shape == (24, 32, 3)
    # the final preview equals the finished frame's image
    np.testing.assert_array_equal(img, out["image"])
    assert not os.path.exists(path + ".tmp.png")
