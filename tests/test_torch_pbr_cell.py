"""The benchmark's ``sponza_pbr_still`` cell on the CPU, at a small size:
the sponza-class scene with the glTF material model (every material with
base-colour, normal and metallic-roughness maps; cut-out foliage), the
plain reference that shades the maps (``perfbench/reference/pbr.py``) and
the shading census of ``render/wavefront.py``.

- The small cell (grid 2, lat 10, lon 12, 32² maps, 64x36, 2 spp, every
  pixel compared) runs through ``run.main`` and reads ``correct``, traced
  and not; its census readers read 4 fetches a hit and cut-outs above 0.
  Its four spheres are small in the frame (the cell's camera), so all
  four are cut out, at 70% of their texels, for the pixels where a ray
  passes through both sides of a sphere to show the cut-outs' object ids.
- The comparison sees every channel: with the program's normal maps
  ignored, its metallic-roughness maps ignored, or its cut-out alpha
  forced to 1, the small run is not correct; nor is the reference in
  bfloat16 in the program's place (the control).
- The GLB that the generator writes round-trips through the port's glTF
  loader: base colour, normal map and the metallic-roughness image's B
  and G channels equal the generator's arrays bit for bit.
- The census: equal over two identical eager frames; zero on
  ``sponza_still``'s small scene, whose only maps are base colour; the
  readers return None where the loaded program has no census.
"""
import io
import json
import os
import sys
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from perfbench import check, control, named, run
from rustray_tpu_torch import EngineConfig, render, to_torch
from rustray_tpu_torch.render import wavefront
from rustray_tpu_torch.scene.material import TextureType
from rustray_tpu_torch.scene.scene import Scene

torch.set_num_threads(1)

CELL = "sponza_pbr_still"
SCENE = {"generator": "sponza_pbr", "grid": 2, "lat": 10, "lon": 12,
         "variant": "uniform", "tex_size": 32, "cutouts": 4,
         "leaf_cover": 0.3}
CONFIG = {"width": 64, "height": 36, "scene": SCENE}
TRAFFIC = {"samples_per_frame": 2, "trace_steps": 1,
           "check": {"pixels": "all", "steps": 3}}
SEED = 2**31 + 11


@pytest.fixture(autouse=True)
def _jax_loaded_by_the_suite(monkeypatch):
    """The suite's conftest loads JAX before any test, so ``run.main``'s
    check that a run loads no JAX cannot be made in this process (the
    benchmark's own tests, ``perfbench/tests``, make it)."""
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])


def run_small(trace=0, fault=None, seconds=1.0):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", CELL, "--seed", str(SEED),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      device="cpu", config_overrides=CONFIG,
                      traffic_overrides=TRAFFIC, fault=fault)
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 else None)


def _limits():
    with open(os.path.join(run.HERE, "limits", f"{CELL}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("trace", [0, 1])
def test_small_cell_is_correct(trace):
    rc, res = run_small(trace=trace)
    assert rc == 0
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert res["check"]["dropped"]["value"] == 0
    m = res["metrics"]
    if trace:
        assert m["tex_fetches.pbr"]["value"] == pytest.approx(4.0)
        assert m["cutout_share.pbr"]["value"] > 0.0
    else:
        assert {"setup_s", "mrays_s"} <= set(m)


def _after_setup(change):
    """A fault: ``change(sa)`` on the program's scene tensors after set-up,
    so every timed frame renders with it."""
    def fault(loop):
        setup = loop.setup

        def faulty():
            setup()
            change(loop.sa)
        loop.setup = faulty
    return fault


def _no_maps(*channels):
    def change(sa):
        for t in channels:
            sa.materials.tex_w[:, int(t)] = 0
    return change


def _opaque(sa):
    """Every texel's alpha byte set to 255."""
    full = torch.tensor(-(1 << 24), dtype=torch.int32)      # 0xFF000000
    sa.tex_texels.bitwise_or_(full)
    sa.tex_pairs.bitwise_or_(full)


FAULTS = {"normal_maps_ignored": _no_maps(TextureType.Normal),
          "metallic_roughness_ignored": _no_maps(TextureType.Roughness,
                                                 TextureType.Reflectivity),
          "cutout_alpha_forced_to_1": _opaque}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_fault_is_not_correct(name):
    rc, res = run_small(fault=_after_setup(FAULTS[name]))
    assert rc == 0
    assert not res["correct"], res["check"]


def test_control_fails_the_limits():
    r = control.readings(CELL, SEED, torch.bfloat16, "cpu", 4, CONFIG,
                         TRAFFIC)
    ok, shown = check.judge(r, _limits())
    assert not ok, shown


def _scene_file(scene, tmp_path):
    gen = named.find("scenes", scene["generator"])
    with open(os.path.join(run.HERE, "configs", "sponza_pbr.json")) as f:
        config = dict(json.load(f), **dict(CONFIG, scene=scene))
    data = gen.program_scene(config, 2)
    path = os.path.join(tmp_path, "scene.json")
    with open(path, "w") as f:
        json.dump(data, f)
    return gen, config, data, path


def test_glb_round_trips_through_the_loader(tmp_path):
    gen, config, data, _ = _scene_file(SCENE, str(tmp_path))
    meshes = gen.reference_data(config)[0]
    scene = Scene()
    scene.load_gltf(data["objects"][0]["path"])
    by_name = {m.name: m for m in scene.materials}
    assert len(by_name) == len(meshes) == 5
    for mesh in meshes:
        md = mesh["material"]
        m = by_name[md["name"]]
        base = m.get_texture(TextureType.Base)
        assert np.array_equal(base, md["base_color_texture"])
        nrm = md["normal_texture"].copy()
        nrm[..., 3] = 255
        assert np.array_equal(m.get_texture(TextureType.Normal), nrm)
        mr = md["metallic_roughness_texture"]
        for t, ch in ((TextureType.Reflectivity, 2),
                      (TextureType.Roughness, 1)):
            grey = m.get_texture(t)
            assert np.array_equal(grey, np.repeat(mr[..., ch:ch + 1], 4, -1))
    # the cut-out materials' masks cut out 1 - leaf_cover of their texels
    cut = [md["base_color_texture"][..., 3] for md in
           (m["material"] for m in meshes)
           if md["base_color_texture"][..., 3].min() < 255]
    assert len(cut) == SCENE["cutouts"]
    assert all(set(np.unique(a)) == {0, 255} for a in cut)
    share = np.mean([(a == 0).mean() for a in cut])
    assert abs(share - (1.0 - SCENE["leaf_cover"])) < 0.1


def _frame_counts(path, seed=5):
    scene = Scene()
    scene.load(path)
    sa, static = to_torch(*scene.compile(64, 36), "cpu")
    cfg = scene.raytracing_config
    wavefront.reset_shading()
    out = render(sa, static, cfg, EngineConfig(seed=seed))
    return out, {k: int(v) for k, v in wavefront.shading.items()}


def test_census_is_steady_and_off_for_base_maps(tmp_path, monkeypatch):
    _, _, _, path = _scene_file(SCENE, str(tmp_path))
    a, ca = _frame_counts(path)
    b, cb = _frame_counts(path)
    assert np.array_equal(a["color"], b["color"])
    assert ca == cb and ca["hits"] > 0 and ca["cutout"] > 0
    assert ca["fetches"] == 4 * ca["hits"]

    still = dict(SCENE, generator="sponza_class")
    for k in ("tex_size", "cutouts", "leaf_cover"):
        still.pop(k)
    os.makedirs(os.path.join(str(tmp_path), "still"))
    _, _, _, path = _scene_file(still, os.path.join(str(tmp_path), "still"))
    _, cs = _frame_counts(path)
    assert cs == {"hits": 0, "cutout": 0, "fetches": 0}

    # a program with no census: the readers read nothing, and do not raise
    monkeypatch.setitem(sys.modules, "rustray_tpu_torch.render.wavefront",
                        types.SimpleNamespace())
    for name in ("tex_fetches.pbr", "cutout_share.pbr"):
        assert run.reader(name)(None) is None
