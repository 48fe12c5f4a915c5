"""The sponza-class scene: grid² dense UV-sphere meshes over a textured
floor, textured PBR materials, two point lights and a sun, one camera,
written as a GLB (``assets/procedural.py``) and loaded as a glTF object of
a JSON scene.  Parameters: ``grid``, ``lat``, ``lon``, ``variant``."""
from __future__ import annotations

import os

from ..assets import files, procedural
from ..reference import scene as rscene

PARAMS = ("grid", "lat", "lon", "variant")


def program_scene(config: dict, samples: int) -> dict:
    scene = config["scene"]
    params = {k: scene[k] for k in PARAMS}
    glb = os.path.join(files.asset_dir(scene), "scene.glb")
    files.write_once(glb, lambda p: procedural.write_sponza_glb(p, **params))
    # no object name: the meshes keep their own names (ball{gx}_{gz})
    return {"name": "SponzaClass",
            "config": files.render_config(config, samples),
            "objects": [{"type": "gltf", "path": glb}]}


def reference_data(config: dict):
    scene = config["scene"]
    return procedural.sponza_class_data(*(scene[k] for k in PARAMS))


def reference_scene(config: dict, data, samples: int):
    return rscene.sponza_scene(data, *files.reference_args(config, samples))
