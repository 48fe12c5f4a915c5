"""The spheres scene: the analytic spheres of ``procedural.SPHERE_SPECS``
(reflective, three of them refracting) over a checkerboard-textured
reflective floor quad, a point light and a sun, as JSON objects, with the
camera that the configuration's ``scene.camera`` sets."""
from __future__ import annotations

import os

from ..assets import files, procedural
from ..reference import scene as rscene


def program_scene(config: dict, samples: int) -> dict:
    scene = config["scene"]
    tex = os.path.join(files.asset_dir(scene), "checker64.png")
    files.write_once(tex, files.png(procedural.checkerboard_texture(64, 8)))
    cam = scene["camera"]
    objects = []
    for i, (pos, r, color, refl, alpha) in enumerate(
            procedural.SPHERE_SPECS):
        objects.append({
            "name": f"sphere{i}", "type": "sphere", "pos": files.vec(pos),
            "radius": r,
            "color": {"base": files.rgb(color),
                      "specular": {"factor":
                                   procedural.SPHERE_SPECULAR_FACTOR}},
            "reflectivity": refl, "alpha": alpha,
            "refraction_index": procedural.SPHERE_REFRACTION_INDEX})
    objects.append({
        "name": "floor", "type": "plane",
        "vertices": [files.vec(v) for v in procedural.FLOOR_VERTICES],
        "color": {"base": files.rgb(procedural.FLOOR_COLOR)},
        "reflectivity": procedural.FLOOR_REFLECTIVITY,
        "texture": {"base": tex}})
    lights = [{"pos": files.vec(pos), "dir": files.vec(dr),
               "color": files.rgb((1, 1, 1)), "intensity": inten,
               "light_type": kind}
              for _, kind, pos, dr, inten in procedural.SPHERE_LIGHTS]
    return {"name": "Spheres", "config": files.render_config(config, samples),
            "camera": {"pos": files.vec(cam["pos"]),
                       "dir": files.vec(cam["dir"]),
                       "up": files.vec(cam["up"]), "fov": cam["fov_deg"],
                       "z_near": cam["z_near"], "z_far": cam["z_far"]},
            "lights": lights, "objects": objects}


def reference_data(config: dict):
    return None


def reference_scene(config: dict, data, samples: int):
    return rscene.spheres_scene(config["scene"]["camera"],
                                *files.reference_args(config, samples))
