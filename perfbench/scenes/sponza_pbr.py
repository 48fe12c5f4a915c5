"""The sponza-class scene with the glTF Sponza's material model: the
geometry, lights and camera of ``sponza_class`` (``procedural.
sponza_class_data``), and on every material three maps of its own, each
``tex_size``² and drawn from a fixed seed:

- base colour RGBA: smooth colour noise; opaque, except on ``cutouts`` of
  the sphere materials (a seeded choice), whose alpha is a binary lattice
  of leaves covering ``leaf_cover`` of the texels (0.6: about 40% at 0),
  as glTF ``MASK`` foliage cuts out leaves, plants and chains;
- a tangent-space normal map of seeded bumps (two octaves of smooth noise
  as a height field);
- a metallic-roughness map: G roughness, B metallic, smooth noise.

Written as a GLB (``assets/gltf_pbr_writer.py``) and loaded as a glTF
object of a JSON scene.  Parameters: ``grid``, ``lat``, ``lon``,
``variant``, ``tex_size``, ``cutouts``, ``leaf_cover``."""
from __future__ import annotations

import os

import numpy as np

from ..assets import files, procedural
from ..assets.gltf_pbr_writer import write_pbr_glb
from ..reference import pbr as rpbr

PARAMS = ("grid", "lat", "lon", "variant", "tex_size", "cutouts",
          "leaf_cover")
TEX_SEED = 22
# leaves per texture side in a cut-out mask (cells of 8 texels at least)
LEAVES = 32
# the normal map's height-field scale, per unit of uv
BUMP = 0.025


def _smooth(rng, size: int, cells: int) -> np.ndarray:
    """(size, size) values in [0, 1]: a (cells + 1)² grid of uniforms
    interpolated with smoothstep weights (continuous slopes)."""
    g = rng.uniform(size=(cells + 1, cells + 1))
    x = (np.arange(size) + 0.5) * (cells / size)
    i = np.minimum(x.astype(np.int64), cells - 1)
    f = x - i
    f = f * f * (3.0 - 2.0 * f)
    a = np.zeros((size, cells + 1))
    a[np.arange(size), i] = 1.0 - f
    a[np.arange(size), i + 1] = f
    return a @ g @ a.T


def _u8(x) -> np.ndarray:
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def leaf_mask(rng, size: int, cover: float) -> np.ndarray:
    """(size, size) bool, True where a leaf is: LEAVES² cells, each holding
    an ellipse turned by a seeded angle, covering ``cover`` of it."""
    cell = max(8, size // LEAVES)
    n = -(-size // cell)
    a = 0.47 * cell
    b = cover * cell * cell / (np.pi * a)
    ang = rng.uniform(0.0, np.pi, (n, n))
    y, x = np.mgrid[0:size, 0:size]
    cy, cx = y // cell, x // cell
    ly = (y % cell) + 0.5 - cell / 2.0
    lx = (x % cell) + 0.5 - cell / 2.0
    c, s = np.cos(ang[cy, cx]), np.sin(ang[cy, cx])
    u = c * lx + s * ly
    v = -s * lx + c * ly
    return (u / a) ** 2 + (v / b) ** 2 <= 1.0


def base_map(rng, size: int, cover) -> np.ndarray:
    """Base colour; ``cover``: the leaf mask's cover, None for opaque."""
    rgb = np.stack([0.6 * _smooth(rng, size, 6) + 0.4 * _smooth(rng, size, 48)
                    for _ in range(3)], -1)
    img = np.empty((size, size, 4), np.uint8)
    img[..., :3] = _u8(255.0 * (0.55 + 0.45 * rgb))
    img[..., 3] = 255 if cover is None else \
        np.where(leaf_mask(rng, size, cover), 255, 0)
    return img


def normal_map(rng, size: int) -> np.ndarray:
    h = 0.7 * _smooth(rng, size, 12) + 0.3 * _smooth(rng, size, 40)
    gy, gx = np.gradient(h)
    n = np.stack([-BUMP * size * gx, -BUMP * size * gy, np.ones_like(h)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    img = np.full((size, size, 4), 255, np.uint8)
    img[..., :3] = _u8(255.0 * (0.5 * n + 0.5))
    return img


def metallic_roughness_map(rng, size: int) -> np.ndarray:
    img = np.full((size, size, 4), 255, np.uint8)
    img[..., 1] = _u8(255.0 * (0.05 + 0.55 * _smooth(rng, size, 10)))
    img[..., 2] = _u8(255.0 * 0.45 * _smooth(rng, size, 10))
    return img


def pbr_data(grid: int, lat: int, lon: int, variant: str, tex_size: int,
             cutouts: int, leaf_cover: float):
    """(meshes, lights, camera): ``sponza_class_data``'s, each material
    carrying its base-colour, normal and metallic-roughness maps."""
    meshes, lights, camera = procedural.sponza_class_data(grid, lat, lon,
                                                          variant)
    rng = np.random.default_rng(TEX_SEED)
    spheres = len(meshes) - 1                      # the floor is last
    cut = set(rng.choice(spheres, size=min(cutouts, spheres),
                         replace=False).tolist())
    out = []
    for i, m in enumerate(meshes):
        md = dict(m["material"])
        md.update(base_color_texture=base_map(
                      rng, tex_size, leaf_cover if i in cut else None),
                  normal_texture=normal_map(rng, tex_size),
                  metallic_roughness_texture=metallic_roughness_map(
                      rng, tex_size))
        out.append(dict(m, material=md))
    return out, lights, camera


def program_scene(config: dict, samples: int) -> dict:
    scene = config["scene"]
    glb = os.path.join(files.asset_dir(scene), "scene.glb")
    files.write_once(glb, lambda p: write_pbr_glb(
        p, *pbr_data(*(scene[k] for k in PARAMS))))
    # no object name: the meshes keep their own names (ball{gx}_{gz})
    return {"name": "SponzaPBR",
            "config": files.render_config(config, samples),
            "objects": [{"type": "gltf", "path": glb}]}


def reference_data(config: dict):
    scene = config["scene"]
    return pbr_data(*(scene[k] for k in PARAMS))


def reference_scene(config: dict, data, samples: int):
    return rpbr.pbr_scene(data, *files.reference_args(config, samples))
