"""The benchmark's scene generators, frozen.

Copies of the port's procedural generators as they stood when the
benchmark was defined (``rustray_tpu_torch/models/procedural.py``:
``checkerboard_texture``, ``uv_sphere_arrays``, ``ensure_bench_assets``
and the specs of ``demo_spheres_scene``), so that a later change to the
program cannot change what the benchmark renders.  The sponza-class data
is returned as plain arrays and dicts: the GLB writer turns it into the
file the program loads, and the reference builds its own scene from the
same data.  ``tests/test_perfbench_assets.py`` holds the GLB to the port's
generator byte for byte.
"""
from __future__ import annotations

import numpy as np

from .gltf_writer import write_glb


def checkerboard_texture(size: int = 64, cells: int = 8) -> np.ndarray:
    y, x = np.mgrid[0:size, 0:size]
    c = (((x * cells // size) + (y * cells // size)) % 2).astype(np.uint8)
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 0] = img[..., 1] = img[..., 2] = 64 + c * 160
    img[..., 3] = 255
    return img


def uv_sphere_arrays(radius: float = 1.0, lat: int = 16, lon: int = 24):
    """Raw (verts, normals, uvs, tris) arrays of a UV sphere."""
    phis = np.linspace(0, np.pi, lat + 1)
    thetas = np.linspace(0, 2 * np.pi, lon + 1)
    pp, tt = np.meshgrid(phis, thetas, indexing="ij")
    normals = np.stack([np.sin(pp) * np.cos(tt), np.cos(pp),
                        np.sin(pp) * np.sin(tt)], axis=-1).reshape(-1, 3)
    verts = (normals * radius).astype(np.float32)
    uvs = np.stack([tt / (2 * np.pi), pp / np.pi], -1).reshape(-1, 2)
    tris = []
    w = lon + 1
    for i in range(lat):
        base = i * w + np.arange(lon)
        a, b_, c, d = base, base + 1, base + w, base + w + 1
        if i > 0:
            tris.append(np.stack([a, c, b_], 1))
        if i < lat - 1:
            tris.append(np.stack([b_, c, d], 1))
    tris = np.concatenate(tris).astype(np.int32)
    return verts, normals.astype(np.float32), uvs.astype(np.float32), tris


def sponza_class_data(grid: int = 6, lat: int = 52, lon: int = 68,
                      variant: str = "uniform"):
    """(meshes, lights, camera) of the sponza-class scene: grid² dense
    UV-sphere meshes over a textured floor, textured PBR materials, two
    point lights and a sun, one camera, in the GLB writer's dicts.
    ``variant="skewed"`` gives power-law tessellations, mixed radii and
    two clumps at a comparable triangle count."""
    rng = np.random.default_rng(7)
    tex = checkerboard_texture(128, 16)
    verts, normals, uvs, tris = uv_sphere_arrays(1.0, lat, lon)
    meshes = []
    n_balls = grid * grid
    if variant == "skewed":
        u = rng.uniform(size=n_balls)
        scale = 0.15 + 3.0 * u ** 4
        scale *= np.sqrt(n_balls / np.sum(scale ** 2))
        radii = 0.25 + 3.25 * rng.uniform(size=n_balls) ** 2.5
        centers = np.where(rng.uniform(size=(n_balls, 1)) < 0.7,
                           np.array([[-5.0, 0.0, -8.0]]),
                           np.array([[9.0, 0.0, -26.0]]))
        pos = centers + rng.normal(scale=2.2, size=(n_balls, 3)) \
            * np.array([1.0, 0.35, 1.0])
        pos[:, 1] = np.maximum(pos[:, 1], radii - 1.2)
    for b in range(n_balls):
        gx, gz = b // grid, b % grid
        if variant == "skewed":
            li = max(4, int(round(lat * scale[b])))
            lo_ = max(6, int(round(lon * scale[b])))
            v_b, n_b, uv_b, t_b = uv_sphere_arrays(float(radii[b]), li, lo_)
            translation = tuple(float(x) for x in pos[b])
        else:
            v_b, n_b, uv_b, t_b = verts, normals, uvs, tris
            translation = (2.6 * (gx - (grid - 1) / 2), 0.0,
                           -6.0 - 2.6 * gz)
        meshes.append(dict(
            name=f"ball{gx}_{gz}", positions=v_b, indices=t_b,
            normals=n_b, uvs=uv_b,
            translation=translation,
            material=dict(
                name=f"m{gx}_{gz}",
                base_color=tuple(rng.uniform(0.3, 1.0, 3)) + (1.0,),
                metallic=float(rng.uniform(0.0, 0.8)),
                roughness=float(rng.uniform(0.0, 0.5)),
                base_color_texture=tex)))
    fv = np.array([[-40, -1.2, 10], [40, -1.2, 10], [40, -1.2, -60],
                   [-40, -1.2, -60]], np.float32)
    meshes.append(dict(
        name="floor", positions=fv,
        indices=np.array([[0, 2, 1], [0, 3, 2]], np.int32),
        normals=np.tile(np.array([[0, 1, 0]], np.float32), (4, 1)),
        uvs=np.array([[0, 0], [8, 0], [8, 8], [0, 8]], np.float32),
        material=dict(name="floor", base_color=(0.7, 0.7, 0.7, 1.0),
                      metallic=0.6, roughness=0.0,
                      base_color_texture=tex)))
    lights = [
        dict(type="point", position=(-6.0, 12.0, 0.0), color=(1, 1, 1),
             intensity=5000.0, name="key"),
        dict(type="point", position=(8.0, 6.0, -4.0),
             color=(1.0, 0.9, 0.8), intensity=2000.0, name="fill"),
        dict(type="directional", direction=(0.5, -1.0, -0.3),
             color=(1, 1, 1), intensity=0.5, name="sun"),
    ]
    camera = dict(eye=(0.0, 3.0, 4.0), dir=(0.0, -0.25, -1.0),
                  up=(0, 1, 0), yfov=np.pi / 2, znear=0.001, zfar=1000.0)
    return meshes, lights, camera


def write_sponza_glb(path: str, grid: int = 6, lat: int = 52, lon: int = 68,
                     variant: str = "uniform") -> None:
    """The sponza-class GLB that the port's ``ensure_bench_assets`` writes
    for the same parameters."""
    write_glb(path, *sponza_class_data(grid, lat, lon, variant))


# demo_spheres_scene: (centre, radius, base colour, reflectivity, alpha);
# every sphere refracts with index 1.5 and its specular colour is 0.8 of
# its base colour
SPHERE_SPECS = [
    ((0.0, 0.0, -6.0), 1.5, (1.0, 0.2, 0.2), 0.3, 1.0),
    ((-3.0, 0.5, -8.0), 1.5, (0.2, 1.0, 0.2), 0.5, 0.8),
    ((3.0, -0.5, -7.0), 1.2, (0.2, 0.2, 1.0), 0.1, 0.6),
    ((0.0, 2.5, -9.0), 1.0, (1.0, 1.0, 1.0), 1.0, 1.0),
]
SPHERE_REFRACTION_INDEX = 1.5
SPHERE_SPECULAR_FACTOR = 0.8
# the floor quad, its base colour and reflectivity; textured with
# checkerboard_texture(64, 8)
FLOOR_VERTICES = ((-12, -2.5, 2), (12, -2.5, 2), (12, -2.5, -20),
                  (-12, -2.5, -20))
FLOOR_COLOR = (0.6, 0.6, 0.9)
FLOOR_REFLECTIVITY = 0.2
# (name, kind, position, direction, intensity), white
SPHERE_LIGHTS = [
    ("key", "point", (-4.0, 8.0, 2.0), (0.0, -1.0, 0.0), 300.0),
    ("sun", "directional", (0.0, 0.0, 0.0), (1.0, -1.0, -0.5), 0.6),
]
