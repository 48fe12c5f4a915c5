"""The reference's scene: plain arrays built from the generator's data
with the semantics of upstream rustray's loaders, never from the program's
loaders or compiled arrays.

The loaders' rules it follows (upstream ``src/scene.rs``):
- ids: one counter from 1 in load order.  A JSON scene's lights take ids
  first, then each object takes one for its material and one for itself;
  a glTF object takes one for its JSON material, then the file's lights,
  then per mesh one for the object and one for its material.
- glTF meshes are baked into world space by their node translation; the
  v coordinate is flipped; PBR maps to Phong as specular = 0.8 base,
  alpha = base alpha, reflectivity = metallic / 2, roughness =
  roughness / 2π.  A point light's intensity is divided by 10; a
  directional light shines along its node's -z axis.
- JSON spheres and planes keep the material defaults below unless the
  object sets them; a plane has no vertex normals (flat shading).
Only translations move objects (the configurations move nothing else), so
intersections run in world space.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..assets import procedural

SPHERE, MESH = "sphere", "mesh"
DIRECTIONAL, POINT, SPOT = 0, 1, 2


@dataclass
class Material:
    base: np.ndarray = field(default_factory=lambda: np.ones(3))
    specular: np.ndarray = field(default_factory=lambda: np.full(3, 0.8))
    ambient: np.ndarray = field(default_factory=lambda: np.zeros(3))
    alpha: float = 1.0
    shininess: float = 150.0
    reflectivity: float = 0.0
    refraction_index: float = 1.0
    shadow_softness: float = 0.01
    roughness: float = 0.0
    monte_carlo: bool = True
    receive_shadow: bool = True
    cast_shadow: bool = True
    reflection_only: bool = False
    backface_culling: bool = True
    smooth_shading: bool = True
    nearest: bool = False
    texture: Optional[np.ndarray] = None      # base colour, (H, W, 4) uint8


@dataclass
class Item:
    kind: str
    obj_id: int
    material: int
    name: str = ""
    center: Optional[np.ndarray] = None       # sphere
    radius: float = 0.0
    tris: Optional[np.ndarray] = None         # mesh, (T, 3, 3) world space
    normals: Optional[np.ndarray] = None      # (T, 3, 3) or None
    uvs: Optional[np.ndarray] = None          # (T, 3, 2) or None
    offset: np.ndarray = field(default_factory=lambda: np.zeros(3))


@dataclass
class Light:
    kind: int
    pos: np.ndarray
    dir: np.ndarray
    color: np.ndarray
    intensity: float
    max_angle: float = float(np.pi / 2)
    enabled: bool = True


@dataclass
class Camera:
    eye: np.ndarray
    dir: np.ndarray
    up: np.ndarray
    fov: float
    near: float
    far: float

    def matrices(self, width: int, height: int):
        """(projection inverse, view inverse), float64: nalgebra's
        Perspective3 and Isometry3::look_at_rh."""
        aspect = width / height
        f = 1.0 / np.tan(self.fov / 2.0)
        n, fa = self.near, self.far
        proj = np.zeros((4, 4))
        proj[0, 0] = f / aspect
        proj[1, 1] = f
        proj[2, 2] = -(fa + n) / (fa - n)
        proj[2, 3] = -(2.0 * fa * n) / (fa - n)
        proj[3, 2] = -1.0
        fwd = self.dir / np.linalg.norm(self.dir)
        s = np.cross(fwd, self.up)
        s = s / np.linalg.norm(s)
        u = np.cross(s, fwd)
        view = np.eye(4)
        view[0, :3], view[1, :3], view[2, :3] = s, u, -fwd
        view[0, 3] = -s @ self.eye
        view[1, 3] = -u @ self.eye
        view[2, 3] = fwd @ self.eye
        return np.linalg.inv(proj), np.linalg.inv(view)


@dataclass
class RefScene:
    items: List[Item]
    materials: List[Material]
    lights: List[Light]
    camera: Camera
    width: int
    height: int
    samples: int
    monte_carlo: bool
    max_recursion: int
    fog_density: float = 0.0
    fog_color: tuple = (0.4, 0.4, 0.4)
    # a shift of every primary ray's point on the near plane, in normalised
    # device coordinates: a camera jittered below a pixel
    ndc_shift: tuple = (0.0, 0.0)


def _f32(v):
    """A value as the loaders read it: float32, then widened."""
    return np.asarray(v, np.float32).astype(np.float64)


def sponza_scene(data, width: int, height: int, samples: int,
                 monte_carlo: bool, max_recursion: int) -> RefScene:
    """The sponza-class scene from its generator's (meshes, lights,
    camera), loaded as a glTF object of a JSON scene."""
    meshes, lights_in, cam = data
    next_id = iter(range(1, 1 << 30))
    next(next_id)                                  # the JSON object's material
    lights = []
    for li in lights_in:
        next(next_id)
        color = _f32(li.get("color", (1, 1, 1)))
        if li["type"] == "point":
            lights.append(Light(POINT, _f32(li["position"]),
                                np.array([0.0, -1.0, 0.0]), color,
                                float(li["intensity"]) / 10.0))
        elif li["type"] == "directional":
            d = np.asarray(li["direction"], np.float64)
            lights.append(Light(DIRECTIONAL, np.zeros(3),
                                _f32(d / np.linalg.norm(d)), color,
                                float(li["intensity"])))
        else:
            raise ValueError("the reference knows point and directional "
                             "glTF lights only")
    items, materials = [], []
    for m in meshes:
        obj_id = next(next_id)
        next(next_id)                              # its material
        md = m["material"]
        base = _f32(md["base_color"])
        mat = Material(base=base[:3], specular=_f32(base[:3].astype(
            np.float32) * np.float32(0.8)), alpha=float(base[3]),
            reflectivity=float(md["metallic"]) * 0.5,
            roughness=float((1.0 / np.pi / 2.0) * md["roughness"]),
            texture=md.get("base_color_texture"))
        materials.append(mat)
        pos = np.asarray(m["positions"], np.float32)
        tr = np.asarray(m.get("translation", (0, 0, 0)), np.float32)
        idx = np.asarray(m["indices"]).reshape(-1, 3)
        world = (pos + tr).astype(np.float64)
        uv = None
        if m.get("uvs") is not None:
            uv = np.asarray(m["uvs"], np.float32).astype(np.float64)
            uv = np.stack([uv[:, 0], 1.0 - uv[:, 1]], -1)[idx]
        nrm = None
        if m.get("normals") is not None:
            nrm = np.asarray(m["normals"], np.float32).astype(np.float64)[idx]
        items.append(Item(MESH, obj_id, len(materials) - 1, m["name"],
                          tris=world[idx], normals=nrm, uvs=uv))
    d = np.asarray(cam["dir"], np.float64)
    d = d / np.linalg.norm(d)
    x = np.cross(d, np.asarray(cam["up"], np.float64))
    x = x / np.linalg.norm(x)
    up = np.cross(x, d)
    camera = Camera(_f32(cam["eye"]), _f32(d), _f32(up / np.linalg.norm(up)),
                    float(cam["yfov"]), float(cam["znear"]),
                    float(cam["zfar"]))
    return RefScene(items, materials, lights, camera, width, height, samples,
                    monte_carlo, max_recursion)


def spheres_scene(camera: dict, width: int, height: int, samples: int,
                  monte_carlo: bool, max_recursion: int) -> RefScene:
    """The analytic spheres and the textured floor quad of
    ``procedural.SPHERE_SPECS``, loaded as JSON objects."""
    next_id = iter(range(1, 1 << 30))
    lights = []
    for _, kind, pos, dr, inten in procedural.SPHERE_LIGHTS:
        next(next_id)
        lights.append(Light(POINT if kind == "point" else DIRECTIONAL,
                            _f32(pos), _f32(dr), np.ones(3), float(inten)))
    items, materials = [], []
    for i, (pos, r, color, refl, alpha) in enumerate(procedural.SPHERE_SPECS):
        next(next_id)
        base = _f32(color)
        materials.append(Material(
            base=base, specular=_f32(np.asarray(color, np.float32)
                                     * np.float32(
                                         procedural.SPHERE_SPECULAR_FACTOR)),
            reflectivity=float(refl), alpha=float(alpha),
            refraction_index=procedural.SPHERE_REFRACTION_INDEX))
        items.append(Item(SPHERE, next(next_id), len(materials) - 1,
                          f"sphere{i}", center=_f32(pos), radius=float(r)))
    next(next_id)
    materials.append(Material(base=_f32(procedural.FLOOR_COLOR),
                              reflectivity=procedural.FLOOR_REFLECTIVITY,
                              texture=procedural.checkerboard_texture(64, 8)))
    v = _f32(procedural.FLOOR_VERTICES)
    tris = np.stack([v[[0, 1, 2]], v[[0, 2, 3]]])
    quad_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    items.append(Item(MESH, next(next_id), len(materials) - 1, "floor",
                      tris=tris, uvs=np.stack([quad_uv[[0, 1, 2]],
                                               quad_uv[[0, 2, 3]]])))
    cam = Camera(_f32(camera["pos"]), _f32(camera["dir"]), _f32(camera["up"]),
                 float(np.radians(camera["fov_deg"])),
                 float(camera["z_near"]), float(camera["z_far"]))
    return RefScene(items, materials, lights, cam, width, height, samples,
                    monte_carlo, max_recursion)
