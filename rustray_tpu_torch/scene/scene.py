"""Scene graph: items, lights, materials, camera, animation + loaders.

Reference: ``Scene`` (src/scene.rs:69-1857).  Monotonic ids
(src/scene.rs:114-119), extension-dispatched loading (src/scene.rs:121-157),
default-environment search (src/scene.rs:1549-1562) and per-frame animation
application (src/scene.rs:1695-1713) are replicated.

The compiled device representation is produced by
:mod:`rustray_tpu.scene.compile`.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .. import spans
from ..config import PostProcessingConfig, RaytracingConfig
from .animation import Animation
from .camera import Camera, DEFAULT_FOV_DEG
from .light import Light, LightType
from .material import Material
from .shapes import Shape

# Oblique direction used by the automatic camera search — src/camera.rs:10.
OBLIQUE_CAM_POS = np.array([-0.5, 0.5, 1.0], np.float32)


@dataclass
class Scene:
    item_id: int = 0
    cam: Camera = field(default_factory=Camera)
    items: List[Shape] = field(default_factory=list)
    lights: List[Light] = field(default_factory=list)
    materials: List[Material] = field(default_factory=list)
    animation: Animation = field(default_factory=Animation)
    raytracing_config: RaytracingConfig = field(default_factory=RaytracingConfig)
    post_processing: PostProcessingConfig = field(default_factory=PostProcessingConfig)

    def clear(self) -> None:  # src/scene.rs:106-112
        self.item_id = 0
        self.items.clear()
        self.lights.clear()
        self.materials.clear()

    def get_next_id(self) -> int:  # src/scene.rs:114-119
        self.item_id += 1
        return self.item_id

    # ----- loading (src/scene.rs:121-157) -----

    def load(self, path: str) -> List[int]:
        from ..utils.assets import resolve_path
        path = resolve_path(path)
        ext = os.path.splitext(path)[1].lower()
        if ext == ".json":
            loaded = self.load_json(path)
        elif ext in (".gltf", ".glb"):
            loaded = self.load_gltf(path)
        elif ext == ".obj":
            loaded = self.load_wavefront(path)
        else:
            print(f"can not load {path}")
            return []
        self.init()
        self.update()
        return loaded

    def load_json(self, path: str) -> List[int]:
        from .json_loader import load_json
        return load_json(self, path)

    def load_gltf(self, path: str) -> List[int]:
        from .gltf_loader import load_gltf
        return load_gltf(self, path)

    def load_wavefront(self, path: str) -> List[int]:
        from .obj_loader import load_wavefront
        return load_wavefront(self, path)

    # ----- lights (src/scene.rs:1369-1401) -----

    def add_light(self, name, pos, dir, color, intensity, max_angle, light_type) -> None:
        self.lights.append(Light(
            enabled=True, id=self.get_next_id(), name=name,
            pos=np.asarray(pos, np.float32), dir=np.asarray(dir, np.float32),
            color=np.asarray(color, np.float32), intensity=float(intensity),
            max_angle=float(max_angle), light_type=light_type))

    def add_default_light(self) -> None:
        self.add_light("default", (-2.0, 10.0, 5.0), (0.0, -1.0, 0.0),
                       (1.0, 1.0, 1.0), 200.0, np.pi / 2, LightType.Point)

    # ----- auto environment (src/scene.rs:1403-1578) -----

    def _world_bbox_points(self) -> np.ndarray:
        pts = []
        for item in self.items:
            lo, hi = item.local_bbox()
            corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                                for y in (lo[1], hi[1]) for z in (lo[2], hi[2])], np.float32)
            trans = item.basic.trans
            world = (trans[:3, :3] @ corners.T).T + trans[:3, 3]
            pts.append(world)
        if not pts:
            return np.zeros((0, 3), np.float32)
        return np.concatenate(pts)

    def find_bottom_y_pos(self) -> float:
        pts = self._world_bbox_points()
        return float(pts[:, 1].min()) if len(pts) else float("inf")

    def find_optimal_camera_pos(self) -> None:
        """Incremental dolly-out + fov search — src/scene.rs:1426-1547."""
        pts = self._world_bbox_points()
        if len(pts) == 0:
            return
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        center = (lo + hi) / 2.0
        direction = OBLIQUE_CAM_POS / np.linalg.norm(OBLIQUE_CAM_POS)
        self.cam.eye_pos = center.copy()

        factor, increment, max_factor, padding = 0.0, 0.01, 1000.0, 1.001
        while factor < max_factor:
            self.cam.eye_pos = center + direction * factor
            self.cam.dir = -direction
            self.cam.init_matrices()
            if all(self.cam.is_point_in_frustum(p) for p in pts):
                self.cam.eye_pos = self.cam.eye_pos + direction * padding
                break
            factor += increment

        fov, increment, fov_padding = 0.0, 0.01, 1.1
        while fov < DEFAULT_FOV_DEG:
            self.cam.fov = float(np.radians(fov))
            self.cam.init_matrices()
            if all(self.cam.is_point_in_frustum(p) for p in pts):
                self.cam.fov *= fov_padding
                break
            fov += increment
        self.cam.init_matrices()

    def find_and_set_default_env_if_needed(self) -> None:  # src/scene.rs:1549-1562
        if self.cam.is_default_cam():
            print("default camera options detected -> trying to find optimal camera pos")
            self.find_optimal_camera_pos()
        if len(self.lights) == 0:
            print("no lights in the scene found --> adding default light")
            self.add_default_light()

    def add_ground_plane(self, scene_dir: str = "scene") -> None:  # src/scene.rs:1564-1573
        y = self.find_bottom_y_pos()
        self.load_json(os.path.join(scene_dir, "floor_reflective.json"))
        item = self.get_by_name("floor reflective")
        if item is not None:
            item.basic.apply_translation((0.0, y, 0.0))

    def add_environment_sphere(self, scene_dir: str = "scene") -> None:
        self.load_json(os.path.join(scene_dir, "environment.json"))

    # ----- CRUD (src/scene.rs:1580-1801) -----

    def delete_light_by_id(self, id: int) -> None:
        self.lights = [l for l in self.lights if l.id != id]

    def delete_object_by_id(self, id: int) -> None:
        self.items = [i for i in self.items if i.basic.id != id]

    def get_material_by_id(self, id: int) -> Optional[Material]:
        for m in self.materials:
            if m.id == id:
                return m
        return None

    def get_by_name(self, name: str) -> Optional[Shape]:
        for item in self.items:
            if item.basic.name == name:
                return item
        return None

    def get_obj_by_id(self, id: int) -> Optional[Shape]:
        for item in self.items:
            if item.basic.id == id:
                return item
        return None

    def get_light_by_id(self, id: int) -> Optional[Light]:
        for l in self.lights:
            if l.id == id:
                return l
        return None

    def get_vec_by_name(self, name: str) -> List[Shape]:
        return [i for i in self.items if i.basic.name == name]

    # ----- lifecycle (src/scene.rs:1666-1713) -----

    def init(self) -> None:
        for item in self.items:
            item.init()

    @spans.timed("session.update")
    def update(self) -> None:
        for item in self.items:
            item.update()

    def frame_exists(self, frame: int) -> bool:
        return self.animation.has_animation() and frame < self.animation.get_frames_amount_to_render()

    @spans.timed("session.apply_frame")
    def apply_frame(self, frame: int) -> bool:
        if not self.animation.has_animation() or frame > self.animation.get_frames_amount_to_render():
            return False
        for item in self.items:
            trans = self.animation.get_trans_for_frame(frame, item.basic.name)
            if trans is not None:
                item.basic.apply_mat(trans)
        return True

    # ----- compile to device arrays -----

    def compile(self, width: int = 0, height: int = 0):
        from .compile import compile_scene
        return compile_scene(self, width, height)

    def print(self) -> None:  # src/scene.rs:1803-1856
        print("\nconfig:\n======")
        self.raytracing_config.print()
        print("\ncam:\n==========")
        self.cam.print()
        print("\nlights:\n==========")
        for l in self.lights:
            print(f" - {l.light_type.name}: pos: {l.pos}, dir: {l.dir}, color: {l.color}, "
                  f"intensity: {l.intensity}, max_angle: {l.max_angle}")
        print("\nscene:\n==========")
        for item in self.items:
            m = item.get_material()
            print(f" - {item.basic.id}: {item.basic.name} (visible: {item.basic.visible})")
        print("\nanimation:\n==========")
        print(f"activated: {self.animation.has_animation()}")
        print(f"fps: {self.animation.fps}")
        print(f"frames_to_render: {self.animation.get_frames_amount_to_render()}")
