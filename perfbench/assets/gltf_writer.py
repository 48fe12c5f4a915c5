"""Minimal glTF 2.0 / GLB writer, frozen for the benchmark.

A copy of the GLB writer of ``rustray_tpu_torch/scene/gltf_writer.py`` as
it stood when the benchmark was defined, so that the benchmark writes its
own scene assets and a later change to the program's writer cannot change
the scenes the benchmark measures (``tests/test_perfbench_assets.py``
holds the two to the same bytes).  Writes meshes (POSITION/NORMAL/
TEXCOORD_0 + uint32 indices, per-node translation), pbrMetallicRoughness
materials with an optional embedded-PNG baseColorTexture,
KHR_lights_punctual lights and one perspective camera.
"""
from __future__ import annotations

import io
import json
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np


def _align(buf: bytearray, n: int = 4, fill: bytes = b"\x00") -> None:
    while len(buf) % n:
        buf.extend(fill)


class _BufferBuilder:
    def __init__(self):
        self.data = bytearray()
        self.views: List[dict] = []

    def add(self, raw: bytes, target: Optional[int] = None) -> int:
        _align(self.data)
        view = {"buffer": 0, "byteOffset": len(self.data), "byteLength": len(raw)}
        if target is not None:
            view["target"] = target
        self.data.extend(raw)
        self.views.append(view)
        return len(self.views) - 1


def _png_bytes(rgba: np.ndarray) -> bytes:
    from PIL import Image
    bio = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(rgba)).save(bio, format="PNG")
    return bio.getvalue()


def _look_matrix(eye, direction, up) -> list:
    """Node matrix (glTF column-major list) whose -z axis is ``direction``."""
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    u = np.asarray(up, np.float64)
    x = np.cross(d, u)
    x = x / max(np.linalg.norm(x), 1e-12)
    y = np.cross(x, d)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, y, -d, np.asarray(eye, np.float64)
    return [float(v) for v in m.T.reshape(-1)]  # column-major


def write_glb(path: str, meshes: Sequence[dict], lights: Sequence[dict] = (),
              camera: Optional[dict] = None) -> None:
    """Write a GLB.

    ``meshes``: dicts with
      - name: str
      - positions (V, 3) float32, indices (T, 3) any-int
      - normals (V, 3) float32 or None, uvs (V, 2) float32 or None
      - translation (3,) optional node translation
      - material: dict(name, base_color (3 or 4,), metallic float,
        roughness float, base_color_texture (H, W, 4) uint8 or None)
    ``lights``: dicts(type="point"|"directional"|"spot", color (3,),
      intensity float, position (3,) [point/spot], direction (3,)
      [directional/spot], outer_cone_angle float [spot])
    ``camera``: dict(eye (3,), dir (3,), up (3,), yfov float, znear, zfar)
    """
    bb = _BufferBuilder()
    accessors: List[dict] = []
    gltf_meshes: List[dict] = []
    nodes: List[dict] = []
    materials: List[dict] = []
    images: List[dict] = []
    textures: List[dict] = []
    mat_cache: Dict[int, int] = {}
    tex_cache: Dict[int, int] = {}

    def add_accessor(arr: np.ndarray, type_: str, target: int,
                     minmax: bool = False) -> int:
        raw = np.ascontiguousarray(arr).tobytes()
        view = bb.add(raw, target)
        comp = {np.dtype(np.float32): 5126, np.dtype(np.uint32): 5125,
                np.dtype(np.uint16): 5123}[arr.dtype]
        acc = {"bufferView": view, "componentType": comp,
               "count": int(arr.shape[0]), "type": type_}
        if minmax:
            acc["min"] = [float(v) for v in arr.min(axis=0)]
            acc["max"] = [float(v) for v in arr.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    def add_material(m: dict) -> int:
        key = id(m)
        if key in mat_cache:
            return mat_cache[key]
        base = list(np.asarray(m.get("base_color", (1, 1, 1)), np.float64))
        if len(base) == 3:
            base = base + [1.0]
        pbr = {"baseColorFactor": [float(v) for v in base],
               "metallicFactor": float(m.get("metallic", 0.0)),
               "roughnessFactor": float(m.get("roughness", 1.0))}
        tex = m.get("base_color_texture")
        if tex is not None:
            tkey = id(tex)
            if tkey not in tex_cache:
                view = bb.add(_png_bytes(tex))
                images.append({"bufferView": view, "mimeType": "image/png"})
                textures.append({"source": len(images) - 1, "sampler": 0})
                tex_cache[tkey] = len(textures) - 1
            pbr["baseColorTexture"] = {"index": tex_cache[tkey]}
        materials.append({"name": m.get("name", f"mat{len(materials)}"),
                          "pbrMetallicRoughness": pbr,
                          "doubleSided": True})
        mat_cache[key] = len(materials) - 1
        return mat_cache[key]

    for mesh in meshes:
        pos = np.asarray(mesh["positions"], np.float32)
        idx = np.asarray(mesh["indices"], np.uint32).reshape(-1)
        attrs = {"POSITION": add_accessor(pos, "VEC3", 34962, minmax=True)}
        if mesh.get("normals") is not None:
            attrs["NORMAL"] = add_accessor(
                np.asarray(mesh["normals"], np.float32), "VEC3", 34962)
        if mesh.get("uvs") is not None:
            attrs["TEXCOORD_0"] = add_accessor(
                np.asarray(mesh["uvs"], np.float32), "VEC2", 34962)
        prim = {"attributes": attrs,
                "indices": add_accessor(idx[:, None], "SCALAR", 34963),
                "mode": 4}
        if mesh.get("material") is not None:
            prim["material"] = add_material(mesh["material"])
        gltf_meshes.append({"name": mesh.get("name", "mesh"),
                            "primitives": [prim]})
        node = {"mesh": len(gltf_meshes) - 1, "name": mesh.get("name", "mesh")}
        if mesh.get("translation") is not None:
            node["translation"] = [float(v) for v in mesh["translation"]]
        nodes.append(node)

    light_defs: List[dict] = []
    for li in lights:
        kind = li.get("type", "point")
        ld = {"type": kind,
              "color": [float(v) for v in li.get("color", (1, 1, 1))],
              "intensity": float(li.get("intensity", 1.0)),
              "name": li.get("name", f"light{len(light_defs)}")}
        if kind == "spot":
            ld["spot"] = {"outerConeAngle": float(li.get("outer_cone_angle",
                                                         np.pi / 4))}
        light_defs.append(ld)
        node = {"name": ld["name"],
                "extensions": {"KHR_lights_punctual":
                               {"light": len(light_defs) - 1}}}
        if kind in ("point", "spot") and li.get("position") is not None:
            node["translation"] = [float(v) for v in li["position"]]
        if kind in ("directional", "spot") and li.get("direction") is not None:
            node["matrix"] = _look_matrix(li.get("position", (0, 0, 0)),
                                          li["direction"], (0, 1, 0))
            node.pop("translation", None)
        nodes.append(node)

    cameras: List[dict] = []
    if camera is not None:
        cameras.append({"type": "perspective", "perspective": {
            "yfov": float(camera.get("yfov", np.pi / 2)),
            "znear": float(camera.get("znear", 0.001)),
            "zfar": float(camera.get("zfar", 1000.0)),
        }})
        nodes.append({"name": "camera", "camera": 0,
                      "matrix": _look_matrix(camera["eye"], camera["dir"],
                                             camera.get("up", (0, 1, 0)))})

    doc = {
        "asset": {"version": "2.0", "generator": "rustray_tpu.gltf_writer"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": gltf_meshes,
        "accessors": accessors,
        "bufferViews": bb.views,
        "buffers": [{"byteLength": len(bb.data)}],
    }
    if materials:
        doc["materials"] = materials
    if images:
        doc["images"] = images
        doc["textures"] = textures
        doc["samplers"] = [{"magFilter": 9729, "minFilter": 9729,
                            "wrapS": 10497, "wrapT": 10497}]
    if cameras:
        doc["cameras"] = cameras
    if light_defs:
        doc["extensionsUsed"] = ["KHR_lights_punctual"]
        doc["extensions"] = {"KHR_lights_punctual": {"lights": light_defs}}

    json_bytes = bytearray(json.dumps(doc, separators=(",", ":")).encode())
    _align(json_bytes, 4, b" ")
    bin_bytes = bytearray(bb.data)
    _align(bin_bytes, 4)
    total = 12 + 8 + len(json_bytes) + 8 + len(bin_bytes)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_bytes), 0x4E4F534A))
        f.write(json_bytes)
        f.write(struct.pack("<II", len(bin_bytes), 0x004E4942))
        f.write(bin_bytes)
