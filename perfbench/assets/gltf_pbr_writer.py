"""GLB writer for the glTF metallic-roughness material model.

``assets/gltf_writer.py`` writes meshes, lights, a camera and materials
with a base-colour texture only.  This writer lets it write everything but
the textures, then appends to the file, per material, the three maps of
the glTF PBR model: ``baseColorTexture`` (RGBA, its alpha a cut-out mask),
``normalTexture`` (tangent-space RGB) and ``metallicRoughnessTexture`` (G
roughness, B metallic), each an embedded PNG read through the writer's
bilinear, repeating sampler.  The PNGs are encoded at zlib level 1, in
threads, so that a scene of a hundred 1024² maps writes in seconds.
"""
from __future__ import annotations

import io
import json
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .gltf_writer import _align, write_glb

# material keys of the maps, and where each goes in a glTF material
MAPS = {"base_color_texture": ("pbrMetallicRoughness", "baseColorTexture"),
        "normal_texture": (None, "normalTexture"),
        "metallic_roughness_texture": ("pbrMetallicRoughness",
                                       "metallicRoughnessTexture")}
_BIN, _JSON = 0x004E4942, 0x4E4F534A


def png_fast(rgba: np.ndarray) -> bytes:
    """An (H, W, 4) uint8 image as PNG bytes at zlib level 1."""
    from PIL import Image
    bio = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(rgba)).save(bio, format="PNG",
                                                     compress_level=1)
    return bio.getvalue()


def _read_glb(path: str):
    with open(path, "rb") as f:
        data = f.read()
    jlen, jtype = struct.unpack_from("<II", data, 12)
    assert jtype == _JSON
    doc = json.loads(data[20:20 + jlen])
    blen, btype = struct.unpack_from("<II", data, 20 + jlen)
    assert btype == _BIN
    return doc, bytearray(data[28 + jlen:28 + jlen + blen])


def _write_glb(path: str, doc: dict, buf: bytearray) -> None:
    json_bytes = bytearray(json.dumps(doc, separators=(",", ":")).encode())
    _align(json_bytes, 4, b" ")
    _align(buf, 4)
    total = 12 + 8 + len(json_bytes) + 8 + len(buf)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_bytes), _JSON))
        f.write(json_bytes)
        f.write(struct.pack("<II", len(buf), _BIN))
        f.write(buf)


def write_pbr_glb(path: str, meshes, lights=(), camera=None) -> None:
    """Write a GLB of ``meshes`` (``gltf_writer.write_glb``'s dicts) whose
    material dicts may also hold ``normal_texture`` and
    ``metallic_roughness_texture`` ((H, W, 4) uint8, as
    ``base_color_texture``).  Materials and images are shared by object
    identity, as ``write_glb`` shares them."""
    plain, first = {}, {}
    stripped = []
    for m in meshes:
        md = m["material"]
        if id(md) not in plain:
            plain[id(md)] = {k: v for k, v in md.items() if k not in MAPS}
        stripped.append(dict(m, material=plain[id(md)]))
    write_glb(path, stripped, lights, camera)

    doc, buf = _read_glb(path)
    # the file's material of each mesh, in the order write_glb wrote them
    for m, gm in zip(meshes, doc["meshes"]):
        first.setdefault(gm["primitives"][0]["material"], m["material"])
    images = {}
    for md in first.values():
        for key in MAPS:
            img = md.get(key)
            if img is not None:
                images.setdefault(id(img), img)
    with ThreadPoolExecutor() as pool:
        encoded = dict(zip(images, pool.map(png_fast, images.values())))
    doc.setdefault("images", [])
    doc.setdefault("textures", [])
    doc["samplers"] = [{"magFilter": 9729, "minFilter": 9729,
                        "wrapS": 10497, "wrapT": 10497}]
    tex_index = {}
    for key_id, raw in encoded.items():
        _align(buf)
        doc["bufferViews"].append({"buffer": 0, "byteOffset": len(buf),
                                   "byteLength": len(raw)})
        buf.extend(raw)
        doc["images"].append({"bufferView": len(doc["bufferViews"]) - 1,
                              "mimeType": "image/png"})
        doc["textures"].append({"source": len(doc["images"]) - 1,
                                "sampler": 0})
        tex_index[key_id] = len(doc["textures"]) - 1
    for mi, md in first.items():
        gm = doc["materials"][mi]
        for key, (group, slot) in MAPS.items():
            img = md.get(key)
            if img is not None:
                (gm[group] if group else gm)[slot] = {
                    "index": tex_index[id(img)]}
    _align(buf)
    doc["buffers"] = [{"byteLength": len(buf)}]
    _write_glb(path, doc, buf)
