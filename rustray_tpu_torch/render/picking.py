"""Pixel picking — ``Raytracing::pick`` (src/raytracing.rs:237-273).

Port of ``rustray_tpu/render/picking.py``: builds the center primary ray
for a pixel and returns (object id, object name, distance) of the first
visible hit, or None.  The trace is the dense scan, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..ops.intersect import prepare_triangles, safe_normalize
from ..ops.rays import pick_ray
from ..ops.traverse import trace_closest


def pick(scene, sa, static, x: int, y: int) -> Optional[Tuple[int, str, float]]:
    o, d = pick_ray(sa.camera, static.width, static.height, x, y)
    d = safe_normalize(d)
    prep = prepare_triangles(sa)
    hit = trace_closest(sa, static, prep, o, d, for_shadow=False,
                        allow_reflection_only=False)
    if not bool(hit.hit[0]):
        return None
    inst = int(hit.inst[0])
    obj_id = int(sa.inst_obj_id[inst])
    item = scene.get_obj_by_id(obj_id)
    name = item.basic.name if item is not None else ""
    return obj_id, name, float(hit.t[0])
