"""Host-side cluster-BVH build: triangles → contiguous <=K-triangle leaves.

Semantics (native C++ and NumPy paths are interchangeable):
- top-down split over the widest centroid axis (binned SAH in the native
  builder, median in the fallback — both emit depth-first leaf order, so
  spatially close clusters are contiguous in the pool);
- every leaf has <= ``max_leaf`` triangles;
- output: permutation of triangle ids (leaf-major), per-cluster triangle
  counts, and per-cluster object-space AABBs.

This replaces the reference's two acceleration structures — the `bvh` crate
scene BVH (src/scene.rs:1681-1688) and parry3d's per-TriMesh BVH
(src/shape/mesh.rs:67) — with a layout the TPU renderer can consume as
dense, aligned slabs.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .. import spans
from . import native


def _build_numpy(verts: np.ndarray, tris: np.ndarray, max_leaf: int):
    n = tris.shape[0]
    tv = verts[tris]                       # (n, 3, 3)
    lo = tv.min(axis=1)
    hi = tv.max(axis=1)
    cent = 0.5 * (lo + hi)

    perm = np.empty((n,), np.int64)
    counts, boxes = [], []
    emitted = 0

    # iterative stack to avoid Python recursion limits on huge meshes
    stack = [np.arange(n)]
    out_stack = []
    while stack:
        idx = stack.pop()
        if idx.shape[0] <= max_leaf:
            out_stack.append(idx)
            continue
        c = cent[idx]
        ext = c.max(axis=0) - c.min(axis=0)
        axis = int(np.argmax(ext))
        mid = idx.shape[0] // 2
        part = np.argpartition(c[:, axis], mid)
        # push right then left so left pops first (depth-first leaf order)
        stack.append(idx[part[mid:]])
        stack.append(idx[part[:mid]])

    for idx in out_stack:
        k = idx.shape[0]
        perm[emitted:emitted + k] = idx
        emitted += k
        counts.append(k)
        boxes.append(np.concatenate([lo[idx].min(axis=0), hi[idx].max(axis=0)]))

    return (perm.astype(np.int32), np.asarray(counts, np.int32),
            np.asarray(boxes, np.float32).reshape(-1, 6))


def _build_native(lib, verts: np.ndarray, tris: np.ndarray, max_leaf: int):
    import ctypes
    n = tris.shape[0]
    max_clusters = 2 * (n // max(1, max_leaf) + 2)
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    perm = np.empty((n,), np.int32)
    aabb = np.empty((max_clusters, 6), np.float32)
    counts = np.empty((max_clusters,), np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    nc = lib.rr_build_clusters(
        verts.ctypes.data_as(fp), verts.shape[0],
        tris.ctypes.data_as(ip), n, max_leaf,
        perm.ctypes.data_as(ip), aabb.ctypes.data_as(fp),
        counts.ctypes.data_as(ip), max_clusters)
    if nc < 0:
        return None
    return perm, counts[:nc].copy(), aabb[:nc].copy()


@spans.timed("session.bvh")
def build_clusters(verts: np.ndarray, tris: np.ndarray,
                   max_leaf: int = 128) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (perm (T,) int32, counts (C,) int32, aabbs (C, 6) float32).

    ``perm`` lists original triangle ids in leaf-major order; cluster ``c``
    owns ``perm[counts[:c].sum() : counts[:c].sum() + counts[c]]``.
    """
    tris = np.asarray(tris, np.int32)
    verts = np.asarray(verts, np.float32)
    if tris.shape[0] == 0:
        return (np.zeros((0,), np.int32), np.zeros((0,), np.int32),
                np.zeros((0, 6), np.float32))
    lib = native.load()
    if lib is not None:
        out = _build_native(lib, verts, tris, max_leaf)
        if out is not None:
            return out
    return _build_numpy(verts, tris, max_leaf)
