"""Ray × sphere and ray × triangle intersection on tensors.

Port of ``rustray_tpu/ops/intersect.py``: parry3d ball-cast semantics for
spheres and Baldwin–Weber per-triangle constants for the world-space
triangle test, with the JAX package's elementwise operation order (no
matmuls, so no TF32 can creep in and the three trace paths agree to the
ULP).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

INF = 3.0e38


def device_const(values, device, dtype=torch.float32):
    """A small constant vector made on ``device`` by fills: no copy from
    host memory, which a CUDA graph capture refuses (and which waits for
    the stream eagerly)."""
    if torch.device(device).type == "cpu":
        return torch.tensor(values, dtype=dtype)
    out = torch.empty((len(values),), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out


def dot(a, b, axis=-1):
    return torch.sum(a * b, dim=axis)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def safe_normalize(v, axis=-1, eps=1e-15):
    n = torch.sqrt(torch.clamp(torch.sum(v * v, dim=axis, keepdim=True),
                               min=eps * eps))
    return v / n


def transform_dir(mat, d):
    """(…,4,4) × (…,3) direction transform, as elementwise products."""
    return torch.sum(mat[..., :3, :3] * d[..., None, :], dim=-1)


def transform_point(mat, p):
    """(…,4,4) × (…,3) point transform (homogeneous w=1)."""
    return transform_dir(mat, p) + mat[..., :3, 3]


@dataclass
class TrianglePrep:
    """World-space triangle data + Baldwin–Weber constants (see the JAX
    package's TrianglePrep for the layout of the optional packs)."""
    a: torch.Tensor        # (T, 3) world vertex a
    n: torch.Tensor        # (T, 3) raw world geometric normal (e1 × e2)
    an: torch.Tensor       # (T,) a·n
    g1: torch.Tensor       # (T, 3)
    c1: torch.Tensor       # (T,)
    g2: torch.Tensor       # (T, 3)
    c2: torch.Tensor       # (T,)
    flat_n: torch.Tensor   # (T, 3) model-matrix-transformed flat normal
    backface_sign: torch.Tensor  # (T,) det-sign of owner instance
    # (C, 16, K) cluster slabs for the block-walk kernel (ops/block_trace)
    pallas_pack: object = None
    # (T, 16) per-winner shading rows (ops/traverse.build_shade_packs)
    shade_pack: object = None
    corner_pack: object = None
    mat_pack_f: object = None
    mat_pack_i: object = None

    def replace(self, **kw) -> "TrianglePrep":
        return dataclasses.replace(self, **kw)


def prepare_triangles(sa) -> TrianglePrep:
    """Build world-space triangle constants from SceneArrays (per frame)."""
    tris = sa.tris.long()
    va = sa.verts[tris[:, 0]]
    vb = sa.verts[tris[:, 1]]
    vc = sa.verts[tris[:, 2]]
    m = sa.inst_trans[sa.tri_inst.long()]  # (T, 4, 4)
    wa = transform_point(m, va)
    wb = transform_point(m, vb)
    wc = transform_point(m, vc)

    e1 = wb - wa
    e2 = wc - wa
    n = cross(e1, e2)
    nn = torch.clamp(dot(n, n), min=1e-30)
    g1 = cross(e2, n) / nn[:, None]
    g2 = cross(n, e1) / nn[:, None]

    local_n = cross(vb - va, vc - va)
    flat_n = safe_normalize(transform_dir(m, safe_normalize(local_n)))

    return TrianglePrep(
        a=wa, n=n, an=dot(wa, n),
        g1=g1, c1=-dot(wa, g1), g2=g2, c2=-dot(wa, g2),
        flat_n=flat_n, backface_sign=sa.inst_det_sign[sa.tri_inst.long()],
    )


def sphere_cast(local_o, local_d, radius, solid):
    """parry3d ``ray_toi_with_ball`` (object space, ball at origin).

    Returns (hit, t, inside): outside & entering → near root; inside &
    solid → 0; inside & not solid → far root."""
    a = dot(local_d, local_d)
    b = dot(local_o, local_d)
    c = dot(local_o, local_o) - radius * radius
    delta = b * b - a * c
    sq = torch.sqrt(torch.clamp(delta, min=1e-30))
    a_safe = torch.clamp(a, min=1e-30)
    t_near = (-b - sq) / a_safe
    t_far = (-b + sq) / a_safe

    miss = ((c > 0.0) & (b > 0.0)) | (delta < 0.0)
    inside = (~miss) & (t_near <= 0.0)
    t = torch.where(inside, torch.where(solid, 0.0, t_far), t_near)
    return ~miss, t, inside


def sphere_hit_normal(local_o, local_d, t, inside, trans):
    """World normal at a ball hit, transformed by the model matrix and
    negated when the cast started inside."""
    local_p = local_o + t[..., None] * local_d
    n_local = safe_normalize(local_p)
    n_local = torch.where(inside[..., None], -n_local, n_local)
    return safe_normalize(transform_dir(trans, n_local))


def intersect_tri_tile(o, d, a_dot_n, n, g1, c1, g2, c2, tri_ok):
    """N rays (N, 3) × a K-triangle tile → (t (N, K), INF where missed;
    hit (N, K)).  Operation order of the JAX package's tile and kernels."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    n0, n1, n2 = n[:, 0][None], n[:, 1][None], n[:, 2][None]
    g10, g11, g12 = g1[:, 0][None], g1[:, 1][None], g1[:, 2][None]
    g20, g21, g22 = g2[:, 0][None], g2[:, 1][None], g2[:, 2][None]

    d_n = dx * n0 + dy * n1 + dz * n2        # (N, K)
    o_n = ox * n0 + oy * n1 + oz * n2
    denom_ok = torch.abs(d_n) > 1e-30
    t = (a_dot_n[None, :] - o_n) / torch.where(denom_ok, d_n, 1.0)
    px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
    u = px * g10 + py * g11 + pz * g12 + c1[None, :]
    v = px * g20 + py * g21 + pz * g22 + c2[None, :]

    hit = (denom_ok & (t >= 0.0) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0) & tri_ok[None, :])
    return torch.where(hit, t, INF), hit


def closest_tri(o, d, prep: TrianglePrep, tri_ok, tile: int,
                ray_block: int = 4096):
    """Dense scan of triangle tiles keeping the closest hit per ray.

    Rays go in blocks of ``ray_block`` so the (rays, tile) intermediates
    stay small.  Returns (best_t (N,), best_tri (N,) int32); best_t = INF
    on miss; ties go to the lowest triangle index."""
    n_tris = prep.a.shape[0]
    out_t, out_i = [], []
    for r0 in range(0, o.shape[0], ray_block):
        ob, db = o[r0:r0 + ray_block], d[r0:r0 + ray_block]
        best_t = torch.full((ob.shape[0],), INF, device=o.device)
        best_i = torch.zeros((ob.shape[0],), dtype=torch.int32,
                             device=o.device)
        for s in range(0, n_tris, tile):
            e = min(s + tile, n_tris)
            t_tile, _ = intersect_tri_tile(
                ob, db, prep.an[s:e], prep.n[s:e], prep.g1[s:e],
                prep.c1[s:e], prep.g2[s:e], prep.c2[s:e], tri_ok[s:e])
            tile_t = torch.amin(t_tile, dim=1)
            tile_arg = torch.argmin(t_tile, dim=1).to(torch.int32) + s
            better = tile_t < best_t
            best_t = torch.where(better, tile_t, best_t)
            best_i = torch.where(better, tile_arg, best_i)
        out_t.append(best_t)
        out_i.append(best_i)
    if not out_t:
        return (torch.full((0,), INF, device=o.device),
                torch.zeros((0,), dtype=torch.int32, device=o.device))
    return torch.cat(out_t), torch.cat(out_i)


def tri_barycentrics(o, d, t, tri_idx, prep: TrianglePrep):
    """Recompute (u, v) and d·n for winning triangles (per-ray gather)."""
    tri = tri_idx.long()
    p = o + t[:, None] * d
    u = dot(p, prep.g1[tri]) + prep.c1[tri]
    v = dot(p, prep.g2[tri]) + prep.c2[tri]
    d_n = dot(d, prep.n[tri])
    return u, v, d_n
