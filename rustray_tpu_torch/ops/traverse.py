"""Closest-hit tracing over the compiled scene, on tensors.

Port of ``rustray_tpu/ops/traverse.py``.  Mesh traversal is either the
dense linear scan (ops/intersect.closest_tri) or a coherence-sorted
cluster walk: the XLA cluster walk in plain torch
(ops/cluster_trace.select_closest_clusters, ``accel_impl="xla"``) or,
with ``accel_impl="pallas"``, a kernel chosen by ``pallas_algo``: the
octet rounds (ops/octet_trace.trace_tris_octets, ``"octet"``, the
default) or the block walk (ops/block_trace.trace_tris_blocks), each a
CUDA kernel on CUDA tensors and its torch twin on the CPU or under
``pallas_interpret``.
The walks are selection only; :func:`selected_t` carries the winner's t
and, as its backward, the JAX package's analytic VJP through one triangle
per ray, so every walk (kernel, twin or XLA) gives the dense scan's
gradient.
Shadow rays carry ``t_max`` = distance to the light; the block walk stops
at a confirmed hit per lane in any-hit mode, the other walks and the dense
scan return the nearest hit.  Per-winner data comes from the packed (T, 16)
rows of ``build_shade_packs`` and per-material data from
``build_mat_packs``; under autograd :func:`gather_mat_rows` takes each
ray's material row, and its backward sums the rows per material
(``csrc/mat_rows.cu`` on the card).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .. import graphs
from ..scene.material import TextureType
from .intersect import (INF, TrianglePrep, closest_tri, dot, safe_normalize,
                        sphere_cast, sphere_hit_normal, transform_dir,
                        transform_point)


@dataclass
class Hit:
    t: torch.Tensor        # (N,) world distance (dir normalized); INF on miss
    hit: torch.Tensor      # (N,) bool
    is_mesh: torch.Tensor  # (N,) bool
    inst: torch.Tensor     # (N,) int32 instance; -1 for block-walk mesh hits
    tri: torch.Tensor      # (N,) int32 global triangle index (mesh hits)


@dataclass
class HitAttrs:
    normal: torch.Tensor   # (N, 3) shading normal pre-normal-mapping
    uv: torch.Tensor       # (N, 2) reference get_uv (v negated)
    mat: torch.Tensor      # (N,) int32 material slot
    obj_id: torch.Tensor   # (N,) int32 reference object id
    point: torch.Tensor    # (N, 3) world hit point
    mat_f: torch.Tensor    # (N, MATF_W) gathered per-material float row
    mat_i: torch.Tensor    # (N, MATI_W) gathered per-material int row


# mat_pack_f columns
MF_BASE = 0        # 0-2 base_color
MF_SPEC = 3        # 3-5 specular_color
MF_AMBIENT = 6     # 6-8 ambient_color
MF_ALPHA = 9
MF_SHININESS = 10
MF_REFLECTIVITY = 11
MF_REFR_INDEX = 12
MF_NM_STRENGTH = 13
MF_ROUGHNESS = 14
MF_SHADOW_SOFT = 15
MATF_W = 16
# mat_pack_i columns
MI_TEX_OFF = 0     # 0-7 tex_offset per TextureType
MI_TEX_W = 8       # 8-15
MI_TEX_H = 16      # 16-23
MI_NEAREST = 24
MI_RECV_SHADOW = 25
MI_MONTE_CARLO = 26
MI_SMOOTH = 27
MI_BACKFACE_CULL = 28
MATI_W = 32


def build_mat_packs(mats):
    """(M, 16) float + (M, 32) int packed material tables."""
    mf = torch.cat([
        mats.base_color, mats.specular_color, mats.ambient_color,
        mats.alpha[:, None], mats.shininess[:, None],
        mats.reflectivity[:, None], mats.refraction_index[:, None],
        mats.normal_map_strength[:, None], mats.roughness[:, None],
        mats.shadow_softness[:, None],
    ], dim=1)
    M = mats.alpha.shape[0]
    flags = [mats.tex_nearest, mats.receive_shadow, mats.monte_carlo,
             mats.smooth_shading, mats.backface_culling]
    mi = torch.cat([
        mats.tex_offset, mats.tex_w, mats.tex_h,
        *[f[:, None].to(torch.int32) for f in flags],
        torch.zeros((M, MATI_W - 29), dtype=torch.int32,
                    device=mats.alpha.device),
    ], dim=1)
    return mf, mi


def build_shade_packs(sa, prep: TrianglePrep, wvn) -> TrianglePrep:
    """Attach shade_pack/corner_pack/material packs to ``prep``."""
    bs = prep.backface_sign[:, None]
    shade = torch.cat([
        prep.n * bs, (prep.an * prep.backface_sign)[:, None],
        prep.g1, prep.c1[:, None], prep.g2, prep.c2[:, None],
        prep.flat_n, sa.tri_inst.to(torch.float32)[:, None],
    ], dim=1)                                             # (T, 16)
    n_idx = sa.tri_n_idx.long()
    has_n = n_idx[:, 0] >= 0
    safe_n = torch.clamp(n_idx, min=0)
    vnc = torch.cat([wvn[safe_n[:, 0]], wvn[safe_n[:, 1]],
                     wvn[safe_n[:, 2]]], dim=1)           # (T, 9)
    uv_idx = sa.tri_uv_idx.long()
    has_uv = uv_idx[:, 0] >= 0
    safe_uv = torch.clamp(uv_idx, min=0)
    uvc = torch.cat([sa.uvs[safe_uv[:, 0]], sa.uvs[safe_uv[:, 1]],
                     sa.uvs[safe_uv[:, 2]]], dim=1)       # (T, 6)
    uvc = torch.where(has_uv[:, None], uvc, 0.0)
    corner = torch.cat([vnc, has_n[:, None].to(torch.float32), uvc],
                       dim=1)                             # (T, 16)
    mat_f, mat_i = build_mat_packs(sa.materials)
    return prep.replace(shade_pack=shade, corner_pack=corner,
                        mat_pack_f=mat_f, mat_pack_i=mat_i)


class _SelectedT(torch.autograd.Function):
    """Forward: the traversal's own winner t (no gather).  Backward: the
    analytic t = (an - o·n)/(d·n) differentiated through one gathered
    ``shade_pack`` row per ray; the pack's cotangent (a scatter-add) is
    only built when the pack needs one.  ``t_sel`` gets no gradient: the
    walks are selection only."""

    @staticmethod
    def forward(ctx, o, d, shade_pack, tri_idx, found, t_sel):
        ctx.save_for_backward(o, d, shade_pack, tri_idx, found)
        return torch.where(found, t_sel, INF)

    @staticmethod
    def backward(ctx, g):
        o, d, pack, tri_idx, found = ctx.saved_tensors
        tri = tri_idx.long()
        row = pack[tri]
        n = row[:, 0:3]
        an = row[:, 3]
        d_n = dot(d, n)
        denom = torch.where(torch.abs(d_n) > 1e-30, d_n, 1.0)
        t = (an - dot(o, n)) / denom
        g = torch.where(found, g, 0.0)
        gd = (g / denom)[:, None]
        d_o = -gd * n if ctx.needs_input_grad[0] else None
        d_d = -gd * t[:, None] * n if ctx.needs_input_grad[1] else None
        d_pack = None
        if ctx.needs_input_grad[2]:
            d_row = torch.zeros_like(row)
            d_row[:, 0:3] = gd * (-o - t[:, None] * d)
            d_row[:, 3] = g / denom
            d_pack = torch.zeros_like(pack).index_add_(
                0, tri, torch.where(found[:, None], d_row, 0.0))
        return d_o, d_d, d_pack, None, None, None


def selected_t(o, d, shade_pack, tri_idx, found, t_sel):
    """The traversal's winner t, ``where(found, t_sel, INF)``, with the JAX
    package's custom VJP (rustray_tpu/ops/traverse.py ``selected_t``) as
    its backward, so the hit distance's gradient reaches ``o``, ``d`` and
    the pack whichever walk selected the winner."""
    return _SelectedT.apply(o, d, shade_pack, tri_idx, found, t_sel)


# the material-row reduction kernel (csrc/mat_rows.cu): its launches and the
# rows they reduced; only the launch in _mat_rows_cuda counts
mat_rows = {"launches": 0, "rows": 0}
# its grid (the kernel's kTile, kWarps and the CTA cap): the order of its
# sums, and so its bits, follow from the rows and materials alone
_MAT_TILE, _MAT_WARPS, _MAT_MAX_CTAS = 64, 8, 512


def reset_mat_rows() -> None:
    """Zero :data:`mat_rows`."""
    mat_rows["launches"] = mat_rows["rows"] = 0


def _mat_rows_twin(g, mat, n_mats: int):
    """The gather's backward in plain torch: the (n_mats, W) sums of the
    rows of ``g`` (N, W) per material ``mat`` (N,)."""
    return torch.zeros((n_mats, g.shape[1]), dtype=g.dtype,
                       device=g.device).index_add_(0, mat, g)


def _mat_rows_grid(n: int, n_mats: int):
    """(CTAs per material tile, rays per warp) of the kernel for n rows."""
    tiles = -(-n_mats // _MAT_TILE)
    ctas = min(max(1, _MAT_MAX_CTAS // tiles),
               max(1, -(-n // (_MAT_WARPS * 32 * 4))))
    per_warp = -(-n // (ctas * _MAT_WARPS))
    return ctas, max(32, -(-per_warp // 32) * 32)


def _mat_rows_cuda(g, mat, n_mats: int):
    """:func:`_mat_rows_twin` by the kernel (csrc/mat_rows.cu) on the
    current stream, deterministic, counted in :data:`mat_rows`.  Raises on
    what the kernel does not take before any CUDA call."""
    n, dev = mat.shape[0], g.device
    if (g.dtype != torch.float32 or g.shape != (n, MATF_W)
            or not g.is_contiguous() or mat.dtype != torch.int32
            or not mat.is_contiguous() or mat.device != dev
            or dev.type != "cuda"):
        raise ValueError(
            f"material rows: g must be a contiguous float32 ({n}, {MATF_W}) "
            f"and mat a contiguous int32 ({n},) tensor on one CUDA device; "
            f"got {g.dtype} {tuple(g.shape)} on {g.device}, {mat.dtype} "
            f"{tuple(mat.shape)} on {mat.device}")
    from ..build import load_kernel_lib
    fn = load_kernel_lib("mat_rows").rr_mat_rows
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ctas, per_warp = _mat_rows_grid(n, n_mats)
    partial = torch.empty((ctas, n_mats, MATF_W), dtype=torch.float32,
                          device=dev)
    out = torch.empty((n_mats, MATF_W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fn(g.data_ptr(), mat.data_ptr(), partial.data_ptr(),
                 out.data_ptr(), n, n_mats, ctas, per_warp,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"material rows kernel launch failed: CUDA error "
                           f"{err}")
    mat_rows["launches"] += 1
    mat_rows["rows"] += n
    return out


class _MatRows(torch.autograd.Function):
    """Forward: ``table[mat.long()]``, the plain gather.  Backward: the
    rows' cotangents summed per material by the kernel on CUDA tensors
    (:func:`_mat_rows_cuda`), by :func:`_mat_rows_twin` on the CPU."""

    @staticmethod
    def forward(ctx, table, mat):
        ctx.save_for_backward(mat)
        ctx.n_mats = table.shape[0]
        return table[mat.long()]

    @staticmethod
    def backward(ctx, g):
        mat, = ctx.saved_tensors
        reduce = _mat_rows_cuda if g.is_cuda else _mat_rows_twin
        return reduce(g.contiguous(), mat, ctx.n_mats), None


def gather_mat_rows(table, mat):
    """Each ray's row of the (M, MATF_W) material table, ``table[mat]``,
    whose backward sums the rows per material in one pass instead of
    autograd's ``index_put_`` (a sort, then each material's rays one after
    another).  ``mat`` (N,) int32."""
    return _MatRows.apply(table, mat)


def instance_mask(sa, for_shadow: bool, allow_reflection_only: bool):
    """Candidate filter per instance — src/raytracing.rs:454."""
    m = sa.inst_mat.long()
    mask = sa.inst_visible & (sa.materials.alpha[m] > 0.0)
    if for_shadow:
        mask = mask & sa.materials.cast_shadow[m]
    if not allow_reflection_only:
        mask = mask & ~sa.materials.reflection_only[m]
    return mask


def _sphere_solid(sa, for_shadow: bool):
    """Solid iff fully opaque, no alpha texture, backface culling on, and
    not a shadow cast (src/shape/sphere.rs:50)."""
    if for_shadow:
        return torch.zeros_like(sa.sphere_valid)
    m = sa.inst_mat[sa.sphere_idx.long()].long()
    has_alpha_tex = sa.materials.tex_w[m, int(TextureType.Alpha)] > 0
    return (~((sa.materials.alpha[m] < 1.0) | has_alpha_tex)
            & sa.materials.backface_culling[m])


def coherence_sort(o, d, alive, t_max, w_lo, w_hi, cl_ok):
    """Coherence-sort rays for the cluster walks and cap each lane at its
    exit from the global cluster bounds.

    Returns (inv, o_s, d_s, alive_s, tmax_s): the sorted rays, their capped
    t_max, and the inverse permutation that restores the caller's order.
    Misses of the global box get cap -1 (they cannot hit anything)."""
    from .block_trace import coherence_key
    n = o.shape[0]
    lo = torch.amin(torch.where(cl_ok[:, None], w_lo, INF), dim=0)
    hi = torch.amax(torch.where(cl_ok[:, None], w_hi, -INF), dim=0)
    key = coherence_key(o, d, alive, lo, hi)
    perm = torch.argsort(key, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=o.device)
    o_s, d_s, alive_s = o[perm], d[perm], alive[perm]

    eps = 1e-30
    sd = torch.where(torch.abs(d_s) > eps, d_s,
                     torch.where(d_s >= 0, eps, -eps))
    t0 = (lo[None] - o_s) / sd
    t1 = (hi[None] - o_s) / sd
    tn_box = torch.amax(torch.minimum(t0, t1), dim=1)
    tf_box = torch.amin(torch.maximum(t0, t1), dim=1)
    exit_cap = torch.where(tf_box >= torch.clamp(tn_box, min=0.0),
                           tf_box * 1.0001 + 1e-3, -1.0)
    tmax_s = exit_cap if t_max is None else torch.minimum(t_max[perm],
                                                          exit_cap)
    return inv, o_s, d_s, alive_s, tmax_s


def _sorted_mesh_trace(sa, static, prep, o, d, alive, t_max, tri_ok, cl_ok,
                       accel_boxes, accel_impl, accel_block, accel_gather,
                       block_n, pallas_interpret, for_shadow,
                       pallas_algo: str = "octet"):
    """Coherence-sort rays, run the cluster walk and restore the caller's
    order.  ``accel_impl="pallas"`` runs a kernel: the octet rounds
    (``pallas_algo="octet"``) or the block walk (any other value); else the
    XLA cluster walk on dead-masked rays.  Returns (found, tri, t).
    Selection only: the rays are detached, and gradients of the winner's
    t go through :func:`selected_t`."""
    w_lo, w_hi = accel_boxes
    t_max = None if t_max is None else t_max.detach()
    inv, o_s, d_s, alive_s, tmax_s = coherence_sort(
        o.detach(), d.detach(), alive, t_max, w_lo.detach(), w_hi.detach(),
        cl_ok)
    mode = "any" if for_shadow else "closest"
    if accel_impl != "pallas":
        from .block_trace import DEAD_ORIGIN
        from .cluster_trace import select_closest_clusters
        o_t = torch.where(alive_s[:, None], o_s, DEAD_ORIGIN)
        d_t = torch.where(alive_s[:, None], d_s, 1.0)
        found_s, tri_s, t_s = select_closest_clusters(
            o_t, d_t, prep, tri_ok, w_lo, w_hi, cl_ok, static.cluster_size,
            accel_block, accel_gather, t_max=tmax_s)
    elif pallas_algo == "octet":
        # the rounds' block-walk fallback keeps trace_tris_octets' own
        # block_n, as in the JAX package
        from .octet_trace import trace_tris_octets
        found_s, tri_s, t_s = trace_tris_octets(
            o_s, d_s, alive_s, tmax_s, prep, w_lo, w_hi, cl_ok,
            static.cluster_size, mode=mode, interpret=pallas_interpret)
    else:
        from .block_trace import trace_tris_blocks
        found_s, tri_s, t_s = trace_tris_blocks(
            o_s, d_s, alive_s, tmax_s, prep, w_lo, w_hi, cl_ok,
            static.cluster_size, block_n=block_n, mode=mode,
            interpret=pallas_interpret)
    return found_s[inv], tri_s[inv], t_s[inv]


def trace_closest(sa, static, prep: TrianglePrep, o, d,
                  for_shadow: bool, allow_reflection_only: bool,
                  tri_tile: int = 1024, accel_boxes=None,
                  accel_block: int = 1024, accel_gather: int = 32,
                  accel_impl: str = "xla", alive=None, t_max=None,
                  block_n: int = 512, pallas_interpret: bool = False,
                  pallas_algo: str = "octet") -> Hit:
    """o (N,3), d (N,3) normalized.  ``accel_boxes`` (w_lo, w_hi) selects
    the cluster walk over the dense scan: the XLA walk
    (ops/cluster_trace, ``accel_block`` rays per block, ``accel_gather``
    clusters per round) or, with ``accel_impl="pallas"``, a kernel chosen
    by ``pallas_algo`` (``"octet"``: the octet rounds; else the block
    walk).  ``alive`` masks rays whose result is unused; ``t_max`` (N,)
    caps accepted hits."""
    n = o.shape[0]
    dev = o.device
    inst_ok = instance_mask(sa, for_shadow, allow_reflection_only)

    best_t = torch.full((n,), INF, device=dev)
    best_inst = torch.zeros((n,), dtype=torch.int32, device=dev)
    best_tri = torch.zeros((n,), dtype=torch.int32, device=dev)
    best_is_mesh = torch.zeros((n,), dtype=torch.bool, device=dev)

    if static.has_mesh:
        tri_ok = sa.tri_valid & inst_ok[sa.tri_inst.long()]
        if accel_boxes is not None:
            cl_ok = sa.cl_valid & inst_ok[sa.cl_inst.long()]
            alive_f = alive if alive is not None else torch.ones(
                (n,), dtype=torch.bool, device=dev)
            # an all-dead wavefront skips its traversal outright
            found, tri_idx, t_sel = graphs.cond(
                alive_f,
                lambda: _sorted_mesh_trace(
                    sa, static, prep, o, d, alive_f, t_max, tri_ok, cl_ok,
                    accel_boxes, accel_impl, accel_block, accel_gather,
                    block_n, pallas_interpret, for_shadow, pallas_algo),
                lambda: (torch.zeros((n,), dtype=torch.bool, device=dev),
                         torch.zeros((n,), dtype=torch.int32, device=dev),
                         torch.full((n,), INF, device=dev)),
                "traversal")
            if prep.shade_pack is not None:
                t_tri = selected_t(o, d, prep.shade_pack, tri_idx, found,
                                   t_sel)
            else:
                from .cluster_trace import recompute_t
                t_tri = recompute_t(o, d, prep, tri_idx, found)
            better = t_tri < best_t
            # instance resolution deferred to hit_attributes (shade_pack);
            # -1 makes a consumer that skips it fail loudly
            best_inst = torch.where(better, -1, best_inst)
        else:
            if alive is None:
                t_tri, tri_idx = closest_tri(o, d, prep, tri_ok, tri_tile)
            else:
                # dead lanes' results are unused: scan only the live rays
                live = torch.nonzero(alive).squeeze(1)
                t_tri = torch.full((n,), INF, device=dev)
                tri_idx = torch.zeros((n,), dtype=torch.int32, device=dev)
                t_tri[live], tri_idx[live] = closest_tri(
                    o[live], d[live], prep, tri_ok, tri_tile)
            if t_max is not None:
                t_tri = torch.where(t_tri <= t_max, t_tri, INF)
            better = t_tri < best_t
            best_inst = torch.where(better, sa.tri_inst[tri_idx.long()],
                                    best_inst)
        best_t = torch.where(better, t_tri, best_t)
        best_tri = torch.where(better, tri_idx, best_tri)
        best_is_mesh = better

    if static.n_spheres > 0:
        s_inst = sa.sphere_idx.long()                # (S,)
        inv = sa.inst_inv[s_inst]                    # (S, 4, 4)
        lo = transform_point(inv[None], o[:, None])  # (N, S, 3)
        ld = transform_dir(inv[None], d[:, None])
        radius = sa.inst_radius[s_inst][None]        # (1, S)
        solid = _sphere_solid(sa, for_shadow)[None]  # (1, S)
        s_hit, s_t, _ = sphere_cast(lo, ld, radius, solid)
        s_ok = sa.sphere_valid[None] & inst_ok[s_inst][None] & s_hit
        if t_max is not None:
            s_ok = s_ok & (s_t <= t_max[:, None])
        s_t = torch.where(s_ok, s_t, INF)
        s_min = torch.amin(s_t, dim=1)
        s_arg = torch.argmin(s_t, dim=1)
        better = s_min < best_t
        best_t = torch.where(better, s_min, best_t)
        best_inst = torch.where(better, s_inst[s_arg].to(torch.int32),
                                best_inst)
        best_is_mesh = best_is_mesh & ~better

    return Hit(t=best_t, hit=best_t < INF, is_mesh=best_is_mesh,
               inst=best_inst, tri=best_tri)


def hit_attributes(sa, static, prep: TrianglePrep, o, d, hit: Hit) -> HitAttrs:
    """Shading normal + UV + material (+ packed material rows) for winners,
    with the reference's normal and UV semantics (see the JAX package)."""
    n_rays = o.shape[0]
    dev = o.device
    t_safe = torch.where(hit.hit, hit.t, 0.0)
    point = o + t_safe[:, None] * d

    normal = torch.zeros((n_rays, 3), device=dev)
    uv = torch.zeros((n_rays, 2), device=dev)
    inst = hit.inst

    if static.has_mesh:
        tri = hit.tri.long()
        row = prep.shade_pack[tri]                      # (N, 16)
        crow = prep.corner_pack[tri]                    # (N, 16)
        mesh_inst = row[:, 15].to(torch.int32)
        inst = torch.where(hit.is_mesh, mesh_inst, inst)

    inst_l = inst.long()
    mat = torch.where(hit.hit, sa.inst_mat[inst_l], 0)
    obj_id = torch.where(hit.hit, sa.inst_obj_id[inst_l], 0)
    if torch.is_grad_enabled() and prep.mat_pack_f.requires_grad:
        mat_f = gather_mat_rows(prep.mat_pack_f, mat)  # (N, 16)
    else:
        mat_f = prep.mat_pack_f[mat.long()]             # (N, 16)
    mat_i = prep.mat_pack_i[mat.long()]                 # (N, 32)

    if static.has_mesh:
        g1, c1 = row[:, 4:7], row[:, 7]
        g2, c2 = row[:, 8:11], row[:, 11]
        u = dot(point, g1) + c1
        v = dot(point, g2) + c2
        w0 = 1.0 - u - v
        backface = dot(d, row[:, 0:3]) > 0.0
        orient = torch.where(backface, -1.0, 1.0)

        flat_n = row[:, 12:15] * orient[:, None]

        has_n = crow[:, 9] > 0.5
        n_interp = (w0[:, None] * crow[:, 0:3]
                    + u[:, None] * crow[:, 3:6]
                    + v[:, None] * crow[:, 6:9])
        smooth_n = safe_normalize(n_interp) * orient[:, None]

        uv_interp = (w0[:, None] * crow[:, 10:12]
                     + u[:, None] * crow[:, 12:14]
                     + v[:, None] * crow[:, 14:16])
        mesh_uv = torch.stack([uv_interp[:, 0], -uv_interp[:, 1]], -1)

        smooth_flag = (mat_i[:, MI_SMOOTH] > 0) & has_n
        mesh_n = torch.where(smooth_flag[:, None], smooth_n, flat_n)
        mesh_n = torch.where(sa.inst_flip[inst_l][:, None], -mesh_n, mesh_n)

        normal = torch.where(hit.is_mesh[:, None], mesh_n, normal)
        uv = torch.where(hit.is_mesh[:, None], mesh_uv, uv)

    if static.n_spheres > 0:
        inv = sa.inst_inv[inst_l]
        trans = sa.inst_trans[inst_l]
        lo = transform_point(inv, o)
        ld = transform_dir(inv, d)
        radius = sa.inst_radius[inst_l]
        has_alpha_tex = mat_i[:, MI_TEX_W + int(TextureType.Alpha)] > 0
        solid = (~((mat_f[:, MF_ALPHA] < 1.0) | has_alpha_tex)
                 & (mat_i[:, MI_BACKFACE_CULL] > 0))
        _, _, inside = sphere_cast(lo, ld, radius, solid)
        sph_n = sphere_hit_normal(lo, ld, t_safe, inside, trans)
        sph_n = torch.where(sa.inst_flip[inst_l][:, None], -sph_n, sph_n)

        lp = lo + t_safe[:, None] * ld
        theta = torch.atan2(-lp[:, 2], lp[:, 0])
        su = (theta + torch.pi) / (2.0 * torch.pi)
        cosphi = torch.clamp(-lp[:, 1] / torch.clamp(radius, min=1e-30),
                             -1.0 + 1e-7, 1.0 - 1e-7)
        sv = torch.arccos(cosphi) / torch.pi
        sph_uv = torch.stack([su, -sv], -1)

        is_sphere = hit.hit & ~hit.is_mesh
        normal = torch.where(is_sphere[:, None], sph_n, normal)
        uv = torch.where(is_sphere[:, None], sph_uv, uv)

    return HitAttrs(normal=normal, uv=uv, mat=mat, obj_id=obj_id,
                    point=point, mat_f=mat_f, mat_i=mat_i)


def prepare_vertex_normals(sa):
    """World-space loaded vertex normals (model matrix × normal)."""
    m = sa.inst_trans[sa.vn_inst.long()]
    return transform_dir(m, sa.vnormals)
