"""Wavefront Whitted / Monte-Carlo ray-tree renderer on tensors.

Port of ``rustray_tpu/render/wavefront.py``.  The reference's per-pixel
recursion becomes a bounded level loop over ray batches: each level traces
a compacted wavefront, adds its affine color contribution, and emits
weighted reflection/refraction children for the next level; a backward fold
then sums children into parents.  The color math, the sample pattern, the
object-id override chain, the queue cap with counted drops, the auto-raise
and the threefry keys (``fold_in`` of chunk start, sample cell, depth, and
17/23 for roughness/shadow jitter) are the JAX package's, so a port render
matches a JAX render of the same scene.

A frame renders as the JAX package's device loop (every chunk per group
of ``samples_per_dispatch`` sample cells, one fetch of the counts per
group) or, with checkpoint/resume or a progressive preview, chunk by
chunk.  Either runs the chunk program as CUDA graphs on the card when a
kernel walks the mesh (:func:`make_chunk_renderer`), eagerly otherwise,
and takes it from ``_RENDERER_CACHE``, so that a later frame of the same
key (the next frame of an animation) replays the graphs captured before.
Mesh traversal is the dense scan or a
coherence-sorted cluster walk: on CUDA scene tensors (or under
``pallas_interpret``) a kernel, the block walk (ops/block_trace) or, with
``pallas_algo="octet"``, the octet rounds (ops/octet_trace); otherwise the
XLA cluster walk in plain torch (ops/cluster_trace).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict

import numpy as np
import torch

from .. import graphs, rng, spans
from ..config import EngineConfig, RaytracingConfig
from ..ops import rays as rays_ops
from ..ops import shade as shade_ops
from ..ops import texture as tex_ops
from ..ops.block_trace import pack_cluster_tris, pack_is_gated
from ..ops.cluster_trace import world_cluster_aabbs
from ..ops.intersect import (INF, cross, device_const, dot, prepare_triangles,
                             safe_normalize)
from ..ops.traverse import (MF_ALPHA, MF_AMBIENT, MF_BASE, MF_NM_STRENGTH,
                            MF_REFLECTIVITY, MF_REFR_INDEX, MF_ROUGHNESS,
                            MF_SHADOW_SOFT, MF_SHININESS, MF_SPEC,
                            MI_MONTE_CARLO, MI_RECV_SHADOW,
                            build_shade_packs, hit_attributes,
                            prepare_vertex_normals, trace_closest)
from ..scene.material import TextureType
from ..utils.mathutil import sample_cell_size, sample_pattern

SHADOW_BIAS = shade_ops.SHADOW_BIAS
PI = shade_ops.PI


# The shading census: live hits shaded (``hits``), the refraction children
# spawned at hits whose alpha is below 1 (``cutout``: cut-out texels and
# translucent materials) and those hits' texture fetches that found a
# texture, summed over the channels (``fetches``), over every level.  Each
# is a device tensor once counted, added to in place, so a captured graph
# adds to it at every replay (graphs.count_on_device).  Counted only where
# the scene has a texture channel beyond base colour (:func:`counts_shading`),
# so a scene with base-colour textures alone launches nothing for it.
shading = {"hits": 0, "cutout": 0, "fetches": 0}


def counts_shading(static) -> bool:
    """Whether the shading census counts this scene's levels: some material
    has a texture in a channel beyond base colour (normal, roughness,
    metallic, alpha, occlusion, emission or specular maps)."""
    return any(static.tex_channels[int(TextureType.Base) + 1:])


def reset_shading() -> None:
    """Zero the shading census (its tensors in place)."""
    for k in shading:
        graphs.zero_count(shading, k)


def _item_color(sa, static, mat_i, tex_type, uv, rgb, fetched=None):
    """Material color times the texture (incl. alpha) when present; the
    fetch's presence mask is appended to ``fetched`` when given."""
    if not static.tex_channels[int(tex_type)]:
        return rgb, torch.ones(rgb.shape[:-1], device=rgb.device)
    rgba, has = tex_ops.get_tex_color_rows(sa, mat_i, int(tex_type), uv,
                                           static)
    if fetched is not None:
        fetched.append(has)
    out = torch.where(has[..., None], rgb * rgba[..., :3], rgb)
    w = torch.where(has, rgba[..., 3], 1.0)
    return out, w


def _tex_scalar(sa, static, mat_i, tex_type, uv, fetched=None):
    """First texture channel + presence mask; (0, False) when no material
    of the scene has the channel.  The mask of a fetch is appended to
    ``fetched`` when given."""
    if not static.tex_channels[int(tex_type)]:
        z = torch.zeros(mat_i.shape[:-1], device=mat_i.device)
        return z, torch.zeros(mat_i.shape[:-1], dtype=torch.bool,
                              device=mat_i.device)
    rgba, has = tex_ops.get_tex_color_rows(sa, mat_i, int(tex_type), uv,
                                           static)
    if fetched is not None:
        fetched.append(has)
    return rgba[..., 0], has


def _count_shading(live, cutout, fetched) -> None:
    """Add one level to the shading census: a few reductions and adds on
    the device, no host sync."""
    for k, mask in (("hits", live), ("cutout", cutout),
                    ("fetches", torch.stack(fetched) & live)):
        graphs.count_on_device(shading, k, mask.sum(dtype=torch.int64))


def _shade_level(sa, static, prep, cfg: RaytracingConfig,
                 o, d, weight, alive, depth, key, boxes, engine: EngineConfig):
    """Trace + shade one wavefront level.

    Returns (emission (N,3) pre-weight, aov dict, children dict)."""
    dev = o.device
    accel_impl = "pallas" if engine.use_pallas(static, dev) else "xla"
    trace_kw = dict(accel_boxes=boxes, accel_block=engine.accel_block,
                    accel_gather=engine.accel_gather, accel_impl=accel_impl,
                    block_n=engine.pallas_block,
                    pallas_interpret=engine.pallas_interpret,
                    pallas_algo=engine.pallas_algo)
    d = safe_normalize(d)
    allow_ro = depth > 1
    hit = trace_closest(sa, static, prep, o, d, for_shadow=False,
                        allow_reflection_only=allow_ro, alive=alive,
                        **trace_kw)
    attrs = hit_attributes(sa, static, prep, o, d, hit)
    mat_f, mat_i = attrs.mat_f, attrs.mat_i
    point = attrs.point
    uv = attrs.uv
    live = alive & hit.hit

    surface_normal = attrs.normal
    fetched = [] if counts_shading(static) else None

    # ---- normal mapping (src/raytracing.rs:756-784) ----
    if static.has_normal_tex:
        ntex, has_nt = tex_ops.get_tex_color_rows(
            sa, mat_i, int(TextureType.Normal), uv, static)
        if fetched is not None:
            fetched.append(has_nt)
        up = device_const((0.0, 1.0, 0.0), dev)
        fwd = device_const((0.0, 0.0, 1.0), dev)
        tangent = cross(surface_normal, up.expand_as(surface_normal))
        tl = shade_ops.safe_sqrt(torch.sum(tangent * tangent, dim=-1), 1e-30)
        tangent = torch.where((tl <= 1e-4)[..., None],
                              cross(surface_normal,
                                    fwd.expand_as(surface_normal)), tangent)
        tangent = safe_normalize(tangent)
        bitangent = safe_normalize(cross(surface_normal, tangent))
        nm = ntex[..., :3] * 2.0 - 1.0
        strength = mat_f[:, MF_NM_STRENGTH]
        nm = nm * torch.stack([strength, strength, torch.ones_like(strength)],
                              -1)
        nm = safe_normalize(nm)
        mapped = safe_normalize(nm[..., 0:1] * tangent
                                + nm[..., 1:2] * bitangent
                                + nm[..., 2:3] * surface_normal)
        surface_normal = torch.where(has_nt[..., None], mapped,
                                     surface_normal)

    # ---- roughness monte-carlo jitter (src/raytracing.rs:786-798) ----
    mc_flag = mat_i[:, MI_MONTE_CARLO] > 0
    if cfg.monte_carlo:
        rtex, has_rt = _tex_scalar(sa, static, mat_i, TextureType.Roughness,
                                   uv, fetched)
        rough = torch.where(has_rt, (1.0 / np.pi / 2.0) * rtex,
                            mat_f[:, MF_ROUGHNESS])
        apply = mc_flag & ((mat_f[:, MF_ROUGHNESS] > 0.0) | has_rt)
        jittered = shade_ops.jitter(rng.fold_in(key, 17), surface_normal,
                                    rough)
        surface_normal = torch.where(apply[..., None], jittered,
                                     surface_normal)

    # ---- base / specular / ambient colors ----
    ambient_rgb, _ = _item_color(sa, static, mat_i,
                                 TextureType.AmbientEmissive, uv,
                                 mat_f[:, MF_AMBIENT:MF_AMBIENT + 3], fetched)
    base_rgb, base_w = _item_color(sa, static, mat_i, TextureType.Base, uv,
                                   mat_f[:, MF_BASE:MF_BASE + 3], fetched)
    spec_rgb, _ = _item_color(sa, static, mat_i, TextureType.Specular, uv,
                              mat_f[:, MF_SPEC:MF_SPEC + 3], fetched)

    alpha = mat_f[:, MF_ALPHA] * base_w
    atex, has_at = _tex_scalar(sa, static, mat_i, TextureType.Alpha, uv,
                               fetched)
    alpha = alpha * torch.where(has_at, atex, 1.0)

    # ---- lights (src/raytracing.rs:814-920) ----
    L = sa.lights.pos.shape[0]
    lpos = sa.lights.pos                                   # (L, 3)
    ldir = sa.lights.dir
    lkind = sa.lights.kind                                 # 0 dir, 1 pt, 2 spot
    is_dir = (lkind == 0)[None, :]
    to_light_pt = lpos[None] - point[:, None]              # (N, L, 3)
    dtl = torch.where(is_dir[..., None], safe_normalize(-ldir)[None],
                      safe_normalize(to_light_pt))
    dot_light = torch.clamp(dot(surface_normal[:, None], dtl), min=0.0)
    base_term = base_rgb[:, None] * dot_light[..., None]

    reflect_dir = shade_ops.reflect(-dtl, surface_normal[:, None])
    view_dir = safe_normalize(-d)
    spec_dot = torch.clamp(dot(reflect_dir, view_dir[:, None]), min=1e-30)
    light_power = torch.pow(spec_dot, mat_f[:, MF_SHININESS][:, None])
    spec_term = spec_rgb[:, None] * light_power[..., None]

    ldist = shade_ops.safe_sqrt(torch.sum(to_light_pt * to_light_pt, dim=-1))
    # quirk: falloff divides by 4π·distance (norm, not norm²)
    intensity = torch.where(is_dir, sa.lights.intensity[None],
                            sa.lights.intensity[None]
                            / (4.0 * PI * torch.clamp(ldist, min=1e-30)))
    is_spot = (lkind == 2)[None, :]
    spot_cos = dot(-dtl, safe_normalize(ldir)[None])
    spot_angle = torch.arccos(torch.clamp(spot_cos, -1.0 + 1e-7, 1.0 - 1e-7))
    intensity = torch.where(is_spot & (spot_angle > sa.lights.max_angle[None]),
                            0.0, intensity)

    # shadows: one light-major ray batch, so a traversal block shares a light
    shadow_dir = dtl
    if cfg.monte_carlo:
        soft = mat_f[:, MF_SHADOW_SOFT][:, None] * torch.ones((1, L),
                                                              device=dev)
        jit_dir = shade_ops.jitter(rng.fold_in(key, 23), shadow_dir, soft)
        shadow_dir = torch.where(mc_flag[:, None, None], jit_dir, shadow_dir)
    shadow_o = (point + surface_normal * SHADOW_BIAS)[:, None] \
        + 0.0 * shadow_dir
    n_rays = o.shape[0]
    sh_o = shadow_o.transpose(0, 1).reshape(L * n_rays, 3)
    sh_d = safe_normalize(shadow_dir.transpose(0, 1).reshape(L * n_rays, 3))
    sh_alive = (live[None, :] & sa.lights.enabled[:, None]).reshape(
        L * n_rays)
    sh_tmax = torch.where(is_dir, INF, ldist).expand(n_rays, L).transpose(
        0, 1).reshape(L * n_rays)
    sh_hit = trace_closest(sa, static, prep, sh_o, sh_d, for_shadow=True,
                           allow_reflection_only=allow_ro, alive=sh_alive,
                           t_max=sh_tmax, **trace_kw)
    sh_t = torch.where(sh_hit.hit, sh_hit.t, 0.0).reshape(L, n_rays).T
    sh_found = sh_hit.hit.reshape(L, n_rays).T
    in_light = ~sh_found | (~is_dir & (sh_t > ldist))

    # occluder alpha-texture attenuation (src/raytracing.rs:894-913), with
    # the JAX package's documented deviation: the occluder's own UV
    shadow_alpha = mat_f[:, MF_ALPHA][:, None]            # receiver alpha
    if static.has_alpha_tex:
        occ_attrs = hit_attributes(sa, static, prep, sh_o, sh_d, sh_hit)
        occ_a, occ_has = _tex_scalar(sa, static, occ_attrs.mat_i,
                                     TextureType.Alpha, occ_attrs.uv)
        shadow_alpha = shadow_alpha * torch.where(
            occ_has.reshape(L, n_rays).T, occ_a.reshape(L, n_rays).T, 1.0)
    shadowed = (mat_i[:, MI_RECV_SHADOW] > 0)[:, None] & ~in_light
    intensity = torch.where(shadowed, intensity * (1.0 - shadow_alpha),
                            intensity)

    enabled = sa.lights.enabled[None]
    contrib = (sa.lights.color[None] * (spec_term + base_term)
               * intensity[..., None])
    local = torch.sum(torch.where(enabled[..., None], contrib, 0.0), dim=1)
    n_shadow_rays = sh_alive.sum()

    # ---- fresnel / reflectivity / refraction ----
    refr_index = mat_f[:, MF_REFR_INDEX]
    kr = shade_ops.fresnel(d, surface_normal, refr_index)

    refl_tex, has_reft = _tex_scalar(sa, static, mat_i,
                                     TextureType.Reflectivity, uv, fetched)
    reflectivity = torch.where(has_reft, refl_tex, mat_f[:, MF_REFLECTIVITY])

    local = local * (1.0 - reflectivity[..., None])

    within_depth = depth <= cfg.max_recursion
    spawn_refl = live & (reflectivity > 0.0) & within_depth
    refl_o, refl_d = shade_ops.create_reflection(surface_normal, d, point)

    refr_o, refr_d, refr_valid = shade_ops.create_transmission(
        surface_normal, d, point, refr_index)
    spawn_refr = live & (alpha < 1.0) & within_depth & refr_valid

    # past max depth a translucent surface still scales its color by alpha
    tail = torch.where(alpha < 1.0, alpha, 1.0) if not within_depth \
        else torch.ones_like(alpha)
    scale = torch.where(spawn_refr, alpha, tail)
    w_refr = torch.where(kr < 1.0, (1.0 - kr) * (1.0 - alpha), 1.0 - alpha)

    # ---- fog / AO / ambient (src/raytracing.rs:977-994) ----
    t_safe = torch.where(hit.hit, hit.t, 0.0)
    fog = torch.clamp(float(np.float32(cfg.fog_density)) * t_safe, max=1.0)
    fog_color = device_const(tuple(cfg.fog_color), dev)
    ao_tex, has_ao = _tex_scalar(sa, static, mat_i,
                                 TextureType.AmbientOcclusion, uv, fetched)
    ao = torch.where(has_ao, ao_tex, 1.0)

    emission = (ao[..., None]
                * ((1.0 - fog[..., None]) * local * scale[..., None]
                   + fog[..., None] * fog_color)
                + ambient_rgb)
    emission = torch.where(live[..., None], emission, 0.0)

    child_common = ao * (1.0 - fog)
    w_refl_child = torch.where(spawn_refl, child_common * scale * reflectivity,
                               0.0)
    w_refr_child = torch.where(spawn_refr, child_common * w_refr, 0.0)

    if fetched is not None:
        _count_shading(live, spawn_refr & (w_refr_child > 0.0), fetched)

    # alpha≈0 id-override chain flag (approx_equal(alpha, 0) — trunc compare)
    alpha_zero = torch.trunc(torch.abs(alpha) * 1e6) == 0.0

    aov = dict(
        depth=torch.where(live, t_safe, 0.0),
        normal=torch.where(live[..., None], attrs.normal, 0.0),
        obj_id=torch.where(live, attrs.obj_id, 0),
    )
    children = dict(
        refl_o=refl_o, refl_d=refl_d, w_refl=weight * w_refl_child[..., None],
        refr_o=refr_o, refr_d=refr_d, w_refr=weight * w_refr_child[..., None],
        spawn_refl=spawn_refl & (w_refl_child > 0.0),
        spawn_refr=spawn_refr & (w_refr_child > 0.0),
        refr_spawned=spawn_refr,
        alpha_zero=alpha_zero,
        n_shadow_rays=n_shadow_rays,
    )
    return emission, aov, children


def _dead_level(n: int, dev):
    """Outputs of an all-dead level (its trace and shade are skipped), each
    in a tensor of its own (a graph's IF node writes each)."""
    def z3():
        return torch.zeros((n, 3), device=dev)

    def zb():
        return torch.zeros((n,), dtype=torch.bool, device=dev)

    return (z3(),
            dict(depth=torch.zeros((n,), device=dev), normal=z3(),
                 obj_id=torch.zeros((n,), dtype=torch.int32, device=dev)),
            dict(refl_o=z3(), refl_d=z3(), w_refl=z3(), refr_o=z3(),
                 refr_d=z3(), w_refr=z3(), spawn_refl=zb(), spawn_refr=zb(),
                 refr_spawned=zb(), alpha_zero=zb(),
                 n_shadow_rays=torch.zeros((), dtype=torch.int64,
                                           device=dev)))


def _expand(acc, kept, take, perm):
    """The fold's children radiance at their places before the compaction:
    ``acc[take]`` where ``kept``, else 0.  Under autograd (``perm``, the
    kept children's places, is kept only in grad mode) the same values are
    put at ``perm``: the gather's backward would sum every dropped child's
    cotangent into row ``take`` = cap - 1, one after another."""
    if perm is not None and acc.requires_grad:
        return acc.new_zeros((kept.shape[0], acc.shape[1])).index_copy(
            0, perm, acc)
    return torch.where(kept[:, None], acc[take], 0.0)


def render_sample(sa, static, prep, cfg: RaytracingConfig,
                  engine: EngineConfig, n_levels: int, boxes,
                  px, py, valid, cell, key):
    """One AA/MC sample for a pixel chunk: the forward wavefront sweep over
    levels 1..n_levels (children in positionally aligned [reflection;
    refraction] halves, compacted past the queue cap) and the backward
    fold of children radiance into parents.

    Returns (color (n,3), depth (n,), normal (n,3), obj_id (n,), dropped,
    traced) — the last two as 0-dim int64 tensors."""
    dev = px.device
    n = px.shape[0]
    cap = int(max(n, round(n * engine.queue_factor)))
    o, d = rays_ops.primary_rays(
        sa.camera, static.width, static.height, px, py,
        cell[0], cell[1], sample_cell_size(cfg.samples),
        cfg.aperture_size, cfg.focal_length, cfg.samples)

    weight = torch.ones((n, 3), device=dev)
    alive = valid
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    traced = torch.zeros((), dtype=torch.int64, device=dev)
    aov0 = None
    levels = []   # per level: contrib, own_id, override, child_inv

    for depth in range(1, n_levels + 1):
        lkey = rng.fold_in(key, depth)

        def shade():
            return _shade_level(sa, static, prep, cfg, o, d, weight, alive,
                                depth, lkey, boxes, engine)

        # an all-dead level contributes nothing: skip its trace and shade
        if depth == 1:
            emission, aov, ch = shade()
        else:
            emission, aov, ch = graphs.cond(
                alive, shade, lambda: _dead_level(o.shape[0], dev), "level")
        traced = traced + alive.sum() + ch["n_shadow_rays"]
        contrib = torch.where(alive[..., None], weight * emission, 0.0)
        if depth == 1:
            aov0 = aov
        own_id = torch.where(alive, aov["obj_id"], 0)
        override = alive & ch["alpha_zero"] & ch["refr_spawned"]
        levels.append(dict(contrib=contrib, own_id=own_id,
                           override=override, child_inv=None,
                           child_perm=None))
        if depth == n_levels:
            break

        o = torch.cat([ch["refl_o"], ch["refr_o"]])
        d = torch.cat([ch["refl_d"], ch["refr_d"]])
        weight = torch.cat([ch["w_refl"], ch["w_refr"]])
        alive_c = torch.cat([alive & ch["spawn_refl"],
                             alive & ch["spawn_refr"]])
        if alive_c.shape[0] > cap:
            # alive-first, heaviest-weight-first compaction; children past
            # the cap are dropped lowest-weight-first and counted
            sort_key = torch.where(alive_c, -weight.amax(dim=-1), 1.0)
            perm_full = torch.argsort(sort_key, stable=True)
            perm = perm_full[:cap]
            # index_select, whose backward adds the unique rows back
            # (index_add_) where x[perm]'s sorts them first (index_put_)
            o, d, weight = (torch.index_select(x, 0, perm)
                            for x in (o, d, weight))
            alive = alive_c[perm]
            dropped = dropped + (alive_c.sum() - alive.sum())
            # rank of each child in the compaction order (rank < cap:
            # kept at that position) — the fold inverts with it
            inv = torch.empty_like(perm_full)
            inv[perm_full] = torch.arange(perm_full.shape[0], device=dev)
            levels[-1]["child_inv"] = inv
            if torch.is_grad_enabled():
                levels[-1]["child_perm"] = perm   # for _expand's backward
        else:
            alive = alive_c

    # ---- backward fold: children radiance → parents ----
    acc = levels[-1]["contrib"]
    id_acc = levels[-1]["own_id"]
    for lvl in range(len(levels) - 2, -1, -1):
        parent = levels[lvl]
        n_parent = parent["contrib"].shape[0]
        inv = parent["child_inv"]
        if inv is not None:
            kept = inv < acc.shape[0]
            take = torch.clamp(inv, max=acc.shape[0] - 1)
            expanded = _expand(acc, kept, take, parent["child_perm"])
            id_expanded = torch.where(kept, id_acc[take], 0)
        else:
            expanded = acc
            id_expanded = id_acc
        child_sum = expanded[:n_parent] + expanded[n_parent:]
        acc = parent["contrib"] + child_sum
        refr_resolved = id_expanded[n_parent:]
        id_acc = torch.where(parent["override"], refr_resolved,
                             parent["own_id"])

    return acc, aov0["depth"], aov0["normal"], id_acc, dropped, traced


def build_chunk_fn(static, cfg: RaytracingConfig, engine: EngineConfig,
                   n_levels: int):
    """The per-chunk render function of the JAX package's
    ``build_chunk_fn``.

    Signature: chunk_fn(sa, prep, boxes, px, py, valid, cells, cell_idx,
    cell_valid, key) → (color_sum, depth_sum, normal_sum, obj_id, dropped,
    traced), where (prep, boxes) come from :func:`prepare_frame` and
    ``cells`` (S, 2) are sample cells (possibly a shard of the full
    pattern) on the host, ``cell_idx`` their global sample indices (a
    cell's key is ``fold_in(key, cell_idx[i])``, so every sharding draws
    the same numbers) and ``cell_valid`` masks padding cells, which add
    nothing.  Sums are not divided by the sample count; the object id is
    the last valid cell's; dropped and traced are 0-dim int64 tensors.
    It runs under autograd unless its caller turns gradients off."""

    def chunk_fn(sa, prep, boxes, px, py, valid, cells, cell_idx, cell_valid,
                 key):
        samples = (render_sample(sa, static, prep, cfg, engine, n_levels,
                                 boxes, px, py, valid, cell,
                                 rng.fold_in(key, int(idx)))
                   for cell, idx, cv in zip(cells, cell_idx, cell_valid)
                   if bool(cv))
        with spans.span("chunk.dispatch"):
            return _reduce_cells(len(cells), samples, px.shape[0], px.device)

    return chunk_fn


def _reduce_cells(n_cells: int, samples, n: int, dev, keep=None):
    """The chunk program's reduction over its sample cells: ``samples``
    yields each valid cell's :func:`render_sample` outputs in cell order.
    One cell's outputs come back as they are (``keep``, e.g. a copy, is
    applied to them), several are summed from zeros in cell order, and the
    object id is the last valid cell's (zeros when no cell is valid)."""
    keep = keep or (lambda x: x)
    # one tensor per output: callers reduce them in place
    sums = [torch.zeros((n, 3), device=dev), torch.zeros((n,), device=dev),
            torch.zeros((n, 3), device=dev),
            torch.zeros((n,), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev)]
    for out in samples:
        if n_cells == 1:
            return tuple(keep(x) for x in out)
        for k in (0, 1, 2, 4, 5):
            sums[k] = sums[k] + out[k]
        sums[3] = keep(out[3])
    return tuple(sums)


# False runs the chunk program eagerly on every device (inside eager());
# read at call time
_CAPTURE = True
# captures of the chunk program and its replays since reset_graph_stats():
# counts, the seconds of every capture (its ``chunk.capture`` span: warm-up
# and capture, from a synchronized start to a synchronized end) and the IF
# nodes of those captures per gate ("level", "traversal", "slice",
# "fallback")
graph_stats = {"captures": 0, "capture_seconds": 0.0, "replays": 0,
               "if_nodes": {}}

# The chunk programs built so far, as the JAX package's
# _RENDERER_CACHE holds its jitted ones: a render() whose key is cached
# builds nothing.  On CUDA it also holds what the cached graphs read and
# write: one graph memory pool per device (key ("pool", device)) and, per
# scene key, the scene tensors the graphs read (("scene", ...), see
# bind_scene).  Between calls that keeps alive, per device, the pool (the
# largest capture's temporaries and every graph's outputs) and a copy of
# each scene key's tensors; _RENDERER_CACHE.clear() releases all of it.
_RENDERER_CACHE: Dict[tuple, object] = {}


def reset_graph_stats() -> None:
    graph_stats.update(captures=0, capture_seconds=0.0, replays=0,
                       if_nodes={})


@contextlib.contextmanager
def eager():
    """Run the chunk program eagerly on every device inside the block: the
    eager frame that the captured one is held to."""
    global _CAPTURE
    was, _CAPTURE = _CAPTURE, False
    try:
        yield
    finally:
        _CAPTURE = was


def captures(static, engine: EngineConfig, device) -> bool:
    """Whether the chunk program runs as CUDA graphs: on CUDA tensors when
    a kernel walks the mesh (K1, K2, or K3 with its K1 fallback).  The
    dense scan, the XLA cluster walk (its rounds loop on the host) and the
    kernels' twins run eagerly."""
    device = torch.device(device)
    return (_CAPTURE and device.type == "cuda" and not engine.pallas_interpret
            and engine.use_pallas(static, device))


def _leaves(tree):
    """The tensors of a scene tree (dataclasses of tensors, tuples), in a
    fixed order, with None where one is absent."""
    if tree is None or isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    else:
        for x in tree:
            yield from _leaves(x)


def _clone_tree(tree):
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else tree.clone()
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _clone_tree(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return type(tree)(_clone_tree(x) for x in tree)


def _scene_key(static, engine: EngineConfig, scene) -> tuple:
    """What the JAX package's jit keys on implicitly, and a captured
    program bakes in: the device of the scene tensors ``scene`` = (sa,
    prep, boxes), the shape and dtype of every one of them, whether the
    chunk program runs as CUDA graphs (:func:`captures`) and the walk that
    the slab pack selects (K1 or K2, ``pack_is_gated``)."""
    sa, prep, _ = scene
    dev = sa.verts.device
    pack = prep.pallas_pack
    return (dev, captures(static, engine, dev),
            pack is not None and pack_is_gated(pack),
            tuple(None if t is None else (tuple(t.shape), t.dtype)
                  for t in _leaves(scene)))


def _config_key(static, cfg: RaytracingConfig, engine: EngineConfig,
                n_levels: int, scene) -> tuple:
    """The JAX package's ``_config_key``, item for item, then
    :func:`_scene_key` of ``scene`` = (sa, prep, boxes)."""
    return (static, cfg.monte_carlo, cfg.samples, cfg.focal_length,
            cfg.aperture_size, cfg.fog_density, tuple(cfg.fog_color),
            cfg.max_recursion, cfg.gamma_correction,
            engine.chunk_pixels, engine.queue_factor, engine.tri_tile,
            engine.seed, n_levels, engine.accel, engine.accel_block,
            engine.accel_gather, engine.accel_min_tris, engine.pallas,
            engine.pallas_block, engine.pallas_interpret,
            engine.pallas_algo) + _scene_key(static, engine, scene)


def _refresh(bound, scene) -> None:
    """Copy the tensors of ``scene`` into the buffers ``bound`` (none onto
    itself)."""
    for dst, src in zip(_leaves(bound), _leaves(scene)):
        if dst is not None and dst is not src:
            dst.copy_(src)


def bind_scene(sa, prep, boxes, static, engine: EngineConfig):
    """The scene tensors (sa, prep, boxes) that the chunk programs read,
    holding this frame's values.  Where :func:`captures` says so, buffers
    the cache owns, one set per scene key, which every cached graph of that
    key reads: copies of the first frame's tensors, refreshed from each
    later frame's by ``copy_`` (render() binds once per call, so a tensor
    changed in place shows in the next render).  Elsewhere, the tensors
    themselves."""
    scene = (sa, prep, boxes)
    if not captures(static, engine, sa.verts.device):
        return scene
    key = ("scene",) + _scene_key(static, engine, scene)
    bound = _RENDERER_CACHE.get(key)
    if bound is None:
        bound = _RENDERER_CACHE[key] = _clone_tree(scene)
    else:
        _refresh(bound, scene)
    return bound


def _graph_pool(dev):
    """The memory pool of every cached graph on ``dev``.  Sharing it is
    safe: graphs replay one at a time on one stream, each replay's outputs
    are copied out before the next replay, and a graph's inputs, scene
    buffers and outputs stay allocated while it lives, so memory that one
    capture freed and a later one took holds nothing live across replays
    (in any order of keys, A, B, A included).  The bodies of the IF nodes
    allocate in it too (:func:`graphs.route_to_pool`): their temporaries
    live only inside their node, and what leaves a body is copied into
    tensors allocated before the node."""
    key = ("pool", dev)
    if key not in _RENDERER_CACHE:
        _RENDERER_CACHE[key] = torch.cuda.graph_pool_handle()
    return _RENDERER_CACHE[key]


def _capture_graph(fn, pool):
    """Capture ``fn()`` in a CUDA graph over ``pool``, the bodies of its
    conditional nodes included; returns (its outputs, the graph's
    replay)."""
    graph = torch.cuda.CUDAGraph()
    dev = torch.cuda.current_device()
    routed = False
    try:
        with torch.cuda.graph(graph, pool=pool):
            graphs.route_to_pool(dev, pool)
            routed = True
            out = fn()
    finally:
        if routed:
            graphs.release_pool(dev, pool)
    return out, graph.replay


def _warm_up(fn, dev):
    """Run ``fn()`` eagerly as a capture records it, on a side stream (so
    every kernel the graph launches, in every branch, is loaded before the
    capture); returns the :class:`graphs.Census` of its gates."""
    with graphs.unconditional() as census:
        if dev.type != "cuda":
            fn()
            return census
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(dev).wait_stream(side)
    return census


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _SampleGraph:
    """One sample of one chunk, captured: the primary rays, every level and
    the backward fold in a CUDA graph over static input buffers (pixels,
    validity, the sample cell and its key words) and the scene buffers
    ``scene`` of :func:`bind_scene`, which its caller refreshes."""

    def __init__(self, static, cfg: RaytracingConfig, engine: EngineConfig,
                 n_levels: int, pool, scene):
        self.args = (static, cfg, engine, n_levels)
        self.pool = pool
        self.scene = scene
        self.inputs = None

    def _capture(self, ins):
        static, cfg, engine, n_levels = self.args
        sa, prep, boxes = self.scene
        dev = ins[0].device
        self.inputs = tuple(x.clone() for x in ins)

        def sample():
            return render_sample(sa, static, prep, cfg, engine, n_levels,
                                 boxes, *self.inputs)

        _sync(dev)
        with spans.span("chunk.capture") as captured:
            self.counts = graphs.device_counts(dev)
            census = _warm_up(sample, dev)
            before = graphs.snapshot()
            with graphs.recording(dev, census) as rec:
                self.outputs, self.replay = _capture_graph(sample, self.pool)
            after = graphs.snapshot()
            graphs.restore(before)
            _sync(dev)
        # what a replay launches whatever its IF nodes decide, and per node
        # what its own body launches each time it runs
        self.delta = [a - b - c for a, b, c in zip(after, before, rec.delta)]
        self.runs, self.site_deltas = rec.runs, rec.deltas
        self.pending = 0
        graph_stats["captures"] += 1
        graph_stats["capture_seconds"] += captured.seconds
        # a new dict: a copy of graph_stats taken earlier keeps its counts
        nodes = dict(graph_stats["if_nodes"])
        for site in rec.sites:
            nodes[site] = nodes.get(site, 0) + 1
        graph_stats["if_nodes"] = nodes

    def _settle(self, runs) -> None:
        """Add the launches of the replays since the last fetch, ``runs``
        being the host copy of the nodes' run counts."""
        delta = [self.pending * u for u in self.delta]
        for site_delta, n in zip(self.site_deltas, runs.tolist()):
            delta = [d + n * s for d, s in zip(delta, site_delta)]
        graphs.add(delta)
        self.pending = 0

    def run(self, px, py, valid, cells, keys, cell_valid):
        """:func:`build_chunk_fn`'s outputs for cells (S, 2) and their keys
        (S, 2), int64 tensors on the chunk's device: one replay per valid
        cell, reduced in cell order."""
        if self.inputs is None:
            self._capture((px, py, valid, cells[0], keys[0]))
        else:
            graphs.carry_over(self.counts)
        for buf, x in zip(self.inputs, (px, py, valid)):
            buf.copy_(x)

        def replays():
            for i, cv in enumerate(cell_valid):
                if not cv:
                    continue
                if not self.pending:
                    # the first replay since the last fetch
                    self.runs.zero_()
                    graphs.defer(self.runs, self._settle)
                self.inputs[3].copy_(cells[i])
                self.inputs[4].copy_(keys[i])
                self.replay()
                self.pending += 1
                graph_stats["replays"] += 1
                yield self.outputs

        return _reduce_cells(len(cell_valid), replays(), px.shape[0],
                             px.device, keep=torch.clone)


def _upload(a, dev):
    """A host array as an int64 tensor on ``dev``, copied without waiting
    for the stream (pinned memory on CUDA)."""
    t = torch.as_tensor(np.asarray(a, dtype=np.int64))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _graph_chunk_fn(static, cfg: RaytracingConfig, engine: EngineConfig,
                    n_levels: int, scene):
    """The chunk program of :func:`build_chunk_fn` as a CUDA graph over the
    bound scene buffers of ``scene``."""
    bound = bind_scene(*scene, static, engine)
    scene_key = _scene_key(static, engine, bound)
    graph = _SampleGraph(static, cfg, engine, n_levels,
                         _graph_pool(bound[0].verts.device), bound)

    def chunk_fn(sa, prep, boxes, px, py, valid, cells, cell_idx, cell_valid,
                 key):
        if _scene_key(static, engine, (sa, prep, boxes)) != scene_key:
            raise ValueError(
                "these scene tensors differ in device, shape or dtype from "
                "the ones the chunk program was made for (or the pack "
                "selects another walk); make_chunk_renderer makes one for "
                "them")
        with spans.span("chunk.dispatch"):
            _refresh(bound, (sa, prep, boxes))
            dev = px.device
            keys = [rng.fold_in(key, int(i)).numpy() for i in cell_idx]
            return graph.run(px, py, valid, _upload(cells, dev),
                             _upload(keys, dev),
                             [bool(v) for v in cell_valid])

    return chunk_fn


def make_chunk_renderer(static, cfg: RaytracingConfig, engine: EngineConfig,
                        n_levels: int, scene):
    """Build (or fetch from the cache) the chunk program of
    :func:`build_chunk_fn`, with its signature and outputs, for the scene
    tensors ``scene`` = (sa, prep, boxes) of :func:`bind_scene`: their
    device, shapes and dtypes are part of the key (:func:`_config_key`).

    Where :func:`captures` says so, CUDA graphs: the first call captures
    one sample of the chunk after an eager warm-up, and every call, in this
    render() or a later one, replays it once per valid cell over the cached
    scene buffers.  A call with other tensors of the same key copies them
    in first; tensors of another key raise ValueError.  Elsewhere the
    cached object is build_chunk_fn, run eagerly, as the JAX package's is
    its jitted function.

    Every cached graph of a device captures into one memory pool
    (:func:`_graph_pool`).  Its outputs equal build_chunk_fn's bit for bit,
    and its IF nodes skip the all-dead work that build_chunk_fn skips, so
    a replay launches what build_chunk_fn launches (:mod:`..graphs`).  Its
    launch counts are added at the next :func:`graphs.fetch` (render()
    fetches once per group of cells; a direct caller calls
    :func:`graphs.settle` before it reads them)."""
    key = _config_key(static, cfg, engine, n_levels, scene)
    cached = _RENDERER_CACHE.get(key)
    if cached is not None:
        return cached
    # the program keeps copies: a caller may change its configs in place
    cfg, engine = dataclasses.replace(cfg), dataclasses.replace(engine)
    if captures(static, engine, scene[0].verts.device):
        fn = _graph_chunk_fn(static, cfg, engine, n_levels, scene)
    else:
        fn = build_chunk_fn(static, cfg, engine, n_levels)
    _RENDERER_CACHE[key] = fn
    return fn


def frame_levels(sa, cfg: RaytracingConfig) -> int:
    """Number of wavefront levels: 1 + max_recursion when any material can
    spawn reflection/refraction children, else 1."""
    mats = sa.materials
    has_secondary = bool(
        (mats.reflectivity > 0.0).any()
        or (mats.alpha < 1.0).any()
        or (mats.tex_w[:, int(TextureType.Reflectivity)] > 0).any()
        or (mats.tex_w[:, int(TextureType.Alpha)] > 0).any())
    return (1 + cfg.max_recursion) if has_secondary else 1


def max_queue_factor(n_levels: int) -> float:
    """Cap for the drop auto-raise: the Whitted tree doubles per bounce."""
    return float(min(2 ** max(n_levels - 1, 0), 64))


# The chunk walk: what render(), render_sharded and render_loss_and_grad
# take for each chunk of the frame.

def chunk_slab(static, start: int, span: int, dev, ray: int = 0,
               n_rays: int = 1):
    """Ray shard ``ray`` of ``n_rays`` of the chunk [start, start + span):
    the chunk padded to a multiple of ``n_rays`` pixels (so the frame's
    last chunk has the lane count of the others) and cut into ``n_rays``
    equal slabs, as the JAX package's ``_pad_pixels`` and ``_shard``.
    Returns (px, py, valid, pix) on ``dev``: int32 pixel coordinates, the
    indices clamped at W·H − 1; the mask of pixels inside the frame; the
    global pixel indices (int64)."""
    n_pix = static.width * static.height
    per = -(-span // n_rays)
    pix = torch.arange(start + ray * per, start + (ray + 1) * per, device=dev)
    idx = torch.clamp(pix, max=n_pix - 1)
    return ((idx % static.width).to(torch.int32),
            (idx // static.width).to(torch.int32), pix < n_pix, pix)


def chunk_key(seed: int, start: int) -> torch.Tensor:
    """The key of the chunk at pixel ``start``: ``fold_in(PRNGKey(seed),
    start)``."""
    return rng.fold_in(rng.PRNGKey(seed), start)


def chunk_cells(cfg: RaytracingConfig, seed: int, shard: int = 0,
                n_shards: int = 1):
    """Sample shard ``shard`` of ``n_shards`` of the frame's sample cells
    (:func:`sample_pattern`), padded to a multiple of ``n_shards`` with
    zero cells, as the JAX package's ``_pad_cells`` and ``_shard``.
    Returns numpy (cells (S, 2) int32, cell_idx (S,) their global indices,
    cell_valid (S,) the mask of real cells)."""
    cells = sample_pattern(cfg.samples, seed)
    s = cells.shape[0]
    per = -(-s // n_shards)
    cells = np.concatenate([cells, np.zeros((per * n_shards - s, 2),
                                            np.int32)])
    cell_idx = np.arange(per * n_shards, dtype=np.int32)
    mine = slice(shard * per, (shard + 1) * per)
    return cells[mine], cell_idx[mine], cell_idx[mine] < s


def raise_queue(render_at, eng: EngineConfig, n_drop: int, max_qf: float,
                what: str = "chunk"):
    """The queue auto-raise of a chunk that dropped ``n_drop`` live rays
    at the carried engine ``eng``: re-render it with ``render_at(engine)``
    → (outputs, dropped, traced) at the factor doubled until nothing drops
    or the factor reaches ``max_qf``.  Returns (the last attempt's
    outputs, None when none ran; the engine reached; the traced rays of
    each attempt; the rays still dropped)."""
    out, traced = None, []
    while n_drop > 0 and eng.queue_factor < max_qf:
        new_qf = min(eng.queue_factor * 2.0, max_qf)
        print(f"info: {n_drop} live secondary rays beyond "
              f"queue_factor={eng.queue_factor}; re-rendering {what} "
              f"with queue_factor={new_qf}")
        eng = dataclasses.replace(eng, queue_factor=new_qf)
        out, n_drop, n_traced = render_at(eng)
        traced.append(n_traced)
    if n_drop:
        print(f"warning: dropped {n_drop} live secondary rays at "
              f"queue_factor={eng.queue_factor} (cap {max_qf}); "
              f"image may deviate from the full Whitted tree")
    return out, eng, traced, n_drop


def prepare_frame(sa, static, engine: EngineConfig):
    """Per-frame triangle constants, shading packs, the kernels' slab pack
    and world cluster boxes.  Returns (prep, boxes); boxes is None on the
    dense path."""
    use_pallas = engine.use_pallas(static, sa.verts.device)
    prep = prepare_triangles(sa)
    prep = build_shade_packs(sa, prep, prepare_vertex_normals(sa))
    if use_pallas:
        prep = prep.replace(pallas_pack=pack_cluster_tris(
            prep, sa.tri_valid, static.n_clusters, static.cluster_size,
            int(sa.cl_lo.shape[0])))
    if not (engine.use_accel(static) or use_pallas):
        return prep, None
    return prep, world_cluster_aabbs(sa)


@torch.no_grad()
def render(sa, static, cfg: RaytracingConfig, engine: EngineConfig = None,
           checkpoint_path: str = None, max_chunks: int = None,
           preview_path: str = None,
           preview_every: int = 1) -> Dict[str, np.ndarray]:
    """Render the full frame from the port's tensor SceneArrays (on any
    device; see :func:`rustray_tpu_torch.scene_arrays.to_torch`).

    Returns numpy AOVs: ``image`` (H, W, 3) uint8, ``color`` (H, W, 3) f32
    (sample-averaged, clamped), ``depth`` (H, W), ``normal`` (H, W, 3),
    ``object_id`` (H, W) int32, ``device_rays`` (live rays traced: primary,
    shadow and secondary, all samples, re-renders included) and
    ``dropped_rays`` (live rays still dropped after the auto-raise).

    ``checkpoint_path``: after every chunk, persist the accumulators, the
    cursor, the ray counts and the queue factor (atomic tmp + rename), and
    resume from the file when it exists and matches the render's
    fingerprint, so that an interrupted render resumes into the
    uninterrupted result bit for bit; the file is removed once the frame
    completes.  ``max_chunks``: render at most this many chunks and return
    the partial frame.  ``preview_path``: write the partial frame as a PNG
    after every ``preview_every``-th chunk and after the last one.  Any of
    the three renders chunk by chunk; without them the frame renders as
    the JAX package's device loop: every chunk per group of
    ``samples_per_dispatch`` cells, one fetch of the counts per group.
    Both walk the chunks with :func:`chunk_slab`, :func:`chunk_key` and
    :func:`raise_queue`, and take their chunk programs from
    ``_RENDERER_CACHE`` (one per queue factor):
    a later call of the same key builds and captures nothing and replays
    the CUDA graphs over its own scene tensors, copied into the cached
    buffers once at its start (:func:`bind_scene`).

    The call is the ``render`` span, its stages the ``render.*`` spans
    (:mod:`..spans`)."""
    with spans.span("render"):
        return _render(sa, static, cfg, engine or EngineConfig(),
                       checkpoint_path, max_chunks, preview_path,
                       preview_every)


def _render(sa, static, cfg, engine, checkpoint_path, max_chunks,
            preview_path, preview_every):
    dev = sa.verts.device
    W, H = static.width, static.height
    n_pix = W * H
    chunk = min(engine.chunk_pixels, n_pix)
    with spans.span("render.prepare"):
        n_levels = frame_levels(sa, cfg)
        cells, cell_idx, cell_valid = chunk_cells(cfg, engine.seed)
        prep, boxes = prepare_frame(sa, static, engine)
    # what the chunk programs read: on the card, the cached graphs' buffers
    # holding this frame's tensors
    with spans.span("render.bind"):
        scene = bind_scene(sa, prep, boxes, static, engine)

    color = torch.zeros((n_pix, 3), device=dev)
    depth = torch.zeros((n_pix,), device=dev)
    normal = torch.zeros((n_pix, 3), device=dev)
    obj_id = torch.zeros((n_pix,), dtype=torch.int32, device=dev)
    device_rays = 0
    dropped_rays = 0
    max_qf = max_queue_factor(n_levels)

    # checkpoint identity: anything that changes per-chunk numerics,
    # the scene content included
    with spans.span("render.fingerprint"):
        fingerprint = repr((W, H, chunk, cfg, engine, n_levels,
                            _scene_fingerprint(sa, static)))
    cursor = 0
    eng = engine
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        with np.load(checkpoint_path, allow_pickle=False) as z:
            resume = str(z["fingerprint"]) == fingerprint
            if resume:
                color, depth, normal, obj_id = (
                    torch.tensor(z[k], device=dev)
                    for k in ("color", "depth", "normal", "obj_id"))
                cursor = int(z["cursor"])
                device_rays = int(z["device_rays"])
                dropped_rays = int(z["dropped_rays"])
                eng = dataclasses.replace(
                    engine, queue_factor=float(z["queue_factor"]))
        if resume:
            print(f"resuming render from checkpoint {checkpoint_path} "
                  f"(pixel {cursor}/{n_pix})")
        else:
            print(f"warning: checkpoint {checkpoint_path} does not match "
                  f"this render config; starting from scratch")

    def render_at(start):
        """The chunk at ``start`` with every cell, fetched: engine →
        (outputs, dropped, traced)."""
        px, py, valid, _ = chunk_slab(static, start, chunk, dev)
        key = chunk_key(engine.seed, start)

        def at(eng):
            fn = make_chunk_renderer(static, cfg, eng, n_levels, scene)
            *out, drops, traced = fn(*scene, px, py, valid, cells, cell_idx,
                                     cell_valid, key)
            with spans.span("render.fetch"):
                n_drop, n_traced = graphs.fetch(torch.stack([drops, traced]))
            return out, int(n_drop), int(n_traced)

        return at

    def rerender(at, n_drop):
        """Re-render a chunk that dropped ``n_drop`` live rays from the
        carried factor (:func:`raise_queue`), counting every attempt's
        rays and the rays still dropped.  Returns the last attempt's
        outputs, None when none ran."""
        nonlocal eng, device_rays, dropped_rays
        if not n_drop:
            return None
        with spans.span("render.rerender"):
            out, eng, traced, n_drop = raise_queue(at, eng, n_drop, max_qf)
        device_rays += sum(traced)
        dropped_rays += n_drop
        return out

    def put_chunk(start, out):
        nv = min(chunk, n_pix - start)
        for acc, part in zip((color, depth, normal, obj_id), out):
            acc[start:start + nv] = part[:nv]

    # every chunk first renders at the engine's own queue factor; the raised
    # factor carries forward across chunks' re-renders (a scene that
    # overflows once overflows again) and is restored on resume, so that a
    # resumed frame equals the uninterrupted one in every key.  (The JAX
    # package first renders a resumed frame's chunks at the raised factor.)
    if checkpoint_path is None and max_chunks is None and preview_path is None:
        # the frame path (the JAX package's device loop): every chunk of
        # the frame per group of samples_per_dispatch cells, with one fetch
        # of the drop and ray counts per group; each chunk's group sums add
        # into the frame in group order and the last group's object id wins
        starts = range(0, n_pix, chunk)
        # the padded frame's slab, cut into every chunk's
        px, py, valid, _ = chunk_slab(static, 0, len(starts) * chunk, dev)
        keys = [chunk_key(engine.seed, s) for s in starts]
        fn = make_chunk_renderer(static, cfg, engine, n_levels, scene)
        per = max(1, int(engine.samples_per_dispatch))
        drops = np.zeros((len(starts),), np.int64)
        for g0 in range(0, len(cells), per):
            g = slice(g0, g0 + per)
            with spans.span("render.group"):
                dr, tr = [], []
                for start, key in zip(starts, keys):
                    c, dpt, nrm, oid, d, t = fn(
                        *scene, px[start:start + chunk],
                        py[start:start + chunk], valid[start:start + chunk],
                        cells[g], cell_idx[g], cell_valid[g], key)
                    nv = min(chunk, n_pix - start)
                    for acc, part in zip((color, depth, normal),
                                         (c, dpt, nrm)):
                        # add_, not +=, which copies the slice back
                        acc[start:start + nv].add_(part[:nv])
                    obj_id[start:start + nv] = oid[:nv]
                    dr.append(d)
                    tr.append(t)
                with spans.span("render.fetch"):
                    counts = graphs.fetch(torch.stack([torch.stack(dr),
                                                       torch.stack(tr)]))
                drops += counts[0]
                device_rays += int(counts[1].sum())
        # chunks that dropped live rays re-render in chunk order
        for ci in np.nonzero(drops)[0]:
            out = rerender(render_at(starts[ci]), int(drops[ci]))
            if out is not None:
                put_chunk(starts[ci], out)
        with spans.span("render.finish"):
            return finish_frame(color, depth, normal, obj_id, cfg, W, H,
                                device_rays, dropped_rays)

    # the checkpoint/preview path: chunk by chunk, each fetched
    starts = list(range(cursor, n_pix, chunk))
    if max_chunks is not None:
        starts = starts[:max_chunks]
    for done, start in enumerate(starts, 1):
        at = render_at(start)
        out, n_drop, traced = at(engine)
        device_rays += traced
        rerun = rerender(at, n_drop)
        put_chunk(start, out if rerun is None else rerun)
        if preview_path is not None and (done % preview_every == 0
                                         or start + chunk >= n_pix):
            _write_preview(preview_path, color.cpu().numpy(), cfg, W, H)
        if checkpoint_path is not None:
            tmp = checkpoint_path + ".tmp.npz"  # savez keeps .npz names
            np.savez(tmp, fingerprint=fingerprint,
                     color=color.cpu().numpy(), depth=depth.cpu().numpy(),
                     normal=normal.cpu().numpy(),
                     obj_id=obj_id.cpu().numpy(),
                     cursor=np.int64(start + chunk),
                     device_rays=np.int64(device_rays),
                     dropped_rays=np.int64(dropped_rays),
                     queue_factor=np.float64(eng.queue_factor))
            os.replace(tmp, checkpoint_path)

    finished = cursor + len(starts) * chunk >= n_pix
    if checkpoint_path is not None and finished and os.path.exists(
            checkpoint_path):
        os.remove(checkpoint_path)

    with spans.span("render.finish"):
        return finish_frame(color, depth, normal, obj_id, cfg, W, H,
                            device_rays, dropped_rays)


def finish_frame(color, depth, normal, obj_id, cfg: RaytracingConfig, W: int,
                 H: int, device_rays: int,
                 dropped_rays: int) -> Dict[str, np.ndarray]:
    """The AOV dict of :func:`render` from the frame's per-pixel sample
    sums (tensors of (W·H, ...)): averaged over the samples, the color
    clamped and quantized (with gamma when the config asks for it), the
    normal normalized."""
    inv_s = 1.0 / cfg.samples
    color = (color * inv_s).cpu().numpy()
    depth = (depth * inv_s).cpu().numpy()
    normal = (normal * inv_s).cpu().numpy()
    obj_id = obj_id.cpu().numpy()
    color = np.minimum(color, 1.0)

    if cfg.gamma_correction:
        quant = np.power(np.maximum(color, 0.0), 1.0 / 2.2)
    else:
        quant = color
    image = np.trunc(quant * 255.0).astype(np.uint8)

    norm_len = np.linalg.norm(normal, axis=-1, keepdims=True)
    normal = np.where(norm_len > 0, normal / np.maximum(norm_len, 1e-30), 0.0)

    return dict(
        image=image.reshape(H, W, 3),
        color=color.reshape(H, W, 3),
        depth=depth.reshape(H, W),
        normal=normal.reshape(H, W, 3),
        object_id=obj_id.reshape(H, W),
        device_rays=device_rays,
        dropped_rays=dropped_rays,
    )


def _write_preview(path, color_sum, cfg, W, H):
    """Partial-frame PNG from the running accumulators (progressive view)."""
    from PIL import Image
    c = np.minimum(color_sum * (1.0 / cfg.samples), 1.0)
    if cfg.gamma_correction:
        c = np.power(np.maximum(c, 0.0), 1.0 / 2.2)
    img = np.trunc(c * 255.0).astype(np.uint8).reshape(H, W, 3)
    tmp = path + ".tmp.png"
    Image.fromarray(img).save(tmp)
    os.replace(tmp, path)


def _scene_fingerprint(sa, static) -> str:
    """Cheap scene-content identity for the checkpoint fingerprint: shape
    census plus coarse content sums of the geometry/material leaves, read
    in double precision on the host as the JAX package reads them."""
    parts = [static.n_instances, static.n_spheres, static.n_tris,
             static.n_materials, static.n_lights, static.n_clusters]
    for leaf in (sa.verts, sa.inst_trans, sa.materials.base_color,
                 sa.materials.alpha, sa.lights.pos, sa.lights.intensity,
                 sa.camera.view_inv):
        a = leaf.detach().cpu().double().numpy()
        parts.append((a.shape, round(float(a.sum()), 6),
                      round(float(np.abs(a).sum()), 6)))
    return repr(parts)
