"""The reference renderer with the glTF material model: ``render.py``'s
per-pixel Whitted / Monte-Carlo ray tree of chosen pixels, plus what
upstream rustray does with a glTF material's maps (``src/raytracing.rs``),
in plain PyTorch at a chosen precision.  It shares no code with the
program.

What the maps add, per hit, in upstream's order:
- normal mapping (``:756-784``): tangent = normal × up, or normal ×
  forward where that is shorter than 1e-4; bitangent = normal × tangent;
  the texel's rgb·2 − 1, its x and y scaled by the material's normal-map
  strength (1, the glTF loader's), normalised, taken to the tangent frame;
- the Monte-Carlo roughness (``:786-798``): the roughness map's texel·1/2π
  where the material has one, and the jitter applies where it has one or
  its roughness is above 0;
- the base colour's texel alpha times the material's alpha is the hit's
  alpha: below 1 it spawns the refraction child, and an alpha of about 0
  takes its object id from that child (the id chain ``render.py``
  follows);
- the metallic map's texel is the hit's reflectivity, in place of the
  material's.
The glTF loader's rules (upstream ``src/scene.rs:909-1092``): B of the
metallic-roughness image is the metallic (reflectivity) map, G the
roughness map, each read as a grey image's first channel; the normal
map's alpha is set to 255; the base-colour factor's alpha is the
material's alpha.

Departures from ``render.py`` where it is not upstream: a shadow ray that
finds an occluder scales the light by 1 − the receiving material's alpha
(upstream's ``shadow_source_alpha = material.alpha``), not by its alpha
with the base texel's alpha in it; ``render.py``'s cells have opaque
texels, where the two agree.  Upstream samples an occluder's alpha map at
the receiver's uv; the program samples it at the occluder's (a documented
deviation); the scenes here have no alpha map, so neither is drawn.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, fields
from typing import List, Optional

import numpy as np
import torch

from .render import (SHADOW_BIAS, _dot, _Geometry, _jitter, _Keys,
                     _normalize, sample_cell_size, sample_pattern)
from .scene import DIRECTIONAL, SPOT, RefScene, sponza_scene

NORMAL_MAP_STRENGTH = 1.0


@dataclass
class Maps:
    """A material's maps beyond base colour, (H, W, 4) uint8 each."""
    normal: Optional[np.ndarray] = None
    metallic_roughness: Optional[np.ndarray] = None


@dataclass
class PbrScene(RefScene):
    maps: List[Maps] = field(default_factory=list)   # one per material


def pbr_scene(data, width: int, height: int, samples: int,
              monte_carlo: bool, max_recursion: int) -> PbrScene:
    """The scene of ``scenes/sponza_pbr.py``'s data loaded as a glTF
    object of a JSON scene: ``scene.sponza_scene``'s, with each material's
    normal and metallic-roughness maps."""
    base = sponza_scene(data, width, height, samples, monte_carlo,
                        max_recursion)
    maps = [Maps(m["material"].get("normal_texture"),
                 m["material"].get("metallic_roughness_texture"))
            for m in data[0]]
    return PbrScene(**{f.name: getattr(base, f.name) for f in fields(base)},
                    maps=maps)


def frame_levels(scene: PbrScene) -> int:
    """1 + max_recursion where some material can spawn a child (a
    reflectivity or a metallic map, an alpha below 1 or a base map with
    a texel below 255), else 1."""
    spawns = any(
        m.reflectivity > 0.0 or m.alpha < 1.0
        or (m.texture is not None and int(m.texture[..., 3].min()) < 255)
        or (mp.metallic_roughness is not None)
        for m, mp in zip(scene.materials, scene.maps))
    return 1 + scene.max_recursion if spawns else 1


def _bilinear_u8(tex, uv, dtype):
    """``render._bilinear`` on a uint8 texture: the upstream bilinear
    fetch (negative coordinates get one size added, floor and ceil clamped
    to the edge, weights against the clamped floor), the four texels
    widened to ``dtype`` in [0, 1] before they are blended.  The indices
    are clamped again as integers: a dtype with fewer bits than the size
    (bfloat16 holds 1023 as 1024) would round the edge past it."""
    h, w = tex.shape[:2]
    x = uv[:, 0] * w
    y = uv[:, 1] * h
    x = torch.where(x < 0, x + w, x)
    y = torch.where(y < 0, y + h, y)
    x0 = torch.clamp(torch.floor(x), 0, w - 1)
    x1 = torch.clamp(torch.ceil(x), 0, w - 1)
    y0 = torch.clamp(torch.floor(y), 0, h - 1)
    y1 = torch.clamp(torch.ceil(y), 0, h - 1)
    xf = (x - x0)[:, None]
    yf = (y - y0)[:, None]

    def at(yy, xx):
        return tex[yy.long().clamp(0, h - 1),
                   xx.long().clamp(0, w - 1)].to(dtype) / 255.0

    p0, p1, p2, p3 = at(y0, x0), at(y0, x1), at(y1, x0), at(y1, x1)
    top = p0 + xf * (p1 - p0)
    bot = p2 + xf * (p3 - p2)
    return top + yf * (bot - top)


class _Channel:
    """One map of every material that has it, by material index: a fetch
    returns (rgba (R, 4) in [0, 1], has (R,) bool) at the hits given."""

    def __init__(self, images, dtype, device):
        self.dtype, self.device = dtype, device
        groups = {}
        for mi, img in enumerate(images):
            if img is not None:
                groups.setdefault(id(img), (torch.as_tensor(
                    np.ascontiguousarray(img), device=device), []))[1].append(
                        mi)
        self.groups = [(tex, torch.tensor(ms, device=device))
                       for tex, ms in groups.values()]

    def __bool__(self):
        return bool(self.groups)

    def fetch(self, hit, mi, uv):
        r = mi.shape[0]
        rgba = torch.zeros((r, 4), dtype=self.dtype, device=self.device)
        rgba[:, 3] = 1.0
        has = torch.zeros((r,), dtype=torch.bool, device=self.device)
        for tex, ms in self.groups:
            sel = torch.nonzero(hit & torch.isin(mi, ms))[:, 0]
            if sel.numel():
                rgba[sel] = _bilinear_u8(tex, uv[sel], self.dtype)
                has[sel] = True
        return rgba, has


def _normal_mapped(sn, ntex, strength):
    """Upstream's tangent frame of ``sn`` and the texel ``ntex`` in it."""
    up = torch.zeros_like(sn)
    up[:, 1] = 1.0
    fwd = torch.zeros_like(sn)
    fwd[:, 2] = 1.0
    tangent = torch.linalg.cross(sn, up)
    short = torch.linalg.vector_norm(tangent, dim=-1) <= 1e-4
    tangent = torch.where(short[:, None], torch.linalg.cross(sn, fwd),
                          tangent)
    tangent = _normalize(tangent)
    bitangent = _normalize(torch.linalg.cross(sn, tangent))
    nm = ntex[:, :3] * 2.0 - 1.0
    nm = nm * torch.stack([strength, strength, torch.ones_like(strength)],
                          -1)
    nm = _normalize(nm)
    return _normalize(nm[:, 0:1] * tangent + nm[:, 1:2] * bitangent
                      + nm[:, 2:3] * sn)


def render_pixels(scene: PbrScene, pixels, seed: int, chunk_pixels: int,
                  queue_factor: float, dtype=torch.float64, device="cpu",
                  block: int = 1 << 23):
    """``render.render_pixels`` with the material maps of ``scene``: the
    same arguments, Monte-Carlo numbers (the program's threefry draws where
    the queue position follows from the pixel) and outputs (``color``,
    ``depth``, ``object_id``, ``exact``, ``rays`` per pixel).  TF32 is off
    while it runs, so a float32 matrix product is a float32 one."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _render_pixels(scene, pixels, seed, chunk_pixels,
                              queue_factor, dtype, device, block)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _render_pixels(scene, pixels, seed, chunk_pixels, queue_factor, dtype,
                   device, block):
    if scene.fog_density != 0.0:
        raise ValueError("the reference renders scenes without fog")
    dt, dev = dtype, torch.device(device)
    W, H = scene.width, scene.height
    pixels = torch.as_tensor(np.asarray(pixels, np.int64), device=dev)
    n_chunk = min(chunk_pixels, W * H)
    cap = max(n_chunk, int(round(n_chunk * queue_factor)))
    cells = sample_pattern(scene.samples, seed)
    S = len(cells)
    P = pixels.shape[0]
    geo = _Geometry(scene, dt, dev)
    keys = _Keys(seed, dev)
    mats = scene.materials
    L = len(scene.lights)
    n_levels = frame_levels(scene)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt,  # noqa: E731
                                  device=dev)
    item_mat = torch.tensor([it.material for it in scene.items],
                            dtype=torch.int64, device=dev)
    item_id = torch.tensor([it.obj_id for it in scene.items],
                           dtype=torch.int64, device=dev)

    def per_mat(attr, cast=float):
        return t([cast(getattr(m, attr)) for m in mats])

    m_base = t(np.stack([m.base for m in mats]))
    m_spec = t(np.stack([m.specular for m in mats]))
    m_amb = t(np.stack([m.ambient for m in mats]))
    m_alpha, m_shin = per_mat("alpha"), per_mat("shininess")
    m_refl, m_ior = per_mat("reflectivity"), per_mat("refraction_index")
    m_soft, m_rough = per_mat("shadow_softness"), per_mat("roughness")
    m_mc = torch.tensor([m.monte_carlo for m in mats], device=dev)
    m_recv = torch.tensor([m.receive_shadow for m in mats], device=dev)
    if any(m.nearest for m in mats):
        raise ValueError("the reference samples textures bilinearly only")
    base_maps = _Channel([m.texture for m in mats], dt, dev)
    normal_maps = _Channel([mp.normal for mp in scene.maps], dt, dev)
    mr_maps = _Channel([mp.metallic_roughness for mp in scene.maps], dt, dev)
    strength = torch.full((1,), NORMAL_MAP_STRENGTH, dtype=dt, device=dev)

    proj_inv, view_inv = (t(m) for m in scene.camera.matrices(W, H))
    cell_size = sample_cell_size(scene.samples)
    # the pixel-samples: pixel-major, sample cells in pattern order
    ps_pix = pixels.repeat_interleave(S)
    ps_cell = torch.arange(S, device=dev).repeat(P)
    cxy = torch.as_tensor(cells, device=dev)[ps_cell].to(dt)
    x = (ps_pix % W).to(dt)
    y = (ps_pix // W).to(dt)
    sx = ((x + 0.5) / W) * 2.0 - 1.0 + (2.0 / W) * cxy[:, 0] / cell_size \
        + scene.ndc_shift[0]
    sy = 1.0 - ((y + 0.5) / H) * 2.0 + (2.0 / H) * cxy[:, 1] / cell_size \
        + scene.ndc_shift[1]
    pp = torch.stack([sx, sy, -torch.ones_like(sx), torch.ones_like(sx)],
                     -1) @ proj_inv.T
    pp[:, 3] = 1.0
    rdv = pp.clone()
    rdv[:, 3] = 0.0
    o = (pp @ view_inv.T)[:, :3]
    d = (rdv @ view_inv.T)[:, :3]

    n_ps = P * S
    ps = torch.arange(n_ps, device=dev)
    weight = torch.ones((n_ps, 3), dtype=dt, device=dev)
    start = (ps_pix // n_chunk) * n_chunk
    slot = ps_pix - start
    queue_len = n_chunk
    color = torch.zeros((n_ps, 3), dtype=dt, device=dev)
    rays = torch.zeros((n_ps,), dtype=torch.int64, device=dev)
    exact = torch.ones((n_ps,), dtype=torch.bool, device=dev)
    depth0 = None
    spare = 0
    # per level: (own id, alpha≈0 & refracted, index of the refraction
    # child in the next level or -1), to resolve the object id backwards
    id_chain = []
    n_enabled = sum(1 for li in scene.lights if li.enabled)

    for depth in range(1, n_levels + 1):
        r = o.shape[0]
        d = _normalize(d)
        ts, item, face, bu, bv, sph_n = geo.trace(o, d, False, depth, block)
        hit = torch.isfinite(ts)
        rays.index_add_(0, ps, torch.ones_like(ps) + hit.long() * n_enabled)
        t_safe = torch.where(hit, ts, torch.zeros_like(ts))
        if depth == 1:
            depth0 = t_safe
        ii = torch.clamp(item, min=0)
        mi = item_mat[ii]
        own_id = torch.where(hit, item_id[ii], 0)
        point = o + d * t_safe[:, None]
        normal, uv = geo.surface(d, point, item, face, bu, bv, sph_n)
        cell = ps_cell[ps]
        st = start[ps]
        known = slot >= 0
        if scene.monte_carlo:
            exact[ps[~known]] = False

        sn = normal
        if normal_maps:
            ntex, has_n = normal_maps.fetch(hit, mi, uv)
            sn = torch.where(has_n[:, None],
                             _normal_mapped(sn, ntex, strength.expand(r)), sn)
        mr, has_mr = mr_maps.fetch(hit, mi, uv)
        if scene.monte_carlo:
            rough = torch.where(has_mr, (1.0 / math.pi / 2.0) * mr[:, 1],
                                m_rough[mi])
            apply = hit & m_mc[mi] & ((m_rough[mi] > 0.0) | has_mr)
            u1, u2 = keys.uniforms(st, cell, depth, 17, slot,
                                   spare + torch.arange(r, device=dev))
            spare += r
            jit = _jitter(sn, rough, u1.to(dt), u2.to(dt))
            sn = torch.where(apply[:, None], jit, sn)

        btex, has_b = base_maps.fetch(hit, mi, uv)
        base = torch.where(has_b[:, None], m_base[mi] * btex[:, :3],
                           m_base[mi])
        spec = m_spec[mi]
        alpha = m_alpha[mi] * torch.where(has_b, btex[:, 3], 1.0)
        view_dir = _normalize(-d)
        local = torch.zeros((r, 3), dtype=dt, device=dev)
        for li_idx, light in enumerate(scene.lights):
            if not light.enabled:
                continue
            lpos = t(light.pos)
            if light.kind == DIRECTIONAL:
                dtl = _normalize(-t(light.dir))[None].expand(r, 3)
                dist = None
                inten = torch.full((r,), light.intensity, dtype=dt,
                                   device=dev)
            else:
                to_l = lpos[None] - point
                dist = torch.linalg.vector_norm(to_l, dim=-1)
                dtl = _normalize(to_l)
                inten = light.intensity / (4.0 * math.pi
                                           * torch.clamp(dist, min=1e-300))
                if light.kind == SPOT:
                    ang = torch.arccos(torch.clamp(
                        _dot(-dtl, _normalize(t(light.dir))[None]), -1, 1))
                    inten = torch.where(ang > light.max_angle, 0.0, inten)
            dot_l = torch.clamp(_dot(sn, dtl), min=0.0)
            rdir = -dtl - 2.0 * _dot(sn, -dtl)[:, None] * sn
            spec_dot = torch.clamp(_dot(rdir, view_dir), min=0.0)
            power = torch.pow(spec_dot, m_shin[mi])
            lit = spec * power[:, None] + base * dot_l[:, None]

            sel = torch.nonzero(hit & m_recv[mi])[:, 0]
            if sel.numel():
                so = point[sel] + sn[sel] * SHADOW_BIAS
                sd = dtl[sel]
                if scene.monte_carlo:
                    s_slot = slot[sel]
                    u1, u2 = keys.uniforms(
                        st[sel], cell[sel], depth, 23,
                        torch.where(s_slot >= 0, s_slot * L + li_idx, -1),
                        spare + torch.arange(sel.numel(), device=dev))
                    spare += sel.numel()
                    jit = _jitter(sd, m_soft[mi[sel]], u1.to(dt), u2.to(dt))
                    sd = torch.where(m_mc[mi[sel]][:, None], jit, sd)
                sd = _normalize(sd)
                sh_t = geo.trace(so, sd, True, depth, block)[0]
                in_light = ~torch.isfinite(sh_t)
                if dist is not None:
                    in_light = in_light | (torch.isfinite(sh_t)
                                           & (sh_t > dist[sel]))
                # upstream: the receiving material's alpha
                att = torch.where(in_light, torch.ones_like(sh_t),
                                  1.0 - m_alpha[mi[sel]])
                inten = inten.clone()
                inten[sel] = inten[sel] * att
            local = local + t(light.color)[None] * lit * inten[:, None]

        refl = torch.where(has_mr, mr[:, 2], m_refl[mi])
        ior = m_ior[mi]
        local = local * (1.0 - refl[:, None])
        # fresnel, with upstream's cos_i = |cos_t|
        idn = _dot(d, sn)
        flip = idn > 0.0
        eta_i = torch.where(flip, ior, torch.ones_like(ior))
        eta_t = torch.where(flip, torch.ones_like(ior), ior)
        sin_t = eta_i / eta_t * torch.sqrt(torch.clamp(1.0 - idn * idn,
                                                       min=0.0))
        cos_t = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
        cos_i = cos_t.abs()
        r_s = (eta_t * cos_i - eta_i * cos_t) / torch.clamp(
            eta_t * cos_i + eta_i * cos_t, min=1e-300)
        r_p = (eta_i * cos_i - eta_t * cos_t) / torch.clamp(
            eta_i * cos_i + eta_t * cos_t, min=1e-300)
        kr = torch.where(sin_t > 1.0, torch.ones_like(sin_t),
                         (r_s * r_s + r_p * r_p) / 2.0)
        within = depth <= scene.max_recursion
        # transmission (upstream create_transmission)
        outside = idn < 0.0
        ref_n = torch.where(outside[:, None], sn, -sn)
        eta = torch.where(outside, 1.0 / ior, ior)
        aidn = idn.abs()
        k = 1.0 - eta * eta * (1.0 - aidn * aidn)
        spawn_refr = hit & (alpha < 1.0) & within & (k >= 0.0)
        if within:
            scale = torch.where(spawn_refr, alpha, torch.ones_like(alpha))
        else:
            scale = torch.where(alpha < 1.0, alpha, torch.ones_like(alpha))
        w_refr = torch.where(kr < 1.0, (1.0 - kr) * (1.0 - alpha),
                             1.0 - alpha)
        emission = local * scale[:, None] + m_amb[mi]
        emission = torch.where(hit[:, None], emission, 0.0)
        color.index_add_(0, ps, weight * emission)

        w_refl_c = torch.where(hit & (refl > 0.0), scale * refl,
                               torch.zeros_like(refl)) if within else \
            torch.zeros_like(refl)
        w_refr_c = torch.where(spawn_refr, w_refr, torch.zeros_like(w_refr))
        go_refl = w_refl_c > 0.0
        go_refr = spawn_refr & (w_refr_c > 0.0)
        alpha_zero = torch.trunc(alpha.abs() * 1e6) == 0.0
        n_refl = int(go_refl.sum())
        refr_child = torch.full((r,), -1, dtype=torch.int64, device=dev)
        refr_child[go_refr] = n_refl + torch.arange(int(go_refr.sum()),
                                                    device=dev)
        id_chain.append((own_id, hit & alpha_zero & spawn_refr, refr_child))
        if depth == n_levels or not (go_refl.any() or go_refr.any()):
            break
        exact_next = 2 * queue_len <= cap
        new_slot = [torch.where(known, slot, -1)[go_refl],
                    torch.where(known, slot + queue_len, -1)[go_refr]]
        if not exact_next:
            new_slot = [torch.full_like(s, -1) for s in new_slot]
        queue_len = min(2 * queue_len, cap)
        ro = point + sn * SHADOW_BIAS
        rd = d - 2.0 * _dot(d, sn)[:, None] * sn
        to = point + ref_n * (-SHADOW_BIAS)
        td = (d + aidn[:, None] * ref_n) * eta[:, None] \
            - ref_n * torch.sqrt(torch.clamp(k, min=0.0))[:, None]
        o = torch.cat([ro[go_refl], to[go_refr]])
        d = torch.cat([rd[go_refl], td[go_refr]])
        weight = torch.cat([weight[go_refl] * w_refl_c[go_refl][:, None],
                            weight[go_refr] * w_refr_c[go_refr][:, None]])
        ps = torch.cat([ps[go_refl], ps[go_refr]])
        slot = torch.cat(new_slot)

    # object ids: a refracted alpha≈0 surface shows its refraction's id
    resolved = id_chain[-1][0]
    for own_id, override, child in reversed(id_chain[:-1]):
        take = override & (child >= 0)
        got = torch.zeros_like(own_id)
        got[take] = resolved[child[take]]
        resolved = torch.where(take, got, own_id)

    color = color.reshape(P, S, 3).mean(1)
    color = torch.clamp(color, max=1.0)
    depth_px = depth0.reshape(P, S).mean(1)
    obj = resolved.reshape(P, S)[:, -1]
    return dict(color=color.double().cpu().numpy(),
                depth=depth_px.double().cpu().numpy(),
                object_id=obj.cpu().numpy(),
                exact=exact.reshape(P, S).all(1).cpu().numpy(),
                rays=rays.reshape(P, S).double().mean(1).cpu().numpy())
