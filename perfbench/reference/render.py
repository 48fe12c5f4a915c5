"""The reference renderer: the upstream Whitted / Monte-Carlo ray tree of
chosen pixels, in plain PyTorch at a chosen precision.

It follows upstream rustray's per-pixel recursion (``src/raytracing.rs``,
with the quirks that the program keeps: fresnel's ``cos_i = |cos_t|``,
point-light falloff over 4π·distance, the receiver's alpha in shadows,
shadow rays from the nearest hit) as a sweep over levels: each level
traces its rays against every item (spheres analytically, meshes by a
brute-force test of every triangle of each mesh whose box the ray enters),
shades them, and spawns weighted reflection and refraction children.  It
shares no code with the program.

Monte-Carlo numbers.  The program draws a ray's jitter from a threefry key
of (seed, chunk start, sample cell, level) at the ray's position in its
level's queue.  While no level has outgrown the queue, that position
follows from the pixel alone (the reflection child keeps its parent's
position, the refraction child adds the parent level's length), and the
reference draws the same numbers.  From the first level whose children
outnumber the queue's capacity, the program sorts the queue by weight over
the whole chunk; the reference cannot know those positions from a few
pixels, draws numbers of its own there, and marks the pixel inexact.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import rng
from .scene import DIRECTIONAL, SPHERE, SPOT, RefScene

SHADOW_BIAS = 1e-3
_FAR = float("inf")


def sample_pattern(samples: int, seed: int) -> np.ndarray:
    """Stratified sample cells (upstream ``src/raytracing.rs:290-313``):
    the cell_size² grid of (x_i, y_i) in x-major order, permuted by
    NumPy's PCG64 stream of ``seed`` (the program's documented deviation
    from Rust's StdRng) and cut to ``samples``."""
    cell = sample_cell_size(samples)
    grid = np.stack(np.meshgrid(np.arange(cell), np.arange(cell),
                                indexing="ij"), axis=-1).reshape(-1, 2)
    perm = np.random.Generator(np.random.PCG64(seed)).permutation(
        grid.shape[0])
    return grid[perm][:samples].astype(np.int64)


def sample_cell_size(samples: int) -> int:
    if samples <= 1:
        return 1
    return (1 << int(samples + 1).bit_length()) // 2


def frame_levels(scene: RefScene) -> int:
    """1 + max_recursion where some material can spawn a child, else 1."""
    spawns = any(m.reflectivity > 0.0 or m.alpha < 1.0
                 for m in scene.materials)
    return 1 + scene.max_recursion if spawns else 1


def _dot(a, b):
    return (a * b).sum(-1)


def _normalize(v):
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.where(n > 0, n, torch.ones_like(n))


class _Geometry:
    """The scene's items as tensors, with each mesh's triangle constants
    (the plane through the triangle and the two barycentric gradients)."""

    def __init__(self, scene: RefScene, dtype, device):
        self.scene = scene
        self.dtype, self.device = dtype, device
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,  # noqa: E731
                                      device=device)
        self.items = []
        for it in scene.items:
            mat = scene.materials[it.material]
            e = dict(item=it, mat=mat)
            if it.kind == SPHERE:
                e.update(center=t(it.center), radius=float(it.radius))
            else:
                tris = t(it.tris) + t(it.offset)
                a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
                e1, e2 = b - a, c - a
                n = torch.linalg.cross(e1, e2)
                nn = torch.clamp(_dot(n, n), min=1e-300)
                g1 = torch.linalg.cross(e2, n) / nn[:, None]
                g2 = torch.linalg.cross(n, e1) / nn[:, None]
                e.update(n=n, an=_dot(a, n), g1=g1, g2=g2,
                         c1=-_dot(a, g1), c2=-_dot(a, g2),
                         lo=tris.reshape(-1, 3).amin(0),
                         hi=tris.reshape(-1, 3).amax(0),
                         normals=None if it.normals is None else t(
                             it.normals),
                         uvs=None if it.uvs is None else t(it.uvs))
            self.items.append(e)

    def trace(self, o, d, for_shadow: bool, depth: int, block: int):
        """Nearest hit of each ray: (t (inf on a miss), item index (-1),
        face, barycentric u, v, sphere normal).  The first item in scene
        order wins a tie, as does the first triangle of a mesh."""
        r = o.shape[0]
        dev, dt = self.device, self.dtype
        best_t = torch.full((r,), _FAR, dtype=dt, device=dev)
        best_i = torch.full((r,), -1, dtype=torch.int64, device=dev)
        best_f = torch.zeros((r,), dtype=torch.int64, device=dev)
        best_u = torch.zeros((r,), dtype=dt, device=dev)
        best_v = torch.zeros((r,), dtype=dt, device=dev)
        sph_n = torch.zeros((r, 3), dtype=dt, device=dev)
        for i, e in enumerate(self.items):
            mat = e["mat"]
            if not (mat.alpha > 0.0 and (not for_shadow or mat.cast_shadow)
                    and (not mat.reflection_only or depth > 1)):
                continue
            if e["item"].kind == SPHERE:
                t, n = self._sphere(e, o, d, for_shadow)
                better = t < best_t
                best_t = torch.where(better, t, best_t)
                best_i = torch.where(better, i, best_i)
                sph_n = torch.where(better[:, None], n, sph_n)
                continue
            inv = 1.0 / d
            t0 = (e["lo"] - o) * inv
            t1 = (e["hi"] - o) * inv
            tn = torch.nan_to_num(torch.minimum(t0, t1), nan=-_FAR).amax(-1)
            tf = torch.nan_to_num(torch.maximum(t0, t1), nan=_FAR).amin(-1)
            cand = torch.nonzero((tn <= tf) & (tf >= 0) & (tn <= best_t))[:, 0]
            step = max(64, block // e["n"].shape[0])
            for s in range(0, cand.shape[0], step):
                idx = cand[s:s + step]
                t, f, u, v = self._mesh(e, o[idx], d[idx])
                better = t < best_t[idx]
                sel = idx[better]
                best_t[sel] = t[better]
                best_i[sel] = i
                best_f[sel] = f[better]
                best_u[sel] = u[better]
                best_v[sel] = v[better]
        return best_t, best_i, best_f, best_u, best_v, sph_n

    @staticmethod
    def _sphere(e, o, d, for_shadow):
        mat = e["mat"]
        solid = (not mat.alpha < 1.0 and mat.backface_culling
                 and not for_shadow)
        lo = o - e["center"]
        r = e["radius"]
        a = _dot(d, d)
        b = _dot(lo, d)
        c = _dot(lo, lo) - r * r
        miss = ((c > 0.0) & (b > 0.0)) | (b * b - a * c < 0.0)
        sq = torch.sqrt(torch.clamp(b * b - a * c, min=0.0))
        near = (-b - sq) / a
        far = (-b + sq) / a
        inside = near <= 0.0
        t = torch.where(inside, torch.zeros_like(near) if solid else far,
                        near)
        n = _normalize(lo + t[:, None] * d)
        n = torch.where(inside[:, None], -n, n)
        return torch.where(miss, _FAR, t), n

    @staticmethod
    def _mesh(e, lo, ld):
        n = e["n"]
        dn = ld @ n.T
        ok = dn.abs() > 1e-30
        t = (e["an"][None] - lo @ n.T) / torch.where(ok, dn,
                                                      torch.ones_like(dn))
        u = lo @ e["g1"].T + t * (ld @ e["g1"].T) + e["c1"][None]
        v = lo @ e["g2"].T + t * (ld @ e["g2"].T) + e["c2"][None]
        hit = ok & (t >= 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        t = torch.where(hit, t, _FAR)
        f = torch.argmin(t, dim=1)
        rows = torch.arange(t.shape[0], device=t.device)
        return t[rows, f], f, u[rows, f], v[rows, f]

    def surface(self, d, hit_point, item, face, u, v, sph_n):
        """(normal, uv) of each hit: interpolated vertex normals (flipped
        towards the ray) or the oriented face normal; barycentric UVs or the
        sphere's (u, -v) mapping."""
        dt, dev = self.dtype, self.device
        m = item.shape[0]
        normal = sph_n.clone()
        uv = torch.zeros((m, 2), dtype=dt, device=dev)
        for i, e in enumerate(self.items):
            sel = torch.nonzero(item == i)[:, 0]
            if sel.numel() == 0:
                continue
            it = e["item"]
            if it.kind == SPHERE:
                if e["mat"].texture is not None:
                    lp = hit_point[sel] - e["center"]
                    theta = torch.atan2(-lp[:, 2], lp[:, 0])
                    phi = torch.arccos(torch.clamp(-lp[:, 1] / it.radius,
                                                   -1.0, 1.0))
                    uv[sel] = torch.stack([(theta + math.pi) / (2 * math.pi),
                                           -phi / math.pi], -1)
                continue
            f = face[sel]
            fn = e["n"][f]
            back = _dot(d[sel], fn) > 0.0
            w = torch.stack([1.0 - u[sel] - v[sel], u[sel], v[sel]], -1)
            if e["mat"].smooth_shading and e["normals"] is not None:
                nrm = _normalize((w[..., None] * e["normals"][f]).sum(1))
                nrm = torch.where(back[:, None], -nrm, nrm)
            else:
                nrm = _normalize(torch.where(back[:, None], -fn, fn))
            normal[sel] = nrm
            if e["uvs"] is not None:
                q = (w[..., None] * e["uvs"][f]).sum(1)
                uv[sel] = torch.stack([q[:, 0], -q[:, 1]], -1)
        return normal, uv


def _bilinear(tex, uv):
    """The upstream bilinear fetch (``src/shape/mod.rs:542-629``): a
    negative coordinate gets one texture size added, floor and ceil are
    clamped to the edge, and the weights are taken against the clamped
    floor.  Returns RGBA in [0, 1]."""
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
        return tex[yy.long(), xx.long()]

    p0, p1, p2, p3 = at(y0, x0), at(y0, x1), at(y1, x0), at(y1, x1)
    top = p0 + xf * (p1 - p0)
    bot = p2 + xf * (p3 - p2)
    return top + yf * (bot - top)


def _jitter(direction, spread, u1, u2):
    """Cone jitter around ``direction`` with uniforms u1 (height) and u2
    (angle); a spread <= 0 or an empty cone keeps the direction."""
    b3 = _normalize(direction)
    ex = torch.zeros_like(b3)
    ex[:, 0] = 1.0
    ey = torch.zeros_like(b3)
    ey[:, 1] = 1.0
    b1 = _normalize(torch.linalg.cross(
        b3, torch.where((b3[:, 0].abs() < 0.5)[:, None], ex, ey)))
    b2 = torch.linalg.cross(b1, b3)
    z_lo = torch.cos(spread * math.pi)
    z = z_lo + (1.0 - z_lo) * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    theta = -math.pi + 2.0 * math.pi * u2
    new = _normalize((r * torch.cos(theta))[:, None] * b1
                     + (r * torch.sin(theta))[:, None] * b2
                     + z[:, None] * b3)
    keep = (spread <= 0.0) | (z_lo >= 1.0)
    return torch.where(keep[:, None], direction, new)


class _Keys:
    """The threefry keys of the program's draws, per ray: seed, chunk
    start, sample cell, level, then 17 (roughness) or 23 (shadows)."""

    def __init__(self, seed: int, device):
        self.base = rng.seed_key(seed)
        self.device = device

    def level(self, start, cell, depth: int, tag: int):
        k = rng.fold_in(self.base, start)
        k = rng.fold_in(k, cell)
        k = rng.fold_in(k, depth)
        return rng.fold_in(k, tag)

    def uniforms(self, start, cell, depth: int, tag: int, index, spare):
        """(u1, u2) per ray: elements ``2 * index`` and ``2 * index + 1``
        of the level's draw where ``index`` is known (>= 0), else numbers
        of the reference's own (``spare``: distinct counts)."""
        known = index >= 0
        k = self.level(start, cell, depth, tag)
        ks = self.level(start, cell, depth, 1_000_003 + tag)
        i = torch.where(known, index, spare)
        key = (torch.where(known, k[0], ks[0]),
               torch.where(known, k[1], ks[1]))
        return rng.uniform_at(key, i * 2), rng.uniform_at(key, i * 2 + 1)


def render_pixels(scene: RefScene, pixels, seed: int, chunk_pixels: int,
                  queue_factor: float, dtype=torch.float64, device="cpu",
                  block: int = 1 << 23):
    """Render the flat pixel indices ``pixels`` (y * width + x) of
    ``scene`` as the program renders its frame with engine ``seed``,
    ``chunk_pixels`` and ``queue_factor``.

    Returns numpy arrays per pixel: ``color`` (P, 3) averaged over the
    samples and clamped to 1, ``depth`` (P,), ``object_id`` (P,), ``exact``
    (P,) bool (every draw of the pixel is the program's), and ``rays``
    (P,): rays traced per sample of the pixel, primary, secondary and
    shadow, as the program counts its ``device_rays``."""
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
    textures = {}
    for mi, m in enumerate(mats):
        if m.nearest:
            raise ValueError("the reference samples textures bilinearly only")
        if m.texture is not None:
            textures.setdefault(id(m.texture), (t(m.texture) / 255.0, []))[
                1].append(mi)
    tex_groups = [(tex, torch.tensor(ms, device=dev))
                  for tex, ms in textures.values()]

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
    fog = 0.0

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
        if scene.monte_carlo:
            apply = hit & m_mc[mi] & (m_rough[mi] > 0.0)
            u1, u2 = keys.uniforms(st, cell, depth, 17, slot,
                                   spare + torch.arange(r, device=dev))
            spare += r
            jit = _jitter(sn, m_rough[mi], u1.to(dt), u2.to(dt))
            sn = torch.where(apply[:, None], jit, sn)

        base = torch.cat([m_base[mi], torch.ones((r, 1), dtype=dt,
                                                 device=dev)], -1)
        for tex, ms in tex_groups:
            sel = torch.nonzero(hit & torch.isin(mi, ms))[:, 0]
            if sel.numel():
                base[sel] = base[sel] * _bilinear(tex, uv[sel])
        spec = m_spec[mi]
        alpha = m_alpha[mi] * base[:, 3]
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
            lit = spec * power[:, None] + base[:, :3] * dot_l[:, None]

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
                att = torch.where(in_light, torch.ones_like(sh_t),
                                  1.0 - alpha[sel])
                inten = inten.clone()
                inten[sel] = inten[sel] * att
            local = local + t(light.color)[None] * lit * inten[:, None]

        refl = m_refl[mi]
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
        emission = (1.0 - fog) * local * scale[:, None] + m_amb[mi]
        emission = torch.where(hit[:, None], emission, 0.0)
        color.index_add_(0, ps, weight * emission)

        w_refl_c = torch.where(hit & (refl > 0.0), (1.0 - fog) * scale * refl,
                               torch.zeros_like(refl)) if within else \
            torch.zeros_like(refl)
        w_refr_c = torch.where(spawn_refr, (1.0 - fog) * w_refr,
                               torch.zeros_like(w_refr))
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
