"""CPU reference oracle: a direct NumPy re-implementation of the reference
renderer's recursive per-pixel algorithm (src/raytracing.rs:275-998).

This module intentionally shares *no* device code with the wavefront
renderer: intersections run in object space (inverse-transformed rays, like
src/shape/{sphere,mesh}.rs), shading recurses, textures are fetched with an
independent sampler.  Tests assert allclose between this oracle and the TPU
wavefront engine, validating the recursion→wavefront and object→world-space
transformations.

The oracle mirrors the reference's behavioral quirks (SURVEY.md §2.1) and the
framework's two documented deviations: shadow rays use the nearest hit, and
shadow alpha textures are sampled with the *occluder's* UVs.
"""
from __future__ import annotations

import numpy as np

from .config import RaytracingConfig
from .scene.material import Material, TextureType
from .scene.scene import Scene
from .scene.shapes import Mesh, Shape, Sphere
from .utils.mathutil import sample_cell_size, sample_pattern

SHADOW_BIAS = 1e-3


def _norm(v):
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


class _Hit:
    __slots__ = ("t", "normal", "item", "face_id")

    def __init__(self, t, normal, item, face_id):
        self.t = t
        self.normal = normal
        self.item = item
        self.face_id = face_id


def _tex_fetch(tex: np.ndarray, x: int, y: int) -> np.ndarray:
    return tex[y, x].astype(np.float64) / 255.0


def _wrap(val: float, bound: int) -> int:
    w = int(np.trunc(val * bound)) % bound
    return w + bound if w < 0 else w


def _sample_bilinear(tex: np.ndarray, u: float, v: float) -> np.ndarray:
    h, w = tex.shape[:2]
    x = u * w
    y = v * h
    if x < 0:
        x += w
    if y < 0:
        y += h
    x0 = min(max(int(np.floor(x)), 0), w - 1)
    x1 = min(max(int(np.ceil(x)), 0), w - 1)
    y0 = min(max(int(np.floor(y)), 0), h - 1)
    y1 = min(max(int(np.ceil(y)), 0), h - 1)
    xf = x - x0
    yf = y - y0
    p0 = _tex_fetch(tex, x0, y0)
    p1 = _tex_fetch(tex, x1, y0)
    p2 = _tex_fetch(tex, x0, y1)
    p3 = _tex_fetch(tex, x1, y1)
    top = p0 + xf * (p1 - p0)
    bot = p2 + xf * (p3 - p2)
    return top + yf * (bot - top)


class Oracle:
    def __init__(self, scene: Scene, width: int, height: int,
                 config: RaytracingConfig = None, seed: int = 0):
        self.scene = scene
        self.config = config or scene.raytracing_config
        scene.cam.init(width, height)
        self.cam = scene.cam
        self.width = width
        self.height = height
        self.rng = np.random.Generator(np.random.PCG64(seed))

    # ----- texture helpers (src/raytracing.rs:629-712) -----

    def get_tex_color(self, mat: Material, uv, tex_type: TextureType):
        if uv is None or not mat.has_texture(tex_type):
            return None
        tex = mat.get_texture(tex_type)
        if mat.texture_filtering_nearest:
            h, w = tex.shape[:2]
            return _tex_fetch(tex, _wrap(uv[0], w), _wrap(uv[1], h))
        return _sample_bilinear(tex, uv[0], uv[1])

    def get_item_color(self, mat: Material, uv, which: str):
        if which == "ambient":
            col, tt = mat.ambient_color, TextureType.AmbientEmissive
        elif which == "base":
            col, tt = mat.base_color, TextureType.Base
        else:
            col, tt = mat.specular_color, TextureType.Specular
        out = np.array([col[0], col[1], col[2], 1.0], np.float64)
        tex = self.get_tex_color(mat, uv, tt)
        if tex is not None:
            out *= tex
        return out

    # ----- intersection (object space, like the reference) -----

    def _intersect_sphere(self, item: Sphere, o, d, force_not_solid):
        inv = item.basic.trans_inverse.astype(np.float64)
        lo = inv[:3, :3] @ o + inv[:3, 3]
        ld = inv[:3, :3] @ d
        mat = item.get_material()
        solid = (not (mat.alpha < 1.0 or mat.has_texture(TextureType.Alpha))
                 and mat.backface_culling and not force_not_solid)
        r = item.radius
        a = ld @ ld
        b = lo @ ld
        c = lo @ lo - r * r
        if c > 0.0 and b > 0.0:
            return None
        delta = b * b - a * c
        if delta < 0.0:
            return None
        sq = np.sqrt(delta)
        t = (-b - sq) / a
        inside = False
        if t <= 0.0:
            inside = True
            t = 0.0 if solid else (-b + sq) / a
        lp = lo + t * ld
        n_local = _norm(lp)
        if inside:
            n_local = -n_local
        trans = item.basic.trans.astype(np.float64)
        n = _norm(trans[:3, :3] @ n_local)
        if item.basic.flip_normals:
            n = -n
        return _Hit(t, n, item, 0)

    def _intersect_mesh(self, item: Mesh, o, d, force_not_solid):
        inv = item.basic.trans_inverse.astype(np.float64)
        lo = inv[:3, :3] @ o + inv[:3, 3]
        ld = inv[:3, :3] @ d
        verts = item.vertices.astype(np.float64)
        tris = item.indices
        a = verts[tris[:, 0]]
        e1 = verts[tris[:, 1]] - a
        e2 = verts[tris[:, 2]] - a
        n = np.cross(e1, e2)
        dn = n @ ld
        ok = np.abs(dn) > 1e-30
        t = np.where(ok, np.einsum("ij,ij->i", a - lo, n) / np.where(ok, dn, 1.0), np.inf)
        p = lo + t[:, None] * ld
        ap = p - a
        # barycentric via projection constants
        nn = np.maximum(np.einsum("ij,ij->i", n, n), 1e-300)
        u = np.einsum("ij,ij->i", np.cross(ap, e2), n) / nn
        v = np.einsum("ij,ij->i", np.cross(e1, ap), n) / nn
        hit = ok & (t >= 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        t = np.where(hit, t, np.inf)
        if not np.any(np.isfinite(t)):
            return None
        fi = int(np.argmin(t))
        ti = float(t[fi])
        backface = dn[fi] > 0.0
        mat = item.get_material()
        trans = item.basic.trans.astype(np.float64)
        if (mat.smooth_shading and item.normals.shape[0] > 0
                and item.normal_indices.shape[0] > 0):
            ni = item.normal_indices[fi]
            w0 = 1.0 - u[fi] - v[fi]
            n_interp = (w0 * item.normals[ni[0]] + u[fi] * item.normals[ni[1]]
                        + v[fi] * item.normals[ni[2]]).astype(np.float64)
            normal = _norm(trans[:3, :3] @ n_interp)
            if backface:
                normal = -normal
        else:
            oriented = n[fi] if not backface else -n[fi]
            normal = _norm(trans[:3, :3] @ _norm(oriented))
        if item.basic.flip_normals:
            normal = -normal
        return _Hit(ti, normal, item, fi)

    def _get_uv(self, item: Shape, hit_point, face_id):
        inv = item.basic.trans_inverse.astype(np.float64)
        lp = inv[:3, :3] @ hit_point + inv[:3, 3]
        if isinstance(item, Sphere):
            theta = np.arctan2(-lp[2], lp[0])
            u = (theta + np.pi) / (2 * np.pi)
            phi = np.arccos(np.clip(-lp[1] / item.radius, -1.0, 1.0))
            v = phi / np.pi
            return np.array([u, -v])
        assert isinstance(item, Mesh)
        if item.uv_indices.shape[0] <= face_id or item.indices.shape[0] <= face_id:
            return np.array([0.0, 0.0])
        tri = item.indices[face_id]
        uvf = item.uv_indices[face_id]
        a = item.vertices[tri[0]].astype(np.float64)
        b = item.vertices[tri[1]].astype(np.float64)
        c = item.vertices[tri[2]].astype(np.float64)
        f1, f2, f3 = a - lp, b - lp, c - lp
        area = np.linalg.norm(np.cross(a - b, a - c))
        a1 = np.linalg.norm(np.cross(f2, f3)) / area
        a2 = np.linalg.norm(np.cross(f3, f1)) / area
        a3 = np.linalg.norm(np.cross(f1, f2)) / area
        uv = (item.uvs[uvf[0]] * a1 + item.uvs[uvf[1]] * a2 + item.uvs[uvf[2]] * a3)
        return np.array([uv[0], -uv[1]])

    def trace(self, o, d, stop_on_first_hit, for_shadow, depth):
        """Nearest-hit search with the reference's candidate filter
        (src/raytracing.rs:429-490; nearest-hit deviation for shadows)."""
        best = None
        for item in self.scene.items:
            mat = item.get_material()
            if not (item.basic.visible and mat.alpha > 0.0
                    and (not for_shadow or mat.cast_shadow)
                    and (not mat.reflection_only or depth > 1)):
                continue
            if isinstance(item, Sphere):
                h = self._intersect_sphere(item, o, d, for_shadow)
            else:
                h = self._intersect_mesh(item, o, d, for_shadow)
            if h is not None and (best is None or h.t < best.t):
                best = h
        return best

    # ----- recursive shading (src/raytracing.rs:720-998) -----

    def jitter(self, direction, spread):
        if spread <= 0.0:
            return direction
        b3 = _norm(direction)
        diff = np.array([1.0, 0.0, 0.0]) if abs(b3[0]) < 0.5 else np.array([0.0, 1.0, 0.0])
        b1 = _norm(np.cross(b3, diff))
        b2 = np.cross(b1, b3)
        z_lo = np.cos(spread * np.pi)
        if z_lo >= 1.0:
            return direction
        z = self.rng.uniform(z_lo, 1.0)
        r = np.sqrt(max(1.0 - z * z, 0.0))
        theta = self.rng.uniform(-np.pi, np.pi)
        return _norm(r * np.cos(theta) * b1 + r * np.sin(theta) * b2 + z * b3)

    def fresnel(self, incident, normal, index):
        i_dot_n = incident @ normal
        eta_i, eta_t = 1.0, index
        if i_dot_n > 0.0:
            eta_i, eta_t = index, 1.0
        sin_t = eta_i / eta_t * np.sqrt(max(1.0 - i_dot_n * i_dot_n, 0.0))
        if sin_t > 1.0:
            return 1.0
        cos_t = np.sqrt(max(1.0 - sin_t * sin_t, 0.0))
        cos_i = abs(cos_t)  # reference quirk (src/raytracing.rs:558)
        r_s = ((eta_t * cos_i) - (eta_i * cos_t)) / ((eta_t * cos_i) + (eta_i * cos_t))
        r_p = ((eta_i * cos_i) - (eta_t * cos_t)) / ((eta_i * cos_i) + (eta_t * cos_t))
        return (r_s * r_s + r_p * r_p) / 2.0

    def get_color(self, o, d, depth):
        d = _norm(d)
        hit = self.trace(o, d, False, False, depth)
        color = np.zeros(3)
        out_depth, out_normal, out_id = 0.0, np.zeros(3), 0
        if hit is None:
            return color, out_depth, out_normal, out_id
        cfg = self.config
        item = hit.item
        mat = item.get_material()
        out_depth = hit.t
        out_normal = hit.normal.copy()
        out_id = item.basic.id
        hit_point = o + d * hit.t
        surface_normal = hit.normal

        uv = None
        if mat.has_any_texture():
            uv = self._get_uv(item, hit_point, hit.face_id)

        # normal mapping
        ntex = self.get_tex_color(mat, uv, TextureType.Normal)
        if ntex is not None:
            tangent = np.cross(surface_normal, np.array([0.0, 1.0, 0.0]))
            if np.linalg.norm(tangent) <= 1e-4:
                tangent = np.cross(surface_normal, np.array([0.0, 0.0, 1.0]))
            tangent = _norm(tangent)
            bitangent = _norm(np.cross(surface_normal, tangent))
            nm = ntex[:3] * 2.0 - 1.0
            nm[0] *= mat.normal_map_strength
            nm[1] *= mat.normal_map_strength
            nm = _norm(nm)
            surface_normal = _norm(nm[0] * tangent + nm[1] * bitangent
                                   + nm[2] * surface_normal)

        rtex = self.get_tex_color(mat, uv, TextureType.Roughness)
        if cfg.monte_carlo and mat.monte_carlo and (mat.roughness > 0.0 or rtex is not None):
            rough = mat.roughness
            if rtex is not None:
                rough = (1.0 / np.pi / 2.0) * rtex[0]
            surface_normal = self.jitter(surface_normal, rough)

        ambient_color = self.get_item_color(mat, uv, "ambient")
        base_color = self.get_item_color(mat, uv, "base")
        specular_color = self.get_item_color(mat, uv, "specular")

        alpha = mat.alpha * base_color[3]
        atex = self.get_tex_color(mat, uv, TextureType.Alpha)
        if atex is not None:
            alpha *= atex[0]

        for light in self.scene.lights:
            if not light.enabled:
                continue
            lt = int(light.light_type)
            if lt == 0:  # directional
                dtl = _norm(-light.dir.astype(np.float64))
            else:
                dtl = _norm(light.pos.astype(np.float64) - hit_point)
            dot_light = max(surface_normal @ dtl, 0.0)
            base = base_color * dot_light
            reflect_dir = -dtl - 2.0 * (surface_normal @ -dtl) * surface_normal
            view_dir = _norm(-d)
            spec_dot = max(reflect_dir @ view_dir, 0.0)
            light_power = spec_dot ** mat.shininess
            specular = specular_color * light_power

            if lt == 0:
                intensity = light.intensity
            else:
                r2 = np.linalg.norm(light.pos.astype(np.float64) - hit_point)
                intensity = light.intensity / (4.0 * np.pi * r2)
                if lt == 2:
                    ldir = _norm(light.dir.astype(np.float64))
                    ang = np.arccos(np.clip(-dtl @ ldir, -1.0, 1.0))
                    if ang > light.max_angle:
                        intensity = 0.0

            if mat.receive_shadow:
                so = hit_point + surface_normal * SHADOW_BIAS
                sd = dtl
                if cfg.monte_carlo and mat.monte_carlo:
                    sd = self.jitter(sd, mat.shadow_softness)
                sh = self.trace(so, _norm(sd), True, True, depth)
                in_light = sh is None
                if not in_light and lt in (1, 2):
                    in_light = sh.t > np.linalg.norm(light.pos.astype(np.float64) - hit_point)
                if not in_light:
                    shadow_alpha = mat.alpha
                    occ_mat = sh.item.get_material()
                    if occ_mat.has_any_texture():
                        occ_uv = self._get_uv(sh.item, so + _norm(sd) * sh.t, sh.face_id)
                        occ_tex = self.get_tex_color(occ_mat, occ_uv, TextureType.Alpha)
                        if occ_tex is not None:
                            shadow_alpha *= occ_tex[0]
                    intensity *= (1.0 - shadow_alpha)

            color += light.color.astype(np.float64) * (specular[:3] + base[:3]) * intensity

        refraction_index = mat.refraction_index
        kr = self.fresnel(d, surface_normal, refraction_index)

        reflectivity = mat.reflectivity
        reft = self.get_tex_color(mat, uv, TextureType.Reflectivity)
        if reft is not None:
            reflectivity = reft[0]

        color = color * (1.0 - reflectivity)

        if reflectivity > 0.0 and depth <= cfg.max_recursion:
            ro = hit_point + surface_normal * SHADOW_BIAS
            rd = d - 2.0 * (d @ surface_normal) * surface_normal
            refl_color = self.get_color(ro, rd, depth + 1)[0]
            color = color + refl_color * reflectivity

        if alpha < 1.0 and depth <= cfg.max_recursion:
            # create_transmission (src/raytracing.rs:500-533)
            ref_n = surface_normal
            eta_t, eta_i = refraction_index, 1.0
            i_dot_n = d @ surface_normal
            if i_dot_n < 0.0:
                i_dot_n = -i_dot_n
            else:
                ref_n = -surface_normal
                eta_t, eta_i = 1.0, refraction_index
            eta = eta_i / eta_t
            k = 1.0 - eta * eta * (1.0 - i_dot_n * i_dot_n)
            if k >= 0.0:
                to = hit_point + ref_n * (-SHADOW_BIAS)
                td = (d + i_dot_n * ref_n) * eta - ref_n * np.sqrt(k)
                tres = self.get_color(to, td, depth + 1)
                refr_color = tres[0]
                if kr < 1.0:
                    color = color * alpha + refr_color * (1.0 - kr) * (1.0 - alpha)
                else:
                    color = color * alpha + refr_color * (1.0 - alpha)
                if np.trunc(abs(alpha) * 1e6) == 0.0:
                    out_id = tres[3]
        elif alpha < 1.0:
            color = color * alpha

        fog_amount = min(cfg.fog_density * hit.t, 1.0)
        color = (1.0 - fog_amount) * color + np.asarray(cfg.fog_color) * fog_amount

        ao = self.get_tex_color(mat, uv, TextureType.AmbientOcclusion)
        if ao is not None:
            color = color * ao[0]

        color = color + ambient_color[:3]
        return color, out_depth, out_normal, out_id

    # ----- per-pixel render (src/raytracing.rs:275-427) -----

    def render_pixel(self, x, y):
        cfg = self.config
        cam = self.cam
        w, h = float(self.width), float(self.height)
        x_f, y_f = float(x), float(y)
        x_step, y_step = 2.0 / w, 2.0 / h
        cells = sample_pattern(cfg.samples)
        cell_size = sample_cell_size(cfg.samples)
        dof = cfg.aperture_size > 1.0 and cfg.focal_length > 1.0

        color = np.zeros(3)
        depth = 0.0
        normal = np.zeros(3)
        obj = 0
        pi = cam.projection_inverse.astype(np.float64)
        vi = cam.view_inverse.astype(np.float64)
        for (x_i, y_i) in cells:
            x_t = x_step * x_i * (1.0 / cell_size)
            y_t = y_step * y_i * (1.0 / cell_size)
            if dof and cfg.samples > 1:
                x_t -= x_step / 2.0
                y_t -= y_step / 2.0
            if dof:
                ap_scale = w / 800.0
                x_t *= cfg.aperture_size * ap_scale
                y_t *= cfg.aperture_size * ap_scale
                cx = ((x_f + 0.5) / w) * 2.0 - 1.0
                cy = 1.0 - ((y_f + 0.5) / h) * 2.0
                cpp = pi @ np.array([cx, cy, -1.0, 1.0])
                cpp[3] = 1.0
                rdv = cpp - np.array([0.0, 0.0, 0.0, 1.0])
                rdv[3] = 0.0
                origin = vi @ np.array([0.0, 0.0, 0.0, 1.0])
                dirw = vi @ rdv
                dirw = dirw / np.linalg.norm(dirw)
                dist = np.linalg.norm(rdv[:3])
                p = origin + (1.0 / (dist / (dist + cfg.focal_length))) * dirw
                sx = (((x_f + 0.5) / w) * 2.0 - 1.0) + x_t
                sy = (1.0 - ((y_f + 0.5) / h) * 2.0) + y_t
                pp = pi @ np.array([sx, sy, -1.0, 1.0])
                pp[3] = 1.0
                ro = vi @ pp
                rd = p - ro
                o, d = ro[:3], rd[:3]
            else:
                sx = (((x_f + 0.5) / w) * 2.0 - 1.0) + x_t
                sy = (1.0 - ((y_f + 0.5) / h) * 2.0) + y_t
                pp = pi @ np.array([sx, sy, -1.0, 1.0])
                pp[3] = 1.0
                rdv = pp - np.array([0.0, 0.0, 0.0, 1.0])
                rdv[3] = 0.0
                o = (vi @ pp)[:3]
                d = (vi @ rdv)[:3]
            c, dep, nrm, oid = self.get_color(o, d, 1)
            color += c
            depth += dep
            normal += nrm
            obj = oid
        n = len(cells)
        color /= n
        depth /= n
        normal /= n
        color = np.minimum(color, 1.0)
        return color, depth, normal, obj

    def render_image_scalar(self):
        """Reference implementation: the original per-pixel recursive loop
        (kept verbatim — test_oracle_batched_matches_scalar pins the fast
        batched path against it)."""
        cfg = self.config
        H, W = self.height, self.width
        color = np.zeros((H, W, 3))
        depth = np.zeros((H, W))
        normal = np.zeros((H, W, 3))
        obj = np.zeros((H, W), np.int32)
        for y in range(H):
            for x in range(W):
                c, dep, nrm, oid = self.render_pixel(x, y)
                color[y, x] = c
                depth[y, x] = dep
                nl = np.linalg.norm(nrm)
                normal[y, x] = nrm / nl if nl > 0 else 0.0
                obj[y, x] = oid
        if cfg.gamma_correction:
            quant = np.power(np.maximum(color, 0.0), 1.0 / 2.2)
        else:
            quant = color
        image = np.trunc(quant * 255.0).astype(np.uint8)
        return dict(color=color, image=image, depth=depth, normal=normal,
                    object_id=obj)

    def _primary_rays_batch(self, cell):
        """(W*H, 3) origins/directions for one AA/MC sample cell —
        the vectorized twin of render_pixel's ray setup."""
        cfg = self.config
        W, H = self.width, self.height
        w, h = float(W), float(H)
        x_step, y_step = 2.0 / w, 2.0 / h
        cell_size = sample_cell_size(cfg.samples)
        dof = cfg.aperture_size > 1.0 and cfg.focal_length > 1.0
        pi = self.cam.projection_inverse.astype(np.float64)
        vi = self.cam.view_inverse.astype(np.float64)
        xs, ys = np.meshgrid(np.arange(W, dtype=np.float64),
                             np.arange(H, dtype=np.float64))
        xs, ys = xs.reshape(-1), ys.reshape(-1)
        x_t = x_step * cell[0] * (1.0 / cell_size)
        y_t = y_step * cell[1] * (1.0 / cell_size)
        if dof and cfg.samples > 1:
            x_t -= x_step / 2.0
            y_t -= y_step / 2.0
        if dof:
            ap_scale = w / 800.0
            x_t *= cfg.aperture_size * ap_scale
            y_t *= cfg.aperture_size * ap_scale
            cx = ((xs + 0.5) / w) * 2.0 - 1.0
            cy = 1.0 - ((ys + 0.5) / h) * 2.0
            cpp = np.stack([cx, cy, np.full_like(cx, -1.0),
                            np.ones_like(cx)], 1) @ pi.T
            cpp[:, 3] = 1.0
            rdv = cpp - np.array([0.0, 0.0, 0.0, 1.0])
            rdv[:, 3] = 0.0
            origin = vi @ np.array([0.0, 0.0, 0.0, 1.0])
            dirw = rdv @ vi.T
            dirw = dirw / np.linalg.norm(dirw, axis=1, keepdims=True)
            dist = np.linalg.norm(rdv[:, :3], axis=1)
            p = origin[None] + (1.0 / (dist / (dist + cfg.focal_length))
                                )[:, None] * dirw
            sx = cx + x_t
            sy = cy + y_t
            pp = np.stack([sx, sy, np.full_like(sx, -1.0),
                           np.ones_like(sx)], 1) @ pi.T
            pp[:, 3] = 1.0
            ro = pp @ vi.T
            rd = p - ro
            return ro[:, :3], rd[:, :3]
        sx = (((xs + 0.5) / w) * 2.0 - 1.0) + x_t
        sy = (1.0 - ((ys + 0.5) / h) * 2.0) + y_t
        pp = np.stack([sx, sy, np.full_like(sx, -1.0),
                       np.ones_like(sx)], 1) @ pi.T
        pp[:, 3] = 1.0
        rdv = pp - np.array([0.0, 0.0, 0.0, 1.0])
        rdv[:, 3] = 0.0
        o = (pp @ vi.T)[:, :3]
        d = (rdv @ vi.T)[:, :3]
        return o, d

    def render_image(self):
        """Batched render: one get_color_batch sweep per sample cell
        (same sampling pattern, accumulation and quantization as the
        scalar path; ~10-50x faster on suite-size scenes)."""
        cfg = self.config
        H, W = self.height, self.width
        cells = sample_pattern(cfg.samples)
        color = np.zeros((H * W, 3))
        depth = np.zeros(H * W)
        normal = np.zeros((H * W, 3))
        obj = np.zeros(H * W, np.int64)
        for cell in cells:
            o, d = self._primary_rays_batch(cell)
            c, dep, nrm, oid = self.get_color_batch(o, d, 1)
            color += c
            depth += dep
            normal += nrm
            obj = oid                       # last sample wins
        n = len(cells)
        color /= n
        depth /= n
        normal /= n
        color = np.minimum(color, 1.0)
        nl = np.linalg.norm(normal, axis=1, keepdims=True)
        normal = np.where(nl > 0, normal / np.where(nl > 0, nl, 1.0), 0.0)
        if cfg.gamma_correction:
            quant = np.power(np.maximum(color, 0.0), 1.0 / 2.2)
        else:
            quant = color
        image = np.trunc(quant * 255.0).astype(np.uint8)
        return dict(color=color.reshape(H, W, 3),
                    image=image.reshape(H, W, 3),
                    depth=depth.reshape(H, W),
                    normal=normal.reshape(H, W, 3),
                    object_id=obj.reshape(H, W).astype(np.int32))

    # ------------------------------------------------------------------
    # Batched evaluation (VERDICT r4 #5): identical algorithm vectorized
    # over rays with NumPy — the pixel/sample loops of render_image were
    # ~10x the suite wall-clock.  Recursion over depth is kept (reflect /
    # refract recurse on index-compacted sub-batches); per-item and
    # per-light loops are kept (small); only the per-ray math is batched.
    # test_oracle_batched_matches_scalar pins batched == scalar exactly
    # on deterministic scenes (MC jitter draws its randoms in a different
    # order, so MC parity remains statistical).
    # ------------------------------------------------------------------

    def _tex_batch(self, mat: Material, uv, tex_type: TextureType):
        """(M, 4-or-3) texture fetch for M rays, or None."""
        if uv is None or not mat.has_texture(tex_type):
            return None
        tex = mat.get_texture(tex_type)
        h, w = tex.shape[:2]
        if mat.texture_filtering_nearest:
            x = (np.trunc(uv[:, 0] * w).astype(np.int64)) % w
            y = (np.trunc(uv[:, 1] * h).astype(np.int64)) % h
            x = np.where(x < 0, x + w, x)
            y = np.where(y < 0, y + h, y)
            return tex[y, x].astype(np.float64) / 255.0
        x = uv[:, 0] * w
        y = uv[:, 1] * h
        x = np.where(x < 0, x + w, x)
        y = np.where(y < 0, y + h, y)
        x0 = np.clip(np.floor(x).astype(np.int64), 0, w - 1)
        x1 = np.clip(np.ceil(x).astype(np.int64), 0, w - 1)
        y0 = np.clip(np.floor(y).astype(np.int64), 0, h - 1)
        y1 = np.clip(np.ceil(y).astype(np.int64), 0, h - 1)
        xf = (x - x0)[:, None]
        yf = (y - y0)[:, None]
        p0 = tex[y0, x0].astype(np.float64) / 255.0
        p1 = tex[y0, x1].astype(np.float64) / 255.0
        p2 = tex[y1, x0].astype(np.float64) / 255.0
        p3 = tex[y1, x1].astype(np.float64) / 255.0
        top = p0 + xf * (p1 - p0)
        bot = p2 + xf * (p3 - p2)
        return top + yf * (bot - top)

    def _item_color_batch(self, mat, uv, which):
        if which == "ambient":
            col, tt = mat.ambient_color, TextureType.AmbientEmissive
        elif which == "base":
            col, tt = mat.base_color, TextureType.Base
        else:
            col, tt = mat.specular_color, TextureType.Specular
        m = uv.shape[0] if uv is not None else 0
        out = np.tile(np.array([col[0], col[1], col[2], 1.0], np.float64),
                      (m, 1))
        tex = self._tex_batch(mat, uv, tt)
        if tex is not None:
            out *= tex
        return out

    def _jitter_batch(self, dirs, spread):
        """Per-ray hemisphere-cap jitter; spread (M,) — rows with
        spread<=0 or a degenerate cap pass through unchanged."""
        m = dirs.shape[0]
        ln = np.linalg.norm(dirs, axis=1, keepdims=True)
        b3 = dirs / np.where(ln > 0, ln, 1.0)
        diff = np.where(np.abs(b3[:, 0:1]) < 0.5,
                        np.array([[1.0, 0.0, 0.0]]),
                        np.array([[0.0, 1.0, 0.0]]))
        b1 = np.cross(b3, diff)
        l1 = np.linalg.norm(b1, axis=1, keepdims=True)
        b1 = b1 / np.where(l1 > 0, l1, 1.0)
        b2 = np.cross(b1, b3)
        z_lo = np.cos(spread * np.pi)
        z = z_lo + (1.0 - z_lo) * self.rng.uniform(size=m)
        r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
        theta = self.rng.uniform(-np.pi, np.pi, size=m)
        out = (r * np.cos(theta))[:, None] * b1 \
            + (r * np.sin(theta))[:, None] * b2 + z[:, None] * b3
        lo = np.linalg.norm(out, axis=1, keepdims=True)
        out = out / np.where(lo > 0, lo, 1.0)
        keep = (spread <= 0.0) | (z_lo >= 1.0)
        return np.where(keep[:, None], dirs, out)

    def _intersect_sphere_batch(self, item, o, d, force_not_solid):
        inv = item.basic.trans_inverse.astype(np.float64)
        lo = o @ inv[:3, :3].T + inv[:3, 3]
        ld = d @ inv[:3, :3].T
        mat = item.get_material()
        solid = (not (mat.alpha < 1.0 or mat.has_texture(TextureType.Alpha))
                 and mat.backface_culling and not force_not_solid)
        r = item.radius
        a = np.einsum("ij,ij->i", ld, ld)
        b = np.einsum("ij,ij->i", lo, ld)
        c = np.einsum("ij,ij->i", lo, lo) - r * r
        miss1 = (c > 0.0) & (b > 0.0)
        delta = b * b - a * c
        miss2 = delta < 0.0
        sq = np.sqrt(np.maximum(delta, 0.0))
        near = (-b - sq) / a
        far = (-b + sq) / a
        inside = near <= 0.0
        # scalar semantics exactly: inside & solid -> t=0; inside & !solid
        # -> far root (no extra positivity check — the scalar path has
        # none); outside -> near root
        t = np.where(inside, 0.0 if solid else 1.0, 1.0) * np.where(
            inside, 0.0 if solid else far, near)
        lp = lo + t[:, None] * ld
        nl = np.linalg.norm(lp, axis=1, keepdims=True)
        n_local = lp / np.where(nl > 0, nl, 1.0)
        n_local = np.where(inside[:, None], -n_local, n_local)
        trans = item.basic.trans.astype(np.float64)
        n = n_local @ trans[:3, :3].T
        ln2 = np.linalg.norm(n, axis=1, keepdims=True)
        n = n / np.where(ln2 > 0, ln2, 1.0)
        if item.basic.flip_normals:
            n = -n
        ok = ~(miss1 | miss2)
        t = np.where(ok, t, np.inf)
        return t, n, np.zeros(t.shape, np.int64)

    def _intersect_mesh_batch(self, item, o, d, force_not_solid,
                              chunk=2048):
        inv = item.basic.trans_inverse.astype(np.float64)
        lo_all = o @ inv[:3, :3].T + inv[:3, 3]
        ld_all = d @ inv[:3, :3].T
        verts = item.vertices.astype(np.float64)
        tris = item.indices
        a = verts[tris[:, 0]]
        e1 = verts[tris[:, 1]] - a
        e2 = verts[tris[:, 2]] - a
        n = np.cross(e1, e2)
        nn = np.maximum(np.einsum("ij,ij->i", n, n), 1e-300)
        an = np.einsum("ij,ij->i", a, n)
        g1 = np.cross(e2, n) / nn[:, None]
        g2 = np.cross(n, e1) / nn[:, None]
        c1 = -np.einsum("ij,ij->i", a, g1)
        c2 = -np.einsum("ij,ij->i", a, g2)
        m = o.shape[0]
        best_t = np.full(m, np.inf)
        best_f = np.zeros(m, np.int64)
        best_u = np.zeros(m)
        best_v = np.zeros(m)
        for r0 in range(0, m, chunk):
            r1 = min(r0 + chunk, m)
            lo = lo_all[r0:r1]
            ld = ld_all[r0:r1]
            dn = ld @ n.T                                    # (m, T)
            ok = np.abs(dn) > 1e-30
            t = np.where(ok, (an[None] - lo @ n.T)
                         / np.where(ok, dn, 1.0), np.inf)
            px = lo[:, None, :] + t[..., None] * ld[:, None, :]
            u = np.einsum("mtj,tj->mt", px, g1) + c1[None]
            v = np.einsum("mtj,tj->mt", px, g2) + c2[None]
            hit = ok & (t >= 0.0) & (u >= 0.0) & (v >= 0.0) \
                & (u + v <= 1.0)
            t = np.where(hit, t, np.inf)
            fi = np.argmin(t, axis=1)
            rows = np.arange(r1 - r0)
            best_t[r0:r1] = t[rows, fi]
            best_f[r0:r1] = fi
            best_u[r0:r1] = u[rows, fi]
            best_v[r0:r1] = v[rows, fi]
        okm = np.isfinite(best_t)
        dn_best = np.einsum("mj,mj->m", ld_all, n[best_f])
        backface = dn_best > 0.0
        mat = item.get_material()
        trans = item.basic.trans.astype(np.float64)
        if (mat.smooth_shading and item.normals.shape[0] > 0
                and item.normal_indices.shape[0] > 0):
            ni = item.normal_indices[best_f]
            w0 = 1.0 - best_u - best_v
            n_i = (w0[:, None] * item.normals[ni[:, 0]]
                   + best_u[:, None] * item.normals[ni[:, 1]]
                   + best_v[:, None] * item.normals[ni[:, 2]]
                   ).astype(np.float64)
            normal = n_i @ trans[:3, :3].T
            ln2 = np.linalg.norm(normal, axis=1, keepdims=True)
            normal = normal / np.where(ln2 > 0, ln2, 1.0)
            normal = np.where(backface[:, None], -normal, normal)
        else:
            oriented = np.where(backface[:, None], -n[best_f], n[best_f])
            lo_n = np.linalg.norm(oriented, axis=1, keepdims=True)
            oriented = oriented / np.where(lo_n > 0, lo_n, 1.0)
            normal = oriented @ trans[:3, :3].T
            ln2 = np.linalg.norm(normal, axis=1, keepdims=True)
            normal = normal / np.where(ln2 > 0, ln2, 1.0)
        if item.basic.flip_normals:
            normal = -normal
        best_t = np.where(okm, best_t, np.inf)
        return best_t, normal, best_f

    def trace_batch(self, o, d, for_shadow, depth):
        """Vectorized nearest-hit search; same candidate filter and tie
        rule (first item in scene order wins strict-< ties) as trace()."""
        m = o.shape[0]
        best_t = np.full(m, np.inf)
        best_n = np.zeros((m, 3))
        best_i = np.full(m, -1, np.int64)
        best_f = np.zeros(m, np.int64)
        for i, item in enumerate(self.scene.items):
            mat = item.get_material()
            if not (item.basic.visible and mat.alpha > 0.0
                    and (not for_shadow or mat.cast_shadow)
                    and (not mat.reflection_only or depth > 1)):
                continue
            if isinstance(item, Sphere):
                t, n, f = self._intersect_sphere_batch(item, o, d,
                                                       for_shadow)
            else:
                t, n, f = self._intersect_mesh_batch(item, o, d, for_shadow)
            better = t < best_t
            best_t = np.where(better, t, best_t)
            best_n = np.where(better[:, None], n, best_n)
            best_i = np.where(better, i, best_i)
            best_f = np.where(better, f, best_f)
        return best_t, best_n, best_i, best_f

    def _get_uv_batch(self, item, hit_point, face_id):
        inv = item.basic.trans_inverse.astype(np.float64)
        lp = hit_point @ inv[:3, :3].T + inv[:3, 3]
        if isinstance(item, Sphere):
            theta = np.arctan2(-lp[:, 2], lp[:, 0])
            u = (theta + np.pi) / (2 * np.pi)
            phi = np.arccos(np.clip(-lp[:, 1] / item.radius, -1.0, 1.0))
            v = phi / np.pi
            return np.stack([u, -v], axis=1)
        valid = (face_id < item.uv_indices.shape[0]) \
            & (face_id < item.indices.shape[0])
        f = np.where(valid, face_id, 0)
        tri = item.indices[f]
        uvf = item.uv_indices[f] if item.uv_indices.shape[0] else tri * 0
        a = item.vertices[tri[:, 0]].astype(np.float64)
        b = item.vertices[tri[:, 1]].astype(np.float64)
        c = item.vertices[tri[:, 2]].astype(np.float64)
        f1, f2, f3 = a - lp, b - lp, c - lp
        area = np.linalg.norm(np.cross(a - b, a - c), axis=1)
        area = np.where(area > 0, area, 1.0)
        a1 = np.linalg.norm(np.cross(f2, f3), axis=1) / area
        a2 = np.linalg.norm(np.cross(f3, f1), axis=1) / area
        a3 = np.linalg.norm(np.cross(f1, f2), axis=1) / area
        uv = (item.uvs[uvf[:, 0]] * a1[:, None]
              + item.uvs[uvf[:, 1]] * a2[:, None]
              + item.uvs[uvf[:, 2]] * a3[:, None])
        out = np.stack([uv[:, 0], -uv[:, 1]], axis=1)
        return np.where(valid[:, None], out, 0.0)

    def _fresnel_batch(self, incident, normal, index):
        i_dot_n = np.einsum("ij,ij->i", incident, normal)
        flip = i_dot_n > 0.0
        eta_i = np.where(flip, index, 1.0)
        eta_t = np.where(flip, 1.0, index)
        sin_t = eta_i / eta_t * np.sqrt(np.maximum(1.0 - i_dot_n ** 2, 0.0))
        tir = sin_t > 1.0
        cos_t = np.sqrt(np.maximum(1.0 - sin_t ** 2, 0.0))
        cos_i = np.abs(cos_t)  # reference quirk (src/raytracing.rs:558)
        r_s = ((eta_t * cos_i) - (eta_i * cos_t)) \
            / np.maximum((eta_t * cos_i) + (eta_i * cos_t), 1e-300)
        r_p = ((eta_i * cos_i) - (eta_t * cos_t)) \
            / np.maximum((eta_i * cos_i) + (eta_t * cos_t), 1e-300)
        return np.where(tir, 1.0, (r_s ** 2 + r_p ** 2) / 2.0)

    def get_color_batch(self, o, d, depth):
        """Vectorized get_color: (M,3)x2 rays -> (color (M,3), depth (M,),
        normal (M,3), id (M,))."""
        cfg = self.config
        m = o.shape[0]
        ln = np.linalg.norm(d, axis=1, keepdims=True)
        d = d / np.where(ln > 0, ln, 1.0)
        t, normal, item_idx, face_id = self.trace_batch(o, d, False, depth)
        hitm = np.isfinite(t)
        color = np.zeros((m, 3))
        out_depth = np.where(hitm, t, 0.0)
        out_normal = np.where(hitm[:, None], normal, 0.0)
        out_id = np.zeros(m, np.int64)
        if not hitm.any():
            return color, out_depth, out_normal, out_id
        t_safe = np.where(hitm, t, 0.0)
        hit_point = o + d * t_safe[:, None]
        surface_normal = normal.copy()

        # per-ray material scalars/colors resolved per item
        uv = np.zeros((m, 2))
        has_uv = np.zeros(m, bool)
        alpha = np.ones(m)
        shininess = np.ones(m)
        reflectivity = np.zeros(m)
        refraction_index = np.ones(m)
        receive_shadow = np.zeros(m, bool)
        ambient_color = np.zeros((m, 4))
        base_color = np.zeros((m, 4))
        specular_color = np.zeros((m, 4))
        ao_mult = np.ones(m)
        for i, item in enumerate(self.scene.items):
            sel = hitm & (item_idx == i)
            if not sel.any():
                continue
            idx = np.nonzero(sel)[0]
            mat = item.get_material()
            out_id[idx] = item.basic.id
            uvi = None
            if mat.has_any_texture():
                uvi = self._get_uv_batch(item, hit_point[idx],
                                         face_id[idx])
                uv[idx] = uvi
                has_uv[idx] = True
            # normal mapping
            ntex = self._tex_batch(mat, uvi, TextureType.Normal)
            if ntex is not None:
                sn = surface_normal[idx]
                tangent = np.cross(sn, np.array([0.0, 1.0, 0.0]))
                tl = np.linalg.norm(tangent, axis=1)
                alt = np.cross(sn, np.array([0.0, 0.0, 1.0]))
                tangent = np.where((tl <= 1e-4)[:, None], alt, tangent)
                tl2 = np.linalg.norm(tangent, axis=1, keepdims=True)
                tangent = tangent / np.where(tl2 > 0, tl2, 1.0)
                bi = np.cross(sn, tangent)
                bl = np.linalg.norm(bi, axis=1, keepdims=True)
                bi = bi / np.where(bl > 0, bl, 1.0)
                nm = ntex[:, :3] * 2.0 - 1.0
                nm[:, 0] *= mat.normal_map_strength
                nm[:, 1] *= mat.normal_map_strength
                nl2 = np.linalg.norm(nm, axis=1, keepdims=True)
                nm = nm / np.where(nl2 > 0, nl2, 1.0)
                mapped = (nm[:, 0:1] * tangent + nm[:, 1:2] * bi
                          + nm[:, 2:3] * sn)
                ml = np.linalg.norm(mapped, axis=1, keepdims=True)
                surface_normal[idx] = mapped / np.where(ml > 0, ml, 1.0)
            # roughness MC jitter
            rtex = self._tex_batch(mat, uvi, TextureType.Roughness)
            if cfg.monte_carlo and mat.monte_carlo and (
                    mat.roughness > 0.0 or rtex is not None):
                rough = np.full(idx.size, mat.roughness)
                if rtex is not None:
                    rough = (1.0 / np.pi / 2.0) * rtex[:, 0]
                surface_normal[idx] = self._jitter_batch(
                    surface_normal[idx], rough)
            ambient_color[idx] = self._item_color_batch(mat, uvi, "ambient") \
                if uvi is not None else np.array(
                    [*mat.ambient_color[:3], 1.0])
            base_color[idx] = self._item_color_batch(mat, uvi, "base") \
                if uvi is not None else np.array([*mat.base_color[:3], 1.0])
            specular_color[idx] = self._item_color_batch(mat, uvi, "spec") \
                if uvi is not None else np.array(
                    [*mat.specular_color[:3], 1.0])
            al = mat.alpha * base_color[idx, 3]
            atex = self._tex_batch(mat, uvi, TextureType.Alpha)
            if atex is not None:
                al = al * atex[:, 0]
            alpha[idx] = al
            shininess[idx] = mat.shininess
            refl = np.full(idx.size, mat.reflectivity)
            reft = self._tex_batch(mat, uvi, TextureType.Reflectivity)
            if reft is not None:
                refl = reft[:, 0]
            reflectivity[idx] = refl
            refraction_index[idx] = mat.refraction_index
            receive_shadow[idx] = mat.receive_shadow
            ao = self._tex_batch(mat, uvi, TextureType.AmbientOcclusion)
            if ao is not None:
                ao_mult[idx] = ao[:, 0]

        # ---- lights ----
        for light in self.scene.lights:
            if not light.enabled:
                continue
            lt = int(light.light_type)
            lpos = light.pos.astype(np.float64)
            if lt == 0:
                dtl = np.tile(_norm(-light.dir.astype(np.float64)), (m, 1))
            else:
                v = lpos[None] - hit_point
                vl = np.linalg.norm(v, axis=1, keepdims=True)
                dtl = v / np.where(vl > 0, vl, 1.0)
            dot_light = np.maximum(
                np.einsum("ij,ij->i", surface_normal, dtl), 0.0)
            base = base_color * dot_light[:, None]
            rdir = -dtl - 2.0 * np.einsum(
                "ij,ij->i", surface_normal, -dtl)[:, None] * surface_normal
            vl2 = np.linalg.norm(d, axis=1, keepdims=True)
            view_dir = -d / np.where(vl2 > 0, vl2, 1.0)
            spec_dot = np.maximum(
                np.einsum("ij,ij->i", rdir, view_dir), 0.0)
            light_power = spec_dot ** shininess
            specular = specular_color * light_power[:, None]
            if lt == 0:
                intensity = np.full(m, light.intensity)
            else:
                r2 = np.linalg.norm(lpos[None] - hit_point, axis=1)
                intensity = light.intensity / (4.0 * np.pi
                                               * np.maximum(r2, 1e-300))
                if lt == 2:
                    ldir = _norm(light.dir.astype(np.float64))
                    ang = np.arccos(np.clip(-dtl @ ldir, -1.0, 1.0))
                    intensity = np.where(ang > light.max_angle, 0.0,
                                         intensity)
            shadow_sel = hitm & receive_shadow
            if shadow_sel.any():
                idx = np.nonzero(shadow_sel)[0]
                so = hit_point[idx] + surface_normal[idx] * SHADOW_BIAS
                sd = dtl[idx]
                if cfg.monte_carlo:
                    soft = np.zeros(idx.size)
                    mc = np.zeros(idx.size, bool)
                    for i, item in enumerate(self.scene.items):
                        s2 = item_idx[idx] == i
                        if s2.any():
                            mt = item.get_material()
                            soft[s2] = mt.shadow_softness
                            mc[s2] = mt.monte_carlo
                    jit = self._jitter_batch(sd, soft)
                    sd = np.where(mc[:, None], jit, sd)
                sl = np.linalg.norm(sd, axis=1, keepdims=True)
                sd = sd / np.where(sl > 0, sl, 1.0)
                sh_t, _, sh_item, sh_face = self.trace_batch(so, sd, True,
                                                             depth)
                in_light = ~np.isfinite(sh_t)
                if lt in (1, 2):
                    ld2 = np.linalg.norm(lpos[None] - hit_point[idx],
                                         axis=1)
                    in_light |= np.isfinite(sh_t) & (sh_t > ld2)
                shadowed = ~in_light
                if shadowed.any():
                    shadow_alpha = alpha[idx].copy()
                    for i, item in enumerate(self.scene.items):
                        occ = shadowed & (sh_item == i)
                        if not occ.any():
                            continue
                        occ_mat = item.get_material()
                        if occ_mat.has_any_texture():
                            oidx = np.nonzero(occ)[0]
                            ouv = self._get_uv_batch(
                                item,
                                so[oidx] + sd[oidx] * sh_t[oidx, None],
                                sh_face[oidx])
                            otex = self._tex_batch(occ_mat, ouv,
                                                   TextureType.Alpha)
                            if otex is not None:
                                shadow_alpha[oidx] *= otex[:, 0]
                    att = np.where(shadowed, 1.0 - shadow_alpha, 1.0)
                    full = np.ones(m)
                    full[idx] = att
                    intensity = intensity * full
            color += light.color.astype(np.float64)[None] \
                * (specular[:, :3] + base[:, :3]) * intensity[:, None]

        kr = self._fresnel_batch(d, surface_normal, refraction_index)
        color = color * (1.0 - reflectivity[:, None])

        within = depth <= cfg.max_recursion
        refl_sel = hitm & (reflectivity > 0.0) & within
        if refl_sel.any():
            idx = np.nonzero(refl_sel)[0]
            ro = hit_point[idx] + surface_normal[idx] * SHADOW_BIAS
            rd = d[idx] - 2.0 * np.einsum(
                "ij,ij->i", d[idx], surface_normal[idx])[:, None] \
                * surface_normal[idx]
            refl_color = self.get_color_batch(ro, rd, depth + 1)[0]
            color[idx] += refl_color * reflectivity[idx, None]

        trans_sel = hitm & (alpha < 1.0)
        if trans_sel.any() and within:
            i_dot_n = np.einsum("ij,ij->i", d, surface_normal)
            outside = i_dot_n < 0.0
            ref_n = np.where(outside[:, None], surface_normal,
                             -surface_normal)
            idn = np.abs(i_dot_n)
            eta = np.where(outside, 1.0 / refraction_index,
                           refraction_index)
            k = 1.0 - eta * eta * (1.0 - idn * idn)
            go = trans_sel & (k >= 0.0)
            if go.any():
                idx = np.nonzero(go)[0]
                to = hit_point[idx] + ref_n[idx] * (-SHADOW_BIAS)
                td = (d[idx] + idn[idx, None] * ref_n[idx]) \
                    * eta[idx, None] - ref_n[idx] \
                    * np.sqrt(k[idx])[:, None]
                tcol, _, _, tid = self.get_color_batch(to, td, depth + 1)
                blend = np.where(kr[idx] < 1.0,
                                 (1.0 - kr[idx]) * (1.0 - alpha[idx]),
                                 1.0 - alpha[idx])
                color[idx] = color[idx] * alpha[idx, None] \
                    + tcol * blend[:, None]
                zero_a = np.trunc(np.abs(alpha[idx]) * 1e6) == 0.0
                out_id[idx[zero_a]] = tid[zero_a]
        elif trans_sel.any():
            color = np.where(trans_sel[:, None], color * alpha[:, None],
                             color)

        fog_amount = np.minimum(cfg.fog_density * t_safe, 1.0)
        color = (1.0 - fog_amount[:, None]) * color \
            + np.asarray(cfg.fog_color)[None] * fog_amount[:, None]
        color = color * ao_mult[:, None]
        color = color + ambient_color[:, :3]
        color = np.where(hitm[:, None], color, 0.0)
        return color, out_depth, out_normal, out_id
