"""The differentiable reference: the gradient of a pixel-restricted MSE of
the reference's ray tree with respect to the materials' base colour,
roughness and reflectivity and the lights' colour and intensity, in plain
PyTorch (float64 unless asked, TF32 off).

It renders chosen pixels as ``render.render_pixels`` does (the same ray
tree, threefry draws and queue positions, and the same helpers of
``render.py``), with the optimised values as leaf tensors.  Traversal runs
without gradients; the winner's distance is then recomputed with autograd
from its triangle's plane, ``t = (an - o·n) / (d·n)``, and the hit point's
barycentrics from it, as the program's ``selected_t`` and
``hit_attributes`` do, so the gradient reaches the distance, the normal and
the texture lookup of every hit, and the children's directions (a rough
surface's jittered normal).  Shadow tests are 0 or 1 and carry none.
Meshes only: an analytic sphere raises.

The loss is the program's: ``Σ_p (C_p - target_p)² / (W·H·3)`` over the
given pixels, ``C_p`` the pixel's sample mean before any clamp.  Where a
level outgrows the program's queue, the reference draws numbers of its
own, as ``render_pixels`` does (on the sponza-class floor from the fourth
level on, where the ray's weight is at most 0.3³).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .render import (SHADOW_BIAS, _bilinear, _dot, _Geometry, _Keys,
                     _normalize, frame_levels, sample_cell_size,
                     sample_pattern)
from .scene import DIRECTIONAL, SPHERE, SPOT, RefScene

# the optimised leaves, (group, field), as the program's parameters name them
LEAVES = (("materials", "base_color"), ("materials", "roughness"),
          ("materials", "reflectivity"), ("lights", "color"),
          ("lights", "intensity"))


def _sqrt0(x):
    """The square root of a quantity clamped at 0, as ``render.py`` takes
    it, with the clamp at the dtype's smallest normal number instead, so
    that its derivative stays finite where the quantity is 0 (a branch
    that ``where`` then discards would otherwise carry 0 · inf = NaN)."""
    return torch.sqrt(torch.clamp(x, min=torch.finfo(x.dtype).tiny))


def _jitter(direction, spread, u1, u2):
    """``render._jitter`` with its cone's rim taken by :func:`_sqrt0`: a
    narrow cone rounds to its axis (z = 1) in bfloat16."""
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
    r = _sqrt0(1.0 - z * z)
    theta = -math.pi + 2.0 * math.pi * u2
    new = _normalize((r * torch.cos(theta))[:, None] * b1
                     + (r * torch.sin(theta))[:, None] * b2
                     + z[:, None] * b3)
    keep = (spread <= 0.0) | (z_lo >= 1.0)
    return torch.where(keep[:, None], direction, new)


class _Recompute(_Geometry):
    """The scene's triangles' plane and barycentric constants, concatenated
    over the meshes, to recompute a selected hit with autograd."""

    def __init__(self, scene: RefScene, dtype, device):
        super().__init__(scene, dtype, device)
        if any(e["item"].kind == SPHERE for e in self.items):
            raise ValueError("the gradient reference traces meshes only")
        counts = [e["n"].shape[0] for e in self.items]
        self.first = torch.tensor([0] + list(np.cumsum(counts)[:-1]),
                                  dtype=torch.int64, device=device)
        cat = lambda k: torch.cat([e[k] for e in self.items])  # noqa: E731
        self.n, self.an = cat("n"), cat("an")
        self.g1, self.c1, self.g2, self.c2 = (cat(k) for k in
                                              ("g1", "c1", "g2", "c2"))

    def hit(self, o, d, for_shadow: bool, depth: int, block: int):
        """The nearest hit as ``trace`` finds it, with t, u and v recomputed
        from the winning triangle under autograd: (t, item, face, u, v)."""
        with torch.no_grad():
            ts, item, face, _, _, _ = self.trace(o.detach(), d.detach(),
                                                 for_shadow, depth, block)
        hit = torch.isfinite(ts)
        tri = self.first[torch.clamp(item, min=0)] + face

        def row(table):
            # a miss reads zeros: its stand-in triangle may be degenerate,
            # with constants that are not numbers in bfloat16
            keep = hit.reshape((-1,) + (1,) * (table.dim() - 1))
            return torch.where(keep, table[tri], 0.0)

        n = row(self.n)
        dn = torch.where(hit, _dot(d, n), 1.0)
        t = torch.where(hit, (row(self.an) - _dot(o, n)) / dn, math.inf)
        p = o + d * torch.where(hit, t, 0.0)[:, None]
        u = _dot(p, row(self.g1)) + row(self.c1)
        v = _dot(p, row(self.g2)) + row(self.c2)
        return t, item, face, u, v


def loss_and_grad(scene: RefScene, pixels, target, seed: int,
                  chunk_pixels: int, queue_factor: float,
                  dtype=torch.float64, device="cpu", block: int = 1 << 23):
    """The loss over ``pixels`` (flat y · width + x) of ``scene`` rendered
    as the program renders its frame with engine ``seed``,
    ``chunk_pixels`` and ``queue_factor``, against ``target`` (P, 3) at
    those pixels, and its gradients.

    Returns ``color`` (P, 3): the sample mean clamped at 1, ``loss``
    (float) and ``grads``: {(group, field): array} over
    :data:`LEAVES`, one row per material of ``scene.materials`` and per
    light of ``scene.lights``."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _loss_and_grad(scene, pixels, target, seed, chunk_pixels,
                              queue_factor, dtype, torch.device(device),
                              block)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _loss_and_grad(scene, pixels, target, seed, chunk_pixels, queue_factor,
                   dt, dev, block):
    if scene.fog_density != 0.0:
        raise ValueError("the reference renders scenes without fog")
    W, H = scene.width, scene.height
    pixels = torch.as_tensor(np.asarray(pixels, np.int64), device=dev)
    n_chunk = min(chunk_pixels, W * H)
    cap = max(n_chunk, int(round(n_chunk * queue_factor)))
    cells = sample_pattern(scene.samples, seed)
    S = len(cells)
    P = pixels.shape[0]
    geo = _Recompute(scene, dt, dev)
    keys = _Keys(seed, dev)
    mats = scene.materials
    L = len(scene.lights)
    n_levels = frame_levels(scene)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt,  # noqa: E731
                                  device=dev)
    item_mat = torch.tensor([it.material for it in scene.items],
                            dtype=torch.int64, device=dev)

    def per_mat(attr):
        return t([float(getattr(m, attr)) for m in mats])

    leaves = {("materials", "base_color"): t(np.stack([m.base for m in mats])),
              ("materials", "roughness"): per_mat("roughness"),
              ("materials", "reflectivity"): per_mat("reflectivity"),
              ("lights", "color"): t(np.stack([li.color
                                               for li in scene.lights])),
              ("lights", "intensity"): t([li.intensity
                                          for li in scene.lights])}
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    m_base = leaves[("materials", "base_color")]
    m_rough = leaves[("materials", "roughness")]
    m_refl = leaves[("materials", "reflectivity")]
    l_color = leaves[("lights", "color")]
    l_int = leaves[("lights", "intensity")]
    m_spec = t(np.stack([m.specular for m in mats]))
    m_amb = t(np.stack([m.ambient for m in mats]))
    m_alpha, m_shin = per_mat("alpha"), per_mat("shininess")
    m_ior, m_soft = per_mat("refraction_index"), per_mat("shadow_softness")
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
    spare = 0
    fog = 0.0

    for depth in range(1, n_levels + 1):
        r = o.shape[0]
        d = _normalize(d)
        ts, item, face, bu, bv = geo.hit(o, d, False, depth, block)
        hit = torch.isfinite(ts)
        t_safe = torch.where(hit, ts, torch.zeros_like(ts))
        mi = item_mat[torch.clamp(item, min=0)]
        point = o + d * t_safe[:, None]
        normal, uv = geo.surface(d, point, item, face, bu, bv,
                                 torch.zeros_like(d))
        cell = ps_cell[ps]
        st = start[ps]
        known = slot >= 0

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
                base = base.index_put((sel,), base[sel] * _bilinear(tex,
                                                                    uv[sel]))
        spec = m_spec[mi]
        alpha = m_alpha[mi] * base[:, 3]
        view_dir = _normalize(-d)
        local = torch.zeros((r, 3), dtype=dt, device=dev)
        for li_idx, light in enumerate(scene.lights):
            if not light.enabled:
                continue
            if light.kind == DIRECTIONAL:
                dtl = _normalize(-t(light.dir))[None].expand(r, 3)
                dist = None
                inten = l_int[li_idx].expand(r)
            else:
                to_l = t(light.pos)[None] - point
                dist = torch.linalg.vector_norm(to_l, dim=-1)
                dtl = _normalize(to_l)
                inten = l_int[li_idx] / (4.0 * math.pi
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
                with torch.no_grad():
                    so = point[sel] + sn[sel] * SHADOW_BIAS
                    sd = dtl[sel]
                    if scene.monte_carlo:
                        s_slot = slot[sel]
                        u1, u2 = keys.uniforms(
                            st[sel], cell[sel], depth, 23,
                            torch.where(s_slot >= 0, s_slot * L + li_idx, -1),
                            spare + torch.arange(sel.numel(), device=dev))
                        spare += sel.numel()
                        jit = _jitter(sd, m_soft[mi[sel]], u1.to(dt),
                                      u2.to(dt))
                        sd = torch.where(m_mc[mi[sel]][:, None], jit, sd)
                    sd = _normalize(sd)
                    sh_t = geo.trace(so, sd, True, depth, block)[0]
                    in_light = ~torch.isfinite(sh_t)
                    if dist is not None:
                        in_light = in_light | (torch.isfinite(sh_t)
                                               & (sh_t > dist[sel]))
                att = torch.where(in_light, torch.ones_like(sh_t),
                                  1.0 - alpha[sel])
                inten = inten.index_put((sel,), inten[sel] * att)
            local = local + l_color[li_idx][None] * lit * inten[:, None]

        refl = m_refl[mi]
        ior = m_ior[mi]
        local = local * (1.0 - refl[:, None])
        # fresnel, with upstream's cos_i = |cos_t|
        idn = _dot(d, sn)
        flip = idn > 0.0
        eta_i = torch.where(flip, ior, torch.ones_like(ior))
        eta_t = torch.where(flip, torch.ones_like(ior), ior)
        sin_t = eta_i / eta_t * _sqrt0(1.0 - idn * idn)
        cos_t = _sqrt0(1.0 - sin_t * sin_t)
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
        color = color.index_add(0, ps, weight * emission)

        w_refl_c = torch.where(hit & (refl > 0.0), (1.0 - fog) * scale * refl,
                               torch.zeros_like(refl)) if within else \
            torch.zeros_like(refl)
        w_refr_c = torch.where(spawn_refr, (1.0 - fog) * w_refr,
                               torch.zeros_like(w_refr))
        go_refl = w_refl_c > 0.0
        go_refr = spawn_refr & (w_refr_c > 0.0)
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
            - ref_n * _sqrt0(k)[:, None]
        o = torch.cat([ro[go_refl], to[go_refr]])
        d = torch.cat([rd[go_refl], td[go_refr]])
        weight = torch.cat([weight[go_refl] * w_refl_c[go_refl][:, None],
                            weight[go_refr] * w_refr_c[go_refr][:, None]])
        ps = torch.cat([ps[go_refl], ps[go_refr]])
        slot = torch.cat(new_slot)

    mean = color.reshape(P, S, 3).mean(1)
    tgt = torch.as_tensor(np.asarray(target), dtype=dt, device=dev)
    loss = ((mean - tgt) ** 2).sum() / (W * H * 3)
    got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {k: (torch.zeros_like(v) if g is None else g).double().cpu()
             .numpy() for (k, v), g in zip(leaves.items(), got)}
    return dict(color=torch.clamp(mean.detach(), max=1.0).double().cpu()
                .numpy(), loss=float(loss.detach()), grads=grads)
