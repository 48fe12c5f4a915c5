"""Texture-atlas sampling from packed material rows, on tensors.

Port of ``rustray_tpu/ops/texture.py``: nearest with the reference's
truncating wrap (a floor-mod, ``torch.remainder``), bilinear with the
reference's edge-extrapolation quirks (the renderer's path goes through the
horizontal texel-pair table, the legacy ``get_tex_color`` through 4 texel
fetches), and the packed-rgba unpack.
"""
from __future__ import annotations

import torch

from .intersect import device_const

_DEFAULT_RGBA = (0.0, 0.0, 0.0, 1.0)


def _unpack(packed):
    """Packed rgba int32 → (…, 4) float in [0, 1]."""
    p = packed.to(torch.int64) & 0xFFFFFFFF
    rgba = [((p >> s) & 0xFF).to(torch.float32) for s in (0, 8, 16, 24)]
    return torch.stack(rgba, dim=-1) / 255.0


def _fetch(texels, offset, w, x, y):
    idx = offset + y * w + x
    return _unpack(texels[torch.clamp(idx, 0, texels.shape[0] - 1).long()])


def _wrap(val, bound):
    """trunc(val·bound) floor-mod bound (``%`` on ints in JAX)."""
    f = val * bound.to(torch.float32)
    w = torch.remainder(torch.trunc(f).to(torch.int32), bound)
    return torch.where(w < 0, w + bound, w)


def sample_nearest(texels, offset, w, h, u, v):
    return _fetch(texels, offset, w, _wrap(u, w), _wrap(v, h))


def _bilinear_coords(w, h, u, v):
    """The reference's bilinear texel coordinates and weights, quirks
    included: negative coords get +size once, and floor/ceil are clamped to
    the edge before the weight is taken against the clamped x0, so
    out-of-range UVs extrapolate at borders.  Returns (x0, x1, y0, y1, xf,
    yf)."""
    wf = w.to(torch.float32)
    hf = h.to(torch.float32)
    x = u * wf
    y = v * hf
    x = torch.where(x < 0.0, x + wf, x)
    y = torch.where(y < 0.0, y + hf, y)
    # floor/ceil as-u32 casts saturate at 0 for negatives (Rust ``as u32``)
    x0 = torch.clamp(torch.floor(x), min=0.0).to(torch.int32)
    x1 = torch.clamp(torch.ceil(x), min=0.0).to(torch.int32)
    y0 = torch.clamp(torch.floor(y), min=0.0).to(torch.int32)
    y1 = torch.clamp(torch.ceil(y), min=0.0).to(torch.int32)
    x0 = torch.minimum(x0, w - 1)
    x1 = torch.minimum(x1, w - 1)
    y0 = torch.minimum(y0, h - 1)
    y1 = torch.minimum(y1, h - 1)
    return x0, x1, y0, y1, x - x0.to(torch.float32), y - y0.to(torch.float32)


def _lerp2(p0, p1, p2, p3, xf, yf):
    top = p0 + xf[..., None] * (p1 - p0)
    bot = p2 + xf[..., None] * (p3 - p2)
    return top + yf[..., None] * (bot - top)


def sample_bilinear(texels, offset, w, h, u, v):
    """Bilinear fetch of 4 texels (src/shape/mod.rs:542-629)."""
    x0, x1, y0, y1, xf, yf = _bilinear_coords(w, h, u, v)
    return _lerp2(_fetch(texels, offset, w, x0, y0),
                  _fetch(texels, offset, w, x1, y0),
                  _fetch(texels, offset, w, x0, y1),
                  _fetch(texels, offset, w, x1, y1), xf, yf)


def _sample_bilinear_pairs(pairs, offset, w, h, u, v):
    """Bilinear fetch via the (NT, 2) horizontal-pair table (2 row gathers;
    identical values to :func:`sample_bilinear`)."""
    x0, x1, y0, y1, xf, yf = _bilinear_coords(w, h, u, v)
    nt = pairs.shape[0]
    r0 = pairs[torch.clamp(offset + y0 * w + x0, 0, nt - 1).long()]   # (N, 2)
    r1 = pairs[torch.clamp(offset + y1 * w + x0, 0, nt - 1).long()]
    right = (x1 > x0)[..., None]
    p0 = _unpack(r0[..., 0])
    p1 = torch.where(right, _unpack(r0[..., 1]), p0)
    p2 = _unpack(r1[..., 0])
    p3 = torch.where(right, _unpack(r1[..., 1]), p2)
    return _lerp2(p0, p1, p2, p3, xf, yf)


def get_tex_color(sa, mat_idx, tex_type: int, uv):
    """Per-ray texture fetch through the material tables (the legacy path;
    the renderer uses :func:`get_tex_color_rows`).  Returns (rgba (N, 4),
    has (N,) bool) — ``Raytracing::get_tex_color`` (src/raytracing.rs:
    651-675): nearest or bilinear per material, ``has`` False when the
    material has no texture in this slot."""
    m = mat_idx.long()
    mats = sa.materials
    offset = mats.tex_offset[m, tex_type]
    w = mats.tex_w[m, tex_type]
    h = mats.tex_h[m, tex_type]
    has = w > 0
    w_safe = torch.clamp(w, min=1)
    h_safe = torch.clamp(h, min=1)
    u, v = uv[..., 0], uv[..., 1]
    rgba = torch.where(
        (mats.tex_nearest[m] != 0)[..., None],
        sample_nearest(sa.tex_texels, offset, w_safe, h_safe, u, v),
        sample_bilinear(sa.tex_texels, offset, w_safe, h_safe, u, v))
    default = device_const(_DEFAULT_RGBA, uv.device)
    return torch.where(has[..., None], rgba, default), has


def get_tex_color_rows(sa, mat_i, tex_type: int, uv, static):
    """Texture fetch from pre-gathered packed material rows.  Returns
    (rgba (N, 4), has (N,) bool); only the filter modes some material of
    the scene uses are sampled."""
    from .traverse import MI_NEAREST, MI_TEX_H, MI_TEX_OFF, MI_TEX_W
    offset = mat_i[..., MI_TEX_OFF + tex_type]
    w = mat_i[..., MI_TEX_W + tex_type]
    h = mat_i[..., MI_TEX_H + tex_type]
    nearest = mat_i[..., MI_NEAREST]
    has = w > 0
    w_safe = torch.clamp(w, min=1)
    h_safe = torch.clamp(h, min=1)
    u, v = uv[..., 0], uv[..., 1]
    if static.any_nearest and static.any_bilinear:
        rgba_n = sample_nearest(sa.tex_texels, offset, w_safe, h_safe, u, v)
        rgba_b = _sample_bilinear_pairs(sa.tex_pairs, offset, w_safe, h_safe,
                                        u, v)
        rgba = torch.where((nearest != 0)[..., None], rgba_n, rgba_b)
    elif static.any_nearest:
        rgba = sample_nearest(sa.tex_texels, offset, w_safe, h_safe, u, v)
    else:
        rgba = _sample_bilinear_pairs(sa.tex_pairs, offset, w_safe, h_safe,
                                      u, v)
    default = device_const(_DEFAULT_RGBA, uv.device)
    return torch.where(has[..., None], rgba, default), has
