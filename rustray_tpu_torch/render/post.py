"""Image-space post-processing: cavity + outline — src/post_processing.rs.

Port of ``rustray_tpu/render/post.py``, on tensors of a given device:
- cavity: curvature from 4-neighbor normal cross-differences with the
  soft-clamp (ridge 1.15 / valley 1.0), multiplying rgb by (curvature + 1)
  (src/post_processing.rs:25-95,163-169).
- outline: white where any 4-neighbor object id disagrees, weighted by the
  fraction of disagreeing neighbors (src/post_processing.rs:97-121,151-161).

Out-of-bounds texel fetches return zeros, replicating the reference's
flat-index bounds check (src/post_processing.rs:35-63) — that check wraps
horizontally at row ends (a flat y*w+x index), which is reproduced.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import PostProcessingConfig


def _fetch_flat(arr_flat, x, y, w, n):
    """Reference texel fetch: flat index y*w+x, zero when outside [0, n)."""
    idx = y * w + x
    ok = (idx >= 0) & (idx < n)
    val = arr_flat[torch.clamp(idx, 0, n - 1).long()]
    return torch.where(ok[..., None] if arr_flat.ndim == 2 else ok, val, 0)


def curvature_soft_clamp(curvature, control):
    return torch.where(curvature < 0.5 / control,
                       curvature * (1.0 - curvature * control),
                       0.25 / control)


def run_post_processing(config: PostProcessingConfig, image: np.ndarray,
                        normals: np.ndarray, depth: np.ndarray,
                        object_ids: np.ndarray, *, device) -> np.ndarray:
    """image: (H, W, 3) uint8; normals: (H, W, 3); object_ids: (H, W) int32.
    Computes on ``device``; returns the processed (H, W, 3) uint8 image."""
    h, w = image.shape[:2]
    img = torch.tensor(image, dtype=torch.float32, device=device)
    n_flat = torch.tensor(normals, dtype=torch.float32,
                          device=device).reshape(-1, 3)
    id_flat = torch.tensor(object_ids, dtype=torch.int32,
                           device=device).reshape(-1)
    n = h * w

    xs = torch.arange(w, dtype=torch.int32, device=device).expand(h, w)
    ys = torch.arange(h, dtype=torch.int32, device=device)[:, None].expand(
        h, w)

    r = img[..., 0]
    g = img[..., 1]
    b = img[..., 2]

    if config.outline:
        center = _fetch_flat(id_flat, xs, ys, w, n)
        up = _fetch_flat(id_flat, xs, ys + 1, w, n)
        down = _fetch_flat(id_flat, xs, ys - 1, w, n)
        right = _fetch_flat(id_flat, xs - 1, ys, w, n)
        left = _fetch_flat(id_flat, xs + 1, ys, w, n)
        eq = (torch.stack([up, down, right, left]) == center[None]).to(
            torch.float32)
        outline = 1.0 - torch.sum(eq * 0.25, dim=0)
        mask = outline > 0.0
        r = torch.where(mask, outline * 255.0, r)
        g = torch.where(mask, outline * 255.0, g)
        b = torch.where(mask, outline * 255.0, b)

    if config.cavity:
        ridge, valley = 1.15, 1.0
        n_up = _fetch_flat(n_flat, xs, ys + 1, w, n)
        n_down = _fetch_flat(n_flat, xs, ys - 1, w, n)
        n_left = _fetch_flat(n_flat, xs - 1, ys, w, n)
        n_right = _fetch_flat(n_flat, xs + 1, ys, w, n)
        # .xz() swizzle: x component of left/right, z component of up/down
        normal_diff = ((n_up[..., 2] - n_down[..., 2])
                       + (n_right[..., 0] - n_left[..., 0]))
        curv = torch.where(normal_diff < 0.0,
                           -2.0 * curvature_soft_clamp(-normal_diff, valley),
                           2.0 * curvature_soft_clamp(normal_diff, ridge))
        r = r * (curv + 1.0)
        g = g * (curv + 1.0)
        b = b * (curv + 1.0)

    out = torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)
    return out.cpu().numpy().astype(np.uint8)
