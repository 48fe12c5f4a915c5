"""Camera ray generation (AA + DOF) on tensors.

Port of ``rustray_tpu/ops/rays.py``: sensor coordinates, the uncentered AA
translation (recentred only under DOF with samples > 1) and the DOF focal
point along the center ray, with the JAX package's operation order.
"""
from __future__ import annotations

import torch

from .intersect import device_const

CAM_CLIPPING_PLANE_DIST = 1.0
APERTURE_BASE_RESOLUTION = 800.0


def _mat4_point(m, v3):
    """m @ [v3, 1] → (…, 4)."""
    return (v3[..., 0:1] * m[:, 0] + v3[..., 1:2] * m[:, 1]
            + v3[..., 2:3] * m[:, 2] + m[:, 3])


def _mat4_vec(m, v4):
    """v4 @ m.T as elementwise products (full f32, no TF32 matmul)."""
    return torch.sum(v4[..., None, :] * m, dim=-1)


def _homog(v3, w: float):
    return torch.cat([v3[..., :3], torch.full_like(v3[..., :1], w)], dim=-1)


def _cell_f32(i):
    """A sample-cell index as a float32 factor: an int, or a 0-dim integer
    tensor on the rays' device (a graph input); the same value either way."""
    if isinstance(i, torch.Tensor):
        return i.to(torch.float32)
    return float(i)


def primary_rays(cam, width, height, px, py, x_i, y_i, cell_size,
                 aperture_size, focal_length, samples):
    """One AA sample's rays for pixel coords (px, py) (N,) int32; x_i/y_i
    are integer sample-cell indices, ints or 0-dim integer tensors on the
    rays' device.  Returns (origin (N,3), dir (N,3) unnormalized).  Every
    constant is made on the device, so the rays can be captured in a CUDA
    graph; 0-dim tensors keep the divisions true divisions (a divisor that
    is a Python scalar becomes a multiplication by its reciprocal on
    CUDA)."""
    dev = px.device
    w = torch.full((), float(width), device=dev)
    h = torch.full((), float(height), device=dev)
    x_f = px.to(torch.float32)
    y_f = py.to(torch.float32)
    x_step = 2.0 / w
    y_step = 2.0 / h

    dof = (aperture_size > 1.0) and (focal_length > 1.0)

    inv_cell = torch.full((), 1.0 / float(cell_size), device=dev)
    x_trans = x_step * _cell_f32(x_i) * inv_cell
    y_trans = y_step * _cell_f32(y_i) * inv_cell
    if dof and samples > 1:
        x_trans = x_trans - x_step / 2.0
        y_trans = y_trans - y_step / 2.0

    proj_inv = cam.proj_inv
    view_inv = cam.view_inv
    eye = device_const((0.0, 0.0, 0.0, 1.0), dev)

    if dof:
        aperture_scale = w / APERTURE_BASE_RESOLUTION
        x_trans = x_trans * float(aperture_size) * aperture_scale
        y_trans = y_trans * float(aperture_size) * aperture_scale

        center_x = ((x_f + 0.5) / w) * 2.0 - 1.0
        center_y = 1.0 - ((y_f + 0.5) / h) * 2.0
        cpp = _mat4_point(proj_inv, torch.stack(
            [center_x, center_y,
             torch.full_like(center_x, -CAM_CLIPPING_PLANE_DIST)], -1))
        cpp = _homog(cpp, 1.0)
        ray_dir_view = _homog(cpp - eye, 0.0)
        origin = _mat4_vec(view_inv, eye)
        dirw = _mat4_vec(view_inv, ray_dir_view)
        dirw = dirw / torch.linalg.norm(dirw[..., :3], dim=-1, keepdim=True)
        dist = torch.linalg.norm(ray_dir_view[..., :3], dim=-1)

        scale = CAM_CLIPPING_PLANE_DIST / (
            dist / (dist + float(focal_length)))
        p = origin + scale[..., None] * dirw

        sx = (((x_f + 0.5) / w) * 2.0 - 1.0) + x_trans
        sy = (1.0 - ((y_f + 0.5) / h) * 2.0) + y_trans
        pp = _mat4_point(proj_inv, torch.stack(
            [sx, sy, torch.full_like(sx, -CAM_CLIPPING_PLANE_DIST)], -1))
        pp = _homog(pp, 1.0)
        ray_origin = _mat4_vec(view_inv, pp)
        ray_dir = p - ray_origin
        return ray_origin[..., :3], ray_dir[..., :3]

    sx = (((x_f + 0.5) / w) * 2.0 - 1.0) + x_trans
    sy = (1.0 - ((y_f + 0.5) / h) * 2.0) + y_trans
    pp = _mat4_point(proj_inv, torch.stack(
        [sx, sy, torch.full_like(sx, -CAM_CLIPPING_PLANE_DIST)], -1))
    pp = _homog(pp, 1.0)
    ray_dir = _homog(pp - eye, 0.0)
    origin = _mat4_vec(view_inv, pp)
    dirw = _mat4_vec(view_inv, ray_dir)
    return origin[..., :3], dirw[..., :3]


def pick_ray(cam, width, height, x, y):
    """Single center ray for picking — src/raytracing.rs:237-262."""
    dev = cam.view_inv.device
    px = torch.tensor([x], dtype=torch.int32, device=dev)
    py = torch.tensor([y], dtype=torch.int32, device=dev)
    return primary_rays(cam, width, height, px, py, 0, 0, 1, 1.0, 1.0, 1)
