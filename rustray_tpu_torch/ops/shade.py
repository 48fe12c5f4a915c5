"""Shading math: reflection, refraction, fresnel and cone jitter on tensors.

Port of ``rustray_tpu/ops/shade.py`` with the reference's quirks kept
(fresnel's ``cos_i = |cos_t|``, reflection weighted by reflectivity only).
Jitter draws from the threefry stream of :mod:`rustray_tpu_torch.rng`, so
Monte-Carlo renders use the same numbers as the JAX package.
"""
from __future__ import annotations

import math

import torch

from .. import rng
from .intersect import cross, device_const, dot, safe_normalize

SHADOW_BIAS = 1e-3
PI = math.pi


def safe_sqrt(x, eps=1e-12):
    """sqrt with a clamped argument (finite gradient at 0)."""
    return torch.sqrt(torch.clamp(x, min=eps))


def reflect(i, n):
    return i - 2.0 * dot(n, i)[..., None] * n


def create_reflection(normal, incident, point):
    origin = point + normal * SHADOW_BIAS
    direction = incident - 2.0 * dot(incident, normal)[..., None] * normal
    return origin, direction


def create_transmission(normal, incident, point, index):
    """Snell refraction.  Returns (origin, dir, valid); valid is False on
    total internal reflection (no ray is spawned)."""
    i_dot_n = dot(incident, normal)
    outside = i_dot_n < 0.0
    ref_n = torch.where(outside[..., None], normal, -normal)
    eta_i = torch.where(outside, 1.0, index)
    eta_t = torch.where(outside, index, 1.0)
    idn = torch.abs(i_dot_n)
    eta = eta_i / torch.clamp(eta_t, min=1e-30)
    k = 1.0 - eta * eta * (1.0 - idn * idn)
    valid = k >= 0.0
    origin = point + ref_n * (-SHADOW_BIAS)
    direction = (incident + idn[..., None] * ref_n) * eta[..., None] \
        - ref_n * safe_sqrt(k)[..., None]
    return origin, direction, valid


def fresnel(incident, normal, index):
    i_dot_n = dot(incident, normal)
    flip = i_dot_n > 0.0
    eta_i = torch.where(flip, index, 1.0)
    eta_t = torch.where(flip, 1.0, index)
    sin_t = eta_i / torch.clamp(eta_t, min=1e-30) * safe_sqrt(
        1.0 - i_dot_n * i_dot_n)
    tir = sin_t > 1.0
    cos_t = safe_sqrt(1.0 - sin_t * sin_t)
    cos_i = torch.abs(cos_t)
    r_s = ((eta_t * cos_i) - (eta_i * cos_t)) / torch.clamp(
        (eta_t * cos_i) + (eta_i * cos_t), min=1e-30)
    r_p = ((eta_i * cos_i) - (eta_t * cos_t)) / torch.clamp(
        (eta_i * cos_i) + (eta_t * cos_t), min=1e-30)
    kr = (r_s * r_s + r_p * r_p) / 2.0
    return torch.where(tir, 1.0, kr)


def jitter(key, direction, spread):
    """Cone jitter around ``direction``: z ~ U[cos(spread·π), 1),
    θ ~ U[-π, π), basis from the axis test |b3.x| < 0.5.  spread <= 0 or an
    empty z-range returns the direction unchanged."""
    b3 = safe_normalize(direction)
    use_x = torch.abs(b3[..., 0]) < 0.5
    ex = device_const((1.0, 0.0, 0.0), direction.device)
    ey = device_const((0.0, 1.0, 0.0), direction.device)
    diff = torch.where(use_x[..., None], ex, ey)
    b1 = safe_normalize(cross(b3, diff))
    b2 = cross(b1, b3)

    z_lo = torch.cos(spread * PI)
    u = rng.uniform(key, tuple(direction.shape[:-1]) + (2,), direction.device)
    u1 = u[..., 0]
    u2 = u[..., 1]
    z = z_lo + (1.0 - z_lo) * u1
    r = safe_sqrt(1.0 - z * z)
    theta = -PI + 2.0 * PI * u2
    x = r * torch.cos(theta)
    y = r * torch.sin(theta)
    new_dir = safe_normalize(x[..., None] * b1 + y[..., None] * b2
                             + z[..., None] * b3)

    empty = z_lo >= 1.0
    keep = (spread <= 0.0) | empty
    return torch.where(keep[..., None], direction, new_dir)


def gamma_encode(linear):
    """src/raytracing.rs:231-235."""
    return torch.pow(torch.clamp(linear, min=0.0), 1.0 / 2.2)
