"""The counting core of the three traversal labs (``traversal_lab``,
``octet_lab``, ``binning_lab``): the port of what ``tools/traversal_lab.py``,
``tools/octet_lab.py`` and ``tools/binning_lab.py`` each carry.

Every lab reads the ``.npz`` of ``capture_waves`` (per-level trace
batches under ``{closest,shadow}_{level}_{o,d,alive,tmax}``), loads the
bench scene as the JAX labs do (``ensure_bench_assets``, 1280x720), takes
each batch through the production preamble (coherence sort, dead rays
masked, t_max capped at the exit from the scene's bounds) and counts,
per batch, the cluster visits that a traversal design would list or need:
the interval slab test over groups of rays (:func:`group_counts`), the
exact slab entry per ray (:func:`ray_entries`) and the dense scan's best
t, the floor of any early-exit walk (:func:`dense_t`).  All of it is plain
torch on the tensors' device.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

BIG = 3.0e37
WIDTH, HEIGHT = 1280, 720


def parse_args(prog: str, doc: str, argv):
    """The labs' arguments: ``[waves.npz] [--device cuda|cpu]``."""
    from .capture_waves import DEFAULT_OUT
    ap = argparse.ArgumentParser(prog=f"python -m rustray_tpu_torch.tools."
                                 f"{prog}", description=doc.split("\n\n")[0])
    ap.add_argument("waves", nargs="?", default=DEFAULT_OUT)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(sys.argv[1:] if argv is None else argv)


def load_scene(dev):
    """The bench scene as the JAX labs load it (``ensure_bench_assets`` of
    grid 6, 52x68 spheres, 1 sample, camera at 1280x720), written to the
    port's build directory.  Returns (sa, prep, w_lo, w_hi) on ``dev``."""
    from ..build import BUILD_DIR
    from ..models import procedural
    from ..ops.cluster_trace import world_cluster_aabbs
    from ..ops.intersect import prepare_triangles
    from ..scene.scene import Scene
    from ..scene_arrays import to_torch
    json_path = procedural.ensure_bench_assets(
        os.path.join(BUILD_DIR, "bench"), grid=6, lat=52, lon=68,
        width=WIDTH, height=HEIGHT, samples=1, monte_carlo=True)
    scene = Scene()
    scene.load(json_path)
    scene.cam.init(WIDTH, HEIGHT)
    scene.init()
    scene.update()
    sa, _ = to_torch(*scene.compile(), dev)
    w_lo, w_hi = world_cluster_aabbs(sa)
    return sa, prepare_triangles(sa), w_lo, w_hi


def batches(z, sa, dev):
    """The capture's batches in the JAX labs' order (by level, closest
    before shadow), skipping those with no live ray.  Yields (name,
    n_alive, for_shadow, cl_ok, tri_ok, o, d, alive, tmax)."""
    from ..ops.traverse import instance_mask
    names = sorted({k.rsplit("_", 1)[0] for k in z.files})
    order = sorted(names, key=lambda s: (int(s.split("_")[1]),
                                         s.startswith("shadow")))
    for name in order:
        o, d, alive, tmax = (torch.as_tensor(z[f"{name}_{k}"], device=dev)
                             for k in ("o", "d", "alive", "tmax"))
        n_alive = int(alive.sum())
        if n_alive == 0:
            continue
        for_shadow = name.startswith("shadow")
        inst_ok = instance_mask(sa, for_shadow, int(name.split("_")[1]) > 1)
        cl_ok = sa.cl_valid & inst_ok[sa.cl_inst.long()]
        tri_ok = sa.tri_valid & inst_ok[sa.tri_inst.long()]
        yield name, n_alive, for_shadow, cl_ok, tri_ok, o, d, alive, tmax


def global_bounds(w_lo, w_hi, cl_ok):
    from ..ops.intersect import INF
    lo = torch.amin(torch.where(cl_ok[:, None], w_lo, INF), dim=0)
    hi = torch.amax(torch.where(cl_ok[:, None], w_hi, -INF), dim=0)
    return lo, hi


def exit_cap(o, d, alive, tmax, lo, hi):
    """Dead rays masked (``DEAD_ORIGIN``, d = 1, t_max = -1) and t_max
    capped at each ray's exit from the box (lo, hi).  Returns (o, d,
    tmax)."""
    from ..ops.block_trace import DEAD_ORIGIN
    o = torch.where(alive[:, None], o, DEAD_ORIGIN)
    d = torch.where(alive[:, None], d, 1.0)
    eps = 1e-30
    sd = torch.where(torch.abs(d) > eps, d, torch.where(d >= 0, eps, -eps))
    t0 = (lo[None] - o) / sd
    t1 = (hi[None] - o) / sd
    tn = torch.amax(torch.minimum(t0, t1), dim=1)
    tf = torch.amin(torch.maximum(t0, t1), dim=1)
    cap = torch.where(tf >= torch.clamp(tn, min=0.0), tf * 1.0001 + 1e-3,
                      -1.0)
    return o, d, torch.minimum(torch.where(alive, tmax, -1.0), cap)


def sorted_preamble(o, d, alive, tmax, w_lo, w_hi, cl_ok):
    """The production preamble: coherence sort (dead rays last), then
    :func:`exit_cap`.  Returns (o, d, alive, tmax), sorted."""
    from ..ops.block_trace import coherence_key
    lo, hi = global_bounds(w_lo, w_hi, cl_ok)
    perm = torch.argsort(coherence_key(o, d, alive, lo, hi), stable=True)
    o, d, alive, tmax = o[perm], d[perm], alive[perm], tmax[perm]
    o, d, tmax = exit_cap(o, d, alive, tmax, lo, hi)
    return o, d, alive, tmax


def group_counts(o, d, alive, tmax, cl_ok, w_lo, w_hi, block: int):
    """The interval slab test over groups of ``block`` consecutive rays
    (their alive-masked origin and direction bounds, refine 1).  Returns
    the listed clusters per group ((nb,) int32) and each listed cluster's
    entry lower bound ((nb, C), INF where not listed)."""
    from ..ops.intersect import INF
    nb = o.shape[0] // block
    o_b = o.reshape(nb, block, 3)
    d_b = d.reshape(nb, block, 3)
    a_b = alive.reshape(nb, block, 1)
    olo = torch.where(a_b, o_b, BIG).amin(dim=1)
    ohi = torch.where(a_b, o_b, -BIG).amax(dim=1)
    dlo = torch.where(a_b, d_b, BIG).amin(dim=1)
    dhi = torch.where(a_b, d_b, -BIG).amax(dim=1)
    g_alive = torch.any(a_b[..., 0], dim=1)
    g_tmax = torch.where(a_b[..., 0], tmax.reshape(nb, block),
                         -BIG).amax(dim=1)
    ax_ok = (dlo > 1e-12) | (dhi < -1e-12)
    i1 = 1.0 / torch.where(ax_ok, dlo, 1.0)
    i2 = 1.0 / torch.where(ax_ok, dhi, 1.0)
    ilo, ihi = torch.minimum(i1, i2), torch.maximum(i1, i2)

    def plane_t(sb):
        a = sb[None] - ohi[:, None]
        b = sb[None] - olo[:, None]
        c0, c1 = a * ilo[:, None], a * ihi[:, None]
        c2, c3 = b * ilo[:, None], b * ihi[:, None]
        lb = torch.minimum(torch.minimum(c0, c1), torch.minimum(c2, c3))
        ub = torch.maximum(torch.maximum(c0, c1), torch.maximum(c2, c3))
        return lb, ub

    lo_lb, lo_ub = plane_t(w_lo)
    hi_lb, hi_ub = plane_t(w_hi)
    near_lb = torch.where(ax_ok[:, None], torch.minimum(lo_lb, hi_lb), -BIG)
    far_ub = torch.where(ax_ok[:, None], torch.maximum(lo_ub, hi_ub), BIG)
    entry = torch.clamp(near_lb.amax(dim=-1), min=0.0)
    exit_ = far_ub.amin(dim=-1)
    poss = ((exit_ >= entry) & (entry <= g_tmax[:, None]) & cl_ok[None]
            & g_alive[:, None])
    return poss.sum(dim=1).to(torch.int32), torch.where(poss, entry, INF)


def batched_counts(o, d, alive, tmax, cl_ok, w_lo, w_hi, block: int,
                   rows_per_call: int = 512) -> np.ndarray:
    """:func:`group_counts`' listed counts, ``rows_per_call`` groups at a
    time, as a numpy array."""
    nb = o.shape[0] // block
    out = []
    for b0 in range(0, nb, max(1, rows_per_call)):
        sl = slice(b0 * block, min(b0 + rows_per_call, nb) * block)
        c, _ = group_counts(o[sl], d[sl], alive[sl], tmax[sl], cl_ok, w_lo,
                            w_hi, block)
        out.append(c.cpu().numpy())
    return np.concatenate(out)


def effective_pairs(o, d, alive, tmax, cl_ok, w_lo, w_hi,
                    best_t) -> np.ndarray:
    """Per ray, the clusters whose exact entry is within min(best_t,
    t_max) (with the walk's 1.0001x + 1e-3 margin): the work of a per-ray
    front-to-back walk with a perfect early exit."""
    cap = torch.minimum(best_t * 1.0001 + 1e-3, tmax)
    out = []
    for r0 in range(0, o.shape[0], 2048):
        sl = slice(r0, r0 + 2048)
        _, entry = group_counts(o[sl], d[sl], alive[sl], cap[sl], cl_ok,
                                w_lo, w_hi, 1)
        out.append((entry <= cap[sl, None]).sum(dim=1).cpu().numpy())
    return np.concatenate(out)


def ray_entries(o, d, tmax, cl_ok, w_lo, w_hi):
    """Exact slab entry of every (masked) ray into every cluster box;
    INF where the ray misses it or enters past its t_max.  (n, C) f32."""
    from ..ops.intersect import INF
    eps = 1e-30
    sd = torch.where(torch.abs(d) > eps, d, torch.where(d >= 0, eps, -eps))
    inv = 1.0 / sd
    t0 = (w_lo[None] - o[:, None]) * inv[:, None]
    t1 = (w_hi[None] - o[:, None]) * inv[:, None]
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    entry = torch.clamp(tn, min=0.0)
    ok = (tf >= entry) & (entry <= tmax[:, None]) & cl_ok[None]
    return torch.where(ok, entry, INF)


def dense_t(o, d, tri_ok, prep):
    """The dense scan's closest t per (masked) ray (tile 4096)."""
    from ..ops.intersect import closest_tri
    return closest_tri(o, d, prep, tri_ok, 4096)[0]


def need(t_best, tmax, for_shadow: bool):
    """Each lane's final need: min(best t, t_max), or in any-hit mode
    -BIG once any hit exists within t_max."""
    if for_shadow:
        return torch.where(t_best <= tmax, -BIG, tmax)
    return torch.minimum(t_best, tmax)
