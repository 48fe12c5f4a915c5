"""Block-coherent cluster traversal without a kernel: the XLA cluster walk.

Port of ``rustray_tpu/ops/cluster_trace.py``.  Rays are processed in blocks
of ``block``; every block is slab-tested against all cluster AABBs at once,
its surviving clusters are sorted front to back and visited in rounds of
``gather`` clusters, each round one dense intersection of the whole block
against the gathered ``gather × K`` triangles.  A block stops once every
ray's best hit precedes the next round's entry distance.

The JAX package runs the rounds as a ``lax.while_loop`` per block under
``vmap``, so every block stops at its own round.  Here the blocks of a group
are batched and the rounds loop on the host while any block is still
active; a block whose loop condition failed is frozen, never given another
round (a later round could still move a winner through f32 slop at box
faces).  Groups bound the (blocks, rays, clusters) temporaries on the card.

Traversal is selection only: inputs are detached, and callers route the
winner's t through ops/traverse.selected_t, whose backward is the analytic
VJP (or, without a shade pack, recompute it with :func:`recompute_t`).
"""
from __future__ import annotations

import torch

from .intersect import INF, TrianglePrep, dot, transform_point

# the 8 corners of a box as (lo, hi) selectors per axis
_CORNERS = ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
            (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))
# elements of the largest per-group temporary (blocks × rays × max(3·C,
# gather·K)): 2^26 f32 is 256 MB, so a group's temporaries stay within a
# few GB on the card
_GROUP_ELEMS = 1 << 26


def world_cluster_aabbs(sa):
    """Per-frame world-space cluster AABBs: the 8 corners of each
    object-space leaf box transformed by its owner instance matrix
    (conservative under affine maps).  Returns (lo (C, 3), hi (C, 3))."""
    lo, hi = sa.cl_lo.detach(), sa.cl_hi.detach()
    m = sa.inst_trans[sa.cl_inst.long()].detach()          # (C, 4, 4)
    sel = torch.tensor(_CORNERS, dtype=torch.float32, device=lo.device)
    corners = lo[:, None, :] * (1.0 - sel)[None] + hi[:, None, :] * sel[None]
    wc = transform_point(m[:, None], corners)              # (C, 8, 3)
    return wc.amin(dim=1), wc.amax(dim=1)


def _slab_test(o, d, w_lo, w_hi, cl_ok):
    """Rays (..., B, 3) vs boxes (C, 3).  Returns (hit, t_enter, t_exit),
    each (..., B, C)."""
    eps = 1e-30
    safe_d = torch.where(torch.abs(d) > eps, d,
                         torch.where(d >= 0, eps, -eps))
    inv = 1.0 / safe_d                                    # (..., B, 3)
    t0 = (w_lo - o[..., None, :]) * inv[..., None, :]     # (..., B, C, 3)
    t1 = (w_hi - o[..., None, :]) * inv[..., None, :]
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (tf >= torch.clamp(tn, min=0.0)) & cl_ok
    return hit, tn, tf


def _intersect_gathered(o, d, tmax, an, n0, n1, n2, g10, g11, g12, c1,
                        g20, g21, g22, c2, ok):
    """Rays (..., B, 3) × a gathered slab of G triangles (component arrays
    (..., G)), elementwise in the JAX package's operation order.  ``tmax``
    (..., B) caps accepted hits.  Returns (best_t (..., B), best_arg
    (..., B) int64 index into the G slab, the first on ties)."""
    ox, oy, oz = o[..., 0:1], o[..., 1:2], o[..., 2:3]
    dx, dy, dz = d[..., 0:1], d[..., 1:2], d[..., 2:3]

    def row(x):
        return x[..., None, :]

    d_n = dx * row(n0) + dy * row(n1) + dz * row(n2)      # (..., B, G)
    o_n = ox * row(n0) + oy * row(n1) + oz * row(n2)
    denom_ok = torch.abs(d_n) > 1e-30
    t = (row(an) - o_n) / torch.where(denom_ok, d_n, 1.0)
    u = (ox + t * dx) * row(g10) + (oy + t * dy) * row(g11) \
        + (oz + t * dz) * row(g12) + row(c1)
    v = (ox + t * dx) * row(g20) + (oy + t * dy) * row(g21) \
        + (oz + t * dz) * row(g22) + row(c2)
    hit = (denom_ok & (t >= 0.0) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0) & row(ok) & (t <= tmax[..., None]))
    t = torch.where(hit, t, INF)
    return torch.amin(t, dim=-1), torch.argmin(t, dim=-1)


def _walk_group(o, d, tmax, comps, tri_ok, w_lo, w_hi, cl_ok, K: int,
                M: int):
    """The rounds of ``select_closest_clusters`` for a group of blocks:
    o, d (G, B, 3), tmax (G, B).  Returns (best_t, best_i int64), (G, B)."""
    dev = o.device
    C = w_lo.shape[0]
    T = tri_ok.shape[0]
    G, B = tmax.shape
    hit, tn, tf = _slab_test(o, d, w_lo, w_hi, cl_ok)
    hit = hit & (tn <= tmax[..., None])
    any_hit = hit.any(dim=1)                                    # (G, C)
    enter = torch.amin(torch.where(hit, torch.clamp(tn, min=0.0), INF),
                       dim=1)
    key = torch.where(any_hit, enter, INF)
    order = torch.argsort(key, dim=1, stable=True)              # front-to-back
    sorted_key = torch.gather(key, 1, order)
    m = any_hit.sum(dim=1)                                      # (G,)
    # farthest distance at which each ray can still be resolved: its
    # current best, capped by the last box exit it overlaps at all and by
    # its t_max (shadow rays stop at the light)
    ray_cap = torch.minimum(torch.amax(torch.where(hit, tf, -INF), dim=2),
                            tmax)                               # (G, B)
    del hit, tn, tf
    n_rounds = -(-C // M)
    lane = torch.arange(M, device=dev)
    tri_lane = torch.arange(K, device=dev)

    best_t = torch.full((G, B), INF, device=dev)
    best_i = torch.zeros((G, B), dtype=torch.int64, device=dev)
    # a block that meets no box has no live entry in any round: its result
    # is (INF, 0) whether or not its rounds run, so they are skipped
    active = m > 0
    for r in range(n_rounds):
        if n_rounds > 1:
            # the while-loop's cond, evaluated per block; a block whose cond
            # failed stays frozen
            need = torch.amax(torch.minimum(best_t, ray_cap), dim=1)
            nxt = min(r * M, C - 1)
            active = active & (r * M < m) & (sorted_key[:, nxt] <= need)
        if not bool(active.any()):
            break
        a = torch.nonzero(active).squeeze(1)
        ranks = r * M + lane                                    # (M,)
        cids = order[a][:, torch.clamp(ranks, max=C - 1)]       # (A, M)
        live = ranks[None] < m[a][:, None]
        idx = (cids[..., None] * K + tri_lane).reshape(a.shape[0], M * K)
        # padded cluster rows reach past the pool: gather clamped, as XLA
        # does (they are never live)
        idx_c = torch.clamp(idx, max=T - 1)
        ok_g = tri_ok[idx_c] & live.repeat_interleave(K, dim=1)
        t_r, a_r = _intersect_gathered(o[a], d[a], tmax[a],
                                       *(c[idx_c] for c in comps), ok_g)
        better = t_r < best_t[a]
        best_t[a] = torch.where(better, t_r, best_t[a])
        best_i[a] = torch.where(better, torch.gather(idx, 1, a_r),
                                best_i[a])
    return best_t, best_i


def select_closest_clusters(o, d, prep: TrianglePrep, tri_ok,
                            w_lo, w_hi, cl_ok, cluster_size: int,
                            block: int = 1024, gather: int = 32,
                            t_max=None):
    """Closest-hit winner selection over the clustered triangle pool.

    o, d: (N, 3) world rays (d normalized).  Returns (found (N,) bool,
    best_tri (N,) int32, best_t (N,) f32 — INF on miss).  Not
    differentiable (inputs are detached); route gradients through
    ops/traverse.selected_t or :func:`recompute_t`.  Padded rays get o = 0,
    d = 1 and t_max = -1, as in the JAX package."""
    o, d = o.detach(), d.detach()
    w_lo, w_hi = w_lo.detach(), w_hi.detach()
    dev = o.device
    K = cluster_size
    C = w_lo.shape[0]
    M = min(gather, C)
    n = o.shape[0]
    if t_max is None:
        t_max = torch.full((n,), INF, device=dev)
    t_max = t_max.detach()
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        o = torch.cat([o, torch.zeros((pad, 3), device=dev)])
        d = torch.cat([d, torch.ones((pad, 3), device=dev)])
        t_max = torch.cat([t_max, torch.full((pad,), -1.0, device=dev)])
    comps = tuple(x.detach() for x in (
        prep.an, prep.n[:, 0], prep.n[:, 1], prep.n[:, 2],
        prep.g1[:, 0], prep.g1[:, 1], prep.g1[:, 2], prep.c1,
        prep.g2[:, 0], prep.g2[:, 1], prep.g2[:, 2], prep.c2))
    o_blk = o.reshape(nb, block, 3)
    d_blk = d.reshape(nb, block, 3)
    t_blk = t_max.reshape(nb, block)
    # blocks are independent, so grouping cannot change a result
    group = max(1, _GROUP_ELEMS // (block * max(3 * C, M * K)))
    best_t, best_i = [], []
    for g0 in range(0, nb, group):
        sl = slice(g0, g0 + group)
        t_g, i_g = _walk_group(o_blk[sl], d_blk[sl], t_blk[sl], comps,
                               tri_ok, w_lo, w_hi, cl_ok, K, M)
        best_t.append(t_g)
        best_i.append(i_g)
    best_t = torch.cat(best_t).reshape(-1)[:n]
    best_i = torch.cat(best_i).reshape(-1)[:n].to(torch.int32)
    return best_t < INF, best_i, best_t


def recompute_t(o, d, prep: TrianglePrep, tri_idx, found):
    """Differentiable ray parameter of the selected winner triangle — the
    plane equation the intersection tile evaluates (t = (a·n − o·n)/(d·n)),
    gathered for one triangle per ray."""
    tri = tri_idx.long()
    n = prep.n[tri]
    an = prep.an[tri]
    d_n = dot(d, n)
    denom = torch.where(torch.abs(d_n) > 1e-30, d_n, 1.0)
    t = (an - dot(o, n)) / denom
    return torch.where(found, t, INF)
