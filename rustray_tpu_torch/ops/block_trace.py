"""Per-ray-block cluster walk: the closest/any-hit mesh traversal.

Port of ``rustray_tpu/ops/block_trace.py``:

1.  Rays arrive sorted by :func:`coherence_key` (direction octant + origin
    Morton code); dead rays sort last, so dead blocks visit nothing.
2.  :func:`_block_lists` slab-tests each block's interval bounds (as four
    quads) against all cluster AABBs and emits a complete front-to-back
    visit list per block: descriptors (cluster id in bits 0-15, quad mask
    in bits 16-19) with ascending entry distances.  The interval test is
    ``csrc/block_lists.cu`` on CUDA tensors and :func:`_list_keys_twin`,
    its plain torch version, on CPU tensors or under ``interpret=True``;
    the row sort that orders each list is torch's.
3.  The walk (``csrc/block_trace.cu`` on CUDA tensors; :func:`_walk_twin`,
    its plain torch version with the same contract, on CPU tensors or under
    ``interpret=True``) visits the list in groups of 8 and stops at the
    first group whose entry distance exceeds every lane's need.  The kernel
    splits it in two passes over work units of one group each
    (:func:`unit_list`): pass A computes every unit's partial result per
    ray over the whole card, pass B replays the walk's rule over each
    block's units in list order.  :func:`_walk_units_twin` is that
    decomposition in plain torch; the tests hold it bit for bit against
    :func:`_walk_twin`.

The JAX package has two walks and picks one by the pack's size
(``_VMEM_PACK_BUDGET``); the port keeps both contracts as two variants of
one kernel:

- **gated** (K1, the JAX ``_make_kernel_vmem``): a list entry is tested
  only by the quads its descriptor names, and in any-hit mode a lane
  freezes at its first hit in list order;
- **ungated** (K2, the JAX ``_make_kernel``): every lane tests every
  entry, and in any-hit mode a lane takes the nearest hit of the whole
  group of 8 entries (lowest list position, then lowest triangle lane, on
  exact ties) and freezes only at the group's end.

Closest mode gives the same winners in both.  Tie semantics: within a slab
the lowest triangle index wins; across clusters the nearer-entry cluster
wins exact-t ties.
"""
from __future__ import annotations

import ctypes

import torch

from .. import graphs
from .intersect import INF, TrianglePrep

_BIG = 3.0e37
# sentinel origin for dead/padding rays: far outside any scene — keeps them
# out of the prologue's block bounds; their t_max of -1 vetoes any hit
DEAD_ORIGIN = 2.0e37
# list entries per early-exit check of the walk (the JAX kernels'
# _VMEM_GROUP and _GROUP), and per work unit of the CUDA kernel
GROUP = 8
# triangles per slab that the CUDA kernel is compiled for (its kK)
KERNEL_K = 128
_MODES = ("closest", "any")
# pack bytes beyond which the JAX package streams slabs from HBM (its K2
# kernel, ``_make_kernel``).  On Hopper the pack sits in global memory at
# any size, so here the budget only selects the walk's contract: gated (K1)
# up to it, ungated (K2) beyond it.  Read at call time (tests patch it).
_VMEM_PACK_BUDGET = 64 * 1024 * 1024

# launches of the CUDA block-walk kernel, per mode: ``launches`` for the
# gated variant (K1), ``ungated_launches`` for the ungated one (K2); only
# the kernel launch in _walk_cuda counts (the twin never does)
launches = {"closest": 0, "any": 0}
ungated_launches = {"closest": 0, "any": 0}
# launches of the CUDA list kernel (csrc/block_lists.cu), per mode: one per
# prepare_walk on CUDA tensors, so on the main path equal to launches +
# ungated_launches; only the launch in _list_keys_cuda counts
list_launches = {"closest": 0, "any": 0}
# trace_tris_blocks calls per selected variant, twin or kernel alike
selected = {"gated": 0, "ungated": 0}
# the census of the walks, per mode: trace_tris_blocks calls, their blocks
# (visit lists) and the lists' entries (an upper bound on the clusters the
# walk visits: the early exit only shrinks it).  calls and blocks are host
# integers that a replay settles at graphs.fetch; entries is a device
# tensor once a walk ran, added to in place (a captured graph adds to it at
# every replay), so counting never waits for the device
census = {m: {"calls": 0, "blocks": 0, "entries": 0} for m in _MODES}


def reset_launches() -> None:
    """Zero the launch and call counters and the census (its entries in
    place)."""
    for m in _MODES:
        launches[m] = 0
        ungated_launches[m] = 0
        list_launches[m] = 0
        census[m]["calls"] = census[m]["blocks"] = 0
        graphs.zero_count(census[m], "entries")
    selected["gated"] = selected["ungated"] = 0


def pack_is_gated(pack) -> bool:
    """The JAX package's variant rule (``trace_tris_blocks``): the gated
    walk while the (C, 16, K) f32 pack fits ``_VMEM_PACK_BUDGET``."""
    return pack.shape[0] * 16 * pack.shape[2] * 4 <= _VMEM_PACK_BUDGET


def pack_cluster_tris(prep: TrianglePrep, tri_valid, n_clusters: int,
                      cluster_size: int, out_rows: int = None):
    """Pack per-triangle Baldwin-Weber constants into (C, 16, K) slabs.

    Rows: 0..2 plane normal n (zeroed for invalid slots: d·n = 0 is a
    guaranteed miss), 3 a·n, 4..6 g1, 7 c1, 8..10 g2, 11 c2, 12..15 zero.
    At least one all-zero row pads the cluster axis past ``n_clusters``."""
    n_clusters = min(n_clusters, prep.an.shape[0] // cluster_size)
    pool = n_clusters * cluster_size
    ok = tri_valid[:pool].to(torch.float32)
    comps = torch.stack([
        prep.n[:pool, 0] * ok, prep.n[:pool, 1] * ok, prep.n[:pool, 2] * ok,
        prep.an[:pool],
        prep.g1[:pool, 0], prep.g1[:pool, 1], prep.g1[:pool, 2],
        prep.c1[:pool],
        prep.g2[:pool, 0], prep.g2[:pool, 1], prep.g2[:pool, 2],
        prep.c2[:pool],
    ], dim=1)                                             # (pool, 12)
    out_rows = max(out_rows if out_rows is not None else n_clusters,
                   n_clusters + 1)
    pack = torch.zeros((out_rows, 16, cluster_size), device=comps.device)
    pack[:n_clusters, :12] = comps.reshape(
        n_clusters, cluster_size, 12).transpose(1, 2)
    return pack


def _spread3(x):
    """Spread the low 10 bits of ``x`` so bit i lands at position 3i."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def coherence_key(o, d, alive, lo, hi):
    """Sort key: bits [23:21] direction octant, [20:0] 7-bit-per-axis
    Morton code of the origin within the scene bounds; dead rays get
    INT32_MAX and sort last."""
    ext = torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp((o - lo) / ext * 128.0, 0.0, 127.0).to(torch.int32)
    m = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
         | (_spread3(q[:, 2]) << 2))
    octant = ((d[:, 0] >= 0).to(torch.int32) * 4
              + (d[:, 1] >= 0).to(torch.int32) * 2
              + (d[:, 2] >= 0).to(torch.int32))
    key = (octant << 21) | m
    return torch.where(alive, key, 0x7FFFFFFF)


def _list_keys_twin(o, d, alive, tmax, w_lo, w_hi, cl_ok, nb, block,
                    refine: int = 4):
    """The interval test of :func:`_block_lists` in plain torch: the twin
    of ``csrc/block_lists.cu``.

    Interval arithmetic over each sub-block's (alive-masked) origin and
    direction bounds lower-bounds every live ray's slab entry distance;
    sub-block results are unioned and recorded as the descriptor's quad
    mask.  Returns (key (NB, C) f32: the least entry distance, INF where no
    sub-block may enter; cid (NB, C) int32 descriptors in cluster order;
    count (NB,) int32, the clusters some sub-block may enter)."""
    S = refine if block % refine == 0 else 1
    sub = block // S
    nbs = nb * S
    o_b = o.reshape(nbs, sub, 3)
    d_b = d.reshape(nbs, sub, 3)
    a_b = alive.reshape(nbs, sub, 1)
    olo = torch.where(a_b, o_b, _BIG).amin(dim=1).reshape(nb, S, 3)
    ohi = torch.where(a_b, o_b, -_BIG).amax(dim=1).reshape(nb, S, 3)
    dlo = torch.where(a_b, d_b, _BIG).amin(dim=1).reshape(nb, S, 3)
    dhi = torch.where(a_b, d_b, -_BIG).amax(dim=1).reshape(nb, S, 3)
    sub_alive = a_b[..., 0].any(dim=1).reshape(nb, S)
    sub_tmax = torch.where(a_b[..., 0], tmax.reshape(nbs, sub),
                           -_BIG).amax(dim=1).reshape(nb, S)

    C = w_lo.shape[0]
    dev = o.device
    possible = torch.zeros((nb, C), dtype=torch.bool, device=dev)
    entry_min = torch.full((nb, C), INF, device=dev)
    qbits = torch.zeros((nb, C), dtype=torch.int32, device=dev)
    for s in range(S):
        ax_ok = (dlo[:, s] > 1e-12) | (dhi[:, s] < -1e-12)
        i1 = 1.0 / torch.where(ax_ok, dlo[:, s], 1.0)
        i2 = 1.0 / torch.where(ax_ok, dhi[:, s], 1.0)
        ilo, ihi = torch.minimum(i1, i2), torch.maximum(i1, i2)

        entry_lb = None
        exit_ub = None
        for a in range(3):
            ia_lo, ia_hi = ilo[:, a:a + 1], ihi[:, a:a + 1]    # (NB, 1)
            oh, ol = ohi[:, s, a][:, None], olo[:, s, a][:, None]
            lo_a = w_lo[None, :, a]                            # (1, C)
            hi_a = w_hi[None, :, a]
            a1, b1 = lo_a - oh, lo_a - ol
            a2, b2 = hi_a - oh, hi_a - ol
            lo_lb = torch.minimum(torch.minimum(a1 * ia_lo, a1 * ia_hi),
                                  torch.minimum(b1 * ia_lo, b1 * ia_hi))
            lo_ub = torch.maximum(torch.maximum(a1 * ia_lo, a1 * ia_hi),
                                  torch.maximum(b1 * ia_lo, b1 * ia_hi))
            hi_lb = torch.minimum(torch.minimum(a2 * ia_lo, a2 * ia_hi),
                                  torch.minimum(b2 * ia_lo, b2 * ia_hi))
            hi_ub = torch.maximum(torch.maximum(a2 * ia_lo, a2 * ia_hi),
                                  torch.maximum(b2 * ia_lo, b2 * ia_hi))
            near_a = torch.minimum(lo_lb, hi_lb)   # LB of per-ray near plane
            far_a = torch.maximum(lo_ub, hi_ub)    # UB of per-ray far plane
            axm = ax_ok[:, a:a + 1]
            near_a = torch.where(axm, near_a, -_BIG)
            far_a = torch.where(axm, far_a, _BIG)
            entry_lb = near_a if entry_lb is None \
                else torch.maximum(entry_lb, near_a)
            exit_ub = far_a if exit_ub is None \
                else torch.minimum(exit_ub, far_a)
        entry_lb = torch.clamp(entry_lb, min=0.0)              # (NB, C)
        poss_s = ((exit_ub >= entry_lb)
                  & (entry_lb <= sub_tmax[:, s][:, None])
                  & cl_ok[None] & sub_alive[:, s][:, None])
        possible = possible | poss_s
        entry_min = torch.minimum(entry_min,
                                  torch.where(poss_s, entry_lb, INF))
        qbits = qbits | (poss_s.to(torch.int32) << s)
    key = torch.where(possible, entry_min, INF)
    if S != 4:
        qbits = torch.where(possible, 15, 0).to(torch.int32)
    cid = torch.arange(C, dtype=torch.int32, device=dev)[None] | (qbits << 16)
    return key, cid, possible.sum(dim=1).to(torch.int32)


def _check_args(what, dev, *specs):
    """Raise unless each (name, x, dtype, shape) is contiguous on dev."""
    for name, x, dtype, shape in specs:
        if x.device != dev or x.dtype != dtype \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} "
                             f"tensor of shape {shape} on {dev}; got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")


def _list_keys_cuda(o, d, alive, tmax, w_lo, w_hi, cl_ok, nb, block,
                    refine: int = 4, mode: str = "closest"):
    """Launch the list kernel (csrc/block_lists.cu) on the current stream:
    :func:`_list_keys_twin`'s contract for four sub-blocks, with one launch
    counted in ``list_launches[mode]``.  Raises on what the kernel does not
    take (another sub-block count, a block over 1024 rays, inputs of
    another device, type, shape or layout) before any CUDA call."""
    if refine != 4 or block % 4:
        raise ValueError(f"block lists: the kernel takes 4 sub-blocks per "
                         f"block (refine=4, block_n a multiple of 4); got "
                         f"refine={refine}, block_n={block}")
    if block > 1024:
        raise ValueError(f"block lists: block_n must be at most 1024; got "
                         f"{block}")
    n, C, dev = nb * block, w_lo.shape[0], o.device
    _check_args("block lists", dev, ("o", o, torch.float32, (n, 3)),
                ("d", d, torch.float32, (n, 3)),
                ("alive", alive, torch.bool, (n,)),
                ("tmax", tmax, torch.float32, (n,)),
                ("w_lo", w_lo, torch.float32, (C, 3)),
                ("w_hi", w_hi, torch.float32, (C, 3)),
                ("cl_ok", cl_ok, torch.bool, (C,)))
    from ..build import load_kernel_lib
    fn = load_kernel_lib("block_lists").rr_block_lists
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    key = torch.empty((nb, C), dtype=torch.float32, device=dev)
    cid = torch.empty((nb, C), dtype=torch.int32, device=dev)
    count = torch.empty((nb,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(o.data_ptr(), d.data_ptr(), alive.data_ptr(),
                 tmax.data_ptr(), w_lo.data_ptr(), w_hi.data_ptr(),
                 cl_ok.data_ptr(), key.data_ptr(), cid.data_ptr(),
                 count.data_ptr(), nb, block, C,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"block lists kernel launch failed: CUDA error "
                           f"{err}")
    list_launches[mode] += 1
    return key, cid, count


def _block_lists(o, d, alive, tmax, w_lo, w_hi, cl_ok, nb, block, cpad,
                 refine: int = 4, interpret: bool = False,
                 mode: str = "closest"):
    """Complete conservative front-to-back cluster list per ray block: the
    interval test (the CUDA kernel for CUDA tensors, counted under
    ``mode``; :func:`_list_keys_twin` for CPU tensors or ``interpret=True``)
    and a stable sort of each block's keys.  Returns (order (NB, cpad)
    int32 descriptors, entry (NB, cpad) f32 ascending, count (NB,)
    int32)."""
    args = (o, d, alive, tmax, w_lo, w_hi, cl_ok, nb, block, refine)
    if o.device.type == "cuda" and not interpret:
        key, cid, count = _list_keys_cuda(*args, mode=mode)
    elif o.device.type != "cpu" and not interpret:
        raise ValueError(f"block lists: no kernel for device {o.device}")
    else:
        key, cid, count = _list_keys_twin(*args)
    C = w_lo.shape[0]
    entry_s, perm = torch.sort(key, dim=1, stable=True)
    order = torch.gather(cid, 1, perm)
    if cpad > C:
        entry_s = torch.nn.functional.pad(entry_s, (0, cpad - C), value=INF)
        order = torch.nn.functional.pad(order, (0, cpad - C))
    return order.contiguous(), entry_s.contiguous(), count


# --------------------------------------------------------------------------
# The walk: CUDA kernel and its plain torch twin
# --------------------------------------------------------------------------

def slab_test(r, slabs):
    """The twins' ray x slab test, in the kernels' operation order: rays
    r (B, R, 8) rows [ox oy oz dx dy dz t_max pad] against slabs
    (B, 16, K).  Returns (t (B, R) of the nearest hit within t_max, INF on
    a miss; its lane (B, R) int32, the lowest on exact ties)."""
    K = slabs.shape[2]
    ox, oy, oz, dx, dy, dz, tmax = (r[..., i:i + 1] for i in range(7))
    trs = slabs[:, :, None, :]                             # (B, 16, 1, K)
    n0, n1, n2, an = trs[:, 0], trs[:, 1], trs[:, 2], trs[:, 3]
    g10, g11, g12, c1 = trs[:, 4], trs[:, 5], trs[:, 6], trs[:, 7]
    g20, g21, g22, c2 = trs[:, 8], trs[:, 9], trs[:, 10], trs[:, 11]
    d_n = dx * n0 + dy * n1 + dz * n2                      # (B, R, K)
    o_n = ox * n0 + oy * n1 + oz * n2
    den = torch.abs(d_n) > 1e-30
    t = (an - o_n) / torch.where(den, d_n, 1.0)
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    u = px * g10 + py * g11 + pz * g12 + c1
    v = px * g20 + py * g21 + pz * g22 + c2
    hit = (den & (t >= 0.0) & (u >= 0.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t <= tmax))
    t_m = torch.where(hit, t, INF)
    tmin = torch.amin(t_m, dim=2)                          # (B, R)
    lane = torch.arange(K, dtype=torch.int32, device=r.device)
    within = torch.amin(torch.where(t_m == tmin[..., None], lane, K), dim=2)
    return tmin, torch.clamp(within, max=K - 1)


def _walk_twin(count, rays, order, entry, pack, mode: str,
               gated: bool = True, return_visited: bool = False):
    """Plain torch version of the block walk with the kernel's contract.

    Per group of GROUP list positions, the blocks still walking (next
    group's first entry distance within their need) visit positions j in
    order, all at once: gather the (16, K) slabs and intersect them.  The
    gated variant tests only the quads whose descriptor bit is set and folds
    each slab into the running best; the ungated variant tests every lane
    and folds the group's nearest hit at the group's end.  Then each block's
    need is recomputed.  Returns (t (NB, BN) — INF on miss, idx (NB, BN)
    int32), and with ``return_visited`` also the list entries each block
    visited ((NB,) int32)."""
    nb, bn, _ = rays.shape
    K = pack.shape[2]
    dev = rays.device
    tmax = rays[..., 6]                                    # (NB, BN)
    quad = (torch.arange(bn, device=dev) // (bn // 4))[None]
    best_t = torch.full((nb, bn), INF, device=dev)
    best_i = torch.zeros((nb, bn), dtype=torch.int32, device=dev)
    visited = torch.zeros((nb,), dtype=torch.int32, device=dev)
    need = tmax.amax(dim=1)
    walking = count > 0
    cnt = count.long()
    for j0 in range(0, order.shape[1], GROUP):
        walking = walking & (j0 < cnt) & (entry[:, j0] <= need)
        act = torch.nonzero(walking).squeeze(1)            # (A,)
        if act.numel() == 0:
            break
        visited[act] += torch.clamp(count[act] - j0, max=GROUP)
        r = rays[act]                                      # (A, BN, 8)
        tm = r[..., 6]
        bt, bi = best_t[act], best_i[act]
        # the ungated variant's group winner (nearest, earliest position)
        gt = torch.full_like(bt, INF)
        gi = torch.zeros_like(bi)
        for j in range(j0, min(j0 + GROUP, order.shape[1])):
            desc = order[act, j]
            cid = (desc & 0xFFFF).long()
            gate = (j < cnt[act])[:, None]                 # (A, 1)
            if gated:
                gate = gate & (((desc[:, None] >> 16) >> quad) & 1).bool()
            tile_min, within = slab_test(r, pack[cid])     # (A, BN)
            gidx = cid[:, None].to(torch.int32) * K + within
            if not gated:
                better = gate & (tile_min < gt)
                gt = torch.where(better, tile_min, gt)
                gi = torch.where(better, gidx, gi)
                continue
            if mode == "any":
                better = gate & (tile_min < INF) & (bt >= INF)
            else:
                better = gate & (tile_min < bt)
            bt = torch.where(better, tile_min, bt)
            bi = torch.where(better, gidx, bi)
        if not gated:
            if mode == "any":
                better = (gt < INF) & (bt >= INF)
            else:
                better = gt < bt
            bt = torch.where(better, gt, bt)
            bi = torch.where(better, gi, bi)
        best_t[act] = bt
        best_i[act] = bi
        if mode == "any":
            lane_need = torch.where(bt < INF, -INF, tm)
        else:
            lane_need = torch.minimum(bt, tm)
        need[act] = lane_need.amax(dim=1)
    if return_visited:
        return best_t, best_i, visited
    return best_t, best_i


def unit_list(count):
    """The CUDA walk's work units: one per group of GROUP list positions of
    each block, numbered block by block.  Returns (units (NB,) int32 =
    ceil(count / GROUP), ustart (NB,) int32, the inclusive cumsum: block b
    owns units [ustart[b] - units[b], ustart[b]))."""
    units = torch.div(count + (GROUP - 1), GROUP, rounding_mode="floor")
    return units, torch.cumsum(units, 0, dtype=torch.int32)


def unit_blocks(count):
    """Every unit's (block (U,) int64, group (U,) int64), in unit order:
    what the kernel finds by a binary search of ``ustart``."""
    units, ustart = unit_list(count)
    n = int(ustart[-1]) if count.numel() else 0
    u = torch.arange(n, device=count.device)
    blk = torch.searchsorted(ustart.long(), u, right=True)
    return blk, u - (ustart.long() - units.long())[blk]


def _walk_units_twin(count, rays, order, entry, pack, mode: str,
                     gated: bool = True, return_visited: bool = False):
    """The CUDA kernel's two-pass decomposition of the walk in plain torch
    (tests only; :func:`_walk_twin` is the contract).

    Pass A: every unit (block b, group g) folds its entries' slab results
    per ray in list order, regardless of the walk's state: the strictly
    nearest hit (earliest entry, then lowest lane, on ties), or in the
    gated any-hit mode the first entry with a hit.  Pass B: each block
    replays the walk over its units in order, stopping at the first group
    whose entry distance exceeds its need, and folds each unit's partial as
    the walk folds a group.  Same returns as :func:`_walk_twin`."""
    nb, bn, _ = rays.shape
    K = pack.shape[2]
    dev = rays.device
    quad = (torch.arange(bn, device=dev) // (bn // 4))[None]
    units, ustart = unit_list(count)
    blk, grp = unit_blocks(count)                          # (U,)
    # pass A
    r = rays[blk]                                          # (U, BN, 8)
    cnt = count.long()[blk]
    part_t = torch.full((blk.numel(), bn), INF, device=dev)
    part_i = torch.zeros((blk.numel(), bn), dtype=torch.int32, device=dev)
    first_hit = gated and mode == "any"
    for e in range(GROUP):
        j = grp * GROUP + e
        desc = order[blk, torch.clamp(j, max=order.shape[1] - 1)]
        cid = (desc & 0xFFFF).long()
        gate = (j < cnt)[:, None]
        if gated:
            gate = gate & (((desc[:, None] >> 16) >> quad) & 1).bool()
        tile_min, within = slab_test(r, pack[cid])         # (U, BN)
        if first_hit:
            better = gate & (tile_min < INF) & (part_t >= INF)
        else:
            better = gate & (tile_min < part_t)
        part_t = torch.where(better, tile_min, part_t)
        part_i = torch.where(better, cid[:, None].to(torch.int32) * K
                             + within, part_i)
    # pass B
    tmax = rays[..., 6]
    best_t = torch.full((nb, bn), INF, device=dev)
    best_i = torch.zeros((nb, bn), dtype=torch.int32, device=dev)
    visited = torch.zeros((nb,), dtype=torch.int32, device=dev)
    need = tmax.amax(dim=1)
    first = (ustart - units).long()
    walking = count > 0
    for g in range(int(units.max()) if nb else 0):
        walking = walking & (g < units) & (entry[:, g * GROUP] <= need)
        act = torch.nonzero(walking).squeeze(1)
        if act.numel() == 0:
            break
        u = first[act] + g
        pt, pi = part_t[u], part_i[u]
        bt, bi = best_t[act], best_i[act]
        if mode == "any":
            better = (pt < INF) & (bt >= INF)
        else:
            better = pt < bt
        bt = torch.where(better, pt, bt)
        best_t[act] = bt
        best_i[act] = torch.where(better, pi, bi)
        visited[act] += torch.clamp(count[act] - g * GROUP, max=GROUP)
        if mode == "any":
            lane_need = torch.where(bt < INF, -INF, tmax[act])
        else:
            lane_need = torch.minimum(bt, tmax[act])
        need[act] = lane_need.amax(dim=1)
    if return_visited:
        return best_t, best_i, visited
    return best_t, best_i


def _walk_cuda(count, rays, order, entry, pack, mode: str,
               gated: bool = True, return_visited: bool = False):
    """Launch the CUDA block walk (csrc/block_trace.cu: pass A over the
    units, pass B per block) on the current stream.  Returns (t (NB, BN),
    idx (NB, BN) int32), and with ``return_visited`` the entries each block
    visited ((NB,) int32).

    The partials go in a workspace of one row of BN per possible unit,
    NB * ceil(cpad / GROUP) rows (t f32 and idx i32: 264 MB for the bench's
    98,304 shadow rays), sized from shapes alone so that no host sync waits
    for the unit count; PyTorch's caching allocator keeps it between
    calls."""
    from ..build import load_kernel_lib
    nb, bn, width = rays.shape
    n_rows, _, K = pack.shape
    cpad = order.shape[1]
    if K != KERNEL_K:
        raise ValueError(f"block walk: the kernel is compiled for slabs of "
                         f"K={KERNEL_K} triangles; got K={K}")
    _check_args("block walk", rays.device,
                ("count", count, torch.int32, (nb,)),
                ("rays", rays, torch.float32, (nb, bn, 8)),
                ("order", order, torch.int32, (nb, cpad)),
                ("entry", entry, torch.float32, (nb, cpad)),
                ("pack", pack, torch.float32, (n_rows, 16, K)))
    if bn % 4 or bn > 1024:
        raise ValueError("block walk: block_n must be a multiple of 4 and "
                         "at most 1024 (one thread per ray)")
    fn = load_kernel_lib("block_trace").rr_block_trace
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = rays.device
    _, ustart = unit_list(count)
    ws_rows = nb * -(-cpad // GROUP)
    ws_t = torch.empty((ws_rows, bn), dtype=torch.float32, device=dev)
    ws_i = torch.empty((ws_rows, bn), dtype=torch.int32, device=dev)
    t_out = torch.empty((nb, bn), dtype=torch.float32, device=dev)
    idx_out = torch.empty((nb, bn), dtype=torch.int32, device=dev)
    visited = torch.empty((nb,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(count.data_ptr(), ustart.data_ptr(), rays.data_ptr(),
                 order.data_ptr(), entry.data_ptr(), pack.data_ptr(),
                 ws_t.data_ptr(), ws_i.data_ptr(), t_out.data_ptr(),
                 idx_out.data_ptr(), visited.data_ptr(), nb, bn, cpad,
                 int(mode == "any"), int(gated),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"block walk kernel launch failed: CUDA error "
                           f"{err}")
    (launches if gated else ungated_launches)[mode] += 1
    if return_visited:
        return t_out, idx_out, visited
    return t_out, idx_out


def block_walk(count, rays, order, entry, pack, mode: str = "closest",
               interpret: bool = False, gated: bool = True,
               return_visited: bool = False):
    """The walk over prepared block lists: the CUDA kernel for CUDA
    tensors, the torch twin for CPU tensors or ``interpret=True``.
    ``gated`` selects K1's contract, else K2's (module docstring);
    ``return_visited`` adds the entries each block visited."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}; got {mode!r}")
    args = (count, rays, order, entry, pack, mode, gated, return_visited)
    if rays.device.type == "cuda" and not interpret:
        return _walk_cuda(*args)
    if rays.device.type != "cpu" and not interpret:
        raise ValueError(f"block walk: no kernel for device {rays.device}")
    return _walk_twin(*args)


def pad_rays(o, d, alive, t_max, block_n: int):
    """Dead-ray masking and padding to whole blocks of ``block_n``: what
    the list test and the walk read.  Returns (o, d, alive, t_max, nb)."""
    n = o.shape[0]
    nb = -(-n // block_n)
    pad = nb * block_n - n
    dev = o.device
    if alive is None:
        alive = torch.ones((n,), dtype=torch.bool, device=dev)
    if t_max is None:
        t_max = torch.full((n,), INF, device=dev)
    # dead lanes: t_max = -1 vetoes any hit (t >= 0 always); the sentinel
    # origin keeps them out of the prologue's interval bounds
    o = torch.where(alive[:, None], o, DEAD_ORIGIN)
    d = torch.where(alive[:, None], d, 1.0)
    t_max = torch.where(alive, t_max, -1.0)
    if pad:
        o = torch.cat([o, torch.full((pad, 3), DEAD_ORIGIN, device=dev)])
        d = torch.cat([d, torch.ones((pad, 3), device=dev)])
        t_max = torch.cat([t_max, torch.full((pad,), -1.0, device=dev)])
        alive = torch.cat([alive, torch.zeros((pad,), dtype=torch.bool,
                                              device=dev)])
    return o, d, alive, t_max, nb


def prepare_walk(o, d, alive, t_max, w_lo, w_hi, cl_ok, block_n: int,
                 mode: str = "closest", interpret: bool = False):
    """Dead-ray masking, padding and visit lists for :func:`block_walk`
    (the list kernel's launch counted under ``mode``; ``interpret`` runs
    the twin).  Returns (count, rays (NB, BN, 8), order, entry)."""
    C = w_lo.shape[0]
    if C > 65536:
        raise ValueError("cluster pool exceeds the 16-bit descriptor "
                         "packing (>8.4M triangles); split the pool")
    if block_n % 4:
        raise ValueError("block_n must be a multiple of 4 (quad gating)")
    cpad = -(-C // 128) * 128
    o, d, alive, t_max, nb = pad_rays(o, d, alive, t_max, block_n)
    order, entry, count = _block_lists(o, d, alive, t_max, w_lo, w_hi,
                                       cl_ok, nb, block_n, cpad,
                                       interpret=interpret, mode=mode)
    rays = torch.cat([o, d, t_max[:, None], torch.zeros_like(t_max)[:, None]],
                     dim=1).reshape(nb, block_n, 8).contiguous()
    return count, rays, order, entry


def _count_walk(count, mode: str) -> None:
    """Add one walk's visit lists ``count`` (NB,) to the ``census``: a
    cast, a reduction and an add on the device, no host sync."""
    c = census[mode]
    c["calls"] += 1
    c["blocks"] += int(count.shape[0])
    graphs.count_on_device(c, "entries", count.sum(dtype=torch.int64))


def trace_tris_blocks(o, d, alive, t_max, prep: TrianglePrep, w_lo, w_hi,
                      cl_ok, cluster_size: int, block_n: int = 512,
                      mode: str = "closest", interpret: bool = False):
    """Closest (or any) mesh hit over the clustered pool.

    o, d: (N, 3) world rays (d normalized; pre-sorted by
    :func:`coherence_key` for speed, never for correctness).  ``t_max``
    (N,) caps accepted hits (None: unbounded); ``alive`` masks unused
    lanes.  The pack's size selects the gated or ungated walk
    (:func:`pack_is_gated`).  Returns (found (N,) bool, best_tri (N,)
    int32, best_t (N,) f32 — INF on miss).  Selection only: the inputs
    are detached, as the JAX package's ``stop_gradient``s do; gradients of
    t go through ops/traverse.selected_t."""
    if prep.pallas_pack is None:
        raise ValueError("trace_tris_blocks requires prep.pallas_pack — "
                         "build it with pack_cluster_tris")
    if prep.pallas_pack.shape[2] != cluster_size:
        raise ValueError("pallas_pack slabs do not match cluster_size")
    o, d, w_lo, w_hi = o.detach(), d.detach(), w_lo.detach(), w_hi.detach()
    t_max = None if t_max is None else t_max.detach()
    pack = prep.pallas_pack.detach()
    n = o.shape[0]
    count, rays, order, entry = prepare_walk(o, d, alive, t_max, w_lo, w_hi,
                                             cl_ok, block_n, mode, interpret)
    _count_walk(count, mode)
    gated = pack_is_gated(pack)
    selected["gated" if gated else "ungated"] += 1
    t, idx = block_walk(count, rays, order, entry, pack, mode, interpret,
                        gated)
    t = t.reshape(-1)[:n]
    return t < INF, idx.reshape(-1)[:n], t
