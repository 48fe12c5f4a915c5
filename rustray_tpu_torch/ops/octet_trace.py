"""Octet round-trace: the ``pallas_algo="octet"`` mesh traversal.

Port of ``rustray_tpu/ops/octet_trace.py``, on the block walk's contract
(ops/block_trace.trace_tris_blocks).  Per trace call (rays pre-sorted by
coherence_key, dead last), in 32,768-ray slices:

1.  :func:`octet_entries`: the exact slab entry of every ray into every
    cluster AABB, folded to a per-octet (N/8, C) matrix (min over the
    octet's 8 rays; INF when no ray enters before its t_max).
2.  Round 0: each octet's nearest cluster (argmin) goes through the round
    kernel with one slot per octet.
3.  The need filter: per ray need = min(best_t, t_max) (any-hit mode: -BIG
    once occluded), maxed over the octet with a ``*1.0001 + 1e-3`` margin;
    clusters entered beyond it are dropped exactly.  Round 1 takes up to 4
    more clusters per octet (4 slots).
4.  Octets with more than 4 clusters left fall back to the block walk for
    exactly those rays (its own ``block_n`` of 128), under a host-side
    ``if`` so the cost is paid only when triggered.

The round kernel is ``csrc/octet_trace.cu`` on CUDA tensors and
:func:`_round_twin`, its plain torch version with the same contract, on CPU
tensors or under ``interpret=True``.  Rounds return the closest hit in both
modes; only the fallback runs the any-hit walk, and it merges on
``fb_t < t``.  Ties: rounds take clusters in (entry, cluster id) order and
the lowest lane wins within a slab, so equal-t winners resolve to the
lowest global triangle index.
"""
from __future__ import annotations

import ctypes

import torch

from .block_trace import slab_test
from .intersect import INF

_BIG = 3.0e37
_SLICE = 32768         # rays per independent pipeline slice
_R1_SLOTS = 4          # clusters per octet in round 1

# launches of the CUDA round kernel per slot count; only the launch in
# _round_cuda counts (the twin never does)
launches = {1: 0, _R1_SLOTS: 0}
# round calls per slot count (twin or kernel), and the block-walk fallback:
# its calls and the rays it re-traced
rounds = {1: 0, _R1_SLOTS: 0}
fallback = {"calls": 0, "rays": 0}


def reset_counts() -> None:
    for k in launches:
        launches[k] = 0
        rounds[k] = 0
    fallback["calls"] = fallback["rays"] = 0


# --------------------------------------------------------------------------
# Prologue: exact per-octet entry matrix
# --------------------------------------------------------------------------

def octet_entries(o, d, tmax, w_lo, w_hi, cl_ok, c_chunk: int = 512):
    """(N/8, C) f32: min over each octet's rays of the exact slab entry
    distance into cluster c (INF when no ray enters before its t_max).
    o/d are dead-masked (DEAD_ORIGIN / t_max = -1).  Chunked over clusters
    to bound the (N, chunk) intermediates."""
    n = o.shape[0]
    no = n // 8
    eps = 1e-30
    sd = torch.where(torch.abs(d) > eps, d, torch.where(d >= 0, eps, -eps))
    inv = 1.0 / sd
    oinv = o * inv
    C = w_lo.shape[0]
    outs = []
    for c0 in range(0, C, c_chunk):
        c1 = min(c0 + c_chunk, C)
        tn = None
        tf = None
        for a in range(3):
            t0 = w_lo[None, c0:c1, a] * inv[:, a:a + 1] - oinv[:, a:a + 1]
            t1 = w_hi[None, c0:c1, a] * inv[:, a:a + 1] - oinv[:, a:a + 1]
            lo_a = torch.minimum(t0, t1)
            hi_a = torch.maximum(t0, t1)
            tn = lo_a if tn is None else torch.maximum(tn, lo_a)
            tf = hi_a if tf is None else torch.minimum(tf, hi_a)
        entry = torch.clamp(tn, min=0.0)
        ok = (tf >= entry) & (entry <= tmax[:, None]) & cl_ok[None, c0:c1]
        e = torch.where(ok, entry, INF)
        outs.append(e.reshape(no, 8, c1 - c0).amin(dim=1))
    return torch.cat(outs, dim=1)                             # (N/8, C)


# --------------------------------------------------------------------------
# The round: CUDA kernel and its plain torch twin
# --------------------------------------------------------------------------

def _round_twin(flags, rays, desc_rows, pack, slots: int):
    """Plain torch version of the round kernel with its contract (see
    csrc/octet_trace.cu).  Returns (t (n_rows,) — INF on miss, idx
    (n_rows,) int32)."""
    steps = desc_rows.shape[0]
    K = pack.shape[2]
    opr = 128 // slots
    desc = desc_rows.reshape(steps * opr, slots).long()       # per octet
    r = rays.reshape(steps * opr, 8, 8)
    bt = torch.full((steps * opr, 8), INF, device=rays.device)
    bi = torch.zeros((steps * opr, 8), dtype=torch.int32, device=rays.device)
    for k in range(slots):
        c = desc[:, k]
        tmin, within = slab_test(r, pack[c])                  # (No, 8)
        gidx = c[:, None].to(torch.int32) * K + within
        better = tmin < bt
        bt = torch.where(better, tmin, bt)
        bi = torch.where(better, gidx, bi)
    live = (flags > 0).repeat_interleave(opr)[:, None]        # (No, 1)
    bt = torch.where(live, bt, INF)
    bi = torch.where(live, bi, 0)
    return bt.reshape(-1), bi.reshape(-1)


def _round_cuda(flags, rays, desc_rows, pack, slots: int):
    """Launch the CUDA round kernel (csrc/octet_trace.cu) on the current
    stream.  Returns (t (n_rows,), idx (n_rows,) int32)."""
    from ..build import load_kernel_lib
    steps = desc_rows.shape[0]
    n_rows = steps * (128 // slots) * 8
    C, _, K = pack.shape
    for name, x, dtype, shape in (
            ("flags", flags, torch.int32, (steps,)),
            ("rays", rays, torch.float32, (n_rows, 8)),
            ("desc", desc_rows, torch.int32, (steps, 128)),
            ("pack", pack, torch.float32, (C, 16, K))):
        if x.device != rays.device or x.dtype != dtype \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"octet round: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape} on "
                             f"{rays.device}; got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if slots <= 0 or 128 % slots:
        raise ValueError(f"octet round: slots must divide 128; got {slots}")
    fn = load_kernel_lib("octet_trace").rr_octet_round
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    t_out = torch.empty((n_rows,), dtype=torch.float32, device=rays.device)
    idx_out = torch.empty((n_rows,), dtype=torch.int32, device=rays.device)
    with torch.cuda.device(rays.device):
        err = fn(flags.data_ptr(), rays.data_ptr(), desc_rows.data_ptr(),
                 pack.data_ptr(), t_out.data_ptr(), idx_out.data_ptr(),
                 steps, slots, K, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"octet round kernel launch failed: CUDA error "
                           f"{err}")
    launches[slots] += 1
    return t_out, idx_out


def octet_round(flags, rays, desc_rows, pack, slots: int,
                interpret: bool = False):
    """One round over prepared descriptor rows: the CUDA kernel for CUDA
    tensors, the torch twin for CPU tensors or ``interpret=True``."""
    if rays.device.type == "cuda" and not interpret:
        return _round_cuda(flags, rays, desc_rows, pack, slots)
    if rays.device.type != "cpu" and not interpret:
        raise ValueError(f"octet round: no kernel for device {rays.device}")
    return _round_twin(flags, rays, desc_rows, pack, slots)


def round_inputs(rays, desc, slots: int, dummy: int):
    """desc (No, slots) cluster ids (dummy = miss) -> (flags (steps,),
    rays padded to n_rows, desc_rows (steps, 128)).  The kernel derives
    octet ids from slot position, so the padded tail of the last row
    addresses octets past No: it gets all-zero ray rows (d.n = 0, a miss)
    and output rows of its own."""
    no = desc.shape[0]
    n = no * 8
    flat = desc.reshape(no * slots).to(torch.int32)
    steps = -(-no * slots // 128)
    flat = torch.nn.functional.pad(flat, (0, steps * 128 - no * slots),
                                   value=dummy)
    desc_rows = flat.reshape(steps, 128).contiguous()
    flags = (desc_rows != dummy).any(dim=1).to(torch.int32)
    n_rows = steps * (128 // slots) * 8
    if n_rows > n:
        rays = torch.nn.functional.pad(rays, (0, 0, 0, n_rows - n))
    return flags, rays.contiguous(), desc_rows


def _run_round(rays, pack, desc, slots: int, dummy: int, interpret: bool):
    """desc (No, slots) int32 cluster ids (dummy = miss) -> per-ray
    (t (n,), idx (n,)) for this round's slots."""
    n = desc.shape[0] * 8
    rounds[slots] += 1
    t_out, i_out = octet_round(*round_inputs(rays, desc, slots, dummy), pack,
                               slots, interpret)
    return t_out[:n], i_out[:n]


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------

def round0_desc(e, dummy: int):
    """Round 0: each octet's nearest cluster.  Returns (desc0 (No, 1),
    c0 (No,)); torch.argmin returns the lowest index on ties, like
    jnp.argmin."""
    m0 = e.amin(dim=1)
    c0 = torch.argmin(e, dim=1).to(torch.int32)
    return torch.where(m0 < INF, c0, dummy)[:, None], c0


def round1_desc(e, c0, t, t_max, mode: str, dummy: int):
    """The need filter and round 1's descriptors.  Returns (desc1 (No, 4),
    remaining (No,) clusters left after the filter, before round 1)."""
    no, C = e.shape
    lane = torch.arange(C, dtype=torch.int32, device=e.device)[None]
    # exact: entry lower-bounds any hit t in a cluster; the margin covers
    # f32 disagreement between entry and hit t
    if mode == "any":
        need_r = torch.where(t < INF, -_BIG, t_max)
    else:
        need_r = torch.minimum(t, t_max)
    need_o = need_r.reshape(no, 8).amax(dim=1) * 1.0001 + 1e-3
    e = torch.where(lane == c0[:, None], INF, e)
    e = torch.where(e <= need_o[:, None], e, INF)
    remaining = (e < INF).sum(dim=1)
    descs = []
    for _ in range(_R1_SLOTS):
        mk = e.amin(dim=1)
        ck = torch.argmin(e, dim=1).to(torch.int32)
        descs.append(torch.where(mk < INF, ck, dummy))
        e = torch.where(lane == ck[:, None], INF, e)
    return torch.stack(descs, dim=1), remaining


def _trace_slice(o, d, alive, t_max, prep, w_lo, w_hi, cl_ok, K, mode,
                 block_n, interpret):
    from .block_trace import trace_tris_blocks

    n = o.shape[0]
    pack = prep.pallas_pack
    # the pack's last row is all zeros (pack_cluster_tris always appends
    # one) and never a real cluster id: empty slots miss and never collide
    dummy = pack.shape[0] - 1

    e = octet_entries(o, d, t_max, w_lo, w_hi, cl_ok)         # (No, C)
    rays = torch.cat([o, d, t_max[:, None], torch.zeros_like(t_max)[:, None]],
                     dim=1)                                   # (n, 8)

    desc0, c0 = round0_desc(e, dummy)
    t, idx = _run_round(rays, pack, desc0, 1, dummy, interpret)

    desc1, remaining = round1_desc(e, c0, t, t_max, mode, dummy)
    t1, i1 = _run_round(rays, pack, desc1, _R1_SLOTS, dummy, interpret)
    better = t1 < t
    t = torch.where(better, t1, t)
    idx = torch.where(better, i1, idx)

    # octets with more than _R1_SLOTS filtered clusters left re-trace
    # through the always-complete block walk (rare; exactness is kept)
    over_r = (remaining > _R1_SLOTS).repeat_interleave(8) & alive
    if bool(over_r.any()):
        fallback["calls"] += 1
        fallback["rays"] += int(over_r.sum())
        _, fb_i, fb_t = trace_tris_blocks(o, d, over_r, t_max, prep, w_lo,
                                          w_hi, cl_ok, K, block_n=block_n,
                                          mode=mode, interpret=interpret)
        better = fb_t < t
        t = torch.where(better, fb_t, t)
        idx = torch.where(better, fb_i, idx)
    return t < INF, idx, t


def trace_tris_octets(o, d, alive, t_max, prep, w_lo, w_hi, cl_ok,
                      cluster_size: int, mode: str = "closest",
                      block_n: int = 128, interpret: bool = False):
    """Closest (or any) mesh hit over the clustered pool via octet rounds.

    Same contract as block_trace.trace_tris_blocks: o, d (N, 3) world rays
    (pre-sorted by coherence_key for speed, never for correctness),
    ``t_max`` (N,) caps accepted hits, ``alive`` masks unused lanes.
    Returns (found (N,) bool, best_tri (N,) int32, best_t (N,) f32).
    ``mode="any"`` returns the closest hit of the rounds (a valid occluder)
    and uses occlusion to collapse the round-1 need filter."""
    from .block_trace import DEAD_ORIGIN

    if prep.pallas_pack is None:
        raise ValueError("trace_tris_octets requires prep.pallas_pack")
    n = o.shape[0]
    dev = o.device
    if alive is None:
        alive = torch.ones((n,), dtype=torch.bool, device=dev)
    if t_max is None:
        t_max = torch.full((n,), INF, device=dev)
    o = torch.where(alive[:, None], o, DEAD_ORIGIN)
    d = torch.where(alive[:, None], d, 1.0)
    t_max = torch.where(alive, t_max, -1.0)

    sl = min(_SLICE, -(-n // 8) * 8)
    pad = -(-n // sl) * sl - n
    if pad:
        o = torch.cat([o, torch.full((pad, 3), DEAD_ORIGIN, device=dev)])
        d = torch.cat([d, torch.ones((pad, 3), device=dev)])
        t_max = torch.cat([t_max, torch.full((pad,), -1.0, device=dev)])
        alive = torch.cat([alive, torch.zeros((pad,), dtype=torch.bool,
                                              device=dev)])

    founds, idxs, ts = [], [], []
    for s0 in range(0, n + pad, sl):
        s1 = s0 + sl
        a_sl = alive[s0:s1]
        # a slice with no live ray is skipped outright
        if bool(a_sl.any()):
            f, i, t = _trace_slice(o[s0:s1], d[s0:s1], a_sl, t_max[s0:s1],
                                   prep, w_lo, w_hi, cl_ok, cluster_size,
                                   mode, block_n, interpret)
        else:
            f = torch.zeros((sl,), dtype=torch.bool, device=dev)
            i = torch.zeros((sl,), dtype=torch.int32, device=dev)
            t = torch.full((sl,), INF, device=dev)
        founds.append(f)
        idxs.append(i)
        ts.append(t)
    return (torch.cat(founds)[:n], torch.cat(idxs)[:n],
            torch.cat(ts)[:n])
