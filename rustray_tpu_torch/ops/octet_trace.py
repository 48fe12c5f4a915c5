"""Octet round-trace: the ``pallas_algo="octet"`` mesh traversal.

Port of ``rustray_tpu/ops/octet_trace.py``, on the block walk's contract
(ops/block_trace.trace_tris_blocks).  Per trace call (rays pre-sorted by
coherence_key, dead last), in 32,768-ray slices, two rounds of one warp
per octet (8 consecutive rays):

1.  :func:`round0`: the exact slab entry of every ray into every cluster
    AABB, folded to a per-octet (N/8, C) matrix ``e`` (min over the
    octet's 8 rays; INF when no ray enters before its t_max), each octet's
    nearest cluster ``c0`` (argmin, lowest id on ties) and its hits there.
2.  :func:`round1`: the need filter (per ray need = min(best_t, t_max);
    any-hit mode: -BIG once occluded; maxed over the octet with a
    ``*1.0001 + 1e-3`` margin: clusters entered beyond it are dropped
    exactly), up to 4 more clusters per octet in (entry, id) order, their
    hits folded in, and ``over``: more than 4 clusters were left.
3.  Octets over 4 fall back to the block walk for exactly those rays (its
    own ``block_n`` of 128), under a gate (:func:`..graphs.cond`: a host
    ``if`` eagerly, an IF node in a CUDA graph) so the cost is paid only
    when triggered.

Each round is one kernel of ``csrc/octet_trace.cu`` on CUDA tensors, with
the selection fused in, and its plain torch twin on CPU tensors or under
``interpret=True``: :func:`_round0_twin` and :func:`_round1_twin`, the
chains of the JAX design (the entry matrix, the argmin passes, the
descriptor rows and the round twin :func:`_round_twin`, the Pallas
kernel's contract).  Rounds return the closest hit in both modes; only the
fallback runs the any-hit walk, and it merges on ``fb_t < t``.  Ties:
rounds take clusters in (entry, cluster id) order and the lowest lane wins
within a slab, so equal-t winners resolve to the lowest global triangle
index.
"""
from __future__ import annotations

import ctypes

import torch

from .. import graphs
from .block_trace import KERNEL_K, _check_args, slab_test
from .intersect import INF

_BIG = 3.0e37
_SLICE = 32768         # rays per independent pipeline slice
_R1_SLOTS = 4          # clusters per octet in round 1
_LANES = 32            # lanes of the warp that takes an octet

# launches of the CUDA kernels, keyed by the round's slot count (1: round
# 0, 4: round 1); only the launches in _round0_cuda / _round1_cuda count
launches = {1: 0, _R1_SLOTS: 0}
# round calls per slot count (twin or kernel), and the block-walk fallback:
# its calls and the rays it re-traced (a device tensor once a fallback ran,
# so counting costs no host sync; added to in place, so that a captured
# graph adds to it at every replay)
rounds = {1: 0, _R1_SLOTS: 0}
fallback = {"calls": 0, "rays": 0}


def reset_counts() -> None:
    for k in launches:
        launches[k] = 0
        rounds[k] = 0
    fallback["calls"] = 0
    graphs.zero_count(fallback, "rays")


# --------------------------------------------------------------------------
# The JAX design's parts: entry matrix, descriptors, round twin
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


def _round_twin(flags, rays, desc_rows, pack, slots: int):
    """The Pallas round kernel's contract in plain torch: one descriptor
    row holds 128/slots octets x ``slots`` cluster ids (empty slots name
    the all-zero dummy row); each ray keeps its minimum t over its octet's
    slots, the lowest lane within a slab and the earliest slot across
    slabs on ties.  Returns (t (n_rows,) — INF on miss, idx (n_rows,)
    int32)."""
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


def _run_round(rays, pack, desc, slots: int, dummy: int):
    """desc (No, slots) int32 cluster ids (dummy = miss) -> per-ray
    (t (n,), idx (n,)) of the round twin over these slots."""
    n = desc.shape[0] * 8
    t_out, i_out = _round_twin(*round_inputs(rays, desc, slots, dummy), pack,
                               slots)
    return t_out[:n], i_out[:n]


def round0_desc(e, dummy: int):
    """Round 0: each octet's nearest cluster.  Returns (desc0 (No, 1),
    c0 (No,)); torch.argmin returns the lowest index on ties, like
    jnp.argmin."""
    m0 = e.amin(dim=1)
    c0 = torch.argmin(e, dim=1).to(torch.int32)
    return torch.where(m0 < INF, c0, dummy)[:, None], c0


def _need(t, t_max, mode: str):
    """Per octet: the largest t any of its rays still needs, with the
    margin for f32 disagreement between entry and hit t (two roundings)."""
    if mode == "any":
        need_r = torch.where(t < INF, -_BIG, t_max)
    else:
        need_r = torch.minimum(t, t_max)
    return need_r.reshape(-1, 8).amax(dim=1) * 1.0001 + 1e-3


def round1_desc(e, c0, t, t_max, mode: str, dummy: int):
    """The need filter and round 1's descriptors.  Returns (desc1 (No, 4),
    remaining (No,) clusters left after the filter, before round 1)."""
    C = e.shape[1]
    lane = torch.arange(C, dtype=torch.int32, device=e.device)[None]
    # exact: entry lower-bounds any hit t in a cluster
    need_o = _need(t, t_max, mode)
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


def _rays(o, d, t_max):
    """(n, 8) rows [ox oy oz dx dy dz t_max 0] of the round twin."""
    return torch.cat([o, d, t_max[:, None], torch.zeros_like(t_max)[:, None]],
                     dim=1)


# --------------------------------------------------------------------------
# The rounds: twins, CUDA kernels and their wrappers
# --------------------------------------------------------------------------

def _round0_twin(o, d, t_max, w_lo, w_hi, cl_ok, pack):
    """Plain torch round 0 with the kernel's contract (see
    csrc/octet_trace.cu).  Returns (e (No, C), c0 (No,) int32, t (n,),
    idx (n,) int32)."""
    dummy = pack.shape[0] - 1
    e = octet_entries(o, d, t_max, w_lo, w_hi, cl_ok)
    desc0, c0 = round0_desc(e, dummy)
    t, idx = _run_round(_rays(o, d, t_max), pack, desc0, 1, dummy)
    return e, c0, t, idx


def _round1_twin(o, d, t_max, e, c0, t, idx, pack, mode: str):
    """Plain torch round 1 with the kernel's contract.  Returns (t (n,),
    idx (n,) int32 merged with round 0's on a strict '<', over (No,) bool,
    slots (No, 4) int32, remaining (No,) int32)."""
    dummy = pack.shape[0] - 1
    slots, remaining = round1_desc(e, c0, t, t_max, mode, dummy)
    t1, i1 = _run_round(_rays(o, d, t_max), pack, slots, _R1_SLOTS, dummy)
    better = t1 < t
    return (torch.where(better, t1, t), torch.where(better, i1, idx),
            remaining > _R1_SLOTS, slots, remaining.to(torch.int32))


def _pack_spec(what, pack):
    R, _, K = pack.shape
    if K != KERNEL_K:
        raise ValueError(f"{what}: the kernel is compiled for slabs of "
                         f"K={KERNEL_K} triangles; got K={K}")
    return ("pack", pack, torch.float32, (R, 16, K))


def _launch(name, *args):
    from ..build import load_kernel_lib
    fn = getattr(load_kernel_lib("octet_trace"), name)
    fn.argtypes = [ctypes.c_int if isinstance(a, int) else ctypes.c_void_p
                   for a in args] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*(a if isinstance(a, int) else a.data_ptr() for a in args),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"octet {name} kernel launch failed: CUDA error "
                           f"{err}")


def _round0_cuda(o, d, t_max, w_lo, w_hi, cl_ok, pack):
    """Launch round 0 (csrc/octet_trace.cu) on the current stream."""
    n, C, dev = o.shape[0], w_lo.shape[0], o.device
    no = n // 8
    _check_args("octet round 0", dev, ("o", o, torch.float32, (no * 8, 3)),
                ("d", d, torch.float32, (n, 3)),
                ("t_max", t_max, torch.float32, (n,)),
                ("w_lo", w_lo, torch.float32, (C, 3)),
                ("w_hi", w_hi, torch.float32, (C, 3)),
                ("cl_ok", cl_ok, torch.bool, (C,)),
                _pack_spec("octet round 0", pack))
    e = torch.empty((no, C), dtype=torch.float32, device=dev)
    c0 = torch.empty((no,), dtype=torch.int32, device=dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("rr_octet_round0", o, d, t_max, w_lo, w_hi, cl_ok, pack, e,
                c0, t, idx, no, C)
    launches[1] += 1
    return e, c0, t, idx


def _round1_cuda(o, d, t_max, e, c0, t, idx, pack, mode: str):
    """Launch round 1 (csrc/octet_trace.cu) on the current stream."""
    n, dev = o.shape[0], o.device
    no, C = e.shape
    _check_args("octet round 1", dev, ("o", o, torch.float32, (no * 8, 3)),
                ("d", d, torch.float32, (n, 3)),
                ("t_max", t_max, torch.float32, (n,)),
                ("e", e, torch.float32, (no, C)),
                ("c0", c0, torch.int32, (no,)),
                ("t", t, torch.float32, (n,)),
                ("idx", idx, torch.int32, (n,)),
                _pack_spec("octet round 1", pack))
    t_out = torch.empty((n,), dtype=torch.float32, device=dev)
    i_out = torch.empty((n,), dtype=torch.int32, device=dev)
    slots = torch.empty((no, _R1_SLOTS), dtype=torch.int32, device=dev)
    remaining = torch.empty((no,), dtype=torch.int32, device=dev)
    over = torch.empty((no,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        _launch("rr_octet_round1", o, d, t_max, e, c0, t, idx, pack, t_out,
                i_out, slots, remaining, over, no, C, int(mode == "any"),
                pack.shape[0] - 1)
    launches[_R1_SLOTS] += 1
    return t_out, i_out, over, slots, remaining


def _kernel_or_twin(what, dev, interpret):
    """True for the CUDA kernel, False for the twin; raise elsewhere."""
    if dev.type == "cuda" and not interpret:
        return True
    if dev.type != "cpu" and not interpret:
        raise ValueError(f"{what}: no kernel for device {dev}")
    return False


def round0(o, d, t_max, w_lo, w_hi, cl_ok, pack, interpret: bool = False):
    """Round 0 of a slice (rays dead-masked, n a multiple of 8): the CUDA
    kernel for CUDA tensors, the twin for CPU tensors or ``interpret=True``.
    Returns (e (No, C), c0 (No,) int32, t (n,), idx (n,) int32)."""
    rounds[1] += 1
    if _kernel_or_twin("octet round 0", o.device, interpret):
        return _round0_cuda(o, d, t_max, w_lo, w_hi, cl_ok, pack)
    return _round0_twin(o, d, t_max, w_lo, w_hi, cl_ok, pack)


def round1(o, d, t_max, e, c0, t, idx, pack, mode: str,
           interpret: bool = False):
    """Round 1 over round 0's outputs: the CUDA kernel for CUDA tensors,
    the twin otherwise.  Returns (t (n,), idx (n,) int32, over (No,) bool,
    slots (No, 4) int32, remaining (No,) int32)."""
    rounds[_R1_SLOTS] += 1
    if _kernel_or_twin("octet round 1", o.device, interpret):
        return _round1_cuda(o, d, t_max, e, c0, t, idx, pack, mode)
    return _round1_twin(o, d, t_max, e, c0, t, idx, pack, mode)


# --------------------------------------------------------------------------
# The kernels' decomposition in torch (for the tests)
# --------------------------------------------------------------------------

def _lex_min_lanes(v, i):
    """The kernels' shuffle butterfly: the lexicographic (v, i) minimum over
    the last axis of 32 lanes, as every lane ends with it."""
    lane = torch.arange(_LANES, device=v.device)
    for off in (16, 8, 4, 2, 1):
        ov, oi = v[..., lane ^ off], i[..., lane ^ off]
        take = (ov < v) | ((ov == v) & (oi < i))
        v, i = torch.where(take, ov, v), torch.where(take, oi, i)
    return v[..., 0], i[..., 0]


def _lane_columns(e):
    """e (No, C) -> (No, J, 32): lane l's j-th cluster is j*32 + l (INF
    past C), and the ids alike."""
    no, C = e.shape
    J = -(-C // _LANES)
    v = torch.nn.functional.pad(e, (0, J * _LANES - C), value=INF)
    ids = torch.arange(J * _LANES, dtype=torch.int32, device=e.device)
    return v.reshape(no, J, _LANES), ids.reshape(J, _LANES)


def _slab_hits_lanes(r, slabs):
    """Each ray of r (No, 8, 8) against its octet's slab (No, 16, 128) as
    the warp does it: lane l tests triangles 4l..4l+3 in order (strict
    '<'), then the butterfly.  Returns (t (No, 8), lane of the slab)."""
    no, R, _ = r.shape
    K = slabs.shape[2]
    assert K == 4 * _LANES
    # each triangle as a slab of its own gives every test's t (INF: miss)
    tri = slabs.permute(0, 2, 1).reshape(no * K, 16, 1)
    t_all, _ = slab_test(r.repeat_interleave(K, dim=0), tri)
    t_all = t_all.reshape(no, K, R).permute(0, 2, 1).reshape(
        no, R, _LANES, 4)
    k_lane = 4 * torch.arange(_LANES, dtype=torch.int32, device=r.device)
    bt = torch.full((no, R, _LANES), INF, device=r.device)
    bk = torch.zeros((no, R, _LANES), dtype=torch.int32, device=r.device)
    for q in range(4):
        take = t_all[..., q] < bt
        bt = torch.where(take, t_all[..., q], bt)
        bk = torch.where(take, k_lane + q, bk)
    return _lex_min_lanes(bt, bk)


def _round0_lanes(o, d, t_max, w_lo, w_hi, cl_ok, pack):
    """Round 0 partitioned as csrc/octet_trace.cu::round0_kernel runs it:
    invalid clusters poisoned with a NaN lo.x, lanes striding the
    clusters with their own (entry, id) minimum, the butterfly, then slab
    c0's triangles over the lanes; dead octets skipped.  Same outputs as
    :func:`round0`."""
    no, K = o.shape[0] // 8, pack.shape[2]
    nan = torch.full_like(w_lo[:, 0], float("nan"))
    lo = torch.stack([torch.where(cl_ok, w_lo[:, 0], nan), w_lo[:, 1],
                      w_lo[:, 2]], dim=1)
    eps = 1e-30
    sd = torch.where(torch.abs(d) > eps, d, torch.where(d >= 0, eps, -eps))
    inv = (1.0 / sd)[:, None]                                 # (n, 1, 3)
    oinv = o[:, None] * inv
    t0 = lo[None] * inv - oinv                                # (n, C, 3)
    t1 = w_hi[None] * inv - oinv
    lo_a, hi_a = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(lo_a[..., 0], lo_a[..., 1]),
                       lo_a[..., 2])
    tf = torch.minimum(torch.minimum(hi_a[..., 0], hi_a[..., 1]),
                       hi_a[..., 2])
    entry = torch.maximum(tn, torch.zeros_like(tn))
    ok = (tf >= entry) & (entry <= t_max[:, None])
    e = torch.where(ok, entry, INF).reshape(no, 8, -1).amin(dim=1)
    live = (t_max.reshape(no, 8) >= 0).any(dim=1)
    e = torch.where(live[:, None], e, INF)
    v, ids = _lane_columns(e)
    best = torch.full((no, _LANES), INF, device=o.device)
    best_c = torch.zeros((no, _LANES), dtype=torch.int32, device=o.device)
    for j in range(v.shape[1]):
        take = v[:, j] < best
        best = torch.where(take, v[:, j], best)
        best_c = torch.where(take, ids[j], best_c)
    m0, c0 = _lex_min_lanes(best, best_c)
    t, k = _slab_hits_lanes(_rays(o, d, t_max).reshape(no, 8, 8),
                            pack[c0.long()])
    hit = (m0 < INF)[:, None] & (t < INF)
    t = torch.where(hit, t, INF)
    idx = torch.where(hit, c0[:, None] * K + k, 0)
    return e, c0, t.reshape(-1), idx.reshape(-1)


def _round1_lanes(o, d, t_max, e, c0, t, idx, pack, mode: str):
    """Round 1 partitioned as csrc/octet_trace.cu::round1_kernel runs it:
    lanes striding the filtered e row with a per-lane top 4 (strict '<'
    insertion), four butterfly merges, the non-empty slots' slabs over the
    lanes folded in slot order into round 0's hit; dead octets skipped.
    Same outputs as :func:`round1`."""
    no, K = e.shape[0], pack.shape[2]
    dummy = pack.shape[0] - 1
    dev = e.device
    need = _need(t, t_max, mode)
    live = (t_max.reshape(no, 8) >= 0).any(dim=1)
    v, ids = _lane_columns(e)
    tv = torch.full((no, _LANES, _R1_SLOTS), INF, device=dev)
    ti = torch.zeros((no, _LANES, _R1_SLOTS), dtype=torch.int32, device=dev)
    cnt = torch.zeros((no, _LANES), dtype=torch.int32, device=dev)
    q = torch.arange(_R1_SLOTS, device=dev)
    for j in range(v.shape[1]):
        x = v[:, j]
        x = torch.where((ids[j] == c0[:, None]) | ~(x <= need[:, None]), INF,
                        x)
        cnt += (x < INF).to(torch.int32)
        # strict insertion: x goes before the first entry it is below
        p = (tv <= x[..., None]).sum(dim=-1, keepdim=True)
        prev_v = torch.cat([tv[..., :1], tv[..., :-1]], dim=-1)
        prev_i = torch.cat([ti[..., :1], ti[..., :-1]], dim=-1)
        tv = torch.where(q < p, tv, torch.where(q == p, x[..., None], prev_v))
        ti = torch.where(q < p, ti, torch.where(
            q == p, ids[j][None, :, None], prev_i))
    slots = []
    for _ in range(_R1_SLOTS):
        wv, wi = _lex_min_lanes(tv[..., 0], ti[..., 0])
        ok = (wv < INF) & live
        slots.append(torch.where(ok, wi, dummy))
        pop = (ok[:, None] & (tv[..., 0] == wv[:, None])
               & (ti[..., 0] == wi[:, None]))[..., None]
        tv = torch.where(pop, torch.cat(
            [tv[..., 1:], torch.full_like(tv[..., :1], INF)], dim=-1), tv)
        ti = torch.where(pop, torch.cat(
            [ti[..., 1:], torch.zeros_like(ti[..., :1])], dim=-1), ti)
    slots = torch.stack(slots, dim=1).to(torch.int32)
    remaining = torch.where(live, cnt.sum(dim=1), 0).to(torch.int32)
    bt, bi = t.reshape(no, 8), idx.reshape(no, 8)
    r = _rays(o, d, t_max).reshape(no, 8, 8)
    for s in range(_R1_SLOTS):
        c = slots[:, s]
        ts, ks = _slab_hits_lanes(r, pack[c.long()])
        better = (c != dummy)[:, None] & (ts < bt)
        bt = torch.where(better, ts, bt)
        bi = torch.where(better, c[:, None] * K + ks, bi)
    return (bt.reshape(-1), bi.reshape(-1), remaining > _R1_SLOTS, slots,
            remaining)


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------

def _trace_slice(o, d, alive, t_max, prep, w_lo, w_hi, cl_ok, K, mode,
                 block_n, interpret):
    from .block_trace import trace_tris_blocks

    pack = prep.pallas_pack
    # the pack's last row is all zeros (pack_cluster_tris always appends
    # one) and never a real cluster id: empty slots miss and never collide
    e, c0, t, idx = round0(o, d, t_max, w_lo, w_hi, cl_ok, pack, interpret)
    t, idx, over, _, _ = round1(o, d, t_max, e, c0, t, idx, pack, mode,
                                interpret)

    # octets with more than _R1_SLOTS filtered clusters left re-trace
    # through the always-complete block walk (rare; exactness is kept),
    # gated as the JAX lax.cond is
    over_r = over.repeat_interleave(8) & alive
    n = o.shape[0]

    def walk():
        fallback["calls"] += 1
        graphs.count_on_device(fallback, "rays", over_r.sum())
        _, fb_i, fb_t = trace_tris_blocks(o, d, over_r, t_max, prep, w_lo,
                                          w_hi, cl_ok, K, block_n=block_n,
                                          mode=mode, interpret=interpret)
        return fb_i, fb_t

    fb_i, fb_t = graphs.cond(
        over_r, walk,
        lambda: (torch.zeros((n,), dtype=torch.int32, device=o.device),
                 torch.full((n,), INF, device=o.device)), "fallback")
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
    and uses occlusion to collapse the round-1 need filter.  Selection
    only: the inputs are detached, as the JAX package's ``stop_gradient``s
    do; gradients of t go through ops/traverse.selected_t."""
    from .block_trace import DEAD_ORIGIN

    if prep.pallas_pack is None:
        raise ValueError("trace_tris_octets requires prep.pallas_pack")
    o, d, w_lo, w_hi = o.detach(), d.detach(), w_lo.detach(), w_hi.detach()
    t_max = None if t_max is None else t_max.detach()
    prep = prep.replace(pallas_pack=prep.pallas_pack.detach())
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
        f, i, t = graphs.cond(
            a_sl,
            lambda: _trace_slice(o[s0:s1], d[s0:s1], a_sl, t_max[s0:s1],
                                 prep, w_lo, w_hi, cl_ok, cluster_size,
                                 mode, block_n, interpret),
            lambda: (torch.zeros((sl,), dtype=torch.bool, device=dev),
                     torch.zeros((sl,), dtype=torch.int32, device=dev),
                     torch.full((sl,), INF, device=dev)),
            "slice")
        founds.append(f)
        idxs.append(i)
        ts.append(t)
    return (torch.cat(founds)[:n], torch.cat(idxs)[:n],
            torch.cat(ts)[:n])
