"""Cost isolation of a per-octet walk on the card: the K4 variants.

Port of ``tools/octet_kernel_bench.py``.  Over the level-3 closest
wavefront of the bench frame's middle chunk (``capture_waves``), each
variant runs the
octet's exact (8, cpad) slab test and then:

- ``v1``: nothing more (slab test only; writes INF / 0);
- ``v2``, ``v2u``, ``v2u8``: intersects clusters 0..15 by index, in a loop
  unrolled 1, 16 and 8 times;
- ``v3``: also takes the entry row's 16 argmin-and-mask passes, but still
  intersects cluster ``step``;
- ``v4``: intersects the clusters those passes chose.

The kernel is ``csrc/octet_bench.cu`` (one template, the variant and the
unroll factor as its parameters; one warp per octet); :func:`_bench_twin`
is its plain torch version with the same contract, and
:func:`_bench_lanes` the kernel's warp and lane decomposition in torch.
The bench checks every variant's kernel against its twin bit for bit (t
and idx) and prints, per variant, the kernel's ms (CUDA events) against
the twin's ms and its bound.

Usage (from the repository root, on a machine with a CUDA card):

    python -m rustray_tpu_torch.tools.octet_kernel_bench [waves.npz] \
        [--old OLD_OCTET_BENCH_CU]

Without the .npz (default ``rustray_tpu_torch/_build/waves.npz``) it
captures the wavefront first.  Given ``--old``, the path of an earlier
``octet_bench.cu`` with the same C interface ``rr_octet_bench``, it builds
that source with the same nvcc flags, checks it against the twin too and
times both designs in turns (old, new, new, old; 5 launches each).  It
ends with round 0 of the octet rounds (``ops/octet_trace.round0``) timed
on the same sorted rays, beside v1 scaled by C / cpad: round 0 is v1's
entry pass plus the e write, the argmin and slab c0.  Each result is one
JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..ops.block_trace import slab_test
from ..ops.intersect import INF

_BIG = 3.0e37
VARIANTS = ("v1", "v2", "v2u", "v2u8", "v3", "v4")
_CODE = {v: i + 1 for i, v in enumerate(VARIANTS)}
_VISITS = 16
_LANES = 32
# FP32 operations of one ray x cluster entry: 6 products, 6 differences,
# 6 min/max per axis, 6 folds into tn and tf, the clamp, 2 comparisons,
# the octet minimum
ENTRY_OPS = 28

# kernel launches per variant; only the launch in _bench_cuda counts
launches = {v: 0 for v in VARIANTS}


def reset_launches() -> None:
    for v in VARIANTS:
        launches[v] = 0


def aabb_table(w_lo, w_hi, cl_ok):
    """The (8, cpad) cluster-AABB table of the JAX bench: rows lo.xyz,
    hi.xyz and two zero rows; disabled clusters and the padding get an
    inverted box (lo = BIG, hi = -BIG); the two zero rows pad with BIG."""
    C = w_lo.shape[0]
    cpad = -(-C // 128) * 128
    lo = torch.where(cl_ok[:, None], w_lo, _BIG)
    hi = torch.where(cl_ok[:, None], w_hi, -_BIG)
    tab = torch.cat([lo.T, hi.T, torch.zeros((2, C), device=w_lo.device)])
    tab = torch.nn.functional.pad(tab, (0, cpad - C), value=_BIG)
    tab[3:6, C:] = -_BIG
    return tab.contiguous()


def bench_inputs(waves, sa, boxes, level: int = 3):
    """(nlive (1,) i32, rays (n, 8), aabb (8, cpad)) from the captured
    closest wavefront of ``level``, coherence-sorted and dead-masked as
    the JAX bench does."""
    from ..ops.block_trace import DEAD_ORIGIN, coherence_key
    dev = sa.verts.device
    w_lo, w_hi = boxes
    cl_ok = sa.cl_valid & sa.inst_visible[sa.cl_inst.long()]
    o = torch.as_tensor(waves[f"closest_{level}_o"], device=dev)
    d = torch.as_tensor(waves[f"closest_{level}_d"], device=dev)
    alive = torch.as_tensor(waves[f"closest_{level}_alive"], device=dev)
    lo = torch.amin(torch.where(cl_ok[:, None], w_lo, INF), dim=0)
    hi = torch.amax(torch.where(cl_ok[:, None], w_hi, -INF), dim=0)
    perm = torch.argsort(coherence_key(o, d, alive, lo, hi), stable=True)
    o, d, alive = o[perm], d[perm], alive[perm]
    o = torch.where(alive[:, None], o, DEAD_ORIGIN)
    d = torch.where(alive[:, None], d, 1.0)
    tmax = torch.where(alive, INF, -1.0)
    rays = torch.cat([o, d, tmax[:, None], torch.zeros_like(tmax)[:, None]],
                     dim=1).contiguous()
    live = torch.nonzero(alive).squeeze(1)
    n_live = int(-(-(int(live.max()) + 1) // 8)) if live.numel() else 0
    nlive = torch.tensor([n_live], dtype=torch.int32, device=dev)
    return nlive, rays, aabb_table(w_lo, w_hi, cl_ok)


def probe_inputs(sa, boxes, n: int, seed: int = 0):
    """Inputs on which every variant finds hits, for checking a kernel
    against its twin: octet r's 8 rays leave the centre of cluster
    (r mod 16)'s box in random directions, so clusters 0..15 hold hits
    and the entry row's argmin names real clusters (each octet's origin
    lies inside them).  Returns (nlive, rays (n, 8), aabb)."""
    dev = sa.verts.device
    w_lo, w_hi = boxes
    cl_ok = sa.cl_valid & sa.inst_visible[sa.cl_inst.long()]
    g = torch.Generator().manual_seed(seed)
    centre = ((w_lo[:16] + w_hi[:16]) / 2).cpu()
    o = centre[(torch.arange(n) // 8) % centre.shape[0]]
    d = torch.randn((n, 3), generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    rays = torch.cat([o, d, torch.full((n, 1), INF), torch.zeros((n, 1))],
                     dim=1).to(dev).contiguous()
    nlive = torch.tensor([n // 8], dtype=torch.int32, device=dev)
    return nlive, rays, aabb_table(w_lo, w_hi, cl_ok)


def _entries(r, aabb):
    """Entry rows e (No, cpad) of octet rays r (No, 8, 8): per ray and
    cluster the exact slab entry (tn from -BIG and tf from BIG folded over
    the axes, clamped at 0; INF unless tf >= entry <= t_max), the minimum
    over the octet's 8 rays."""
    o3, d3, tmax = r[..., 0:3], r[..., 3:6], r[..., 6:7]      # (No, 8, .)
    eps = 1e-30
    sd = torch.where(torch.abs(d3) > eps, d3,
                     torch.where(d3 >= 0, eps, -eps))
    inv = 1.0 / sd
    oinv = o3 * inv
    shape = (r.shape[0], 8, aabb.shape[1])
    tn = torch.full(shape, -_BIG, device=r.device)
    tf = torch.full(shape, _BIG, device=r.device)
    for a in range(3):
        ia, oa = inv[..., a:a + 1], oinv[..., a:a + 1]
        t0 = aabb[a] * ia - oa
        t1 = aabb[3 + a] * ia - oa
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    entry = torch.clamp(tn, min=0.0)
    ok = (tf >= entry) & (entry <= tmax)
    return torch.where(ok, entry, INF).amin(dim=1)


def _picks(e):
    """The 16 argmin-and-mask passes over e (No, cpad): each takes the
    lowest index of the row's minimum and sets that entry to INF.
    Returns (No, 16) int64."""
    cpad = e.shape[1]
    lane_c = torch.arange(cpad, device=e.device)
    out = []
    for _ in range(_VISITS):
        m = e.amin(dim=1, keepdim=True)
        cv = torch.where(e == m, lane_c, cpad).amin(dim=1)
        e = torch.where(lane_c == cv[:, None], INF, e)
        out.append(cv)
    return torch.stack(out, dim=1)


def _columns(variant, picks, no, cpad, n_pack, dev):
    """(No, 16) clusters each visit reads: 0..15 for v2/v3, the picks
    clamped to cpad - 1 for v4; past the pack's last row a dynamic index
    clamps, as in the JAX interpreter."""
    if variant == "v4":
        cols = torch.clamp(picks, max=cpad - 1)
    else:
        cols = torch.arange(_VISITS, device=dev).expand(no, _VISITS)
    return torch.clamp(cols, max=n_pack - 1)


def _bench_twin(nlive, rays, aabb, pack, variant: str):
    """Plain torch version of the bench kernel with its contract (see
    csrc/octet_bench.cu).  Returns (t (n,) — INF on miss, idx (n,) int32)."""
    no = rays.shape[0] // 8
    cpad, (n_pack, _, K) = aabb.shape[1], pack.shape
    dev = rays.device
    r = rays.reshape(no, 8, 8)
    e = _entries(r, aabb)
    bt = torch.full((no, 8), INF, device=dev)
    bi = torch.zeros((no, 8), dtype=torch.int32, device=dev)
    if variant != "v1":
        picks = _picks(e) if variant in ("v3", "v4") else None
        cols = _columns(variant, picks, no, cpad, n_pack, dev)
        for jg in range(_VISITS):
            c = cols[:, jg]
            tmin, within = slab_test(r, pack[c])              # (No, 8)
            better = tmin < bt
            bt = torch.where(better, tmin, bt)
            bi = torch.where(better, c[:, None].to(torch.int32) * K + within,
                             bi)
    live = (torch.arange(no, device=dev) < nlive[0])[:, None]
    return (torch.where(live, bt, INF).reshape(-1),
            torch.where(live, bi, 0).reshape(-1))


# --------------------------------------------------------------------------
# The kernel's decomposition in torch (for the tests)
# --------------------------------------------------------------------------

def _picks_lanes(e):
    """The 16 passes as the warp takes them (csrc/octet_bench.cu::
    Candidates and select16): lane l offers clusters l, l + 32, ... in
    order; each keeps its first 16 (entry, id) below INF by strict
    insertion (an entry is at most BIG or INF); 16 butterfly minima over
    the lists' heads, each popped by its owner, while entries below INF
    last; every later pass takes cluster 0, as the twin's row is INF
    throughout by then.  Same result as :func:`_picks`."""
    from ..ops.octet_trace import _lane_columns, _lex_min_lanes
    no, dev = e.shape[0], e.device
    v, ids = _lane_columns(e)
    tv = torch.full((no, _LANES, _VISITS), INF, device=dev)
    ti = torch.zeros((no, _LANES, _VISITS), dtype=torch.int32, device=dev)
    q = torch.arange(_VISITS, device=dev)
    for j in range(v.shape[1]):
        x, c = v[:, j], ids[j]
        ins = x < tv[..., -1]             # the padding past cpad is INF
        # strict insertion: x goes after every entry it is not below
        p = (tv <= x[..., None]).sum(dim=-1, keepdim=True)
        prev_v = torch.cat([tv[..., :1], tv[..., :-1]], dim=-1)
        prev_i = torch.cat([ti[..., :1], ti[..., :-1]], dim=-1)
        new_v = torch.where(q < p, tv, torch.where(q == p, x[..., None],
                                                   prev_v))
        new_i = torch.where(q < p, ti, torch.where(q == p, c[:, None],
                                                   prev_i))
        tv = torch.where(ins[..., None], new_v, tv)
        ti = torch.where(ins[..., None], new_i, ti)
    picks = []
    going = torch.ones((no,), dtype=torch.bool, device=dev)
    for _ in range(_VISITS):
        wv, wi = _lex_min_lanes(tv[..., 0], ti[..., 0])
        going = going & (wv < INF)
        picks.append(torch.where(going, wi, 0))
        pop = (going[:, None] & (tv[..., 0] == wv[:, None])
               & (ti[..., 0] == wi[:, None]))[..., None]
        tv = torch.where(pop, torch.cat(
            [tv[..., 1:], torch.full_like(tv[..., :1], INF)], dim=-1), tv)
        ti = torch.where(pop, torch.cat(
            [ti[..., 1:], torch.zeros_like(ti[..., :1])], dim=-1), ti)
    return torch.stack(picks, dim=1).to(torch.int64)


def _bench_lanes(nlive, rays, aabb, pack, variant: str):
    """The bench partitioned as csrc/octet_bench.cu runs it: the entry
    rows, the selection through the lanes' candidate lists
    (:func:`_picks_lanes`); in each visit lane l tests triangles l + 32 q
    (q = 0..3) against the 8 rays and keeps per ray its nearest hit over
    all visits with the key visit * K + triangle (strict '<'); after the
    last visit one (t, key) butterfly per ray.  Same outputs as
    :func:`_bench_twin`; K must be 128."""
    from ..ops.octet_trace import _lex_min_lanes
    no = rays.shape[0] // 8
    cpad, (n_pack, _, K) = aabb.shape[1], pack.shape
    assert K == 4 * _LANES
    dev = rays.device
    r = rays.reshape(no, 8, 8)
    e = _entries(r, aabb)
    bt = torch.full((no, 8), INF, device=dev)
    bi = torch.zeros((no, 8), dtype=torch.int32, device=dev)
    if variant != "v1":
        picks = _picks_lanes(e) if variant in ("v3", "v4") else None
        cols = _columns(variant, picks, no, cpad, n_pack, dev)
        lane = torch.arange(_LANES, dtype=torch.int32, device=dev)
        lt = torch.full((no, 8, _LANES), INF, device=dev)
        lk = torch.zeros((no, 8, _LANES), dtype=torch.int32, device=dev)
        for jg in range(_VISITS):
            # every (ray, triangle) test's t: each triangle a slab of its own
            tri = pack[cols[:, jg]].permute(0, 2, 1).reshape(no * K, 16, 1)
            t_all, _ = slab_test(r.repeat_interleave(K, dim=0), tri)
            t_all = t_all.reshape(no, K, 8).permute(0, 2, 1)   # (No, 8, K)
            for q in range(4):
                t = t_all[..., q * _LANES:(q + 1) * _LANES]
                take = t < lt
                lt = torch.where(take, t, lt)
                lk = torch.where(take, jg * K + q * _LANES + lane, lk)
        t, key = _lex_min_lanes(lt, lk)                        # (No, 8)
        cid = cols.gather(1, (key // K).long()).to(torch.int32)
        bt = t
        bi = torch.where(t < INF, cid * K + key % K, 0)
    live = (torch.arange(no, device=dev) < nlive[0])[:, None]
    return (torch.where(live, bt, INF).reshape(-1),
            torch.where(live, bi, 0).reshape(-1))


# --------------------------------------------------------------------------
# The kernel
# --------------------------------------------------------------------------

def _launch(lib, nlive, rays, aabb, pack, variant: str):
    """One launch of ``rr_octet_bench`` from ``lib`` on the current stream,
    after checking the inputs.  Returns (t (n,), idx (n,) int32)."""
    n = rays.shape[0]
    cpad = aabb.shape[1]
    n_pack, _, K = pack.shape
    for name, x, dtype, shape in (
            ("nlive", nlive, torch.int32, (1,)),
            ("rays", rays, torch.float32, (n, 8)),
            ("aabb", aabb, torch.float32, (8, cpad)),
            ("pack", pack, torch.float32, (n_pack, 16, K))):
        if x.device != rays.device or x.dtype != dtype \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"octet bench: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape} on "
                             f"{rays.device}; got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if n % 8:
        raise ValueError("octet bench: the ray count must be a multiple of 8")
    if K != 128:
        raise ValueError(f"octet bench: the kernel takes slabs of 128 "
                         f"triangles; got K={K}")
    if rays.data_ptr() % 16 or pack.data_ptr() % 16:
        raise ValueError("octet bench: rays and pack must be 16-byte aligned")
    fn = lib.rr_octet_bench
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    t_out = torch.empty((n,), dtype=torch.float32, device=rays.device)
    idx_out = torch.empty((n,), dtype=torch.int32, device=rays.device)
    with torch.cuda.device(rays.device):
        err = fn(_CODE[variant], nlive.data_ptr(), rays.data_ptr(),
                 aabb.data_ptr(), pack.data_ptr(), t_out.data_ptr(),
                 idx_out.data_ptr(), n // 8, cpad, K, n_pack,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"octet bench kernel launch failed: CUDA error "
                           f"{err}")
    return t_out, idx_out


def _bench_cuda(nlive, rays, aabb, pack, variant: str):
    """Launch the bench kernel (csrc/octet_bench.cu) on the current
    stream.  Returns (t (n,), idx (n,) int32)."""
    from ..build import load_kernel_lib
    out = _launch(load_kernel_lib("octet_bench"), nlive, rays, aabb, pack,
                  variant)
    launches[variant] += 1
    return out


def bench_kernel(nlive, rays, aabb, pack, variant: str,
                 interpret: bool = False):
    """One variant: the CUDA kernel for CUDA tensors, the torch twin for
    CPU tensors or ``interpret=True``."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}; got "
                         f"{variant!r}")
    if rays.device.type == "cuda" and not interpret:
        return _bench_cuda(nlive, rays, aabb, pack, variant)
    if rays.device.type != "cpu" and not interpret:
        raise ValueError(f"octet bench: no kernel for device {rays.device}")
    return _bench_twin(nlive, rays, aabb, pack, variant)


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls after one warm-up,
    by CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def check(nlive, rays, aabb, pack, variant: str):
    """One variant's kernel against its twin on the same inputs, bit for
    bit: t and idx equal (torch.equal); raises otherwise.  Returns
    dict(found, hits, max_abs_err): the share of equal found masks (1.0),
    the kernel's hits and its max |dt| (0.0)."""
    got = bench_kernel(nlive, rays, aabb, pack, variant)
    want = bench_kernel(nlive, rays, aabb, pack, variant, interpret=True)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError(
            f"octet bench {variant}: kernel and twin differ in "
            f"{int((got[0] != want[0]).sum())} t and "
            f"{int((got[1] != want[1]).sum())} idx entries")
    return dict(found=1.0, hits=int((got[0] < INF).sum()), max_abs_err=0.0)


def time_variants(nlive, rays, aabb, pack, iters: int = 5):
    """The bench proper: ms per launch of every variant's kernel."""
    return {v: cuda_ms(lambda v=v: bench_kernel(nlive, rays, aabb, pack, v),
                       iters) for v in VARIANTS}


def bench_work(nlive, rays, aabb, pack, variant: str):
    """What a variant needs on these inputs: ENTRY_OPS per ray x cluster
    entry of the live octets; past v1, 16 visits of 8 rays x K triangles
    (31 FP32 operations a test); in v3/v4 one comparison per entry for the
    selection.  Bytes: the live octets' rays, the box table's 6 rows, the
    visited slabs' 12 rows once (none in v1; clusters 0..15 in v2/v3; the
    distinct chosen clusters of the live octets in v4), t and idx out.
    Returns (tests, bound_ms, bound_by)."""
    from .walk_compare import FLOPS_PER_TEST, bound
    n = rays.shape[0]
    octets = max(0, min(int(nlive[0]), n // 8))
    cpad = aabb.shape[1]
    n_pack, _, K = pack.shape
    tests = 0 if variant == "v1" else octets * _VISITS * 8 * K
    flops = (octets * 8 * cpad * ENTRY_OPS + tests * FLOPS_PER_TEST
             + (octets * cpad if variant in ("v3", "v4") else 0))
    if variant == "v1":
        slabs = 0
    elif variant == "v4":
        r = rays[:octets * 8].reshape(octets, 8, 8)
        cols = _columns("v4", _picks(_entries(r, aabb)), octets, cpad,
                        n_pack, rays.device)
        slabs = int(torch.unique(cols).numel())
    else:
        slabs = min(_VISITS, n_pack)
    nbytes = octets * 8 * 32 + 6 * cpad * 4 + slabs * 12 * K * 4 + n * 8
    return (tests, *bound(flops, nbytes))


def main(argv=None) -> int:
    from ..scene_arrays import to_torch
    from ..render.wavefront import prepare_frame
    from ..config import EngineConfig
    from ..ops import octet_trace as ot
    from .capture_waves import DEFAULT_OUT, capture, load_bench_scene
    from .walk_compare import build_source
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("waves", nargs="?", default=DEFAULT_OUT)
    ap.add_argument("--old", default=None,
                    help="an earlier octet_bench.cu to time in turns")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("octet_kernel_bench: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    old = build_source(args.old, "octet_bench_old") if args.old else None
    scene = load_bench_scene(1280, 720)
    sa, static = to_torch(*scene.compile(), "cuda")
    cfg = scene.raytracing_config
    cfg.samples = 1
    if os.path.exists(args.waves):
        waves = dict(np.load(args.waves))
    else:
        waves = capture(sa, static, cfg)
    prep, boxes = prepare_frame(sa, static, EngineConfig(chunk_pixels=32768))
    nlive, rays, aabb = bench_inputs(waves, sa, boxes)
    pack = prep.pallas_pack
    cpad = aabb.shape[1]
    print(json.dumps(dict(live_octets=int(nlive[0]),
                          octets=rays.shape[0] // 8, cpad=cpad)))
    v1_ms = None
    for v in VARIANTS:
        row = dict(variant=v, **check(nlive, rays, aabb, pack, v))
        row["tests"], row["bound_ms"], row["bound_by"] = bench_work(
            nlive, rays, aabb, pack, v)
        row["twin_ms"] = cuda_ms(lambda: bench_kernel(
            nlive, rays, aabb, pack, v, interpret=True), 2)

        def run_new():
            bench_kernel(nlive, rays, aabb, pack, v)
        if old is not None:
            want = bench_kernel(nlive, rays, aabb, pack, v, interpret=True)
            got = _launch(old, nlive, rays, aabb, pack, v)
            torch.cuda.synchronize()
            row["old_equal_twin"] = bool(torch.equal(got[0], want[0])
                                         and torch.equal(got[1], want[1]))

            def run_old():
                _launch(old, nlive, rays, aabb, pack, v)
            o1 = cuda_ms(run_old, 5)
            n1 = cuda_ms(run_new, 5)
            n2 = cuda_ms(run_new, 5)
            o2 = cuda_ms(run_old, 5)
            row.update(old_ms=[o1, o2], new_ms=[n1, n2])
        else:
            row["new_ms"] = [cuda_ms(run_new, 5)]
        ms = sum(row["new_ms"]) / len(row["new_ms"])
        row["share_of_bound"] = row["bound_ms"] / ms
        if v == "v1":
            v1_ms = ms
        print(json.dumps(row))
    # round 0 of the octet rounds on the same sorted rays: the entry pass
    # over C clusters, the e write, the argmin and slab c0
    C = boxes[0].shape[0]
    cl_ok = sa.cl_valid & sa.inst_visible[sa.cl_inst.long()]
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    tmax = rays[:, 6].contiguous()
    r0_ms = cuda_ms(lambda: ot.round0(o, d, tmax, *boxes, cl_ok, pack), 5)
    v1_c = v1_ms * C / cpad
    print(json.dumps(dict(round0_ms=r0_ms, clusters=C, v1_ms=v1_ms,
                          v1_scaled_ms=v1_c, round0_rest_ms=r0_ms - v1_c)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
