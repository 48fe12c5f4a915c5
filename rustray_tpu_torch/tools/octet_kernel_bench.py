"""Cost isolation of a per-octet walk on the card: the K4 variants.

Port of ``tools/octet_kernel_bench.py``.  Over the level-3 closest
wavefront of the bench frame's middle chunk (``capture_waves``), each
variant runs the
octet's exact (8, cpad) slab test and then:

- ``v1``: nothing more (slab test only; writes INF / 0);
- ``v2``, ``v2u``, ``v2u8``: intersects clusters 0..15 by index, in a loop
  unrolled 1, 16 and 8 times;
- ``v3``: also takes and masks the entry row's argmin at each of the 16
  steps, but still intersects cluster ``step``;
- ``v4``: intersects the argmin cluster itself.

The kernel is ``csrc/octet_bench.cu`` (one template, the variant and the
unroll factor as its parameters); :func:`_bench_twin` is its plain torch
version with the same contract.  The bench prints, per variant, the
kernel's ms (CUDA events) against the twin's ms.

Usage (from the repository root, on a machine with a CUDA card):

    python -m rustray_tpu_torch.tools.octet_kernel_bench [waves.npz]

Without the .npz (default ``rustray_tpu_torch/_build/waves.npz``) it
captures the wavefront first.
"""
from __future__ import annotations

import ctypes
import os
import sys

import numpy as np
import torch

from ..ops.block_trace import slab_test
from ..ops.intersect import INF

_BIG = 3.0e37
VARIANTS = ("v1", "v2", "v2u", "v2u8", "v3", "v4")
_CODE = {v: i + 1 for i, v in enumerate(VARIANTS)}
_VISITS = 16

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


def _bench_twin(nlive, rays, aabb, pack, variant: str):
    """Plain torch version of the bench kernel with its contract (see
    csrc/octet_bench.cu).  Returns (t (n,) — INF on miss, idx (n,) int32)."""
    n = rays.shape[0]
    no = n // 8
    cpad = aabb.shape[1]
    n_pack, _, K = pack.shape
    dev = rays.device
    r = rays.reshape(no, 8, 8)
    o3, d3, tmax = r[..., 0:3], r[..., 3:6], r[..., 6:7]      # (No, 8, .)
    eps = 1e-30
    sd = torch.where(torch.abs(d3) > eps, d3,
                     torch.where(d3 >= 0, eps, -eps))
    inv = 1.0 / sd
    oinv = o3 * inv
    tn = torch.full((no, 8, cpad), -_BIG, device=dev)
    tf = torch.full((no, 8, cpad), _BIG, device=dev)
    for a in range(3):
        ia, oa = inv[..., a:a + 1], oinv[..., a:a + 1]
        t0 = aabb[a] * ia - oa
        t1 = aabb[3 + a] * ia - oa
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    entry = torch.clamp(tn, min=0.0)
    ok = (tf >= entry) & (entry <= tmax)
    e = torch.where(ok, entry, INF).amin(dim=1)               # (No, cpad)

    bt = torch.full((no, 8), INF, device=dev)
    bi = torch.zeros((no, 8), dtype=torch.int32, device=dev)
    if variant != "v1":
        lane_c = torch.arange(cpad, device=dev)
        for jg in range(_VISITS):
            c = torch.full((no,), jg, dtype=torch.long, device=dev)
            if variant in ("v3", "v4"):
                m = e.amin(dim=1, keepdim=True)
                cv = torch.where(e == m, lane_c, cpad).amin(dim=1)
                e = torch.where(lane_c == cv[:, None], INF, e)
                if variant == "v4":
                    c = torch.clamp(cv, max=cpad - 1)
            # a dynamic index past the pack clamps, as in the JAX
            # interpreter
            c = torch.clamp(c, max=n_pack - 1)
            tmin, within = slab_test(r, pack[c])              # (No, 8)
            gidx = c[:, None].to(torch.int32) * K + within
            better = tmin < bt
            bt = torch.where(better, tmin, bt)
            bi = torch.where(better, gidx, bi)
    live = (torch.arange(no, device=dev) < nlive[0])[:, None]
    return (torch.where(live, bt, INF).reshape(-1),
            torch.where(live, bi, 0).reshape(-1))


def _bench_cuda(nlive, rays, aabb, pack, variant: str):
    """Launch the bench kernel (csrc/octet_bench.cu) on the current
    stream.  Returns (t (n,), idx (n,) int32)."""
    from ..build import load_kernel_lib
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
    fn = load_kernel_lib("octet_bench").rr_octet_bench
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
    launches[variant] += 1
    return t_out, idx_out


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
    """One variant's kernel against its twin on the same inputs.  Returns
    dict(found, hits, max_abs_err); raises if they disagree (found masks
    under 99.9% equal, or the t of rays both find beyond rtol 1e-4,
    atol 1e-5)."""
    t_k, _ = bench_kernel(nlive, rays, aabb, pack, variant)
    t_p, _ = bench_kernel(nlive, rays, aabb, pack, variant, interpret=True)
    torch.cuda.synchronize()
    f_k, f_p = t_k < INF, t_p < INF
    found = (f_k == f_p).float().mean().item()
    both = f_k & f_p
    err = (t_k - t_p).abs()[both].max().item() if both.any() else 0.0
    if found < 0.999 or not torch.allclose(t_k[both], t_p[both], rtol=1e-4,
                                           atol=1e-5):
        raise RuntimeError(f"octet bench {variant}: kernel and twin disagree "
                           f"(found masks equal on {found:.5f}, max|dt| "
                           f"{err:.3g})")
    return dict(found=found, hits=int(f_k.sum()), max_abs_err=err)


def time_variants(nlive, rays, aabb, pack, iters: int = 5):
    """The bench proper: ms per launch of every variant's kernel."""
    return {v: cuda_ms(lambda v=v: bench_kernel(nlive, rays, aabb, pack, v),
                       iters) for v in VARIANTS}


def main(argv=None) -> int:
    from ..scene_arrays import to_torch
    from ..render.wavefront import prepare_frame
    from ..config import EngineConfig
    from .capture_waves import DEFAULT_OUT, capture, load_bench_scene
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("octet_kernel_bench: needs a CUDA card", file=sys.stderr)
        return 1
    scene = load_bench_scene(1280, 720)
    sa, static = to_torch(*scene.compile(), "cuda")
    cfg = scene.raytracing_config
    cfg.samples = 1
    path = argv[0] if argv else DEFAULT_OUT
    if os.path.exists(path):
        waves = dict(np.load(path))
    else:
        waves = capture(sa, static, cfg)
    prep, boxes = prepare_frame(sa, static, EngineConfig(chunk_pixels=32768))
    nlive, rays, aabb = bench_inputs(waves, sa, boxes)
    pack = prep.pallas_pack
    print(f"live octets: {int(nlive[0])} of {rays.shape[0] // 8}")
    for v, ms in time_variants(nlive, rays, aabb, pack).items():
        row = check(nlive, rays, aabb, pack, v)
        plain = cuda_ms(lambda: bench_kernel(nlive, rays, aabb, pack, v,
                                             interpret=True), 2)
        print(f"{v}: kernel {ms:.3f} ms, twin {plain:.3f} ms, found masks "
              f"equal {row['found']:.5f}, max|dt| {row['max_abs_err']:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
