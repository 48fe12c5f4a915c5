"""The block walk at the bench shapes: its inputs, its work and bound, and
a timing against an earlier build of its CUDA source.

The inputs are those of ``chip_smoke.py`` phase 3: the primary rays of the
1280x720 bench frame's middle chunk (32,768 rays) and their level-1 shadow
rays, coherence-sorted, in blocks of 128.  :func:`walk_work` counts what
the serial walk needs on them (entries visited, listed quads, ray x
triangle tests, bytes) and the least time the card could take for it;
:func:`list_work` counts the same for the list test that builds the visit
lists.

Usage (repository root, one CUDA card):

    python -m rustray_tpu_torch.tools.walk_compare [OLD_BLOCK_TRACE_CU]

It checks the walk (gated K1 and ungated K2, closest and any-hit) against
its twin and prints its time and bound per launch.  Given the path of an
earlier ``block_trace.cu`` with the one-pass C interface
``rr_block_trace(count, rays, order, entry, pack, t, idx, nb, bn, cpad, K,
any_mode, gated, stream)``, it builds that source with the same nvcc
flags, checks it against the twin too, and times both in turns (old, new,
new, old).  Each launch's result is printed as one JSON line.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys

import torch

CHUNK = 32768
BLOCK = 128
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W)
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# flops of one ray x triangle test: d.n 5, o.n 5, the subtraction and
# the division 2, the hit point 6, u 6, v 6, u + v 1
FLOPS_PER_TEST = 31


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the FP32 time and the bytes
    time at the card's published peaks."""
    f_ms = flops / FP32_FLOPS * 1e3
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (f_ms, "operations") if f_ms >= b_ms else (b_ms, "bytes")


def level1_rays(sa, static, prep, boxes, cfg, engine):
    """Primary rays of the frame's middle chunk (the top chunks see mostly
    sky) at sample cell 0, and their level-1 shadow rays (light-major, as
    the renderer batches them; no jitter)."""
    from ..ops import rays as rays_ops
    from ..ops.intersect import INF, dot, safe_normalize
    from ..ops.traverse import hit_attributes, trace_closest
    from ..utils.mathutil import sample_cell_size, sample_pattern
    dev = sa.verts.device
    n_pix = static.width * static.height
    start = n_pix // 2 // CHUNK * CHUNK
    idx = torch.arange(start, start + CHUNK, device=dev) % n_pix
    cell = sample_pattern(cfg.samples, engine.seed)[0]
    o, d = rays_ops.primary_rays(
        sa.camera, static.width, static.height,
        (idx % static.width).to(torch.int32),
        (idx // static.width).to(torch.int32), int(cell[0]), int(cell[1]),
        sample_cell_size(cfg.samples), cfg.aperture_size, cfg.focal_length,
        cfg.samples)
    d = safe_normalize(d)
    alive = torch.ones((CHUNK,), dtype=torch.bool, device=dev)
    hit = trace_closest(sa, static, prep, o, d, for_shadow=False,
                        allow_reflection_only=False, accel_boxes=boxes,
                        accel_impl="pallas", alive=alive,
                        block_n=engine.pallas_block, pallas_algo="block")
    attrs = hit_attributes(sa, static, prep, o, d, hit)
    lights = sa.lights
    is_dir = (lights.kind == 0)[None, :]
    to_light = lights.pos[None] - attrs.point[:, None]
    dtl = torch.where(is_dir[..., None], safe_normalize(-lights.dir)[None],
                      safe_normalize(to_light))
    ldist = torch.sqrt(torch.clamp(dot(to_light, to_light), min=1e-12))
    L = lights.pos.shape[0]
    sh_o = (attrs.point + attrs.normal * 1e-3)[None].expand(L, CHUNK, 3)
    sh_d = dtl.transpose(0, 1)
    sh_alive = (hit.hit[None] & lights.enabled[:, None])
    sh_tmax = torch.where(is_dir, INF, ldist).transpose(0, 1)
    return ((o, d, alive, None),
            (sh_o.reshape(-1, 3), sh_d.reshape(-1, 3), sh_alive.reshape(-1),
             sh_tmax.reshape(-1)))


def sorted_sets(sa, boxes, ray_sets):
    """The ray sets as the walks see them: coherence-sorted, with the
    scene-exit cap.  Returns [(name, mode, o, d, alive, t_max, cl_ok)]."""
    from ..ops.traverse import coherence_sort, instance_mask
    w_lo, w_hi = boxes
    out = []
    for name, (o, d, alive, t_max), for_shadow in zip(
            ("primary", "shadow"), ray_sets, (False, True)):
        inst_ok = instance_mask(sa, for_shadow, False)
        cl_ok = sa.cl_valid & inst_ok[sa.cl_inst.long()]
        _, o_s, d_s, alive_s, tmax_s = coherence_sort(o, d, alive, t_max,
                                                      w_lo, w_hi, cl_ok)
        out.append((name, "any" if for_shadow else "closest", o_s, d_s,
                    alive_s, tmax_s, cl_ok))
    return out


def walk_work(lists, visited, K: int, gated: bool):
    """What the serial walk needs on ``lists`` (count, rays, order, entry)
    given the entries each block visited (a prefix of its list): entries
    visited (sum, median, max per block), listed quads, ray x triangle
    tests (listed quads, or all four ungated, x BN/4 rays x K per visited
    entry), the bytes it must move (rays, visited descriptors and
    distances, each visited cluster's 12 slab rows once, t and idx out)
    and its bound."""
    count, rays, order, _ = lists
    nb, bn, _ = rays.shape
    pos = torch.arange(order.shape[1], device=order.device)[None]
    vis = pos < visited[:, None].long()
    qbits = (order >> 16) & 15
    quads = sum((qbits >> q) & 1 for q in range(4))
    listed = quads if gated else torch.full_like(quads, 4)
    entries = int(visited.sum())
    n_quads = int(quads[vis].sum())
    tests = int(listed[vis].sum()) * (bn // 4) * K
    clusters = int(torch.unique((order & 0xFFFF)[vis]).numel())
    nbytes = (rays.numel() * 4 + entries * 8 + count.numel() * 4
              + clusters * 12 * K * 4 + nb * bn * 8)
    ms, by = bound(tests * FLOPS_PER_TEST, nbytes)
    v = visited.float()
    return dict(blocks=nb, entries=entries,
                median=float(v.median()) if nb else 0.0,
                max=int(visited.max()) if nb else 0,
                quads_per_entry=n_quads / max(entries, 1), tests=tests,
                clusters=clusters, bytes=nbytes,
                fp32_ms=tests * FLOPS_PER_TEST / FP32_FLOPS * 1e3,
                bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_ms=ms,
                bound_by=by)


# FP32 operations of the list test per live sub-block and ok cluster: 26
# per usable axis (4 differences, 8 products, 12 min/max, near and far) and
# 8 to fold the axes, clamp, compare and fold the sub-block
LIST_FLOPS_PER_AXIS = 26
LIST_FLOPS_PER_SUB = 8


def list_work(o, d, alive, cl_ok, nb: int, block: int):
    """What the list test (``block_trace._list_keys_twin``, four sub-blocks)
    needs on padded, dead-masked rays: the operations of the live
    sub-blocks' usable axes against the ok clusters, the bytes of reading
    the rays and boxes once and writing key, cid and count, and the
    bound."""
    from ..ops.block_trace import _BIG
    S, C = 4, cl_ok.shape[0]
    a = alive.reshape(nb, S, block // S, 1)
    d_b = d.reshape(nb, S, block // S, 3)
    dlo = torch.where(a, d_b, _BIG).amin(dim=2)
    dhi = torch.where(a, d_b, -_BIG).amax(dim=2)
    axes = ((dlo > 1e-12) | (dhi < -1e-12)).sum(dim=2)     # (nb, S)
    live = a[..., 0].any(dim=2)
    per_cluster = int(((LIST_FLOPS_PER_AXIS * axes + LIST_FLOPS_PER_SUB)
                       * live).sum())
    flops = per_cluster * int(cl_ok.sum())
    nbytes = (nb * block * (12 + 12 + 1 + 4) + C * (24 + 1)
              + nb * C * 8 + nb * 4)
    ms, by = bound(flops, nbytes)
    return dict(blocks=nb, live_subblocks=int(live.sum()), pairs=nb * C,
                flops=flops, bytes=nbytes,
                fp32_ms=flops / FP32_FLOPS * 1e3,
                bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_ms=ms,
                bound_by=by)


def build_source(src: str, stem: str) -> ctypes.CDLL:
    """Build a kernel source (an earlier version, outside csrc/) with the
    port's nvcc flags into the build directory and load it."""
    from .. import build
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(build.NVCC_FLAGS)
                                .encode()).hexdigest()[:16]
    so = os.path.join(build.BUILD_DIR, f"lib{stem}-{digest}.so")
    if not os.path.exists(so):
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so,
                               src], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src}:\n"
                               f"{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(so)


def load_old(src: str) -> ctypes.CDLL:
    """An earlier block_trace.cu (one-pass C interface), built and
    loaded."""
    lib = build_source(src, "block_trace_old")
    lib.rr_block_trace.argtypes = [ctypes.c_void_p] * 7 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.rr_block_trace.restype = ctypes.c_int
    return lib


def old_walk(lib, count, rays, order, entry, pack, mode, gated):
    nb, bn, _ = rays.shape
    t = torch.empty((nb, bn), dtype=torch.float32, device=rays.device)
    i = torch.empty((nb, bn), dtype=torch.int32, device=rays.device)
    err = lib.rr_block_trace(
        count.data_ptr(), rays.data_ptr(), order.data_ptr(),
        entry.data_ptr(), pack.data_ptr(), t.data_ptr(), i.data_ptr(), nb,
        bn, order.shape[1], pack.shape[2], int(mode == "any"), int(gated),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"old block walk launch failed: CUDA error {err}")
    return t, i


def same_as_twin(got, want):
    """(found masks equal, winners equal on found rays, max |dt|) of a
    walk's (t, idx) against the twin's, over all rays."""
    from ..ops.intersect import INF
    (t_k, i_k), (t_p, i_p) = got, want
    f_k, f_p = t_k < INF, t_p < INF
    both = f_k & f_p
    # shares from integer counts: a float32 mean on the card multiplies the
    # sum by 1/N, so a mean of N ones can round below 1.0
    agree = int((f_k == f_p).sum()) / f_k.numel() if f_k.numel() else 1.0
    n_both = int(both.sum())
    same_i = int((i_k == i_p)[both].sum()) / n_both if n_both else 1.0
    err = (t_k - t_p).abs()[both].max().item() if both.any() else 0.0
    return agree, same_i, err


def bench_inputs():
    """The bench scene on the card, its frame prep and phase 3's sets."""
    from ..config import EngineConfig
    from ..render.wavefront import prepare_frame
    from ..scene_arrays import to_torch
    from .capture_waves import load_bench_scene
    scene = load_bench_scene(1280, 720)
    sa, static = to_torch(*scene.compile(), "cuda")
    engine = EngineConfig(chunk_pixels=CHUNK, pallas_block=BLOCK,
                          queue_factor=1.0)
    prep, boxes = prepare_frame(sa, static, engine)
    sets = sorted_sets(sa, boxes, level1_rays(
        sa, static, prep, boxes, scene.raytracing_config, engine))
    return prep, boxes, sets


def main(argv=None) -> int:
    from ..ops import block_trace as bt
    from .octet_kernel_bench import cuda_ms
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("walk_compare: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    old = load_old(argv[0]) if argv else None
    prep, (w_lo, w_hi), sets = bench_inputs()
    pack = prep.pallas_pack
    K = pack.shape[2]
    for name, _, o, d, alive, tmax, cl_ok in sets:
        lists = bt.prepare_walk(o, d, alive, tmax, w_lo, w_hi, cl_ok, BLOCK)
        for gated in (True, False):
            for mode in ("closest", "any"):
                t_p, i_p, v_p = bt.block_walk(*lists, pack, mode,
                                              interpret=True, gated=gated,
                                              return_visited=True)
                t_k, i_k, v_k = bt.block_walk(*lists, pack, mode,
                                              gated=gated,
                                              return_visited=True)
                new = same_as_twin((t_k, i_k), (t_p, i_p))
                row = dict(set=name, gated=gated, mode=mode, rays=o.shape[0],
                           new_vs_twin=new,
                           visited_equal=bool(torch.equal(v_k, v_p)),
                           **walk_work(lists, v_p, K, gated))
                run_new = (lambda: bt.block_walk(*lists, pack, mode,
                                                 gated=gated))
                if old is not None:
                    row["old_vs_twin"] = same_as_twin(
                        old_walk(old, *lists, pack, mode, gated), (t_p, i_p))

                    def run_old():
                        old_walk(old, *lists, pack, mode, gated)
                    o1 = cuda_ms(run_old, 5)
                    n1 = cuda_ms(run_new, 5)
                    n2 = cuda_ms(run_new, 5)
                    o2 = cuda_ms(run_old, 5)
                    row.update(old_ms=[o1, o2], new_ms=[n1, n2])
                else:
                    row["new_ms"] = [cuda_ms(run_new, 5)]
                print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
