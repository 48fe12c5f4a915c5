"""Wall time against device time for the block walk (K1), at three block
sizes.

Port of ``tools/kernel_probe.py``: ``trace_tris_blocks`` on 98,304
primary rays of the 1280x720 bench frame (cell 0, in pixel order) at
``block_n`` 128, 256 and 512.  For each it prints the whole call (visit
lists and walk) and K1 alone on the same lists: the wall time per call
by CUDA events and the device's busy time by ``devbench.device_time``,
each the mean of 3 calls after a warm-up, then K1's work and bound
(``walk_compare.walk_work``: the FP32 operations of its ray x triangle
tests or the bytes it must move, at the card's published peaks) and its
share of that bound.  The rays are the frame's middle 98,304 pixels: the
JAX tool's first 98,304 (rows 0-76) see only sky in this scene, so the
walk would visit nothing.

Usage (repository root; on the card unless asked for the CPU):

    python -m rustray_tpu_torch.tools.kernel_probe [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

N_RAYS = 98304
BLOCKS = (128, 256, 512)


def _wall_ms(fn, iters: int, dev) -> float:
    """Mean ms per call after one warm-up: CUDA events on the card, the
    host clock on the CPU."""
    if dev.type == "cuda":
        from .octet_kernel_bench import cuda_ms
        return cuda_ms(fn, iters)
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


@torch.no_grad()
def probe(sa, static, n: int = N_RAYS, blocks=BLOCKS, iters: int = 3):
    """K1 on ``n`` primary rays from the frame's middle at each block size.
    Returns one dict per block size (also printed)."""
    from ..ops import block_trace as bt
    from ..ops import rays as rays_ops
    from ..ops.cluster_trace import world_cluster_aabbs
    from ..ops.intersect import prepare_triangles, safe_normalize
    from .devbench import device_time
    from .walk_compare import walk_work
    dev = sa.verts.device
    prep = prepare_triangles(sa)
    pack = bt.pack_cluster_tris(prep, sa.tri_valid, static.n_clusters,
                                static.cluster_size, int(sa.cl_lo.shape[0]))
    prep = prep.replace(pallas_pack=pack)
    w_lo, w_hi = world_cluster_aabbs(sa)
    cl_ok = sa.cl_valid
    n_pix = static.width * static.height
    idx = (torch.arange(n, device=dev) + max(0, n_pix // 2 - n // 2)) % n_pix
    o, d = rays_ops.primary_rays(
        sa.camera, static.width, static.height,
        (idx % static.width).to(torch.int32),
        (idx // static.width).to(torch.int32), 0, 0, 1, 1.0, 1.0, 1)
    d = safe_normalize(d)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    gated = bt.pack_is_gated(pack)
    rows = []
    for bn in blocks:
        def call(o, d, alive, bn=bn):
            return bt.trace_tris_blocks(o, d, alive, None, prep, w_lo, w_hi,
                                        cl_ok, static.cluster_size,
                                        block_n=bn)
        lists = bt.prepare_walk(o, d, alive, None, w_lo, w_hi, cl_ok, bn)

        def walk(*lists):
            return bt.block_walk(*lists, pack, "closest", gated=gated)
        _, _, visited = bt.block_walk(*lists, pack, "closest", gated=gated,
                                      return_visited=True)
        work = walk_work(lists, visited, pack.shape[2], gated)
        row = dict(block_n=bn,
                   wall=_wall_ms(lambda: call(o, d, alive), iters, dev),
                   device=device_time(call, o, d, alive, iters=iters),
                   k1_wall=_wall_ms(lambda: walk(*lists), iters, dev),
                   k1_device=device_time(walk, *lists, iters=iters),
                   **work)
        rows.append(row)
        print(f"block_n={bn}: wall {row['wall']:8.3f} ms   device "
              f"{row['device']:8.3f} ms   | K1 alone: wall "
              f"{row['k1_wall']:8.3f} ms, device {row['k1_device']:8.3f} "
              f"ms; {work['blocks']} blocks, {work['entries']} entries "
              f"visited, {work['tests']} tests; bound "
              f"{work['bound_ms']:.4f} ms ({work['bound_by']}), K1 at "
              f"{work['bound_ms'] / row['k1_device']:.2%} of it",
              flush=True)
    return rows


def main(argv=None) -> int:
    from ..scene_arrays import to_torch
    from .capture_waves import load_bench_scene
    from .devbench import device_or_exit
    ap = argparse.ArgumentParser(
        prog="python -m rustray_tpu_torch.tools.kernel_probe",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = device_or_exit("kernel_probe", args.device)
    scene = load_bench_scene(1280, 720)
    sa, static = to_torch(*scene.compile(), dev)
    probe(sa, static)
    return 0


if __name__ == "__main__":
    sys.exit(main())
