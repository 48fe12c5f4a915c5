"""Scaling of the sharded renderer over ranks.

Port of ``tools/scaling_bench.py``: ``render_sharded`` of
``demo_spheres_scene(width, height)`` (``max_recursion`` 3, ``samples``
per pixel, queue factor 8.0) on 1, 2 and 4 ranks on the card (1, 2, 4 and
8 with ``--device cpu``).  Each count is a fresh launch of gloo ranks
over ``tcp://localhost`` (``parallel/dryrun.launch_ranks``); the mesh
has a samples axis of 2 where the rank count and the samples are even.
Every rank renders the frame once (kernel builds, graph captures) and
then once timed; the seconds are rank 0's, from a barrier to the frame on
the host.  It prints seconds per frame, speedup and efficiency against
one rank.

Ranks on one card share it (and the host's cores share the CPU ranks):
the efficiency there measures contention for one device, not scaling
over several.

Usage (repository root; on the card unless asked for the CPU):

    python -m rustray_tpu_torch.tools.scaling_bench [width height samples]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

MODULE = "rustray_tpu_torch.tools.scaling_bench"
TIMEOUT = 900.0


def _worker(args) -> int:
    import torch.distributed as dist
    from ..config import EngineConfig
    from ..models.procedural import demo_spheres_scene
    from ..parallel.dryrun import rank_device
    from ..parallel.shard import init_distributed, make_mesh, render_sharded
    from ..scene_arrays import to_torch
    dev = rank_device(args.device, args.rank)
    if dev is None:
        return 1
    init_distributed("gloo", f"tcp://localhost:{args.port}", args.n,
                     args.rank)
    try:
        scene = demo_spheres_scene(args.width, args.height)
        scene.raytracing_config.max_recursion = 3
        scene.raytracing_config.samples = args.samples
        sa, static = to_torch(*scene.compile(), dev)
        cfg = scene.raytracing_config
        engine = EngineConfig(queue_factor=8.0)
        s_axis = 2 if (args.samples % 2 == 0 and args.n % 2 == 0
                       and args.n > 1) else 1
        mesh = make_mesh(s_axis)
        render_sharded(sa, static, cfg, engine, mesh)
        dist.barrier()
        t0 = time.perf_counter()
        out = render_sharded(sa, static, cfg, engine, mesh)
        dt = time.perf_counter() - t0
        if args.rank == 0:
            with open(args.result, "w") as f:
                json.dump({"n": args.n, "seconds": dt, "mesh": [
                    args.n // s_axis, s_axis],
                    "device_rays": int(out["device_rays"])}, f)
    finally:
        dist.destroy_process_group()
    return 0


def bench(counts, width: int, height: int, samples: int,
          device: str) -> int:
    """Each rank count in a fresh launch; prints and returns 0, or 1 when a
    launch failed."""
    from ..parallel.dryrun import ranks_result
    results = {}
    for n in counts:
        rc, r = ranks_result(MODULE, [
            "--n", str(n), "--device", device, str(width), str(height),
            str(samples)], n, TIMEOUT)
        if r is None:
            print(f"ranks={n}: FAILED (exit code {rc})")
            return 1
        results[n] = r["seconds"]
        base = results[counts[0]] * counts[0]
        print(f"ranks={n} (mesh {r['mesh'][0]}x{r['mesh'][1]}): "
              f"{r['seconds']:.3f} s/frame  speedup="
              f"{base / r['seconds']:.2f}x  efficiency="
              f"{base / (n * r['seconds']) * 100.0:.0f}%  device_rays="
              f"{r['device_rays']}", flush=True)
    where = (f"one card ({torch.cuda.get_device_name(0)})"
             if device == "cuda" else f"{os.cpu_count()} host cores")
    print(f"(the ranks share {where}: efficiency measures contention for "
          f"it, not scaling over devices)")
    return 0


def main(argv=None) -> int:
    from .devbench import device_or_exit
    ap = argparse.ArgumentParser(prog=f"python -m {MODULE}",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("width", type=int, nargs="?", default=256)
    ap.add_argument("height", type=int, nargs="?", default=192)
    ap.add_argument("samples", type=int, nargs="?", default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    for hidden in ("--n", "--rank", "--port"):
        ap.add_argument(hidden, type=int, default=None,
                        help=argparse.SUPPRESS)
    ap.add_argument("--result", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.rank is not None:
        return _worker(args)
    device_or_exit("scaling_bench", args.device)
    counts = (1, 2, 4) if args.device == "cuda" else (1, 2, 4, 8)
    return bench(counts, args.width, args.height, args.samples, args.device)


if __name__ == "__main__":
    sys.exit(main())
