"""Measured all-reduce payload and time against compute, for the sharded
paths.

Port of ``tools/ici_ratio.py``: on 2 ranks with a samples axis of 2 (a
1 x 2 mesh, gloo over ``tcp://localhost``), ``render_sharded`` and
``render_loss_and_grad`` of ``demo_spheres_scene(width, height)``
(``max_recursion`` 3, ``samples`` per pixel, queue factor 8.0), each
once to warm up and once measured.  For the measured call every
``torch.distributed.all_reduce`` is wrapped (:class:`AllReduceMeter`):
its tensor's shape, dtype and bytes, and its seconds (the device
synchronized before and after on the card).  Prints one JSON report: per
path the payload bytes, the all-reduce count and seconds, the call's
seconds, its compute seconds (the call less its all-reduces) and the
ratio of all-reduce to compute seconds, on the ranks that ran.  The JAX
tool estimated the ratio from a TPU link rate; no such figure is used.

Usage (repository root; on the card unless asked for the CPU):

    python -m rustray_tpu_torch.tools.ici_ratio [width height samples]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch
import torch.distributed as dist

MODULE = "rustray_tpu_torch.tools.ici_ratio"
RANKS = 2
TIMEOUT = 900.0


class AllReduceMeter:
    """While active, ``torch.distributed.all_reduce`` records each call:
    (shape, dtype, bytes, seconds)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self.real = dist.all_reduce

        def all_reduce(tensor, *args, **kwargs):
            sync = torch.cuda.synchronize if tensor.is_cuda else (
                lambda *_: None)
            sync(tensor.device)
            t0 = time.perf_counter()
            out = self.real(tensor, *args, **kwargs)
            sync(tensor.device)
            self.calls.append((list(tensor.shape), str(tensor.dtype),
                               tensor.numel() * tensor.element_size(),
                               time.perf_counter() - t0))
            return out

        dist.all_reduce = all_reduce
        return self

    def __exit__(self, *exc):
        dist.all_reduce = self.real
        return False


def measure(fn) -> dict:
    """``fn()`` once to warm up, then once under :class:`AllReduceMeter`
    from a barrier; the path's entry of the report."""
    fn()
    dist.barrier()
    with AllReduceMeter() as meter:
        t0 = time.perf_counter()
        fn()
        secs = time.perf_counter() - t0
    comm = sum(c[3] for c in meter.calls)
    return dict(all_reduce_bytes=sum(c[2] for c in meter.calls),
                all_reduce_calls=len(meter.calls), all_reduce_seconds=comm,
                seconds=secs, compute_seconds=secs - comm,
                comm_over_compute=comm / max(secs - comm, 1e-9),
                reduced=[c[:3] for c in meter.calls])


def _worker(args) -> int:
    import numpy as np
    from ..config import EngineConfig
    from ..models.procedural import demo_spheres_scene
    from ..parallel import shard
    from ..parallel.dryrun import rank_device
    from ..scene_arrays import to_torch
    dev = rank_device(args.device, args.rank)
    if dev is None:
        return 1
    shard.init_distributed("gloo", f"tcp://localhost:{args.port}", RANKS,
                           args.rank)
    try:
        scene = demo_spheres_scene(args.width, args.height)
        scene.raytracing_config.max_recursion = 3
        scene.raytracing_config.samples = args.samples
        sa, static = to_torch(*scene.compile(), dev)
        cfg = scene.raytracing_config
        engine = EngineConfig(queue_factor=8.0)
        mesh = shard.make_mesh(2)
        target = np.zeros((static.height, static.width, 3), np.float32)
        report = {
            "ranks": RANKS, "mesh": [1, 2], "device": (
                torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
            "workload": f"demo_spheres {args.width}x{args.height} samples="
                        f"{args.samples} max_recursion=3, ('rays','samples')"
                        f" mesh 1x2",
            "forward": measure(lambda: shard.render_sharded(
                sa, static, cfg, engine, mesh)),
            "value_and_grad": measure(lambda: shard.render_loss_and_grad(
                sa, static, cfg, target, engine, mesh))}
        if args.rank == 0:
            with open(args.result, "w") as f:
                json.dump(report, f)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    from ..parallel.dryrun import ranks_result
    from .devbench import device_or_exit
    ap = argparse.ArgumentParser(prog=f"python -m {MODULE}",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("width", type=int, nargs="?", default=256)
    ap.add_argument("height", type=int, nargs="?", default=192)
    ap.add_argument("samples", type=int, nargs="?", default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    for hidden in ("--rank", "--port"):
        ap.add_argument(hidden, type=int, default=None,
                        help=argparse.SUPPRESS)
    ap.add_argument("--result", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.rank is not None:
        return _worker(args)
    device_or_exit("ici_ratio", args.device)
    rc, report = ranks_result(MODULE, [
        "--device", args.device, str(args.width), str(args.height),
        str(args.samples)], RANKS, TIMEOUT)
    if report is None:
        print(f"ici_ratio: the ranks failed (exit code {rc})",
              file=sys.stderr)
        return rc or 1
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
