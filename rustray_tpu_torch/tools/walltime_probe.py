"""Where the frame's wall clock goes: argument build and upload, dispatch,
device completion and fetch, over the bench frame's chunks.

Port of ``tools/walltime_probe.py``: the 1280x720 bench frame at 4
samples per pixel, engine queue factor 2.0 and ``chunk_pixels`` 98,304
(10 chunks), through the port's ``make_chunk_renderer``.  On the card its
first call captures the chunk program as a CUDA graph (after an eager
warm-up), unless the process has cached it already; that call is timed
apart, as the capture.  Then every chunk's
arguments are built and uploaded, every chunk is dispatched (the host
enqueues each cell's graph replay), the device is awaited, and the
outputs are fetched to the host.  Then one argument set's build and
upload, awaited, and on the card the same dispatches again under
``torch.profiler``: the device's busy time and idle share over them.

Usage (repository root; on the card unless asked for the CPU):

    python -m rustray_tpu_torch.tools.walltime_probe [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

WIDTH, HEIGHT = 1280, 720


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def probe(sa, static, cfg, engine, samples: int):
    """The split of one frame at ``samples`` per pixel; returns the
    seconds of each column (also printed)."""
    from .. import graphs, rng
    from ..render import wavefront
    from ..utils.mathutil import sample_pattern
    dev = sa.verts.device
    width, height = static.width, static.height
    cfg = dataclasses.replace(cfg, samples=samples)
    chunk = engine.chunk_pixels
    scene = wavefront.bind_scene(
        sa, *wavefront.prepare_frame(sa, static, engine), static, engine)
    rend = wavefront.make_chunk_renderer(static, cfg, engine,
                                         1 + cfg.max_recursion, scene)
    cells = sample_pattern(samples, engine.seed)
    cell_idx = np.arange(cells.shape[0])
    cell_valid = np.ones((cells.shape[0],), bool)
    key = rng.PRNGKey(0)
    n_pix = width * height

    def args_for(start):
        idx = np.arange(start, start + chunk)
        valid = idx < n_pix
        idx_c = np.minimum(idx, n_pix - 1)
        px = torch.as_tensor(idx_c % width, dtype=torch.int32, device=dev)
        py = torch.as_tensor(idx_c // width, dtype=torch.int32, device=dev)
        return (*scene, px, py, torch.as_tensor(valid, device=dev),
                cells, cell_idx, cell_valid, rng.fold_in(key, start))

    # warm-up: the capture of the chunk program (on the card)
    wavefront.reset_graph_stats()
    _sync(dev)
    t0 = time.perf_counter()
    rend(*args_for(0))
    _sync(dev)
    t_cap = time.perf_counter() - t0
    g = dict(wavefront.graph_stats)

    starts = list(range(0, n_pix, chunk))
    t0 = time.perf_counter()
    argsets = [args_for(s) for s in starts]
    t1 = time.perf_counter()
    outs = [rend(*a) for a in argsets]
    t2 = time.perf_counter()
    _sync(dev)
    t3 = time.perf_counter()
    [[x.cpu().numpy() for x in o] for o in outs]
    graphs.settle()                 # the replays' launch counts
    t4 = time.perf_counter()
    split = dict(chunks=len(starts), capture=t_cap, args=t1 - t0,
                 dispatch=t2 - t1, completion=t3 - t2, fetch=t4 - t3,
                 total=t4 - t0)
    print(f"chunks: {len(starts)} of {chunk} pixels, {samples} spp")
    print(f"capture (first call): {t_cap:7.3f} s ({g['captures']} "
          f"captures in {g['capture_seconds']:.3f} s)")
    print(f"arg build+transfer : {split['args']:7.3f} s")
    print(f"dispatch (async)   : {split['dispatch']:7.3f} s")
    print(f"device completion  : {split['completion']:7.3f} s")
    print(f"fetch to host      : {split['fetch']:7.3f} s")
    print(f"total              : {split['total']:7.3f} s")

    t5 = time.perf_counter()
    a = args_for(0)
    _sync(dev)
    split["one_argset"] = time.perf_counter() - t5
    print(f"one argset build+put (blocked): {split['one_argset']:.3f} s "
          f"({len(a)} arguments)")
    if dev.type == "cuda":
        # whether dispatch waits on the device: its busy time over the
        # same dispatches, profiled
        from ..build import BUILD_DIR
        from .profile_frame import profile
        _, p = profile(lambda: [rend(*a) for a in argsets],
                       os.path.join(BUILD_DIR, "trace_walltime.json"))
        graphs.settle()
        split.update(profiled=p["wall"], busy=p["busy"], idle=p["idle"])
        print(f"dispatch+completion profiled again: {p['wall']:.3f} s, "
              f"device busy {p['busy']:.3f} s, idle share {p['idle']:.3f}")
    return split


def main(argv=None) -> int:
    from ..config import EngineConfig
    from ..scene_arrays import to_torch
    from .capture_waves import load_bench_scene
    from .devbench import device_or_exit
    ap = argparse.ArgumentParser(
        prog="python -m rustray_tpu_torch.tools.walltime_probe",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = device_or_exit("walltime_probe", args.device)
    scene = load_bench_scene(WIDTH, HEIGHT)
    sa, static = to_torch(*scene.compile(), dev)
    probe(sa, static, scene.raytracing_config,
          EngineConfig(queue_factor=2.0, chunk_pixels=98304), 4)
    return 0


if __name__ == "__main__":
    sys.exit(main())
