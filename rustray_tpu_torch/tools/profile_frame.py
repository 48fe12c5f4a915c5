"""Where the bench frame's time goes on the card: one 1280x720 frame under
``torch.profiler``.

Usage (repository root, one CUDA card):

    python -m rustray_tpu_torch.tools.profile_frame [block|octet|ungated]
        [samples] [eager]

Renders the frame once unprofiled and once profiled (after a 320x180
warm-up), with the bench engine settings of ``chip_smoke.py`` (chunk
32,768, blocks of 128, queue factor 1.0): ``block`` is the block walk
(K1), ``octet`` the octet rounds (K3), ``ungated`` the block walk with the
pack budget forced to 0 (K2).  ``render()`` takes its frame path, so the
chunk program runs as CUDA graphs: the unprofiled frame captures them (a
warm-up and a capture per queue factor) and replays them once per chunk
and cell; the profiled frame replays the cached graphs.  With ``eager``
both frames run the chunk program eagerly instead, with its host syncs
(``render/wavefront.eager()``: the program the graphs are held
to).  Each run is a process of its own, as the profiler's state after
long sessions in one process was seen to drop device events.
It prints the captures, their seconds and the replays of each frame, and,
from the profiler's trace, the profiled wall, the device's busy time (the
union of its kernel, copy and memset intervals), the idle share (1 - busy /
profiled wall) and the kernels with the most device time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time

import torch

from .devbench import device_or_exit, device_summary


def profile(fn, trace_path: str, top: int = 25):
    """Run ``fn()`` once under torch.profiler (CPU and CUDA) and write its
    chrome trace to ``trace_path``.  Returns (fn's result, a dict: ``wall``
    profiled seconds, ``busy`` device seconds, ``idle`` share, ``ranked``
    kernels as :func:`device_summary` gives them, and the chunk program's
    ``graph`` captures, capture seconds and replays in the call)."""
    from ..render import wavefront
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    wavefront.reset_graph_stats()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stats = dict(wavefront.graph_stats)
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    busy, ranked = device_summary(trace_path, top)
    return out, dict(wall=wall, busy=busy, idle=1.0 - busy / wall,
                     ranked=ranked, graph=stats)


def main(argv=None) -> int:
    from ..config import EngineConfig
    from ..ops import block_trace as bt
    from ..render import wavefront
    from ..render.wavefront import render
    from ..scene_arrays import to_torch
    from .capture_waves import load_bench_scene
    argv = sys.argv[1:] if argv is None else argv
    algo = argv[0] if argv else "block"
    samples = int(argv[1]) if len(argv) > 1 else 1
    eager = argv[2:] == ["eager"]
    if algo not in ("block", "octet", "ungated") or argv[2:] not in (
            [], ["eager"]):
        raise SystemExit(f"profile_frame: unknown arguments {argv!r}")
    device_or_exit("profile_frame", "cuda")
    engine = EngineConfig(chunk_pixels=32768, pallas_block=128,
                          queue_factor=1.0)
    if algo == "octet":
        engine = dataclasses.replace(engine, pallas_algo="octet")
    budget = bt._VMEM_PACK_BUDGET
    if algo == "ungated":
        bt._VMEM_PACK_BUDGET = 0
    try:
        with wavefront.eager() if eager else contextlib.nullcontext():
            small = load_bench_scene(320, 180)
            sa, st = to_torch(*small.compile(), "cuda")
            cfg = small.raytracing_config
            cfg.samples = 1
            render(sa, st, cfg, engine)                      # warm-up
            scene = load_bench_scene(1280, 720)
            sa, st = to_torch(*scene.compile(), "cuda")
            cfg = scene.raytracing_config
            cfg.samples = samples
            torch.cuda.synchronize()
            wavefront.reset_graph_stats()
            t0 = time.perf_counter()
            render(sa, st, cfg, engine)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            g = dict(wavefront.graph_stats)
            from ..build import BUILD_DIR
            trace = os.path.join(BUILD_DIR,
                                 f"trace_{algo}{'_eager' * eager}.json")
            out, p = profile(lambda: render(sa, st, cfg, engine), trace)
    finally:
        bt._VMEM_PACK_BUDGET = budget
    print(f"{algo}{' eager' * eager}: 1280x720 {samples} spp: wall "
          f"{wall:.3f} s unprofiled "
          f"({g['captures']} captures in {g['capture_seconds']:.3f} s, "
          f"{g['replays']} replays), {p['wall']:.3f} s profiled; device busy "
          f"{p['busy']:.3f} s, idle share {p['idle']:.3f}; device rays "
          f"{out['device_rays']}")
    for k, s, n in p["ranked"]:
        print(f"  {s * 1e3:10.1f} ms {n:7d} calls {s / p['busy']:7.2%}  "
              f"{k[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
