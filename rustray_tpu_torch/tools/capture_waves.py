"""Capture the per-level wavefront ray batches of one bench chunk.

Port of ``tools/capture_waves.py``: renders one chunk-sample of the
1280x720 bench frame (``data/bench``) with the renderer's own
level loop (``_shade_level`` and the compaction of ``render_sample``),
while a wrapper around ``trace_closest`` records every call's (o, d,
alive, t_max).  Batches are saved to an .npz under the keys
the JAX tool writes: ``{closest,shadow}_{level}_{o,d,alive,tmax}``, where
level counts the calls of that kind so far.

Usage (from the repository root, on a machine with a CUDA card):

    python -m rustray_tpu_torch.tools.capture_waves [out.npz] \\
        [chunk_pixels] [start_chunk]

Defaults: ``rustray_tpu_torch/_build/waves.npz``, 32768, 14 (the frame's
middle chunk; see ``MIDDLE_CHUNK``).
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ..build import BUILD_DIR

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH_JSON = os.path.join(ROOT, "data", "bench",
                          "sponza_class_g6_52x68.json")
DEFAULT_OUT = os.path.join(BUILD_DIR, "waves.npz")
# the frame's middle chunk (pixels 458,752.. of 1280x720).  The JAX tool
# defaults to chunk 10, which this scene's camera sees as sky: none of its
# 32,768 primary rays hits, so it has no secondary wavefront at all.
MIDDLE_CHUNK = 1280 * 720 // 2 // 32768


def load_bench_scene(width: int, height: int):
    """The bench scene of data/bench through the port's JSON→GLTF loaders.
    The committed JSON names its GLB by an absolute path; the GLB is found
    by its basename beside the JSON and a rewritten copy of the JSON goes to
    the port's build directory (nothing is written into data/)."""
    from ..scene.scene import Scene
    with open(BENCH_JSON) as f:
        spec = json.load(f)
    bench = os.path.dirname(BENCH_JSON)
    for obj in spec["objects"]:
        obj["path"] = os.path.join(bench, os.path.basename(obj["path"]))
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, "bench_scene.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    scene = Scene()
    scene.load(path)
    scene.cam.init(width, height)
    scene.init()
    scene.update()
    return scene


@torch.no_grad()
def capture(sa, static, cfg, engine=None, chunk: int = 32768,
            start_chunk: int = MIDDLE_CHUNK):
    """Trace chunk ``start_chunk`` at sample cell 0 with key PRNGKey(0)
    through the renderer's level loop, as the JAX tool does (every level,
    dead or not; no backward fold), and return the recorded batches as a
    dict of numpy arrays (keys as in the module docstring)."""
    from .. import rng
    from ..config import EngineConfig
    from ..ops import rays as rays_ops
    from ..render import wavefront
    from ..utils.mathutil import sample_cell_size, sample_pattern

    engine = engine or EngineConfig(queue_factor=1.0, chunk_pixels=chunk)
    dev = sa.verts.device
    prep, boxes = wavefront.prepare_frame(sa, static, engine)
    n_levels = 1 + cfg.max_recursion
    n_pix = static.width * static.height
    idx = torch.clamp(torch.arange(start_chunk * chunk,
                                   (start_chunk + 1) * chunk, device=dev),
                      max=n_pix - 1)
    cell = sample_pattern(cfg.samples, engine.seed)[0]
    o, d = rays_ops.primary_rays(
        sa.camera, static.width, static.height,
        (idx % static.width).to(torch.int32),
        (idx // static.width).to(torch.int32), int(cell[0]), int(cell[1]),
        sample_cell_size(cfg.samples), cfg.aperture_size, cfg.focal_length,
        cfg.samples)
    key = rng.PRNGKey(0)
    cap = int(max(chunk, round(chunk * engine.queue_factor)))
    weight = torch.ones((chunk, 3), device=dev)
    alive = torch.ones((chunk,), dtype=torch.bool, device=dev)

    captured = []
    real_trace = wavefront.trace_closest

    def recording_trace(sa_, static_, prep_, o, d, for_shadow, **kw):
        n = o.shape[0]
        a = kw.get("alive")
        t_max = kw.get("t_max")
        captured.append((
            "shadow" if for_shadow else "closest", o, d,
            a if a is not None else torch.ones((n,), dtype=torch.bool,
                                               device=o.device),
            t_max if t_max is not None else torch.full(
                (n,), 3.0e38, device=o.device)))
        return real_trace(sa_, static_, prep_, o, d, for_shadow, **kw)

    wavefront.trace_closest = recording_trace
    try:
        for depth in range(1, n_levels + 1):
            _, _, ch = wavefront._shade_level(
                sa, static, prep, cfg, o, d, weight, alive, depth,
                rng.fold_in(key, depth), boxes, engine)
            if depth == n_levels:
                break
            o = torch.cat([ch["refl_o"], ch["refr_o"]])
            d = torch.cat([ch["refl_d"], ch["refr_d"]])
            weight = torch.cat([ch["w_refl"], ch["w_refr"]])
            alive_c = torch.cat([alive & ch["spawn_refl"],
                                 alive & ch["spawn_refr"]])
            if alive_c.shape[0] > cap:
                perm = torch.argsort(torch.where(
                    alive_c, -weight.amax(dim=-1), 1.0), stable=True)[:cap]
                o, d, weight = o[perm], d[perm], weight[perm]
                alive = alive_c[perm]
            else:
                alive = alive_c
    finally:
        wavefront.trace_closest = real_trace

    save = {}
    tags = [c[0] for c in captured]
    for i, (tag, o, d, a, t_max) in enumerate(captured):
        base = f"{tag}_{tags[:i + 1].count(tag)}"
        save[base + "_o"] = o.cpu().numpy()
        save[base + "_d"] = d.cpu().numpy()
        save[base + "_alive"] = a.cpu().numpy()
        save[base + "_tmax"] = t_max.cpu().numpy()
    return save


def main(argv=None) -> int:
    from ..scene_arrays import to_torch
    argv = sys.argv[1:] if argv is None else argv
    out_path = os.path.abspath(argv[0] if argv else DEFAULT_OUT)
    if out_path.startswith(os.path.join(ROOT, "data") + os.sep):
        print("capture_waves: data/ holds committed assets; write the "
              "capture elsewhere", file=sys.stderr)
        return 1
    chunk = int(argv[1]) if len(argv) > 1 else 32768
    start_chunk = int(argv[2]) if len(argv) > 2 else MIDDLE_CHUNK
    if not torch.cuda.is_available():
        print("capture_waves: needs a CUDA card (the bench frame traces "
              "through the block-walk kernel)", file=sys.stderr)
        return 1
    scene = load_bench_scene(1280, 720)
    sa, static = to_torch(*scene.compile(), "cuda")
    cfg = scene.raytracing_config
    cfg.samples = 1
    save = capture(sa, static, cfg, chunk=chunk, start_chunk=start_chunk)
    for key in save:
        if key.endswith("_alive"):
            print(f"{key[:-6]}: n={save[key].shape[0]} "
                  f"alive={int(save[key].sum())}")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.savez_compressed(out_path, **save)
    print(f"saved {len(save) // 4} trace batches to {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
