"""N ranks of the sharded render and of one train step, the port's twin of
``__graft_entry__.py::dryrun_multichip``.

    python -m rustray_tpu_torch.parallel.dryrun N [--device cuda|cpu]
        [--backend nccl|gloo] [--scene demo|glass|bench]
        [--queue-factor Q] [--chunk-pixels P] [--out DIR]
        [--timeout SECONDS]

starts N processes, one per rank, joined over ``tcp://localhost``.  On
every mesh of N ranks (rays × samples: every split of N) they run
``render_sharded``, ``render_loss_and_grad`` against a black target, and
one SGD step through ``apply_diff_params`` followed by the loss of the
stepped scene; rank 0 writes the mesh's outputs to ``DIR/mesh_RxS.npz``
(default DIR: the port's build directory).  It runs on CUDA unless asked
for the CPU; ``nccl`` (the default on CUDA) needs one card per rank, so
ranks that share a card use ``gloo``.  The launcher stops every rank when
one fails or the time runs out, and exits with the first failing code.

Scenes: ``demo`` (demo spheres 16×12, max_recursion 2, 2 spp), ``glass``
(a frame-filling glass sphere 32×24, max_recursion 3, 1 spp, which drops
rays at queue factor 1) and ``bench`` (the bench scene of data/bench at
320×180, Monte-Carlo off, 2 spp).
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LEARNING_RATE = 1e-2


def _glass_scene():
    from ..scene.light import LightType
    from ..scene.material import Material
    from ..scene.scene import Scene
    from ..scene.shapes import Sphere
    scene = Scene()
    m = Material(id=scene.get_next_id(), name="glass")
    m.base_color = np.array([0.4, 0.7, 0.9], np.float32)
    m.reflectivity = 0.5
    m.alpha = 0.5
    m.refraction_index = 1.5
    s = Sphere("big", m, 0.0, 0.0, -5.0, 4.8)
    s.basic.id = scene.get_next_id()
    scene.items.append(s)
    scene.materials.append(m)
    scene.add_light("key", (-4.0, 8.0, 2.0), (0, -1, 0), (1, 1, 1), 200.0,
                    np.pi / 2, LightType.Point)
    scene.cam.init(32, 24)
    scene.raytracing_config.max_recursion = 3
    scene.init()
    scene.update()
    return scene


def _demo_scene():
    from ..models.procedural import demo_spheres_scene
    scene = demo_spheres_scene(16, 12)
    scene.raytracing_config.max_recursion = 2
    scene.raytracing_config.samples = 2
    return scene


def _bench_scene():
    from ..tools.capture_waves import load_bench_scene
    scene = load_bench_scene(320, 180)
    scene.raytracing_config.monte_carlo = False
    scene.raytracing_config.samples = 2
    return scene


SCENES = {"demo": _demo_scene, "glass": _glass_scene, "bench": _bench_scene}


def load_scene(name: str, device):
    """(sa, static, cfg) of a named scene, its tensors on ``device``."""
    from ..scene_arrays import to_torch
    scene = SCENES[name]()
    sa, static = to_torch(*scene.compile(), device)
    return sa, static, scene.raytracing_config


def run_mesh(sa, static, cfg, engine, mesh) -> dict:
    """The render, the loss and grads, and one SGD step on ``mesh``.
    Returns numpy arrays: the render's AOVs and counts, ``loss``,
    ``grad_dropped`` (rays the gradient pass dropped), one
    ``g.<group>.<field>`` per parameter and ``loss_after_step``."""
    from . import shard
    out = shard.render_sharded(sa, static, cfg, engine, mesh)
    target = np.zeros((static.height, static.width, 3), np.float32)
    shard.reset_dropped()
    loss, grads = shard.render_loss_and_grad(sa, static, cfg, target, engine,
                                             mesh)
    out["loss"] = float(loss)
    out["grad_dropped"] = shard.dropped["rays"]
    params = shard.extract_diff_params(sa)
    stepped = {}
    for grp, leaves in grads.items():
        stepped[grp] = {}
        for k, g in leaves.items():
            out[f"g.{grp}.{k}"] = g.cpu().numpy()
            stepped[grp][k] = params[grp][k] - LEARNING_RATE * g
    sa_step = shard.apply_diff_params(sa, stepped)
    loss_step, _ = shard.render_loss_and_grad(sa_step, static, cfg, target,
                                              engine, mesh)
    out["loss_after_step"] = float(loss_step)
    return {k: np.asarray(v) for k, v in out.items()}


def meshes(n: int):
    """Every (rays, samples) split of ``n`` ranks, samples ascending."""
    return [(n // s, s) for s in range(1, n + 1) if n % s == 0]


def rank_device(device: str, rank: int):
    """A rank's device: card ``rank % device_count`` on CUDA (None, with a
    message, when there is no card); on the CPU one thread per rank, as
    the ranks share the host's cores."""
    if device == "cuda":
        if not torch.cuda.is_available():
            print("--device cuda, but torch.cuda.is_available() is False; "
                  "pass --device cpu", file=sys.stderr)
            return None
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        return dev
    torch.set_num_threads(1)
    return torch.device("cpu")


def _worker(args) -> int:
    from .shard import init_distributed, make_mesh
    from ..config import EngineConfig
    dev = rank_device(args.device, args.rank)
    if dev is None:
        return 1
    init_distributed(args.backend, f"tcp://localhost:{args.port}", args.n,
                     args.rank)
    try:
        sa, static, cfg = load_scene(args.scene, dev)
        engine = EngineConfig(queue_factor=args.queue_factor,
                              chunk_pixels=args.chunk_pixels)
        for r, s in meshes(args.n):
            t0 = time.perf_counter()
            out = run_mesh(sa, static, cfg, engine, make_mesh(s))
            if args.rank == 0:
                os.makedirs(args.out, exist_ok=True)
                np.savez(os.path.join(args.out, f"mesh_{r}x{s}.npz"), **out)
                print(f"dryrun: {args.scene} mesh {r}x{s} on {dev} "
                      f"({args.backend}) in "
                      f"{time.perf_counter() - t0:.2f} s: device_rays="
                      f"{int(out['device_rays'])}, dropped="
                      f"{int(out['dropped_rays'])}, loss={out['loss']:.8g} "
                      f"(dropped {int(out['grad_dropped'])}), after one SGD "
                      f"step {out['loss_after_step']:.8g}", flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(module: str, argv, n: int, timeout: float) -> int:
    """Start ``n`` processes ``python -m module *argv --rank i --port P``
    (one per rank, joined over ``tcp://localhost:P``) from the repository
    root and wait for them; stop them all on the first failure or after
    ``timeout`` seconds.  Returns the first failing exit code, 124 at the
    time limit, else 0."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *argv, "--rank", str(i), "--port",
         str(port)], cwd=ROOT)
        for i in range(n)]
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            if time.monotonic() > deadline:
                print(f"{module}: ranks still running after {timeout} s",
                      file=sys.stderr)
                return 124
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def ranks_result(module: str, argv, n: int, timeout: float):
    """:func:`launch_ranks` with ``--result PATH`` appended, PATH a fresh
    file in the build directory that rank 0 writes as JSON.  Returns
    (exit code, the parsed result or None)."""
    import json
    import tempfile
    from ..build import BUILD_DIR
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="ranks", suffix=".json",
                                dir=BUILD_DIR)
    os.close(fd)
    try:
        rc = launch_ranks(module, [*argv, "--result", path], n, timeout)
        with open(path) as f:
            text = f.read()
    finally:
        os.remove(path)
    return rc, (json.loads(text) if rc == 0 and text else None)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    from ..build import BUILD_DIR
    ap = argparse.ArgumentParser(
        prog="python -m rustray_tpu_torch.parallel.dryrun",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, help="number of ranks")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on CUDA, gloo on the CPU")
    ap.add_argument("--scene", choices=sorted(SCENES), default="demo")
    ap.add_argument("--queue-factor", type=float, default=4.0)
    ap.add_argument("--chunk-pixels", type=int, default=65536)
    ap.add_argument("--out", default=BUILD_DIR)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.backend is None:
        args.backend = "nccl" if args.device == "cuda" else "gloo"
    if args.rank is None:
        return launch_ranks("rustray_tpu_torch.parallel.dryrun", argv,
                            args.n, args.timeout)
    return _worker(args)


if __name__ == "__main__":
    sys.exit(main())
