"""CLI entry point replicating src/main.rs:16-114 argument semantics.

Accepted (positional, order-free, like the reference):
- ``cmd``            — headless mode (the default here; without it we still
                       run headless but note the GUI is out of scope)
- ``no-animation``   — disable animation frame stepping
- ``monte_carlo=0|1|true|false``
- ``samples=N``
- ``start=0|1``      — accepted for compatibility (headless always starts)
- ``WIDTHxHEIGHT``   — e.g. 800x600
- scene paths ending in .json/.gltf/.glb/.obj

Extra (new framework): ``out=DIR``, ``chunk=N``, ``seed=N``, ``post=0|1``,
``preview=N``; and in this port ``device=cuda|cpu`` (default ``cuda``): the
device the session renders on, which the JAX package takes from its
backend instead.
"""
from __future__ import annotations

import re
import sys

from .config import EngineConfig
from .run import RenderSession

RES_RE = re.compile(r"^\d+x\d+$")


def parse_args(argv):
    opts = dict(window=True, scenes=[], animation=True, width=0, height=0,
                monte_carlo=None, samples=None, start=False, out="data/output",
                chunk=None, seed=0, preview=0, device="cuda")
    for arg in argv:
        if arg == "cmd":
            opts["window"] = False
        elif arg == "no-animation":
            opts["animation"] = False
        elif arg.startswith("monte_carlo="):
            v = arg.split("=", 1)[1]
            opts["monte_carlo"] = v in ("1", "true")
        elif arg.endswith((".json", ".gltf", ".glb", ".obj")):
            opts["scenes"].append(arg)
        elif RES_RE.match(arg):
            w, h = arg.split("x")
            opts["width"], opts["height"] = int(w), int(h)
        elif arg.startswith("samples="):
            opts["samples"] = int(arg.split("=", 1)[1])
        elif arg.startswith("start="):
            opts["start"] = arg.split("=", 1)[1] in ("1", "true")
        elif arg.startswith("out="):
            opts["out"] = arg.split("=", 1)[1]
        elif arg.startswith("chunk="):
            opts["chunk"] = int(arg.split("=", 1)[1])
        elif arg.startswith("seed="):
            opts["seed"] = int(arg.split("=", 1)[1])
        elif arg.startswith("preview="):
            # preview=1 writes the partial frame PNG after every chunk
            # (preview=N: every N chunks) — the minimal equivalent of the
            # reference GUI's live view (src/run.rs:677-1714)
            opts["preview"] = int(arg.split("=", 1)[1])
        elif arg.startswith("device="):
            opts["device"] = arg.split("=", 1)[1]
    return opts


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    opts = parse_args(argv)
    engine = EngineConfig(seed=opts["seed"])
    if opts["chunk"]:
        engine.chunk_pixels = opts["chunk"]
    if opts["window"]:
        print("note: windowed GUI is not part of the port; "
              "running headless (pass 'cmd' to silence this)")
    runner = RenderSession(opts["width"], opts["height"], opts["scenes"],
                           animate=opts["animation"], out_dir=opts["out"],
                           engine=engine, preview=opts["preview"],
                           device=opts["device"])
    runner.init()
    # cmd overrides applied onto the scene config (src/main.rs:79-83)
    if opts["monte_carlo"] is not None:
        runner.scene.raytracing_config.monte_carlo = opts["monte_carlo"]
    if opts["samples"] is not None:
        runner.scene.raytracing_config.samples = opts["samples"]
    runner.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
