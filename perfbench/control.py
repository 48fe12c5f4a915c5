"""The check's control: the reference put in the program's place, computed
in a lower precision than the configuration states (bfloat16 for the
program's float32), and judged by the harness's own run exactly as the
program is.  Its readings are the upper ends from which the limits in
``limits/`` were set; the benchmark's own runs never run it.

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...]
        --steps N [--dtype bfloat16] [--device cuda]

For each seed, ``run.main`` runs the cell with every step replaced by the
reference at ``--dtype``, at the check's pixels, in the state the loop
gives that step; nothing of the program runs.  ``--steps``: the steps
that a window of the cell completes.  The run's own reservoir, comparison
with the float64 reference and judgement follow; one JSON line per seed
gives the check's readings.  Exit 2 without a card, unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time
from contextlib import redirect_stdout

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from perfbench import run  # noqa: E402


def _frame(loop, ref) -> dict:
    """The reference's outputs at the pixels as a frame of the program's
    outputs (the other pixels empty)."""
    n = loop.width * loop.height
    color = np.full((n, 3), np.nan)
    depth = np.full(n, np.nan)
    object_id = np.zeros(n, np.int64)
    color[loop.pixels] = ref["color"]
    depth[loop.pixels] = ref["depth"]
    object_id[loop.pixels] = ref["object_id"]
    return dict(color=color.reshape(loop.height, loop.width, 3),
                depth=depth.reshape(loop.height, loop.width),
                object_id=object_id.reshape(loop.height, loop.width),
                device_rays=float(ref["rays"].mean()) * n * loop.samples,
                dropped_rays=0)


def stand_in(dtype, steps: int):
    """A fault for ``run.main``: ``steps`` steps, each the reference at
    ``dtype`` in the program's place."""
    def fault(loop):
        def step(i):
            t0 = time.perf_counter()
            state = loop.state(i)
            out = _frame(loop, loop.reference(state, dtype))
            return dict(seconds=time.perf_counter() - t0, out=out,
                        state=state)
        loop.max_steps = steps
        loop.setup = loop.release = lambda: None
        loop.step = step
    return fault


def readings(workload: str, seed: int, dtype, device: str, steps: int,
             config_overrides=None, traffic_overrides=None) -> dict:
    """The check's numbers with the reference at ``dtype`` in the
    program's place."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", "1e9", "--trace", "0"], device=device,
                      config_overrides=config_overrides,
                      traffic_overrides=traffic_overrides,
                      fault=stand_in(dtype, steps))
    if rc != 0:
        raise SystemExit(f"perfbench/control.py: the run exited {rc}")
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    return {k: v["value"] for k, v in result["check"].items()}


def main(argv=None) -> int:
    import torch
    p = argparse.ArgumentParser(prog="perfbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--steps", type=int, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("perfbench/control.py: no CUDA card", file=sys.stderr)
        return 2
    dtype = getattr(torch, args.dtype)
    for seed in args.seeds:
        r = readings(args.workload, seed, dtype, args.device, args.steps)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": args.dtype, "readings": r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
