"""The control of the ``grad`` loop's check: the reference computed in a
lower precision than the configuration states (bfloat16 for the
program's float32) put in the program's place where the check compares
the program with the reference (the colour at the compared pixels and the
gradient of the loss restricted to them), judged by the harness's own run
exactly as the program is.  The rest stays the program's: the steps of the
window and their Adam updates, the gradient of the loss off the compared
pixels and each timed step's full-frame gradient, which
``grad_split_rel`` ties to the compared one.  Its readings are the upper
ends from which ``limits/sponza_grad.json`` was set; the benchmark's own
runs never run it.

    python3 perfbench/control_grad.py --seeds <n> [<n> ...] --steps N
        [--workload sponza_grad] [--dtype bfloat16] [--device cuda]

``--steps``: the steps that a window of the cell completes.  One JSON line
per seed gives the check's readings.  Exit 2 without a card, unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import sys
from contextlib import redirect_stdout

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from perfbench import run  # noqa: E402


def stand_in(dtype, steps: int):
    """A fault for ``run.main``: ``steps`` steps, the compared colour and
    gradient of each the reference's at ``dtype``."""
    def fault(loop):
        sample, grads_at, refs = loop.sample, loop.grads_at, {}

        def ref(state):
            if state not in refs:
                refs[state] = loop.reference(state, dtype)
            return refs[state]

        loop.max_steps = steps
        loop.sample = lambda rec: dict(sample(rec),
                                       color=ref(rec["state"])["color"])
        loop.grads_at = lambda state, inside: (
            ref(state)["grad"] if inside else grads_at(state, inside))
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
        raise SystemExit(f"perfbench/control_grad.py: the run exited {rc}")
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    return {k: v["value"] for k, v in result["check"].items()}


def main(argv=None) -> int:
    import torch
    p = argparse.ArgumentParser(prog="perfbench/control_grad.py")
    p.add_argument("--workload", default="sponza_grad")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--steps", type=int, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("perfbench/control_grad.py: no CUDA card", file=sys.stderr)
        return 2
    dtype = getattr(torch, args.dtype)
    for seed in args.seeds:
        r = readings(args.workload, seed, dtype, args.device, args.steps)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": args.dtype, "readings": r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
