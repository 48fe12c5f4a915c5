"""The benchmark of rustray_tpu_torch, the PyTorch and CUDA port.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout, on a machine with as many CUDA cards as
the cell asks for (``BENCHMARK.json``).  One run is one process: it sets
up the cell (imports, the card check, scene assets on a checkout's first
run, the scene's load and compile, and one warm-up step of the cell's own
shapes, which builds the kernels and captures the graphs that the window
replays), then measures the cell's closed loop for ``--seconds`` (a step
running when they elapse completes), or with ``--trace 1`` profiles a
bounded slice of steps instead, checks what the program rendered against
the plain reference, and prints one JSON line last on standard output.

Everything of a cell is found by name: the workload in ``BENCHMARK.json``
(or ``reserve.json``, for a cell held back from it),
its configuration in ``configs/<config>.json`` (whose scene generator is
``scenes/<generator>.py``), its traffic in ``traffic/<traffic>.json``
(whose loop kind is ``loops/<kind>.py``), the limits of its check in
``limits/<workload>.json``, end-to-end metrics in ``e2e/<metric>.py`` and
per-layer metrics in ``metrics/<metric>.py`` (``named.py``).  Exit codes:
0 with a result; 2 with no card or too few; 3 when the run loaded JAX or
the JAX package; 1 on any other error.  No result line is printed unless
the code is 0.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache of the run stays at a fixed path inside the
# checkout, so that only a checkout's first run builds
CACHE = os.path.join(HERE, "_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import check, devtrace, named  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "rustray_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load,
    each compared whole (``rustray_tpu_torch`` is not ``rustray_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _json(path):
    with open(path) as f:
        return json.load(f)


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"perfbench: no {what} named {name!r} in BENCHMARK.json"
                     " or perfbench/reserve.json")


def _applies(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def load_spec():
    """``BENCHMARK.json``, with the entries of ``reserve.json`` added: cells
    whose files the benchmark keeps and tests, but which it holds back from
    ``BENCHMARK.json`` while no bound holds their end-to-end metric on the
    check's machines (``PERF.md``).  The check runs only the cells of
    ``BENCHMARK.json``; an entry there takes the place of a reserved entry
    of the same name."""
    spec = _json(os.path.join(ROOT, "BENCHMARK.json"))
    reserve = _json(os.path.join(HERE, "reserve.json"))
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = {e["name"] for e in spec[key]}
        spec[key] = spec[key] + [e for e in reserve.get(key, [])
                                 if e["name"] not in names]
    return spec


def load_cell(workload: str):
    """(spec, workload entry, config, traffic, limits) of a cell."""
    spec = load_spec()
    wl = _named(spec["workloads"], workload, "workload")
    config = _json(os.path.join(HERE, "configs", f"{wl['config']}.json"))
    traffic = _json(os.path.join(HERE, "traffic", f"{wl['traffic']}.json"))
    limits = _json(os.path.join(HERE, "limits", f"{workload}.json"))
    return spec, wl, config, traffic, limits


def reader(name: str):
    """The per-layer reader of metric ``name`` (``metrics/``)."""
    return named.find("metrics", name).read


def make_loop(config, traffic, seed, device):
    """The loop of a cell: the kind that the traffic file names."""
    return named.find("loops", traffic["loop"]).Loop(config, traffic, seed,
                                                     device)


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_window(loop, seconds, offer):
    """Steps back to back until ``seconds`` have elapsed (the step then
    running completes).  Returns (steps, window seconds, failed)."""
    steps, failed = [], 0
    t0 = time.perf_counter()
    i = 0
    while i < loop.max_steps:
        try:
            rec = loop.step(i)
        except Exception as e:  # noqa: BLE001 - a failed step is counted
            print(f"perfbench: step {i} failed: {e!r}", file=sys.stderr)
            failed += 1
            rec = None
        end = time.perf_counter() - t0
        if rec is not None:
            offer(rec)
            steps.append(dict(loop.summary(rec), end=end))
        i += 1
        if end >= seconds:
            break
    return steps, end, failed


def run_trace(loop, n_steps, offer, device):
    """Profile ``n_steps`` steps; returns (Trace, steps, failed)."""
    import torch
    recs = []
    failed = 0

    def body():
        nonlocal failed
        for i in range(n_steps):
            with torch.profiler.record_function("step"):
                try:
                    recs.append(loop.step(i))
                    _sync(device)
                except Exception as e:  # noqa: BLE001
                    print(f"perfbench: step {i} failed: {e!r}",
                          file=sys.stderr)
                    failed += 1

    trace = devtrace.profile(body, lambda: _sync(device))
    for rec, span in zip(recs, trace.spans):
        offer(rec)
        trace.steps.append(dict(loop.summary(rec), busy_s=span[3]))
    trace.info = loop.trace_info()
    return trace, trace.steps, failed


def main(argv=None, *, device=None, config_overrides=None,
         traffic_overrides=None, fault=None) -> int:
    """The benchmark's run.  ``device``, the overrides and ``fault`` are for
    the benchmark's own tests and its control: a device other than the
    card, a smaller cell, and a change to the loop (``fault(loop)``, before
    set-up), such as one that breaks what it renders or puts the reference
    in the program's place."""
    p = argparse.ArgumentParser(prog="perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec, wl, config, traffic, limits = load_cell(args.workload)
    config = dict(config, **(config_overrides or {}))
    traffic = dict(traffic, **(traffic_overrides or {}))

    import torch
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < int(wl["chips"]):
            print(f"perfbench: the cell needs {wl['chips']} CUDA card(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                  f"device_count={torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    on_card = torch.device(device).type == "cuda"

    loop = make_loop(config, traffic, args.seed, device)
    if fault is not None:
        fault(loop)
    reservoir = check.Reservoir(int(traffic["check"]["steps"]), args.seed)

    def offer(rec):
        reservoir.offer((rec["state"], loop.sample(rec)))

    try:
        loop.setup()
        _sync(device)
        setup_s = time.perf_counter() - T0
        if args.trace:
            trace, steps, failed = run_trace(loop, int(traffic["trace_steps"]),
                                             offer, device)
        else:
            steps, window_s, failed = run_window(loop, args.seconds, offer)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        loop.release()
    finally:
        loop.close()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    numbers = loop.check(reservoir.kept, steps)
    correct, shown = check.judge(numbers, limits)
    correct = correct and failed == 0 and len(steps) > 0

    if args.trace:
        metrics = {}
        for m in spec["per_layer"]:
            if _applies(m, wl["name"]):
                v = reader(m["name"])(trace)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {}
        for m in spec["end_to_end"]:
            # no completed step: nothing to reduce but the set-up
            if not _applies(m, wl["name"]) or \
                    (not steps and m["name"] != "setup_s"):
                continue
            v = setup_s if m["name"] == "setup_s" else \
                named.find("e2e", m["name"]).reduce(steps, window_s, loop)
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3

    dev = {"platform": "gpu" if on_card else device,
           "kind": torch.cuda.get_device_name(0) if on_card else device,
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(steps) + failed,
              "failed": failed, "metrics": metrics, "device": dev}
    if args.trace:
        dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = trace.breakdown()
    result["check"] = shown
    print("perfbench: step seconds " + json.dumps(
        [round(st["seconds"], 4) for st in steps]), file=sys.stderr)
    print("perfbench: readings " + json.dumps(numbers), file=sys.stderr)
    for name, v in shown.items():
        print(f"perfbench: {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
