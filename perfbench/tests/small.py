"""Small versions of the cells for CPU tests: the same loops, scenes and
check at a size a test run holds, every pixel compared."""

SPONZA = {"width": 48, "height": 27,
          "scene": {"generator": "sponza_class", "grid": 2, "lat": 10,
                    "lon": 12, "variant": "uniform"}}
ANIM = {"fps": 24, "keyframes": 9,
        "objects": ["ball0_0", "ball1_0"],
        "offset_lo": [-1.0, 0.0, -1.0], "offset_hi": [1.0, 1.0, 1.0]}
SMALL = {
    "sponza_still": (SPONZA, {"samples_per_frame": 2, "trace_steps": 1,
                              "check": {"pixels": "all", "steps": 3}}),
    "spheres_edit": ({"width": 48, "height": 36},
                     {"trace_steps": 3,
                      "check": {"pixels": "all", "steps": 50}}),
    # 12 frames over 9 keyframes: the small run's few frames move far
    "sponza_anim": (SPONZA, {"trace_steps": 1,
                             "check": {"pixels": "all", "steps": 50},
                             "animation": dict(ANIM, frames=12)}),
}
SEED = 2**31 + 11


def run_small(workload, seconds=1.0, trace=0, fault=None, seed=SEED):
    """run.main on the CPU at the small size; returns (rc, result dict)."""
    import io
    import json
    from contextlib import redirect_stdout

    from perfbench import run
    config, traffic = SMALL[workload]
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      device="cpu", config_overrides=config,
                      traffic_overrides=traffic, fault=fault)
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 else None)
