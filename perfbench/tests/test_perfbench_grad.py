"""The ``grad`` loop (cell ``sponza_grad``) at a small size on the CPU:
one window of gradient steps through the port's CPU path, its check
against the differentiable reference under the cell's limits, the split
of the gradient over the compared pixels and the rest adding up to the
timed step's, and a broken step caught."""
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

from perfbench import run
from perfbench.tests.small import SEED, SPONZA

# 48 x 27 in chunks of 512 pixels, so the steps render in three chunks
# with the chunk start folded into each key, as the cell's frame does
CONFIG = dict(SPONZA, engine={"chunk_pixels": 512, "queue_factor": 4.0,
                              "pallas": "auto"})
TRAFFIC = {"samples_per_frame": 2, "trace_steps": 1,
           "target": {"samples": 4, "samples_per_dispatch": 2},
           "check": {"pixels": "all", "steps": 1}}


def run_grad(trace=0, fault=None, seconds=1.0):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", "sponza_grad", "--seed", str(SEED),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      device="cpu", config_overrides=CONFIG,
                      traffic_overrides=TRAFFIC, fault=fault)
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 else None)


@pytest.mark.parametrize("trace", [0, 1])
def test_small_grad_run_is_correct(trace):
    rc, res = run_grad(trace)
    assert rc == 0
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    check = res["check"]
    assert set(check) == {"color_p99", "color_bad_pct", "grad_rel_err",
                          "grad_split_rel", "dropped"}
    assert all(v["value"] is not None for v in check.values())
    # the two weighted gradients add up to the timed one (float32 sums)
    assert check["grad_split_rel"]["value"] < 1e-5
    names = set(res["metrics"])
    if trace:
        # no card: no device clock for the backward passes
        assert "idle_share.grad" in names and "backward_ms.grad" not in names
    else:
        assert names == {"mrays_s", "setup_s"}


def stale_step(loop):
    """Every step's gradient taken at the perturbed start, as if the Adam
    step were never applied (the kept parameters move on)."""
    adam_step = loop.adam_step

    def stale(grads):
        saved = {k: loop.leaf(k).clone() for k in loop.traffic["perturb"]}
        adam_step(grads)
        loop._shadow = {k: loop.leaf(k).clone() for k in saved}
        for k, v in saved.items():
            loop.leaf(k).copy_(v)

    apply = loop.apply

    def apply_shadow(i):
        apply(i)
        if getattr(loop, "_shadow", None):
            loop.params[i] = {k: v.numpy().copy()
                              for k, v in loop._shadow.items()}
    loop.adam_step = stale
    loop.apply = apply_shadow


def half_frame(loop):
    """The timed step's gradient of half the frame's chunks."""
    from rustray_tpu_torch.parallel import shard
    real = shard.render_loss_and_grad

    def halved(sa, static, cfg, target, engine, mesh=None,
               pixel_weight=None, return_color=False):
        if return_color:
            w = np.ones(static.width * static.height, np.float32)
            w[w.shape[0] // 2:] = 0.0
            return real(sa, static, cfg, target, engine, mesh, w, True)
        return real(sa, static, cfg, target, engine, mesh, pixel_weight)
    setup = loop.setup

    def broken():
        setup()
        loop._shard = type("S", (), dict(vars(shard),
                                         render_loss_and_grad=halved))
    loop.setup = broken


@pytest.mark.parametrize("fault", [stale_step, half_frame])
def test_grad_fault_is_not_correct(fault):
    rc, res = run_grad(fault=fault, seconds=2.0)
    assert rc == 0
    assert not res["correct"], res["check"]


def test_control_fails_the_limits():
    """The reference in bfloat16 in the program's place is not correct
    under the cell's limits."""
    import torch

    from perfbench import check
    from perfbench.control_grad import readings
    r = readings("sponza_grad", SEED, torch.bfloat16, "cpu", 1, CONFIG,
                 TRAFFIC)
    limits = run.load_cell("sponza_grad")[4]
    ok, shown = check.judge(r, limits)
    assert not ok, shown
