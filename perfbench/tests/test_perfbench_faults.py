"""The check catches a broken timed path: with the loop's step broken
underneath, a small run on the CPU (the card check skipped) comes out not
correct.  Faults that a cell can have: a step that returns its state
unchanged (the still frame's jitter, the edit or the animation frame is
not applied), half of the
batch left out with the mean taken over the rest (half the samples, or at
one sample half the rows filled from the other half), and an answer
altered where it is produced (the frame's colours).  One card, so no
exchange between chips to leave out."""
import numpy as np
import pytest

from perfbench.tests.small import run_small


def stale_state(loop):
    """Each step renders the scene as it was: the camera's jitter, the
    edit or the animation frame is not applied."""
    loop.apply = lambda i: None


def half_batch(loop):
    """Half of each frame's work left out, the mean over the rest."""
    step = loop.step

    def halved(i):
        rec = step(i)
        out = dict(rec["out"])
        if loop.samples > 1:
            raise AssertionError("small cells render one sample, or two")
        for k in ("color", "depth", "object_id"):
            a = np.array(out[k])
            a[1::2] = a[0:a.shape[0] - a.shape[0] % 2:2][:a[1::2].shape[0]]
            out[k] = a
        out["device_rays"] = out["device_rays"] // 2
        rec["out"] = out
        return rec
    loop.step = halved


def half_samples(loop):
    """A 2-sample frame rendered and averaged at 1 sample."""
    setup = loop.setup

    def halved():
        setup()
        loop.cfg.samples = loop.samples // 2
    loop.setup = halved


def altered(loop):
    """Every frame's colours changed where they are produced."""
    step = loop.step

    def alter(i):
        rec = step(i)
        out = dict(rec["out"])
        out["color"] = np.clip(out["color"] + 0.05, 0.0, 1.0)
        rec["out"] = out
        return rec
    loop.step = alter


CASES = [("sponza_still", stale_state), ("spheres_edit", stale_state),
         ("sponza_anim", stale_state),
         ("spheres_edit", half_batch), ("sponza_anim", half_batch),
         ("sponza_still", half_samples),
         ("spheres_edit", altered), ("sponza_still", altered),
         ("sponza_anim", altered)]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f.__name__}" for w, f in CASES])
def test_fault_is_not_correct(workload, fault):
    rc, res = run_small(workload, seconds=2.0, fault=fault)
    assert rc == 0
    assert not res["correct"], res["check"]


def test_failing_steps_are_counted_and_not_correct():
    def failing(loop):
        step = loop.step

        def fail(i):
            if i >= 0:
                raise RuntimeError("broken step")
            return step(i)
        loop.step = fail

    rc, res = run_small("spheres_edit", seconds=0.5, fault=failing)
    assert rc == 0
    assert not res["correct"] and res["failed"] >= 1
