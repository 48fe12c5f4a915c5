"""The comparison that decides ``correct``: the program's frames against the
reference's, at pixels and steps drawn from the seed.

Numbers (each compared with its limit in ``limits/<workload>.json``; a
cell compares the ones its file lists):
- ``id_miss_pct``: per cent of compared pixels whose object id differs
  (which surface the primary ray hits).
- ``depth_p99``: 99th percentile over compared pixels of the depth's
  difference relative to the reference's depth (0.001 at least).
- ``color_p99``: 99th percentile over compared pixels of the largest
  channel difference of the colour (a shift of the whole frame).
- ``color_bad_pct``: per cent of compared pixels whose colour differs by
  more than 2/255 in some channel, two levels of the 8-bit image (a change
  of a few pixels, such as one object's).
- ``rays_gap_pct``: the largest, over compared steps, per cent difference
  of the program's traced rays per pixel-sample (``device_rays`` over
  width·height·samples) from the reference's mean over its pixels.
- ``dropped``: rays dropped in any step of the run (limit 0).
"""
from __future__ import annotations

import numpy as np

NAMES = ("id_miss_pct", "depth_p99", "color_p99", "color_bad_pct",
         "rays_gap_pct", "dropped")
BAD_COLOR = 2.0 / 255.0


class Reservoir:
    """A uniform sample, drawn from the seed, of ``size`` of the steps that
    a run completes, however many that is."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.Generator(np.random.PCG64([seed, 17]))
        self.kept = []
        self.seen = 0

    def offer(self, item):
        if len(self.kept) < self.size:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(self.seen + 1))
            if j < self.size:
                self.kept[j] = item
        self.seen += 1


def pick_pixels(width: int, height: int, count, seed: int) -> np.ndarray:
    """Sorted flat pixel indices to compare: all, or ``count`` drawn from
    the seed without replacement."""
    n = width * height
    if count == "all" or int(count) >= n:
        return np.arange(n)
    rng = np.random.Generator(np.random.PCG64([seed, 19]))
    return np.sort(rng.choice(n, int(count), replace=False))


def sample_outputs(out: dict, pixels: np.ndarray, spp_pixels: int) -> dict:
    """The program's outputs of one step at the compared pixels."""
    return dict(color=out["color"].reshape(-1, 3)[pixels].astype(np.float64),
                depth=out["depth"].reshape(-1)[pixels].astype(np.float64),
                object_id=out["object_id"].reshape(-1)[pixels],
                rays=float(out["device_rays"]) / spp_pixels,
                dropped=int(out["dropped_rays"]))


def compare(pairs, dropped: int) -> dict:
    """The numbers over ``pairs`` of (program, reference) outputs at the
    same pixels; ``dropped``: the run's dropped rays over all steps."""
    ids, dep, col, gaps = [], [], [], []
    for prog, ref in pairs:
        ids.append(prog["object_id"] != ref["object_id"])
        dep.append(np.abs(prog["depth"] - ref["depth"])
                   / np.maximum(ref["depth"], 1e-3))
        col.append(np.abs(prog["color"] - ref["color"]).max(1))
        gaps.append(abs(prog["rays"] - ref["rays"].mean())
                    / max(ref["rays"].mean(), 1e-12) * 100.0)
    ids, dep, col = (np.concatenate(x) for x in (ids, dep, col))
    return {"id_miss_pct": float(ids.mean() * 100.0),
            "depth_p99": float(np.percentile(dep, 99)),
            "color_p99": float(np.percentile(col, 99)),
            "color_bad_pct": float((col > BAD_COLOR).mean() * 100.0),
            "rays_gap_pct": float(max(gaps)),
            "dropped": int(dropped)}


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) for the numbers ``limits``
    names; a number without a value, or above its limit, fails."""
    shown, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        shown[name] = {"value": value, "limit": limit}
        if value is None or not value <= limit:
            ok = False
    return ok, shown
