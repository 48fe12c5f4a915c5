"""Traversal-design lab: list statistics on captured wavefronts.

Port of ``tools/traversal_lab.py``.  Input: the .npz of
``capture_waves`` (the per-level trace batches of one bench chunk).  For
each batch, after the production coherence sort and exit cap
(:mod:`.labs`), it prints:

- listed cluster visits at block granularities 128 / 32 / 16 / 8 / 1 (1 =
  the interval test per ray, the floor for any list-driven traversal);
- lockstep-banded iteration counts (a 128-ray tile of B-ray bands advances
  each band on its own; iterations = max over the tile's bands);
- effective per-ray pairs: clusters whose exact entry is within the ray's
  dense-scan best t (the work of a per-ray front-to-back walk with a
  perfect early exit).

Usage (repository root; on the card unless asked for the CPU):

    python -m rustray_tpu_torch.tools.traversal_lab [waves.npz]
        [--device cuda|cpu]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import labs
from .devbench import device_or_exit


@torch.no_grad()
def main(argv=None) -> int:
    args = labs.parse_args("traversal_lab", __doc__, argv)
    dev = device_or_exit("traversal_lab", args.device)
    z = np.load(args.waves)
    sa, prep, w_lo, w_hi = labs.load_scene(dev)
    print(f"{'batch':>10} {'alive':>6} | listed visits by granularity "
          f"(sum over groups)")
    print(f"{'':>10} {'':>6} | {'b128':>8} {'b32':>8} {'b16':>8} {'b8':>8} "
          f"{'perray':>9} {'eff-ray':>9} | {'it128':>6} {'band32':>7} "
          f"{'band16':>7}")
    for name, n_alive, _, cl_ok, tri_ok, o, d, alive, tmax in labs.batches(
            z, sa, dev):
        o, d, alive, tmax = labs.sorted_preamble(o, d, alive, tmax, w_lo,
                                                 w_hi, cl_ok)
        counts = {blk: labs.batched_counts(o, d, alive, tmax, cl_ok, w_lo,
                                           w_hi, blk, max(1, 2**16 // blk))
                  for blk in (128, 32, 16, 8)}
        per_ray = labs.batched_counts(o, d, alive, tmax, cl_ok, w_lo, w_hi,
                                      1, 2048)
        best_t = torch.minimum(labs.dense_t(o, d, tri_ok, prep), tmax)
        eff = labs.effective_pairs(o, d, alive, tmax, cl_ok, w_lo, w_hi,
                                   best_t)
        # lockstep iteration counts for banded 128-tiles
        it128 = counts[128].sum()
        band32 = counts[32].reshape(-1, 4).max(axis=1).sum()
        band16 = counts[16].reshape(-1, 8).max(axis=1).sum()
        print(f"{name:>10} {n_alive:>6} | {counts[128].sum():>8} "
              f"{counts[32].sum():>8} {counts[16].sum():>8} "
              f"{counts[8].sum():>8} {per_ray.sum():>9} {eff.sum():>9} | "
              f"{it128:>6} {band32:>7} {band16:>7}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
