"""Ray orderings for the block walk, simulated on captured wavefronts.

Port of ``tools/binning_lab.py``.  The question: if rays are sorted by
their nearest listed cluster (instead of direction octant + Morton
code), do 128-ray blocks share their first clusters well enough that the
early-exit block walk approaches the per-ray work floor?

For each batch of the ``capture_waves`` .npz and each ordering it prints
the listed visits of 128-ray blocks (what the walk's lists hold, from the
interval test refined over 4 sub-blocks of 32, as in production) and the
approximate effective visits: per block, listed entries within the
block's final need (max over its lanes of min(true best t, t_max)), a
lower bound on the walk's iterations.

Orderings: ``morton`` = the production ``coherence_key``; ``firstcl`` =
each ray's nearest cluster by its exact slab entry, then the key's
octant bits.

Usage (repository root; on the card unless asked for the CPU):

    python -m rustray_tpu_torch.tools.binning_lab [waves.npz]
        [--device cuda|cpu]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import labs
from .devbench import device_or_exit


def block_stats(o, d, alive, tmax, cl_ok, w_lo, w_hi, need):
    """(listed, effective) visits summed over 128-ray blocks, the interval
    test refined over 4 sub-blocks as in production; ``need`` (n,) is each
    lane's final need."""
    from ..ops.intersect import INF
    nb = o.shape[0] // 128
    S, sub = 4, 32
    possible = torch.zeros((nb, w_lo.shape[0]), dtype=torch.bool,
                           device=o.device)
    entry_min = torch.full((nb, w_lo.shape[0]), INF, device=o.device)
    for s in range(S):
        lanes = torch.arange(nb * 128, device=o.device).reshape(nb, S, sub)
        at = lanes[:, s].reshape(-1)
        _, entry = labs.group_counts(o[at], d[at], alive[at], tmax[at],
                                     cl_ok, w_lo, w_hi, sub)
        possible = possible | (entry < INF)
        entry_min = torch.minimum(entry_min, entry)
    listed = possible.sum()
    block_need = torch.where(alive.reshape(nb, 128), need.reshape(nb, 128),
                             -labs.BIG).amax(dim=1)
    eff = (possible & (entry_min <= block_need[:, None])).sum()
    return int(listed), int(eff)


@torch.no_grad()
def main(argv=None) -> int:
    from ..ops.block_trace import coherence_key
    args = labs.parse_args("binning_lab", __doc__, argv)
    dev = device_or_exit("binning_lab", args.device)
    z = np.load(args.waves)
    sa, prep, w_lo, w_hi = labs.load_scene(dev)
    print(f"{'batch':>10} {'alive':>6} | {'morton listed/eff':>20} | "
          f"{'firstcl listed/eff':>20}")
    for name, n_alive, for_shadow, cl_ok, tri_ok, o0, d0, alive0, tmax0 in \
            labs.batches(z, sa, dev):
        lo, hi = labs.global_bounds(w_lo, w_hi, cl_ok)
        key = coherence_key(o0, d0, alive0, lo, hi)
        o_m, d_m, tmax_c = labs.exit_cap(o0, d0, alive0, tmax0, lo, hi)
        # exact per-ray first cluster and the true best t (dense scan)
        fc = torch.cat([
            torch.argmin(labs.ray_entries(o_m[r0:r0 + 4096],
                                          d_m[r0:r0 + 4096],
                                          tmax_c[r0:r0 + 4096], cl_ok, w_lo,
                                          w_hi), dim=1)
            for r0 in range(0, o0.shape[0], 4096)]).to(torch.int32)
        need = labs.need(labs.dense_t(o_m, d_m, tri_ok, prep), tmax_c,
                         for_shadow)
        # int32 throughout, wrapping as the JAX tool's key does (its dead
        # rays' key overflows)
        firstcl = (fc * (1 << 8) + (key & 0x7F000000) // (1 << 24)
                   + (~alive0).to(torch.int32) * 0x7FFFFFFF)
        rows = []
        for k in (key, firstcl):
            perm = torch.argsort(k, stable=True)
            rows.append(block_stats(o_m[perm], d_m[perm], alive0[perm],
                                    tmax_c[perm], cl_ok, w_lo, w_hi,
                                    need[perm]))
        print(f"{name:>10} {n_alive:>6} | {rows[0][0]:>9}/{rows[0][1]:>9} | "
              f"{rows[1][0]:>9}/{rows[1][1]:>9}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
