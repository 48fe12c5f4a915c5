"""Octet-granularity pair statistics, sizing the octet rounds (K3).

Port of ``tools/octet_lab.py``.  The design under test: rays
coherence-sorted; per-ray exact cluster slab tests OR-folded to octets (8
consecutive rays, one warp of the octet kernels); round 0 takes each
octet's nearest-entry cluster, round 1 the remaining pairs whose entry is
within the octet's need after round 0.

For each batch of the ``capture_waves`` .npz it prints: exact per-ray
pairs (the floor), octet-listed pairs (no early exit), round-1 pairs with
the true best t pruning each ray, folded to octets (the workload is round
0 + round 1), live octets, the most pairs of one octet, and the octets
with round-1 work.

Usage (repository root; on the card unless asked for the CPU):

    python -m rustray_tpu_torch.tools.octet_lab [waves.npz]
        [--device cuda|cpu]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import labs
from .devbench import device_or_exit


def octet_stats(o, d, alive, tmax, cl_ok, w_lo, w_hi, need):
    """One slice's (per-ray pairs, octet-listed pairs, round-1 pairs, live
    octets, most pairs of an octet, octets with round-1 work); ``need``
    (n,) is each ray's min(true best t, t_max)."""
    from ..ops.intersect import INF
    entry = labs.ray_entries(o, d, tmax, cl_ok, w_lo, w_hi)
    ok = (entry < INF) & alive[:, None]
    no = o.shape[0] // 8
    entry_o = torch.where(ok, entry, INF).reshape(no, 8, -1)
    listed_o = torch.any(ok.reshape(no, 8, -1), dim=1)         # (no, C)
    # round 0: each octet's nearest-entry cluster
    first = torch.argmin(torch.amin(entry_o, dim=1), dim=1)    # (no,)
    # per-ray effective (entry within its own need), folded to octets
    eff_r = ok & (entry <= need[:, None] * 1.0001 + 1e-3)
    eff_o = torch.any(eff_r.reshape(no, 8, -1), dim=1)
    # round 1 = effective minus the round-0 cluster
    is_first = torch.nn.functional.one_hot(first, entry.shape[1]).bool()
    p2 = eff_o & ~is_first
    cnt_o = listed_o.sum(dim=1)
    return (int(ok.sum()), int(listed_o.sum()), int(p2.sum()),
            int(listed_o.any(dim=1).sum()), int(cnt_o.max()),
            int((p2.sum(dim=1) > 0).sum()))


@torch.no_grad()
def main(argv=None) -> int:
    args = labs.parse_args("octet_lab", __doc__, argv)
    dev = device_or_exit("octet_lab", args.device)
    z = np.load(args.waves)
    sa, prep, w_lo, w_hi = labs.load_scene(dev)
    print(f"{'batch':>10} {'alive':>6} | {'perray':>8} {'oct_list':>9} "
          f"{'oct_p2':>8} {'liveoct':>7} {'maxoct':>6} {'p2oct':>6}")
    tot = np.zeros(3, np.int64)
    for name, n_alive, for_shadow, cl_ok, tri_ok, o, d, alive, tmax in \
            labs.batches(z, sa, dev):
        o, d, alive, tmax = labs.sorted_preamble(o, d, alive, tmax, w_lo,
                                                 w_hi, cl_ok)
        need = labs.need(labs.dense_t(o, d, tri_ok, prep), tmax, for_shadow)
        acc = np.zeros(6, np.int64)
        for r0 in range(0, o.shape[0], 4096):
            sl = slice(r0, r0 + 4096)
            vals = octet_stats(o[sl], d[sl], alive[sl], tmax[sl], cl_ok,
                               w_lo, w_hi, need[sl])
            acc[:4] += vals[:4]
            acc[4] = max(acc[4], vals[4])
            acc[5] += vals[5]
        print(f"{name:>10} {n_alive:>6} | {acc[0]:>8} {acc[1]:>9} "
              f"{acc[2]:>8} {acc[3]:>7} {acc[4]:>6} {acc[5]:>6}")
        tot += [acc[0], acc[1], acc[3] + acc[2]]
    print(f"\ntotals: per-ray {tot[0]}, octet-listed {tot[1]}, "
          f"phase1+2 workload {tot[2]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
