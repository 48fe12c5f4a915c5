"""Gather and scatter cost against table layout, on the card.

Port of ``tools/gather_bench.py``: PyTorch's own gathers and scatters
(library calls on purpose: it measures them, not a kernel of the port) on
the table sizes of the bench frame's per-winner attribute fetches,
T = 331,904 rows and N = 262,144 random indices (``torch.randint`` from
seed 0 on the device): rows of width 1-128, sorted indices, a scalar
table, a lane-major (16, T) table through ``take_along_dim``, the
two-level pick from a (T/128, 128, 16) table, and a (T, 4) scatter and
scatter-add.  Each is timed by ``devbench.device_time`` (5 calls).

Usage (repository root; on the card unless asked for the CPU):

    python -m rustray_tpu_torch.tools.gather_bench [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys

import torch

T = 331904
N = 262144


@torch.no_grad()
def bench(t_rows: int = T, n_idx: int = N, device: str = "cuda",
          iters: int = 5):
    """Every layout on ``device``; returns {name: device ms} (also
    printed)."""
    from .devbench import device_time
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(0, t_rows, (n_idx,), generator=gen, device=dev)
    idx_sorted = torch.sort(idx).values
    out = {}

    def run(name, fn, *args):
        ms = device_time(fn, *args, iters=iters)
        out[name] = ms
        print(f"{name:44s} {ms:8.3f} ms  ({ms * 1e6 / n_idx:6.1f} ns/row)",
              flush=True)

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    for F in (1, 3, 8, 16, 32, 128):
        run(f"rows ({t_rows},{F})[idx]", lambda t, i: t[i], zeros(t_rows, F),
            idx)
    tab16 = zeros(t_rows, 16)
    run("rows (T,16)[idx_sorted]", lambda t, i: t[i], tab16, idx_sorted)
    run("scalar (T,)[idx]", lambda t, i: t[i], zeros(t_rows), idx)
    # lane-major: the table transposed to (16, T), gathered along T
    run("lanes (16,T) take_along_dim",
        lambda t, i: torch.take_along_dim(t, i[None].expand(16, n_idx),
                                          dim=1), zeros(16, t_rows), idx)
    # two levels: the row of 128, then the lane within it
    run("3d (T/128,128,16) [q] then lane-pick",
        lambda t, i: torch.take_along_dim(
            t[i // 128], (i % 128)[:, None, None], dim=1)[:, 0],
        zeros(t_rows // 128, 128, 16), idx)
    src = zeros(n_idx, 4)
    big = zeros(t_rows, 4)
    run("scatter (T,4).index_put", lambda b, i, s: b.index_put((i,), s),
        big, idx, src)
    run("scatter-add (T,4).index_add", lambda b, i, s: b.index_add(0, i, s),
        big, idx, src)
    return out


def main(argv=None) -> int:
    from .devbench import device_or_exit
    ap = argparse.ArgumentParser(
        prog="python -m rustray_tpu_torch.tools.gather_bench",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if device_or_exit("gather_bench", args.device).type == "cpu":
        print("device: host CPU (these are not device times)")
    bench(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
