"""The octet rounds (K3) at the bench shapes: their checks against the
twins, their work and bound, and the slice against an earlier
``octet_trace.cu``.

The inputs are those of ``chip_smoke.py`` phase 3: the first 32,768-ray
slice of the 1280x720 bench frame's middle-chunk primary rays and of their
level-1 shadow rays, coherence-sorted and dead-masked as
``trace_tris_octets`` does.  :func:`check_rounds` holds both round kernels
to their twins exactly (round 0: e, c0, t, idx; round 1 in both modes: t,
idx, over, slots, remaining); :func:`round_work` counts what each round
needs on these inputs and the least time the card could take for it.

Usage (repository root, one CUDA card):

    python -m rustray_tpu_torch.tools.round_compare [OLD_OCTET_TRACE_CU]

Given the path of an earlier ``octet_trace.cu`` with the one-round C
interface ``rr_octet_round(flags, rays, desc, pack, t, idx, steps, slots,
K, stream)`` (the selection then runs in torch: ``octet_entries``, the
argmins, the need filter), it builds that source with the same nvcc flags
and times the whole slice (selection plus both rounds) both ways in
turns: old, new, new, old.  Each result is printed as one JSON line.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

# FP32 operations of one ray x cluster entry in round 0 (6 products, 6
# differences, 6 min/max per axis, 4 to fold the axes, the clamp, 2
# comparisons, the octet minimum) and of one entry of a live octet's row
# in round 1 (the c0 and need comparisons, the top-4 comparison)
ENTRY_OPS = 26
SELECT_OPS = 3


def slice_inputs(o, d, alive, t_max):
    """A set's first slice, dead-masked as trace_tris_octets masks it."""
    from ..ops.block_trace import DEAD_ORIGIN
    from ..ops.intersect import INF
    from ..ops.octet_trace import _SLICE
    a = alive[:_SLICE]
    tm = torch.full_like(a, INF, dtype=torch.float32) if t_max is None \
        else t_max[:_SLICE]
    return (torch.where(a[:, None], o[:_SLICE], DEAD_ORIGIN).contiguous(),
            torch.where(a[:, None], d[:_SLICE], 1.0).contiguous(),
            torch.where(a, tm, -1.0).contiguous())


def _bound(flops, nbytes):
    from .walk_compare import bound
    ms, by = bound(flops, nbytes)
    return dict(flops=flops, bytes=nbytes, bound_ms=ms, bound_by=by)


def round_work(o, t_max, e, c0, slots, pack):
    """Each round's work on one slice, from the twin's outputs.  Round 0:
    ENTRY_OPS per ray x cluster entry of the live octets (any ray with
    t_max >= 0) and 31 per ray x triangle test in slab c0 where the row
    names one; bytes: boxes, every t_max and the live octets' o and d,
    the e rows written, c0's slabs, c0, t and idx.  Round 1: SELECT_OPS
    per entry of a live row and 31 per test of its non-empty slots;
    bytes: every t_max and round 0's t, idx and c0, the o and d of octets
    with a slot, the live rows of e, the slots' slabs, the outputs.
    Returns (round 0 dict, round 1 dict) with tests and bound."""
    from ..ops.intersect import INF
    from .walk_compare import FLOPS_PER_TEST
    n, (no, C), K = o.shape[0], e.shape, pack.shape[2]
    dummy = pack.shape[0] - 1
    live = (t_max.reshape(no, 8) >= 0).any(dim=1)
    n_live = int(live.sum())
    named0 = live & (e.amin(dim=1) < INF)
    tests0 = int(named0.sum()) * 8 * K
    slab = 12 * K * 4
    w0 = _bound(
        n_live * 8 * C * ENTRY_OPS + tests0 * FLOPS_PER_TEST,
        C * 25 + n * 4 + n_live * 8 * 24 + no * C * 4
        + int(torch.unique(c0[named0]).numel()) * slab + n * 8 + no * 4)
    w0["tests"] = tests0
    full = slots != dummy
    tests1 = int(full.sum()) * 8 * K
    w1 = _bound(
        n_live * C * SELECT_OPS + tests1 * FLOPS_PER_TEST,
        n * 12 + int(full.any(dim=1).sum()) * 8 * 24 + no * 4
        + n_live * C * 4
        + int(torch.unique(slots[full]).numel()) * slab + n * 8
        + no * (16 + 4 + 1))
    w1["tests"] = tests1
    return w0, w1


def check_rounds(o, d, t_max, boxes, cl_ok, pack, modes):
    """Both round kernels against their twins on one slice, exactly: round
    0 (e, c0, t, idx), then round 1 in each mode on the same round-0
    outputs (t, idx, over, slots, remaining).  Raises on any difference.
    Returns (round 0 outputs, {mode: round 1 outputs}) of the twin."""
    from ..ops import octet_trace as ot
    r0k = ot.round0(o, d, t_max, *boxes, cl_ok, pack)
    r0p = ot.round0(o, d, t_max, *boxes, cl_ok, pack, interpret=True)
    torch.cuda.synchronize()
    _equal("round 0", ("e", "c0", "t", "idx"), r0k, r0p)
    r1 = {}
    for mode in modes:
        r1k = ot.round1(o, d, t_max, *r0p, pack, mode)
        r1[mode] = ot.round1(o, d, t_max, *r0p, pack, mode, interpret=True)
        torch.cuda.synchronize()
        _equal(f"round 1 ({mode})",
               ("t", "idx", "over", "slots", "remaining"), r1k, r1[mode])
    return r0p, r1


def _equal(what, names, got, want):
    for name, g, w in zip(names, got, want):
        if g.dtype != w.dtype or not torch.equal(g, w):
            bad = int((g != w).sum()) if g.shape == w.shape else -1
            raise RuntimeError(f"octet {what}: kernel {name} differs from "
                               f"the twin's ({g.dtype} vs {w.dtype}, {bad} "
                               f"entries differ)")


def load_old(src: str) -> ctypes.CDLL:
    """An earlier octet_trace.cu (one-round C interface), built and
    loaded."""
    from .walk_compare import build_source
    lib = build_source(src, "octet_trace_old")
    lib.rr_octet_round.argtypes = [ctypes.c_void_p] * 6 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.rr_octet_round.restype = ctypes.c_int
    return lib


def _old_round(lib, rays, desc, slots, pack, dummy):
    from ..ops import octet_trace as ot
    n = desc.shape[0] * 8
    flags, r, rows = ot.round_inputs(rays, desc, slots, dummy)
    n_rows = r.shape[0]
    t = torch.empty((n_rows,), dtype=torch.float32, device=r.device)
    i = torch.empty((n_rows,), dtype=torch.int32, device=r.device)
    err = lib.rr_octet_round(flags.data_ptr(), r.data_ptr(), rows.data_ptr(),
                             pack.data_ptr(), t.data_ptr(), i.data_ptr(),
                             rows.shape[0], slots, pack.shape[2],
                             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"old octet round launch failed: CUDA error "
                           f"{err}")
    return t[:n], i[:n]


def old_slice(lib, o, d, t_max, boxes, cl_ok, pack, mode):
    """The earlier design's slice: the torch selection around two launches
    of the earlier round kernel.  Returns (t, idx, over)."""
    from ..ops import octet_trace as ot
    dummy = pack.shape[0] - 1
    e = ot.octet_entries(o, d, t_max, *boxes, cl_ok)
    rays = ot._rays(o, d, t_max)
    desc0, c0 = ot.round0_desc(e, dummy)
    t, idx = _old_round(lib, rays, desc0, 1, pack, dummy)
    desc1, remaining = ot.round1_desc(e, c0, t, t_max, mode, dummy)
    t1, i1 = _old_round(lib, rays, desc1, ot._R1_SLOTS, pack, dummy)
    better = t1 < t
    return (torch.where(better, t1, t), torch.where(better, i1, idx),
            remaining > ot._R1_SLOTS)


def new_slice(o, d, t_max, boxes, cl_ok, pack, mode, interpret=False):
    """This design's slice: round 0 and round 1.  Returns (t, idx, over)."""
    from ..ops import octet_trace as ot
    r0 = ot.round0(o, d, t_max, *boxes, cl_ok, pack, interpret=interpret)
    return ot.round1(o, d, t_max, *r0, pack, mode, interpret=interpret)[:3]


def main(argv=None) -> int:
    from .octet_kernel_bench import cuda_ms
    from .walk_compare import bench_inputs, same_as_twin
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("round_compare: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    old = load_old(argv[0]) if argv else None
    prep, boxes, sets = bench_inputs()
    pack = prep.pallas_pack
    for name, _, o, d, alive, t_max, cl_ok in sets:
        o, d, t_max = slice_inputs(o, d, alive, t_max)
        r0, r1 = check_rounds(o, d, t_max, boxes, cl_ok, pack,
                              ("closest", "any"))
        for mode in ("closest", "any"):
            w0, w1 = round_work(o, t_max, r0[0], r0[1], r1[mode][3], pack)
            row = dict(set=name, mode=mode, rays=o.shape[0],
                       kernels_equal_twins=True, round0=w0, round1=w1,
                       remaining_over_4=int(r1[mode][2].sum()))

            def run_new():
                new_slice(o, d, t_max, boxes, cl_ok, pack, mode)
            if old is not None:
                row["old_vs_twin"] = same_as_twin(
                    old_slice(old, o, d, t_max, boxes, cl_ok, pack,
                              mode)[:2], r1[mode][:2])

                def run_old():
                    old_slice(old, o, d, t_max, boxes, cl_ok, pack, mode)
                o1 = cuda_ms(run_old, 5)
                n1 = cuda_ms(run_new, 5)
                n2 = cuda_ms(run_new, 5)
                o2 = cuda_ms(run_old, 5)
                row.update(old_slice_ms=[o1, o2], new_slice_ms=[n1, n2])
            else:
                row["new_slice_ms"] = [cuda_ms(run_new, 5)]
            print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
