"""Cross-validate the port's walks: the dense scan, the XLA cluster walk,
the block walk's twin, K1 at three block sizes, K2 and K3, on coherent
(camera) and incoherent (random, half-dead) rays.

Port of ``tools/validate_accel.py``: the same scene (``bench_scene(grid)``
at 160x90), the same three batches drawn in the same order from
``np.random.default_rng(seed)``, and the same comparison of each walk
against the dense scan: found masks equal on at least 99.9% of the live
rays, and the t of each walk's winner, recomputed from its plane, within
a relative 1e-4 of the dense winner's.  Each kernel is also held to its
twin on the same batch, exactly: t bit for bit, the same winner on every
ray both find, and for the block walk the same entries visited per block.

Usage (repository root):

    python -m rustray_tpu_torch.tools.validate_accel [grid] [n_rays]
        [--device cuda|cpu]

The walks: the dense scan (tile 2048), the XLA walk (block 512, gather
32) and the twin (block 512) print the JAX tool's lines (``twin`` for its
``pallas``); then K1 at ``block_n`` 128, 256 and 512, K2 (the pack budget
forced to 0, block 512) and K3 (``trace_tris_octets``, with the rays its
fallback re-traced through K1).  It runs on the card unless asked for the
CPU, where every kernel walk is its twin.  It prints ``ALL OK`` or
``MISMATCH`` and exits 1 on a mismatch.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

WIDTH, HEIGHT = 160, 90
KERNEL_BLOCKS = (128, 256, 512)


def _batch(kind, rng, n, sa, dev):
    """One batch, drawn as the JAX tool draws it: (o, d, alive)."""
    from ..ops import rays as rays_ops

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    if kind == "camera":
        px = torch.as_tensor(rng.integers(0, WIDTH, n), dtype=torch.int32,
                             device=dev)
        py = torch.as_tensor(rng.integers(0, HEIGHT, n), dtype=torch.int32,
                             device=dev)
        o, d = rays_ops.primary_rays(sa.camera, WIDTH, HEIGHT, px, py, 0, 0,
                                     1, 1.0, 1.0, 1)
        return o, d, torch.ones((n,), dtype=torch.bool, device=dev)
    o = f32(rng.uniform(-8, 8, (n, 3)))
    d = f32(rng.normal(size=(n, 3)))
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    if kind == "random":
        return o, d, torch.ones((n,), dtype=torch.bool, device=dev)
    # half-dead, shadow-like
    return o, d, torch.as_tensor(rng.uniform(size=n) < 0.5, device=dev)


def compare(kind, name, f, i, ref):
    """The JAX tool's comparison of a walk's (found, winner) against the
    dense scan's.  ``ref``: numpy (o, d, plane normals n, a·n, dense found,
    dense winner, live).  Returns (good, the tool's line)."""
    o_, d_, n_, an_, found_d, i_d, live = ref
    same_found = (f == found_d) | ~live

    def t_of(idx):
        # winners may differ on exact-t ties: compare recomputed t
        idx = np.clip(idx, 0, n_.shape[0] - 1)
        dn = (d_ * n_[idx]).sum(1)
        dn = np.where(np.abs(dn) > 1e-30, dn, 1.0)
        return (an_[idx] - (o_ * n_[idx]).sum(1)) / dn

    both = f & found_d & live
    t_ref = t_of(i_d)
    t_got = t_of(i)
    dif = np.abs(t_got[both] - t_ref[both])
    rel = dif / np.maximum(np.abs(t_ref[both]), 1e-6)
    close = bool((rel < 1e-4).all()) if both.any() else True
    nbad = int((rel >= 1e-4).sum()) if both.any() else 0
    # found-ness may differ on f32 slab-test boundary grazes (the dense
    # scan culls nothing): allow 0.1% of rays
    good = bool(same_found.mean() >= 0.999 and close)
    line = (f"  {kind:9s} {name:6s}: found-match={same_found.mean():.4f} "
            f"t-close={close} bad={nbad} "
            f"maxrel={float(rel.max()) if both.any() else 0:.2e}")
    return good, line


def _same_walk(got, want, visited=None):
    """Kernel against twin: t bit for bit, winners on rays both find, and
    the visited entries.  Returns (equal, what differs)."""
    from .walk_compare import same_as_twin
    agree, same_i, err = same_as_twin(got, want)
    bad = []
    if agree != 1.0 or err != 0.0:
        bad.append(f"t (found {agree:.5f}, max|dt| {err:.3g})")
    if same_i != 1.0:
        bad.append(f"winners ({same_i:.5f})")
    if visited is not None and not torch.equal(*visited):
        bad.append("visited entries")
    return not bad, ", ".join(bad)


def main(grid=3, n=4096, block_n=512, seed=0, device="cuda") -> int:
    from ..models.procedural import bench_scene
    from ..ops import block_trace as bt
    from ..ops import octet_trace as ot
    from ..ops.cluster_trace import select_closest_clusters, \
        world_cluster_aabbs
    from ..ops.intersect import INF, closest_tri, prepare_triangles
    from ..scene_arrays import to_torch
    from .devbench import device_or_exit
    dev = device_or_exit("validate_accel", device)
    scene = bench_scene(grid=grid, width=WIDTH, height=HEIGHT)
    sa, static = to_torch(*scene.compile(), dev)
    K = static.cluster_size
    prep = prepare_triangles(sa)
    prep = prep.replace(pallas_pack=bt.pack_cluster_tris(
        prep, sa.tri_valid, static.n_clusters, K, int(sa.cl_lo.shape[0])))
    pack = prep.pallas_pack
    w_lo, w_hi = world_cluster_aabbs(sa)
    tri_ok = sa.tri_valid & sa.inst_visible[sa.tri_inst.long()]
    cl_ok = sa.cl_valid & sa.inst_visible[sa.cl_inst.long()]
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
    print(f"tris={static.n_tris} clusters={static.n_clusters} "
          f"device={dev} ({name}) rays={n}")

    def found_idx(f_i_t):
        f, i, _ = f_i_t
        return f.cpu().numpy(), i.cpu().numpy()

    def kernel_walk(o, d, alive, bn, forced):
        """K1 (or K2 with the budget forced to 0) on prepared lists,
        against the twin on the same lists."""
        budget = bt._VMEM_PACK_BUDGET
        if forced:
            bt._VMEM_PACK_BUDGET = 0
        try:
            gated = bt.pack_is_gated(pack)
            lists = bt.prepare_walk(o, d, alive, None, w_lo, w_hi, cl_ok, bn)
            t_k, i_k, v_k = bt.block_walk(*lists, pack, "closest",
                                          gated=gated, return_visited=True)
            t_p, i_p, v_p = bt.block_walk(*lists, pack, "closest",
                                          interpret=True, gated=gated,
                                          return_visited=True)
        finally:
            bt._VMEM_PACK_BUDGET = budget
        equal, diff = _same_walk((t_k, i_k), (t_p, i_p), (v_k, v_p))
        t = t_k.reshape(-1)[:o.shape[0]]
        note = (f"twin: t, idx, visited equal ({int(v_k.sum())} entries "
                f"visited, at most {int(v_k.max())} per block of {bn})"
                if equal else f"twin: DIFFERS in {diff}")
        return equal, (t < INF).cpu().numpy(), \
            i_k.reshape(-1)[:o.shape[0]].cpu().numpy(), note

    def octet_walk(o, d, alive):
        ot.reset_counts()
        f_k, i_k, t_k = ot.trace_tris_octets(o, d, alive, None, prep, w_lo,
                                             w_hi, cl_ok, K)
        fb_rays, fb_calls = int(ot.fallback["rays"]), ot.fallback["calls"]
        _, i_p, t_p = ot.trace_tris_octets(o, d, alive, None, prep, w_lo,
                                           w_hi, cl_ok, K, interpret=True)
        equal, diff = _same_walk((t_k, i_k), (t_p, i_p))
        note = (f"twin: t, idx equal; fallback re-traced {fb_rays} of "
                f"{int(alive.sum())} live rays in {fb_calls} calls"
                if equal else f"twin: DIFFERS in {diff}")
        return equal, f_k.cpu().numpy(), i_k.cpu().numpy(), note

    rng = np.random.default_rng(seed)
    ok_all = True
    for kind in ("camera", "random", "halfdead"):
        o, d, alive = _batch(kind, rng, n, sa, dev)
        t_d, i_d = closest_tri(o, d, prep, tri_ok, 2048)
        print(f"  {kind}: dense done", flush=True)
        f_x, i_x = found_idx(select_closest_clusters(
            o, d, prep, tri_ok, w_lo, w_hi, cl_ok, K, block=block_n,
            gather=32))
        print(f"  {kind}: xla done", flush=True)
        f_p, i_p = found_idx(bt.trace_tris_blocks(
            o, d, alive, None, prep, w_lo, w_hi, cl_ok, K, block_n=block_n,
            interpret=True))
        print(f"  {kind}: twin done", flush=True)
        ref = (o.cpu().numpy(), d.cpu().numpy(), prep.n.cpu().numpy(),
               prep.an.cpu().numpy(), (t_d < INF).cpu().numpy(),
               i_d.cpu().numpy(), alive.cpu().numpy())
        for tag, f, i in (("xla", f_x, i_x), ("twin", f_p, i_p)):
            good, line = compare(kind, tag, f, i, ref)
            print(line)
            ok_all &= good
        kernels = [(f"K1/{bn}", lambda bn=bn: kernel_walk(o, d, alive, bn,
                                                          False))
                   for bn in KERNEL_BLOCKS]
        kernels += [(f"K2/{block_n}", lambda: kernel_walk(o, d, alive,
                                                          block_n, True)),
                    ("K3", lambda: octet_walk(o, d, alive))]
        for tag, walk in kernels:
            equal, f, i, note = walk()
            good, line = compare(kind, tag, f, i, ref)
            print(f"{line}; {note}", flush=True)
            ok_all &= good and equal
    print("ALL OK" if ok_all else "MISMATCH")
    return 0 if ok_all else 1


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rustray_tpu_torch.tools.validate_accel",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("grid", type=int, nargs="?", default=3)
    ap.add_argument("n_rays", type=int, nargs="?", default=4096)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    return main(args.grid, args.n_rays, device=args.device)


if __name__ == "__main__":
    sys.exit(cli())
