#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (rustray_tpu_torch) on one card.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints its result; any failure raises and exits non-zero):
  1. the card: nvidia-smi name and power limit, torch's device name, the
     CUDA runtime and driver versions (csrc/graph_cond.cu built first to
     ask them) and torch's allocator calls that route an IF node body's
     allocations to its graph's pool; TF32 off for matmuls and
     convolutions;
  2. build: nvcc builds every kernel from the checkout's sources, one
     process per source, all at once (csrc/block_trace.cu, block_lists.cu,
     octet_trace.cu, octet_bench.cu, graph_cond.cu, mat_rows.cu), with
     their ptxas lines;
  3. kernels vs twins on the full bench scene (data/bench, 249,698
     triangles in 2,593 clusters), on the primary rays of one 32768-pixel
     chunk and their level-1 shadow rays, timed: the block walk gated (K1)
     and ungated (K2), closest and any-hit (t, winners and the entries
     each block visited equal to the twin's; the work the walk needs and
     its bound printed per launch); the octet rounds (K3, round 0 and
     round 1 with the selection fused in) exactly against their twins on
     each set's first slice, round 1 in both modes, with the slice's time;
     a tie check of torch.argmin on the card;
  4. the main path: render() of the 1280x720 bench frame with the bench
     engine settings, counting kernel launches, drops and device rays;
     render() takes its frame path, so the chunk program runs as CUDA
     graphs (one capture per queue factor, one replay per chunk and cell;
     the gates on all-dead work are IF nodes, and a replay's launches are
     added at the group's fetch from the device's run counts of the
     nodes), as in every render() below without a checkpoint, preview or
     max_chunks;
  5. a 160x90 frame through the kernel against the JAX package's render of
     it (tests/data/jax_bench_160x90.npz, written on the CPU by
     tests/data/make_jax_bench_reference.py), and a 320x180 frame through
     the kernel and through its twin, compared;
  6. the octet path: the bench frame with pallas_algo="octet";
  7. the large-pack path: the bench frame at 1 spp with the pack budget
     forced to 0, so every block walk is the ungated K2;
  8. 320x180 frames: octet against block, K2 against K1;
  9. the octet kernel bench (K4): the port's capture of the middle chunk's
     level-3 closest wavefront, then every variant, timed, with its bound,
     and exactly against its twin (t and idx), on the wavefront and on
     probe rays that hit, where the wavefront rarely does;
 10. the user's entry points: the CLI (``rustray_tpu_torch.cli.main``)
     renders the 1280x720 bench frame at 1 spp on the card by default,
     through K1, with a preview; its PNG and preview equal the session's
     image; a 320x180 render interrupted by its checkpoint resumes into the
     uninterrupted one bit for bit; a 320x180 frame through the XLA cluster
     walk (plain torch on the card) against the K1 frame, both timed;
     cavity + outline post-processing on the card against the CPU; and
     RenderSession.pick on CUDA against CPU tensors;
 11. scene gradients (rustray_tpu_torch.parallel.shard): (a)
     render_loss_and_grad of the bench scene at 640x360, 1 spp, all 5
     levels, through K1 in its forward pass, against render() of the scene
     with base_color halved, timed beside the forward-only render(), with
     its peak memory, and every K1 launch of that pass held to the twin
     bit for bit on a sample of its blocks (the first and last 128 and
     256 drawn); (b) at 320x180 the gradient through K1, the octet rounds
     (K3), the twin and the XLA walk, held to K1's; (c) at 160x90 central
     differences on the most-hit material; (d) two gloo ranks on the card
     (python -m rustray_tpu_torch.parallel.dryrun 2 --backend gloo --scene
     bench), started after (b) and run beside (c), on meshes 2x1 and 1x2
     against the one-rank run: render, loss, gradients and one SGD
     step;
 12. the frame path against the eager chunk program (build_chunk_fn per
     chunk, with its host syncs): the bench frames of phases 4 (K1) and 6
     (K3 with its K1 fallback) rendered again eagerly, equal bit for bit in
     every AOV, the image, device and dropped rays and the fallback's rays,
     with both frames' seconds, the captures, their seconds, their IF
     nodes and the replays; then each frame replayed (no capture): equal
     to the eager frame, its launches equal to the eager program's in
     every counter and in the fallback's calls; a glass variant of the tests'
     bench mini-scene whose queue factor 1.0 is raised twice over three
     chunks, and then the plain mini-scene sharing its static, back to
     back, each equal to its own eager frame;
 13. the repo's tools (rustray_tpu_torch/tools): validate_accel at grid 3
     with 4,096 rays and at grid 6 with 98,304 rays (camera, random and
     half-dead batches; the dense scan, the XLA walk, the twin, K1 at
     block_n 128, 256 and 512, K2 with the budget forced to 0 and K3, each
     against the dense scan at the tool's thresholds and each kernel
     against its twin bit for bit, with the octet fallback's rays);
     kernel_probe (K1 on 98,304 primary rays of the bench frame at block_n
     128, 256 and 512: wall and device time, work and bound); and
     walltime_probe's split of the 1-spp bench frame (capture, argument
     upload, dispatch, device completion, fetch);
 14. the renderer cache across frames (render/wavefront._RENDERER_CACHE):
     (a) from an empty cache, RenderSession(animate=True) on the card over
     a 3-frame animation of the bench scene at 1280x720, 1 spp (a scene
     JSON in a temporary directory: the bench GLB, one ball rising, fps 3,
     keyframes at 0 and 1000 ms): one capture per queue factor for the
     whole session, each frame equal bit for bit to the eager frame
     program on its scene (and a frame that captures nothing launching
     K1 as often as it), 0 dropped rays, frames 1 and 2 moved against
     frame 0, with each frame's compile, render() and capture seconds;
     (b) the 1-spp bench frame twice through render() on K1, the octet
     path (K3 with its K1 fallback) and K2 (budget forced to 0): the
     second call captures nothing, replays as the first, launches what the
     eager frame launches and equals it and the eager frame; (c) a light's
     intensity halved in place in the same tensor: the next render() sees
     it and equals the eager render; (d) the glass mini-scene at two chunk
     sizes, A, B, A, each equal to a fresh render of its key, the third
     with no capture; (e) the memory reserved after a render and after
     _RENDERER_CACHE.clear() and empty_cache();
 15. conditional graph nodes (csrc/graph_cond.cu): two gates nested in a
     captured graph over 32,768 rays, replayed with both masks dead, the
     outer dead and the inner live, the outer partly live and the inner
     dead, both partly live and both live: each replay equal to the eager
     gates, with the nodes' run counts; the gate on a dead mask timed in a
     graph of 64 and eagerly;
 16. the 1-spp bench frame through K1 and through the octet path, each
     replayed (the graphs its first frame captured) and eagerly under
     torch.profiler, each in a process of its own
     (rustray_tpu_torch.tools.profile_frame): device busy time, idle share
     and the port's kernels' calls in each trace side by side;
 17. the block-list kernel (csrc/block_lists.cu, the interval test of
     ops/block_trace._block_lists) on the main path's shapes: the middle
     chunk of the bench frame captured with the CLI's engine (65,536
     pixels, queue factor 4), its level-1 primary and shadow rays and its
     level-3 shadow rays (NB 512, 1,536 and 6,144 blocks of 128 against
     2,593 clusters), coherence-sorted as the walks see them: keys,
     descriptors, counts and the sorted lists equal to the twin's bit for
     bit, the kernel timed beside the twin and its bound (FP32 operations
     the inputs need at 67 TFLOP/s, or the bytes at 3.35 TB/s).  Every
     frame of phases 4, 6, 7, 12 and 14 checks that it launched once per
     walk (list_launches equal to K1's and K2's launches, eager and
     replayed);
 18. the gradient at the main path's size: render_loss_and_grad of the
     1280x720 bench frame at 4 spp through K1, in chunks of 524,288
     pixels per call (the sponza_inverse configuration's), timed with its
     peak memory, its forward and backward device milliseconds
     (shard.grad_stats) and the launches of the material-row and threefry
     kernels; its
     image equal to render()'s for the same engine and seed,
     and no ray dropped;
 19. the material-row kernel (csrc/mat_rows.cu, the backward of
     hit_attributes' per-ray gather of the (37, 16) material table) on
     the main path's shapes: the cotangents and materials of a 1-spp
     gradient at chunk 524,288, at level 1 (524,288 rays) and at a deep
     level (the queue of 2,097,152): against a float64 index_add_ at
     relative L2 1e-6 and bit for bit across two launches, timed beside
     its byte bound (N * 68 + M * 64 bytes at 3.35 TB/s), its twin
     (index_add_) and PyTorch's indexing backward of the same gather;
 20. the threefry kernels (csrc/threefry.cu, rng.fold_in and rng.uniform
     on CUDA tensors): uniform at the still frame's jitter shapes
     (65,536 and 262,144 rays, x 2 and x 3 lights x 2) and at odd sizes,
     from a device key and from host key words, and fold_in with int and
     tensor data, bit for bit against the plain twin on the card; each
     kernel's mean over a graph of 20 launches beside the twin's chain
     (in a graph too) and its bound (the 43 shift and logic operations an
     element that only the integer pipe runs, at 16.7 T ops/s, or 4 bytes
     an element at 3.35 TB/s); phase 4's frame rendered again with the
     twin in the kernels' place (captured anew), equal bit for bit in
     every AOV; a 1-spp 1280x720 gradient at chunk
     524,288 with the kernels twice and with the twin: image and loss
     equal bit for bit, gradients within the kernels' own run-to-run
     difference; and the kernels a replayed 2-spp K1 frame launches, with
     the twin and with the kernels, each counted in a torch.profiler trace
     in a process of its own (``python3 chip_smoke.py --replay-kernels
     twin|kernel``);
 21. the glTF material model (the benchmark's sponza_pbr scene, written by
     perfbench/scenes/sponza_pbr.py: every material with 1024² base-colour,
     normal and metallic-roughness maps, cut-out foliage on 9 spheres) at
     320x180, 2 spp, with the CLI's engine: the frame that captures, a
     replayed frame and the eager chunk program's frame equal bit for bit,
     and the shading census (render/wavefront.shading: hits, cut-out
     refraction children, texture fetches) equal between the replayed and
     the eager frame, 4 fetches a hit; the 1-spp bench frame, whose only
     maps are base colour, counts nothing (``python3 chip_smoke.py --pbr``
     runs this phase alone).

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  SMOKE_SAMPLES overrides the sample count of
phases 4 and 6 (default 2).
"""
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1280, 720
CHUNK = 32768
BLOCK = 128
# device rays of the 1280x720 bench frame, 1 sample, rendered by the JAX
# package itself (XLA cluster walk, same engine settings) on an H100
RAYS_PER_SAMPLE = 10908817
# the same count recorded by the JAX package's TPU bench run (527,835,561
# rays over 128 samples, BENCH_r05.json): printed for comparison only, as
# the JAX package on the CPU and on the GPU counts 2.6x more (PERF.md)
TPU_RAYS_PER_SAMPLE = 527835561 / 128
# the JAX package's render of the bench scene at 160x90, 1 sample, on the
# CPU: 8-bit image, object ids and device rays
JAX_REFERENCE = os.path.join(ROOT, "tests", "data", "jax_bench_160x90.npz")
# the TPU kernels the port's kernels replace (file:line of the Pallas
# kernel body)
TPU_K1 = "rustray_tpu/ops/block_trace.py:279"
TPU_K2 = "rustray_tpu/ops/block_trace.py:434"
TPU_K3 = "rustray_tpu/ops/octet_trace.py:109"
TPU_K4 = "tools/octet_kernel_bench.py:29"
# the sites of the JAX package's device-side skips (jax.lax.cond) that the
# port's conditional graph nodes (csrc/graph_cond.cu::set_if) replace
TPU_CONDS = ("rustray_tpu/render/wavefront.py:383",
             "rustray_tpu/ops/traverse.py:331",
             "rustray_tpu/ops/octet_trace.py:306",
             "rustray_tpu/ops/octet_trace.py:361")
# the JAX package's block-list prologue, which XLA fuses: no Pallas kernel
TPU_LISTS = ("none: rustray_tpu/ops/block_trace.py::_block_lists is XLA, "
             "not Pallas")
# the JAX package's material-row gather, whose transpose XLA derives
TPU_MAT_ROWS = ("none: the backward of rustray_tpu/ops/traverse.py::"
                "hit_attributes' material gather is XLA's transpose")
# the JAX package draws with jax.random, which XLA compiles: no Pallas kernel
TPU_RNG = "none: jax.random's threefry is XLA, not Pallas"
KERNEL_SOURCES = ("block_trace", "block_lists", "octet_trace", "octet_bench",
                  "graph_cond", "mat_rows", "threefry")
# the still frame's jitter draws per level: a chunk of 65,536 pixels at
# queue factors 1 and 4, the roughness jitter (N, 2) and the soft shadows'
# (N, 3 lights, 2)
RNG_SHAPES = ((65536, 2), (262144, 2), (65536, 3, 2), (262144, 3, 2))
# threefry's 32-bit operations per element (csrc/threefry.cu): all of
# them, and those only the integer pipe runs (its shifts and logic; the adds
# may run on the FMA pipe), and that pipe's rate (132 SMs x 64 lanes x
# 1.98 GHz)
RNG_OPS, RNG_ALU_OPS, INT32_OPS_S = 80, 43, 16.7e12


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _cuda_ms(fn, iters):
    from rustray_tpu_torch.tools.octet_kernel_bench import cuda_ms
    return cuda_ms(fn, iters)


def _graph_ms(fn, inputs, iters):
    """Device ms per call of ``fn``: one CUDA graph of ``iters`` calls, call
    i on ``inputs[i % len(inputs)]``, replayed between two CUDA events, so
    no host launch is in the time."""
    import torch
    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _row():
    return dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                bound_by="operations", tests=0)


def compare_walks(prep, boxes, sets):
    """Phase 3: the block walk and its twin on the same visit lists, gated
    (K1) and ungated (K2), both modes: t, winners and the entries each
    block visited must be equal; the walk's work and bound are printed.
    Returns {(gated, mode): row} of the kernel table (without launches)."""
    import torch
    from rustray_tpu_torch.ops import block_trace as bt
    from rustray_tpu_torch.tools.walk_compare import same_as_twin, walk_work
    w_lo, w_hi = boxes
    pack = prep.pallas_pack
    rows = {(g, m): _row() for g in (True, False) for m in ("closest", "any")}
    for name, _, o_s, d_s, alive_s, tmax_s, cl_ok in sets:
        lists = bt.prepare_walk(o_s, d_s, alive_s, tmax_s, w_lo, w_hi, cl_ok,
                                BLOCK)
        n = o_s.shape[0]
        for gated in (True, False):
            tag = "K1" if gated else "K2"
            for mode in ("closest", "any"):
                t_k, i_k, v_k = bt.block_walk(*lists, pack, mode,
                                              gated=gated,
                                              return_visited=True)
                t_p, i_p, v_p = bt.block_walk(*lists, pack, mode,
                                              interpret=True, gated=gated,
                                              return_visited=True)
                torch.cuda.synchronize()
                agree, same_i, err = same_as_twin((t_k, i_k), (t_p, i_p))
                _check(agree == 1.0 and same_i == 1.0 and err == 0.0,
                       f"{tag} {name}/{mode}: kernel and twin differ (found "
                       f"{agree:.5f}, winners {same_i:.5f}, max|dt| {err})")
                _check(torch.equal(v_k, v_p), f"{tag} {name}/{mode}: "
                       "visited entries differ from the twin's")
                work = walk_work(lists, v_p, pack.shape[2], gated)
                ms = _cuda_ms(lambda: bt.block_walk(*lists, pack, mode,
                                                    gated=gated), 5)
                plain = _cuda_ms(lambda: bt.block_walk(
                    *lists, pack, mode, interpret=True, gated=gated), 1)
                print(f"phase 3: {tag} {name:7s} {mode:7s} rays={n} "
                      f"found={agree:.5f} agree, winners {same_i:.5f}, "
                      f"hits={int((t_k < 3e38).sum())}, max|dt|={err:.3g}, "
                      f"visited equal, kernel {ms:.3f} ms, twin "
                      f"{plain:.3f} ms")
                print(f"phase 3: {tag} {name:7s} {mode:7s} work: blocks "
                      f"{work['blocks']}, entries visited {work['entries']} "
                      f"(median {work['median']:g}, max {work['max']}), "
                      f"listed quads per entry "
                      f"{work['quads_per_entry']:.3f}, tests "
                      f"{work['tests']}, clusters {work['clusters']}; bound "
                      f"FP32 {work['fp32_ms']:.4f} ms, bytes "
                      f"{work['bytes_ms']:.4f} ms; kernel at "
                      f"{work['bound_ms'] / ms:.2%} of its bound")
                row = rows[(gated, mode)]
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row["ms"] += ms
                row["plain_ms"] += plain
                row["bound_ms"] += work["bound_ms"]
                row["bound_by"] = work["bound_by"]
                row["tests"] += work["tests"]
    return rows


def compare_lists(smi, sa, static, cfg):
    """Phase 17: the block-list kernel against its twin at the main path's
    shapes, timed beside the twin and its bound.  Returns the kernel
    table's row (without launches)."""
    import torch
    from rustray_tpu_torch import EngineConfig
    from rustray_tpu_torch.ops import block_trace as bt
    from rustray_tpu_torch.ops.cluster_trace import world_cluster_aabbs
    from rustray_tpu_torch.ops.traverse import coherence_sort, instance_mask
    from rustray_tpu_torch.tools.capture_waves import capture
    from rustray_tpu_torch.tools.walk_compare import list_work
    start = time.perf_counter()
    eng = EngineConfig()
    cfg.samples = 1
    waves = capture(sa, static, cfg, eng, chunk=eng.chunk_pixels,
                    start_chunk=WIDTH * HEIGHT // 2 // eng.chunk_pixels)
    w_lo, w_hi = world_cluster_aabbs(sa)
    row = _row()
    for name, for_shadow in (("closest_1", False), ("shadow_1", True),
                             ("shadow_3", True)):
        o, d, alive, t_max = (torch.as_tensor(waves[f"{name}_{k}"],
                                              device="cuda")
                              for k in ("o", "d", "alive", "tmax"))
        inst_ok = instance_mask(sa, for_shadow, False)
        cl_ok = sa.cl_valid & inst_ok[sa.cl_inst.long()]
        _, o, d, alive, t_max = coherence_sort(o, d, alive, t_max, w_lo,
                                               w_hi, cl_ok)
        o, d, alive, t_max, nb = bt.pad_rays(o, d, alive, t_max, BLOCK)
        args = (o, d, alive, t_max, w_lo, w_hi, cl_ok, nb, BLOCK)
        key, cid, count = bt._list_keys_cuda(*args)
        key_t, cid_t, count_t = bt._list_keys_twin(*args)
        cpad = -(-w_lo.shape[0] // 128) * 128
        lists = bt._block_lists(*args, cpad)
        lists_t = bt._block_lists(*args, cpad, interpret=True)
        torch.cuda.synchronize()
        same = (torch.equal(key.view(torch.int32), key_t.view(torch.int32))
                and torch.equal(cid, cid_t) and torch.equal(count, count_t)
                and all(torch.equal(a, b) for a, b in zip(lists, lists_t)))
        _check(same, f"phase 17: {name}: the list kernel differs from its "
               "twin")
        ms = _cuda_ms(lambda: bt._list_keys_cuda(*args), 20)
        plain = _cuda_ms(lambda: bt._list_keys_twin(*args), 2)
        sort_ms = _cuda_ms(lambda: bt._block_lists(*args, cpad), 5) - ms
        work = list_work(o, d, alive, cl_ok, nb, BLOCK)
        print(f"phase 17: {name:9s} NB {nb} x C {w_lo.shape[0]}: key, cid, "
              f"count and the sorted lists equal to the twin's; live "
              f"sub-blocks {work['live_subblocks']} of {4 * nb}, listed "
              f"pairs {int(count.sum())} of {work['pairs']}; kernel "
              f"{ms:.4f} ms, twin {plain:.3f} ms, sort, gather and pad "
              f"{sort_ms:.4f} ms; bound FP32 {work['fp32_ms']:.4f} ms, bytes "
              f"{work['bytes_ms']:.4f} ms; kernel at "
              f"{work['bound_ms'] / ms:.2%} of its bound")
        row["ms"] += ms
        row["plain_ms"] += plain
        row["bound_ms"] += work["bound_ms"]
        row["bound_by"] = work["bound_by"]
        row["tests"] += work["pairs"]
    print(f"phase 17 in {time.perf_counter() - start:.1f} s ({smi})")
    return row


def check_argmin_ties():
    """torch.argmin on the card must return the lowest index on ties, as
    jnp.argmin does: the octet rounds' cluster order rests on it."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)
    e = torch.randint(0, 4, (4096, 2593), device="cuda",
                      generator=g).float()
    e[::7] = 3.0e38                         # rows with no cluster at all
    lane = torch.arange(e.shape[1], device="cuda")
    want = torch.where(e == e.amin(dim=1, keepdim=True), lane,
                       e.shape[1]).amin(dim=1)
    got = torch.argmin(e, dim=1)
    _check(torch.equal(got, want), "torch.argmin on CUDA does not return "
           "the lowest index on ties")
    print("phase 3: torch.argmin returns the lowest index on ties "
          f"(4096 x 2593, {int((e == e.amin(1, keepdim=True)).sum())} "
          "minima)")


def compare_rounds(prep, boxes, sets):
    """Phase 3: the two octet round kernels (K3) against their twins on
    each set's first 32,768-ray slice, exactly (round 0: e, c0, t, idx;
    round 1 in both modes: t, idx, over, slots, remaining), each timed
    with its twin, with its work and bound; then the whole slice, kernels
    against the twin chain.  Returns {slots: row} of the kernel table
    (without launches): 1 for round 0, 4 for round 1."""
    import torch
    from rustray_tpu_torch.ops import octet_trace as ot
    from rustray_tpu_torch.ops.intersect import INF
    from rustray_tpu_torch.tools.round_compare import (
        check_rounds, new_slice, round_work, slice_inputs)
    pack = prep.pallas_pack
    rows = {1: _row(), 4: _row()}

    def add(slots, ms, plain, work):
        row = rows[slots]
        row["ms"] += ms
        row["plain_ms"] += plain
        row["bound_ms"] += work["bound_ms"]
        row["bound_by"] = work["bound_by"]
        row["tests"] += work["tests"]
        return (f"kernel {ms:.3f} ms, twin {plain:.3f} ms; tests "
                f"{work['tests']}, {work['flops']} FP32 operations, "
                f"{work['bytes']} bytes, bound {work['bound_ms']:.4f} ms "
                f"({work['bound_by']}); kernel at "
                f"{work['bound_ms'] / ms:.2%} of its bound")

    for name, _, o_s, d_s, alive_s, tmax_s, cl_ok in sets:
        o, d, tmax = slice_inputs(o_s, d_s, alive_s, tmax_s)
        r0, r1 = check_rounds(o, d, tmax, boxes, cl_ok, pack,
                              ("closest", "any"))
        ms = _cuda_ms(lambda: ot.round0(o, d, tmax, *boxes, cl_ok, pack), 5)
        plain = _cuda_ms(lambda: ot.round0(o, d, tmax, *boxes, cl_ok, pack,
                                           interpret=True), 1)
        for mode in ("closest", "any"):
            w0, w1 = round_work(o, tmax, r0[0], r0[1], r1[mode][3], pack)
            if mode == "closest":
                print(f"phase 3: K3 round 0 {name:7s} rays={o.shape[0]} e, "
                      f"c0, t and idx equal to the twin's, hits="
                      f"{int((r0[2] < INF).sum())}; {add(1, ms, plain, w0)}")
            ms1 = _cuda_ms(lambda: ot.round1(o, d, tmax, *r0, pack, mode), 5)
            plain1 = _cuda_ms(lambda: ot.round1(o, d, tmax, *r0, pack, mode,
                                                interpret=True), 1)
            t1, _, over, slots, _ = r1[mode]
            print(f"phase 3: K3 round 1 {name:7s} {mode:7s} t, idx, over, "
                  f"slots and remaining equal to the twin's, hits="
                  f"{int((t1 < INF).sum())}, filled slots "
                  f"{int((slots != pack.shape[0] - 1).sum())}, octets over "
                  f"4 {int(over.sum())}; {add(4, ms1, plain1, w1)}")
            k_ms = _cuda_ms(lambda: new_slice(o, d, tmax, boxes, cl_ok, pack,
                                              mode), 5)
            p_ms = _cuda_ms(lambda: new_slice(o, d, tmax, boxes, cl_ok, pack,
                                              mode, interpret=True), 1)
            print(f"phase 3: K3 slice {name:7s} {mode:7s} (selection and "
                  f"both rounds): kernels {k_ms:.3f} ms, twin chain "
                  f"{p_ms:.3f} ms")
    return rows


def bench_frame(tag, sa, static, cfg, engine, samples, counters):
    """Render the bench frame with ``counters`` (dicts of launch counts)
    and the chunk program's graph counts reset just before and read just
    after; check drops, the image and the device rays per sample.  Returns
    (seconds, rays per sample, counts, the render's output, graph
    counts)."""
    import numpy as np
    import torch
    from rustray_tpu_torch import render
    from rustray_tpu_torch.render import wavefront
    cfg.samples = samples
    torch.cuda.synchronize()
    for reset in counters.values():
        reset[1]()
    wavefront.reset_graph_stats()
    t0 = time.perf_counter()
    out = render(sa, static, cfg, engine)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k: dict(c[0]) for k, c in counters.items()}
    graph = dict(wavefront.graph_stats)
    print(f"{tag}: {WIDTH}x{HEIGHT} {samples} spp in {secs:.2f} s: "
          f"device_rays={out['device_rays']} "
          f"({out['device_rays'] / secs / 1e6:.2f} Mrays/s), "
          f"dropped={out['dropped_rays']}, kernel launches {counts}; "
          f"{graph['captures']} captures in "
          f"{graph['capture_seconds']:.3f} s, {graph['replays']} replays")
    _check(out["dropped_rays"] == 0, f"{tag}: rays still dropped after "
           "auto-raise")
    if "lists" in counts:
        walks = {m: counts["K1"][m] + counts["K2"][m] for m in counts["K1"]}
        _check(counts["lists"] == walks, f"{tag}: list kernel launches "
               f"{counts['lists']} against the walks' {walks}")
    color = out["color"]
    _check(color.shape == (HEIGHT, WIDTH, 3) and np.isfinite(color).all(),
           f"{tag}: image not finite or of the wrong shape")
    _check(color.max() > 0.0, f"{tag}: image is all black")
    per = out["device_rays"] / samples
    _check(abs(per / RAYS_PER_SAMPLE - 1.0) <= 0.05,
           f"{tag}: device rays per sample {per:.0f} not within 5% of "
           f"{RAYS_PER_SAMPLE:.0f}")
    print(f"{tag}: device rays per sample {per:.1f} vs the JAX package's "
          f"{RAYS_PER_SAMPLE} ({per / RAYS_PER_SAMPLE - 1.0:+.4%})")
    return secs, per, counts, out, graph


def compare_renders(tag, a, b):
    import numpy as np
    frac = np.isclose(a["color"], b["color"], rtol=2e-3, atol=2e-3).mean()
    oid = (a["object_id"] == b["object_id"]).mean()
    print(f"{tag}: color close on {frac:.5f}, object id equal on {oid:.5f}, "
          f"device rays {a['device_rays']} vs {b['device_rays']}")
    _check(frac >= 0.995 and oid >= 0.995, f"{tag}: renders differ")


def entry_points(smi, bench_json, small, k_small, engine):
    """Phase 10: the CLI frame, checkpoint/resume, the XLA cluster walk,
    post-processing and picking; ``small`` is the 320x180 (sa, static,
    cfg) of phase 5 and ``k_small`` its K1 frame."""
    import dataclasses
    import glob
    import shutil
    import numpy as np
    import torch
    from PIL import Image
    from rustray_tpu_torch import PostProcessingConfig, cli, render
    from rustray_tpu_torch.build import BUILD_DIR
    from rustray_tpu_torch.ops import block_trace as bt
    from rustray_tpu_torch.render.post import run_post_processing
    from rustray_tpu_torch.run import RenderSession

    start = time.perf_counter()
    # the CLI frame, on the default device, through K1
    out_dir = os.path.join(BUILD_DIR, "cli")
    shutil.rmtree(out_dir, ignore_errors=True)
    sessions = []

    class Recorded(RenderSession):
        def init(self):
            sessions.append(self)
            super().init()

    cli_session = cli.RenderSession
    cli.RenderSession = Recorded
    try:
        torch.cuda.synchronize()
        bt.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["cmd", bench_json, f"{WIDTH}x{HEIGHT}", "samples=1",
                       "no-animation", f"out={out_dir}", "preview=8"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        cli.RenderSession = cli_session
    launches = dict(bt.launches)
    sess = sessions[0]
    res = sess.result
    per = res["device_rays"]
    print(f"phase 10: CLI frame {WIDTH}x{HEIGHT} 1 spp on {sess.device} in "
          f"{secs:.2f} s, scene load and compile included (the session's "
          f"render {sess.stats.last_render_seconds:.3f} s) ({smi}): "
          f"device_rays={per}, dropped={res['dropped_rays']}, K1 launches "
          f"{launches}")
    _check(rc == 0, f"the CLI returned {rc}")
    _check(sess.device == "cuda", "the CLI did not default to the card")
    _check(all(n > 0 for n in launches.values()),
           f"a K1 mode never launched in the CLI frame: {launches}")
    _check(res["dropped_rays"] == 0, "the CLI frame dropped rays")
    _check(abs(per / RAYS_PER_SAMPLE - 1.0) <= 0.05,
           f"CLI frame: device rays per sample {per} not within 5% of "
           f"{RAYS_PER_SAMPLE}")
    pngs = glob.glob(os.path.join(out_dir, "output_*.png"))
    _check(len(pngs) == 1, f"the CLI wrote {len(pngs)} output PNGs")
    for path in (pngs[0], os.path.join(out_dir, "preview.png")):
        img = np.asarray(Image.open(path))
        _check(np.array_equal(img, res["image"]),
               f"{os.path.basename(path)} differs from the session's image")
    print(f"phase 10: {os.path.basename(pngs[0])} and preview.png equal the "
          f"session's image; device rays per sample "
          f"{per / RAYS_PER_SAMPLE - 1.0:+.4%} from the JAX package's")

    # checkpoint and resume on the card, 4 chunks
    sa, static, cfg = small
    ck_engine = dataclasses.replace(engine, chunk_pixels=16384)
    ckpt = os.path.join(BUILD_DIR, "smoke.ckpt.npz")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    full = render(sa, static, cfg, ck_engine)
    render(sa, static, cfg, ck_engine, checkpoint_path=ckpt, max_chunks=1)
    _check(os.path.exists(ckpt), "no checkpoint after the first chunk")
    qf = float(np.load(ckpt)["queue_factor"])
    resumed = render(sa, static, cfg, ck_engine, checkpoint_path=ckpt)
    _check(not os.path.exists(ckpt), "the checkpoint outlived its frame")
    for k in ("image", "color", "depth", "normal", "object_id",
              "device_rays", "dropped_rays"):
        _check(np.array_equal(resumed[k], full[k]),
               f"checkpoint: the resumed frame's {k} differs")
    print(f"phase 10: 320x180 in 4 chunks, cut after chunk 1 (queue factor "
          f"{qf} there) and resumed: every AOV, device_rays and "
          f"dropped_rays equal to the uninterrupted frame's")

    # the XLA cluster walk against K1, in turns
    xla = dataclasses.replace(engine, accel="on", pallas="off")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k_out = render(sa, static, cfg, engine)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    x_out = render(sa, static, cfg, xla)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _check(all(np.array_equal(k_out[k], k_small[k])
               for k in ("color", "object_id", "device_rays")),
           "the K1 frame differs from phase 5's")
    print(f"phase 10: 320x180 1 spp, K1 {t1 - t0:.3f} s, XLA cluster walk "
          f"{t2 - t1:.3f} s ({smi}); dropped {x_out['dropped_rays']}")
    compare_renders("phase 10: 320x180 XLA walk vs K1", x_out, k_small)

    # post-processing on the card against the CPU
    post = PostProcessingConfig(cavity=True, outline=True)
    aovs = (res["image"], res["normal"], res["depth"], res["object_id"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = run_post_processing(post, *aovs, device="cuda")
    t1 = time.perf_counter()
    on_cpu = run_post_processing(post, *aovs, device="cpu")
    t2 = time.perf_counter()
    step = np.abs(on_card.astype(np.int32) - on_cpu.astype(np.int32)).max()
    print(f"phase 10: cavity + outline on the CLI frame: card {t1 - t0:.3f} "
          f"s, CPU {t2 - t1:.3f} s ({smi}); max difference {step} of 255, "
          f"{int((on_card != res['image']).any(axis=-1).sum())} pixels "
          f"changed")
    _check(step <= 1, "post-processing on the card and the CPU differ")

    # picking on CUDA and on CPU tensors
    cpu_sess = RenderSession(WIDTH, HEIGHT, [bench_json], animate=False,
                             device="cpu")
    cpu_sess.scene = sess.scene
    for xy in ((WIDTH // 2, HEIGHT // 2), (0, 0)):
        got, ref = sess.pick(*xy), cpu_sess.pick(*xy)
        print(f"phase 10: pick {xy}: CUDA {got}, CPU {ref}")
        _check((got is None) == (ref is None) and (got is None or (
            got[:2] == ref[:2] and np.isclose(got[2], ref[2], rtol=1e-5,
                                              atol=0.0))),
               f"pick {xy} differs between CUDA and the CPU")
    print(f"phase 10: {time.perf_counter() - start:.1f} s in all ({smi})")


def _leaves(grads):
    return {f"{g}.{k}": v for g, d in grads.items() for k, v in d.items()}


def _timed_grad(sa, static, cfg, target, engine):
    """render_loss_and_grad with every launch and drop count reset just
    before; returns (loss, grads, seconds, K1 launches, K3 launches,
    dropped rays)."""
    import torch
    from rustray_tpu_torch.ops import block_trace as bt
    from rustray_tpu_torch.ops import octet_trace as ot
    from rustray_tpu_torch.parallel import shard
    torch.cuda.synchronize()
    bt.reset_launches()
    ot.reset_counts()
    shard.reset_dropped()
    t0 = time.perf_counter()
    loss, grads = shard.render_loss_and_grad(sa, static, cfg, target, engine)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (float(loss), grads, secs, dict(bt.launches), dict(ot.launches),
            shard.dropped["rays"])


class _WalkRecorder:
    """While active, ``bt.block_walk`` keeps, for every launch of the CUDA
    walk, its inputs and results on a sample of its blocks: the first and
    the last ``edge`` and ``extra`` more drawn from a seed.  Each block
    walks its own list, so the twin on the sample must give the kernel's
    results on those blocks bit for bit."""

    def __init__(self, edge=128, extra=256):
        self.edge, self.extra = edge, extra
        self.calls = []

    def __enter__(self):
        import torch
        from rustray_tpu_torch.ops import block_trace as bt
        self.bt, self.walk = bt, bt.block_walk
        # drawn on the card, so that recording adds no host sync
        gen = torch.Generator(device="cuda").manual_seed(0)

        def recording(count, rays, order, entry, pack, mode="closest",
                      interpret=False, gated=True, return_visited=False):
            out = self.walk(count, rays, order, entry, pack, mode, interpret,
                            gated, return_visited)
            if rays.device.type == "cuda" and not interpret:
                nb, dev = rays.shape[0], rays.device
                at = torch.arange(nb, device=dev)
                if nb > 2 * self.edge + self.extra:
                    mid = torch.randperm(nb - 2 * self.edge, device=dev,
                                         generator=gen)[:self.extra]
                    at = torch.cat([at[:self.edge],
                                    torch.sort(mid).values + self.edge,
                                    at[nb - self.edge:]])
                self.calls.append(dict(
                    mode=mode, gated=gated, rays=rays.shape[0] * rays.shape[1],
                    nb=nb, at=at,
                    inputs=(count[at], rays[at], order[at], entry[at]),
                    pack=pack, got=(out[0][at], out[1][at])))
            return out

        bt.block_walk = recording
        return self

    def __exit__(self, *exc):
        self.bt.block_walk = self.walk
        return False

    def check(self, tag):
        """Hold every recorded launch against the twin on its sample."""
        from rustray_tpu_torch.ops.intersect import INF
        t0 = time.perf_counter()
        for i, c in enumerate(self.calls):
            want = self.walk(*c["inputs"], c["pack"], c["mode"],
                             interpret=True, gated=c["gated"])
            (t_k, i_k), (t_p, i_p) = c["got"], want
            f_k, f_p = t_k < INF, t_p < INF
            n_found = int((f_k != f_p).sum())
            n_idx = int(((i_k != i_p) & f_k & f_p).sum())
            n_t = int((t_k != t_p).sum())
            _check(n_found == n_idx == n_t == 0,
                   f"{tag}: K1 launch {i} ({c['mode']}, {c['rays']} rays) "
                   f"differs from the twin on its sample: {n_found} rays "
                   f"found or missed against it, {n_idx} other winners, "
                   f"{n_t} other t")
            print(f"{tag}: K1 launch {i} {c['mode']:7s} {c['rays']} rays in "
                  f"{c['nb']} blocks: {t_k.shape[0]} blocks (first, last, "
                  f"drawn) equal to the twin, t and idx bit for bit, "
                  f"{int(f_p.sum())} hits among them")
        return time.perf_counter() - t0


def gradients(smi, small, tiny):
    """Phase 11: scene gradients on the card, through K1 in the forward
    pass; ``small`` and ``tiny`` are phase 5's 320x180 and 160x90 (sa,
    static, cfg) at 1 spp."""
    import shutil
    import numpy as np
    import torch
    from rustray_tpu_torch import EngineConfig, render, to_torch
    from rustray_tpu_torch.build import BUILD_DIR
    from rustray_tpu_torch.parallel import dryrun, shard
    from rustray_tpu_torch.render.wavefront import frame_levels
    from rustray_tpu_torch.tools.capture_waves import load_bench_scene

    start = time.perf_counter()
    # (a) the full bench scene at 640x360 through K1, the CLI's queue
    # factor first
    scene = load_bench_scene(640, 360)
    sa, static = to_torch(*scene.compile(), "cuda")
    cfg = scene.raytracing_config
    cfg.samples = 1
    _check(frame_levels(sa, cfg) == 5, "the bench frame should have 5 levels")
    params = shard.extract_diff_params(sa)
    params["materials"]["base_color"] = params["materials"]["base_color"] * 0.5
    target = render(shard.apply_diff_params(sa, params), static, cfg,
                    EngineConfig())["color"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd = render(sa, static, cfg, EngineConfig())
    torch.cuda.synchronize()
    fwd_secs = time.perf_counter() - t0
    qf = 4.0
    while True:
        torch.cuda.reset_peak_memory_stats()
        with _WalkRecorder() as walks:
            loss, grads, secs, k1, _, dropped = _timed_grad(
                sa, static, cfg, target, EngineConfig(queue_factor=qf))
        if dropped == 0 or qf >= 64:
            break
        print(f"phase 11: queue factor {qf} dropped {dropped} rays in the "
              f"gradient pass; doubling it")
        qf *= 2.0
    mem = torch.cuda.max_memory_allocated()
    leaves = _leaves(grads)
    print(f"phase 11: render_loss_and_grad 640x360 1 spp, 5 levels, "
          f"{static.n_tris} triangles, queue factor {qf}: loss {loss:.9g} "
          f"in {secs:.3f} s, peak memory {mem / 2**30:.2f} GiB ({smi}); "
          f"forward-only render() of the frame {fwd_secs:.3f} s "
          f"({fwd['device_rays']} device rays); K1 launches {k1}, dropped "
          f"{dropped}")
    print("phase 11: max |grad| " + ", ".join(
        f"{k} {float(v.abs().max()):.4g}" for k, v in leaves.items()))
    _check(all(n > 0 for n in k1.values()),
           f"a K1 mode never launched in the gradient's forward pass: {k1}")
    _check(len(walks.calls) == sum(k1.values()),
           f"{len(walks.calls)} K1 launches recorded of {sum(k1.values())}")
    twin_secs = walks.check("phase 11 (a)")
    print(f"phase 11: (a) every K1 launch of the gradient pass held to the "
          f"twin on its sample in {twin_secs:.1f} s")
    _check(dropped == 0, "the gradient pass dropped rays")
    _check(all(bool(torch.isfinite(v).all()) for v in leaves.values()),
           "a gradient is not finite")
    _check(bool(leaves["materials.base_color"].abs().max() > 0)
           and bool(leaves["camera.view_inv"].abs().max() > 0),
           "the base_color or view_inv gradient is zero")

    _engines(small)

    # (d) starts here: two gloo ranks on the card run while (c) does
    out_dir = os.path.join(BUILD_DIR, "dryrun")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    log_path = os.path.join(out_dir, "ranks.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        ranks = subprocess.Popen(
            [sys.executable, "-m", "rustray_tpu_torch.parallel.dryrun", "2",
             "--device", "cuda", "--backend", "gloo", "--scene", "bench",
             "--out", out_dir, "--timeout", "300"],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    try:
        _differences(tiny)
        rc = ranks.wait(timeout=360)
    finally:
        if ranks.poll() is None:
            ranks.kill()
            ranks.wait()
    ranks_secs = time.perf_counter() - t0
    with open(log_path) as f:
        printed = f.read()
    for line in printed.splitlines():
        if line.startswith("dryrun:"):
            print(f"phase 11: {line}")
    _check(rc == 0, f"the 2-rank dryrun failed ({rc}):\n{printed[-3000:]}")
    sa_b, st_b, cfg_b = dryrun.load_scene("bench", "cuda")
    single = dryrun.run_mesh(sa_b, st_b, cfg_b, EngineConfig(),
                             shard.make_mesh())
    for mesh in ("2x1", "1x2"):
        z = np.load(os.path.join(out_dir, f"mesh_{mesh}.npz"))
        _check(np.abs(z["color"] - single["color"]).max() <= 1e-5,
               f"{mesh}: color differs from the one-rank render")
        for k in ("object_id", "device_rays", "dropped_rays"):
            _check(np.array_equal(z[k], single[k]),
                   f"{mesh}: {k} differs from the one-rank run")
        _check(np.isclose(z["loss"], single["loss"], rtol=1e-5, atol=0.0)
               and np.isclose(z["loss_after_step"], single["loss_after_step"],
                              rtol=1e-5, atol=0.0),
               f"{mesh}: loss differs from the one-rank run")
        worst = 0.0
        for k in single:
            if k.startswith("g."):
                _check(np.allclose(z[k], single[k], rtol=1e-5, atol=1e-7),
                       f"{mesh}: {k} differs from the one-rank gradient")
                worst = max(worst, float(np.abs(z[k] - single[k]).max()))
        print(f"phase 11: 2 ranks, mesh {mesh}: color max difference "
              f"{np.abs(z['color'] - single['color']).max():.3g}, ids, "
              f"device_rays ({int(z['device_rays'])}) and dropped equal; "
              f"loss {float(z['loss']):.9g} vs {float(single['loss']):.9g}, "
              f"after one SGD step {float(z['loss_after_step']):.9g}; grads "
              f"max difference {worst:.3g}")
    print(f"phase 11: the 2-rank dryrun took {ranks_secs:.1f} s, beside "
          f"(c); phase 11 "
          f"{time.perf_counter() - start:.1f} s in all ({smi})")


def chunked_gradient(smi, sa, static, cfg, chunk=524288):
    """Phase 18: the chunked gradient of the 1280x720 bench frame at 4 spp
    through K1, against render() of the same engine and seed."""
    import dataclasses
    import numpy as np
    import torch
    from rustray_tpu_torch import EngineConfig, render, rng
    from rustray_tpu_torch.ops import block_trace as bt
    from rustray_tpu_torch.ops import traverse as trav
    from rustray_tpu_torch.parallel import shard
    from rustray_tpu_torch.render import wavefront

    start = time.perf_counter()
    cfg4 = dataclasses.replace(cfg, samples=4)
    engine = EngineConfig(seed=17, chunk_pixels=chunk)
    params = shard.extract_diff_params(sa)
    params["materials"]["base_color"] = params["materials"]["base_color"] * 0.5
    target = render(shard.apply_diff_params(sa, params), static, cfg4,
                    engine)["color"]
    out = render(sa, static, cfg4, engine)
    # the frames' graphs keep their pools: free them before the gradient
    wavefront._RENDERER_CACHE.clear()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bt.reset_launches()
    trav.reset_mat_rows()
    shard.reset_dropped()
    shard.reset_grad_stats()
    rng.reset_launches()
    t0 = time.perf_counter()
    loss, grads, color = shard.render_loss_and_grad(
        sa, static, cfg4, target, engine, return_color=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    st = dict(shard.grad_stats)
    color = color.cpu().numpy().reshape(out["color"].shape)
    diff = float(np.abs(color - out["color"]).max())
    image = np.trunc(color * 255.0).astype(np.uint8)
    n_pix = static.width * static.height
    _check(st["chunks"] == -(-n_pix // chunk) and st["calls"] == 1,
           f"phase 18: the gradient took {st} for {n_pix} pixels")
    _check(all(n > 0 for n in bt.launches.values()),
           f"phase 18: a K1 mode never launched: {dict(bt.launches)}")
    mat_rows = dict(trav.mat_rows)
    rng_launches = dict(rng.launches)
    _check(mat_rows["launches"] > 0, "phase 18: the material-row kernel "
           "never launched")
    _check(shard.dropped["rays"] == 0 and out["dropped_rays"] == 0,
           f"phase 18: dropped rays: gradient {shard.dropped['rays']}, "
           f"render() {out['dropped_rays']}")
    _check(np.array_equal(image, out["image"]) and diff <= 1e-6,
           f"phase 18: the gradient's image differs from render()'s: max "
           f"colour difference {diff}")
    g = {f"{grp}.{k}": float(v.abs().max()) for grp, d in grads.items()
         for k, v in d.items()}
    _check(all(np.isfinite(v) for v in g.values()) and g[
        "materials.base_color"] > 0, f"phase 18: gradients {g}")
    print(f"phase 18: render_loss_and_grad {static.width}x{static.height} "
          f"4 spp, chunk {chunk} ({st['chunks']} chunks, {st['cells']} "
          f"chunk-cells): loss {float(loss):.9g} in {secs:.3f} s, peak "
          f"memory {peak} B ({peak / 2**30:.2f} GiB), forward "
          f"{st['forward_ms']:.1f} ms, backward {st['backward_ms']:.1f} ms "
          f"of device time; K1 launches {dict(bt.launches)}; material-row "
          f"kernel {mat_rows['launches']} launches over {mat_rows['rows']} "
          f"rows; threefry kernels {rng_launches}; image equal to "
          f"render()'s (max colour difference {diff}); 0 dropped ({smi})")
    print(f"phase 18 in {time.perf_counter() - start:.1f} s")
    return dict(secs=secs, peak=peak, mat_rows=mat_rows, rng=rng_launches,
                **st)


def mat_rows_phase(smi, sa, static, cfg, chunk=524288):
    """Phase 19: the material-row kernel on the cotangents and materials
    of a 1-spp gradient of the bench frame at ``chunk`` pixels, one input
    per queue length (level 1's and the first deep level's in the
    backward), against a float64 index_add_ and across two launches, timed
    beside its byte bound, its twin and PyTorch's indexing backward.
    Returns the kernel table's row (without launches)."""
    import dataclasses
    import numpy as np
    import torch
    from rustray_tpu_torch import EngineConfig
    from rustray_tpu_torch.ops import traverse as trav
    from rustray_tpu_torch.parallel import shard
    start = time.perf_counter()
    seen = {}
    launch = trav._mat_rows_cuda

    def record(g, mat, n_mats):
        if mat.shape[0] not in seen:
            seen[mat.shape[0]] = (g.clone(), mat.clone(), n_mats)
        return launch(g, mat, n_mats)

    trav._mat_rows_cuda = record
    try:
        target = np.full((static.height, static.width, 3), 0.5, np.float32)
        shard.render_loss_and_grad(
            sa, static, dataclasses.replace(cfg, samples=1), target,
            EngineConfig(seed=19, chunk_pixels=chunk))
    finally:
        trav._mat_rows_cuda = launch
    _check(len(seen) >= 2, f"phase 19: queue lengths {sorted(seen)}")
    row = _row()
    row["library_ms"] = 0.0
    for n in sorted(seen):
        g, mat, n_mats = seen[n]
        want = torch.zeros((n_mats, g.shape[1]), dtype=torch.float64,
                           device=g.device).index_add_(0, mat, g.double())
        first = trav._mat_rows_cuda(g, mat, n_mats)
        second = trav._mat_rows_cuda(g, mat, n_mats)
        twin = trav._mat_rows_twin(g, mat, n_mats)
        torch.cuda.synchronize()
        rel = float(torch.linalg.vector_norm(first.double() - want)
                    / torch.linalg.vector_norm(want))
        _check(torch.equal(first.view(torch.int32), second.view(torch.int32))
               and rel <= 1e-6, f"phase 19: N {n}: two launches differ or "
               f"the relative L2 to float64 is {rel:.3g}")
        err = float((first - twin).abs().max())
        # the kernels' time in a graph, each call on a copy of the input
        # that left the 50 MB L2 cache, and the wall of a call by CUDA
        # events, which at these sizes is the host's launch
        copies = [(g.clone(), mat.clone(), n_mats) for _ in range(
            max(2, -(-150_000_000 // (n * 68))))]
        ms = _graph_ms(trav._mat_rows_cuda, copies, 20)
        call_ms = _cuda_ms(lambda: trav._mat_rows_cuda(g, mat, n_mats), 20)
        del copies
        plain = _cuda_ms(lambda: trav._mat_rows_twin(g, mat, n_mats), 20)
        table = torch.zeros((n_mats, g.shape[1]), device=g.device,
                            requires_grad=True)
        idx = mat.long()
        library = _cuda_ms(lambda: torch.autograd.grad(table[idx], table, g),
                           3)
        bound = (n * (4 + 4 * g.shape[1]) + n_mats * 4 * g.shape[1]) \
            / 3.35e12 * 1e3
        m = mat.cpu().numpy()
        runs = 1 + int(np.count_nonzero(m[1:] != m[:-1]))
        print(f"phase 19: N {n} x M {n_mats}: {np.mean(m == 0):.1%} of the "
              f"rows on material 0, {runs} runs of one material; relative "
              f"L2 to float64 {rel:.3g}, two launches equal, max difference "
              f"to the twin {err:.3g}; kernel {ms:.4f} ms in a graph on "
              f"inputs out of L2 ({call_ms:.4f} ms a call by events), twin "
              f"{plain:.4f} "
              f"ms, PyTorch's indexing backward {library:.3f} ms; bound "
              f"(bytes) {bound:.4f} ms; kernel at {bound / ms:.2%} of its "
              f"bound")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += ms
        row["plain_ms"] += plain
        row["library_ms"] += library
        row["bound_ms"] += bound
        row["bound_by"] = "bytes"
        row["tests"] += n
    print(f"phase 19 in {time.perf_counter() - start:.1f} s ({smi})")
    return row


def _engines(small):
    """Phase 11 (b): the 320x180 gradient through every traversal path
    against K1's; ``small`` is (sa, static, cfg) at 1 spp."""
    import numpy as np
    from rustray_tpu_torch import EngineConfig

    sa5, st5, cfg5 = small
    black = np.zeros((st5.height, st5.width, 3), np.float32)
    engines = {"K1": EngineConfig(),
               "octet (K3)": EngineConfig(pallas_algo="octet"),
               "twin": EngineConfig(pallas="on", pallas_interpret=True),
               "XLA walk": EngineConfig(accel="on", pallas="off")}
    runs = {}
    for name, eng in engines.items():
        loss5, g5, secs5, k1, k3, dropped = _timed_grad(sa5, st5, cfg5, black,
                                                        eng)
        runs[name] = (loss5, _leaves(g5))
        print(f"phase 11: 320x180 gradient through {name}: loss {loss5:.9g} "
              f"in {secs5:.3f} s; K1 "
              f"launches {k1}, K3 launches {k3}, "
              f"dropped {dropped}")
        _check(dropped == 0, f"{name}: the gradient pass dropped rays")
        launched = {"K1": all(n > 0 for n in k1.values()),
                    "octet (K3)": all(n > 0 for n in k3.values())}
        _check(launched.get(name, not (any(k1.values()) or any(k3.values()))),
               f"{name}: unexpected kernel launches K1 {k1}, K3 {k3}")
    loss_k1, ref = runs["K1"]
    for name, (loss5, got) in runs.items():
        worst = 0.0
        for k, b in ref.items():
            tol = 1e-3 * b.abs() + 1e-5 * float(b.abs().max())
            err = (got[k] - b).abs()
            _check(bool((err <= tol).all()), f"{name}: {k} differs from "
                   f"K1's by {float(err.max()):.3g}")
            worst = max(worst, float((err / tol.clamp(min=1e-30)).max()))
        _check(abs(loss5 - loss_k1) <= 1e-6 * abs(loss_k1),
               f"{name}: loss {loss5} differs from K1's {loss_k1}")
        print(f"phase 11: {name} vs K1: loss difference "
              f"{loss5 - loss_k1:.3g}, every leaf within "
              f"1e-3*|b| + 1e-5*max|b| (at most {worst:.3f} of it)")



def _differences(tiny):
    """Phase 11 (c): central differences at 160x90 on the most-hit
    material; ``tiny`` is (sa, static, cfg) at 1 spp."""
    import numpy as np
    import torch
    from rustray_tpu_torch import EngineConfig, render
    from rustray_tpu_torch.parallel import shard

    sa9, st9, cfg9 = tiny
    out9 = render(sa9, st9, cfg9, EngineConfig())
    hit = out9["depth"].reshape(-1) > 0
    oid = torch.as_tensor(out9["object_id"].reshape(-1)[hit])
    inst_of = {int(i): n for n, i in enumerate(sa9.inst_obj_id.tolist())}
    mats = sa9.inst_mat.cpu()[[inst_of[int(i)] for i in oid]]
    m = int(torch.bincount(mats).argmax())
    black9 = np.zeros((st9.height, st9.width, 3), np.float32)
    eng9 = EngineConfig()
    _, g9, _, _, _, dropped = _timed_grad(sa9, st9, cfg9, black9, eng9)
    _check(dropped == 0, "the 160x90 gradient pass dropped rays")
    eps = 1e-3
    for field, idx in (("base_color", (m, 0)), ("base_color", (m, 1)),
                       ("base_color", (m, 2)), ("reflectivity", (m,))):
        def loss_at(delta):
            p = shard.extract_diff_params(sa9)
            leaf = p["materials"][field].clone()
            leaf[idx] += delta
            p["materials"][field] = leaf
            loss9, _ = shard.render_loss_and_grad(
                shard.apply_diff_params(sa9, p), st9, cfg9, black9, eng9)
            return float(loss9)
        fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
        g = float(g9["materials"][field][idx])
        print(f"phase 11: 160x90 material {m} ({int((mats == m).sum())} of "
              f"{int(hit.sum())} hit pixels) {field}{list(idx)}: gradient "
              f"{g:.6g}, central difference {fd:.6g}")
        _check(np.isclose(g, fd, rtol=5e-2, atol=1e-4),
               f"{field}{list(idx)}: gradient {g} vs central difference {fd}")


FRAME_KEYS = ("image", "color", "depth", "normal", "object_id",
              "device_rays", "dropped_rays")


def _differ(a, b):
    """The keys of FRAME_KEYS in which two renders differ at all."""
    import numpy as np
    return [k for k in FRAME_KEYS
            if not np.array_equal(np.asarray(a[k]), np.asarray(b[k]))]


def _eager(fn):
    """``fn()`` with the chunk program run eagerly on the card:
    build_chunk_fn per chunk, with its host syncs (the parent's loop)."""
    from rustray_tpu_torch.render import wavefront
    with wavefront.eager():
        return fn()


def _mini_scene(glass):
    """The tests' bench mini-scene at 96x64 (1,010 triangles in 9
    clusters, 4 Monte-Carlo samples, 7 levels) on the card; ``glass``
    makes every material reflect and refract, so that queue factor 1.0
    drops rays and is raised twice."""
    from rustray_tpu_torch import to_torch
    from rustray_tpu_torch.models.procedural import bench_scene
    scene = bench_scene(grid=2, lat=10, lon=14, width=96, height=64)
    if glass:
        for m in scene.materials:
            m.reflectivity, m.alpha, m.refraction_index = 0.5, 0.5, 1.5
    sa, static = to_torch(*scene.compile(), "cuda")
    return sa, static, scene.raytracing_config


def frame_path(smi, sa, static, cfg, samples, frames):
    """Phase 12: the frame path against the eager chunk program.
    ``frames`` maps a path's name to (engine, launch counters, phase 4's or
    6's (seconds, counts, output, graph counts, fallback rays))."""
    import torch
    from rustray_tpu_torch import EngineConfig, render
    from rustray_tpu_torch.ops import octet_trace as ot
    from rustray_tpu_torch.render import wavefront
    start = time.perf_counter()
    for name, (eng, counters, graph) in frames.items():
        secs, counts, out, g, fb = graph
        ot.reset_counts()
        e_secs, _, e_counts, e_out, e_g = _eager(lambda: bench_frame(
            f"phase 12: eager {name}", sa, static, cfg, eng, samples,
            counters))
        e_fb, e_calls = int(ot.fallback["rays"]), ot.fallback["calls"]
        _check(e_g["captures"] == 0, f"phase 12: the eager {name} frame "
               f"captured: {e_g}")
        diff = _differ(out, e_out)
        _check(not diff, f"phase 12: {name}: the frame path differs from "
               f"the eager chunk program in {diff}")
        _check(fb == e_fb, f"phase 12: {name}: fallback rays {fb} vs eager "
               f"{e_fb}")
        # the same frame again, replaying the graphs captured in phase 4 or
        # 6 (no capture, no warm-up): its IF nodes launch what eager does
        ot.reset_counts()
        w_secs, _, w_counts, w_out, w_g = bench_frame(
            f"phase 12: replayed {name}", sa, static, cfg, eng, samples,
            counters)
        w_fb, w_calls = int(ot.fallback["rays"]), ot.fallback["calls"]
        _check(w_g["captures"] == 0, f"phase 12: {name}: the replayed frame "
               f"captured: {w_g}")
        diff = _differ(w_out, e_out)
        _check(not diff, f"phase 12: {name}: the replayed frame differs "
               f"from the eager chunk program in {diff}")
        _check(w_fb == e_fb, f"phase 12: {name}: replayed fallback rays "
               f"{w_fb} vs eager {e_fb}")
        for k, per_mode in w_counts.items():
            if k == "set_if":
                continue
            for m, n in per_mode.items():
                _check(n == e_counts[k][m], f"phase 12: {name}: {k}[{m}] "
                       f"launched {n} times in the replayed frame, "
                       f"{e_counts[k][m]} in the eager chunk program")
        _check(w_calls == e_calls, f"phase 12: {name}: fallback calls "
               f"{w_calls} replayed vs {e_calls} eager")
        _check(w_counts["set_if"]["set_if"] > 0, f"phase 12: {name}: the "
               "replayed frame reached no IF node")
        nodes = g["if_nodes"]
        print(f"phase 12: {name}: frame path equal to the eager chunk "
              f"program bit for bit in {', '.join(FRAME_KEYS)} "
              f"({out['device_rays'] / samples:.1f} rays per sample, "
              f"{out['dropped_rays']} dropped, fallback rays {fb}); "
              f"frame path {secs:.3f} s ({g['captures']} captures in "
              f"{g['capture_seconds']:.3f} s, {g['replays']} replays, "
              f"{sum(nodes.values())} IF nodes {nodes}), replayed "
              f"{w_secs:.3f} s, eager {e_secs:.3f} s ({smi})")
        print(f"phase 12: {name}: launches per replayed frame {w_counts}, "
              f"fallback calls {w_calls}, equal to the eager chunk "
              f"program's {e_counts}, fallback calls {e_calls}")

    # a scene that raises its queue factor, over 3 chunks, both paths
    glass = EngineConfig(chunk_pixels=2048, queue_factor=1.0, accel="on")
    sa_g, st_g, cfg_g = _mini_scene(True)
    wavefront.reset_graph_stats()
    g_out = render(sa_g, st_g, cfg_g, glass)
    g = dict(wavefront.graph_stats)
    e_out = _eager(lambda: render(sa_g, st_g, cfg_g, glass))
    diff = _differ(g_out, e_out)
    _check(not diff, f"phase 12: the glass scene's frame path differs from "
           f"the eager chunk program in {diff}")
    _check(g["captures"] >= 2 and g_out["dropped_rays"] == 0,
           f"phase 12: the glass scene raised no queue factor: {g}")
    # the per-chunk path replays the first factor's graph after the raised
    # one's was captured in the same pool
    diff = _differ(render(sa_g, st_g, cfg_g, glass, max_chunks=3), e_out)
    _check(not diff, f"phase 12: the glass scene's per-chunk path differs "
           f"from the eager chunk program in {diff}")
    print(f"phase 12: glass mini-scene 96x64, 3 chunks, queue factor 1.0: "
          f"{g['captures']} captures (raised factors), {g['replays']} "
          f"replays; equal to the eager frame in every key, device rays "
          f"{g_out['device_rays']}, dropped 0, and so is its per-chunk "
          f"path")

    # two scenes sharing one static, back to back through the frame path
    sa_b, st_b, cfg_b = _mini_scene(False)
    _check(st_b == st_g, "phase 12: the two mini-scenes differ in static")
    outs = [render(sa_g, st_g, cfg_g, glass), render(sa_b, st_g, cfg_b, glass)]
    eager = [e_out, _eager(lambda: render(sa_b, st_g, cfg_b, glass))]
    for name, a, b in zip(("glass", "plain"), outs, eager):
        diff = _differ(a, b)
        _check(not diff, f"phase 12: the {name} scene after another differs "
               f"from its eager frame in {diff}")
    _check(_differ(outs[0], outs[1]), "phase 12: the two scenes rendered "
           "the same frame")
    torch.cuda.synchronize()
    print(f"phase 12: two scenes sharing one static, back to back: each "
          f"equal to its own eager frame; phase 12 in "
          f"{time.perf_counter() - start:.1f} s ({smi})")


def tools_phase(smi, sa, static, cfg):
    """Phase 13: validate_accel at its defaults and at grid 6 with 98,304
    rays (raises on MISMATCH: a walk outside the tool's thresholds or a
    kernel not bit for bit its twin), kernel_probe's three block sizes and
    walltime_probe on the 1-spp bench frame."""
    from rustray_tpu_torch import EngineConfig
    from rustray_tpu_torch.tools import (kernel_probe, validate_accel,
                                         walltime_probe)
    start = time.perf_counter()
    for grid, n in ((3, 4096), (6, 98304)):
        t0 = time.perf_counter()
        rc = validate_accel.main(grid, n)
        _check(rc == 0, f"phase 13: validate_accel grid {grid}, {n} rays: "
               "MISMATCH")
        print(f"phase 13: validate_accel grid {grid}, {n} rays: ALL OK in "
              f"{time.perf_counter() - t0:.1f} s")
    for row in kernel_probe.probe(sa, static):
        _check(row["k1_device"] > 0, "phase 13: kernel_probe saw no device "
               "time")
    split = walltime_probe.probe(sa, static, cfg, EngineConfig(
        queue_factor=2.0, chunk_pixels=98304), 1)
    print(f"phase 13: walltime_probe 1 spp: capture {split['capture']:.3f} "
          f"s, args {split['args']:.3f} s, dispatch {split['dispatch']:.3f} "
          f"s, completion {split['completion']:.3f} s, fetch "
          f"{split['fetch']:.3f} s; profiled again {split['profiled']:.3f} s, "
          f"device busy {split['busy']:.3f} s; phase 13 in "
          f"{time.perf_counter() - start:.1f} s ({smi})")


def _chunk_programs():
    """The cached chunk programs (not the pools or scene buffers) and
    their queue factors (the JAX key's 11th item)."""
    from rustray_tpu_torch.render import wavefront
    keys = [k for k in wavefront._RENDERER_CACHE
            if k[0] not in ("pool", "scene")]
    return len(keys), sorted({k[10] for k in keys})


def _launches_with_warm_up(first, second, g1):
    """Whether the kernel launch counts ``first`` of a render whose graph
    counts are ``g1`` are ``second``'s, the same frame's without a
    capture (a replayed or eager frame): equal when ``g1`` counts no
    capture, else no fewer in any counter (the eager warm-up before a
    capture runs every branch).  set_if, which only a replay launches, is
    not compared."""
    kernels = [(k, m) for k in first if k != "set_if" for m in first[k]]
    if g1["captures"] == 0:
        return all(first[k][m] == second[k][m] for k, m in kernels)
    return all(first[k][m] >= second[k][m] for k, m in kernels)


def animated_session(smi):
    """Phase 14 (a): a 3-frame animation of the bench scene through
    RenderSession on the card, from an empty cache."""
    import json
    import tempfile
    import numpy as np
    import torch
    from rustray_tpu_torch import render as render_fn
    from rustray_tpu_torch import run as run_mod
    from rustray_tpu_torch.ops import block_trace as bt
    from rustray_tpu_torch.render import wavefront
    glb = os.path.join(ROOT, "data", "bench", "sponza_class_g6_52x68.glb")
    # one ball (of 36) rises 1.5 units over the animation; the gltf object
    # has no name, so its items keep their mesh names
    move = [{"time": t, "objects": [{"name": "ball2_3", "transformation": {
        "translation": {"x": 0.0, "y": y, "z": 0.0}}}]}
        for t, y in ((0, 0.0), (1000, 1.5))]
    spec = {"name": "SponzaClassAnimated",
            "config": {"monte_carlo": True, "samples": 1, "max_recursion": 4},
            "objects": [{"type": "gltf", "path": glb}],
            "animation": {"enabled": True, "fps": 3, "keyframes": move}}
    frames, scenes = [], []

    class Frames(run_mod.RenderSession):
        def render_current_frame(self):
            torch.cuda.synchronize()
            bt.reset_launches()
            wavefront.reset_graph_stats()
            out = super().render_current_frame()
            frames.append(dict(
                out=out, scene=scenes[-1], graph=dict(wavefront.graph_stats),
                k1=dict(bt.launches),
                compile=self.stats.last_compile_seconds,
                render=self.stats.last_render_seconds))
            return out

    to_torch = run_mod.to_torch

    def recording(*args):
        scenes.append(to_torch(*args))
        return scenes[-1]

    start = time.perf_counter()
    wavefront._RENDERER_CACHE.clear()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "animated.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        run_mod.to_torch = recording
        try:
            sess = Frames(WIDTH, HEIGHT, [path], animate=True, out_dir=tmp,
                          device="cuda")
            sess.init()
            sess.run(save=False)
        finally:
            run_mod.to_torch = to_torch
    n_programs, factors = _chunk_programs()
    _check(len(frames) == 3, f"phase 14: the animation rendered {len(frames)} "
           "frames, not 3")
    _check(len({st for _, st in scenes}) == 1, "phase 14: the frames' "
           "SceneStatic differs")
    captures = sum(f["graph"]["captures"] for f in frames)
    for i, f in enumerate(frames):
        out, g = f["out"], f["graph"]
        print(f"phase 14: (a) frame {i}: compile and upload "
              f"{f['compile']:.3f} s, render() {f['render']:.3f} s "
              f"({g['captures']} captures in {g['capture_seconds']:.3f} s, "
              f"{g['replays']} replays), device_rays {out['device_rays']}, "
              f"dropped {out['dropped_rays']}, K1 launches {f['k1']} ({smi})")
        _check(out["dropped_rays"] == 0, f"phase 14: frame {i} dropped rays")
        _check(all(n > 0 for n in f["k1"].values()),
               f"phase 14: frame {i} launched no K1: {f['k1']}")
        _check(i == 0 or g["captures"] == 0, f"phase 14: frame {i} "
               f"captured: {g}")
        sa_f, static_f = f["scene"]
        bt.reset_launches()
        want = _eager(lambda: render_fn(sa_f, static_f,
                                        sess.scene.raytracing_config,
                                        sess.engine))
        e_k1 = dict(bt.launches)
        diff = _differ(out, want)
        _check(not diff, f"phase 14: frame {i} differs from the eager frame "
               f"program on its scene in {diff}")
        # a frame that captures launches its warm-up's kernels too
        _check(_launches_with_warm_up({"K1": f["k1"]}, {"K1": e_k1}, g),
               f"phase 14: frame {i} K1 launches {f['k1']} against the "
               f"eager frame's {e_k1}")
        if i:
            moved = [k for k in ("color", "object_id")
                     if not np.array_equal(out[k], frames[0]["out"][k])]
            _check(moved, f"phase 14: frame {i} equals frame 0: the motion "
                   "did not reach the picture")
    _check(captures == n_programs, f"phase 14: {captures} captures over the "
           f"session for {n_programs} queue factors {factors}")
    print(f"phase 14: (a) 3 frames of an animated session: {captures} "
          f"captures for queue factors {factors} over the session; each "
          f"frame equal to the eager frame program on its scene in "
          f"{', '.join(FRAME_KEYS)}; frames 1 and 2 moved against frame 0; "
          f"{time.perf_counter() - start:.1f} s ({smi})")


def frames_phase(smi, sa, static, cfg, paths):
    """Phase 14: the renderer cache across frames.  ``paths`` maps a kernel
    path's name to (engine, launch counters, pack budget) on the bench
    scene (sa, static, cfg)."""
    import gc
    import numpy as np
    import torch
    from rustray_tpu_torch import EngineConfig, render
    from rustray_tpu_torch.ops import block_trace as bt
    from rustray_tpu_torch.ops import octet_trace as ot
    from rustray_tpu_torch.render import wavefront
    start = time.perf_counter()
    animated_session(smi)

    # (b) the same frame twice through render(), per kernel path
    last = {}
    budget = bt._VMEM_PACK_BUDGET
    for name, (eng, counters, pack_budget) in paths.items():
        bt._VMEM_PACK_BUDGET = pack_budget
        try:
            runs = []
            for call in ("first", "second"):
                ot.reset_counts()
                secs, _, counts, out, g = bench_frame(
                    f"phase 14: (b) {name}, {call} call", sa, static, cfg,
                    eng, 1, counters)
                runs.append((secs, counts, out, g, int(ot.fallback["rays"])))
            ot.reset_counts()
            e_secs, _, e_counts, e_out, _ = _eager(lambda: bench_frame(
                f"phase 14: (b) {name}, eager", sa, static, cfg, eng, 1,
                counters))
            e_fb = int(ot.fallback["rays"])
        finally:
            bt._VMEM_PACK_BUDGET = budget
        (s1, c1, o1, g1, fb1), (s2, c2, o2, g2, fb2) = runs
        _check(g2["captures"] == 0, f"phase 14: {name}: the second call "
               f"captured: {g2}")
        _check(g2["replays"] == g1["replays"], f"phase 14: {name}: replays "
               f"{g2['replays']} vs the first call's {g1['replays']}")
        _check(_launches_with_warm_up(c1, c2, g1), f"phase 14: {name}: "
               f"launches {c2} against the first call's {c1}")
        _check(_launches_with_warm_up(c2, e_counts, g2), f"phase 14: "
               f"{name}: the second call launched {c2}, the eager frame "
               f"{e_counts}")
        if "K3" in c2:
            ran = all(c2["K3"].values())
        else:
            used, unused = ("K2", "K1") if pack_budget == 0 else ("K1", "K2")
            ran = all(c2[used].values()) and not any(c2[unused].values())
        _check(ran, f"phase 14: {name}: the second call launched {c2}")
        for other, o in (("the first call's", o1), ("the eager frame", e_out)):
            diff = _differ(o2, o)
            _check(not diff, f"phase 14: {name}: the second call differs "
                   f"from {other} in {diff}")
        _check(fb1 == fb2 == e_fb, f"phase 14: {name}: fallback rays {fb1}, "
               f"{fb2}, eager {e_fb}")
        last[name] = o2
        print(f"phase 14: (b) {name}: first call {s1:.3f} s "
              f"({g1['captures']} captures in {g1['capture_seconds']:.3f} s, "
              f"{g1['replays']} replays), second {s2:.3f} s (0 captures, "
              f"{g2['replays']} replays), eager {e_secs:.3f} s; launches "
              f"{c1} then {c2}, eager {e_counts}; the second equal to the "
              f"first and to the eager frame in {', '.join(FRAME_KEYS)} "
              f"({smi})")

    # (c) a light's intensity changed in place in the same tensor
    eng, counters, _ = paths["K1"]
    intensity = sa.lights.intensity.clone()
    sa.lights.intensity[0] *= 0.5
    try:
        _, _, _, out, g = bench_frame("phase 14: (c) light 0 at half "
                                      "intensity", sa, static, cfg, eng, 1,
                                      counters)
        want = _eager(lambda: render(sa, static, cfg, eng))
    finally:
        sa.lights.intensity.copy_(intensity)
    _check(g["captures"] == 0, f"phase 14: (c) the changed scene captured: "
           f"{g}")
    _check(_differ(out, last["K1"]), "phase 14: (c) the render after the "
           "change equals the one before it")
    diff = _differ(out, want)
    _check(not diff, f"phase 14: (c) the render after the change differs "
           f"from the eager render of the changed scene in {diff}")
    print(f"phase 14: (c) light 0's intensity halved in place: the next "
          f"render() (0 captures) differs from the last and equals the "
          f"eager render of the changed scene")

    # (d) two configurations alternating, A, B, A, on the glass mini-scene
    sa_g, st_g, cfg_g = _mini_scene(True)
    a = EngineConfig(chunk_pixels=2048, queue_factor=1.0, accel="on")
    b = EngineConfig(chunk_pixels=1024, queue_factor=1.0, accel="on")
    fresh = []
    for e in (a, b):
        wavefront._RENDERER_CACHE.clear()
        fresh.append(render(sa_g, st_g, cfg_g, e))
    wavefront._RENDERER_CACHE.clear()
    seq = []
    for tag, e, want in (("A", a, fresh[0]), ("B", b, fresh[1]),
                         ("A", a, fresh[0])):
        wavefront.reset_graph_stats()
        out = render(sa_g, st_g, cfg_g, e)
        g = dict(wavefront.graph_stats)
        diff = _differ(out, want)
        _check(not diff, f"phase 14: (d) render {len(seq) + 1} ({tag}) "
               f"differs from a fresh render of its key in {diff}")
        _check(out["dropped_rays"] == 0, f"phase 14: (d) {tag} dropped rays")
        seq.append(f"{tag} {g['captures']} captures, {g['replays']} replays")
        _check(len(seq) < 3 or g["captures"] == 0, f"phase 14: (d) the "
               f"third render captured: {g}")
    print(f"phase 14: (d) glass mini-scene at chunks 2048 (A) and 1024 (B), "
          f"queue factor 1.0 raised: {'; '.join(seq)}; each equal to a "
          f"fresh render of its key")

    # (e) the memory the cache keeps between calls
    render(sa, static, cfg, eng)
    torch.cuda.synchronize()
    kept = torch.cuda.memory_reserved()
    n_entries = len(wavefront._RENDERER_CACHE)
    wavefront._RENDERER_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    freed = torch.cuda.memory_reserved()
    print(f"phase 14: (e) memory reserved after a render with "
          f"{n_entries} cache entries {kept / 2**30:.3f} GiB; after "
          f"_RENDERER_CACHE.clear() and empty_cache() {freed / 2**30:.3f} "
          f"GiB ({smi})")
    _check(freed < kept, "phase 14: (e) clearing the cache released no "
           "memory")
    print(f"phase 14: {time.perf_counter() - start:.1f} s in all ({smi})")


def conditional_nodes(smi):
    """Phase 15: IF nodes nested two deep (csrc/graph_cond.cu) in a small
    captured graph over one chunk's 32,768 rays, replayed under every mask
    pattern against the eager gates (``graphs.cond`` outside a capture,
    ``bool(mask.any())``), with their run counts; then the gate timed on
    a dead 32,768-ray mask, in a graph of 64 gates and eagerly.  Returns
    the kernel table's row of set_if."""
    import torch
    from rustray_tpu_torch import graphs
    from rustray_tpu_torch.render import wavefront
    dev = torch.device("cuda")
    start = time.perf_counter()
    gen = torch.Generator().manual_seed(15)
    x = torch.rand(CHUNK, generator=gen).to(dev)
    some = torch.rand(CHUNK, generator=gen) < 0.01
    masks = [torch.zeros(CHUNK, dtype=torch.bool, device=dev)
             for _ in range(2)]

    def program():
        def inner():
            return (x * 3.0 + 1.0,)

        def outer():
            y, = graphs.cond(masks[1], inner, lambda: (torch.zeros_like(x),),
                             "inner")
            return x + y, torch.where(masks[1], y, -1.0)

        return graphs.cond(masks[0], outer, lambda: (
            torch.zeros_like(x), torch.full_like(x, 7.0)), "outer")

    pool = torch.cuda.graph_pool_handle()
    census = wavefront._warm_up(program, dev)
    _check((census.gates, census.max_depth) == (2, 2),
           f"phase 15: the warm-up passed {census.gates} gates, "
           f"{census.max_depth} deep")
    graphs.reset_launches()
    with graphs.recording(dev, census) as rec:
        out, replay = wavefront._capture_graph(program, pool)
    _check(rec.sites == ["outer", "inner"], f"phase 15: nodes {rec.sites}")
    values = {"dead": torch.zeros(CHUNK, dtype=torch.bool),
              "partly live": some, "live": torch.ones(CHUNK,
                                                      dtype=torch.bool)}
    err = 0.0
    for pattern in (("dead", "dead"), ("dead", "live"),
                    ("partly live", "dead"), ("partly live", "partly live"),
                    ("live", "live")):
        for m, v in zip(masks, pattern):
            m.copy_(values[v])
        want = [t.clone() for t in program()]
        rec.runs.zero_()
        replay()
        torch.cuda.synchronize()
        for o, w in zip(out, want):
            err = max(err, float((o - w).abs().max()))
            _check(torch.equal(o, w), f"phase 15: {pattern}: the replay "
                   "differs from the eager gates")
        outer_ran = pattern[0] != "dead"
        runs = rec.runs.tolist()
        _check(runs == [int(outer_ran), int(outer_ran and pattern[1] !=
                                            "dead")],
               f"phase 15: {pattern}: runs {runs}")
        print(f"phase 15: masks {pattern[0]} / {pattern[1]}: the replay "
              f"equals the eager gates, runs {runs}")

    # the gate on a dead mask: 64 in one graph, and eagerly
    n_gates = 64
    dead = torch.zeros(CHUNK, dtype=torch.bool, device=dev)

    def gates():
        return [graphs.cond(dead, lambda: (x + 1.0,),
                            lambda: (torch.zeros_like(x),), "timed")[0]
                for _ in range(n_gates)]

    census = wavefront._warm_up(gates, dev)
    with graphs.recording(dev, census) as timed:
        _, replay64 = wavefront._capture_graph(gates, pool)
    ms = _cuda_ms(replay64, 20) / n_gates
    plain_ms = _cuda_ms(lambda: [graphs.cond(dead, lambda: (x + 1.0,),
                                             lambda: (torch.zeros_like(x),),
                                             "timed")
                                 for _ in range(n_gates)], 5) / n_gates
    _check(timed.runs.sum().item() == 0, "phase 15: a dead gate ran")
    # per gate: the mask read once, the predicate written and read, runs
    # read and written
    bound_ms = (CHUNK + 2 + 16) / 3.35e12 * 1e3
    print(f"phase 15: gate on a dead {CHUNK}-ray mask (mask.any(), set_if, "
          f"the IF node): {ms * 1e3:.2f} us per gate in a graph of "
          f"{n_gates}, eagerly (bool(mask.any()), a host sync) "
          f"{plain_ms * 1e3:.2f} us; bound {bound_ms * 1e6:.2f} ns "
          f"(bytes); phase 15 in {time.perf_counter() - start:.1f} s "
          f"({smi})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes",
                tests=n_gates)


def profiled_frames(smi):
    """Phase 16: the 1-spp bench frame replayed (the graphs its first
    frame captured) and eagerly, each under torch.profiler in a process
    of its own (``tools/profile_frame.py``), through K1 and the octet
    path: device busy time, idle share and the port's kernels' calls side
    by side."""
    import re
    start = time.perf_counter()
    ours = ("walk_units_kernel", "round0_kernel")
    for algo in ("block", "octet"):
        seen = {}
        for mode in ("replayed", "eager"):
            args = [sys.executable, "-m", "rustray_tpu_torch.tools."
                    "profile_frame", algo, "1"] + ["eager"] * (
                        mode == "eager")
            run = subprocess.run(args, cwd=ROOT, capture_output=True,
                                 text=True, timeout=300)
            _check(run.returncode == 0, f"phase 16: {' '.join(args[2:])} "
                   f"failed:\n{run.stdout[-2000:]}{run.stderr[-2000:]}")
            head = next(line for line in run.stdout.splitlines()
                        if line.startswith(algo))
            m = re.search(r"device busy ([0-9.]+) s, idle share ([0-9.]+)",
                          head)
            calls = {k: int(line.split()[2]) for line in
                     run.stdout.splitlines() for k in ours if k in line}
            seen[mode] = calls
            print(f"phase 16: {algo} {mode}: device busy {m.group(1)} s, "
                  f"idle share {m.group(2)}; the port's kernels' calls in "
                  f"the trace {calls} ({head.strip()}) ({smi})")
        complete = seen["replayed"] == seen["eager"]
        print(f"phase 16: {algo}: the traces hold "
              f"{'the same' if complete else 'DIFFERENT'} numbers of the "
              "port's kernels (a trace that lost device events differs)")
    print(f"phase 16 in {time.perf_counter() - start:.1f} s ({smi})")


@contextlib.contextmanager
def _rng_twin():
    """rng.fold_in and rng.uniform by the plain twin on every device (the
    parent's generator); the renderer cache is emptied on entry and exit,
    so no graph captured with one generator is replayed with the other."""
    from rustray_tpu_torch import rng
    from rustray_tpu_torch.render import wavefront
    saved = rng.fold_in, rng.uniform_words
    wavefront._RENDERER_CACHE.clear()
    rng.fold_in, rng.uniform_words = rng.fold_in_twin, rng.uniform_words_twin
    try:
        yield
    finally:
        rng.fold_in, rng.uniform_words = saved
        wavefront._RENDERER_CACHE.clear()


def _rng_bound_ms(n, ops=RNG_ALU_OPS):
    return max(ops * n / INT32_OPS_S, 4 * n / 3.35e12) * 1e3


def rng_kernels(smi):
    """Phase 20 (a, b): the threefry kernels against the twin bit for bit
    at the still frame's shapes and at odd sizes, and timed in graphs of 20
    launches beside the twin's chain and the bound.  Returns the kernel
    table's rows (uniform, fold_in), without launches."""
    import torch
    from rustray_tpu_torch import rng
    start = time.perf_counter()
    host_keys = [rng.fold_in(rng.PRNGKey(s), 65536)
                 for s in (0, 2 ** 31 + 20, 2 ** 32 - 1)]
    host_keys += [torch.tensor(w, dtype=torch.int64) for w in (
        (0, 0), (0xFFFFFFFF, 0xFFFFFFFF))]
    shapes = RNG_SHAPES + ((0,), (1,), (3,), (5,), (4097,))
    for hk in host_keys:
        key = hk.cuda()
        for shape in shapes:
            want = rng.uniform_words_twin(*key.unbind(), shape, "cuda")
            for got in (rng.uniform(key, shape, "cuda"),
                        rng.uniform(hk, shape, "cuda")):
                _check(got.shape == want.shape and torch.equal(
                    got.view(torch.int32), want.view(torch.int32)),
                    f"phase 20: uniform {shape} under {hk.tolist()} differs "
                    f"from the twin")
        for data in (0, 3, 17, 23, 65536, 0xFFFFFFFF):
            want = rng.fold_in_twin(key, data)
            _check(torch.equal(rng.fold_in(key, data), want)
                   and torch.equal(rng.fold_in(key, torch.tensor(
                       data, dtype=torch.int64, device="cuda")), want),
                   f"phase 20: fold_in({hk.tolist()}, {data}) differs from "
                   f"the twin")
    torch.cuda.synchronize()
    print(f"phase 20: uniform at {len(shapes)} shapes and fold_in at 6 data "
          f"under {len(host_keys)} keys, from device keys and host words: "
          f"bit for bit the twin's on the card")
    key = host_keys[0].cuda()
    u_row, f_row = _row(), _row()
    for shape in RNG_SHAPES:
        n = 1
        for e in shape:
            n *= e
        ms = _graph_ms(lambda k: rng.uniform(k, shape, "cuda"), [(key,)], 20)
        twin = _graph_ms(lambda k: rng.uniform_words_twin(
            *k.unbind(), shape, "cuda"), [(key,)], 20)
        eager = _cuda_ms(lambda: rng.uniform_words_twin(
            *key.unbind(), shape, "cuda"), 20)
        bound = _rng_bound_ms(n)
        print(f"phase 20: uniform {shape} ({n} floats): kernel {ms:.4f} ms "
              f"(graph of 20), twin {twin:.4f} ms in a graph, {eager:.4f} "
              f"ms eagerly; bound {bound:.4f} ms ({RNG_ALU_OPS} integer-pipe "
              f"operations an element; all {RNG_OPS} on that pipe would "
              f"take {_rng_bound_ms(n, RNG_OPS):.4f} ms); kernel at "
              f"{bound / ms:.2%} of its bound, {twin / ms:.1f}x faster "
              f"than the twin")
        u_row["ms"] += ms
        u_row["plain_ms"] += twin
        u_row["bound_ms"] += bound
        u_row["tests"] += n
    ms = _graph_ms(lambda k: rng.fold_in(k, 17), [(key,)], 20)
    twin = _graph_ms(lambda k: rng.fold_in_twin(k, 17), [(key,)], 20)
    bound = _rng_bound_ms(1)
    print(f"phase 20: fold_in: kernel {ms:.4f} ms (graph of 20), twin "
          f"{twin:.4f} ms in a graph; bound {bound:.2e} ms: a launch")
    f_row.update(ms=ms, plain_ms=twin, bound_ms=bound, tests=1)
    print(f"phase 20 (a, b) in {time.perf_counter() - start:.1f} s ({smi})")
    return u_row, f_row


def rng_frames(smi, sa, static, cfg, engine, samples, out4):
    """Phase 20 (c-e): the kernels' bits in the frame and the gradient
    against the twin's, and the kernels a replayed frame launches with
    each.  Returns the kernel child's counts (threefry launches per
    replayed frame under ``uniform`` and ``fold_in``)."""
    import dataclasses
    import numpy as np
    import torch
    from rustray_tpu_torch import EngineConfig, render, rng
    from rustray_tpu_torch.parallel import shard
    from rustray_tpu_torch.render import wavefront
    start = time.perf_counter()
    cfg_s = dataclasses.replace(cfg, samples=samples)
    with _rng_twin():
        twin_out = render(sa, static, cfg_s, engine)
    diff = _differ(twin_out, out4)
    _check(not diff, f"phase 20: phase 4's frame with the twin differs in "
           f"{diff}")
    print(f"phase 20: phase 4's {samples}-spp frame captured and replayed "
          f"with the twin: equal bit for bit in {', '.join(FRAME_KEYS)}")

    cfg1 = dataclasses.replace(cfg, samples=1)
    target = np.full((static.height, static.width, 3), 0.5, np.float32)
    eng = EngineConfig(seed=20, chunk_pixels=524288)

    def grad():
        rng.reset_launches()
        loss, grads, color = shard.render_loss_and_grad(
            sa, static, cfg1, target, eng, return_color=True)
        torch.cuda.synchronize()
        flat = torch.cat([v.detach().reshape(-1).double()
                          for d in grads.values() for v in d.values()])
        return float(loss), flat, color.cpu().numpy(), dict(rng.launches)

    wavefront._RENDERER_CACHE.clear()
    torch.cuda.empty_cache()
    first, second = grad(), grad()
    with _rng_twin():
        twin = grad()
    torch.cuda.empty_cache()

    def rel(a, b):
        return float((a - b).norm() / max(float(b.norm()), 1e-30))

    rerun, off = rel(second[1], first[1]), rel(twin[1], first[1])
    _check(np.array_equal(first[2], twin[2]) and first[0] == twin[0],
           f"phase 20: the gradient's image or loss differs with the twin "
           f"(loss {first[0]!r} vs {twin[0]!r})")
    _check(off <= 4.0 * rerun + 1e-12, f"phase 20: the gradients with the "
           f"twin differ by {off:.3g} (relative L2), the kernels' two runs "
           f"by {rerun:.3g}")
    print(f"phase 20: 1-spp gradient at chunk 524,288: image and loss "
          f"{first[0]!r} equal bit for bit with the twin; gradients' "
          f"relative L2 to the kernels' first run: twin {off:.3g}, the "
          f"kernels' second run {rerun:.3g}; threefry kernels {first[3]}, "
          f"twin {twin[3]}")

    counts = {}
    for mode in ("twin", "kernel"):
        run = subprocess.run([sys.executable, os.path.join(
            ROOT, "chip_smoke.py"), "--replay-kernels", mode], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        _check(run.returncode == 0, f"phase 20: --replay-kernels {mode} "
               f"failed:\n{run.stdout[-2000:]}{run.stderr[-2000:]}")
        counts[mode] = json.loads(run.stdout.strip().splitlines()[-1])
        print(f"phase 20: replayed {samples}-spp K1 frame with the {mode}: "
              f"{counts[mode]} ({smi})")
    _check(counts["twin"]["threefry"] == 0 and counts["kernel"]["threefry"]
           > 0, f"phase 20: threefry kernels in the traces {counts}")
    _check(counts["kernel"]["kernels"] < counts["twin"]["kernels"],
           f"phase 20: the kernels launched no fewer kernels {counts}")
    print(f"phase 20: kernels per replayed {samples}-spp K1 frame: twin "
          f"{counts['twin']['kernels']}, kernels "
          f"{counts['kernel']['kernels']} "
          f"({counts['kernel']['threefry']} of them threefry's)")
    print(f"phase 20 (c-e) in {time.perf_counter() - start:.1f} s ({smi})")
    return counts["kernel"]


def replay_kernels(mode: str) -> int:
    """Phase 20's child process: the 2-spp 1280x720 bench frame through K1
    (phase 4's engine) captured, then replayed under torch.profiler, with
    rng's kernels (``kernel``) or with the twin in their place (``twin``).
    Prints one JSON line: the trace's kernels, the threefry kernels among
    them, device busy, profiled wall and idle share."""
    sys.path.insert(0, ROOT)
    from rustray_tpu_torch import EngineConfig, render, to_torch
    from rustray_tpu_torch.build import BUILD_DIR
    from rustray_tpu_torch.tools.capture_waves import load_bench_scene
    from rustray_tpu_torch.tools.devbench import device_summary
    from rustray_tpu_torch.tools.profile_frame import profile
    if mode not in ("twin", "kernel"):
        raise SystemExit(f"chip_smoke: --replay-kernels twin|kernel, not "
                         f"{mode!r}")
    scene = load_bench_scene(WIDTH, HEIGHT)
    sa, static = to_torch(*scene.compile(), "cuda")
    cfg = scene.raytracing_config
    cfg.samples = int(os.environ.get("SMOKE_SAMPLES", 2))
    engine = EngineConfig(chunk_pixels=CHUNK, pallas_block=BLOCK,
                          queue_factor=1.0)
    with _rng_twin() if mode == "twin" else contextlib.nullcontext():
        render(sa, static, cfg, engine)
        trace = os.path.join(BUILD_DIR, f"trace_rng_{mode}.json")
        _, p = profile(lambda: render(sa, static, cfg, engine), trace)
    _, ranked = device_summary(trace, 10 ** 9, ("kernel",))
    print(json.dumps(dict(
        kernels=sum(n for _, _, n in ranked),
        threefry=sum(n for k, _, n in ranked if "threefry" in k),
        uniform=sum(n for k, _, n in ranked if "threefry_uniform" in k),
        fold_in=sum(n for k, _, n in ranked if "threefry_fold_in" in k),
        busy_s=round(p["busy"], 4), wall_s=round(p["wall"], 4),
        idle=round(p["idle"], 4), captures=p["graph"]["captures"],
        replays=p["graph"]["replays"])))
    return 0


def pbr_phase(smi, sa, static, cfg):
    """Phase 21: the glTF material model (the benchmark's ``sponza_pbr``
    scene: every material with base-colour, normal and metallic-roughness
    maps of 1024², 9 spheres with cut-out foliage) at 320x180, 2 spp, with
    the CLI's engine: a frame that captures, one that replays and one of
    the eager chunk program, equal bit for bit, and the shading census
    (render/wavefront.shading) equal between the replayed frame and the
    eager one.  The bench frame, whose only maps are base colour, counts
    nothing, so its graphs launch what they launched before the census."""
    import dataclasses
    import tempfile
    import torch
    from rustray_tpu_torch import EngineConfig, render, to_torch
    from rustray_tpu_torch.render import wavefront
    from rustray_tpu_torch.scene.scene import Scene
    from perfbench import named
    start = time.perf_counter()

    def census():
        return {k: int(v) for k, v in wavefront.shading.items()}

    wavefront.reset_shading()
    render(sa, static, dataclasses.replace(cfg, samples=1), EngineConfig())
    _check(census() == {"hits": 0, "cutout": 0, "fetches": 0},
           f"phase 21: the bench frame counted shading {census()}")
    _check(not wavefront.counts_shading(static), "phase 21: the bench "
           "scene's static asks for the shading census")

    with open(os.path.join(ROOT, "perfbench", "configs",
                           "sponza_pbr.json")) as f:
        config = json.load(f)
    gen = named.find("scenes", config["scene"]["generator"])
    t0 = time.perf_counter()
    data = gen.program_scene(config, 2)
    t_assets = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scene.json")
        with open(path, "w") as f:
            json.dump(data, f)
        scene = Scene()
        t0 = time.perf_counter()
        scene.load(path)
        sa21, st21 = to_torch(*scene.compile(320, 180), "cuda")
        t_load = time.perf_counter() - t0
    cfg21 = scene.raytracing_config
    _check(wavefront.counts_shading(st21), "phase 21: the PBR scene's "
           "static does not ask for the shading census")
    engine = EngineConfig(seed=21)
    wavefront._RENDERER_CACHE.clear()
    wavefront.reset_graph_stats()
    frames, counts = {}, {}
    for name in ("captured", "replayed", "eager"):
        wavefront.reset_shading()
        if name == "eager":
            frames[name] = _eager(lambda: render(sa21, st21, cfg21, engine))
        else:
            frames[name] = render(sa21, st21, cfg21, engine)
        counts[name] = census()
    g = dict(wavefront.graph_stats)
    for name in ("captured", "replayed"):
        diff = _differ(frames[name], frames["eager"])
        _check(not diff, f"phase 21: the {name} frame differs from the "
               f"eager one in {diff}")
    _check(counts["replayed"] == counts["eager"], f"phase 21: the shading "
           f"census of the replayed frame {counts['replayed']} against the "
           f"eager frame's {counts['eager']}")
    c = counts["eager"]
    _check(c["hits"] > 0 and c["cutout"] > 0 and c["fetches"] == 4 *
           c["hits"], f"phase 21: census {c}")
    _check(frames["eager"]["dropped_rays"] == 0, "phase 21: dropped rays")
    print(f"phase 21: sponza_pbr at 320x180, 2 spp: assets {t_assets:.1f} "
          f"s, load and compile {t_load:.1f} s ({st21.n_tris} triangles, "
          f"{int(sa21.tex_texels.shape[0])} texels); captured, replayed and "
          f"eager frames equal bit for bit in {', '.join(FRAME_KEYS)}; "
          f"census replayed {counts['replayed']} = eager {counts['eager']} "
          f"(captured frame {counts['captured']}, warm-up included): "
          f"{c['fetches'] / c['hits']:.3f} fetches a hit, "
          f"{100.0 * c['cutout'] / c['hits']:.3f}% cut-out; graphs {g}; "
          f"device rays {frames['eager']['device_rays']}")
    del sa21, st21, frames
    wavefront._RENDERER_CACHE.clear()
    torch.cuda.empty_cache()
    print(f"phase 21 in {time.perf_counter() - start:.1f} s ({smi})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "rustray_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository (the "
              "rustray_tpu_torch package is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import dataclasses
    import numpy as np
    from rustray_tpu_torch import EngineConfig, render, to_torch
    from rustray_tpu_torch import build
    from rustray_tpu_torch.ops import block_trace as bt
    from rustray_tpu_torch.ops import octet_trace as ot
    from rustray_tpu_torch.render.wavefront import prepare_frame
    from rustray_tpu_torch.tools import octet_kernel_bench as okb
    from rustray_tpu_torch.tools.capture_waves import (
        MIDDLE_CHUNK, capture, load_bench_scene)
    from rustray_tpu_torch.tools.walk_compare import level1_rays, sorted_sets

    # ---- phase 1: the card ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1: device {kind}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    from rustray_tpu_torch import graphs
    runtime, driver = graphs.versions()
    pools = {f: hasattr(torch._C, f) for f in (
        "_cuda_beginAllocateCurrentThreadToPool", "_cuda_endAllocateToPool",
        "_cuda_releasePool")}
    print(f"phase 1: cudaRuntimeGetVersion {runtime}, cudaDriverGetVersion "
          f"{driver}; torch allocator pool routing {pools}")
    _check(all(pools.values()), "phase 1: torch lacks the allocator calls "
           "that route an IF node body's allocations to its graph's pool")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 2: build every kernel from the checkout, in parallel ----
    build.build_kernel_libs(KERNEL_SOURCES)
    for name in KERNEL_SOURCES:
        build.load_kernel_lib(name)
        print(f"phase 2: nvcc built {name}.cu in "
              f"{build.build_seconds[name]:.2f} s")
        for line in build.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line or \
                    "Compiling entry" in line:
                print(f"phase 2: ptxas: {line.strip()}")

    # ---- phase 3: kernels vs twins on the bench scene ----
    t0 = time.perf_counter()
    scene = load_bench_scene(WIDTH, HEIGHT)
    sa_np, static_np = scene.compile()
    cfg = scene.raytracing_config
    _check(static_np.n_tris == 249698, f"n_tris {static_np.n_tris}")
    _check(static_np.n_clusters == 2593, f"n_clusters "
           f"{static_np.n_clusters}")
    sa, static = to_torch(sa_np, static_np, "cuda")
    engine = EngineConfig(chunk_pixels=CHUNK, pallas_block=BLOCK,
                          queue_factor=1.0)
    prep, boxes = prepare_frame(sa, static, engine)
    _check(boxes is not None, "the bench engine did not select the block "
           "walk on CUDA")
    _check(bt.pack_is_gated(prep.pallas_pack), "the bench pack should "
           "select the gated walk")
    print(f"phase 3: bench scene loaded and compiled in "
          f"{time.perf_counter() - t0:.1f} s: {static.n_tris} triangles, "
          f"{static.n_clusters} clusters, {static.n_lights} lights, "
          f"pack {tuple(prep.pallas_pack.shape)}")
    sets = sorted_sets(sa, boxes,
                       level1_rays(sa, static, prep, boxes, cfg, engine))
    walk_rows = compare_walks(prep, boxes, sets)
    check_argmin_ties()
    round_rows = compare_rounds(prep, boxes, sets)

    samples = int(os.environ.get("SMOKE_SAMPLES", 2))
    walk = {"K1": (bt.launches, bt.reset_launches),
            "K2": (bt.ungated_launches, bt.reset_launches),
            "lists": (bt.list_launches, bt.reset_launches),
            "set_if": (graphs.launches, graphs.reset_launches)}

    # ---- phase 4: the main path ----
    secs4, per4, c4, out4, g4 = bench_frame("phase 4", sa, static, cfg,
                                            engine, samples, walk)
    _check(g4["captures"] >= 1 and g4["replays"] >= 1,
           f"phase 4: the frame path captured no chunk program: {g4}")
    _check(all(n > 0 for n in c4["K1"].values()),
           f"a K1 mode never launched: {c4['K1']}")
    _check(not any(c4["K2"].values()), "the bench pack ran the ungated walk")
    print(f"phase 4: the TPU bench record is {TPU_RAYS_PER_SAMPLE:.1f} rays "
          f"per sample")

    # ---- phase 5: small frames against the JAX package and the twin ----
    ref = np.load(JAX_REFERENCE)
    tiny = load_bench_scene(160, 90)
    sa5, st5 = to_torch(*tiny.compile(), "cuda")
    cfg5 = tiny.raytracing_config
    cfg5.samples = 1
    j_out = render(sa5, st5, cfg5, engine)
    step = np.abs(j_out["image"].astype(np.int32)
                  - ref["image"].astype(np.int32)).max(axis=-1)
    within = (step <= 1).mean()
    oid = (j_out["object_id"] == ref["object_id"]).mean()
    print(f"phase 5: 160x90 vs the JAX package: device rays "
          f"{j_out['device_rays']} vs {int(ref['device_rays'])}, pixels "
          f"within one 8-bit step {within:.5f}, object ids equal {oid:.5f}")
    _check(j_out["device_rays"] == int(ref["device_rays"]),
           "device rays differ from the JAX package's")
    _check(within >= 0.995 and oid >= 0.995,
           "160x90 render differs from the JAX package's")
    tiny5 = (sa5, st5, cfg5)
    small = load_bench_scene(320, 180)
    sa5, st5 = to_torch(*small.compile(), "cuda")
    cfg5 = small.raytracing_config
    cfg5.samples = 1
    t0 = time.perf_counter()
    k_out = render(sa5, st5, cfg5, engine)
    t1 = time.perf_counter()
    p_out = render(sa5, st5, cfg5, dataclasses.replace(
        engine, pallas="on", pallas_interpret=True))
    t2 = time.perf_counter()
    print(f"phase 5: 320x180 1 spp kernel {t1 - t0:.2f} s, twin "
          f"{t2 - t1:.2f} s")
    compare_renders("phase 5: 320x180 K1 vs twin", k_out, p_out)

    # ---- phase 6: the octet path ----
    octet = dataclasses.replace(engine, pallas_algo="octet")
    octet_counts = {"K3": (ot.launches, ot.reset_counts), **walk}
    secs6, per6, c6, out6, g6 = bench_frame("phase 6", sa, static, cfg,
                                            octet, samples, octet_counts)
    fb6 = (int(ot.fallback["rays"]), ot.fallback["calls"])
    _check(all(n > 0 for n in c6["K3"].values()),
           f"the octet path never launched a round: {c6['K3']}")
    print(f"phase 6: octet frame {secs6:.2f} s vs block {secs4:.2f} s; "
          f"device rays per sample {per6 - per4:+.1f} from phase 4's; "
          f"fallback re-traced {fb6[0]} rays in {fb6[1]} calls")

    # ---- phase 7: the large-pack path (K2) ----
    budget = bt._VMEM_PACK_BUDGET
    bt._VMEM_PACK_BUDGET = 0
    try:
        secs7, per7, c7, _, _ = bench_frame("phase 7", sa, static, cfg,
                                            engine, 1, walk)
        _check(not any(c7["K1"].values()) and all(
            n > 0 for n in c7["K2"].values()),
            f"the forced large-pack frame did not run only K2: {c7}")
        k2_small = render(sa5, st5, cfg5, engine)
    finally:
        bt._VMEM_PACK_BUDGET = budget
    print(f"phase 7: K2 frame {secs7:.2f} s at 1 spp; device rays per "
          f"sample {per7 - per4:+.1f} from phase 4's")

    # ---- phase 8: 320x180, octet vs block and K2 vs K1 ----
    o_small = render(sa5, st5, cfg5, octet)
    compare_renders("phase 8: 320x180 octet vs block", o_small, k_out)
    compare_renders("phase 8: 320x180 K2 vs K1", k2_small, k_out)

    # ---- phase 9: the octet kernel bench (K4) ----
    cfg.samples = 1
    waves = capture(sa, static, cfg, engine)
    nlive, rays, aabb = okb.bench_inputs(waves, sa, boxes)
    print(f"phase 9: captured chunk {MIDDLE_CHUNK}, level-3 closest "
          f"wavefront: {rays.shape[0]} rays, {int(nlive[0])} live octets")
    okb.reset_launches()
    k4_ms = okb.time_variants(nlive, rays, aabb, prep.pallas_pack)
    k4_launches = dict(okb.launches)
    # the captured wavefront rarely meets clusters 0..15, so each variant
    # is also checked on probe rays that do (okb.probe_inputs)
    probe = okb.probe_inputs(sa, boxes, CHUNK)
    k4_rows = {}
    for v in okb.VARIANTS:
        row = okb.check(nlive, rays, aabb, prep.pallas_pack, v)
        p_row = okb.check(*probe, prep.pallas_pack, v)
        _check(v == "v1" or p_row["hits"] > 0, f"K4 {v}: no hit on the "
               "probe rays")
        row["ms"] = k4_ms[v]
        row["plain_ms"] = _cuda_ms(lambda: okb.bench_kernel(
            nlive, rays, aabb, prep.pallas_pack, v, interpret=True), 1)
        row["tests"], row["bound_ms"], row["bound_by"] = okb.bench_work(
            nlive, rays, aabb, prep.pallas_pack, v)
        k4_rows[v] = row
        print(f"phase 9: K4 {v:5s} t and idx equal to the twin's, "
              f"hits={row['hits']}; probe t and idx equal, "
              f"hits={p_row['hits']}; kernel {row['ms']:.3f} ms, twin "
              f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}); kernel at "
              f"{row['bound_ms'] / row['ms']:.2%} of its bound")
    _check(all(n > 0 for n in k4_launches.values()),
           f"a K4 variant never launched: {k4_launches}")

    # ---- phase 10: the user's entry points ----
    entry_points(smi[0], os.path.join(build.BUILD_DIR, "bench_scene.json"),
                 (sa5, st5, cfg5), k_out, engine)

    # ---- phase 11: scene gradients and the rays x samples split ----
    gradients(smi[0], (sa5, st5, cfg5), tiny5)

    # ---- phase 12: the frame path against the eager chunk program ----
    frame_path(smi[0], sa, static, cfg, samples, {
        "K1": (engine, walk, (secs4, c4, out4, g4, 0)),
        "octet": (octet, octet_counts, (secs6, c6, out6, g6, fb6[0]))})

    # ---- phase 13: the repo's tools on the card ----
    tools_phase(smi[0], sa, static, cfg)

    # ---- phase 14: the renderer cache across frames ----
    frames_phase(smi[0], sa, static, cfg, {
        "K1": (engine, walk, budget), "octet": (octet, octet_counts, budget),
        "K2 (forced)": (engine, walk, 0)})

    # ---- phase 15: conditional graph nodes ----
    cond_row = conditional_nodes(smi[0])

    # ---- phase 16: replayed and eager frames under the profiler ----
    profiled_frames(smi[0])

    # ---- phase 17: the block-list kernel at the main path's shapes ----
    list_row = compare_lists(smi[0], sa, static, cfg)

    # ---- phase 18: the gradient at the main path's size, in chunks ----
    grad18 = chunked_gradient(smi[0], sa, static, cfg)

    # ---- phase 19: the material-row kernel at the main path's shapes ----
    mat_row = mat_rows_phase(smi[0], sa, static, cfg)

    # ---- phase 20: the threefry kernels ----
    u_row, f_row = rng_kernels(smi[0])
    rng_replay = rng_frames(smi[0], sa, static, cfg, engine, samples, out4)

    # ---- phase 21: the glTF material model and the shading census ----
    pbr_phase(smi[0], sa, static, cfg)

    def entry(name, source, replaces, launches, row):
        # no one PyTorch call computes any of the walks, and torch has no
        # call that makes a conditional graph node: library_ms null but for
        # the material rows (autograd's indexing backward)
        return dict(name=name, route="cuda",
                    source=f"rustray_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches,
                    max_abs_err=row["max_abs_err"], ms=row["ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"],
                    library_ms=row.get("library_ms"), tests=row["tests"])

    kernels = (
        [entry(f"block_walk[{m}]", "block_trace.cu", TPU_K1, c4["K1"][m],
               walk_rows[(True, m)]) for m in ("closest", "any")]
        + [entry(f"block_walk_ungated[{m}]", "block_trace.cu", TPU_K2,
                 c7["K2"][m], walk_rows[(False, m)])
           for m in ("closest", "any")]
        + [entry(f"octet_round[slots={k}]", "octet_trace.cu", TPU_K3,
                 c6["K3"][k], round_rows[k]) for k in (1, 4)]
        + [entry(f"octet_bench[{v}]", "octet_bench.cu", TPU_K4,
                 k4_launches[v], k4_rows[v]) for v in okb.VARIANTS]
        + [entry("set_if", "graph_cond.cu", ", ".join(TPU_CONDS),
                 c4["set_if"]["set_if"], cond_row),
           entry("block_lists", "block_lists.cu", TPU_LISTS,
                 sum(c4["lists"].values()), list_row),
           entry("mat_rows", "mat_rows.cu", TPU_MAT_ROWS,
                 grad18["mat_rows"]["launches"], mat_row),
           entry("threefry_uniform", "threefry.cu", TPU_RNG,
                 rng_replay["uniform"], u_row),
           entry("threefry_fold_in", "threefry.cu", TPU_RNG,
                 rng_replay["fold_in"], f_row)])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def pbr_only() -> int:
    """Phase 21 alone, on the 1280x720 bench scene and the PBR scene."""
    sys.path.insert(0, ROOT)
    from rustray_tpu_torch import to_torch
    from rustray_tpu_torch.tools.capture_waves import load_bench_scene
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    scene = load_bench_scene(WIDTH, HEIGHT)
    sa, static = to_torch(*scene.compile(), "cuda")
    pbr_phase(smi, sa, static, scene.raytracing_config)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--replay-kernels"] and len(sys.argv) == 3:
        sys.exit(replay_kernels(sys.argv[2]))
    if sys.argv[1:] == ["--pbr"]:
        sys.exit(pbr_only())
    sys.exit(main())
