"""Sharded rendering and scene-parameter gradients over torch.distributed.

Port of ``rustray_tpu/parallel/shard.py``.  The world's ranks form a
("rays", "samples") grid, ``reshape(n // sample_axis, sample_axis)`` as the
JAX package lays out its device mesh:

  - pixels → split over "rays" (the analogue of the reference's tile queue)
  - AA/MC sample cells → split over "samples"
  - the scene → replicated: every rank holds the whole SceneArrays

Per-sample sums are reduced with ``all_reduce`` over "samples", the
gradients over the world.  Only ``all_reduce`` is used (gloo has no
``all_gather`` for CUDA tensors): a rank writes its pixels into a zero
frame and the frame is summed over "rays", so every rank returns the whole
frame.  Every decision that leads to a collective (the queue auto-raise)
is taken on all-reduced values, so the ranks never diverge.

Unlike the JAX package, :func:`render_loss_and_grad` returns the true
gradient on every mesh: the JAX package differentiates through its
``psum`` over "samples" and then sums the gradients over both axes, which
scales them by the number of sample shards.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from .. import rng, spans
from ..config import EngineConfig, RaytracingConfig
from ..render.wavefront import (build_chunk_fn, chunk_cells, chunk_key,
                                chunk_slab, finish_frame, frame_levels,
                                max_queue_factor, prepare_frame, raise_queue)

# rays dropped past the queue cap inside render_loss_and_grad, summed over
# the world (it has no auto-raise, as in the JAX package)
dropped = {"rays": 0}

# render_loss_and_grad's counters since reset_grad_stats(): calls, chunks,
# (chunk, sample cell) renders, and on CUDA the device milliseconds of the
# chunks' forward passes (render and loss) and backward passes
grad_stats = {"calls": 0, "chunks": 0, "cells": 0, "forward_ms": 0.0,
              "backward_ms": 0.0}


def reset_dropped() -> None:
    dropped["rays"] = 0


def init_distributed(backend: str, init_method: str, world_size: int,
                     rank: int) -> None:
    """Join the process group: ``backend`` "nccl" with one GPU per rank,
    "gloo" on the CPU or with ranks sharing a card; ``init_method`` e.g.
    ``tcp://localhost:<port>``."""
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)


@dataclass
class Mesh:
    """This rank's place on the ("rays", "samples") grid.  ``groups`` maps
    an axis to the process group of the ranks that differ from this one
    only along it, and "world" to every rank; an axis one rank wide has no
    group."""
    shape: Dict[str, int]
    ray: int = 0
    sample: int = 0
    groups: Dict[str, object] = field(default_factory=dict)


def make_mesh(sample_axis: int = 1) -> Mesh:
    """The world as ``reshape(n // sample_axis, sample_axis)``: rank r sits
    at (r // sample_axis, r % sample_axis).  Without a process group it is
    a 1 × 1 mesh.  Collective: every rank calls it with the same argument."""
    if not dist.is_initialized():
        if sample_axis != 1:
            raise ValueError("a mesh with sample_axis > 1 needs a process "
                             "group (init_distributed)")
        return Mesh({"rays": 1, "samples": 1})
    n = dist.get_world_size()
    rank = dist.get_rank()
    if sample_axis < 1 or n % sample_axis:
        raise ValueError(f"sample_axis {sample_axis} does not divide the "
                         f"world of {n} ranks")
    grid = np.arange(n).reshape(n // sample_axis, sample_axis)
    groups = {"world": dist.group.WORLD} if n > 1 else {}
    # new_group is collective over the world: every rank creates every
    # group of an axis, in the same order
    for axis, lines in (("samples", list(grid)), ("rays", list(grid.T))):
        if len(lines[0]) == 1:
            continue
        for line in lines:
            g = (dist.group.WORLD if len(line) == n
                 else dist.new_group([int(r) for r in line]))
            if rank in line:
                groups[axis] = g
    return Mesh({"rays": grid.shape[0], "samples": sample_axis},
                rank // sample_axis, rank % sample_axis, groups)


def _sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum ``x`` in place over ``axis`` ("rays", "samples" or "world")."""
    group = mesh.groups.get(axis)
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


@torch.no_grad()
def render_sharded(sa, static, cfg: RaytracingConfig,
                   engine: EngineConfig = None,
                   mesh: Mesh = None) -> Dict[str, np.ndarray]:
    """Render the frame over the mesh: pixel chunks of
    ``engine.chunk_pixels`` per ray shard, each rank its slab of the
    chunk's pixels and its share of the sample cells.  A chunk that drops
    live secondary rays is re-rendered by every rank at a doubled queue
    factor until the full Whitted tree fits.  The raised factor then stays
    for the chunks that follow, as in the JAX package's ``render_sharded``,
    while ``render()``, like the JAX package's, first renders every chunk
    at the engine's own factor.  The two differ on purpose: each keeps its
    JAX counterpart's rule.

    Returns the numpy AOVs of ``render()`` on every rank: ``image``,
    ``color``, ``depth``, ``normal``, ``object_id``, ``device_rays`` and
    ``dropped_rays``, summed over the world."""
    engine = engine or EngineConfig()
    mesh = mesh or make_mesh()
    dev = sa.verts.device
    n_levels = frame_levels(sa, cfg)
    max_qf = max_queue_factor(n_levels)

    W, H = static.width, static.height
    n_pix = W * H
    span = min(engine.chunk_pixels * mesh.shape["rays"], n_pix)
    cells = chunk_cells(cfg, engine.seed, mesh.sample, mesh.shape["samples"])
    # object id: the last sample wins, so only the rank holding the last
    # sample cell contributes its id to the sum over "samples"
    owns_last = bool((cells[1] == cfg.samples - 1).any())
    prep, boxes = prepare_frame(sa, static, engine)

    color = torch.zeros((n_pix, 3), device=dev)
    depth = torch.zeros((n_pix,), device=dev)
    normal = torch.zeros((n_pix, 3), device=dev)
    obj_id = torch.zeros((n_pix,), dtype=torch.int32, device=dev)
    device_rays = dropped_rays = 0

    def render_at(px, py, valid, key, eng):
        c, d, n, oid, n_drop, traced = build_chunk_fn(
            static, cfg, eng, n_levels)(sa, prep, boxes, px, py, valid,
                                        *cells, key)
        c, d, n = (_sum(x, mesh, "samples") for x in (c, d, n))
        oid = _sum(oid if owns_last else torch.zeros_like(oid), mesh,
                   "samples")
        n_drop, traced = _sum(torch.stack([n_drop, traced]), mesh,
                              "world").tolist()
        return (c, d, n, oid), n_drop, traced

    eng = engine
    for start in range(0, n_pix, span):
        px, py, valid, pix = chunk_slab(static, start, span, dev, mesh.ray,
                                        mesh.shape["rays"])
        at = functools.partial(render_at, px, py, valid,
                               chunk_key(engine.seed, start))
        out, n_drop, traced = at(eng)
        rerun, eng, attempts, n_drop = raise_queue(at, eng, n_drop, max_qf,
                                                   "sharded chunk")
        # as in the JAX package, only the last attempt's rays count
        device_rays += (attempts or [traced])[-1]
        dropped_rays += n_drop
        mine = pix[valid]
        for acc, part in zip((color, depth, normal, obj_id),
                             out if rerun is None else rerun):
            acc[mine] = part[valid]

    # each rank holds its own ray shard's pixels (the same on every rank
    # of a "samples" line): the sum over "rays" is the whole frame
    color, depth, normal, obj_id = (_sum(x, mesh, "rays")
                                    for x in (color, depth, normal, obj_id))
    return finish_frame(color, depth, normal, obj_id, cfg, W, H, device_rays,
                        dropped_rays)


# --------------------------------------------------------------------------
# Differentiable scene optimization: sharded value-and-grad
# --------------------------------------------------------------------------

DIFF_MATERIAL_FIELDS = ("ambient_color", "base_color", "specular_color",
                        "alpha", "shininess", "reflectivity",
                        "refraction_index", "normal_map_strength",
                        "shadow_softness", "roughness")
DIFF_LIGHT_FIELDS = ("pos", "dir", "color", "intensity", "max_angle")


def extract_diff_params(sa) -> Dict:
    """Differentiable scene parameters (materials, lights, camera) as
    dicts of the scene's own tensors, under the JAX package's keys."""
    return dict(
        materials={f: getattr(sa.materials, f) for f in DIFF_MATERIAL_FIELDS},
        lights={f: getattr(sa.lights, f) for f in DIFF_LIGHT_FIELDS},
        camera=dict(proj_inv=sa.camera.proj_inv, view_inv=sa.camera.view_inv),
    )


def apply_diff_params(sa, params: Dict):
    """A copy of ``sa`` with the parameters of :func:`extract_diff_params`
    replaced by ``params``."""
    return dataclasses.replace(
        sa,
        materials=dataclasses.replace(sa.materials, **params["materials"]),
        lights=dataclasses.replace(sa.lights, **params["lights"]),
        camera=dataclasses.replace(sa.camera, **params["camera"]),
    )


def reset_grad_stats() -> None:
    grad_stats.update(calls=0, chunks=0, cells=0, forward_ms=0.0,
                      backward_ms=0.0)


def render_loss_and_grad(sa, static, cfg: RaytracingConfig, target,
                         engine: EngineConfig = None, mesh: Mesh = None,
                         pixel_weight=None, return_color: bool = False):
    """loss = MSE(render, target) over the frame and its gradients with
    respect to :func:`extract_diff_params`, over the mesh.

    Each rank renders its ray shard's pixels over its sample cells.  When
    they fit in ``engine.chunk_pixels`` they are one chunk with key
    ``PRNGKey(seed)``, no chunk start folded in, as in the JAX package.
    A larger frame renders in chunks of ``chunk_pixels`` per ray shard, as
    :func:`render_sharded` does, each with key ``fold_in(PRNGKey(seed),
    start)``, so that its image is ``render()``'s for the same engine;
    the JAX package has no such path and keeps its one-chunk key.  Every
    sample cell of a pixel lies in the pixel's chunk, so a chunk takes the
    loss of its own pixels, runs its backward and frees its graph before
    the next chunk: the peak memory follows the chunk, not the frame.
    With ``c_r`` a chunk's summed color on this rank, the loss is taken
    from ``C = Σ_samples c_r`` and the backward runs on ``Σ g·c_r``, ``g =
    ∂loss/∂C``; the gradients are summed over the chunks, then over the
    world, and the loss over "rays".

    ``pixel_weight`` (H·W or (H, W); None: all ones) weights each pixel's
    squared error.  Returns (loss 0-dim tensor, grads with the structure
    of the parameters; a leaf that no gradient reaches, e.g.
    ``lights.max_angle``, is zeros), and with ``return_color`` also the
    rendered mean colour (H·W, 3), clamped at 1 as ``render()``'s, the
    whole frame on every rank.  Live rays past the queue cap are dropped
    without a re-render and counted in :data:`dropped`.

    The call is the ``grad`` span; per chunk ``grad.forward`` (the render
    under autograd and the loss) and ``grad.backward``, then
    ``grad.reduce``.  :data:`grad_stats` counts the calls, chunks and
    (chunk, cell) renders, and on CUDA the forward and backward device
    milliseconds, read from events after the call's final sync."""
    with spans.span("grad"):
        return _loss_and_grad(sa, static, cfg, target,
                              engine or EngineConfig(), mesh or make_mesh(),
                              pixel_weight, return_color)


def _loss_and_grad(sa, static, cfg, target, engine, mesh, pixel_weight,
                   return_color):
    dev = sa.verts.device
    n_pix = static.width * static.height
    inv_s = 1.0 / cfg.samples
    one_chunk = -(-n_pix // mesh.shape["rays"]) <= engine.chunk_pixels
    span = n_pix if one_chunk else engine.chunk_pixels * mesh.shape["rays"]
    cells, cell_idx, cell_valid = chunk_cells(cfg, engine.seed, mesh.sample,
                                              mesh.shape["samples"])
    # one zero row past the frame for the padded pixels
    tgt = torch.as_tensor(np.concatenate(
        [np.asarray(target, np.float32).reshape(-1, 3),
         np.zeros((1, 3), np.float32)]), device=dev)
    wgt = None if pixel_weight is None else torch.as_tensor(np.concatenate(
        [np.asarray(pixel_weight, np.float32).reshape(-1),
         np.zeros((1,), np.float32)]), device=dev)

    params = {grp: {k: v.detach().clone().requires_grad_(True)
                    for k, v in leaves.items()}
              for grp, leaves in extract_diff_params(sa).items()}
    flat = [leaf for leaves in params.values() for leaf in leaves.values()]
    sa2 = apply_diff_params(sa, params)
    prep, boxes = prepare_frame(sa2, static, engine)
    chunk_fn = build_chunk_fn(static, cfg, engine, frame_levels(sa, cfg))
    timed = dev.type == "cuda"
    events = []
    loss = grads = None
    n_drop = torch.zeros((), dtype=torch.int64, device=dev)
    frame = torch.zeros((n_pix, 3), device=dev) if return_color else None
    starts = range(0, n_pix, span)
    for start in starts:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
            if timed else []
        with spans.span("grad.forward"):
            if ev:
                ev[0].record()
            px, py, valid, pix = chunk_slab(static, start, span, dev,
                                            mesh.ray, mesh.shape["rays"])
            at = torch.clamp(pix, max=n_pix)
            c, _, _, _, drops, _ = chunk_fn(
                sa2, prep, boxes, px, py, valid, cells, cell_idx, cell_valid,
                rng.PRNGKey(engine.seed) if one_chunk
                else chunk_key(engine.seed, start))
            n_drop = n_drop + drops
            color = _sum(c.detach().clone(), mesh,
                         "samples").requires_grad_(True)
            err = (color * inv_s - tgt[at]) ** 2
            if wgt is not None:
                err = err * wgt[at][:, None]
            # normalized here so loss AND grads share the same scale
            part = torch.sum(torch.where(valid[:, None], err, 0.0)) \
                / (n_pix * 3)
            if frame is not None:
                frame[pix[valid]] = color.detach()[valid]
        with spans.span("grad.backward"):
            if ev:
                ev[1].record()
            (g,) = torch.autograd.grad(part, color)
            # the frame's prep is every chunk's: keep its graph until the
            # last chunk
            got = (torch.autograd.grad(c, flat, grad_outputs=g,
                                       allow_unused=True,
                                       retain_graph=start != starts[-1])
                   if c.requires_grad else [None] * len(flat))
            got = torch.cat([(torch.zeros_like(p) if q is None else q)
                             .reshape(-1) for p, q in zip(flat, got)])
            del c, g, color, err
            if ev:
                ev[2].record()
        loss = part.detach() if loss is None else loss + part.detach()
        grads = got if grads is None else grads + got
        events.append(ev)

    with spans.span("grad.reduce"):
        grads = _sum(grads, mesh, "world")
        loss = _sum(loss, mesh, "rays")
        n_drop = int(_sum(n_drop, mesh, "world"))
        if frame is not None:
            frame = torch.clamp(_sum(frame, mesh, "rays") * inv_s, max=1.0)
    out, off = {}, 0
    for grp, leaves in params.items():
        out[grp] = {}
        for k, p in leaves.items():
            out[grp][k] = grads[off:off + p.numel()].reshape(p.shape)
            off += p.numel()

    dropped["rays"] += n_drop
    grad_stats["calls"] += 1
    grad_stats["chunks"] += len(starts)
    grad_stats["cells"] += len(starts) * int(np.sum(cell_valid))
    # the events completed before the drop count reached the host
    for ev in events:
        if ev:
            grad_stats["forward_ms"] += ev[0].elapsed_time(ev[1])
            grad_stats["backward_ms"] += ev[1].elapsed_time(ev[2])
    if return_color:
        return loss, out, frame
    return loss, out
