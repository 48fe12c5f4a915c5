"""Scene gradients of the port against the JAX package on the CPU.

- ``selected_t``: the port's autograd Function (forward and its o, d and
  pack gradients) against autograd through the port's ``recompute_t`` and
  against the JAX package's custom VJP, on the rays of
  tests/test_accel.py and the port's XLA-walk winners.
- Every traversal path gives the dense scan's gradient: the XLA walk, the
  block walk's twin and the octet twin on the bench mini-scene (the walks
  are selection only; the hit distance's gradient comes from
  ``selected_t``).
- ``render_loss_and_grad`` on a 1 × 1 mesh against the JAX package's:
  demo spheres (dense scan) and the bench mini-scene through the XLA walk
  with Monte-Carlo jitter at 2 spp, loss at rtol 1e-5, every gradient leaf
  at rtol 1e-4 / atol 1e-6 (a leaf no gradient reaches is zeros in both).
  One exception: the demo frame's camera gradient is ill-conditioned (two
  silhouette pixels change their gradient up to twentyfold when their ray
  moves by one ulp), and the JAX package's compiled program rounds the
  sensor coordinates of an offset sample cell one ulp differently when the
  pixel coordinates are traced inputs, as they are in its
  ``render_loss_and_grad``.  With the pixels as constants JAX rounds them
  as the port does, so the demo case's camera leaves are held against
  ``jax.value_and_grad`` of the same loss with the pixels as constants.
- Twins of tests/test_sharding.py: finite and nonzero gradients, central
  differences on ``reflectivity[0]``, and a halved ``base_color`` changes
  the render.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustray_tpu.config import EngineConfig as JaxEngineConfig
from rustray_tpu.models.procedural import bench_scene, demo_spheres_scene
from rustray_tpu.ops import cluster_trace as j_ct
from rustray_tpu.ops import traverse as j_trav
from rustray_tpu.ops.intersect import prepare_triangles as j_prepare
from rustray_tpu.parallel import shard as j_shard
from rustray_tpu.render.wavefront import build_chunk_fn as j_build_chunk_fn
from rustray_tpu.render.wavefront import frame_levels as j_frame_levels
from test_torch_block_trace import _batches
from rustray_tpu_torch import EngineConfig, render, to_torch
from rustray_tpu_torch.ops import cluster_trace as ct
from rustray_tpu_torch.ops import traverse as trav
from rustray_tpu_torch.parallel import shard
from rustray_tpu_torch.render.wavefront import prepare_frame

torch.set_num_threads(1)

XLA = dict(accel="on", pallas="off", accel_block=256, accel_gather=8)
ENGINES = {
    "dense": dict(accel="off", pallas="off"),
    "xla": XLA,
    "block_twin": dict(accel="on", pallas="on", pallas_interpret=True,
                       pallas_algo="block"),
    "octet_twin": dict(accel="on", pallas="on", pallas_interpret=True,
                       pallas_algo="octet"),
}


def _demo():
    scene = demo_spheres_scene(16, 12)
    scene.raytracing_config.max_recursion = 2
    scene.raytracing_config.samples = 2
    return scene


def _bench_mc():
    scene = bench_scene(grid=2, lat=10, lon=14, width=32, height=24,
                        monte_carlo=True, samples=2)
    scene.raytracing_config.max_recursion = 2
    return scene


# case → (scene, engine settings, camera leaves against the plain grad)
CASES = {"demo_spheres": (_demo, dict(queue_factor=8.0), True),
         "bench_xla_mc": (_bench_mc, XLA, False)}


def _leaves(grads):
    return {(g, k): v for g, d in grads.items() for k, v in d.items()}


def _jax_plain_grads(sa, static, cfg, target, engine):
    """jax.value_and_grad of render_loss_and_grad's loss on one device,
    without shard_map, with the pixels and sample cells as constants."""
    px, py, valid, _ = j_shard._pad_pixels(static, 1)
    cells, cell_idx, cell_valid = j_shard._pad_cells(cfg, engine, 1)
    chunk_fn = j_build_chunk_fn(static, cfg, engine, j_frame_levels(sa, cfg))
    tgt = jnp.asarray(np.asarray(target, np.float32).reshape(-1, 3))
    n_pix = static.width * static.height

    def loss(params, sa):
        sa2 = j_shard.apply_diff_params(sa, params)
        c = chunk_fn(sa2, j_prepare(sa2), j_trav.prepare_vertex_normals(sa2),
                     jnp.asarray(px), jnp.asarray(py), jnp.asarray(valid),
                     jnp.asarray(cells), jnp.asarray(cell_idx),
                     jnp.asarray(cell_valid),
                     jax.random.PRNGKey(engine.seed))[0]
        err = (c * (1.0 / cfg.samples) - tgt) ** 2
        return jnp.sum(jnp.where(jnp.asarray(valid)[:, None], err, 0.0)) \
            / (n_pix * 3)

    return jax.jit(jax.value_and_grad(loss))(j_shard.extract_diff_params(sa),
                                             sa)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    build, eng, plain_camera = CASES[request.param]
    scene = build()
    sa, static = scene.compile()
    cfg = scene.raytracing_config
    target = np.zeros((static.height, static.width, 3), np.float32)
    j_eng = JaxEngineConfig(**eng)
    loss, grads = j_shard.render_loss_and_grad(
        sa, static, cfg, target, j_eng, j_shard.make_mesh(jax.devices()[:1]))
    ref = {k: np.asarray(v) for k, v in _leaves(grads).items()}
    if plain_camera:
        _, plain = _jax_plain_grads(sa, static, cfg, target, j_eng)
        ref.update({("camera", k): np.asarray(v)
                    for k, v in plain["camera"].items()})
    sa_t, static_t = to_torch(sa, static, "cpu")
    return dict(sa=sa_t, static=static_t, cfg=cfg, target=target,
                engine=EngineConfig(**eng), loss=float(loss), ref=ref)


def test_selected_t_matches_recompute_t_and_jax():
    """Forward: the walk's own t; backward: the gradients of autograd
    through recompute_t and of the JAX package's custom VJP (o, d, and
    the pack through its scatter-add)."""
    scene = bench_scene(grid=2, lat=10, lon=14, width=96, height=64,
                        monte_carlo=False, samples=1)
    sa, static = scene.compile()
    sa_t, static_t = to_torch(sa, static, "cpu")
    prep, (w_lo, w_hi) = prepare_frame(sa_t, static_t, EngineConfig(**XLA))
    j_prep = j_trav.build_shade_packs(sa, j_prepare(sa),
                                      j_trav.prepare_vertex_normals(sa))
    tri_ok = sa_t.tri_valid & sa_t.inst_visible[sa_t.tri_inst.long()]
    cl_ok = sa_t.cl_valid & sa_t.inst_visible[sa_t.cl_inst.long()]
    for name, o_np, d_np, _ in _batches(sa, 512):
        o, d = torch.tensor(o_np), torch.tensor(d_np)
        found, tri_idx, t_sel = ct.select_closest_clusters(
            o, d, prep, tri_ok, w_lo, w_hi, cl_ok, static.cluster_size,
            block=256, gather=8)
        assert found.any(), name
        w = torch.linspace(0.5, 1.5, o.shape[0])

        def weighted(t):
            return torch.sum(torch.where(found, t, 0.0) * w)

        o1, d1 = o.clone().requires_grad_(True), d.clone().requires_grad_(True)
        pack = prep.shade_pack.clone().requires_grad_(True)
        t_fast = trav.selected_t(o1, d1, pack, tri_idx, found, t_sel)
        assert torch.equal(t_fast, torch.where(found, t_sel, ct.INF))
        g_fast = torch.autograd.grad(weighted(t_fast), (o1, d1, pack))

        o2, d2 = o.clone().requires_grad_(True), d.clone().requires_grad_(True)
        t_ref = ct.recompute_t(o2, d2, prep, tri_idx, found)
        torch.testing.assert_close(t_fast[found], t_ref[found], rtol=1e-4,
                                   atol=1e-5)
        g_ref = torch.autograd.grad(weighted(t_ref), (o2, d2))

        def j_weighted(o, d, pack):
            t = j_trav.selected_t(o, d, pack, jnp.asarray(tri_idx.numpy()),
                                  jnp.asarray(found.numpy()),
                                  jnp.asarray(t_sel.numpy()))
            return jnp.sum(jnp.where(jnp.asarray(found.numpy()), t, 0.0)
                           * jnp.asarray(w.numpy()))

        g_jax = jax.grad(j_weighted, argnums=(0, 1, 2))(
            jnp.asarray(o_np), jnp.asarray(d_np), j_prep.shade_pack)
        for a, b, c in zip(g_fast, g_ref + (None,), g_jax):
            np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-4,
                                       atol=1e-6, err_msg=name)
            if b is not None:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                           atol=1e-6, err_msg=name)


def test_every_walk_gives_the_dense_gradient():
    """The hit distance's gradient on the XLA walk and the twins equals the
    dense scan's (before selected_t had a backward, the XLA walk lost it
    and the twins kept it only through their own arithmetic)."""
    from rustray_tpu_torch.models.procedural import bench_scene as t_bench
    scene = t_bench(grid=2, lat=10, lon=14, width=32, height=24,
                    monte_carlo=False, samples=1)
    sa, static = to_torch(*scene.compile(), "cpu")
    cfg = scene.raytracing_config
    target = np.zeros((static.height, static.width, 3), np.float32)
    grads = {}
    for name, eng in ENGINES.items():
        loss, g = shard.render_loss_and_grad(sa, static, cfg, target,
                                             EngineConfig(**eng))
        grads[name] = (float(loss), g)
    loss_d, dense = grads["dense"]
    assert dense["camera"]["view_inv"].abs().max() > 0
    for name, (loss, g) in grads.items():
        assert loss == pytest.approx(loss_d, rel=1e-6), name
        for grp, field in (("camera", "view_inv"), ("lights", "pos")):
            np.testing.assert_allclose(g[grp][field].numpy(),
                                       dense[grp][field].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{name} {field}")


def test_loss_and_grads_match_jax(case):
    loss, grads = shard.render_loss_and_grad(
        case["sa"], case["static"], case["cfg"], case["target"],
        case["engine"])
    assert float(loss) == pytest.approx(case["loss"], rel=1e-5)
    got = _leaves(grads)
    assert set(got) == set(case["ref"])
    for key, ref in case["ref"].items():
        np.testing.assert_allclose(got[key].numpy(), ref, rtol=1e-4,
                                   atol=1e-6, err_msg=str(key))
    assert not got[("lights", "max_angle")].any()


def test_gradients_finite_and_nonzero(case):
    loss, grads = shard.render_loss_and_grad(
        case["sa"], case["static"], case["cfg"], case["target"],
        case["engine"])
    assert np.isfinite(float(loss)) and float(loss) > 0.0
    assert all(torch.isfinite(g).all() for g in _leaves(grads).values())
    assert grads["materials"]["base_color"].abs().max() > 0.0


def test_gradient_matches_finite_difference(case):
    sa, static, cfg = case["sa"], case["static"], case["cfg"]
    _, grads = shard.render_loss_and_grad(sa, static, cfg, case["target"],
                                          case["engine"])
    g = float(grads["materials"]["reflectivity"][0])
    eps = 1e-3

    def loss_at(delta):
        refl = sa.materials.reflectivity.clone()
        refl[0] += delta
        sa2 = dataclasses.replace(sa, materials=dataclasses.replace(
            sa.materials, reflectivity=refl))
        loss, _ = shard.render_loss_and_grad(sa2, static, cfg,
                                             case["target"], case["engine"])
        return float(loss)

    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    assert np.isclose(g, fd, rtol=5e-2, atol=1e-4), (g, fd)


def test_param_update_changes_render(case):
    sa, static, cfg = case["sa"], case["static"], case["cfg"]
    params = shard.extract_diff_params(sa)
    params["materials"]["base_color"] = params["materials"]["base_color"] * 0.5
    sa2 = shard.apply_diff_params(sa, params)
    a = render(sa, static, cfg, case["engine"])
    b = render(sa2, static, cfg, case["engine"])
    assert np.abs(a["color"] - b["color"]).max() > 1e-3
