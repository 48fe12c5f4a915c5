"""The port's octet kernel bench (K4) and wavefront capture tools.

Each variant's torch twin (``rustray_tpu_torch.tools.octet_kernel_bench.
_bench_twin``, what ``bench_kernel`` runs on CPU tensors) is held against
the JAX bench kernel, built here from ``tools/octet_kernel_bench.
make_kernel`` with ``build``'s grid spec and run in interpret mode, on 64
rays (8 octets, 6 of them live).  Thresholds of tests/test_accel.py: found
masks at least 99.9% equal and t allclose at rtol=1e-4, atol=1e-5; the
winning triangle index must match too.  The CUDA kernel is held against
the twin by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from test_torch_block_trace import _batches, _t, accel  # noqa: F401
from tools import octet_kernel_bench as j_okb
from rustray_tpu_torch import to_torch
from rustray_tpu_torch.ops.intersect import INF
from rustray_tpu_torch.tools import octet_kernel_bench as okb

torch.set_num_threads(1)

N_RAYS = 64
N_LIVE = 6


def _j_aabb_table(w_lo, w_hi, cl_ok):
    """tools/octet_kernel_bench.py's inlined build_cluster_aabb_table."""
    C = w_lo.shape[0]
    cpad = -(-C // 128) * 128
    lo = jnp.where(cl_ok[:, None], w_lo, jnp.float32(j_okb._BIG))
    hi = jnp.where(cl_ok[:, None], w_hi, jnp.float32(-j_okb._BIG))
    tab = jnp.concatenate([lo.T, hi.T, jnp.zeros((2, C))], axis=0)
    return jnp.pad(tab, ((0, 0), (0, cpad - C)),
                   constant_values=j_okb._BIG)[:, :cpad].at[3:6, C:].set(
                       -j_okb._BIG)


def _j_call(no, n_rows, cpad, K, variant):
    """``build``'s pallas_call (tools/octet_kernel_bench.py:142-159) in
    interpret mode."""
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(no,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
        out_specs=[pl.BlockSpec((n_rows, 1), lambda r, c: (0, 0))] * 2,
        scratch_shapes=[
            pltpu.VMEM((1, cpad), jnp.float32),
            pltpu.VMEM((8, 1), jnp.float32),
            pltpu.VMEM((8, 1), jnp.int32),
            pltpu.SMEM((1, 1), jnp.int32),
            pltpu.SMEM((1, 1), jnp.int32),
        ])
    return pl.pallas_call(
        j_okb.make_kernel(cpad, K, variant), grid_spec=grid_spec,
        out_shape=[jax.ShapeDtypeStruct((n_rows, 1), jnp.float32),
                   jax.ShapeDtypeStruct((n_rows, 1), jnp.int32)],
        interpret=True)


@pytest.fixture(scope="module")
def inputs(accel):  # noqa: F811
    """Camera rays, except octets 4 and 5: random directions from the
    centre of cluster 0's box, so that their entry row's argmin is a real
    cluster (the bench's padded and disabled clusters enter at 0 too)."""
    _, o, d, _ = _batches(accel["sa"], N_RAYS)[0]
    rnd = _batches(accel["sa"], N_RAYS)[1][2]
    centre = (np.asarray(accel["w_lo"])[0] + np.asarray(accel["w_hi"])[0]) / 2
    o, d = o.copy(), d.copy()
    o[32:48] = centre
    d[32:48] = rnd[32:48]
    tmax = np.where(np.arange(N_RAYS) < N_LIVE * 8 - 3, 3e38,
                    -1.0).astype(np.float32)
    rays = np.concatenate([o, d, tmax[:, None],
                           np.zeros((N_RAYS, 1), np.float32)], axis=1)
    aabb = okb.aabb_table(*accel["boxes_t"], _t(accel["cl_ok"]))
    return dict(rays=rays.astype(np.float32), aabb=aabb,
                nlive=np.array([N_LIVE], np.int32))


def test_aabb_table_matches_jax(accel, inputs):  # noqa: F811
    ref = _j_aabb_table(accel["w_lo"], accel["w_hi"],
                        jnp.asarray(accel["cl_ok"]))
    np.testing.assert_array_equal(inputs["aabb"].numpy(), np.asarray(ref))


@pytest.mark.parametrize("variant", okb.VARIANTS)
def test_bench_twin_matches_jax_kernel(accel, inputs, variant):  # noqa: F811
    pack_t = accel["prep_t"].pallas_pack
    assert pack_t.shape[0] >= 16      # v2-v4 read clusters 0..15
    cpad, K = inputs["aabb"].shape[1], pack_t.shape[2]
    t_j, i_j = _j_call(N_RAYS // 8, N_RAYS, cpad, K, variant)(
        jnp.asarray(inputs["nlive"]), jnp.asarray(inputs["rays"]),
        jnp.asarray(inputs["aabb"].numpy()), accel["prep"].pallas_pack)
    t_j, i_j = np.asarray(t_j)[:, 0], np.asarray(i_j)[:, 0]
    okb.reset_launches()
    t_p, i_p = okb.bench_kernel(_t(inputs["nlive"]), _t(inputs["rays"]),
                                inputs["aabb"], pack_t, variant)
    assert okb.launches[variant] == 0          # the twin launches nothing
    t_p, i_p = t_p.numpy(), i_p.numpy()
    f_j, f_p = t_j < 3e38, t_p < INF
    assert (f_j == f_p).mean() >= 0.999, variant
    both = f_j & f_p
    np.testing.assert_allclose(t_p[both], t_j[both], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(i_p[both], i_j[both])
    assert not f_p[N_LIVE * 8:].any() and (i_p[N_LIVE * 8:] == 0).all()
    if variant == "v1":
        assert not f_p.any()
    else:
        assert f_p.any(), variant


def test_bench_refuses_other_devices(accel, inputs):  # noqa: F811
    """No silent fallback: a tensor on neither the CPU nor CUDA raises."""
    with pytest.raises(ValueError, match="no kernel"):
        okb.bench_kernel(_t(inputs["nlive"]).to("meta"),
                         _t(inputs["rays"]).to("meta"),
                         inputs["aabb"].to("meta"),
                         accel["prep_t"].pallas_pack.to("meta"), "v2")


def test_capture_and_bench_inputs():
    """The capture tool on a small frame (twin engine): one closest and
    one shadow batch per traced level, under the JAX tool's keys; the
    level-3 closest wavefront then makes bench inputs the twin runs."""
    from rustray_tpu_torch import EngineConfig, to_torch
    from rustray_tpu_torch.models.procedural import bench_scene
    from rustray_tpu_torch.render.wavefront import prepare_frame
    from rustray_tpu_torch.tools.capture_waves import capture
    scene = bench_scene(grid=2, lat=10, lon=14, width=96, height=64,
                        monte_carlo=False, samples=1)
    sa, static = to_torch(*scene.compile(), "cpu")
    cfg = scene.raytracing_config
    engine = EngineConfig(queue_factor=1.0, chunk_pixels=2048, pallas="on",
                          pallas_interpret=True)
    waves = capture(sa, static, cfg, engine, chunk=2048, start_chunk=1)
    assert waves["closest_1_o"].shape == (2048, 3)
    assert waves["closest_1_alive"].all()
    L = static.n_lights
    assert waves["shadow_1_o"].shape == (L * 2048, 3)
    assert waves["closest_3_o"].shape == (2048, 3)
    for key, x in waves.items():
        assert np.isfinite(x).all() or key.endswith("_tmax"), key
    _, boxes = prepare_frame(sa, static, engine)
    nlive, rays, aabb = okb.bench_inputs(waves, sa, boxes)
    alive = waves["closest_3_alive"]
    assert int(nlive[0]) >= -(-int(alive.sum()) // 8)
    assert rays.shape == (2048, 8) and aabb.shape[0] == 8
    pack = prepare_frame(sa, static, engine)[0].pallas_pack
    t, _ = okb.bench_kernel(nlive, rays, aabb, pack, "v4")
    assert (t[int(nlive[0]) * 8:] >= INF).all()


def test_probe_inputs_hit_in_every_variant(accel):  # noqa: F811
    """The probe rays chip_smoke.py checks the kernels on: every variant
    but v1 finds hits, v4 through argmin clusters."""
    sa = to_torch(accel["sa"], accel["static"], "cpu")[0]
    nlive, rays, aabb = okb.probe_inputs(sa, accel["boxes_t"], 256)
    for v in okb.VARIANTS:
        t, _ = okb.bench_kernel(nlive, rays, aabb,
                                accel["prep_t"].pallas_pack, v)
        assert bool((t < INF).any()) == (v != "v1"), v
