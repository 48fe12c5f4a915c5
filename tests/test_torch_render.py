"""The slice end to end: the port's render() against the JAX package's.

Both render the same compiled scene at 96x64 on the CPU.  The JAX package
renders with the dense scan; the port renders with the dense scan, through
the block walk's torch twin (accel and pallas on, ``pallas_interpret=True``)
and through the XLA cluster walk (accel on, pallas off), the last held
against the JAX package's render with the same engine.  Thresholds of
tests/test_accel.py: color within rtol=2e-3, atol=2e-3 on at least 99.5% of
pixels and object ids equal on at least 99.5%; on the dense path and the
XLA walk the device-ray counts are equal.  The default engine renders a
mesh scene of 2,048 triangles or more on CPU tensors through the XLA walk.
"""
import numpy as np
import pytest
import torch

from rustray_tpu.config import EngineConfig as JaxEngineConfig
from rustray_tpu.models.procedural import bench_scene, demo_spheres_scene
from rustray_tpu.render.wavefront import render as jax_render
from rustray_tpu_torch import EngineConfig, render, to_torch

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core oversubscribes them
torch.set_num_threads(1)

DENSE = dict(accel="off", pallas="off", chunk_pixels=4096)
TWIN = dict(accel="on", pallas="on", pallas_interpret=True,
            chunk_pixels=4096)
XLA = dict(accel="on", pallas="off", accel_block=256, accel_gather=8,
           chunk_pixels=4096)
ENGINES = {"dense": DENSE, "twin": TWIN, "xla": XLA}
SCENES = {
    "bench": lambda: bench_scene(grid=2, lat=10, lon=14, width=96,
                                 height=64, monte_carlo=False, samples=1),
    "demo_spheres": lambda: demo_spheres_scene(96, 64),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def reference(request):
    scene = SCENES[request.param]()
    sa, static = scene.compile()
    cfg = scene.raytracing_config
    ref = jax_render(sa, static, cfg, JaxEngineConfig(**DENSE))
    sa_t, static_t = to_torch(sa, static, "cpu")
    return sa_t, static_t, cfg, ref, (sa, static)


def assert_render_close(out, ref):
    frac = np.isclose(out["color"], ref["color"], rtol=2e-3,
                      atol=2e-3).mean()
    assert frac >= 0.995, frac
    assert (out["object_id"] == ref["object_id"]).mean() >= 0.995
    assert out["image"].shape == ref["image"].shape
    assert np.isfinite(out["depth"]).all() and np.isfinite(
        out["normal"]).all()


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_render_matches_jax(reference, engine):
    sa, static, cfg, ref, compiled = reference
    out = render(sa, static, cfg, EngineConfig(**ENGINES[engine]))
    if engine == "xla" and EngineConfig(**XLA).use_accel(static):
        # the JAX package's render through its own XLA cluster walk (on a
        # scene without clusters both engines are the dense scan)
        ref = jax_render(*compiled, cfg, JaxEngineConfig(**XLA))
    assert_render_close(out, ref)
    assert out["dropped_rays"] == 0
    if engine != "twin":
        assert out["device_rays"] == ref["device_rays"]


def test_default_engine_renders_mesh_scene_on_cpu(monkeypatch):
    """The default EngineConfig on CPU tensors selects the cluster walk for
    a mesh scene of 2,048 triangles or more and runs the XLA walk (no
    kernel, no twin), matching the dense scan."""
    from rustray_tpu_torch.models.procedural import bench_scene as t_bench
    from rustray_tpu_torch.ops import cluster_trace
    scene = t_bench(grid=3, lat=10, lon=14, width=32, height=24,
                    monte_carlo=False, samples=1)
    scene.raytracing_config.max_recursion = 1
    sa, static = to_torch(*scene.compile(), "cpu")
    cfg = scene.raytracing_config
    assert static.n_tris >= 2048
    assert EngineConfig().use_accel(static)
    assert not EngineConfig().use_pallas(static, "cpu")
    calls = []
    real = cluster_trace.select_closest_clusters

    def counting(*args, **kw):
        calls.append(args[0].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(cluster_trace, "select_closest_clusters", counting)
    out = render(sa, static, cfg, EngineConfig())
    assert calls
    dense = render(sa, static, cfg, EngineConfig(**DENSE))
    assert_render_close(out, dense)
    assert out["device_rays"] == dense["device_rays"]
    assert out["dropped_rays"] == 0


def test_block_walk_mesh_hits_defer_instance(reference):
    """Block-walk mesh hits carry Hit.inst == -1; hit_attributes resolves
    the owner instance from shade_pack."""
    from rustray_tpu_torch.ops.traverse import hit_attributes, trace_closest
    from rustray_tpu_torch.render.wavefront import prepare_frame
    sa, static, cfg, _, _ = reference
    if not static.has_mesh:
        pytest.skip("scene without meshes")
    prep, boxes = prepare_frame(sa, static, EngineConfig(**TWIN))
    from rustray_tpu_torch.ops import rays
    n = 64 * 96
    idx = torch.arange(n)
    o, d = rays.primary_rays(sa.camera, 96, 64, (idx % 96).int(),
                             (idx // 96).int(), 0, 0, 1, 1.0, 1.0, 1)
    d = d / d.norm(dim=1, keepdim=True)
    hit = trace_closest(sa, static, prep, o, d, False, False,
                        accel_boxes=boxes, accel_impl="pallas",
                        block_n=128, pallas_algo="block")
    mesh = hit.hit & hit.is_mesh
    assert mesh.any() and (hit.inst[mesh] == -1).all()
    attrs = hit_attributes(sa, static, prep, o, d, hit)
    owner = sa.inst_obj_id[sa.tri_inst[hit.tri.long()].long()]
    assert (attrs.obj_id[mesh] == owner[mesh]).all()
