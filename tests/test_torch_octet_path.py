"""The octet path (``pallas_algo="octet"``) end to end against the JAX
package.

The port's ``trace_tris_octets`` (round twin and block-walk fallback on
CPU tensors) is held against the JAX ``trace_tris_octets(interpret=True)``
and the dense scan; then ``render()`` with ``pallas_algo="octet"`` is held
against the JAX package's dense render, and its counters show that the
engine setting reaches the octet path.  Thresholds of tests/test_accel.py:
found masks at least 99.9% equal, the selected triangle's t allclose at
rtol=1e-4, atol=1e-5; images: color within rtol=2e-3, atol=2e-3 on at
least 99.5% of pixels and object ids equal on at least 99.5%.  The JAX
octet engine itself is not rendered: tests/test_accel.py:300-305 records
that its compile destabilised test workers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustray_tpu.config import EngineConfig as JaxEngineConfig
from rustray_tpu.models.procedural import bench_scene
from rustray_tpu.ops import octet_trace as j_ot
from rustray_tpu.ops.intersect import closest_tri
from rustray_tpu.render.wavefront import render as jax_render
from test_torch_block_trace import _batches, _t, _tri_t, accel  # noqa: F401
from rustray_tpu_torch import EngineConfig, render, to_torch
from rustray_tpu_torch.ops import block_trace as bt
from rustray_tpu_torch.ops import octet_trace as ot

torch.set_num_threads(1)

N = 256   # the JAX interpret run costs about 30 s per call at this size


def _octets(acc, o, d, alive, tmax, mode):
    return ot.trace_tris_octets(
        _t(o), _t(d), _t(alive), None if tmax is None else _t(tmax),
        acc["prep_t"], *acc["boxes_t"], _t(acc["cl_ok"]),
        acc["static"].cluster_size, mode=mode)


def _j_octets(acc, o, d, alive, tmax, mode):
    f, i, _ = j_ot.trace_tris_octets(
        o, d, alive, tmax, acc["prep"], acc["w_lo"], acc["w_hi"],
        jnp.asarray(acc["cl_ok"]), acc["static"].cluster_size, mode=mode,
        interpret=True)
    return np.asarray(f), np.asarray(i)


@pytest.mark.parametrize("batch", [0, 1])
def test_octet_path_matches_jax_and_dense(accel, batch):  # noqa: F811
    name, o, d, alive = _batches(accel["sa"], N)[batch]
    prep = accel["prep"]
    t_d, i_d = closest_tri(o, d, prep, accel["tri_ok"], 1024)
    found_d = (np.asarray(t_d) < 3e38) & alive
    f_j, i_j = _j_octets(accel, o, d, alive, None, "closest")
    f_j = f_j & alive
    f_p, i_p, t_p = (x.numpy() for x in _octets(accel, o, d, alive, None,
                                                "closest"))
    f_p = f_p & alive
    assert f_p.any()
    for ref_f, ref_i in ((found_d, np.asarray(i_d)), (f_j, i_j)):
        assert (f_p == ref_f).mean() >= 0.999, name
        both = f_p & ref_f
        np.testing.assert_allclose(_tri_t(prep, o, d, i_p)[both],
                                   _tri_t(prep, o, d, ref_i)[both],
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_p[f_p], _tri_t(prep, o, d, i_p)[f_p],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_octet_path_tmax(accel, mode):  # noqa: F811
    """t_max = 4.0: occlusion booleans exact against the dense scan and
    JAX, winners within the cap; both modes return the closest hit."""
    name, o, d, alive = _batches(accel["sa"], N)[1]
    prep = accel["prep"]
    t_d, i_d = closest_tri(o, d, prep, accel["tri_ok"], 1024)
    tmax = np.full((N,), 4.0, np.float32)
    found_ref = (np.asarray(t_d) < 4.0) & alive
    f_j, i_j = _j_octets(accel, o, d, alive, tmax, mode)
    f_j = f_j & alive
    f_p, i_p, _ = (x.numpy() for x in _octets(accel, o, d, alive, tmax,
                                              mode))
    f_p = f_p & alive
    for ref in (found_ref, f_j):
        assert (f_p == ref).mean() >= 0.999, mode
    assert (_tri_t(prep, o, d, i_p)[f_p] <= 4.0 + 1e-4).all(), mode
    both = f_p & f_j
    np.testing.assert_allclose(_tri_t(prep, o, d, i_p)[both],
                               _tri_t(prep, o, d, i_j)[both],
                               rtol=1e-4, atol=1e-5)


def test_render_octet_matches_jax_dense():
    """render() with pallas_algo="octet" through the twins against the JAX
    package's dense render.  The setting reaches the octet path: its
    rounds run, and the block walk runs only as the rounds' fallback."""
    scene = bench_scene(grid=2, lat=10, lon=14, width=96, height=64,
                        monte_carlo=False, samples=1)
    sa, static = scene.compile()
    cfg = scene.raytracing_config
    ref = jax_render(sa, static, cfg, JaxEngineConfig(
        accel="off", pallas="off", chunk_pixels=4096))
    sa_t, static_t = to_torch(sa, static, "cpu")
    ot.reset_counts()
    bt.reset_launches()
    out = render(sa_t, static_t, cfg, EngineConfig(
        accel="on", pallas="on", pallas_interpret=True, pallas_algo="octet",
        chunk_pixels=4096))
    assert ot.rounds[1] > 0 and ot.rounds[4] == ot.rounds[1]
    assert sum(bt.selected.values()) == ot.fallback["calls"]
    frac = np.isclose(out["color"], ref["color"], rtol=2e-3,
                      atol=2e-3).mean()
    assert frac >= 0.995, frac
    assert (out["object_id"] == ref["object_id"]).mean() >= 0.995
    assert out["dropped_rays"] == 0
    assert np.isfinite(out["depth"]).all()


def test_pallas_algo_selects_the_walk(accel):  # noqa: F811
    """trace_closest passes pallas_algo on to the kernel path: "octet" runs
    the rounds, other values run the block walk, as in the JAX package."""
    from rustray_tpu_torch.ops.traverse import trace_closest
    from rustray_tpu_torch.render.wavefront import prepare_frame
    sa = to_torch(accel["sa"], accel["static"], "cpu")[0]
    static = accel["static"]
    prep, boxes = prepare_frame(sa, static, EngineConfig(
        accel="on", pallas="on", pallas_interpret=True))
    _, o, d, _ = _batches(accel["sa"], 64)[0]
    for algo, octet in (("octet", True), ("block", False), ("bvh", False)):
        ot.reset_counts()
        bt.reset_launches()
        hit = trace_closest(sa, static, prep, _t(o), _t(d), False, False,
                            accel_boxes=boxes, accel_impl="pallas",
                            block_n=128, pallas_algo=algo)
        assert hit.hit.any()
        assert (ot.rounds[1] == 1) == octet, algo
        assert (sum(bt.selected.values()) == 0) == octet, algo
