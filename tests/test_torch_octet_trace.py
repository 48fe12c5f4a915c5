"""The octet round-trace: its host parts, its round twin and its fallback
against the JAX package.

``octet_entries`` and the round twin (``rustray_tpu_torch.ops.octet_trace.
_round_twin``, the part of both rounds' twins that runs the slab tests)
are held against their JAX counterparts, the round against the Pallas
kernel in interpret mode (``_run_round(interpret=True)``) on the same
descriptors, slots 1 and 4.  A spray of rays that cross many clusters
makes octets overflow round 1, so the block-walk fallback runs; the whole
path is then held against the JAX ``trace_tris_octets(interpret=True)``
and the dense scan.  Thresholds of tests/test_accel.py: found masks at
least 99.9% equal and the selected triangle's t allclose at rtol=1e-4,
atol=1e-5.  The fused rounds are held against the JAX chain and their
kernel decomposition by tests/test_torch_octet_fused.py, the CUDA kernels
against the twins by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustray_tpu.ops import octet_trace as j_ot
from rustray_tpu.ops.block_trace import DEAD_ORIGIN
from rustray_tpu.ops.intersect import closest_tri
from test_torch_block_trace import _batches, _t, _tri_t, accel  # noqa: F401
from rustray_tpu_torch.ops import octet_trace as ot
from rustray_tpu_torch.ops.intersect import INF

torch.set_num_threads(1)


def _masked(o, d, alive, tmax):
    """Dead-ray masking as trace_tris_octets does it, in numpy."""
    o = np.where(alive[:, None], o, DEAD_ORIGIN).astype(np.float32)
    d = np.where(alive[:, None], d, 1.0).astype(np.float32)
    return o, d, np.where(alive, tmax, -1.0).astype(np.float32)


def spray(n, seed=5):
    """Rays from just above the sphere grid towards random floor points:
    each octet enters many clusters and several miss the first one, so
    more than 4 clusters survive the need filter and the fallback runs."""
    rng = np.random.default_rng(seed)
    o = (np.array([[0.0, 4.0, -7.3]]) + rng.uniform(-0.2, 0.2, (n, 3)))
    tgt = np.stack([rng.uniform(-2.3, 2.3, n), np.full(n, -1.2),
                    rng.uniform(-9.6, -5.0, n)], axis=1)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("batch", [0, 1])
def test_octet_entries_match_jax(accel, batch):  # noqa: F811
    name, o, d, alive = _batches(accel["sa"], 1024)[batch]
    o, d, tmax = _masked(o, d, alive, np.full(1024, 6.0, np.float32))
    ref = np.asarray(j_ot.octet_entries(
        o, d, tmax, accel["w_lo"], accel["w_hi"],
        jnp.asarray(accel["cl_ok"]), c_chunk=8))
    got = ot.octet_entries(_t(o), _t(d), _t(tmax), *accel["boxes_t"],
                           _t(accel["cl_ok"]), c_chunk=8).numpy()
    assert got.shape == ref.shape == (128, accel["w_lo"].shape[0])
    fin_r, fin_g = ref < 3e38, got < INF
    assert (fin_r == fin_g).mean() >= 0.999, name
    assert fin_g.any()
    both = fin_r & fin_g
    np.testing.assert_allclose(got[both], ref[both], rtol=1e-6)


@pytest.mark.parametrize("slots", [1, 4])
def test_round_twin_matches_jax_kernel(accel, slots):  # noqa: F811
    """The same descriptors through JAX _run_round (interpret) and the
    port's: round 0's argmin per octet, or the 4 nearest clusters."""
    name, o, d, alive = _batches(accel["sa"], 256)[1]
    o, d, tmax = _masked(o, d, alive, np.full(256, 3e38, np.float32))
    pack_j = accel["prep"].pallas_pack
    dummy = pack_j.shape[0] - 1
    e = np.array(j_ot.octet_entries(o, d, tmax, accel["w_lo"],
                                    accel["w_hi"],
                                    jnp.asarray(accel["cl_ok"])))
    cols = []
    for _ in range(slots):
        c = e.argmin(axis=1)
        cols.append(np.where(e.min(axis=1) < 3e38, c, dummy))
        e[np.arange(e.shape[0]), c] = 3e38
    desc = np.stack(cols, axis=1).astype(np.int32)
    assert (desc != dummy).any() and (desc == dummy).any()
    rays = np.concatenate([o, d, tmax[:, None],
                           np.zeros((256, 1), np.float32)], axis=1)
    t_j, i_j = j_ot._run_round(jnp.asarray(rays), pack_j,
                               jnp.asarray(desc), slots,
                               accel["static"].cluster_size, dummy, True)
    t_j, i_j = np.asarray(t_j), np.asarray(i_j)
    ot.reset_counts()
    t_p, i_p = ot._run_round(_t(rays), accel["prep_t"].pallas_pack,
                             _t(desc), slots, dummy)
    assert ot.launches == {1: 0, 4: 0}
    t_p, i_p = t_p.numpy(), i_p.numpy()
    assert t_p.shape == (256,)
    f_j, f_p = t_j < 3e38, t_p < INF
    assert (f_j == f_p).mean() >= 0.999
    assert f_p.any()
    both = f_j & f_p
    np.testing.assert_allclose(t_p[both], t_j[both], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(i_p[both], i_j[both])


def test_round_twin_pads_and_skips_rows():
    """A row whose flag is 0 writes INF / 0; the padded tail of the last
    row (octets past No) gets zero rays and output rows of its own."""
    pack = torch.zeros((2, 16, 4))
    rays = torch.zeros((24, 8))
    rays[:, 5] = 1.0
    rays[:, 6] = 10.0
    desc = torch.tensor([[1], [1], [1]], dtype=torch.int32)  # all dummy
    flags, r_pad, rows = ot.round_inputs(rays, desc, 1, dummy=1)
    assert flags.tolist() == [0] and rows.shape == (1, 128)
    assert r_pad.shape == (1024, 8) and not r_pad[24:].any()
    t, i = ot._round_twin(flags, r_pad, rows, pack, 1)
    assert t.shape == (1024,) and (t >= INF).all() and (i == 0).all()


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_fallback_path_matches_jax_and_dense(accel, mode):  # noqa: F811
    o, d = spray(64)
    prep = accel["prep"]
    t_d, i_d = closest_tri(o, d, prep, accel["tri_ok"], 1024)
    found_d = np.asarray(t_d) < 3e38
    f_j, i_j, _ = j_ot.trace_tris_octets(
        o, d, None, None, prep, accel["w_lo"], accel["w_hi"],
        jnp.asarray(accel["cl_ok"]), accel["static"].cluster_size,
        mode=mode, interpret=True)
    f_j, i_j = np.asarray(f_j), np.asarray(i_j)
    ot.reset_counts()
    f_p, i_p, t_p = ot.trace_tris_octets(
        _t(o), _t(d), None, None, accel["prep_t"], *accel["boxes_t"],
        _t(accel["cl_ok"]), accel["static"].cluster_size, mode=mode)
    f_p, i_p, t_p = f_p.numpy(), i_p.numpy(), t_p.numpy()
    assert ot.fallback["calls"] == 1 and ot.fallback["rays"] > 0
    for ref_f, ref_i in ((found_d, np.asarray(i_d)), (f_j, i_j)):
        assert (f_p == ref_f).mean() >= 0.999, mode
        both = f_p & ref_f
        np.testing.assert_allclose(_tri_t(prep, o, d, i_p)[both],
                                   _tri_t(prep, o, d, ref_i)[both],
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_p[f_p], _tri_t(prep, o, d, i_p)[f_p],
                               rtol=1e-4, atol=1e-5)


def test_round_refuses_other_devices(accel):  # noqa: F811
    """No silent fallback: a tensor on neither the CPU nor CUDA raises, in
    either round."""
    m = torch.zeros((64, 3), device="meta")
    tm = torch.zeros((64,), device="meta")
    pack = accel["prep_t"].pallas_pack.to("meta")
    boxes = [b.to("meta") for b in accel["boxes_t"]]
    cl_ok = torch.ones((boxes[0].shape[0],), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ot.round0(m, m, tm, *boxes, cl_ok, pack)
    e = torch.zeros((8, boxes[0].shape[0]), device="meta")
    c0 = torch.zeros((8,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ot.round1(m, m, tm, e, c0, tm, c0.repeat(8), pack, "closest")
