"""The XLA cluster walk: the port's ``select_closest_clusters`` and
``recompute_t`` against the JAX package's, and the walks' defaults.

Both packages get the same numpy inputs (the JAX package's triangle
constants and world cluster boxes) on the camera and random ray batches of
tests/test_accel.py.  Thresholds of tests/test_accel.py: found masks at
least 99.9% equal (all are expected) and t at rtol=1e-4, atol=1e-5; the
winners must be equal where both found one.  The cases cover the
single-round branch (``gather`` ≥ C), blocks that stop at different rounds
(a small ``gather`` with ``t_max`` = 4), and dead and padded rays.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustray_tpu.models.procedural import bench_scene
from rustray_tpu.ops import cluster_trace as j_ct
from rustray_tpu.ops import octet_trace as j_ot
from rustray_tpu.ops import traverse as j_trav
from rustray_tpu.ops.intersect import prepare_triangles
from test_torch_block_trace import _batches
from rustray_tpu_torch import to_torch
from rustray_tpu_torch.ops import cluster_trace as ct
from rustray_tpu_torch.ops import octet_trace as ot
from rustray_tpu_torch.ops import traverse as trav
from rustray_tpu_torch.ops.block_trace import DEAD_ORIGIN
from rustray_tpu_torch.ops.intersect import TrianglePrep

torch.set_num_threads(1)

BLOCK = 256


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def walk():
    scene = bench_scene(grid=2, lat=10, lon=14, width=96, height=64,
                        monte_carlo=False, samples=1)
    sa, static = scene.compile()
    prep = prepare_triangles(sa)
    w_lo, w_hi = j_ct.world_cluster_aabbs(sa)
    tri_ok = np.asarray(sa.tri_valid & sa.inst_visible[sa.tri_inst])
    cl_ok = np.asarray(sa.cl_valid & sa.inst_visible[sa.cl_inst])
    prep_t = TrianglePrep(**{f: _t(getattr(prep, f)) for f in (
        "a", "n", "an", "g1", "c1", "g2", "c2", "flat_n", "backface_sign")})
    return dict(sa=sa, static=static, prep=prep, prep_t=prep_t,
                boxes=(np.asarray(w_lo), np.asarray(w_hi)), tri_ok=tri_ok,
                cl_ok=cl_ok, C=int(np.asarray(w_lo).shape[0]))


def _both(walk, o, d, gather, t_max=None):
    """The JAX and the port's select_closest_clusters on the same numpy
    rays; returns ((found, idx, t) numpy) for each."""
    K = walk["static"].cluster_size
    w_lo, w_hi = walk["boxes"]
    j = j_ct.select_closest_clusters(
        jnp.asarray(o), jnp.asarray(d), walk["prep"],
        jnp.asarray(walk["tri_ok"]), jnp.asarray(w_lo), jnp.asarray(w_hi),
        jnp.asarray(walk["cl_ok"]), K, block=BLOCK, gather=gather,
        t_max=None if t_max is None else jnp.asarray(t_max))
    p = ct.select_closest_clusters(
        _t(o), _t(d), walk["prep_t"], _t(walk["tri_ok"]), _t(w_lo),
        _t(w_hi), _t(walk["cl_ok"]), K, block=BLOCK, gather=gather,
        t_max=None if t_max is None else _t(t_max))
    return [np.asarray(x) for x in j], [x.numpy() for x in p]


@pytest.mark.parametrize("case", ["single_round", "rounds_tmax",
                                  "dead_padded"])
def test_select_closest_clusters_matches_jax(walk, case):
    n = 1000 if case == "dead_padded" else 1024   # 1000: a padded block
    gather = {"single_round": 4 * walk["C"], "rounds_tmax": 2,
              "dead_padded": 8}[case]
    assert (gather >= walk["C"]) == (case == "single_round")
    for name, o, d, alive in _batches(walk["sa"], n):
        t_max = np.full((n,), 4.0, np.float32) if case == "rounds_tmax" \
            else None
        if case == "dead_padded":
            # dead rays as _sorted_mesh_trace masks them
            o = np.where(alive[:, None], o, np.float32(DEAD_ORIGIN))
            d = np.where(alive[:, None], d, np.float32(1.0))
        (f_j, i_j, t_j), (f_p, i_p, t_p) = _both(walk, o, d, gather, t_max)
        assert (f_p == f_j).mean() >= 0.999, (case, name)
        both = f_p & f_j
        assert both.any(), (case, name)
        np.testing.assert_array_equal(i_p[both], i_j[both], err_msg=name)
        np.testing.assert_allclose(t_p[both], t_j[both], rtol=1e-4,
                                   atol=1e-5, err_msg=name)
        if case == "dead_padded":
            assert not f_p[~alive].any() and not f_j[~alive].any()
        if t_max is not None:
            assert (t_p[f_p] <= 4.0).all()


def test_rounds_stop_per_block(walk, monkeypatch):
    """With a small gather and t_max = 4 the blocks of one call (the
    random rays) stop at different rounds, and a block whose loop condition
    failed gets no further round."""
    rounds = []
    real = ct._intersect_gathered

    def counting(o, *args):
        rounds.append(o.shape[0])
        return real(o, *args)

    monkeypatch.setattr(ct, "_intersect_gathered", counting)
    _, o, d, _ = _batches(walk["sa"], 1024)[1]
    _both(walk, o, d, 2, np.full((1024,), 4.0, np.float32))
    # blocks taking part in each round: never more than the round before,
    # and fewer than all blocks before the last round
    assert rounds == sorted(rounds, reverse=True)
    assert rounds[0] == 1024 // BLOCK and rounds[-1] < rounds[0]
    assert len(rounds) < -(-walk["C"] // 2)


def test_recompute_t_matches_jax(walk):
    _, o, d, _ = _batches(walk["sa"], 512)[0]
    (f_j, i_j, _), _ = _both(walk, o, d, 8)
    ref = j_ct.recompute_t(jnp.asarray(o), jnp.asarray(d), walk["prep"],
                           jnp.asarray(i_j), jnp.asarray(f_j))
    got = ct.recompute_t(_t(o), _t(d), walk["prep_t"], _t(i_j), _t(f_j))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_world_boxes_match_jax(walk):
    sa_t, _ = to_torch(walk["sa"], walk["static"], "cpu")
    for got, ref in zip(ct.world_cluster_aabbs(sa_t), walk["boxes"]):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_pallas_algo_defaults_to_octet(walk, monkeypatch):
    """A direct trace_closest caller that passes accel_boxes and the kernel
    path but no pallas_algo reaches trace_tris_octets, in both packages;
    the two packages' defaults agree."""
    for fn in ("trace_closest", "_sorted_mesh_trace"):
        j_def = inspect.signature(getattr(j_trav, fn)).parameters
        p_def = inspect.signature(getattr(trav, fn)).parameters
        assert p_def["pallas_algo"].default == \
            j_def["pallas_algo"].default == "octet", fn
    calls = []

    def stub(zeros):
        def trace_tris_octets(o, *args, **kw):
            calls.append(kw["mode"])
            n = o.shape[0]
            return zeros(n)
        return trace_tris_octets

    monkeypatch.setattr(j_ot, "trace_tris_octets", stub(lambda n: (
        jnp.zeros((n,), bool), jnp.zeros((n,), jnp.int32),
        jnp.full((n,), 3.0e38, jnp.float32))))
    monkeypatch.setattr(ot, "trace_tris_octets", stub(lambda n: (
        torch.zeros((n,), dtype=torch.bool),
        torch.zeros((n,), dtype=torch.int32), torch.full((n,), 3.0e38))))
    sa, static = walk["sa"], walk["static"]
    sa_t, _ = to_torch(sa, static, "cpu")
    _, o, d, _ = _batches(sa, 64)[0]
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    boxes = walk["boxes"]
    j_trav.trace_closest(sa, static, walk["prep"], jnp.asarray(o),
                         jnp.asarray(d), False, False,
                         accel_boxes=tuple(jnp.asarray(b) for b in boxes),
                         accel_impl="pallas")
    trav.trace_closest(sa_t, static, walk["prep_t"], _t(o), _t(d), False,
                       False, accel_boxes=tuple(_t(b) for b in boxes),
                       accel_impl="pallas")
    assert calls == ["closest", "closest"]
