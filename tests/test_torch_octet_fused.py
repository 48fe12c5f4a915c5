"""The fused octet rounds: their twins against the JAX chain, and the
kernels' decomposition against the twins bit for bit.

``round0`` / ``round1`` take the selection into the round kernels
(``csrc/octet_trace.cu``).  Their twins are the JAX design's chain in
torch (``octet_entries`` -> ``round0_desc`` -> ``_round_twin``, and
``round1_desc`` -> ``_round_twin`` -> merge).  Here:

- the twins are held against the JAX chain on the same numpy rays:
  ``octet_entries`` + ``argmin`` + ``_run_round(interpret=True)`` + the
  need filter and four argmin passes, at the thresholds of
  tests/test_accel.py (found masks at least 99.9% equal, t allclose at
  rtol=1e-4, atol=1e-5, winners equal where both hit);
- ``_round0_lanes`` / ``_round1_lanes``, the kernels' partition in torch
  (lanes striding clusters, per-lane minima and top 4s, shuffle
  butterflies, lanes over a slab's triangles, slot folding), are held bit
  for bit against the twins: on the test scene, on a copy with every
  cluster five times over and triangles repeated within each slab (equal
  entries, equal t within a lane, across lanes and across slots), and
  on built entry matrices with ties, rows of INF, fewer than 4
  candidates, dead octets and ``remaining`` around 4, in both modes.

The CUDA kernels are held against the twins exactly by
tests/test_torch_cuda.py and chip_smoke.py on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustray_tpu.ops import octet_trace as j_ot
from test_torch_block_trace import _batches, _t, accel  # noqa: F401
from test_torch_octet_trace import _masked, spray
from rustray_tpu_torch.ops import octet_trace as ot
from rustray_tpu_torch.ops.intersect import INF

torch.set_num_threads(1)

N = 256
COPIES = 5


def _same(got, want):
    """Bit for bit: equal tensors of equal dtype (t compared as values,
    where -0.0 equals 0.0, as the tie rules compare them)."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
        assert torch.equal(g, w), (g, w)


def _duplicated(acc):
    """Every real cluster five times over, each slab's triangle 4l+1 equal
    to 4l (l < 16) and triangles 64-127 equal to 0-63, and one copy's
    cluster 3 not ok; the dummy row last."""
    pack = acc["prep_t"].pallas_pack
    real = pack.shape[0] - 1
    body = pack[:real].clone()
    body[:, :, 1:64:4] = body[:, :, 0:64:4]     # ties within a lane
    body[:, :, 64:] = body[:, :, :64]           # and across lanes
    pack2 = torch.cat([body] * COPIES + [torch.zeros_like(pack[:1])])
    w_lo, w_hi = (b[:real].repeat(COPIES, 1) for b in acc["boxes_t"])
    cl_ok = _t(acc["cl_ok"][:real]).repeat(COPIES)
    cl_ok[real + 3] = False
    return pack2, w_lo.contiguous(), w_hi.contiguous(), cl_ok


def _ray_sets(acc):
    sets = []
    for _, o, d, alive in _batches(acc["sa"], N):
        sets.append(_masked(o, d, alive, np.full(N, 3e38, np.float32)))
    o, d = spray(N)
    sets.append(_masked(o, d, np.ones(N, bool),
                        np.full(N, 3e38, np.float32)))
    return [tuple(_t(x) for x in s) for s in sets]


@pytest.mark.parametrize("scene", ["test", "duplicated"])
def test_rounds_decomposition_matches_twins(accel, scene):  # noqa: F811
    """Both rounds, both modes, on camera, random and spray rays."""
    if scene == "test":
        pack = accel["prep_t"].pallas_pack
        boxes = accel["boxes_t"]
        cl_ok = _t(accel["cl_ok"])
    else:
        pack, *boxes, cl_ok = _duplicated(accel)
    hits = over = 0
    for o, d, tmax in _ray_sets(accel):
        r0 = ot._round0_twin(o, d, tmax, *boxes, cl_ok, pack)
        _same(ot._round0_lanes(o, d, tmax, *boxes, cl_ok, pack), r0)
        for mode in ("closest", "any"):
            r1 = ot._round1_twin(o, d, tmax, *r0, pack, mode)
            _same(ot._round1_lanes(o, d, tmax, *r0, pack, mode), r1)
            hits += int((r1[0] < INF).sum())
            over += int(r1[2].sum())
    assert hits > 0 and over > 0


def _built_round1_inputs(pack, mode, seed):
    """An entry matrix of small integers (ties), rows of INF, rows with
    1-3 candidates and dead octets, and rays whose need leaves about 3-6
    clusters per octet."""
    rng = np.random.default_rng(seed)
    no, C = 96, pack.shape[0] - 1
    e = rng.integers(0, 6, (no, C)).astype(np.float32)
    e[rng.uniform(size=(no, C)) < 0.3] = 3e38
    e[0::11] = 3e38
    for row, k in ((3, 1), (4, 2), (5, 3)):
        e[row] = 3e38
        e[row, rng.choice(C, k, replace=False)] = rng.integers(0, 3, k)
    dead = np.zeros(no, bool)
    dead[-8:] = True
    e[dead] = 3e38
    c0 = np.where(e.min(1) < 3e38, e.argmin(1), 0).astype(np.int32)
    # t_max per octet at its k-th smallest entry other than c0: the need
    # filter then keeps about k + ties clusters
    srt = np.sort(np.where(np.arange(C) == c0[:, None], 3e38, e), axis=1)
    k = rng.integers(2, 6, no)
    cap = srt[np.arange(no), k]
    tmax = np.repeat(np.where(cap < 3e38, cap, 9.0), 8).astype(np.float32)
    tmax[np.repeat(dead, 8)] = -1.0
    t0 = np.full(no * 8, 3e38, np.float32)
    if mode == "any":
        t0[rng.uniform(size=no * 8) < 0.05] = 1.0    # a few occluded rays
    else:
        hit = rng.uniform(size=no * 8) < 0.3
        t0[hit] = rng.uniform(0.5, 8.0, hit.sum())
    t0[np.repeat(dead, 8)] = 3e38
    idx0 = np.where(t0 < 3e38, 7, 0).astype(np.int32)
    return e, c0, t0, tmax, idx0, dead


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_round1_decomposition_on_built_matrices(accel, mode):  # noqa: F811
    pack, *_ = _duplicated(accel)
    e, c0, t0, tmax, idx0, dead = _built_round1_inputs(pack, mode, 7)
    no = e.shape[0]
    _, o, d, _ = _batches(accel["sa"], no * 8)[0]
    o, d = _t(o), _t(d)
    args = (_t(e), _t(c0), _t(t0), _t(idx0), pack, mode)
    r1 = ot._round1_twin(o, d, _t(tmax), *args)
    _same(ot._round1_lanes(o, d, _t(tmax), *args), r1)
    rem = r1[4].numpy()
    assert {0, 1, 2, 3, 4, 5} <= set(rem.tolist()) and (rem > 5).any()
    assert (rem[dead] == 0).all()
    dummy = pack.shape[0] - 1
    assert (r1[3].numpy()[rem == 2][:, 2:] == dummy).all()
    assert (r1[0] < INF).any()


def _jax_chain(acc, o, d, tmax, mode):
    """The JAX design's slice on numpy rays: entries, argmin, round 0
    through the Pallas kernel in interpret mode, the need filter, four
    argmin passes, round 1, the merge."""
    pack = acc["prep"].pallas_pack
    K, dummy = acc["static"].cluster_size, pack.shape[0] - 1
    e = np.array(j_ot.octet_entries(o, d, tmax, acc["w_lo"], acc["w_hi"],
                                    jnp.asarray(acc["cl_ok"])))
    no, C = e.shape
    c0 = e.argmin(1).astype(np.int32)
    desc0 = np.where(e.min(1) < 3e38, c0, dummy)[:, None].astype(np.int32)
    rays = jnp.asarray(np.concatenate(
        [o, d, tmax[:, None], np.zeros((no * 8, 1), np.float32)], axis=1))
    t0, i0 = (np.asarray(x) for x in j_ot._run_round(
        rays, pack, jnp.asarray(desc0), 1, K, dummy, True))
    need_r = (np.where(t0 < 3e38, np.float32(-3e37), tmax) if mode == "any"
              else np.minimum(t0, tmax))
    need = (need_r.reshape(no, 8).max(1) * np.float32(1.0001)
            + np.float32(1e-3))
    f = np.where(np.arange(C) == c0[:, None], np.float32(3e38), e)
    f = np.where(f <= need[:, None], f, np.float32(3e38))
    remaining = (f < 3e38).sum(1)
    cols = []
    for _ in range(4):
        ck = f.argmin(1)
        cols.append(np.where(f.min(1) < 3e38, ck, dummy))
        f[np.arange(no), ck] = 3e38
    slots = np.stack(cols, 1).astype(np.int32)
    t1, i1 = (np.asarray(x) for x in j_ot._run_round(
        rays, pack, jnp.asarray(slots), 4, K, dummy, True))
    better = t1 < t0
    return (c0, np.where(better, t1, t0), np.where(better, i1, i0), slots,
            remaining)


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_fused_twins_match_jax(accel, mode):  # noqa: F811
    batch, cap = (0, 3e38) if mode == "closest" else (1, 4.0)
    _, o, d, alive = _batches(accel["sa"], N)[batch]
    o, d, tmax = _masked(o, d, alive, np.full(N, cap, np.float32))
    c0_j, t_j, i_j, slots_j, rem_j = _jax_chain(accel, o, d, tmax, mode)
    pack = accel["prep_t"].pallas_pack
    ot.reset_counts()
    e, c0, t, idx = ot.round0(_t(o), _t(d), _t(tmax), *accel["boxes_t"],
                              _t(accel["cl_ok"]), pack)
    t, idx, over, slots, rem = ot.round1(_t(o), _t(d), _t(tmax), e, c0, t,
                                         idx, pack, mode)
    assert ot.rounds == {1: 1, 4: 1} and ot.launches == {1: 0, 4: 0}
    assert (c0.numpy() == c0_j).mean() >= 0.999
    assert (slots.numpy() == slots_j).mean() >= 0.999
    assert (rem.numpy() == rem_j).mean() >= 0.999
    assert ((over.numpy()) == (rem_j > 4)).mean() >= 0.999
    t, idx = t.numpy(), idx.numpy()
    f_p, f_j = t < INF, t_j < 3e38
    assert (f_p == f_j).mean() >= 0.999 and f_p.any()
    both = f_p & f_j
    np.testing.assert_allclose(t[both], t_j[both], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(idx[both], i_j[both])
