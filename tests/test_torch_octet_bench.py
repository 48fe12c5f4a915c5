"""The port's octet kernel bench (K4) and wavefront capture tools.

Each variant's torch twin (``rustray_tpu_torch.tools.octet_kernel_bench.
_bench_twin``, what ``bench_kernel`` runs on CPU tensors) is held against
the JAX bench kernel, built here from ``tools/octet_kernel_bench.
make_kernel`` with ``build``'s grid spec and run in interpret mode, on 64
rays (8 octets, 6 of them live).  Thresholds of tests/test_accel.py: found
masks at least 99.9% equal and t allclose at rtol=1e-4, atol=1e-5; the
winning triangle index must match too.

The kernel's warp and lane decomposition (``_bench_lanes``: lanes striding
the clusters with their own candidate lists, butterfly minima for the 16
passes; lane l testing triangles l + 32 q of every slab, keeping each
ray's nearest over the visits, and one (t, key) butterfly per ray) is held
bit for bit against the twin in every variant, on inputs built with ties:
equal entries within a lane, across lanes and across the first 16; rows
of INF and rows with 1-15 entries below INF; padded clusters entering at
0; equal t within a lane, across lanes and across visits; octets past
nlive.  The CUDA kernel is held against the twin bit for bit by
tests/test_torch_cuda.py and chip_smoke.py.
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


def _same(got, want):
    """Bit for bit: equal tensors of equal dtype (t compared as values)."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
        assert torch.equal(g, w), (g, w)


def _tie_pack(acc):
    """The test scene's pack with ties: each slab's triangle 4l+1 equal to
    4l (l < 16), triangles 64-127 equal to 0-63 and slab 1 equal to slab
    0, so every hit ties across lanes (4l and 4l + 1) and within a lane
    (k and k + 64, both lane k mod 32's), and rays hitting
    slab 0 tie across the visits to clusters 0 and 1."""
    pack = acc["prep_t"].pallas_pack.clone()
    assert pack.shape[0] >= 16        # v2-v4 read clusters 0..15
    real = pack.shape[0] - 1
    pack[:real, :, 1:64:4] = pack[:real, :, 0:64:4]
    pack[:real, :, 64:] = pack[:real, :, :64]
    pack[1] = pack[0]
    return pack


def _scene_inputs(acc):
    """Probe rays from the centres of clusters 0..15 (32 octets, the last 4
    past nlive; octet 3 dead, half of octet 5 dead) over the scene's box
    table with its padding, and box 1 and 32 equal to box 0 and boxes
    40-71 equal to box 2: equal entries across lanes, within lane 0 and
    across the first 16 of a row."""
    sa = to_torch(acc["sa"], acc["static"], "cpu")[0]
    _, rays, aabb = okb.probe_inputs(sa, acc["boxes_t"], 256)
    rays[24:32, 6] = -1.0
    rays[40:48:2, 6] = -1.0
    aabb[:, 1] = aabb[:, 0]
    aabb[:, 32] = aabb[:, 0]
    aabb[:, 40:72] = aabb[:, 2:3]
    nlive = torch.tensor([28], dtype=torch.int32)
    return nlive, rays, aabb, _tie_pack(acc)


def _built_inputs(acc, seed=5):
    """40 octets along +x (octet k from (20k, 0, 0), directions within
    1e-3 of +x; the last 4 past nlive) over 512 unpadded boxes.  Octet k
    owns k % 18 boxes of y, z in [-1, 1] at x offsets 0, 1, 2 or 3 (equal
    offsets give equal entries, offset 0 contains the origin), on random
    columns; the other columns sit at y = 500 and are never entered.
    Octets with t_max 4 reach only their own boxes, so their rows hold 0
    to 17 entries below INF; every fifth octet has t_max INF and enters
    the boxes of all the octets after it; octets 18 and 19 are dead."""
    rng = np.random.default_rng(seed)
    no, cpad = 40, 512
    lo = np.tile(np.array([[0.0], [500.0], [500.0]], np.float32), cpad)
    hi = lo + 1.0
    cols = rng.permutation(cpad)
    pos = 0
    for k in range(no):
        for _ in range(k % 18):
            c, a = cols[pos % cpad], rng.integers(0, 4)
            pos += 1
            lo[:, c] = (20.0 * k + a - 0.25, -1.0, -1.0)
            hi[:, c] = (20.0 * k + a + 0.25, 1.0, 1.0)
    aabb = np.concatenate([lo, hi, np.zeros((2, cpad), np.float32)])
    o = np.zeros((no * 8, 3), np.float32)
    o[:, 0] = 20.0 * np.repeat(np.arange(no), 8)
    o[:, 1:] = rng.uniform(-0.01, 0.01, (no * 8, 2))
    d = np.concatenate([np.ones((no * 8, 1)),
                        rng.uniform(-1e-3, 1e-3, (no * 8, 2))], axis=1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = np.where(np.repeat(np.arange(no) % 5 == 0, 8), 3e38, 4.0)
    tmax[np.repeat(np.isin(np.arange(no), (18, 19)), 8)] = -1.0
    rays = np.concatenate([o, d, tmax[:, None].astype(np.float32),
                           np.zeros((no * 8, 1), np.float32)], axis=1)
    return (torch.tensor([36], dtype=torch.int32), _t(rays), _t(aabb),
            _tie_pack(acc))


def _inputs(acc, kind):
    return _scene_inputs(acc) if kind == "scene" else _built_inputs(acc)


@pytest.mark.parametrize("kind", ["scene", "built"])
def test_bench_inputs_hold_the_ties(accel, kind):  # noqa: F811
    """The tie-built inputs hold what they are built for, and the lanes'
    16 passes equal the twin's on their entry rows."""
    nlive, rays, aabb, pack = _inputs(accel, kind)
    e = okb._entries(rays.reshape(-1, 8, 8), aabb)
    assert torch.equal(okb._picks_lanes(e), okb._picks(e))
    live = e[:int(nlive[0])]
    finite = (live < INF).sum(dim=1)
    assert (finite == 0).any()                          # rows of INF
    lanes = torch.arange(e.shape[1]) % 32
    same_lane = across = False
    for row in live:
        v, c = torch.unique(row[row < INF], return_counts=True)
        for x in v[c > 1]:
            ln = lanes[row == x]
            same_lane |= bool(len(set(ln.tolist())) < len(ln))
            across |= bool(len(set(ln.tolist())) > 1)
    assert same_lane and across
    if kind == "built":
        assert set(range(1, 16)) <= set(finite.tolist())
        assert (finite > 16).any()
    else:
        # the padding enters at 0, more than 16 times in every live row
        assert (e[:, -1] == 0).sum() > 0 and (finite[finite > 0] > 16).all()


@pytest.mark.parametrize("kind", ["scene", "built"])
@pytest.mark.parametrize("variant", okb.VARIANTS)
def test_bench_lanes_match_twin(accel, kind, variant):  # noqa: F811
    """The kernel's decomposition against the twin, bit for bit."""
    nlive, rays, aabb, pack = _inputs(accel, kind)
    want = okb._bench_twin(nlive, rays, aabb, pack, variant)
    _same(okb._bench_lanes(nlive, rays, aabb, pack, variant), want)
    t = want[0]
    assert (t[int(nlive[0]) * 8:] >= INF).all()
    if kind == "scene" and variant != "v1":
        assert (t < INF).sum() > 16, variant


def test_pick_lanes_on_built_rows():
    """The lanes' 16 passes against the twin's on entry rows of small
    integers (ties everywhere), with rows holding 0 to 40 entries below
    INF at random columns, and a row below INF throughout."""
    rng = np.random.default_rng(11)
    no, cpad = 82, 200
    e = rng.integers(0, 5, (no, cpad)).astype(np.float32)
    for k in range(no - 1):
        keep = rng.choice(cpad, min(k // 2, cpad), replace=False)
        row = np.full(cpad, 3e38, np.float32)
        row[keep] = e[k, keep]
        e[k] = row
    e = _t(e)
    _same((okb._picks_lanes(e),), (okb._picks(e),))
