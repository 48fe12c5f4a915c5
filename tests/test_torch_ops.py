"""The port's device ops against the JAX package's, elementwise on the CPU.

Inputs come from numpy with fixed seeds and go through the JAX function
and its torch counterpart; results agree at rtol=1e-5, atol=1e-6 (both are
float32 with the same operation order; XLA may still fuse or reassociate a
sum), and random bits agree exactly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rustray_tpu.models.procedural import bench_scene
from rustray_tpu.ops import intersect as j_isect
from rustray_tpu.ops import rays as j_rays
from rustray_tpu.ops import shade as j_shade
from rustray_tpu.ops import texture as j_tex
from rustray_tpu.ops import traverse as j_trav
from rustray_tpu_torch import rng, to_torch
from rustray_tpu_torch.ops import intersect, rays, shade, texture, traverse

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core oversubscribes them
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(kw or TOL))


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def scene():
    sc = bench_scene(grid=2, lat=10, lon=14, width=96, height=64,
                     monte_carlo=True, samples=2)
    sa, static = sc.compile()
    sa_t, static_t = to_torch(sa, static, "cpu")
    return sa, static, sa_t, static_t


def _vec(rng_, shape, scale=1.0):
    return (rng_.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------- rng

@pytest.mark.parametrize("seed", [0, 1, 7, 123456789])
def test_prng_key_and_fold_in_bits(seed):
    k = jax.random.PRNGKey(seed)
    kt = rng.PRNGKey(seed)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(k).astype(np.int64))
    for data in (0, 1, 17, 23, 32768, 921599):
        k2 = jax.random.fold_in(k, data)
        kt2 = rng.fold_in(kt, data)
        np.testing.assert_array_equal(kt2.numpy(),
                                      np.asarray(k2).astype(np.int64))


@pytest.mark.parametrize("shape", [(5,), (7, 2), (33, 3, 2), (4096, 2)])
def test_uniform_bits(shape):
    k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 65536),
                           3)
    kt = rng.fold_in(rng.fold_in(rng.PRNGKey(0), 65536), 3)
    ref = np.asarray(jax.random.uniform(k, shape, jnp.float32))
    got = rng.uniform(kt, shape, "cpu").numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


# ---------------------------------------------------------------- intersect

def test_vector_helpers():
    r = np.random.default_rng(0)
    a, b = _vec(r, (64, 3)), _vec(r, (64, 3))
    m = _vec(r, (64, 4, 4))
    _close(intersect.dot(_t(a), _t(b)), j_isect.dot(a, b))
    _close(intersect.safe_normalize(_t(a)), j_isect.safe_normalize(a))
    _close(intersect.safe_normalize(torch.zeros(2, 3)),
           j_isect.safe_normalize(jnp.zeros((2, 3))))
    _close(intersect.transform_point(_t(m), _t(a)),
           j_isect.transform_point(m, a))
    _close(intersect.transform_dir(_t(m), _t(a)),
           j_isect.transform_dir(m, a))


def test_prepare_triangles(scene):
    sa, _, sa_t, _ = scene
    ref = j_isect.prepare_triangles(sa)
    got = intersect.prepare_triangles(sa_t)
    for f in ("a", "n", "an", "g1", "c1", "g2", "c2", "flat_n",
              "backface_sign"):
        _close(getattr(got, f), getattr(ref, f), rtol=1e-5, atol=1e-5)


def test_tri_barycentrics(scene):
    """(u, v, d·n) of winning triangles along random rays, hit or not."""
    sa, _, sa_t, _ = scene
    r = np.random.default_rng(11)
    n = 300
    o = _vec(r, (n, 3), 3.0)
    d = _vec(r, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = np.abs(_vec(r, (n,), 4.0))
    tri = r.integers(0, sa.tri_valid.shape[0], n).astype(np.int32)
    ref = j_isect.tri_barycentrics(o, d, t, tri,
                                   j_isect.prepare_triangles(sa))
    got = intersect.tri_barycentrics(_t(o), _t(d), _t(t), _t(tri),
                                     intersect.prepare_triangles(sa_t))
    for g, rf in zip(got, ref):
        _close(g, rf, rtol=1e-5, atol=1e-5)


def test_sphere_cast_and_normal():
    r = np.random.default_rng(1)
    lo, ld = _vec(r, (256, 3), 3.0), _vec(r, (256, 3))
    radius = np.abs(_vec(r, (256,))) + 0.5
    solid = r.uniform(size=256) < 0.5
    trans = _vec(r, (256, 4, 4))
    ref = j_isect.sphere_cast(lo, ld, radius, solid)
    got = intersect.sphere_cast(_t(lo), _t(ld), _t(radius), _t(solid))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    _close(got[1], ref[1])
    _close(intersect.sphere_hit_normal(_t(lo), _t(ld), got[1], got[2],
                                       _t(trans)),
           j_isect.sphere_hit_normal(lo, ld, ref[1], ref[2], trans))


def test_intersect_tile_and_closest_tri(scene):
    sa, static, sa_t, _ = scene
    prep_j = j_isect.prepare_triangles(sa)
    prep_t = intersect.prepare_triangles(sa_t)
    r = np.random.default_rng(2)
    o = _vec(r, (512, 3), 4.0)
    d = _vec(r, (512, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ok = np.asarray(sa.tri_valid)
    t_ref, hit_ref = j_isect.intersect_tri_tile(
        o, d, prep_j.an[:256], prep_j.n[:256], prep_j.g1[:256],
        prep_j.c1[:256], prep_j.g2[:256], prep_j.c2[:256], ok[:256])
    t_got, hit_got = intersect.intersect_tri_tile(
        _t(o), _t(d), prep_t.an[:256], prep_t.n[:256], prep_t.g1[:256],
        prep_t.c1[:256], prep_t.g2[:256], prep_t.c2[:256], _t(ok[:256]))
    assert (hit_got.numpy() == np.asarray(hit_ref)).mean() >= 0.9999
    both = hit_got.numpy() & np.asarray(hit_ref)
    _close(t_got.numpy()[both], np.asarray(t_ref)[both], rtol=1e-4,
           atol=1e-5)
    bt_ref, bi_ref = j_isect.closest_tri(o, d, prep_j, ok, 512)
    bt_got, bi_got = intersect.closest_tri(_t(o), _t(d), prep_t, _t(ok), 512)
    found = np.asarray(bt_ref) < float(j_isect.INF)
    assert ((bt_got.numpy() < intersect.INF) == found).mean() >= 0.999
    assert (bi_got.numpy() == np.asarray(bi_ref))[found].mean() >= 0.999
    _close(bt_got.numpy()[found], np.asarray(bt_ref)[found], rtol=1e-4,
           atol=1e-5)


# ---------------------------------------------------------------- rays

@pytest.mark.parametrize("dof", [False, True])
def test_primary_rays(scene, dof):
    sa, static, sa_t, _ = scene
    r = np.random.default_rng(3)
    px = r.integers(0, 96, 300).astype(np.int32)
    py = r.integers(0, 64, 300).astype(np.int32)
    ap, fl = (8.0, 6.0) if dof else (1.0, 1.0)
    ref = j_rays.primary_rays(sa.camera, 96, 64, jnp.asarray(px),
                              jnp.asarray(py), 1, 2, 4, ap, fl, 3)
    got = rays.primary_rays(sa_t.camera, 96, 64, _t(px), _t(py), 1, 2, 4,
                            ap, fl, 3)
    for g, rf in zip(got, ref):
        _close(g, rf, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- shade

def test_shade_math():
    r = np.random.default_rng(4)
    n = _vec(r, (400, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    i = _vec(r, (400, 3))
    i /= np.linalg.norm(i, axis=1, keepdims=True)
    p = _vec(r, (400, 3), 5.0)
    idx = (1.0 + np.abs(_vec(r, (400,)))).astype(np.float32)
    _close(shade.safe_sqrt(_t(idx - 1.5)), j_shade.safe_sqrt(idx - 1.5))
    _close(shade.reflect(_t(i), _t(n)), j_shade.reflect(i, n))
    for g, rf in zip(shade.create_reflection(_t(n), _t(i), _t(p)),
                     j_shade.create_reflection(n, i, p)):
        _close(g, rf)
    got = shade.create_transmission(_t(n), _t(i), _t(p), _t(idx))
    ref = j_shade.create_transmission(n, i, p, idx)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    _close(got[0], ref[0])
    _close(got[1], ref[1], rtol=1e-5, atol=1e-5)
    _close(shade.fresnel(_t(i), _t(n), _t(idx)), j_shade.fresnel(i, n, idx))


def test_gamma_encode():
    """Negative, zero, in-range and above-one linear colors."""
    lin = np.concatenate([np.linspace(-0.5, 1.5, 401, dtype=np.float32),
                          np.float32([0.0, 1e-30, 1.0])])
    _close(shade.gamma_encode(_t(lin)), j_shade.gamma_encode(lin))


@pytest.mark.parametrize("shape", [(300,), (100, 3)])
def test_jitter(shape):
    r = np.random.default_rng(5)
    dirs = _vec(r, shape + (3,))
    spread = np.abs(_vec(r, shape, 0.2))
    spread[::7] = 0.0
    k = jax.random.fold_in(jax.random.PRNGKey(0), 17)
    kt = rng.fold_in(rng.PRNGKey(0), 17)
    _close(shade.jitter(kt, _t(dirs), _t(spread)),
           j_shade.jitter(k, dirs, spread), rtol=1e-5, atol=2e-6)


# ---------------------------------------------------------------- texture

def test_unpack_and_wrap():
    r = np.random.default_rng(6)
    packed = r.integers(-2**31, 2**31 - 1, 500).astype(np.int32)
    _close(texture._unpack(_t(packed)), j_tex._unpack(packed))
    vals = _vec(r, (500,), 3.0)
    bound = r.integers(1, 50, 500).astype(np.int32)
    np.testing.assert_array_equal(texture._wrap(_t(vals), _t(bound)).numpy(),
                                  np.asarray(j_tex._wrap(vals, bound)))


@pytest.mark.parametrize("nearest", [False, True])
def test_get_tex_color_rows(scene, nearest):
    sa, static, sa_t, static_t = scene
    import dataclasses
    st = dataclasses.replace(static, any_nearest=nearest,
                             any_bilinear=True)
    mf, mi = j_trav.build_mat_packs(sa.materials)
    mi = np.asarray(mi).copy()
    mi[:, j_trav.MI_NEAREST] = r_near = np.arange(mi.shape[0]) % 2
    r = np.random.default_rng(7)
    rows = r.integers(0, mi.shape[0], 1000)
    uv = _vec(r, (1000, 2), 2.0)
    ref = j_tex.get_tex_color_rows(sa, mi[rows], 0, uv, st)
    got = texture.get_tex_color_rows(sa_t, _t(mi[rows]), 0, _t(uv), st)
    assert r_near.any()
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    _close(got[0], ref[0], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- traverse

def test_packs_and_instance_mask(scene):
    sa, static, sa_t, _ = scene
    prep_j = j_trav.build_shade_packs(sa, j_isect.prepare_triangles(sa),
                                      j_trav.prepare_vertex_normals(sa))
    prep_t = traverse.build_shade_packs(
        sa_t, intersect.prepare_triangles(sa_t),
        traverse.prepare_vertex_normals(sa_t))
    for f in ("shade_pack", "corner_pack", "mat_pack_f"):
        _close(getattr(prep_t, f), getattr(prep_j, f), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(prep_t.mat_pack_i.numpy(),
                                  np.asarray(prep_j.mat_pack_i))
    for shadow in (False, True):
        for ro in (False, True):
            np.testing.assert_array_equal(
                traverse.instance_mask(sa_t, shadow, ro).numpy(),
                np.asarray(j_trav.instance_mask(sa, shadow, ro)))
        np.testing.assert_array_equal(
            traverse._sphere_solid(sa_t, shadow).numpy(),
            np.asarray(j_trav._sphere_solid(sa, shadow)))


@pytest.mark.parametrize("shadow", [False, True])
def test_dense_trace_and_hit_attributes(shadow):
    """Dense trace_closest + hit_attributes on a scene with spheres and
    meshes (demo_spheres) and camera rays."""
    from rustray_tpu.models.procedural import demo_spheres_scene
    sa, static = demo_spheres_scene(96, 64).compile()
    sa_t, static_t = to_torch(sa, static, "cpu")
    r = np.random.default_rng(8)
    px = r.integers(0, 96, 600).astype(np.int32)
    py = r.integers(0, 64, 600).astype(np.int32)
    o, d = j_rays.primary_rays(sa.camera, 96, 64, jnp.asarray(px),
                               jnp.asarray(py), 0, 0, 1, 1.0, 1.0, 1)
    d = j_isect.safe_normalize(d)
    t_max = np.full((600,), 12.0, np.float32) if shadow else None
    prep_j = j_trav.build_shade_packs(sa, j_isect.prepare_triangles(sa),
                                      j_trav.prepare_vertex_normals(sa))
    prep_t = traverse.build_shade_packs(
        sa_t, intersect.prepare_triangles(sa_t),
        traverse.prepare_vertex_normals(sa_t))
    hit_j = j_trav.trace_closest(sa, static, prep_j, o, d, shadow, False,
                                 t_max=t_max)
    hit_t = traverse.trace_closest(sa_t, static_t, prep_t, _t(o), _t(d),
                                   shadow, False,
                                   t_max=None if t_max is None
                                   else _t(t_max))
    np.testing.assert_array_equal(hit_t.hit.numpy(), np.asarray(hit_j.hit))
    np.testing.assert_array_equal(hit_t.is_mesh.numpy(),
                                  np.asarray(hit_j.is_mesh))
    np.testing.assert_array_equal(hit_t.inst.numpy(), np.asarray(hit_j.inst))
    _close(hit_t.t.numpy(), np.asarray(hit_j.t), rtol=1e-5, atol=1e-5)
    at_j = j_trav.hit_attributes(sa, static, prep_j, o, d, hit_j)
    at_t = traverse.hit_attributes(sa_t, static_t, prep_t, _t(o), _t(d),
                                   hit_t)
    for f in ("mat", "obj_id", "mat_i"):
        np.testing.assert_array_equal(getattr(at_t, f).numpy(),
                                      np.asarray(getattr(at_j, f)))
    for f in ("normal", "uv", "point", "mat_f"):
        _close(getattr(at_t, f), getattr(at_j, f), rtol=1e-4, atol=1e-5)
