"""The port's texture samplers: nearest and the legacy 4-texel bilinear
against the JAX package's and the oracle's (the port's verbatim copy of it),
the texel-pair bilinear against the legacy one, and ``get_tex_color``
against the JAX package's on a textured scene.  Twins of
tests/test_textures.py; negative and >1 UVs exercise the wrap and the
edge-extrapolation quirks."""
import jax.numpy as jnp
import numpy as np
import torch

from rustray_tpu.models.procedural import bench_scene
from rustray_tpu.ops import texture as j_tex
from rustray_tpu.scene.material import TextureType
from rustray_tpu.scene.textures import pack_rgba
from rustray_tpu_torch import to_torch
from rustray_tpu_torch.ops import texture as tex
from rustray_tpu_torch.oracle import _sample_bilinear, _tex_fetch, _wrap

torch.set_num_threads(1)


def _random_tex(rng, w, h):
    return rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)


def _scalar(x):
    return torch.tensor(x, dtype=torch.int32)


def test_nearest_matches_jax_and_oracle_wrap():
    rng = np.random.default_rng(3)
    t = _random_tex(rng, 7, 5)
    texels = pack_rgba(t)
    uvs = rng.uniform(-2.5, 2.5, size=(200, 2)).astype(np.float32)
    got = tex.sample_nearest(torch.tensor(texels), _scalar(0), _scalar(7),
                             _scalar(5), torch.tensor(uvs[:, 0]),
                             torch.tensor(uvs[:, 1])).numpy()
    ref = np.asarray(j_tex.sample_nearest(
        jnp.asarray(texels), jnp.int32(0), jnp.int32(7), jnp.int32(5),
        jnp.asarray(uvs[:, 0]), jnp.asarray(uvs[:, 1])))
    np.testing.assert_array_equal(got, ref)
    for i, (u, v) in enumerate(uvs):
        want = _tex_fetch(t, _wrap(float(u), 7), _wrap(float(v), 5))
        np.testing.assert_allclose(got[i], want, atol=1e-6)


def test_bilinear_matches_jax_and_oracle_including_quirks():
    rng = np.random.default_rng(4)
    t = _random_tex(rng, 9, 6)
    texels = pack_rgba(t)
    uvs = rng.uniform(-1.5, 1.8, size=(200, 2)).astype(np.float32)
    got = tex.sample_bilinear(torch.tensor(texels), _scalar(0), _scalar(9),
                              _scalar(6), torch.tensor(uvs[:, 0]),
                              torch.tensor(uvs[:, 1])).numpy()
    ref = np.asarray(j_tex.sample_bilinear(
        jnp.asarray(texels), jnp.int32(0), jnp.int32(9), jnp.int32(6),
        jnp.asarray(uvs[:, 0]), jnp.asarray(uvs[:, 1])))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    for i, (u, v) in enumerate(uvs):
        want = _sample_bilinear(t, float(u), float(v))
        np.testing.assert_allclose(got[i], want, atol=2e-5,
                                   err_msg=f"uv={u},{v}")


def test_pair_table_bilinear_matches_legacy():
    rng = np.random.default_rng(7)
    w, h = 13, 9
    t = rng.integers(0, 2**31 - 1, w * h, dtype=np.int32)
    pairs = np.stack([t, np.append(t[1:], t[-1])], axis=1)
    n = 512
    u = torch.tensor(rng.uniform(-1.5, 2.5, n), dtype=torch.float32)
    v = torch.tensor(rng.uniform(-1.5, 2.5, n), dtype=torch.float32)
    off = torch.zeros((n,), dtype=torch.int32)
    wv = torch.full((n,), w, dtype=torch.int32)
    hv = torch.full((n,), h, dtype=torch.int32)
    a = tex.sample_bilinear(torch.tensor(t), off, wv, hv, u, v)
    b = tex._sample_bilinear_pairs(torch.tensor(pairs), off, wv, hv, u, v)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_get_tex_color_matches_jax():
    scene = bench_scene(grid=2, lat=10, lon=14, width=32, height=24,
                        monte_carlo=False, samples=1)
    sa, static = scene.compile()
    sa_t, _ = to_torch(sa, static, "cpu")
    rng = np.random.default_rng(5)
    n = 256
    mat = rng.integers(0, np.asarray(sa.materials.alpha).shape[0], n)
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    for tt in (TextureType.Base, TextureType.Normal):
        rgba, has = tex.get_tex_color(sa_t, torch.tensor(mat), int(tt),
                                      torch.tensor(uv))
        r_rgba, r_has = j_tex.get_tex_color(sa, jnp.asarray(mat), int(tt),
                                            jnp.asarray(uv))
        np.testing.assert_array_equal(has.numpy(), np.asarray(r_has))
        np.testing.assert_allclose(rgba.numpy(), np.asarray(r_rgba),
                                   atol=1e-6)
    assert has.numpy().sum() == 0 and np.asarray(r_has).sum() == 0
    assert tex.get_tex_color(sa_t, torch.tensor(mat), int(TextureType.Base),
                             torch.tensor(uv))[1].any()
