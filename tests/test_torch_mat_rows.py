"""The backward of the per-ray material-row gather (``gather_mat_rows``).

``ops/traverse.py::hit_attributes`` gathers each ray's row of the (M, 16)
material table; under autograd its backward sums the rows' cotangents per
material: by the CUDA kernel (``csrc/mat_rows.cu``) on CUDA tensors, by
``_mat_rows_twin`` (``index_add_``) on the CPU.

CPU part (counts in tier-1): the forward equals ``table[mat.long()]`` bit
for bit and the gradient equals plain indexing's at rtol 1e-6, for M of 1,
37 and one material tile plus one, N of 0, 100 and 1,031, with all rays on
one material, sorted runs and uniform random materials; ``hit_attributes``
keeps plain indexing unless the table requires grad under grad mode.

CUDA part (``cuda`` marker; skips without a card): the kernel against a
float64 ``index_add_`` at relative L2 1e-6 (also M = 3,000 and N of a
chunk's queue), two launches bit for bit, the launch counter under
``render_loss_and_grad`` and ``render()`` (which never loads the library),
and a chunked gradient equal to plain indexing's (the material rows and
the fold's expansion):

    python -m pytest tests/test_torch_mat_rows.py -q -m cuda
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rustray_tpu_torch import EngineConfig, render, to_torch
from rustray_tpu_torch.models.procedural import bench_scene
from rustray_tpu_torch.ops import traverse as trav
from rustray_tpu_torch.ops.intersect import safe_normalize
from rustray_tpu_torch.parallel import shard
from rustray_tpu_torch.render import wavefront
from rustray_tpu_torch.render.wavefront import prepare_frame

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE_EDGE = trav._MAT_TILE + 1
DISTS = ("one", "sorted", "uniform")
needs_card = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs an NVIDIA GPU: the CUDA kernel "
                                "has no CPU mode")


def _inputs(n_mats, n, dist, seed=0, device="cpu"):
    """A (n_mats, 16) table, the cotangent g (n, 16) and mat (n,) int32:
    every ray on the last material, sorted runs of random lengths, or
    uniform random materials."""
    rng = np.random.default_rng(seed)
    if dist == "one":
        mat = np.full(n, n_mats - 1)
    elif dist == "sorted":
        mat = np.sort(rng.integers(0, n_mats, n))
    else:
        mat = rng.integers(0, n_mats, n)
    table = torch.tensor(rng.normal(size=(n_mats, 16)), dtype=torch.float32,
                         device=device)
    g = torch.tensor(rng.normal(size=(n, 16)), dtype=torch.float32,
                     device=device)
    return table, g, torch.tensor(mat, dtype=torch.int32, device=device)


def _f64(g, mat, n_mats):
    return torch.zeros((n_mats, 16), dtype=torch.float64,
                       device=g.device).index_add_(0, mat, g.double())


def _grads(table, g, mat):
    """(forward, gradient) through gather_mat_rows and through plain
    indexing."""
    leaf = table.clone().requires_grad_()
    out = trav.gather_mat_rows(leaf, mat)
    got, = torch.autograd.grad(out, leaf, g)
    plain = table.clone().requires_grad_()
    want, = torch.autograd.grad(plain[mat.long()], plain, g)
    return out.detach(), got, want


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("n", [0, 100, 1031])
@pytest.mark.parametrize("n_mats", [1, 37, TILE_EDGE])
def test_gather_and_gradient_match_plain_indexing(n_mats, n, dist):
    table, g, mat = _inputs(n_mats, n, dist)
    out, got, want = _grads(table, g, mat)
    assert torch.equal(out, table[mat.long()])
    assert got.shape == (n_mats, 16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=0)


@pytest.fixture(scope="module")
def mini():
    """The bench mini-scene, its prep, and 256 rays from its middle
    through the dense scan."""
    sc = bench_scene(grid=2, lat=10, lon=14, width=96, height=64)
    sa, static = to_torch(*sc.compile(), "cpu")
    prep, _ = prepare_frame(sa, static, EngineConfig(accel="off",
                                                     pallas="off"))
    rng = np.random.default_rng(5)
    lo, hi = sa.verts.amin(0).numpy(), sa.verts.amax(0).numpy()
    o = torch.tensor(np.broadcast_to(0.5 * (lo + hi), (256, 3)).copy(),
                     dtype=torch.float32)
    d = safe_normalize(torch.tensor(rng.normal(size=(256, 3)),
                                    dtype=torch.float32))
    hit = trav.trace_closest(sa, static, prep, o, d, for_shadow=False,
                             allow_reflection_only=False)
    assert 0 < int(hit.hit.sum()) < 256
    return sa, static, prep, o, d, hit


def _refuse(*_):
    raise AssertionError("gather_mat_rows was taken")


def test_hit_attributes_keeps_plain_indexing_without_grad(mini, monkeypatch):
    sa, static, prep, o, d, hit = mini
    monkeypatch.setattr(trav, "gather_mat_rows", _refuse)
    assert not prep.mat_pack_f.requires_grad
    attrs = trav.hit_attributes(sa, static, prep, o, d, hit)
    assert attrs.mat_f.grad_fn is None
    assert torch.equal(attrs.mat_f, prep.mat_pack_f[attrs.mat.long()])
    leaf = prep.replace(mat_pack_f=prep.mat_pack_f.clone().requires_grad_())
    with torch.no_grad():
        attrs = trav.hit_attributes(sa, static, leaf, o, d, hit)
    assert torch.equal(attrs.mat_f, prep.mat_pack_f[attrs.mat.long()])


def test_hit_attributes_takes_the_function_under_grad(mini):
    sa, static, prep, o, d, hit = mini
    leaf = prep.mat_pack_f.clone().requires_grad_()
    attrs = trav.hit_attributes(sa, static, prep.replace(mat_pack_f=leaf),
                                o, d, hit)
    assert type(attrs.mat_f.grad_fn).__name__ == "_MatRowsBackward"
    assert torch.equal(attrs.mat_f.detach(), prep.mat_pack_f[
        attrs.mat.long()])
    w = torch.linspace(-1.0, 1.0, attrs.mat_f.numel()).view_as(attrs.mat_f)
    got, = torch.autograd.grad((attrs.mat_f * w).sum(), leaf)
    plain = prep.mat_pack_f.clone().requires_grad_()
    want, = torch.autograd.grad((plain[attrs.mat.long()] * w).sum(), plain)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)


# ---- on the card ----

def _rel_l2(got, want):
    want = want.double()
    den = float(torch.linalg.vector_norm(want))
    err = float(torch.linalg.vector_norm(got.double() - want))
    return err / den if den else err


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("n", [0, 100, 1031, 2**19 + 3])
@pytest.mark.parametrize("n_mats", [1, 37, TILE_EDGE, 3000])
@pytest.mark.cuda
@needs_card
def test_kernel_matches_float64_and_repeats_bit_for_bit(n_mats, n, dist):
    _, g, mat = _inputs(n_mats, n, dist, seed=n_mats + n, device="cuda")
    trav.reset_mat_rows()
    first = trav._mat_rows_cuda(g, mat, n_mats)
    second = trav._mat_rows_cuda(g, mat, n_mats)
    want = _f64(g, mat, n_mats)
    torch.cuda.synchronize()
    assert trav.mat_rows == {"launches": 2, "rows": 2 * n}
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    if n == 0:
        assert not first.any()
    else:
        assert _rel_l2(first, want) <= 1e-6
    _, g, mat = _inputs(n_mats, min(n, 4096), dist, device="cuda")
    table = torch.zeros((n_mats, 16), device="cuda", requires_grad=True)
    got, = torch.autograd.grad(trav.gather_mat_rows(table, mat), table, g)
    want = _f64(g, mat, n_mats)
    torch.cuda.synchronize()
    assert trav.mat_rows["launches"] == 3
    assert _rel_l2(got, want) <= 1e-6


def _plain_expand(acc, kept, take, perm):
    return torch.where(kept[:, None], acc[take], 0.0)


def _cuda_scene():
    sc = bench_scene(grid=2, lat=10, lon=14, width=96, height=64,
                     monte_carlo=True, samples=2)
    sc.raytracing_config.max_recursion = 2
    sa, static = to_torch(*sc.compile(), "cuda")
    return sa, static, sc.raytracing_config


_RENDER_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
from rustray_tpu_torch import build
from rustray_tpu_torch.ops import traverse as trav
from test_torch_mat_rows import _cuda_scene
from rustray_tpu_torch import EngineConfig, render
sa, static, cfg = _cuda_scene()
render(sa, static, cfg, EngineConfig(seed=3))
print(json.dumps({{"loaded": "mat_rows" in build._LIBS,
                  "launches": trav.mat_rows["launches"]}}))
"""


@pytest.mark.cuda
@needs_card
def test_launches_under_the_gradient_and_not_under_render():
    script = _RENDER_ONLY.format(root=ROOT)
    res = subprocess.run([sys.executable, "-c", script], cwd=os.path.join(
        ROOT, "tests"), capture_output=True, text=True, check=True)
    assert res.stdout.strip().splitlines()[-1] == \
        '{"loaded": false, "launches": 0}'
    sa, static, cfg = _cuda_scene()
    trav.reset_mat_rows()
    render(sa, static, cfg, EngineConfig(seed=3))
    assert trav.mat_rows["launches"] == 0
    target = np.random.default_rng(2).uniform(
        0.0, 1.0, (static.height, static.width, 3)).astype(np.float32)
    shard.render_loss_and_grad(sa, static, cfg, target,
                               EngineConfig(seed=3, chunk_pixels=1024))
    assert trav.mat_rows["launches"] > 0
    assert trav.mat_rows["rows"] >= static.width * static.height


@pytest.mark.cuda
@needs_card
def test_chunked_gradient_equals_plain_indexing(monkeypatch):
    """At queue factor 1 every level's children are compacted, so the
    fold's expansion runs under autograd too."""
    sa, static, cfg = _cuda_scene()
    target = np.random.default_rng(4).uniform(
        0.0, 1.0, (static.height, static.width, 3)).astype(np.float32)
    engine = EngineConfig(seed=2**31 + 7, chunk_pixels=1024,
                          queue_factor=1.0)
    trav.reset_mat_rows()
    loss, grads = shard.render_loss_and_grad(sa, static, cfg, target, engine)
    assert trav.mat_rows["launches"] > 0
    monkeypatch.setattr(trav, "gather_mat_rows",
                        lambda table, mat: table[mat.long()])
    monkeypatch.setattr(wavefront, "_expand", _plain_expand)
    p_loss, p_grads = shard.render_loss_and_grad(sa, static, cfg, target,
                                                 engine)
    np.testing.assert_allclose(float(loss), float(p_loss), rtol=1e-5)
    for grp, d in p_grads.items():
        assert d.keys() == grads[grp].keys()
        for k, want in d.items():
            np.testing.assert_allclose(grads[grp][k].cpu().numpy(),
                                       want.cpu().numpy(), rtol=1e-5,
                                       atol=1e-9, err_msg=f"{grp}.{k}")
