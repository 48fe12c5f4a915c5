"""The port's tools (``rustray_tpu_torch/tools``) against the JAX tools
(``tools/``) on the CPU.

- ``validate_accel``: the JAX tool's ``main(2, 256)`` (Pallas in
  interpret mode) and the port's at the same size on CPU tensors print the
  same lines for the dense scan, the XLA walk and the twin (the JAX
  tool's ``pallas``), and the port's dense scan, XLA walk and twin give
  the JAX functions' results on the same inputs: found masks equal, t
  allclose at rtol 1e-4 / atol 1e-5 (tests/test_accel.py's thresholds).
- The three labs: a seeded synthetic capture under the JAX keys (two
  levels, closest and shadow, 1,024 rays each) over the tests' bench
  mini-scene (both packages' ``ensure_bench_assets`` patched to grid 2,
  10x14 spheres): the printed tables are equal.
- ``ici_ratio`` on two gloo ranks: the counted all-reduce payload is the
  bytes that the reduced tensors' shapes imply.
- ``devbench.device_time``, ``gather_bench`` and ``scaling_bench`` (1 and
  2 ranks) at a tiny size, and every tool refusing ``--device cuda``
  without a card.
"""
import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rustray_tpu.models.procedural as j_procedural
import rustray_tpu_torch.models.procedural as t_procedural
from rustray_tpu_torch.tools import (binning_lab, devbench, gather_bench,
                                     ici_ratio, kernel_probe, octet_lab,
                                     scaling_bench, traversal_lab,
                                     validate_accel, walltime_probe)
from tools import binning_lab as j_binning_lab
from tools import octet_lab as j_octet_lab
from tools import traversal_lab as j_traversal_lab
from tools import validate_accel as j_validate_accel

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID, N_RAYS = 2, 256


def _lines(text):
    """The per-walk lines of the dense scan, the XLA walk and the twin, and
    the verdict, under the JAX tool's names."""
    out = []
    for line in text.splitlines():
        if line.startswith("  ") and not any(
                f" {k}" in line for k in ("K1/", "K2/", "K3 ")):
            out.append(line.replace("twin done", "pallas done")
                       .replace("twin  :", "pallas:"))
        elif line in ("ALL OK", "MISMATCH"):
            out.append(line)
    return out


def test_validate_accel_prints_the_jax_tools_lines(capsys):
    assert j_validate_accel.main(GRID, N_RAYS) == 0
    want = capsys.readouterr().out
    assert validate_accel.main(GRID, N_RAYS, device="cpu") == 0
    got = capsys.readouterr().out
    assert len(_lines(want)) == 3 * 5 + 1
    assert _lines(got) == _lines(want)
    # every kernel walk (its twin on the CPU) passed and was printed
    for kind in ("camera", "random", "halfdead"):
        for tag in ("K1/128", "K1/256", "K1/512", "K2/512", "K3    "):
            assert any(line.startswith(f"  {kind:9s} {tag}:") and
                       "DIFFERS" not in line for line in got.splitlines())


def test_validate_accel_walks_match_jax():
    """The port's dense scan, XLA walk and twin against the JAX functions on
    the tool's three batches, as numpy inputs."""
    from rustray_tpu.models.procedural import bench_scene as j_bench_scene
    from rustray_tpu.ops.block_trace import (pack_cluster_tris,
                                             trace_tris_blocks)
    from rustray_tpu.ops.cluster_trace import (select_closest_clusters,
                                               world_cluster_aabbs)
    from rustray_tpu.ops.intersect import INF, closest_tri, prepare_triangles
    from rustray_tpu_torch.models.procedural import bench_scene
    from rustray_tpu_torch.ops import block_trace as bt
    from rustray_tpu_torch.ops import cluster_trace as ct
    from rustray_tpu_torch.ops import intersect as ti
    from rustray_tpu_torch.scene_arrays import to_torch

    sa, static = j_bench_scene(grid=GRID, width=160, height=90).compile()
    prep = prepare_triangles(sa)
    prep = prep.replace(pallas_pack=pack_cluster_tris(
        prep, sa.tri_valid, static.n_clusters, static.cluster_size,
        int(sa.cl_lo.shape[0])))
    w_lo, w_hi = world_cluster_aabbs(sa)
    tri_ok = jnp.asarray(sa.tri_valid & sa.inst_visible[sa.tri_inst])
    cl_ok = jnp.asarray(sa.cl_valid & sa.inst_visible[sa.cl_inst])
    K = static.cluster_size

    tsa, tst = to_torch(*bench_scene(grid=GRID, width=160,
                                     height=90).compile(), "cpu")
    tprep = ti.prepare_triangles(tsa)
    tprep = tprep.replace(pallas_pack=bt.pack_cluster_tris(
        tprep, tsa.tri_valid, tst.n_clusters, K, int(tsa.cl_lo.shape[0])))
    t_lo, t_hi = ct.world_cluster_aabbs(tsa)
    t_tri_ok = tsa.tri_valid & tsa.inst_visible[tsa.tri_inst.long()]
    t_cl_ok = tsa.cl_valid & tsa.inst_visible[tsa.cl_inst.long()]

    j_walks = {
        "dense": jax.jit(lambda o, d, a: closest_tri(o, d, prep, tri_ok,
                                                     2048)[::-1]),
        "xla": jax.jit(lambda o, d, a: select_closest_clusters(
            o, d, prep, tri_ok, w_lo, w_hi, cl_ok, K, block=512,
            gather=32)[1:]),
        "twin": jax.jit(lambda o, d, a: trace_tris_blocks(
            o, d, a, None, prep, w_lo, w_hi, cl_ok, K, block_n=512,
            interpret=True)[1:])}
    t_walks = {
        "dense": lambda o, d, a: ti.closest_tri(o, d, tprep, t_tri_ok,
                                                2048)[::-1],
        "xla": lambda o, d, a: ct.select_closest_clusters(
            o, d, tprep, t_tri_ok, t_lo, t_hi, t_cl_ok, K, block=512,
            gather=32)[1:],
        "twin": lambda o, d, a: bt.trace_tris_blocks(
            o, d, a, None, tprep, t_lo, t_hi, t_cl_ok, K, block_n=512,
            interpret=True)[1:]}
    rng = np.random.default_rng(0)
    for kind in ("camera", "random", "halfdead"):
        o, d, alive = validate_accel._batch(kind, rng, N_RAYS, tsa, "cpu")
        args = [x.numpy() for x in (o, d, alive)]
        for name in ("dense", "xla", "twin"):
            j_i, j_t = (np.asarray(x) for x in j_walks[name](*args))
            t_i, t_t = (x.numpy() for x in t_walks[name](o, d, alive))
            j_f, t_f = j_t < INF, t_t < INF
            assert np.array_equal(j_f, t_f), (kind, name)
            np.testing.assert_allclose(t_t[j_f], j_t[j_f], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{kind} {name}")
            assert j_f.any() or kind != "camera"


def _capture(path, seed=0, n=1024):
    """A seeded capture under the JAX keys: levels 1 and 2, closest and
    shadow, rays aimed at the mini-scene from its camera (closest level 1)
    or from around it, 80% alive; shadow rays with a finite t_max."""
    rng = np.random.default_rng(seed)
    out = {}
    for lvl in (1, 2):
        for tag in ("closest", "shadow"):
            if tag == "closest" and lvl == 1:
                o = np.tile(np.array([[0.0, 3.0, 4.0]]), (n, 1))
            else:
                o = rng.uniform([-4, -1, -10], [4, 4, 2], (n, 3))
            tgt = rng.uniform([-3, -1.2, -10], [3, 1.5, -4], (n, 3))
            d = tgt - o + rng.normal(scale=0.5, size=(n, 3))
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            b = f"{tag}_{lvl}"
            out[b + "_o"] = o.astype(np.float32)
            out[b + "_d"] = d.astype(np.float32)
            out[b + "_alive"] = rng.uniform(size=n) < 0.8
            out[b + "_tmax"] = (np.full(n, 3.0e38) if tag == "closest"
                                else rng.uniform(1.0, 20.0, n)
                                ).astype(np.float32)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def waves(tmp_path_factory):
    path = tmp_path_factory.mktemp("waves") / "waves.npz"
    _capture(path)
    return str(path)


@pytest.mark.parametrize("lab", ["traversal_lab", "octet_lab",
                                 "binning_lab"])
def test_lab_tables_equal_the_jax_labs(lab, waves, tmp_path, monkeypatch):
    """Integer tables, equal line for line.  (A count could in principle
    differ by a slab-boundary graze, f32 arithmetic ordered differently;
    on these inputs none does, so they are held equal.)"""
    for mod, sub in ((j_procedural, "jax"), (t_procedural, "torch")):
        real = mod.ensure_bench_assets
        monkeypatch.setattr(
            mod, "ensure_bench_assets",
            lambda out_dir, real=real, sub=sub, **kw: real(
                str(tmp_path / sub), grid=2, lat=10, lon=14, width=96,
                height=64, samples=1, monte_carlo=True))
    j_mod = {"traversal_lab": j_traversal_lab, "octet_lab": j_octet_lab,
             "binning_lab": j_binning_lab}[lab]
    t_mod = {"traversal_lab": traversal_lab, "octet_lab": octet_lab,
             "binning_lab": binning_lab}[lab]
    monkeypatch.setattr(sys, "argv", ["lab", waves])
    want, got = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(want):
        j_mod.main()
    with contextlib.redirect_stdout(got):
        assert t_mod.main([waves, "--device", "cpu"]) == 0
    rows = want.getvalue().splitlines()
    assert sum(" closest_" in r or " shadow_" in r for r in rows) == 4
    assert got.getvalue() == want.getvalue()


def _run(*args, timeout=240):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_ici_ratio_counts_the_reduced_bytes():
    """Two gloo ranks, mesh 1 x 2, demo spheres 16 x 12 at 2 spp: the
    forward render reduces its one chunk's color, depth, normal (f32), ids
    (i32) and the two int64 counts over "samples"; the gradient the summed
    color, every parameter's gradient (f32) and the drop count (i64)."""
    from rustray_tpu_torch.parallel.shard import extract_diff_params
    from rustray_tpu_torch.scene_arrays import to_torch
    out = _run("rustray_tpu_torch.tools.ici_ratio", "16", "12", "2",
               "--device", "cpu")
    report = json.loads(out[out.index("{"):])
    px = 16 * 12
    fwd, grad = report["forward"], report["value_and_grad"]
    assert [r[:2] for r in fwd["reduced"]] == [
        [[px, 3], "torch.float32"], [[px], "torch.float32"],
        [[px, 3], "torch.float32"], [[px], "torch.int32"],
        [[2], "torch.int64"]]
    sa, _ = to_torch(*t_procedural.demo_spheres_scene(16, 12).compile(),
                     "cpu")
    n_params = sum(v.numel() for leaves in extract_diff_params(sa).values()
                   for v in leaves.values())
    assert [r[:2] for r in grad["reduced"]] == [
        [[px, 3], "torch.float32"], [[n_params], "torch.float32"],
        [[], "torch.int64"]]
    for path in (fwd, grad):
        assert path["all_reduce_bytes"] == sum(r[2] for r in path["reduced"])
        assert path["all_reduce_calls"] == len(path["reduced"])
        assert 0 < path["all_reduce_seconds"] < path["seconds"]
    assert fwd["all_reduce_bytes"] == px * 7 * 4 + px * 4 + 16
    assert grad["all_reduce_bytes"] == px * 3 * 4 + n_params * 4 + 8


def test_device_time_on_host_tensors():
    a = torch.randn(256, 256)
    ms = devbench.device_time(lambda x: x @ x, a, iters=2)
    assert 0.0 < ms < 1e4
    with pytest.raises(ValueError):
        devbench.device_time(lambda: None)


def test_gather_bench_times_every_layout():
    got = gather_bench.bench(2048, 1024, "cpu", iters=1)
    assert len(got) == 12
    assert all(np.isfinite(ms) and ms > 0 for ms in got.values())


def test_scaling_bench_one_and_two_ranks(capsys):
    assert scaling_bench.bench((1, 2), 16, 12, 2, "cpu") == 0
    out = capsys.readouterr().out
    assert "ranks=1 (mesh 1x1)" in out and "ranks=2 (mesh 1x2)" in out
    rays = {line.split("device_rays=")[1] for line in out.splitlines()
            if "device_rays=" in line}
    assert len(rays) == 1, out


@pytest.mark.parametrize("tool", [
    lambda: validate_accel.cli(["--device", "cuda"]),
    lambda: kernel_probe.main(["--device", "cuda"]),
    lambda: walltime_probe.main(["--device", "cuda"]),
    lambda: gather_bench.main(["--device", "cuda"]),
    lambda: scaling_bench.main(["--device", "cuda"]),
    lambda: ici_ratio.main(["--device", "cuda"]),
    lambda: traversal_lab.main(["--device", "cuda"]),
    lambda: octet_lab.main(["--device", "cuda"]),
    lambda: binning_lab.main(["--device", "cuda"]),
], ids=["validate_accel", "kernel_probe", "walltime_probe", "gather_bench",
        "scaling_bench", "ici_ratio", "traversal_lab", "octet_lab",
        "binning_lab"])
def test_tools_refuse_cuda_without_a_card(tool):
    """Asked for the card with none present, a tool exits non-zero and does
    not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run")
    try:
        rc = tool()
    except SystemExit as e:
        rc = e.code
    assert rc not in (0, None)
