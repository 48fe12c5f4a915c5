"""The port's host-side code is a jax-free copy of the JAX package's.

The card that runs the port has no JAX and no flax, so the loaders,
``compile_scene``, the cluster builder, the math helpers and the config
dataclasses live in ``rustray_tpu_torch`` as copies.  These tests pin each
copy to its original: the source text may differ only where the port had
to change it, and scenes loaded and compiled through either package give
equal leaves.
"""
import ast
import dataclasses
import difflib
import json
import os
import re

import numpy as np
import pytest
import torch

import rustray_tpu
import rustray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G2_GLB = os.path.join(REPO, "data", "bench", "sponza_class_g2_12x18.glb")

# module → regexes every changed line of the original must match (the port
# rewords a docstring that named a local checkout path, and drops flax)
_VERBATIM = {
    "utils/__init__.py": [], "utils/download.py": [], "utils/assets.py": [],
    "utils/mathutil.py": [r"^Reference parity notes \(citations into "],
    "scene/__init__.py": [], "scene/scene.py": [], "scene/camera.py": [],
    "scene/light.py": [], "scene/material.py": [], "scene/shapes.py": [],
    "scene/textures.py": [], "scene/animation.py": [],
    "scene/json_loader.py": [], "scene/gltf_loader.py": [],
    "scene/gltf_writer.py": [], "scene/obj_loader.py": [],
    "scene/compile.py": [r"^from flax import struct$",
                         r"^@struct\.dataclass$"],
    "accel/__init__.py": [], "accel/builder.py": [],
    "models/__init__.py": [],
    "models/procedural.py": [r"sponza\.json\)\.  Returns the JSON path\.$"],
    "native/cluster_bvh.cpp": [],
    "oracle.py": [], "__main__.py": [],
}


def _src(pkg, rel):
    with open(os.path.join(os.path.dirname(pkg.__file__), rel)) as f:
        return f.read().splitlines()


@pytest.mark.parametrize("rel", sorted(_VERBATIM))
def test_host_copy_is_verbatim(rel):
    orig, port = _src(rustray_tpu, rel), _src(rustray_tpu_torch, rel)
    removed = [l[2:] for l in difflib.ndiff(orig, port)
               if l.startswith("- ")]
    for line in removed:
        assert any(re.search(p, line) for p in _VERBATIM[rel]), (
            f"{rel}: line changed in the port's copy: {line!r}")
    if rel == "scene/compile.py":
        assert not any("flax" in l or "struct." in l for l in port)


def test_native_source_is_the_ports_own():
    """The cluster builder compiles the port's copy of cluster_bvh.cpp,
    never the JAX package's file."""
    from rustray_tpu_torch.accel import native
    pkg = os.path.dirname(os.path.abspath(rustray_tpu_torch.__file__))
    assert os.path.commonpath([native._SRC, pkg]) == pkg, native._SRC
    assert os.path.isfile(native._SRC)


def _code_strings(path):
    """String constants of a module's code, docstrings left out."""
    tree = ast.parse(open(path).read())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_port_names_no_path_into_the_jax_package():
    """No string in the port's code names the JAX package's directory as
    a path component (a file the port would read from there)."""
    pkg = os.path.dirname(os.path.abspath(rustray_tpu_torch.__file__))
    for dirpath, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "_build"]
        for name in files:
            if not name.endswith(".py"):
                continue
            for s in _code_strings(os.path.join(dirpath, name)):
                assert "rustray_tpu" not in re.split(r"[\\/]", s), (
                    name, s)


def test_config_copy_matches_up_to_use_pallas():
    """config.py is verbatim up to ``use_pallas``, which reads the tensor
    device instead of the JAX backend."""
    orig = "\n".join(_src(rustray_tpu, "config.py"))
    port = "\n".join(_src(rustray_tpu_torch, "config.py"))
    port = port.replace("\nimport torch\n\n", "\n", 1)
    cut = "    def use_pallas(self, static"
    assert port[:port.index(cut)] == orig[:orig.index(cut)]


def test_use_pallas_reads_the_device():
    from rustray_tpu_torch.config import EngineConfig
    from rustray_tpu_torch.scene.compile import SceneStatic
    big = SceneStatic(n_instances=1, n_spheres=0, n_tris=5000, n_materials=1,
                      n_lights=1, width=8, height=8, has_any_texture=False,
                      has_normal_tex=False, has_mesh=True, n_clusters=40)
    assert not EngineConfig().use_pallas(big, "cpu")
    assert EngineConfig().use_pallas(big, "cuda")
    assert not EngineConfig(accel="off").use_pallas(big, "cuda")
    assert not EngineConfig(pallas="off").use_pallas(big, "cuda")
    assert EngineConfig(pallas="on", pallas_interpret=True).use_pallas(
        big, "cpu")
    with pytest.raises(ValueError, match="pallas_interpret"):
        EngineConfig(pallas="on").use_pallas(big, "cpu")


@pytest.mark.parametrize("samples", [1, 2, 5, 16, 128])
def test_sample_pattern_copy(samples):
    from rustray_tpu.utils.mathutil import sample_pattern as ref
    from rustray_tpu_torch.utils.mathutil import sample_pattern
    np.testing.assert_array_equal(sample_pattern(samples, 3),
                                  ref(samples, 3))


def test_cluster_builder_copy():
    from rustray_tpu.accel import builder as ref
    from rustray_tpu_torch.accel import builder
    rng = np.random.default_rng(5)
    verts = rng.normal(size=(600, 3)).astype(np.float32)
    tris = rng.integers(0, 600, (900, 3)).astype(np.int32)
    assert (builder.native.load() is None) == (ref.native.load() is None)
    for a, b in zip(builder.build_clusters(verts, tris, 64),
                    ref.build_clusters(verts, tris, 64)):
        np.testing.assert_array_equal(a, b)


def _load_json_scene(pkg, tmp_path):
    spec = {"config": {"monte_carlo": True, "samples": 2,
                       "max_recursion": 3},
            "objects": [{"name": "sponza_class", "type": "gltf",
                         "path": G2_GLB}]}
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(spec))
    scene = pkg.Scene()
    scene.load(str(path))
    scene.cam.init(96, 64)
    scene.init()
    scene.update()
    return scene


def _bench(pkg, mc):
    from importlib import import_module
    procedural = import_module(pkg.__name__ + ".models.procedural")
    return procedural.bench_scene(grid=2, lat=10, lon=14, width=96,
                                  height=64, monte_carlo=mc,
                                  samples=2 if mc else 1)


def _demo(pkg):
    from importlib import import_module
    return import_module(
        pkg.__name__ + ".models.procedural").demo_spheres_scene(96, 64)


_SCENES = {
    "g2_glb_json": lambda pkg, tmp: _load_json_scene(pkg, tmp),
    "bench_scene": lambda pkg, tmp: _bench(pkg, False),
    "bench_scene_mc": lambda pkg, tmp: _bench(pkg, True),
    "demo_spheres": lambda pkg, tmp: _demo(pkg),
}


def _assert_leaves_equal(a, b, path="sa"):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(y):
            _assert_leaves_equal(x, y, f"{path}.{f.name}")
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f"{path}.{f.name}"
        np.testing.assert_array_equal(x, y, err_msg=f"{path}.{f.name}")


@pytest.mark.parametrize("name", sorted(_SCENES))
def test_scene_copy_compiles_equal_leaves(name, tmp_path):
    ref_scene = _SCENES[name](rustray_tpu, tmp_path)
    scene = _SCENES[name](rustray_tpu_torch, tmp_path)
    assert dataclasses.asdict(scene.raytracing_config) == \
        dataclasses.asdict(ref_scene.raytracing_config)
    ref_sa, ref_static = ref_scene.compile()
    sa, static = scene.compile()
    assert dataclasses.asdict(static) == dataclasses.asdict(ref_static)
    _assert_leaves_equal(sa, ref_sa)
    # the bridge keeps every leaf of either package's compile, with the
    # dtype JAX gives it
    for leaves, st in ((sa, static), (ref_sa, ref_static)):
        sa_t, static_t = rustray_tpu_torch.to_torch(leaves, st, "cpu")
        assert dataclasses.asdict(static_t) == dataclasses.asdict(st)
        _assert_bridged(sa_t, ref_sa)


def _assert_bridged(t, ref, path="sa"):
    import jax.numpy as jnp
    for f in dataclasses.fields(ref):
        x, y = getattr(t, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(y):
            _assert_bridged(x, y, f"{path}.{f.name}")
            continue
        assert isinstance(x, torch.Tensor), f"{path}.{f.name}"
        want = jnp.asarray(y).dtype
        assert np.dtype(str(x.dtype).replace("torch.", "")) == want, \
            f"{path}.{f.name}: {x.dtype} vs {want}"
        np.testing.assert_array_equal(x.numpy(), np.asarray(jnp.asarray(y)),
                                      err_msg=f"{path}.{f.name}")
