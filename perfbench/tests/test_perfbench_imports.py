"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared
whole: rustray_tpu_torch is not rustray_tpu)."""
import ast
import os

import pytest

from perfbench import run

FILES = sorted(os.path.join(d, f)
               for d, _, fs in os.walk(run.HERE) for f in fs
               if f.endswith(".py") and "_cache" not in d)


def top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: os.path.relpath(p, run.HERE))
def test_no_jax(path):
    assert not set(top_names(path)) & {"jax", "jaxlib", "flax",
                                       "rustray_tpu"}


def test_reference_imports_nothing_of_the_program():
    ref = [p for p in FILES if os.sep + "reference" + os.sep in p]
    assert ref
    for path in ref:
        assert "rustray_tpu_torch" not in set(top_names(path)), path
    data = [p for p in FILES if os.sep + "assets" + os.sep in p
            or os.sep + "scenes" + os.sep in p]
    for path in data:
        assert "rustray_tpu_torch" not in set(top_names(path)), path


def test_the_check_names_the_program_only_through_its_entry_points():
    names = set()
    for path in FILES:
        if os.sep + "tests" + os.sep in path:
            continue
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("rustray_tpu_torch"):
                names |= {f"{node.module}.{a.name}" for a in node.names}
    assert names == {"rustray_tpu_torch.config.EngineConfig",
                     "rustray_tpu_torch.run.RenderSession",
                     "rustray_tpu_torch.render.wavefront.render",
                     "rustray_tpu_torch.scene_arrays.to_torch"}
