"""The port stands alone: importing it pulls in no JAX, no flax and no
triton (the card has no JAX; kernels build on first use, not at import),
and chip_smoke.py refuses to report without a GPU or a checkout."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GUARD = """
import sys
import rustray_tpu_torch
import rustray_tpu_torch.render.wavefront
import rustray_tpu_torch.ops.block_trace
import rustray_tpu_torch.scene.gltf_loader
import rustray_tpu_torch.scene.json_loader
import rustray_tpu_torch.models.procedural
import rustray_tpu_torch.build
import rustray_tpu_torch.cli
import rustray_tpu_torch.run
import rustray_tpu_torch.oracle
import rustray_tpu_torch.render.post
import rustray_tpu_torch.render.picking
import rustray_tpu_torch.ops.cluster_trace
import rustray_tpu_torch.parallel.shard
import rustray_tpu_torch.parallel.dryrun
import rustray_tpu_torch.tools.validate_accel
import rustray_tpu_torch.tools.devbench
import rustray_tpu_torch.tools.kernel_probe
import rustray_tpu_torch.tools.walltime_probe
import rustray_tpu_torch.tools.labs
import rustray_tpu_torch.tools.traversal_lab
import rustray_tpu_torch.tools.octet_lab
import rustray_tpu_torch.tools.binning_lab
import rustray_tpu_torch.tools.gather_bench
import rustray_tpu_torch.tools.scaling_bench
import rustray_tpu_torch.tools.ici_ratio
bad =sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'triton',
                                    'rustray_tpu'))
print(bad)
sys.exit(1 if bad else 0)
"""


def _run(args, cwd):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_pulls_no_jax_flax_or_triton():
    proc = _run(["-c", _GUARD], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_never_import_jax():
    pkg = os.path.join(REPO, "rustray_tpu_torch")
    for dirpath, dirs, files in os.walk(pkg):
        # _build/ holds build outputs, not the port's sources
        dirs[:] = [d for d in dirs if d != "_build"]
        for name in files:
            if name.endswith((".py", ".cu")):
                with open(os.path.join(dirpath, name)) as f:
                    for line in f:
                        words = line.split()
                        assert not (words[:1] in (["import"], ["from"])
                                    and words[1].split(".")[0] in
                                    ("jax", "flax")), (name, line)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu_or_checkout(where, tmp_path):
    """Without CUDA (or run outside a checkout) chip_smoke.py exits
    non-zero and prints no result line."""
    import torch
    if where == "checkout":
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: chip_smoke.py would run")
        cwd = REPO
    else:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    proc = _run(["chip_smoke.py"], cwd)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
