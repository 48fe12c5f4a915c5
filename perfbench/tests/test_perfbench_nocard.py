"""Without a card the benchmark prints no result and exits non-zero, and
so it does in a directory that holds only BENCHMARK.json and perfbench/."""
import os
import shutil
import subprocess
import sys

from perfbench import run

CMD = ["perfbench/run.py", "--workload", "spheres_edit", "--seed",
       "2147483659", "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable] + CMD, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    p = _run(run.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_bare_directory_no_result(tmp_path):
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(run.ROOT, "perfbench"),
                    tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("_assets", "_cache",
                                                  "__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
