"""Parts of the benchmark found by name, one file each.

``find(folder, name)`` is the module ``perfbench/<folder>/<name>.py``, or
else ``perfbench/<folder>/<name before the first dot>.py``, so that
``idle_share.edit`` reads with ``metrics/idle_share.py``.  The folders:

- ``loops/<kind>.py``: a loop kind, named by a traffic file's ``loop``;
- ``scenes/<generator>.py``: a scene generator, named by a configuration's
  ``scene.generator``;
- ``e2e/<metric>.py``: an end-to-end metric's reduction over the window;
- ``metrics/<metric>.py``: a per-layer metric's reader of the traced slice.

A later cell, mix, configuration or metric adds files and entries here
and in ``BENCHMARK.json``; no file that is there needs an edit.
"""
from __future__ import annotations

import importlib
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def find(folder: str, name: str):
    for stem in dict.fromkeys((name, name.split(".")[0])):
        if os.path.exists(os.path.join(HERE, folder, f"{stem}.py")):
            return importlib.import_module(f"perfbench.{folder}.{stem}")
    raise SystemExit(f"perfbench: no {folder}/{name}.py")
