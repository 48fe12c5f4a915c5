"""What the scene generators (``scenes/<generator>.py``) share: the
directory of a configuration's asset files, written once per checkout,
and the JSON forms of vectors, colours and the render config.

A generator's files (a GLB, a texture) go into a directory under
``perfbench/_assets/`` named by the generator and a hash of its
parameters, so that a later run finds them; the scene JSON that the
program loads is made per run, because a traffic mix may add to it (the
samples of a frame, an animation).
"""
from __future__ import annotations

import hashlib
import json
import os

ASSET_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_assets")
# bumped when what a generator writes changes, so that no stale file is read
_VERSION = 1
# the lens and the fog of a render config; the reference renders them off
LENS_AND_FOG = ("aperture_size", "focal_length", "fog_density")


def asset_dir(scene: dict) -> str:
    digest = hashlib.sha1(json.dumps([_VERSION, scene], sort_keys=True)
                          .encode()).hexdigest()[:12]
    d = os.path.join(ASSET_ROOT, f"{scene['generator']}-{digest}")
    os.makedirs(d, exist_ok=True)
    return d


def write_once(path: str, write) -> None:
    """Write ``path`` through a temporary name, so that a run cut short
    never leaves a partial file for a later run to read."""
    if os.path.exists(path):
        return
    tmp = f"{path}.partial"
    write(tmp)
    os.replace(tmp, path)


def png(img):
    def write(path):
        from PIL import Image
        Image.fromarray(img).save(path, format="PNG")
    return write


def vec(v):
    return {"x": float(v[0]), "y": float(v[1]), "z": float(v[2])}


def rgb(v):
    return {"r": float(v[0]), "g": float(v[1]), "b": float(v[2])}


def render_config(config: dict, samples: int) -> dict:
    """The scene JSON's ``config`` of a configuration at ``samples`` per
    frame, its lens and fog stated as the configuration's file gives them."""
    rt = {"monte_carlo": bool(config["monte_carlo"]), "samples": int(samples),
          "max_recursion": int(config["max_recursion"])}
    rt.update({k: float(config[k]) for k in LENS_AND_FOG})
    return rt


def reference_args(config: dict, samples: int) -> tuple:
    """(width, height, samples, monte_carlo, max_recursion) of the
    reference's scene; it has no lens and no fog, so a configuration that
    turns either on has no reference."""
    on = [k for k in LENS_AND_FOG if float(config[k]) != 0.0]
    if on:
        raise ValueError(f"the reference renders no {', '.join(on)}")
    return (int(config["width"]), int(config["height"]), int(samples),
            bool(config["monte_carlo"]), int(config["max_recursion"]))
