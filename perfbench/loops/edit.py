"""``edit``: one user at an editor, with no think time.  Each step makes
one edit in place on the session's scene, and the edit stays, as a user's
edits do: a sphere's base colour, reflectivity or position, or a light's
intensity (the file's ``kinds``, each with its range), then
``RenderSession.render_current_frame()`` renders the frame and returns it
to the host.  The kinds come in turns of one of each, in an order drawn
from the seed for every turn, so every seed's window holds as many of
each; the target and the value of every edit are drawn from the seed."""
from __future__ import annotations

import numpy as np

from .. import loop as base
from ..assets.procedural import SPHERE_LIGHTS, SPHERE_SPECS


def _translation(v) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(v, np.float32)
    return m


def _centre(target):
    return np.asarray(SPHERE_SPECS[target][0], np.float32)


def _intensity(target, factor):
    return float(SPHERE_LIGHTS[target][4] * factor)


class Loop(base.Loop):
    def edit(self, i: int):
        """(kind, target, value) of step i's edit."""
        spec = self.traffic["edits"]
        kinds = list(spec["kinds"])
        n = len(kinds)
        order = np.random.Generator(np.random.PCG64(
            [self.seed, 11, i // n])).permutation(n)
        kind = kinds[int(order[i % n])]
        lo, hi = spec["kinds"][kind]
        rng = np.random.Generator(np.random.PCG64([self.seed, 13, i]))
        if kind == "light_intensity":
            return kind, int(rng.integers(spec["lights"])), \
                float(rng.uniform(lo, hi))
        target = int(rng.integers(spec["spheres"]))
        if kind == "reflectivity":
            return kind, target, float(rng.uniform(lo, hi))
        return kind, target, rng.uniform(lo, hi, 3).astype(np.float32)

    def setup(self):
        self.sess = self.session(self.scene_file(), animate=False)
        self._spheres = [it for it in self.sess.scene.items
                         if it.basic.name.startswith("sphere")]
        self.step(-1)

    def state(self, i: int):
        """The scene after edits 0..i (-1: as loaded)."""
        return i

    def apply(self, i: int):
        if i < 0:
            return
        kind, target, value = self.edit(i)
        if kind == "light_intensity":
            self.sess.scene.lights[target].intensity = _intensity(target,
                                                                  value)
            return
        item = self._spheres[target]
        if kind == "base_color":
            item.get_material().base_color = value
        elif kind == "reflectivity":
            item.get_material().reflectivity = value
        elif kind == "position":
            item.basic.apply_mat(_translation(_centre(target) + value))

    def render(self):
        return self.session_render()

    def reference_scene(self, state):
        ref = self.reference_base()
        spheres = [it for it in ref.items if it.name.startswith("sphere")]
        for i in range(state + 1):
            kind, target, value = self.edit(i)
            if kind == "light_intensity":
                ref.lights[target].intensity = _intensity(target, value)
                continue
            item = spheres[target]
            mat = ref.materials[item.material]
            if kind == "base_color":
                mat.base = np.asarray(value, np.float32).astype(np.float64)
            elif kind == "reflectivity":
                mat.reflectivity = float(np.float32(value))
            elif kind == "position":
                item.center = (_centre(target) + value).astype(
                    np.float32).astype(np.float64)
        return ref

    def release(self):
        del self.sess, self._spheres
