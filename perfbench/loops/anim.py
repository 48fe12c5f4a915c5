"""``anim``: an animated ``RenderSession``.  The scene JSON carries
keyframes that move the meshes the file names along a path drawn from the
seed; each step renders the next frame through ``render_current_frame()``,
which updates the scene, compiles it, rebuilds the moved meshes' cluster
BVH and uploads it."""
from __future__ import annotations

import numpy as np

from .. import loop as base


class Loop(base.Loop):
    def __init__(self, *args):
        super().__init__(*args)
        self.fps, self.frames, self.kfs = self.keyframes()

    def keyframes(self):
        a = self.traffic["animation"]
        fps, frames = a["fps"], a["frames"]
        end_ms = int(np.ceil(1000.0 * frames / fps))
        times = np.linspace(0, end_ms, a["keyframes"]).round().astype(int)
        rng = np.random.Generator(np.random.PCG64([self.seed, 13]))
        lo, hi = np.asarray(a["offset_lo"]), np.asarray(a["offset_hi"])
        kfs = []
        for k, t in enumerate(times):
            objs = []
            for name in a["objects"]:
                v = np.zeros(3) if k == 0 else rng.uniform(lo, hi)
                objs.append((name, np.asarray(v, np.float32)))
            kfs.append((int(t), objs))
        return fps, frames, kfs

    def setup(self):
        anim = {"animation": {"fps": self.fps, "enabled": True, "keyframes": [
            {"time": t, "objects": [
                {"name": n, "transformation": {"translation": {
                    "x": float(v[0]), "y": float(v[1]), "z": float(v[2])}}}
                for n, v in objs]} for t, objs in self.kfs]}}
        self.sess = self.session(self.scene_file(anim), animate=True)
        self.step(-1)

    def state(self, i: int) -> int:
        """The frame that step i renders: 1 + i, cycling over frames
        1..frames-1; the warm-up (i = -1) renders frame 0."""
        return 0 if i < 0 else 1 + i % (self.frames - 1)

    def apply(self, i: int):
        f = self.state(i)
        self.sess.stats.frame = f
        self.sess.scene.apply_frame(f)

    def render(self):
        return self.session_render()

    def offsets(self, frame: int):
        """{object name: translation} at ``frame``, as upstream's animation
        interpolates keyframes (``src/animation.rs:109-205``): the
        timestamp floor(1000 / fps · frame), the last keyframe at or before
        it and the next one, a float32 lerp."""
        ts = int(np.floor((1000.0 / self.fps) * frame))
        first = last = self.kfs[0]
        for k, kf in enumerate(self.kfs):
            if kf[0] <= ts:
                first = kf
                last = self.kfs[k + 1] if k + 1 < len(self.kfs) else kf
        diff = last[0] - first[0]
        fac = np.float32((1.0 / diff) * (ts - first[0]) if diff else np.inf)
        out = {}
        for (name, a), (_, b) in zip(first[1], last[1]):
            out[name] = a + fac * (b - a)
        return out

    def reference_scene(self, state):
        ref = self.reference_base()
        offs = self.offsets(state)
        for it in ref.items:
            if it.name in offs:
                it.offset = np.asarray(offs[it.name], np.float32).astype(
                    np.float64)
        return ref

    def release(self):
        del self.sess
