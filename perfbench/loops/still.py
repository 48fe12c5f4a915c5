"""``still``: an offline render, accumulated in groups of samples.  The
scene is compiled once in set-up; each step renders one frame of
``samples_per_frame`` samples through ``render()``, the same key every
step, with the camera jittered below a pixel by an offset drawn from the
seed for that step, as a renderer that accumulates a long render group by
group moves its sample positions from one group to the next.  So no two
frames of a run are the same input.  The jitter is a translation in
normalised device coordinates set on the compiled camera's inverse
projection, a scene tensor that every replay reads anew and that the
renderer's cache key does not hold: no step recaptures."""
from __future__ import annotations

import numpy as np

from .. import loop as base


class Loop(base.Loop):
    def setup(self):
        from rustray_tpu_torch.render.wavefront import render
        from rustray_tpu_torch.scene_arrays import to_torch
        self._render = render
        self.sess = self.session(self.scene_file(), animate=False)
        scene = self.sess.scene
        self.sa, self.static = to_torch(*scene.compile(self.width,
                                                       self.height),
                                        self.device)
        self.cfg = scene.raytracing_config
        self.eng = self.engine()
        self._proj = self.sa.camera.proj_inv.detach().cpu().double().numpy()
        self.step(-1)

    def shift(self, i: int):
        """Step i's jitter in normalised device coordinates: an offset
        within a pixel, uniform in each axis, drawn from the seed."""
        j = np.random.Generator(np.random.PCG64(
            [self.seed, 29, i + 1])).uniform(-0.5, 0.5, 2)
        return (2.0 * float(j[0]) / self.width,
                -2.0 * float(j[1]) / self.height)

    def state(self, i: int):
        return i

    def apply(self, i: int):
        import torch
        t = np.eye(4)
        t[0, 3], t[1, 3] = self.shift(i)
        self.sa.camera.proj_inv.copy_(torch.from_numpy(
            (self._proj @ t).astype(np.float32)))

    def render(self):
        return self._render(self.sa, self.static, self.cfg, self.eng), {}

    def reference_scene(self, state):
        ref = self.reference_base()
        ref.ndc_shift = self.shift(state)
        return ref

    def release(self):
        del self.sa, self.static, self.sess
