"""A closed loop of one client: the base of every loop kind.

A traffic mix is a data file, ``traffic/<mix>.json``, of the numbers one
loop kind reads; its ``loop`` key names the kind, the module
``loops/<kind>.py`` (found by ``named.find``), whose class ``Loop``
derives from the one here.  A kind defines:

- ``setup()``: load the scene into the program, then one warm-up step
  (``self.step(-1)``) of the cell's own shapes;
- ``apply(i)``: set step i's input on the program's scene (the warm-up,
  ``i = -1``, sets the loaded scene's);
- ``render()``: render the frame through the kind's entry point; returns
  (outputs, the program's own clocks of the step as a dict);
- ``state(i)``: what the reference needs to rebuild step i's scene, known
  without running the step (hashable);
- ``reference_scene(state)``: the reference's scene in that state;
- ``release()``: drop the program's state before the check.

The rest is common to the kinds: a step, what the run keeps of it, what
the check keeps of it, the check against the reference at float64 once
the window has closed, and the counts that the traced run's readers
need.  The program gets only the generated inputs.
"""
from __future__ import annotations

import json
import os
import tempfile
import time

from . import check, named


class Loop:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.samples = int(traffic["samples_per_frame"])
        self.width, self.height = int(config["width"]), int(config["height"])
        self.max_steps = 1 << 30
        self.pixels = check.pick_pixels(self.width, self.height,
                                        traffic["check"]["pixels"], seed)
        self.generator = named.find("scenes", config["scene"]["generator"])
        self.tmp = None
        self._ref_data = None

    # ---- the program's side ----

    def engine(self):
        from rustray_tpu_torch.config import EngineConfig
        e = self.config["engine"]
        return EngineConfig(seed=self.seed, chunk_pixels=e["chunk_pixels"],
                            queue_factor=e["queue_factor"], pallas=e["pallas"])

    def scene_file(self, extra=None) -> str:
        """Write this run's scene JSON into the run's temporary directory."""
        data = self.generator.program_scene(self.config, self.samples)
        data.update(extra or {})
        self.tmp = tempfile.mkdtemp(prefix="perfbench_scene")
        path = os.path.join(self.tmp, "scene.json")
        with open(path, "w") as f:
            json.dump(data, f)
        return path

    def session(self, path: str, animate: bool):
        from rustray_tpu_torch.run import RenderSession
        s = RenderSession(self.width, self.height, [path], animate=animate,
                          engine=self.engine(), device=self.device)
        s.init()
        return s

    def session_render(self):
        """``render_current_frame()`` of the loop's session, with the
        session's clocks of its scene compile and its render."""
        out = self.sess.render_current_frame()
        return out, dict(compile_s=self.sess.stats.last_compile_seconds,
                         render_s=self.sess.stats.last_render_seconds)

    def step(self, i: int) -> dict:
        """Step i: its input set and its frame rendered; the record of what
        it rendered, its time and its state."""
        t0 = time.perf_counter()
        self.apply(i)
        out, clocks = self.render()
        return dict(seconds=time.perf_counter() - t0, out=out,
                    state=self.state(i), **clocks)

    def close(self):
        import shutil
        if self.tmp:
            shutil.rmtree(self.tmp, ignore_errors=True)

    # ---- what is kept of a step ----

    def summary(self, rec: dict) -> dict:
        """What the run keeps of every step: its time, the program's
        clocks, and its traced and dropped rays."""
        s = {k: rec[k] for k in ("seconds", "compile_s", "render_s")
             if k in rec}
        s.update(device_rays=int(rec["out"]["device_rays"]),
                 dropped=int(rec["out"]["dropped_rays"]))
        return s

    def sample(self, rec: dict) -> dict:
        """What the check keeps of a step: its outputs at the pixels."""
        return check.sample_outputs(rec["out"], self.pixels,
                                    self.width * self.height * self.samples)

    # ---- the reference's side ----

    def reference_base(self):
        """The reference's scene as the configuration loads it."""
        if self._ref_data is None:
            self._ref_data = self.generator.reference_data(self.config)
        return self.generator.reference_scene(self.config, self._ref_data,
                                              self.samples)

    @property
    def engine_params(self):
        e = self.config["engine"]
        return e["chunk_pixels"], e["queue_factor"]

    def reference(self, state, dtype=None) -> dict:
        """The reference's outputs at the pixels in ``state``, at ``dtype``
        (float64 unless given)."""
        import torch
        from .reference.render import render_pixels
        chunk, qf = self.engine_params
        return render_pixels(self.reference_scene(state), self.pixels,
                             self.seed, chunk, qf,
                             dtype=dtype or torch.float64,
                             device=self.device)

    def check(self, kept, steps) -> dict:
        """The check's numbers: the kept (state, sample) pairs against the
        reference in each state (rendered once per state), and the rays
        that every step dropped."""
        refs, pairs = {}, []
        for state, prog in kept:
            if state not in refs:
                refs[state] = self.reference(state)
            pairs.append((prog, refs[state]))
        if not pairs:
            return {}
        return check.compare(pairs, sum(s["dropped"] for s in steps))

    def trace_info(self) -> dict:
        """The configuration's counts that the traced run's readers use:
        triangles, chunks of a frame, samples, levels of the ray tree."""
        from .reference.render import frame_levels
        ref = self.reference_base()
        n = self.width * self.height
        return dict(n_tris=sum(len(it.tris) for it in ref.items
                               if it.tris is not None),
                    n_chunks=-(-n // min(self.engine_params[0], n)),
                    samples=self.samples, n_levels=frame_levels(ref))
