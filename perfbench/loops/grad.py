"""``grad``: inverse rendering, one client in a closed loop.  Set-up renders
the "photograph" with ``render()`` at the scene's true parameters (the
file's ``target`` samples, seed ``seed + 1``), then moves the optimised
leaves (the file's ``perturb``: materials' base colour, roughness and
reflectivity, lights' colour and intensity) by offsets drawn from the
seed.  Step i takes ``render_loss_and_grad`` of the frame against the
photograph at ``samples_per_frame`` samples with engine seed ``seed · 1000
+ i`` (a fresh sample pattern each step) and its image, then one Adam step
on the optimised leaves, written in place into the scene's tensors and
clamped.  The camera is not optimised, but its leaves are differentiated
as every call does.

The check, after the window, for each kept step i at its parameters and
seed: the program's image against the reference's at the compared pixels
S (``color_p99``, ``color_bad_pct``); the program's gradient of the loss
restricted to S (``pixel_weight`` 1 on S) against the reference's float64
gradient of the same loss over the optimised leaves (``grad_rel_err``, a
relative L2 error); and the gradients with weights 1 on S and 1 off S,
which must add up to the timed step's own full-frame gradient
(``grad_split_rel``), so the compared numbers are tied to what the timed
path produced.  ``dropped``: rays every step dropped (limit 0)."""
from __future__ import annotations

import dataclasses

import numpy as np

from .. import check as frame_check
from .. import loop as base


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


class Loop(base.Loop):
    def __init__(self, *args):
        super().__init__(*args)
        self.leaves = [tuple(k.split(".")) for k in self.traffic["perturb"]]
        self.params = {}

    # ---- the program's side ----

    def setup(self):
        import torch
        from rustray_tpu_torch.parallel import shard
        from rustray_tpu_torch.render import wavefront
        from rustray_tpu_torch.scene_arrays import to_torch
        self._shard = shard
        sess = self.session(self.scene_file(), animate=False)
        scene = sess.scene
        self.sa, self.static = to_torch(*scene.compile(self.width,
                                                       self.height),
                                        self.device)
        self.cfg = scene.raytracing_config
        del sess
        t = self.traffic["target"]
        photo = wavefront.render(
            self.sa, self.static,
            dataclasses.replace(self.cfg, samples=int(t["samples"])),
            dataclasses.replace(self.engine(), seed=self.seed + 1,
                                samples_per_dispatch=int(
                                    t["samples_per_dispatch"])))
        self.target = photo["color"].reshape(-1, 3)
        # the photograph's graphs hold memory the gradient needs
        wavefront._RENDERER_CACHE.clear()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        rng = np.random.Generator(np.random.PCG64([self.seed, 37]))
        for key, spec in self.traffic["perturb"].items():
            leaf = self.leaf(key)
            now = leaf.detach().cpu().numpy()
            if "times" in spec:
                new = now * rng.uniform(*spec["times"], now.shape)
            else:
                new = now + rng.uniform(*spec["plus"], now.shape)
            leaf.copy_(torch.as_tensor(new.astype(np.float32)))
        self.clamp()
        self.adam = {k: [torch.zeros_like(self.leaf(k)),
                         torch.zeros_like(self.leaf(k))]
                     for k in self.traffic["perturb"]}
        self.n_adam = 0
        self.rows = self.material_rows()
        self.step(-1)

    def leaf(self, key: str):
        grp, field = key.split(".")
        return getattr(getattr(self.sa, grp), field)

    def clamp(self):
        for key, spec in self.traffic["perturb"].items():
            lo, hi = spec["clamp"]
            self.leaf(key).clamp_(min=lo, max=hi)

    def material_rows(self):
        """The program's material row of each of the reference's
        materials, by the object ids of the items that use them."""
        ids = self.sa.inst_obj_id.cpu().numpy()
        mats = self.sa.inst_mat.cpu().numpy()
        rows = {}
        for it in self.reference_base().items:
            rows[it.material] = int(mats[np.nonzero(ids == it.obj_id)[0][0]])
        return [rows[m] for m in range(len(rows))]

    def engine_at(self, i: int):
        return dataclasses.replace(self.engine(), seed=self.seed * 1000 + i)

    def state(self, i: int):
        return i

    def apply(self, i: int):
        """Keep the parameters that step i differentiates at."""
        self._i = i
        self.params[i] = {k: self.leaf(k).detach().cpu().numpy().copy()
                          for k in self.traffic["perturb"]}

    def render(self):
        import torch
        shard = self._shard
        stats = getattr(shard, "grad_stats", None)
        before = dict(stats) if stats else None
        d0 = shard.dropped["rays"]
        _, grads, color = shard.render_loss_and_grad(
            self.sa, self.static, self.cfg, self.target,
            self.engine_at(self._i), return_color=True)
        self.adam_step(grads)
        out = dict(color=color, dropped=shard.dropped["rays"] - d0,
                   grad=self.flat(grads), fwd_ms=None, bwd_ms=None)
        # device clocks: on the card only
        if stats and torch.device(self.device).type == "cuda":
            out.update(fwd_ms=stats["forward_ms"] - before["forward_ms"],
                       bwd_ms=stats["backward_ms"] - before["backward_ms"])
        return out, {}

    def adam_step(self, grads):
        """One Adam step on the optimised leaves, in place, then clamped."""
        import torch
        a = self.traffic["adam"]
        self.n_adam += 1
        b1, b2 = a["beta1"], a["beta2"]
        with torch.no_grad():
            for key, (m, v) in self.adam.items():
                grp, field = key.split(".")
                g = grads[grp][field]
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                mh = m / (1.0 - b1 ** self.n_adam)
                vh = v / (1.0 - b2 ** self.n_adam)
                self.leaf(key).sub_(a["lr"] * mh / (vh.sqrt() + a["eps"]))
        self.clamp()

    def flat(self, grads) -> np.ndarray:
        """The optimised leaves' gradients as one float64 vector."""
        return np.concatenate([grads[g][f].detach().double().cpu().numpy()
                               .reshape(-1) for g, f in self.leaves])

    def set_params(self, state):
        import torch
        for key, v in self.params[state].items():
            self.leaf(key).copy_(torch.as_tensor(v))

    def grads_at(self, state, inside: bool) -> np.ndarray:
        """The program's gradient at step ``state``'s parameters and seed
        of the loss weighted 1 on the compared pixels (``inside``) or 1
        off them."""
        self.set_params(state)
        w = np.zeros(self.width * self.height, np.float32)
        w[self.pixels] = 1.0
        _, grads = self._shard.render_loss_and_grad(
            self.sa, self.static, self.cfg, self.target,
            self.engine_at(state), pixel_weight=w if inside else 1.0 - w)
        return self.flat(grads)

    # ---- what is kept of a step ----

    def summary(self, rec: dict) -> dict:
        out = rec["out"]
        return dict(seconds=rec["seconds"], dropped=int(out["dropped"]),
                    fwd_ms=out.get("fwd_ms"), bwd_ms=out.get("bwd_ms"))

    def sample(self, rec: dict) -> dict:
        out = rec["out"]
        return dict(color=out["color"].double().cpu().numpy()[self.pixels],
                    grad=out["grad"])

    # ---- the reference's side ----

    def reference_scene(self, state):
        """The reference's scene at step ``state``'s parameters (the
        program's float32 values, widened)."""
        ref = self.reference_base()
        p = {k: v.astype(np.float64) for k, v in self.params[state].items()}
        for m, row in enumerate(self.rows):
            mat = ref.materials[m]
            mat.base = p["materials.base_color"][row]
            mat.roughness = float(p["materials.roughness"][row])
            mat.reflectivity = float(p["materials.reflectivity"][row])
        for li, light in enumerate(ref.lights):
            light.color = p["lights.color"][li]
            light.intensity = float(p["lights.intensity"][li])
        return ref

    def reference(self, state, dtype=None) -> dict:
        """The reference's colour at the compared pixels and its gradient
        of the loss over them, in the program's layout (float64 unless
        ``dtype``)."""
        import torch
        from ..reference.grad import loss_and_grad
        chunk, qf = self.engine_params
        r = loss_and_grad(self.reference_scene(state), self.pixels,
                          self.target[self.pixels], self.seed * 1000 + state,
                          chunk, qf, dtype=dtype or torch.float64,
                          device=self.device)
        parts = []
        for g, f in self.leaves:
            v = r["grads"][(g, f)]
            if g == "materials":
                full = np.zeros_like(self.params[state][f"{g}.{f}"],
                                     np.float64)
                full[self.rows] = v
                v = full
            parts.append(v.reshape(-1))
        return dict(color=r["color"], grad=np.concatenate(parts))

    def check(self, kept, steps) -> dict:
        if not kept:
            return {}
        import torch
        states = sorted({s for s, _ in kept})
        inside = {s: self.grads_at(s, True) for s in states}
        split = {s: inside[s] + self.grads_at(s, False) for s in states}
        del self.sa, self.static
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        refs = {s: self.reference(s) for s in states}
        col, rel, spl = [], [], []
        for state, prog in kept:
            col.append(np.abs(prog["color"] - refs[state]["color"]).max(1))
            rel.append(_rel(inside[state], refs[state]["grad"]))
            spl.append(_rel(split[state], prog["grad"]))
        col = np.concatenate(col)
        return {"color_p99": float(np.percentile(col, 99)),
                "color_bad_pct": float((col > frame_check.BAD_COLOR).mean()
                                       * 100.0),
                "grad_rel_err": max(rel), "grad_split_rel": max(spl),
                "dropped": int(sum(s["dropped"] for s in steps))}

    def release(self):
        """The scene stays: the check takes the program's gradients."""
