"""``still_pbr``: the ``still`` loop (an offline render accumulated in
jittered groups of samples) on a scene whose materials carry the glTF
maps: its check renders with the reference that shades them
(``reference/pbr.py``) in place of ``reference/render.py``."""
from __future__ import annotations

from . import still


class Loop(still.Loop):
    def reference(self, state, dtype=None) -> dict:
        import torch
        from ..reference.pbr import render_pixels
        chunk, qf = self.engine_params
        return render_pixels(self.reference_scene(state), self.pixels,
                             self.seed, chunk, qf,
                             dtype=dtype or torch.float64,
                             device=self.device)

    def trace_info(self) -> dict:
        from ..reference.pbr import frame_levels
        ref = self.reference_base()
        n = self.width * self.height
        return dict(n_tris=sum(len(it.tris) for it in ref.items
                               if it.tris is not None),
                    n_chunks=-(-n // min(self.engine_params[0], n)),
                    samples=self.samples, n_levels=frame_levels(ref))
