"""Per cent of live hits shaded that spawn a refraction child because
their alpha (the material's times the base-colour texel's) is below 1:
the shading census's ``cutout`` over its ``hits``
(``rustray_tpu_torch.render.wavefront.shading``), every level, over every
frame of the run, set-up included.  On an alpha-cut scene these are the
pass-through rays of cut-out texels, each a ray more for the next level.
Read from the program loaded in this process; None where it has no
shading census or shaded no hit."""
import sys


def read(trace):
    wf = sys.modules.get("rustray_tpu_torch.render.wavefront")
    census = getattr(wf, "shading", None)
    if not census or int(census["hits"]) <= 0:
        return None
    return 100.0 * int(census["cutout"]) / int(census["hits"])
