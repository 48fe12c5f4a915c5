"""Texture fetches per live hit shaded: the shading census's ``fetches``
over its ``hits`` (``rustray_tpu_torch.render.wavefront.shading``), every
level, counted in the program eagerly and under graph replay alike, over
every frame of the run, set-up included.  A fetch is one channel's
bilinear lookup that found a map on the hit's material, so a scene whose
materials all carry base-colour, normal and metallic-roughness maps reads
4 (the metallic-roughness image is two grey maps).  Read from the program
loaded in this process; None where it has no shading census or shaded no
hit."""
import sys


def read(trace):
    wf = sys.modules.get("rustray_tpu_torch.render.wavefront")
    census = getattr(wf, "shading", None)
    if not census or int(census["hits"]) <= 0:
        return None
    return int(census["fetches"]) / int(census["hits"])
