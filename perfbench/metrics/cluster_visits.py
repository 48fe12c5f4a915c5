"""Mean clusters per block visit list of the run's block walks, both modes:
the census's ``entries`` over its ``blocks``
(``rustray_tpu_torch.ops.block_trace.census``), counted in the program
eagerly and under graph replay alike, over every walk of the run, set-up
included.  An upper bound on the clusters a ray block visits (the walk
stops early); it moves with the scene's clusters and the rays' coherence,
and so with the traversal's work.  Read from the program loaded in this
process; None where it has no census or walked no block."""
import sys


def read(trace):
    bt = sys.modules.get("rustray_tpu_torch.ops.block_trace")
    census = getattr(bt, "census", None)
    if not census:
        return None
    blocks = sum(c["blocks"] for c in census.values())
    if blocks <= 0:
        return None
    return sum(int(c["entries"]) for c in census.values()) / blocks
