"""Median over the profiled steps of ``render()``'s wall time
(``RenderSession.stats.last_render_seconds``) less the device's busy time
within the step, in ms: the frame path's host work that the device does
not hide.  A steady statistic beside the edit loop's tail."""
import statistics


def read(trace):
    vals = [s["render_s"] - s["busy_s"] for s in trace.steps
            if "render_s" in s and "busy_s" in s]
    if not vals:
        return None
    return 1e3 * statistics.median(vals)
