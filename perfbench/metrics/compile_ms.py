"""Mean over the profiled steps of the session's scene compile and upload
(``RenderSession.stats.last_compile_seconds``), in ms."""


def read(trace):
    vals = [s["compile_s"] for s in trace.steps if "compile_s" in s]
    if not vals:
        return None
    return 1e3 * sum(vals) / len(vals)
