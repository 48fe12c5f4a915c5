"""Per cent of the profiled slice's wall time in which no operation ran on
the device: 100 · (1 - busy / window), busy the union of the device's
kernel, copy and memset intervals."""


def read(trace):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
