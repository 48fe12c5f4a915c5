"""Window milliseconds per completed edit: in a closed loop of one user
with no think time, the mean time from an edit to its image on the
host."""


def reduce(steps, window_s, loop):
    return window_s / len(steps) * 1e3
