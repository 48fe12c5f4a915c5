"""Window seconds per completed animation frame."""


def reduce(steps, window_s, loop):
    return window_s / len(steps)
