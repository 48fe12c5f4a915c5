"""Primary rays (width · height · samples of every completed frame) per
second of the window, in millions."""


def reduce(steps, window_s, loop):
    rays = len(steps) * loop.width * loop.height * loop.samples
    return rays / window_s / 1e6
