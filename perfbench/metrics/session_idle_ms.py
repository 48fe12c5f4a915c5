"""Idle milliseconds of the device per traced step under the session's
spans (``session.*``: frame set-up, scene update, compile with its BVH
builds, upload) where no host op covered the gap: the scene work of an
animation frame that the device waits for."""
from perfbench import spangaps


def read(trace):
    return spangaps.idle_ms(trace, "session")
