"""Idle milliseconds of the device per traced step while the host was in
``render()``'s own stages (the ``render`` and ``render.*`` spans: prepare,
bind, fingerprint, group, fetch, re-render, finish) and no host op covered
the gap: the frame path's host work that the device waits for."""
from perfbench import spangaps


def read(trace):
    return spangaps.idle_ms(trace, "render")
