"""Idle milliseconds of the device per traced step under the chunk
program's spans (``chunk.dispatch``: host keys, uploads and graph replays
or the eager run; ``chunk.capture``) where no host op covered the gap."""
from perfbench import spangaps


def read(trace):
    return spangaps.idle_ms(trace, "chunk")
