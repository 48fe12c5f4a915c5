"""Idle milliseconds of the device per traced step while the host was in
``render_loss_and_grad``'s own stages (the ``grad`` and ``grad.*`` spans:
a chunk's forward set-up and loss, its backward's glue, the sums over the
world) and no host op covered the gap: the gradient path's host work that
the device waits for."""
from perfbench import spangaps


def read(trace):
    return spangaps.idle_ms(trace, "grad")
