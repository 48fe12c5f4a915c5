"""Mean over the profiled steps of the backward passes' device time per
gradient step, in ms: ``render_loss_and_grad``'s ``grad_stats
["backward_ms"]`` over the step, CUDA events at the ``grad.backward``
span's ends (autograd through the shading ops and ``selected_t``'s VJP).
None where the program keeps no such clock or ran on no card."""


def read(trace):
    vals = [s["bwd_ms"] for s in trace.steps if s.get("bwd_ms") is not None]
    if not vals:
        return None
    return sum(vals) / len(vals)
