"""Device operations (kernels, copies, fills) launched per rollout in the
profiled iterations: those whose launching runtime call lies in a
phase_rollout span, per iteration, rounded up as trace.per_call does for
the records a trace drops."""

from gymbench import trace


def read(run):
    t = run.trace
    if t is None:
        return None
    spans = t.spans("phase_rollout")
    if not spans:
        return None
    return trace.per_call(len(t.launched_in(spans)) / len(spans))
