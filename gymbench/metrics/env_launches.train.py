"""Device operations (kernels, copies, fills) launched per env step in the
profiled iterations: those whose launching runtime call lies in an
env.step span, per span, rounded up as trace.per_call does."""

from gymbench import spans


def read(run):
    return spans.launches_per_span(run.trace, "env.step")
