"""The device's idle share over the profiled iterations, in percent: 1 -
the union of the device's operation intervals over the traced wall."""

from gymbench import trace


def read(run):
    share = trace.idle_share(run.trace)
    return None if share is None else 100.0 * share
