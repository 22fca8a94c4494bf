"""Host milliseconds per iteration inside the host syncs of
host_syncs.train: the summed durations of the blocking runtime calls that
start inside a ppo.iteration span, per span."""

from gymbench import spans


def read(run):
    got = spans.syncs_in(run.trace, "ppo.iteration")
    if got is None:
        return None
    syncs, n = got
    return sum(b - a for _, a, b in syncs) / 1e6 / n
