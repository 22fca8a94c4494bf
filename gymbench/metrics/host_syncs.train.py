"""Host syncs per iteration in the profiled iterations: the runtime calls
that block until the device catches up (gymbench/spans.py SYNC_CALLS)
starting inside a ppo.iteration span, per span."""

from gymbench import spans


def read(run):
    got = spans.syncs_in(run.trace, "ppo.iteration")
    if got is None:
        return None
    syncs, n = got
    return len(syncs) / n
