"""Device operations launched per control step by the rollout's
bookkeeping (episode sums and counts, buffer appends): those whose
launching runtime call lies in a ppo.episode_stats span, per span, rounded
up as trace.per_call does."""

from gymbench import spans


def read(run):
    return spans.launches_per_span(run.trace, "ppo.episode_stats")
