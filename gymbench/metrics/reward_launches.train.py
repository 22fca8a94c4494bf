"""Device operations launched per env step by the reward terms: those
whose launching runtime call lies in an env.reward span, per span, rounded
up as trace.per_call does."""

from gymbench import spans


def read(run):
    return spans.launches_per_span(run.trace, "env.reward")
