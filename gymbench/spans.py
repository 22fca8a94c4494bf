"""The program's spans in a trace.Trace, for the readers of metrics/ that
read them.  The program (booster_gym_torch/utils/spans.py) opens a span
at each layer boundary of the training step while a profiler records:
ppo.iteration, and inside it ppo.rollout (ppo.act, env.step and its
parts, ppo.episode_stats) and ppo.update.  A trace of a program without
them holds none, and every function here then returns None.

A host sync is a runtime call that returns only once the device has
caught up: one of SYNC_CALLS (CUPTI may add a version, as in _v3020).
"""

import re

from gymbench import trace

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def is_sync(name):
    return re.sub(r"_v\d+$", "", name) in SYNC_CALLS


def named(t, name):
    """The host spans called exactly `name`, or None without a trace or
    such a span."""
    if t is None:
        return None
    spans = [s for s in t.spans(name) if s[0] == name]
    return spans or None


def launches_per_span(t, name):
    """Device operations launched inside the `name` spans, per span,
    rounded up as trace.per_call does; None without the span."""
    spans = named(t, name)
    if spans is None:
        return None
    return trace.per_call(len(t.launched_in(spans)) / len(spans))


def syncs_in(t, name):
    """(the host syncs starting inside the `name` spans as (name, start,
    end), the number of spans); None without the span."""
    spans = named(t, name)
    if spans is None:
        return None
    ivs = sorted((a, b) for _, a, b in spans)
    inside = [h for h in t.host if is_sync(h[0])
              and any(a <= h[1] <= b for a, b in ivs)]
    return inside, len(spans)
