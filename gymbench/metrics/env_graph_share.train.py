"""The share of env steps replayed as CUDA graphs in the profiled
iterations: env.graph spans over env.step spans.  0 where every step runs
op by op (env.step spans and no env.graph span, as in a program without
the graphs); None without an env.step span or a trace."""

from gymbench import spans


def read(run):
    steps = spans.named(run.trace, "env.step")
    if steps is None:
        return None
    return len(spans.named(run.trace, "env.graph") or []) / len(steps)
