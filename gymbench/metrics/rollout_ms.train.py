"""Mean milliseconds of an iteration's rollout over every iteration of the
traced window: CUDA events at train_iteration's timer hook (rollout, then
update)."""


def read(run):
    if not run.phases:
        return None
    return sum(r for r, _ in run.phases) / len(run.phases)
