"""Mean milliseconds of an iteration's update (its mini-epochs) over every
iteration of the traced window: CUDA events at train_iteration's timer hook
(update, then end)."""


def read(run):
    if not run.phases:
        return None
    return sum(u for _, u in run.phases) / len(run.phases)
