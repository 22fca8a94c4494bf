"""Task registry: T1 (the walk task), T1Serial (the same class on the
23-DoF serial robot; its config widens observations and actions) and
T1Standup (fall recovery on the serial robot).  basic.env_class lets a
config of its own (T1StandupFT, the standup fine-tune stage) reuse a
registered class: --task picks the config, env_class the class."""

from booster_gym_torch.envs.standup import T1Standup
from booster_gym_torch.envs.t1 import T1

TASKS = {"T1": T1, "T1Serial": T1, "T1Standup": T1Standup}


def make_task(cfg, device, group=None):
    """The task's env on `device`; under a data-parallel Group its rows of
    the batch (booster_gym_torch/parallel)."""
    name = cfg["basic"].get("env_class") or cfg["basic"]["task"]
    if name not in TASKS:
        raise KeyError(f"Unknown task {name}; known: {sorted(TASKS)}")
    return TASKS[name](cfg, device=device, group=group)


__all__ = ["T1", "T1Standup", "TASKS", "make_task"]
