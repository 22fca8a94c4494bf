"""Task registry (the T1 walk task is the only ported task)."""

from booster_gym_torch.envs.t1 import T1

TASKS = {"T1": T1}


def make_task(cfg, device):
    name = cfg["basic"].get("env_class") or cfg["basic"]["task"]
    if name not in TASKS:
        raise KeyError(f"Unknown or unported task {name}; ported: {sorted(TASKS)}")
    return TASKS[name](cfg, device=device)


__all__ = ["T1", "TASKS", "make_task"]
