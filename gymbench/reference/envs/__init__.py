"""The reference envs, by task.  Every module of this package that declares
TASKS, a dict from task name to its env class (as the program's own
registry has it), is found here: a new task's reference is one new module
beside t1.py, and nothing else changes.

A reference env class supplies, besides init_params, reset_all and step:

  State, Params      its dataclasses; the program's state and params are
                     converted into them field by field, by name
  STATE_FIELDS       the state's fields that a step compares, besides sim's
  obs_sigmas()       the observation noise's sigma per column of (obs,
                     privileged obs), 0 where a column is noise-free
  noise_free_obs(params, state)
                     its observations of a state with the noise left out
  reset_terms(s, r)  what a reset fixes whatever its random draws
  own_params()       the params it makes itself from the seed rather than
                     take from the program (the env origins, the terrain)
"""

import functools
import importlib
import pkgutil


@functools.cache
def tasks():
    """{task name: reference env class} over this package's modules."""
    found = {}
    for mod in pkgutil.iter_modules(__path__):
        declared = getattr(importlib.import_module(f"{__name__}.{mod.name}"), "TASKS", {})
        for name, cls in declared.items():
            if name in found and found[name] is not cls:
                raise ValueError(f"task {name} is declared twice, the second time in "
                                 f"{mod.name}")
            found[name] = cls
    return found


def env_class(cfg):
    """The reference env class of a config: basic.env_class, else
    basic.task, as the program picks its own."""
    name = cfg["basic"].get("env_class") or cfg["basic"]["task"]
    known = tasks()
    if name not in known:
        raise KeyError(f"the benchmark has no reference env for task {name}; "
                       f"known: {sorted(known)}")
    return known[name]
