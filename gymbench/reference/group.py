"""The env batch of one process: the world-size-1 case of
booster_gym_torch's parallel.Group, which the env's random draws and row
selections go through."""

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Group:
    num_envs: int
    device: torch.device
    world: int = 1
    rank: int = 0

    @property
    def local_envs(self):
        return self.num_envs

    def rows(self, x):
        return x

    def draw(self, fn, gen, shape, *args, device=None):
        device = self.device if device is None else device
        return fn(*args, tuple(shape), generator=gen, device=device)

    def all_reduce(self, x, op="sum"):
        return x
