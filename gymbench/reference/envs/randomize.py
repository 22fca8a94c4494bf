"""Declarative randomization (port of booster_gym_tpu/envs/randomize.py).

A spec is {range, operation, distribution} read from config; None is a
no-op.  gaussian: noise = mu + sigma * N(0, 1); uniform: noise = lo +
(hi - lo) * U(0, 1); additive: x + noise; scaling: x * noise.  With
return_noise the unit draw is returned too (the privileged observation
stores it).  Under a data-parallel Group, x holds the rank's rows of the
env batch and the unit draw is the global batch's, sliced (Group.draw)."""

import torch


def apply_randomization(gen, tensor, params, return_noise=False, group=None):
    if params is None:
        if return_noise:
            return tensor, torch.zeros_like(tensor)
        return tensor

    dist = params["distribution"]
    a, b = params["range"]
    if dist == "gaussian":
        noise = _draw(torch.randn, gen, tensor, group)
        noise_val = a + b * noise
    elif dist == "uniform":
        noise = _draw(torch.rand, gen, tensor, group)
        noise_val = a + (b - a) * noise
    else:
        raise ValueError(f"Invalid randomization distribution: {dist}")

    op = params["operation"]
    if op == "additive":
        result = tensor + noise_val
    elif op == "scaling":
        result = tensor * noise_val
    else:
        raise ValueError(f"Invalid randomization operation: {op}")

    if return_noise:
        return result, noise
    return result


def _draw(fn, gen, tensor, group):
    if group is None:
        return fn(tensor.shape, generator=gen, device=tensor.device)
    return group.draw(fn, gen, tensor.shape, device=tensor.device)
