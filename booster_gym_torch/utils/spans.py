"""Profiler spans at the layer boundaries of the training step.

span(name) is torch.profiler.record_function(name) while a torch.profiler
session records on this thread, and one shared null context otherwise, so
an untraced step pays one C call per span.  The spans sit on kineto's
clock beside the device records, so a trace places every kernel launch
and every idle gap of the device inside the span that was running on the
host.  A span never reads a device value.

The names, nested as the training step runs them:

    ppo.iteration        PPO.train_iteration
      ppo.rollout        PPO.rollout
        ppo.act          network.act and the noise draw, each control step
        env.step         T1.step
          env.graph         on one card, the step's CUDA graphs: the inputs copied in,
                            the five parts below replayed, the outputs copied out
          env.physics       the actions, the control step (K1 or K5) and its unpacking
          env.post_physics  root terrain height, post-physics refresh, counters,
                            kicks, pushes, termination
          env.reward        the reward terms
          env.reset         resets and curriculum, teleport, the trimesh terrain
                            fix, command resampling, the post-reset refresh
          env.observe       observations and the last_* bookkeeping
        ppo.episode_stats  episode sums, counts and buffer appends, each step
      ppo.update         PPO.update, both backends
        ppo.gae          the fused backend's K2 (values, GAE, advantage sums), each mini-epoch
        ppo.grads        its K3 (gradients and loss sums), each mini-epoch
        ppo.opt          its K4 (clip, Adam, staged weights), each mini-epoch

and at set-up, outside the iteration:

    env.bank             T1Standup's bank of settled fallen states, in init_params
"""

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name, args=None):
    """A profiler span called `name` (with the string `args`, if given)
    while a profiler records; the shared null context otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name, args)
