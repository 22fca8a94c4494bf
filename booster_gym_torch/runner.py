"""Training runner (port of the train() loop of booster_gym_tpu/runner.py).

Builds the task and the PPO trainer on one device, loops over train
iterations, logs and checkpoints.  On a CUDA device every iteration is
timed with CUDA events (rollout, update, whole iteration); on the CPU with
the host clock.
"""

import random
import time

import numpy as np
import torch

from booster_gym_torch.algo.ppo import PPO
from booster_gym_torch.envs import make_task
from booster_gym_torch.utils.recorder import Recorder


def resolve_device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


class _Timer:
    """Marks phase boundaries of one iteration: CUDA events on a GPU (read
    after the device has passed them), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = {}

    def __call__(self, name):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks[name] = ev
        else:
            self.marks[name] = time.perf_counter()

    def ms(self, a, b):
        if self.cuda:
            self.marks[b].synchronize()
            return self.marks[a].elapsed_time(self.marks[b])
        return 1e3 * (self.marks[b] - self.marks[a])


class Runner:
    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg["basic"].get("checkpoint"):
            raise NotImplementedError("resuming from a checkpoint is not ported yet")
        seed = cfg["basic"]["seed"]
        if seed == -1:
            seed = np.random.randint(0, 10000)
            cfg["basic"]["seed"] = seed
        print(f"Setting seed: {seed}")
        random.seed(seed)
        np.random.seed(seed)
        self.seed = seed
        self.env = make_task(cfg, self.device)
        self.ppo = PPO(self.env, cfg, self.device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def _checkpoint_dict(self, ts):
        cpu = lambda t: t.detach().cpu()
        return {
            "params": {k: cpu(v) for k, v in self.ppo.network.state_dict().items()},
            "adam_m": cpu(ts.opt.m), "adam_v": cpu(ts.opt.v), "adam_count": ts.opt.count,
            "lr": float(ts.lr), "iteration": ts.iteration,
            "curriculum": cpu(ts.env_state.curriculum_prob),
        }

    def _kernel_launches(self):
        fused = self.ppo.fused
        count = lambda kernel: 0 if kernel is None else kernel.launches
        sub = self.env.substep
        return {"substep_kernel_launches": count(sub),
                "terrain_sampler_launches": count(self.env.terrain_sampler),
                "fused_sampler_launches": 0 if sub is None else sub.fused_sampler_launches,
                "gae_launches": fused.gae_launches,
                "grads_stats_launches": fused.grads_stats_launches,
                "opt_stage_launches": fused.opt_stage_launches}

    def train(self):
        """Run max_iterations train iterations; returns one record per
        iteration (metrics as floats plus rollout_ms, update_ms, iter_ms,
        env_steps_per_sec and the CUDA kernels' launches in the iteration,
        all 0 on the CPU: substep_kernel_launches for K1 on the plane or K5
        on trimesh, one per control step (the decimation loop is one
        launch), terrain_sampler_launches for the standalone trimesh
        sampler (0 on the env's path), fused_sampler_launches for the
        control steps whose epilogue sampled the terrain (K6 + K7 in K5's
        launch), and gae_launches, grads_stats_launches and opt_stage_launches for the
        fused update's K2, K3 and K4)."""
        recorder = Recorder(self.cfg)
        env_params, ts = self.ppo.init(self.gen)
        max_iterations = self.cfg["basic"]["max_iterations"]
        save_interval = self.cfg["runner"]["save_interval"]
        steps_per_iter = self.cfg["runner"]["horizon_length"] * self.env.num_envs
        records = []
        for it in range(max_iterations):
            timer = _Timer(self.device)
            launches0 = self._kernel_launches()
            ts, metrics = self.ppo.train_iteration(env_params, ts, self.gen, timer)
            names = list(metrics)
            values = torch.stack([metrics[k].float() for k in names]).tolist()
            rec = dict(zip(names, values))
            rec["rollout_ms"] = timer.ms("rollout", "update")
            rec["update_ms"] = timer.ms("update", "end")
            rec["iter_ms"] = timer.ms("rollout", "end")
            rec["env_steps_per_sec"] = steps_per_iter / (rec["iter_ms"] / 1e3)
            for name, count in self._kernel_launches().items():
                rec[name] = count - launches0[name]
            records.append(rec)
            if not all(np.isfinite(v) for v in values):
                bad = [k for k, v in zip(names, values) if not np.isfinite(v)]
                raise FloatingPointError(f"non-finite metrics at iteration {it + 1}: {bad}")
            if (it + 1) % 10 == 0 or it == 0 or it + 1 == max_iterations:
                recorder.record_statistics(rec, it)
                print(f"epoch: {it + 1}/{max_iterations} reward={rec['reward']:.3f} "
                      f"iter={rec['iter_ms']:.1f}ms (rollout {rec['rollout_ms']:.1f}, "
                      f"update {rec['update_ms']:.1f}) steps/s={rec['env_steps_per_sec']:,.0f}")
            if (it + 1) % save_interval == 0:
                recorder.save(self._checkpoint_dict(ts), it + 1)
        recorder.save(self._checkpoint_dict(ts), max_iterations)
        self.train_state = ts
        return records
