"""Training and evaluation runner (port of booster_gym_tpu/runner.py).

Builds the task and the PPO trainer, loops over train iterations, logs and
checkpoints; resumes from the port's checkpoints and the JAX package's
pickle checkpoints (basic.checkpoint), and plays a policy.  On a CUDA
device every iteration is timed with CUDA events (rollout, update, whole
iteration); on the CPU with the host clock.

Data parallelism, the JAX runner's mesh: where the environment configures
a process group (torchrun, or booster_gym_torch.train's own launcher),
this process is one rank of it and trains its slice of the env batch
(booster_gym_torch/parallel), unless basic.data_parallel is false.  Rank 0
alone writes the run's directory, records and checkpoints, and every rank
waits for each save; on resume every rank loads the same checkpoint.  The
metrics are the all-reduced ones, the times and launch counts this rank's.
play runs on the same group, and rank 0 gathers the trajectory.
"""

import os
import random
import time

import numpy as np
import torch

from booster_gym_torch.algo.ppo import PPO, OptState
from booster_gym_torch.convert import train_state_from_jax_checkpoint
from booster_gym_torch.envs import make_task
from booster_gym_torch.parallel import (
    Group,
    default_backend,
    initialize_distributed,
    process_group,
    rank_device,
)
from booster_gym_torch.utils.recorder import Recorder, load_checkpoint, resolve_checkpoint


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


def build_group(cfg, device):
    """The JAX runner's initialize_distributed and _build_mesh: this
    process's rank of the process group the environment configures, on
    cuda:(LOCAL_RANK % device count) for a CUDA device, over nccl where each
    rank has a card and gloo otherwise; a group of its own where nothing is
    configured or under basic.data_parallel: false."""
    num_envs = cfg["env"]["num_envs"]
    if (cfg["basic"].get("data_parallel", True) is False
            or not initialize_distributed(default_backend(device))):
        return Group(num_envs, device)
    return process_group(num_envs, rank_device(device))


class Runner:
    def __init__(self, cfg, device="cuda", group=None):
        """`group`: this rank's data-parallel Group; by default the one the
        environment configures (build_group)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.group = build_group(cfg, self.device) if group is None else group
        self.device = self.group.device
        self.rank0 = self.group.rank == 0
        ckpt = cfg["basic"].get("checkpoint")
        self.checkpoint = resolve_checkpoint(ckpt) if ckpt else None
        seed = cfg["basic"]["seed"]
        if seed == -1:
            seed = int(self.group.broadcast(torch.tensor(
                [np.random.randint(0, 10000)], device=self.device))[0])
            cfg["basic"]["seed"] = seed
        self._print(f"Setting seed: {seed}")
        random.seed(seed)
        np.random.seed(seed)
        self.seed = seed
        self.env = make_task(cfg, self.device, self.group)
        self.ppo = PPO(self.env, cfg, self.device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def _print(self, *args):
        if self.rank0:
            print(*args, flush=True)

    def _init_state(self):
        """(env_params, TrainState): ppo.init from the generator seeded
        anew, then, under basic.checkpoint, each saved piece restored on its
        own as the JAX runner does (a piece that fails prints and keeps its
        init): params, Adam m/v/count, lr and iteration, the curriculum,
        and last the generator state, after init has drawn from it (a JAX
        checkpoint has none: the generator stays as the seed left it)."""
        self.gen.manual_seed(self.seed)
        env_params, ts = self.ppo.init(self.gen)
        if self.checkpoint is None:
            return env_params, ts
        self._print(f"Loading model from {self.checkpoint}")
        saved = load_checkpoint(self.checkpoint)
        jax_ckpt = "opt_state" in saved
        if jax_ckpt:
            saved = train_state_from_jax_checkpoint(self.ppo.network, saved)
        self.ppo.network.load_state_dict(saved["params"])

        def like(x, ref):
            if tuple(x.shape) != tuple(ref.shape):
                raise ValueError(f"shape {tuple(x.shape)}, expected {tuple(ref.shape)}")
            return x.to(device=ref.device, dtype=ref.dtype)

        try:
            opt = saved["opt"] if jax_ckpt else OptState(
                m=saved["adam_m"], v=saved["adam_v"], count=saved["adam_count"])
            ts.opt = OptState(m=like(opt.m, ts.opt.m), v=like(opt.v, ts.opt.v),
                              count=int(opt.count))
        except Exception as e:
            print(f"Failed to load optimizer: {e}")
        try:
            lr = torch.tensor(float(saved["lr"]), dtype=ts.lr.dtype, device=self.device)
            ts.lr, ts.iteration = lr, int(saved["iteration"])
        except Exception as e:
            print(f"Failed to load lr/iteration: {e}")
        try:
            ts.env_state = ts.env_state.replace(curriculum_prob=like(
                torch.as_tensor(saved["curriculum"]), ts.env_state.curriculum_prob))
        except Exception as e:
            print(f"Failed to load curriculum: {e}")
        try:
            if "gen_state" in saved:
                self.gen.set_state(saved["gen_state"])
        except Exception as e:
            print(f"Failed to load generator state: {e}")
        return env_params, ts

    def _checkpoint_dict(self, ts):
        cpu = lambda t: t.detach().cpu()
        return {
            "params": {k: cpu(v) for k, v in self.ppo.network.state_dict().items()},
            "adam_m": cpu(ts.opt.m), "adam_v": cpu(ts.opt.v), "adam_count": ts.opt.count,
            "lr": float(ts.lr), "iteration": ts.iteration,
            "curriculum": cpu(ts.env_state.curriculum_prob),
            "gen_state": self.gen.get_state(),
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
        fused update's K2, K3 and K4).  A resumed run starts at the saved
        iteration.  Under basic.profile (True or a directory) iterations
        start + 10 to start + 13 are traced by torch.profiler into a Chrome
        trace under <run>/profile or that directory; the trace carries the
        program's spans (utils/spans.py): ppo.iteration, ppo.rollout,
        ppo.act, env.step with env.physics, env.post_physics, env.reward,
        env.reset and env.observe, ppo.episode_stats and ppo.update.  Over several ranks
        the records hold the all-reduced metrics, env_steps_per_sec is the
        global batch's, the times and launches are this rank's; rank 0 alone
        records, saves and profiles."""
        recorder = Recorder(self.cfg) if self.rank0 else None
        env_params, ts = self._init_state()
        max_iterations = self.cfg["basic"]["max_iterations"]
        save_interval = self.cfg["runner"]["save_interval"]
        steps_per_iter = self.cfg["runner"]["horizon_length"] * self.env.global_envs
        profile_dir = self.cfg["basic"].get("profile") if self.rank0 else None
        if profile_dir is True:
            profile_dir = os.path.join(recorder.dir, "profile")
        start, prof, records = ts.iteration, None, []
        try:
            for it in range(start, max_iterations):
                if profile_dir and it == start + 10:
                    prof = self._start_profile()
                ts, rec = self._iteration(env_params, ts, steps_per_iter)
                records.append(rec)
                if prof is not None and it >= start + 13:
                    self._stop_profile(prof, profile_dir)
                    prof = None
                last = it + 1 == max_iterations
                if recorder is not None and ((it + 1) % 10 == 0 or it == start or last):
                    recorder.record_statistics(rec, it)
                    print(f"epoch: {it + 1}/{max_iterations} reward={rec['reward']:.3f} "
                          f"iter={rec['iter_ms']:.1f}ms (rollout {rec['rollout_ms']:.1f}, "
                          f"update {rec['update_ms']:.1f}) "
                          f"steps/s={rec['env_steps_per_sec']:,.0f}")
                if (it + 1) % save_interval == 0:
                    self._save(recorder, ts, it + 1)
        finally:
            if prof is not None:
                self._stop_profile(prof, profile_dir)
        self._save(recorder, ts, max_iterations)
        self.train_state = ts
        return records

    def _save(self, recorder, ts, it):
        """Rank 0 writes the checkpoint; every rank waits for it."""
        if recorder is not None:
            recorder.save(self._checkpoint_dict(ts), it)
        self.group.barrier()

    def _iteration(self, env_params, ts, steps_per_iter):
        """One train iteration: (TrainState, its record)."""
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
        if not all(np.isfinite(v) for v in values):
            bad = [k for k, v in zip(names, values) if not np.isfinite(v)]
            raise FloatingPointError(f"non-finite metrics at iteration {ts.iteration}: {bad}")
        return ts, rec

    def _start_profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof, profile_dir):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace written to {path}")

    @torch.no_grad()
    def play(self, num_steps=None, deterministic=True, timer=None):
        """Policy rollout from basic.checkpoint (JAX runner.py play) on the
        runner's group, as train runs: each rank steps its rows [lo, hi) of
        the env batch.  The action is the actor's mean, or mean + std *
        noise when not deterministic, the noise drawn at the global batch
        from the runner's generator and sliced (Group.draw); 10 s of
        control steps by default.  Rank 0 returns one dict per step of
        numpy arrays over the global batch in env order: root_pos,
        root_quat, q, rew, done (all-gathered after the last step); the
        other ranks return None.  `timer`, when given, is called as
        timer("steps") before the first step and timer("end") after the
        last, on this rank."""
        env_params, ts = self._init_state()
        state, obs = ts.env_state, ts.obs
        keys = ("root_pos", "root_quat", "q", "rew", "done")
        steps = {k: [] for k in keys}
        if timer:
            timer("steps")
        for _ in range(num_steps or 10 * int(1.0 / self.env.dt)):
            mu, std = self.ppo.network.act(obs)
            act = mu if deterministic else mu + std * self.group.draw(torch.randn, self.gen,
                                                                      mu.shape)
            state, obs, rew, done, _ = self.env.step(env_params, state, act, self.gen)
            for k, x in zip(keys, (state.sim.root_pos, state.sim.root_quat, state.sim.q,
                                   rew, done)):
                steps[k].append(x.clone())
        if timer:
            timer("end")
        stacked = {k: self._gather_envs(torch.stack(v)) for k, v in steps.items()}
        if not self.rank0:
            return None
        arrays = {k: v.cpu().numpy() for k, v in stacked.items()}
        return [{k: arrays[k][i] for k in keys} for i in range(len(steps["rew"]))]

    def _gather_envs(self, x):
        """x [T, local envs, ...] -> [T, global envs, ...] in env order, on
        every rank (all_gather); x itself at world size 1.  bool goes as
        uint8 (gloo has no bool)."""
        if self.group.world == 1:
            return x
        y = x.transpose(0, 1).contiguous()
        y = self.group.all_gather(y.to(torch.uint8) if x.dtype == torch.bool else y)
        return y.to(x.dtype).transpose(0, 1)
