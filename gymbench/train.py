"""A training cell: booster_gym_torch.runner.Runner on one card, its
iterations (PPO.train_iteration: a rollout of horizon_length control steps,
then mini_epochs full-batch mini-epochs) back to back for the window.

Set-up builds the runner from the configuration and the traffic (the env
count and the terrain) with the seed, initializes it from the seed, and
runs check_train.ITERATIONS iterations under check_train.Capture: they are
the warm-up of every shape the window runs, and the steps the reference
follows.  The window loops the same call on the same state until the
seconds have passed, then synchronises.  With --trace 1 every iteration of
the window carries CUDA events at the timer hook (rollout, update, end),
and torch.profiler then traces traffic["profile_iterations"] more after a
warm-up iteration, their phases marked by spans.  After the window the
program's memory is freed and the reference checks the set-up's
iterations.
"""

import time

import torch

from gymbench import check_train, trace


class _Events:
    """train_iteration's timer hook: a CUDA event at each mark."""

    def __init__(self):
        self.marks = []

    def __call__(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))

    def phases(self):
        """[(rollout ms, update ms)] of each iteration, after a synchronise."""
        out = []
        for i in range(0, len(self.marks), 3):
            (_, a), (_, b), (_, c) = self.marks[i:i + 3]
            out.append((a.elapsed_time(b), b.elapsed_time(c)))
        return out


class _Spans:
    """train_iteration's timer hook in traced iterations: a profiler span
    per phase, without a synchronise (the trace ties each kernel to the
    phase whose host span launched it)."""

    def __init__(self):
        self.span = None

    def __call__(self, name):
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None
        if name != "end":
            self.span = torch.profiler.record_function(f"phase_{name}")
            self.span.__enter__()


def set_up(cfg, traffic, seed, device):
    """The runner built from the configuration and the traffic, initialized
    from the seed, then the checked iterations under capture.  Returns
    (cfg as run, runner, env_params, ts, capture)."""
    from booster_gym_torch.runner import Runner

    cfg = {k: (dict(v) if isinstance(v, dict) else v) for k, v in cfg.items()}
    cfg["env"]["num_envs"] = int(traffic["num_envs"])
    cfg["terrain"]["type"] = traffic["terrain"]
    cfg["basic"].update(seed=int(seed), data_parallel=False, checkpoint=None)
    runner = Runner(cfg, device=device)
    env_params, ts = runner.ppo.init(runner.gen)
    steps = check_train.sample_steps(seed, cfg["runner"]["horizon_length"],
                                     int(traffic["check_steps"]))
    cap = check_train.Capture(runner, steps)
    cap.install(ts)
    cap.before(ts)
    for _ in range(check_train.ITERATIONS):
        ts, _ = runner.ppo.train_iteration(env_params, ts, runner.gen)
    cap.remove()
    return cfg, runner, env_params, ts, cap


def _finite(metrics):
    return torch.isfinite(torch.stack([v.float() for v in metrics.values()])).all()


def window(runner, env_params, ts, seconds, traced, profile_iterations):
    """The measured loop.  Returns a dict: iterations, seconds (first
    iteration's start to the final synchronise), failed (iterations with a
    non-finite metric), and traced: phases [(rollout ms, update ms)] and
    the trace."""
    ppo, gen = runner.ppo, runner.gen
    timer = _Events() if traced else None
    ok = torch.zeros((), dtype=torch.int64, device=runner.device)
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        ts, metrics = ppo.train_iteration(env_params, ts, gen, timer)
        ok += _finite(metrics)
        n += 1
    if runner.device.type == "cuda":
        torch.cuda.synchronize()
    out = {"iterations": n, "seconds": time.perf_counter() - t0}
    out["failed"] = n - int(ok)
    if traced:
        out["phases"] = timer.phases()
        spans = _Spans()
        state = {"ts": ts}

        def step():
            state["ts"], _ = ppo.train_iteration(env_params, state["ts"], gen, spans)

        out["trace"] = trace.profile(step, profile_iterations)
    return out
