"""Where one training iteration's time goes on the card.

    python -m booster_gym_torch.profile_iteration

Runs the main path of chip_smoke.py (testing.main_path_cfg: flat T1 on the
T1-shaped stand-in URDF, 4096 envs, horizon 24, 20 mini-epochs, xla update)
for two warm-up iterations, then profiles two iterations with
torch.profiler and prints: the iterations' wall time, the device's busy
share (the sum of kernel times over the wall time; one stream, so kernels
do not overlap), the number of kernel launches, and the kernels that take
the most device time.  The profiler adds host-side cost per launch, so the
wall time and the idle share it reports are upper bounds of the
unprofiled run's.  Needs a GPU.
"""

import json
import tempfile
import time

import torch

WARMUP_ITERS, PROFILED_ITERS = 2, 2


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("profile_iteration needs a CUDA card")

    from booster_gym_torch.runner import Runner
    from booster_gym_torch.testing import card_line, main_path_cfg, write_t1_shaped_urdf

    card = card_line()
    runner = Runner(main_path_cfg(write_t1_shaped_urdf(tempfile.mkdtemp())), device="cuda")
    ppo, gen = runner.ppo, runner.gen
    env_params, ts = ppo.init(gen)
    for _ in range(WARMUP_ITERS):
        ts, _ = ppo.train_iteration(env_params, ts, gen)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_ITERS):
            ts, _ = ppo.train_iteration(env_params, ts, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_ITERS

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3 / PROFILED_ITERS
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time / 1e3 / PROFILED_ITERS, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    launches = len(kernels) // PROFILED_ITERS
    print(f"card: {card}")
    print(f"profiled iteration: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), {launches} kernel launches")
    for name, (ms, n) in top:
        print(f"  {ms:8.2f} ms  {n // PROFILED_ITERS:6d} launches  {name[:90]}")
    print(json.dumps({"card": card, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                      "launches_per_iter": launches,
                      "top": [{"name": k[:90], "ms": v[0], "launches": v[1] // PROFILED_ITERS}
                              for k, v in top]}))


if __name__ == "__main__":
    main()
