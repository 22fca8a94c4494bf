"""Where one training iteration's time goes on the card.

    python -m booster_gym_torch.profile_iteration [--update fused|xla]
                                                  [--terrain plane|trimesh]
                                                  [--out FILE]

Runs the main path of chip_smoke.py (testing.main_path_cfg: flat T1 on the
T1-shaped stand-in URDF, 4096 envs, horizon 24, 20 mini-epochs, the fused
update unless --update xla asks for the autograd one; with --terrain
trimesh its rough path, testing.rough_path_cfg: T1.yaml's own terrain) for
two warm-up iterations, then profiles two iterations with torch.profiler
and prints, for the iteration and its rollout and update phases: the wall time,
the device's busy share (the sum of kernel times over the wall time; one
stream, so kernels do not overlap), the number of kernel launches, and the
kernels that take the most device time, and the substep kernel (K1, or K5
on trimesh) per launch, which is one control step of the env's 10
substeps, and per substep.  The device is synchronised at the
phase boundaries, so a kernel belongs to the phase in whose span it
starts.  The profiler adds host-side cost per launch, so the wall time and
the idle share it reports are upper bounds of the unprofiled run's.  The
JSON line (and --out FILE) also holds every kernel's device time and
launches per iteration, by name, for each phase.  Needs a GPU.
"""

import argparse
import json
import tempfile
import time

import torch

WARMUP_ITERS, PROFILED_ITERS = 2, 2


class _PhaseSpans:
    """train_iteration's timer hook: closes the running phase's profiler
    span and opens the next, with the device synchronised between them."""

    def __init__(self):
        self.span = None

    def __call__(self, name):
        torch.cuda.synchronize()
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None
        if name != "end":
            self.span = torch.profiler.record_function(f"phase_{name}")
            self.span.__enter__()


def main(argv=None):
    """Returns the JSON record it prints."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--update", choices=("fused", "xla"), default="fused")
    parser.add_argument("--terrain", choices=("plane", "trimesh"), default="plane")
    parser.add_argument("--out", help="also write the JSON record to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_iteration needs a CUDA card")

    from booster_gym_torch.runner import Runner
    from booster_gym_torch.testing import (
        card_line,
        main_path_cfg,
        rough_path_cfg,
        write_t1_shaped_urdf,
    )

    card = card_line()
    path_cfg = main_path_cfg if args.terrain == "plane" else rough_path_cfg
    cfg = path_cfg(write_t1_shaped_urdf(tempfile.mkdtemp()))
    cfg["algorithm"]["update_backend"] = args.update
    runner = Runner(cfg, device="cuda")
    ppo, gen = runner.ppo, runner.gen
    env_params, ts = ppo.init(gen)
    for _ in range(WARMUP_ITERS):
        ts, _ = ppo.train_iteration(env_params, ts, gen)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    spans = _PhaseSpans()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_ITERS):
            ts, _ = ppo.train_iteration(env_params, ts, gen, spans)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_ITERS

    events = list(prof.events())
    # the phase spans also come back as device-side annotations: not kernels
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("phase_")]
    phases = [(e.name[len("phase_"):], e.time_range.start, e.time_range.end)
              for e in events if e.name.startswith("phase_")
              and e.device_type == torch.autograd.DeviceType.CPU]

    def summary(label, kernels, wall_ms):
        busy_ms = sum(e.device_time for e in kernels) / 1e3 / PROFILED_ITERS
        by_name = {}
        for e in kernels:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.device_time / 1e3 / PROFILED_ITERS, n + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        launches = len(kernels) // PROFILED_ITERS
        print(f"profiled {label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
              f"({100 * busy_ms / wall_ms:.1f}%), {launches} kernel launches")
        for name, (ms, n) in top:
            print(f"  {ms:8.2f} ms  {n // PROFILED_ITERS:6d} launches  {name[:90]}")
        return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "launches_per_iter": launches,
                "top": [{"name": k[:90], "ms": v[0], "launches": v[1] // PROFILED_ITERS}
                        for k, v in top],
                "kernels": {k[:120]: {"ms": v[0], "launches": v[1] / PROFILED_ITERS}
                            for k, v in by_name.items()}}

    print(f"card: {card}; update_backend {args.update}; terrain {args.terrain}")
    out = {"card": card, "update_backend": args.update, "terrain": args.terrain,
           "iteration": summary("iteration", kernels, wall_ms)}
    # the substep kernel: one launch per control step
    control = [e for e in kernels if "control_kernel" in e.name]
    decimation = runner.env.decimation
    if control:
        per_launch = sum(e.device_time for e in control) / len(control) / 1e3
        out["substep_kernel"] = {"launches_per_iter": len(control) // PROFILED_ITERS,
                                 "ms_per_launch": per_launch,
                                 "ms_per_substep": per_launch / decimation}
        print(f"substep kernel ({'K1' if args.terrain == 'plane' else 'K5'}): "
              f"{len(control) // PROFILED_ITERS} launches per iteration, {per_launch:.4f} ms per "
              f"launch (one control step), {per_launch / decimation:.4f} ms per substep")
    for phase in ("rollout", "update"):
        spans_of = [(a, b) for name, a, b in phases if name == phase]
        inside = [e for e in kernels
                  if any(a <= e.time_range.start <= b for a, b in spans_of)]
        phase_ms = sum(b - a for a, b in spans_of) / 1e3 / PROFILED_ITERS
        out[phase] = summary(phase, inside, phase_ms)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
