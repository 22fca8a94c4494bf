"""Where one training iteration's time goes on the card, by the program's spans.

    python -m booster_gym_torch.profile_iteration [--update fused|xla]
                                                  [--terrain plane|trimesh]
                                                  [--out FILE]

Runs the main path of chip_smoke.py (testing.main_path_cfg: flat T1 on the
T1-shaped stand-in URDF, 4096 envs, horizon 24, 20 mini-epochs, the fused
update unless --update xla asks for the autograd one; with --terrain
trimesh its rough path, testing.rough_path_cfg: T1.yaml's own terrain) for
two warm-up iterations, then profiles two iterations with torch.profiler.
Nothing synchronises the device inside them, so rollout and update overlap
as they do in training.

The program's spans (utils/spans.py: ppo.iteration, ppo.rollout, ppo.act,
env.step, env.graph and the step's parts, ppo.episode_stats, ppo.update)
group the report.
For each span, per iteration: the host milliseconds inside it, the device
operations (kernels, copies, fills) whose launching runtime call lies in
it, their device milliseconds, the device's idle milliseconds put down to
it (each idle gap of the device goes to the innermost span running on the
host at the gap's midpoint, "(outside)" where none is), and the host's
waits on the device: the runtime calls in SYNC_CALLS that start in it.
Also printed, for the iteration and for ppo.rollout and ppo.update: the
wall time, the device's busy share (the sum of kernel times over the wall
time; one stream, so kernels do not overlap), the launches and the kernels
that take the most device time; and the substep kernel (K1, or K5 on
trimesh) per launch, which is one control step of the env's 10 substeps,
and per substep.  The profiler adds host-side cost per launch, so the wall
time and the idle it reports are upper bounds of the unprofiled run's.
The JSON line (and --out FILE) also holds every kernel's device time and
launches per iteration, by name, for the iteration and each phase.  Needs
a GPU.
"""

import argparse
import bisect
import json
import re
import tempfile
import time

import torch

WARMUP_ITERS, PROFILED_ITERS = 2, 2
SPANS = ("ppo.iteration", "ppo.rollout", "ppo.act", "env.step", "env.graph", "env.physics",
         "env.post_physics", "env.reward", "env.reset", "env.observe", "ppo.episode_stats",
         "ppo.update", "ppo.gae", "ppo.grads", "ppo.opt")
# runtime calls that return only once the device has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
OUTSIDE = "(outside)"


def is_sync(name):
    """Whether a runtime call's name (CUPTI may add a version, _v3020) is
    one of SYNC_CALLS."""
    return re.sub(r"_v\d+$", "", name) in SYNC_CALLS


def collect(events):
    """(device, host, launches) of kineto events: device (name, start, end,
    correlation id) of every kernel, copy and fill, sorted by start; host
    (name, start, end) of the main thread's operators, spans and runtime
    calls, sorted by start; launches: correlation id -> start of the CUDA
    API call (cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel, ...) that
    launched it: the operators carry correlation ids of their own, which
    are not the device's.  Nanoseconds on kineto's clock."""
    device, host, launches, threads = [], [], {}, {}
    for ev in events:
        name, a, b = ev.name(), ev.start_ns(), ev.end_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append((name, a, b, ev.correlation_id()))
            continue
        tid = ev.start_thread_id()
        threads[tid] = threads.get(tid, 0) + 1
        if ev.correlation_id() and name.startswith("cu"):
            launches.setdefault(ev.correlation_id(), a)
        host.append((name, a, b, tid))
    main = max(threads, key=threads.get) if threads else None
    host = sorted(((n, a, b) for n, a, b, tid in host if tid == main), key=lambda h: h[1])
    return sorted(device, key=lambda d: d[1]), host, launches


def _inside(intervals, t):
    """Whether t lies in one of the disjoint (start, end) `intervals`,
    sorted by start."""
    i = bisect.bisect_right([a for a, _ in intervals], t) - 1
    return i >= 0 and t <= intervals[i][1]


def _idle_gaps(device, lo, hi):
    """The device's idle intervals within [lo, hi] (device sorted by start)."""
    out, end = [], lo
    for _, a, b, _ in device:
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return out


def span_table(device, host, launches, iterations):
    """{span: {launches, host_ms, device_ms, idle_ms, syncs}} per iteration
    for every name in SPANS and OUTSIDE (idle only), over the traced window
    from the first ppo.iteration's start to the device's last operation."""
    spans = {name: [(a, b) for n, a, b in host if n == name] for name in SPANS}
    syncs = [a for n, a, _ in host if is_sync(n)]
    table = {}
    for name, ivs in spans.items():
        ops = [ev for ev in device if launches.get(ev[3]) is not None
               and _inside(ivs, launches[ev[3]])]
        table[name] = {"launches": len(ops) / iterations,
                       "host_ms": sum(b - a for a, b in ivs) / 1e6 / iterations,
                       "device_ms": sum(b - a for _, a, b, _ in ops) / 1e6 / iterations,
                       "idle_ms": 0.0,
                       "syncs": sum(_inside(ivs, t) for t in syncs) / iterations}
    table[OUTSIDE] = {"idle_ms": 0.0}
    if not spans["ppo.iteration"] or not device:
        return table
    lo, hi = spans["ppo.iteration"][0][0], max(b for _, _, b, _ in device)
    # the innermost span at t is the latest-starting one that covers it
    flat = sorted(((a, b, n) for n, ivs in spans.items() for a, b in ivs))
    starts = [a for a, _, _ in flat]
    for a, b in _idle_gaps(device, lo, hi):
        t, owner = (a + b) // 2, OUTSIDE
        for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if t <= flat[j][1]:
                owner = flat[j][2]
                break
        table[owner]["idle_ms"] += (b - a) / 1e6 / iterations
    return table


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
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_ITERS):
            ts, _ = ppo.train_iteration(env_params, ts, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_ITERS

    device, host, launches = collect(prof.profiler.kineto_results.events())
    # (name, device ms) of each kernel
    kernels = [(n, (b - a) / 1e6) for n, a, b, _ in device]

    def summary(label, kernels, wall_ms):
        busy_ms = sum(ms for _, ms in kernels) / PROFILED_ITERS
        by_name = {}
        for name, ms in kernels:
            t, n = by_name.get(name, (0.0, 0))
            by_name[name] = (t + ms / PROFILED_ITERS, n + 1)
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
    control = [ms for name, ms in kernels if "control_kernel" in name]
    decimation = runner.env.decimation
    if control:
        per_launch = sum(control) / len(control)
        out["substep_kernel"] = {"launches_per_iter": len(control) // PROFILED_ITERS,
                                 "ms_per_launch": per_launch,
                                 "ms_per_substep": per_launch / decimation}
        print(f"substep kernel ({'K1' if args.terrain == 'plane' else 'K5'}): "
              f"{len(control) // PROFILED_ITERS} launches per iteration, {per_launch:.4f} ms per "
              f"launch (one control step), {per_launch / decimation:.4f} ms per substep")
    for phase in ("rollout", "update"):
        ivs = [(a, b) for n, a, b in host if n == f"ppo.{phase}"]
        inside = [(n, (b - a) / 1e6) for n, a, b, c in device
                  if launches.get(c) is not None and _inside(ivs, launches[c])]
        phase_ms = sum(b - a for a, b in ivs) / 1e6 / PROFILED_ITERS
        out[phase] = summary(phase, inside, phase_ms)

    table = span_table(device, host, launches, PROFILED_ITERS)
    out["spans"] = table
    print(f"{'span, per iteration':20s} {'launches':>9s} {'host ms':>9s} {'device ms':>9s} "
          f"{'idle ms':>9s} {'syncs':>6s}")
    for name in SPANS:
        r = table[name]
        print(f"{name:20s} {r['launches']:9.1f} {r['host_ms']:9.2f} {r['device_ms']:9.2f} "
              f"{r['idle_ms']:9.2f} {r['syncs']:6.1f}")
    print(f"{OUTSIDE:20s} {'':9s} {'':9s} {'':9s} {table[OUTSIDE]['idle_ms']:9.2f}")
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
