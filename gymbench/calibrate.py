"""The readings that a cell's correctness limits are set from.

    python3 -m gymbench.calibrate --workload NAME --seeds 11,12,... \
        [--controls 3] [--out FILE]

For each seed, in one process: the program's set-up as a run makes it,
then the compared numbers of the sound program (the lower readings) and
how its env steps' per-env gaps spread.  For the first --controls seeds
also the control, the plain reference computed in the precision below
the configured one in the program's place (the network's products in fp8,
the physics in TF32), and the faults a run can have: in the env step those
of check_train.plant(), and the update on half the envs.  One JSON line
per seed, also appended to --out.  A limit lies above the largest lower
reading and below the smallest upper one (PERF.md gives both).
"""

import argparse
import gc
import json
import sys
import time

import torch

from gymbench import check_train, spec, train

TOLS = (1e-3, 3e-3, 1e-2, 3e-2, 1e-1)
FAULTS = ("unchanged", "part_unchanged", "done_flipped", "reset_moving")


def spread(steps, cap):
    """How the sound per-env gaps of the sampled steps spread: per step
    the 0.99 and 0.999 quantiles, the largest gap that is not OFF, the
    envs that read OFF, the share over each of TOLS, the envs whose
    termination differs, the largest reset gap, and the share of envs that
    reset."""
    out = []
    for (gap, differs, reset), (_, _, step) in zip(steps, [cap.env_steps[k]
                                                    for k in sorted(cap.env_steps)]):
        on = gap[gap < check_train.OFF].sort().values
        out.append({"q99": float(on[int(0.99 * (on.numel() - 1))]),
                    "q999": float(on[int(0.999 * (on.numel() - 1))]),
                    "max": float(on[-1]), "off": int((gap >= check_train.OFF).sum()),
                    "over": [float((gap > t).float().mean()) for t in TOLS],
                    "done_differs": int(differs.sum()), "reset_max": float(reset.max()),
                    "resets": float(step[3].float().mean())})
    return out


def train_seed(cfg, traffic, seed, control, device="cuda"):
    t0 = time.perf_counter()
    cfg, runner, env_params, ts, cap = train.set_up(cfg, traffic, seed, device)
    del runner, ts
    gc.collect()
    t1 = time.perf_counter()
    ref = check_train.Reference(cfg, device)
    steps = ref.env_steps(cap, env_params)
    out = {"sound": {"field_gap": ref.field_gap(env_params),
                     **check_train.step_numbers(steps)}}
    want = ref.updates(cap)
    loss, grad, change = ref.compare_updates(ref.program_updates(cap), want)
    out["sound"].update(loss_gap=loss, grad_gap=grad, change_gap=change)
    out["spread"] = spread(steps, cap)
    t2 = time.perf_counter()
    out["setup_s"], out["reference_s"] = t1 - t0, t2 - t1
    if control:
        loss, grad, change = ref.compare_updates(ref.updates(cap, control=True), want)
        out["control"] = {**check_train.step_numbers(ref.env_steps(cap, env_params,
                                                                   control=True)),
                          "loss_gap": loss, "grad_gap": grad, "change_gap": change}
        loss, grad, change = ref.compare_updates(ref.updates(cap, half=True), want)
        out["half_batch"] = {"loss_gap": loss, "grad_gap": grad, "change_gap": change}
        for fault in FAULTS:
            out[fault] = check_train.step_numbers(ref.env_steps(cap, env_params,
                                                                fault=fault))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gymbench.calibrate needs a CUDA card", file=sys.stderr)
        return 2
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    cfg, _ = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        rec = train_seed(cfg, traffic, seed % 2 ** 32, i < args.controls)
        rec = {"workload": cell["name"], "seed": seed, "card": torch.cuda.get_device_name(0),
               **rec}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
