"""A run of a cell, by the kind of its traffic: set-up, the window, the
end-to-end or per-layer metrics, and the numbers the reference compares.

Each per-layer metric is read by metrics/<name>.py's read(run) from a
Run: what the run measured, and the shapes that the counts need.  A reader
that finds nothing to read returns None, and the metric is left out of the
line.
"""

import dataclasses
import gc
import time

import torch

from gymbench import check_train, spec, stats, train, trace
from gymbench.counts import substep, update
from gymbench.reference.envs import env_class


@dataclasses.dataclass
class Run:
    cell: dict
    cfg: dict
    traffic: dict
    robot: substep.Robot
    nets: update.Nets = None
    field_cells: int = 0
    trace: object = None         # trace.Trace of the profiled steps
    phases: list = None          # [(rollout ms, update ms)] of every iteration

    @property
    def plane(self):
        return self.cfg["terrain"]["type"] == "plane"


def _robot(env, cfg):
    solver = cfg["sim"].get("solver", {})
    return substep.robot(env.model, len(env.feet_indices), len(cfg["asset"]["feet_edge_pos"]),
                         int(solver.get("iterations", 4)))


def read_per_layer(run):
    bench = spec.benchmark()
    return {name: spec.metric_reader(name)(run)
            for name in spec.metrics_of(bench, run.cell["name"], "per_layer")}


def _traced(result, run, t):
    result["metrics"] = read_per_layer(run)
    if t is not None:
        lo, hi = t.window
        result["busy_s"] = trace.busy_ns(t.device, lo, hi) / 1e9
        result["window_s"] = (hi - lo) / 1e9
        result["breakdown"] = {"device_ops": trace.top_device_ops(t),
                               "idle_gaps": trace.idle_by_host(t)}
    else:
        result.update(busy_s=None, window_s=None, breakdown=None)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak(device):
    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def train_run(cell, cfg, traffic, seed, seconds, traced, t_start, device="cuda"):
    # a task with no reference env fails here, before set-up and the window
    env_class(cfg)
    cfg, runner, env_params, ts, cap = train.set_up(cfg, traffic, seed, device)
    sync(device)
    setup_s = time.time() - t_start
    w = train.window(runner, env_params, ts, seconds, traced,
                     int(traffic["profile_iterations"]))
    peak = _peak(device)
    steps = w["iterations"] * cfg["runner"]["horizon_length"] * cfg["env"]["num_envs"]
    hf = env_params.height_field
    run = Run(cell, cfg, traffic, _robot(runner.env, cfg), update.nets(cfg),
              0 if cfg["terrain"]["type"] == "plane" else hf.numel(),
              w.get("trace"), w.get("phases"))
    result = {"attempted": w["iterations"], "failed": w["failed"], "memory_peak_bytes": peak}
    if traced:
        _traced(result, run, run.trace)
    else:
        result["metrics"] = {"env_steps_per_s": stats.rate(steps, w["seconds"]),
                             "setup_s": setup_s}
    # the program's state goes before the reference runs
    params = env_params
    del runner, ts, w, run
    _free(device)
    ref = check_train.Reference(cfg, device)
    result["numbers"] = ref.numbers(cap, params)
    return result

