"""The operation and byte counts reproduce the bounds that PERF.md's table
of kernels gives at 4096 envs (and T = 24, B = 4096 for the update); a
roofline share reads 100 % where a kernel takes its bound."""

import pytest

from gymbench import spec
from gymbench.cells import Run
from gymbench.counts import peaks, substep, update
from gymbench.reference.model.urdf import load_urdf
from gymbench.reference.terrain import Terrain
from gymbench.trace import Trace


def _robot(name, rim):
    model = load_urdf(f"{spec.HERE}/robots/{name}.urdf", cylinder_rim_points=rim)
    return substep.robot(model, 2, 4, 4)


@pytest.mark.parametrize("label,name,rim,envs,plane,us", [
    ("K1", "t1_shaped", 4, 4096, True, 35.3),
    ("K5", "t1_shaped", 4, 4096, False, 39.1),
    ("K1 MPC", "t1_shaped", 4, 256, True, 2.21),
])
def test_control_step_bounds(label, name, rim, envs, plane, us):
    r = _robot(name, rim)
    cells = 0
    if not plane:
        cfg, _ = spec.config("t1_shaped")
        cells = Terrain(cfg["terrain"], seed=0, device="cpu").height_field.numel()
    nbytes, nops = substep.control_step(r, envs, plane, sampled=not plane, field_cells=cells)
    assert round(peaks.bound_s(nbytes, nops) * 1e6, 2 if us < 10 else 1) == us


@pytest.mark.parametrize("kernel,ops,us", [
    ("gae", peaks.BF16_OPS_PER_S, 23.6), ("grads_stats", peaks.BF16_OPS_PER_S, 99.9),
    ("opt_stage", peaks.F32_OPS_PER_S, 1.59)])
def test_update_bounds(kernel, ops, us):
    cfg, _ = spec.config("t1_shaped")
    n = update.nets(cfg)
    assert n.n_params == 177945
    w = update.work(n, 24, 4096)[kernel]
    assert round(peaks.bound_s(*w, ops) * 1e6, 2 if us < 10 else 1) == us


def test_roofline_reads_100_at_the_bound():
    cfg, _ = spec.config("t1_shaped")
    cfg = {**cfg, "env": {**cfg["env"], "num_envs": 4096},
           "terrain": {**cfg["terrain"], "type": "plane"}}
    r = _robot("t1_shaped", 4)
    bound_ns = peaks.bound_s(*substep.control_step(r, 4096, True, sampled=False)) * 1e9
    t = Trace(device=[("void control_kernel<1>(...)", 0, int(round(bound_ns)), 1)], host=[],
              launches={}, window=(0, 10 ** 9))
    run = Run({"name": "x"}, cfg, {}, r, update.nets(cfg), trace=t)
    share = spec.metric_reader("roofline.control_step.train")(run)
    assert abs(share - 100.0) < 0.01
