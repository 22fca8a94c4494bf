"""The whole iteration's share of the H100's peak, in percent: the sum of
the least times of the kernels counted (horizon control steps, K1 or K5;
mini_epochs calls each of K2, K3 and K4) over the mean iteration's wall
time by CUDA events (rollout plus update) over the traced window.  The
env's small kernels are not counted, so this bounds from below."""

from gymbench.counts import peaks, substep, update


def read(run):
    if not run.phases:
        return None
    cfg = run.cfg
    T, B, E = cfg["runner"]["horizon_length"], cfg["env"]["num_envs"], cfg["runner"]["mini_epochs"]
    cs = peaks.bound_s(*substep.control_step(run.robot, B, run.plane, sampled=not run.plane,
                                             field_cells=run.field_cells,
                                             decimation=cfg["control"]["decimation"]))
    products = peaks.BF16_OPS_PER_S if run.nets.bf16 else peaks.F32_OPS_PER_S
    work = update.work(run.nets, T, B)
    upd = (peaks.bound_s(*work["gae"], products) + peaks.bound_s(*work["grads_stats"], products)
           + peaks.bound_s(*work["opt_stage"]))
    wall_s = sum(r + u for r, u in run.phases) / len(run.phases) / 1e3
    return 100.0 * (T * cs + E * upd) / wall_s
