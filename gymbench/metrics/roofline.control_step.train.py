"""The control step's share of its roofline, in percent: the least time an
H100 takes for one launch at the cell's shapes (counts/substep.py: K1 on
the plane, K5 sampling the terrain in its epilogue on trimesh) over the
traced mean device time of a control_kernel launch."""

from gymbench import trace
from gymbench.counts import peaks, substep


def read(run):
    if run.trace is None:
        return None
    ms = trace.ms_per_launch([e for e in run.trace.device if "control_kernel" in e[0]])
    if ms is None:
        return None
    nbytes, nops = substep.control_step(run.robot, run.cfg["env"]["num_envs"], run.plane,
                                        sampled=not run.plane, field_cells=run.field_cells,
                                        decimation=run.cfg["control"]["decimation"])
    return 100.0 * peaks.bound_s(nbytes, nops) / (ms / 1e3)
