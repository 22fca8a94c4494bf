"""K2's share of its roofline, in percent: the least time an H100 takes for
one call of the fused update's values and GAE at N = horizon x envs rows
(counts/update.py's "gae", bf16 products on the tensor cores) over the
device time of the operations launched inside the program's ppo.gae
spans, per span (a span is one call, once a mini-epoch).  None without
the span (a program before it) or without a device operation in it."""

from gymbench import spans
from gymbench.counts import peaks, update


def read(run):
    gae = spans.named(run.trace, "ppo.gae")
    if gae is None:
        return None
    ops = run.trace.launched_in(gae)
    if not ops:
        return None
    s_per_call = sum(b - a for _, a, b, _ in ops) / len(gae) / 1e9
    T, B = run.cfg["runner"]["horizon_length"], run.cfg["env"]["num_envs"]
    nbytes, nops = update.work(run.nets, T, B)["gae"]
    ops_per_s = peaks.BF16_OPS_PER_S if run.nets.bf16 else peaks.F32_OPS_PER_S
    return 100.0 * peaks.bound_s(nbytes, nops, ops_per_s) / s_per_call
