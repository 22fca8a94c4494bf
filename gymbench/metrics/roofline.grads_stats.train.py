"""K3's share of its roofline, in percent: the least time an H100 takes for
one call at N = horizon x envs rows (counts/update.py, bf16 products on the
tensor cores) over K3's traced device time per call: its k3_pass1,
k3_pass2 and k3_reduce launches and the k_pad launch that opens each call
(the one the next launch after which is k3_pass1)."""

from gymbench.counts import peaks, update


def read(run):
    t = run.trace
    if t is None:
        return None
    dev = t.device
    ns = calls = 0
    for i, (name, a, b, _) in enumerate(dev):
        if "k3_pass1" in name:
            calls += 1
        if any(k in name for k in ("k3_pass1", "k3_pass2", "k3_reduce")) or (
                "k_pad" in name and i + 1 < len(dev) and "k3_pass1" in dev[i + 1][0]):
            ns += b - a
    if not calls:
        return None
    T, B = run.cfg["runner"]["horizon_length"], run.cfg["env"]["num_envs"]
    nbytes, nops = update.work(run.nets, T, B)["grads_stats"]
    ops_per_s = peaks.BF16_OPS_PER_S if run.nets.bf16 else peaks.F32_OPS_PER_S
    return 100.0 * peaks.bound_s(nbytes, nops, ops_per_s) / (ns / calls / 1e9)
