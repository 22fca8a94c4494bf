"""The reader of roofline.gae.train on synthetic traces: K2's bound at the
cell's widths and rows over the device time launched inside the ppo.gae
spans, per span; None without the span (a program before it) or a trace."""

import pytest

from gymbench import spec, trace
from gymbench.counts import peaks, update

US = 1_000


def _run(host, device=(), launches=None, config="t1_standup"):
    cfg, _ = spec.config(config)
    cfg["env"] = {**cfg["env"], "num_envs": 16384}
    t = None if host is None else trace.Trace(
        device=sorted(device, key=lambda d: d[1]), host=sorted(host, key=lambda h: h[1]),
        launches=launches or {}, window=(0, 10_000_000_000))
    return type("Run", (), {"trace": t, "cfg": cfg, "nets": update.nets(cfg)})()


def _read(run):
    return spec.metric_reader("roofline.gae.train")(run)


@pytest.mark.parametrize("config", ["t1_standup", "t1_shaped"])
def test_bound_over_the_device_time_per_span(config):
    # two calls: a copy and the kernel each, 5.5 ms of device time a call;
    # one kernel launched outside the spans
    ms = 1_000_000
    host = [("ppo.update", 0, 100 * ms), ("ppo.gae", 1 * ms, 2 * ms),
            ("ppo.grads", 2 * ms, 3 * ms), ("ppo.gae", 10 * ms, 11 * ms)]
    launch_at = {1: 1 * ms + 10, 2: 1 * ms + 20, 3: 10 * ms + 10, 4: 10 * ms + 20, 5: 2 * ms + 5}
    device = [("copy", 5 * ms, 5 * ms + 500 * US, 1), ("k2_critic", 6 * ms, 11 * ms, 2),
              ("copy", 20 * ms, 20 * ms + 500 * US, 3), ("k2_critic", 21 * ms, 26 * ms, 4),
              ("k3_pass1", 30 * ms, 90 * ms, 5)]
    run = _run(host, device, launch_at, config)
    nbytes, nops = update.work(run.nets, 24, 16384)["gae"]
    want = 100.0 * peaks.bound_s(nbytes, nops, peaks.BF16_OPS_PER_S) / 5.5e-3
    assert _read(run) == pytest.approx(want, rel=1e-12)
    assert 0 < _read(run) < 100


def test_missing_span_or_trace_reads_none():
    ms = 1_000_000
    # the parent's trace: the update's span and no ppo.gae inside it
    parent = _run([("ppo.update", 0, 10 * ms)], [("k2_critic", 1 * ms, 2 * ms, 1)],
                  {1: 5 * ms})
    assert _read(parent) is None
    assert _read(_run(None)) is None
    # a span that launched nothing the trace recorded
    assert _read(_run([("ppo.gae", 0, ms)], [("k", 2 * ms, 3 * ms, 1)], {1: 2 * ms})) is None
