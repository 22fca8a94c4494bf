"""The profiler arithmetic on synthetic traces: busy union, idle share,
gaps named by the host, per-call rounding, and traces that are empty or
cover part of the window (a run's profile can come back so)."""

from gymbench import trace


def _trace(device, host=(), window=(0, 100)):
    device = sorted(device, key=lambda d: d[1])
    return trace.Trace(device=device, host=sorted(host, key=lambda h: h[1]), launches={},
                       window=window)


def test_busy_union_of_overlapping_intervals():
    dev = [("a", 10, 30, 1), ("b", 20, 40, 2), ("c", 50, 60, 3)]
    assert trace.busy_ns(dev, 0, 100) == 40
    assert trace.busy_ns(dev, 25, 55) == 20
    t = _trace(dev)
    assert abs(trace.idle_share(t) - 0.6) < 1e-12


def test_nested_and_clipped_intervals():
    dev = [("a", -10, 5, 1), ("b", 0, 50, 2), ("c", 10, 20, 3), ("d", 95, 130, 4)]
    assert trace.busy_ns(dev, 0, 100) == 55
    assert trace.gaps(dev, 0, 100) == [(50, 95)]


def test_empty_trace_reads_nothing():
    assert trace.idle_share(None) is None
    assert trace.idle_share(_trace([])) is None


def test_partial_trace_counts_only_what_it_holds():
    # the device events cover the first fifth of the window only
    t = _trace([("k", 0, 20, 1)])
    assert abs(trace.idle_share(t) - 0.8) < 1e-12
    assert trace.gaps(t.device, 0, 100) == [(20, 100)]


def test_idle_gaps_named_by_the_host_op():
    dev = [("k1", 0, 10, 1), ("k2", 40, 50, 2), ("k3", 55, 100, 3)]
    host = [("aten::mul", 5, 45), ("phase_rollout", 0, 100), ("aten::add", 48, 54)]
    t = _trace(dev, host)
    ranked = trace.idle_by_host(t)
    assert ranked[0] == ["aten::mul", 30 / 1e9]
    assert ranked[1] == ["aten::add", 5 / 1e9]
    assert trace.top_device_ops(t)[0] == ["k3", 45 / 1e9]


def test_launched_in_ties_kernels_to_the_launching_span():
    t = _trace([("k1", 10, 20, 7), ("k2", 60, 70, 8), ("k3", 80, 90, 9)])
    t.launches = {7: 5, 8: 55, 9: 75}
    spans = [("phase_rollout", 0, 50), ("phase_update", 50, 70)]
    assert [e[0] for e in t.launched_in(spans[:1])] == ["k1"]
    assert [e[0] for e in t.launched_in(spans[1:])] == ["k2"]


def test_per_call_rounds_dropped_records_up():
    assert trace.per_call(18800) == 18800
    assert trace.per_call(18799.5) == 18800
    assert trace.per_call(18800.0000000001) == 18800
