"""The readers of the program's spans on synthetic traces: host syncs
counted inside ppo.iteration only and per span, their milliseconds summed,
launches per span rounded up, and a missing span or trace reads None (the
parent of the spans' PR runs the readers too)."""

from gymbench import spans, spec, trace


def _trace(device, host, launches):
    return trace.Trace(device=sorted(device, key=lambda d: d[1]),
                       host=sorted(host, key=lambda h: h[1]), launches=launches,
                       window=(0, 10_000_000))


def _run(t):
    return type("Run", (), {"trace": t})()


def _two_iterations():
    ms = 1_000_000
    host = [("ppo.iteration", 0, 4 * ms), ("ppo.iteration", 5 * ms, 9 * ms),
            ("env.step", 1 * ms, 2 * ms), ("env.step", 6 * ms, 7 * ms),
            ("env.reward", 1 * ms + 10, 1 * ms + 20),
            # blocking calls: 1.5 ms and 0.5 ms inside the iterations, one
            # between them and one at the window's end outside every span
            ("cudaStreamSynchronize", 3 * ms, 3 * ms + ms // 2 * 3),
            ("cudaMemcpy_v3020", 8 * ms, 8 * ms + ms // 2),
            ("cudaStreamSynchronize", int(4.5 * ms), int(4.6 * ms)),
            ("cudaDeviceSynchronize", 9_500_000, 9_900_000),
            # not blocking
            ("cudaMemcpyAsync", 2 * ms, 2 * ms + 5), ("cudaLaunchKernel", 1 * ms + 1, 1 * ms + 2)]
    # launches: env.step holds 3 then 2 of them (one dropped by the trace),
    # env.reward 1; one outside every env.step
    launch_at = {1: 1 * ms + 1, 2: 1 * ms + 15, 3: 1 * ms + 500, 4: 6 * ms + 1, 5: 6 * ms + 2,
                 6: 3 * ms}
    device = [(f"k{c}", t + 100, t + 200, c) for c, t in launch_at.items()]
    return _trace(device, host, launch_at)


def _read(name, t):
    return spec.metric_reader(name)(_run(t))


def test_syncs_counted_inside_the_iteration_and_per_span():
    t = _two_iterations()
    assert _read("host_syncs.train", t) == 1.0          # 2 in 2 iterations
    assert abs(_read("host_sync_ms.train", t) - (1.5 + 0.5) / 2) < 1e-12
    assert spans.is_sync("cudaEventSynchronize") and not spans.is_sync("cudaMemcpyAsync")


def test_launches_per_span_rounded_up():
    t = _two_iterations()
    assert _read("env_launches.train", t) == 3           # 5 in 2 spans: 2.5 -> 3
    assert _read("reward_launches.train", t) == 1
    assert spans.launches_per_span(t, "env") is None     # a name, not a prefix


def test_missing_span_or_trace_reads_none():
    names = ("host_syncs.train", "host_sync_ms.train", "env_launches.train",
             "reward_launches.train", "stats_launches.train")
    t = _two_iterations()
    assert _read("stats_launches.train", t) is None
    # the parent's trace: the benchmark's phase spans and no program span
    parent = _trace([("k", 10, 20, 1)], [("phase_rollout", 0, 100),
                                         ("cudaStreamSynchronize", 50, 60)], {1: 5})
    for name in names:
        assert _read(name, None) is None
        assert _read(name, parent) is None
