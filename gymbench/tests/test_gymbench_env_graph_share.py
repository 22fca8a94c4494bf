"""The reader of env_graph_share.train on synthetic traces: env.graph spans
over env.step spans, 0 where every step runs op by op, and None without an
env.step span or a trace."""

from gymbench import spec, trace


def _read(host):
    t = None if host is None else trace.Trace(
        device=[("k", 10, 20, 1)], host=sorted(host, key=lambda h: h[1]),
        launches={1: 5}, window=(0, 10_000_000))
    return spec.metric_reader("env_graph_share.train")(type("Run", (), {"trace": t})())


def test_graph_share_counts_env_graph_spans_per_env_step():
    ms = 1_000_000
    steps = [("env.step", 1 * ms, 2 * ms), ("env.step", 6 * ms, 7 * ms)]
    graphed = steps + [("env.graph", 1 * ms + 5, 2 * ms - 5), ("env.graph", 6 * ms + 5, 7 * ms - 5)]
    half = steps + [("env.graph", 6 * ms + 5, 7 * ms - 5)]
    assert _read(graphed) == 1.0
    assert _read(half) == 0.5
    assert _read(steps) == 0          # every step op by op, as before the graphs
    assert _read([("phase_rollout", 0, 100)]) is None
    assert _read(None) is None
