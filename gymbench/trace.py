"""A bounded torch.profiler trace of a few steps, and the arithmetic on it.

profile() runs one step under the profiler's warm-up (which records
nothing) and then the active steps inside a span of its own, opened and
closed by a sentinel fill on the device, and synchronises before the span
closes.  A trace that holds no device event (seen as a process's first
trace on this card) is taken once more.  The trace stays in memory: no
file is written.  The profiler drops a kernel's record now and then and
adds host cost to every launch, so counts are rounded up per step
(per_call) and the traced wall and idle share are upper bounds of an
untraced run's.

Times are kineto's nanoseconds, host and device on one clock.
"""

import bisect
import dataclasses
import math

import torch

WINDOW = "gymbench_window"
_SENTINEL = "FillFunctor<signed char>"


@dataclasses.dataclass
class Trace:
    """device: (name, start, end, launch correlation id) of every kernel,
    copy and fill, sorted by start; host: (name, start, end) of the main
    thread's operators and spans, sorted by start; launches: correlation id
    -> the host time of the runtime call that launched it; window: (start,
    end) of the traced steps."""
    device: list
    host: list
    launches: dict
    window: tuple

    def spans(self, prefix):
        """The host spans whose names start with `prefix`: (name, start, end)."""
        return [h for h in self.host if h[0].startswith(prefix)]

    def launched_in(self, spans):
        """The device events whose launch lies inside one of `spans`."""
        spans = sorted((a, b) for _, a, b in spans)
        starts = [a for a, _ in spans]
        out = []
        for ev in self.device:
            t = self.launches.get(ev[3])
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                out.append(ev)
        return out


def _kind(ev):
    return ev.device_type() == torch.autograd.DeviceType.CUDA


def _collect(events):
    device, host, launches, threads = [], [], {}, {}
    for ev in events:
        name, t0, t1 = ev.name(), ev.start_ns(), ev.end_ns()
        if _kind(ev):
            if ev.is_user_annotation() or _SENTINEL in name:
                continue
            device.append((name, t0, t1, ev.correlation_id()))
        else:
            tid = ev.start_thread_id()
            threads[tid] = threads.get(tid, 0) + 1
            if ev.correlation_id():
                launches.setdefault(ev.correlation_id(), t0)
            host.append((name, t0, t1, tid))
    main = max(threads, key=threads.get) if threads else None
    host = sorted((n, a, b) for n, a, b, tid in host if tid == main)
    return sorted(device, key=lambda d: d[1]), sorted(host, key=lambda h: h[1]), launches


def profile(step, steps, attempts=2):
    """Trace `steps` calls of step() after one warm-up call; None if no
    attempt recorded a device event."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sentinel = torch.empty(1, dtype=torch.int8, device="cuda")
    for _ in range(attempts):
        got = {}
        sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        ready = lambda p: got.setdefault("events", p.profiler.kineto_results.events())
        with torch.profiler.profile(activities=acts, schedule=sched,
                                    on_trace_ready=ready) as prof:
            step()
            torch.cuda.synchronize()
            prof.step()
            with torch.profiler.record_function(WINDOW):
                sentinel.fill_(0)
                for _ in range(steps):
                    step()
                sentinel.fill_(0)
                torch.cuda.synchronize()
            prof.step()
        device, host, launches = _collect(got.get("events", []))
        windows = [(a, b) for n, a, b in host if n == WINDOW]
        if device and windows:
            return Trace(device, host, launches, windows[0])
    return None


def busy_ns(device, lo, hi):
    """The length of the union of the device intervals (sorted by start)
    within [lo, hi]."""
    total, end = 0, lo
    for _, a, b, *_ in device:
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def idle_share(trace):
    """1 - busy / wall over the traced window, or None without a trace."""
    if trace is None or not trace.device:
        return None
    lo, hi = trace.window
    return 1.0 - busy_ns(trace.device, lo, hi) / (hi - lo)


def gaps(device, lo, hi):
    """The idle intervals (start, end) of the device within [lo, hi]."""
    out, end = [], lo
    for _, a, b, *_ in device:
        if end >= hi:
            break
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        out.append((end, hi))
    return out


def host_op_at(host, starts, t, reach=64):
    """The innermost host operator or span running at time t, or
    "python" where none is (the interpreter between operators)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        name, a, b = host[j]
        if a <= t <= b and name != WINDOW:
            return name
    return "python"


def idle_by_host(trace, top=10):
    """[[what the host ran during the gap, idle seconds]] of the traced
    window, the largest first: each idle interval is named by the host's
    innermost operator at its midpoint."""
    lo, hi = trace.window
    starts = [h[1] for h in trace.host]
    total = {}
    for a, b in gaps(trace.device, lo, hi):
        name = host_op_at(trace.host, starts, (a + b) // 2)
        total[name] = total.get(name, 0) + (b - a)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in ranked]


def top_device_ops(trace, top=10):
    """[[device operation, seconds in the traced window]], the largest first."""
    total = {}
    for name, a, b, _ in trace.device:
        total[name] = total.get(name, 0) + (b - a)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in ranked]


def per_call(count):
    """The launches per step that a profiler's count per step stands for:
    a trace drops a record now and then and never adds one, so a count in
    (n - 1, n] stands for n."""
    return math.ceil(count - 1e-9)


def ms_per_launch(events):
    """Mean device milliseconds of the recorded events, or None."""
    if not events:
        return None
    return sum(b - a for _, a, b, _ in events) / len(events) / 1e6
