"""What a traced run reads: the profiler's events, and fenced spans.

`digest(prof)` turns a finished `torch.profiler.profile` into plain
lists, read from its events in memory (no trace file is written): every
device activity (kernels, copies, sets) with its name and interval, and
every host event with its interval. `Spans` times the program's stage
timers (`profiling.stage_timer`) from outside, keeping each stage's
nesting depth, since stages nest (`final/upload_wait` inside
`final/stream`).
"""

import contextlib
import threading
import time

import numpy as np


def _ns(e, what):
    f = getattr(e, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, what + "_us")() * 1000)


def digest(prof, ranges=()):
    """(device, host): lists of (name, start_ns, end_ns). `ranges` are the
    names of profiler ranges the benchmark opened: the profiler mirrors
    each on the device's timeline, where they are not device work."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        row = (e.name(), start, end)
        if e.device_type() == DeviceType.CUDA:
            if e.name() not in ranges:
                device.append(row)
        elif e.device_type() == DeviceType.CPU:
            host.append(row)
    return device, host


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_seconds(device):
    """Seconds in which some device activity ran: the union of their
    intervals, so overlapping streams count once."""
    return sum(e - s for s, e in merged([(s, e) for _, s, e in device])) / 1e9


def top_ops(device, n=10):
    """The n device operations, by name, that took most time:
    [[name, seconds]]."""
    tot = {}
    for name, s, e in device:
        tot[name] = tot.get(name, 0) + (e - s)
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns / 1e9] for name, ns in top]


def idle_gaps(device, host, n=10):
    """The n longest gaps between device activity, each named by the
    innermost host event open at its middle: [[name, seconds]]."""
    busy = merged([(s, e) for _, s, e in device])
    gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])]
    gaps = sorted(gaps, reverse=True)[:n]
    if not gaps:
        return []
    starts = np.array([s for _, s, _ in host], np.int64)
    ends = np.array([e for _, _, e in host], np.int64)
    out = []
    for length, s, e in gaps:
        mid = (s + e) // 2
        idx = np.nonzero((starts <= mid) & (ends >= mid))[0]
        if len(idx):
            k = idx[np.argmin(ends[idx] - starts[idx])]
            name = host[k][0]
        else:
            name = "host, no profiled event open"
        out.append([name, length / 1e9])
    return out


class Spans:
    """Wraps a module's `stage_timer` so that each stage also lands here
    as (name, depth, seconds), and with `ranges` opens a profiler range of
    the stage's name, which names the device's idle gaps; the program's
    own timer still runs inside (its fences are the program's)."""

    def __init__(self, module, ranges=False):
        self.module = module
        self.ranges = ranges
        self.spans = []
        self._local = threading.local()
        self._orig = None

    @contextlib.contextmanager
    def _timer(self, name):
        from torch.profiler import record_function

        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        t0 = time.perf_counter()
        try:
            with contextlib.ExitStack() as stack:
                if self.ranges:
                    stack.enter_context(record_function(name))
                stack.enter_context(self._orig(name))
                yield
        finally:
            self._local.depth = depth
            self.spans.append((name, depth, time.perf_counter() - t0))

    def __enter__(self):
        self._orig = self.module.stage_timer
        self.module.stage_timer = self._timer
        return self

    def __exit__(self, *exc):
        self.module.stage_timer = self._orig

    def total(self, name=None, prefix=None, top=False):
        """Seconds in stage `name`, or in stages starting with `prefix`;
        with `top`, only stages not inside another."""
        return sum(sec for nm, depth, sec in self.spans
                   if (name is None or nm == name)
                   and (prefix is None or nm.startswith(prefix))
                   and (not top or depth == 0))

    def seen(self, name=None, prefix=None):
        return any((name is None or nm == name)
                   and (prefix is None or nm.startswith(prefix))
                   for nm, _, _ in self.spans)
