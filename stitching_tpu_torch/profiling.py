"""Stage spans, counters, fences and device traces.

Port of `stitching_tpu/profiling.py`. It is off until a caller switches
it on; nothing here reads the environment:

- `enable()`: `stage_timer(name)` records each pipeline stage as a span
  and into a per-name table (the engine names its stages
  `registration/upload`, `final/stream`, `final/blend`, ...), and
  `count(name, n)` adds to a counter;
- `enable_fence()`: `fence(*tensors)` at a stage's end synchronises the
  card, so each stage's time covers its own device work. Without it the
  card runs ahead of the host and a stage's work lands in whichever later
  stage first waits on it. Fenced runs are for attribution; a wall time
  comes from an unfenced run;
- `record(name, seconds)`: a duration measured elsewhere (the uploader's
  thread) as a stage entry, with no span;
- `get_spans()`: the spans, each a `Span(name, parent, thread, start_ns,
  end_ns)`. `parent` is the innermost span open in the same thread when it
  began (None at the top). The times are on the clock of the profiler's
  events, nanoseconds since the epoch, so a span lays against a
  `torch.profiler` trace; they are the monotonic counter shifted once, in
  `enable()`, so a step of the wall clock does not reorder them. The last
  `SPAN_CAPACITY` spans are kept;
- `get_counters()`, `get_report()`, `print_report()`, `reset()`: the
  counters, the stage table, both printed, and all of it cleared;
- `device_trace(logdir)`: `torch.profiler` over the block, written to
  `logdir` as a Chrome trace. While a profiler runs, each enabled stage
  also opens a `record_function` range of its name, so the trace carries
  the stages.

Disabled, `stage_timer` and `count` check one module global and return.
"""

import contextlib
import os
import threading
import time
from collections import defaultdict, deque, namedtuple

import torch
import torch.autograd.profiler as _autograd_profiler

# spans kept: about 1,000 stitches of 16 views (some 70 spans each)
SPAN_CAPACITY = 100_000

Span = namedtuple("Span", "name parent thread start_ns end_ns")

_ENABLED = False
_FENCE = False
_STAGES = defaultdict(lambda: [0, 0.0])  # name -> [count, total_s]
_SPANS = deque(maxlen=SPAN_CAPACITY)
_COUNTERS = defaultdict(int)
_LOCK = threading.Lock()                 # the uploader's thread records too
_EPOCH_OFFSET_NS = 0                     # epoch ns - perf_counter ns


class _Open(threading.local):
    """The names of the spans open in this thread, innermost last."""

    def __init__(self):
        self.names = []


_OPEN = _Open()


def enable(on=True):
    global _ENABLED, _EPOCH_OFFSET_NS
    if on:
        _EPOCH_OFFSET_NS = time.time_ns() - time.perf_counter_ns()
    _ENABLED = on


def enable_fence(on=True):
    global _FENCE
    _FENCE = on


def _devices(x, out):
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _devices(v, out)
    return out


def fence(*tensors):
    """Wait until the card has finished the work behind `tensors` (nested
    lists, tuples and dicts of tensors), only when fencing is on. CPU
    tensors are finished when they are returned."""
    if not (_ENABLED and _FENCE):
        return
    for dev in _devices(tensors, set()):
        torch.cuda.synchronize(dev)


def _add(name, seconds, span=None):
    with _LOCK:
        rec = _STAGES[name]
        rec[0] += 1
        rec[1] += seconds
        if span is not None:
            _SPANS.append(span)


def record(name, seconds):
    """Record an externally measured duration as a stage entry (no
    span)."""
    if not _ENABLED:
        return
    _add(name, seconds)


def count(name, n=1):
    """Add `n` to counter `name`. Callers count once per call, with the
    call's total."""
    if not _ENABLED:
        return
    with _LOCK:
        _COUNTERS[name] += n


def reset():
    with _LOCK:
        _STAGES.clear()
        _SPANS.clear()
        _COUNTERS.clear()


@contextlib.contextmanager
def stage_timer(name):
    if not _ENABLED:
        yield
        return
    names = _OPEN.names
    parent = names[-1] if names else None
    names.append(name)
    # the span encloses its profiler range: a range's first opening in a
    # process takes a fraction of a millisecond after its own stamp
    t0 = time.perf_counter_ns()
    try:
        if _autograd_profiler._is_profiler_enabled:
            with _autograd_profiler.record_function(name):
                yield
        else:
            yield
    finally:
        t1 = time.perf_counter_ns()
        names.pop()
        _add(name, (t1 - t0) / 1e9,
             Span(name, parent, threading.get_ident(),
                  t0 + _EPOCH_OFFSET_NS, t1 + _EPOCH_OFFSET_NS))


@contextlib.contextmanager
def device_trace(logdir):
    """`torch.profiler` over the block (host and, where there is a card,
    device activity); the trace is written to `logdir/trace.json`, with
    the enabled stages as ranges."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def get_report():
    with _LOCK:
        return {k: dict(calls=v[0], total_s=round(v[1], 4))
                for k, v in _STAGES.items()}


def get_spans():
    with _LOCK:
        return list(_SPANS)


def get_counters():
    with _LOCK:
        return dict(_COUNTERS)


def print_report():
    rep = get_report()
    counters = get_counters()
    if not rep and not counters:
        return
    width = max(len(k) for k in [*rep, *counters])
    for k, v in sorted(rep.items(), key=lambda kv: -kv[1]["total_s"]):
        print(f"{k:<{width}}  calls={v['calls']:<4d} "
              f"total={v['total_s']:.3f}s")
    for k, v in sorted(counters.items()):
        print(f"{k:<{width}}  count={v}")
