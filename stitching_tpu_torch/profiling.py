"""Stage timers, fences and device traces.

Port of `stitching_tpu/profiling.py`. It is off until a caller switches
it on; nothing here reads the environment:

- `enable()`: `stage_timer(name)` records the wall time of each pipeline
  stage into a process-wide report (the engine names its stages
  `registration/upload`, `final/stream`, `final/blend`, ...);
- `enable_fence()`: `fence(*tensors)` at a stage's end synchronises the
  card, so each stage's time covers its own device work. Without it the
  card runs ahead of the host and a stage's work lands in whichever later
  stage first waits on it. Fenced runs are for attribution; a wall time
  comes from an unfenced run;
- `record(name, seconds)`: a duration measured elsewhere (the uploader's
  thread) as a stage entry;
- `get_report()`, `print_report()`, `reset()`: the stage table;
- `device_trace(logdir)`: `torch.profiler` over the block, written to
  `logdir` as a Chrome trace.
"""

import contextlib
import os
import threading
import time
from collections import defaultdict

import torch

_ENABLED = False
_FENCE = False
_STAGES = defaultdict(lambda: [0, 0.0])  # name -> [count, total_s]
_LOCK = threading.Lock()                 # the uploader's thread records too


def enable(on=True):
    global _ENABLED
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


def record(name, seconds):
    """Record an externally measured duration as a stage entry."""
    if not _ENABLED:
        return
    with _LOCK:
        rec = _STAGES[name]
        rec[0] += 1
        rec[1] += seconds


def reset():
    with _LOCK:
        _STAGES.clear()


@contextlib.contextmanager
def stage_timer(name):
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record(name, time.perf_counter() - t0)


@contextlib.contextmanager
def device_trace(logdir):
    """`torch.profiler` over the block (host and, where there is a card,
    device activity); the trace is written to `logdir/trace.json`."""
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


def print_report():
    rep = get_report()
    if not rep:
        return
    width = max(len(k) for k in rep)
    for k, v in sorted(rep.items(), key=lambda kv: -kv[1]["total_s"]):
        print(f"{k:<{width}}  calls={v['calls']:<4d} "
              f"total={v['total_s']:.3f}s")
