"""What the program records about itself in a traced run: its spans and
counters from the fenced part, and the caching allocator's `cudaMalloc`
calls over the profiled part.

`run.py` loads the metric readers just before the profiled part, and
ends the fenced part with `profiling.reset()`, which clears the program's
record before any reader runs. So a reader of the record calls `arm()`
when it is loaded. `arm()` reads the allocator's `num_device_alloc` (the
profiled part starts next) and wraps `profiling.reset` once, so that
each reset first keeps what the program recorded
(`profiling.get_spans()` and `get_counters()`, where the program has
them), and the first reset after `arm()`, which opens the fenced part,
reads `num_device_alloc` again. A program without spans or counters
leaves them empty, and a reader finds nothing to read.
"""

import sys

PROFILING = "stitching_tpu_torch.profiling"

_KEPT = {"spans": [], "counters": {}, "allocs": []}


def _device_allocs():
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return torch.cuda.memory_stats().get("num_device_alloc")


def _keep(profiling):
    _KEPT["spans"] = list(getattr(profiling, "get_spans", list)())
    _KEPT["counters"] = dict(getattr(profiling, "get_counters", dict)())
    if len(_KEPT["allocs"]) == 1:
        _KEPT["allocs"].append(_device_allocs())


def arm():
    """Start a run's record: the allocator's count now, and the program's
    `reset` wrapped (once a process) to keep what it clears."""
    _KEPT.update(spans=[], counters={}, allocs=[_device_allocs()])
    profiling = sys.modules.get(PROFILING)
    if profiling is None or getattr(profiling.reset, "keeps_record", False):
        return
    reset = profiling.reset

    def keeping_reset():
        _keep(profiling)
        reset()

    keeping_reset.keeps_record = True
    profiling.reset = keeping_reset


def spans():
    """The program's spans from the fenced part: tuples (name, parent,
    thread, start_ns, end_ns)."""
    return _KEPT["spans"]


def counters():
    """The program's counters from the fenced part: {name: count}."""
    return _KEPT["counters"]


def device_allocs():
    """`cudaMalloc` calls of the caching allocator over the profiled part;
    None off the card, or where the allocator does not count them."""
    allocs = _KEPT["allocs"]
    if len(allocs) != 2 or None in allocs:
        return None
    return allocs[1] - allocs[0]


def span_seconds(name):
    """Seconds in the program's spans named `name`; None if there is
    none."""
    got = [end - start for nm, _, _, start, end in spans() if nm == name]
    return sum(got) / 1e9 if got else None
