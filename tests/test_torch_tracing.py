"""The port's own tracing (`stitching_tpu_torch.profiling`): spans nested
by thread, on the profiler's clock, the counters, and nothing recorded
while it is off.

One fenced `Stitcher(device="cpu")` stitch of `rotation_set(n=3, size=
(1200, 900))` takes the streamed branch (inputs over the MEDIUM size)
under `torch.profiler`: every stage opens a profiler range of its name,
and each span starts within 1 ms of its range. The counters are held
against independent counts: the flood fill's rounds on masks whose shape
fixes them, and the LM loop's trial steps against its residual
evaluations.
"""

import contextlib
import sys
import threading
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch
from torch._C._functorch import is_functorch_wrapped_tensor
from torch.profiler import ProfilerActivity, profile

from fixtures import rotation_set
from stitching_tpu_torch import Stitcher, cropper, profiling
from stitching_tpu_torch.ops import bundle

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)

N_VIEWS = 3

# the spans inside another stage, with the stage they nest in
NESTED = {"low/crop/paste": "low/crop", "low/crop/flood_fill": "low/crop",
          "low/crop/lir": "low/crop", "low/crop/slice": "low/crop",
          "final/upload_wait": "final/stream",
          "final/stream/warp": "final/stream",
          "final/stream/feed": "final/stream"}


@contextlib.contextmanager
def tracing(fence=True):
    profiling.reset()
    profiling.enable()
    profiling.enable_fence(fence)
    try:
        yield
    finally:
        profiling.enable(False)
        profiling.enable_fence(False)
        profiling.reset()


@pytest.fixture(scope="module")
def images():
    imgs, _, _ = rotation_set(n=N_VIEWS, size=(1200, 900), focal=1000,
                              max_angle=0.3)
    return imgs


@pytest.fixture(scope="module")
def traced(images):
    """One fenced stitch under `torch.profiler`: the spans, the counters
    and the profiler's range starts by name."""
    with tracing():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            Stitcher(device="cpu").stitch(images)
        spans, counters = profiling.get_spans(), profiling.get_counters()
    starts = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        starts[e.name()].append(e.start_ns())
    return spans, counters, starts


def test_new_spans_nest_in_their_stages(traced):
    spans, _, _ = traced
    pairs = Counter((s.name, s.parent) for s in spans)
    for name, parent in NESTED.items():
        calls = N_VIEWS if name.startswith("final/") else 1
        assert pairs[(name, parent)] == calls, name
        assert sum(n for (nm, _), n in pairs.items() if nm == name) == calls
    # the rest are top-level stages, all in the caller's thread
    tops = {s.name for s in spans if s.parent is None}
    assert tops >= {"registration/bundle_adjust", "low/crop",
                    "final/stream", "final/blend"}
    assert not tops & set(NESTED)
    assert len({s.thread for s in spans}) == 1
    # each nested span lies inside one span of its parent
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            assert any(p.name == s.parent and p.start_ns <= s.start_ns
                       and s.end_ns <= p.end_ns for p in spans), s


def test_counters_of_the_stitch(traced):
    _, counters, _ = traced
    assert set(counters) == {"bundle/iterations", "crop/flood_rounds",
                             "match/pairs", "bundle/edges"}
    assert counters["bundle/iterations"] >= 1
    assert counters["match/pairs"] == N_VIEWS * (N_VIEWS - 1) // 2
    assert 1 <= counters["bundle/edges"] <= counters["match/pairs"]
    assert counters["crop/flood_rounds"] >= 1


def test_no_band_lands_in_place_on_the_cpu(traced):
    """The CPU writes its bands into the host panorama at once: the copy
    engine lands none, and no copy is waited on."""
    spans, counters, _ = traced
    assert counters.get("fetch/bands_in_place", 0) == 0
    assert "final/blend/wait" not in {s.name for s in spans}


def test_every_stage_is_a_profiler_range(traced):
    spans, _, starts = traced
    made = Counter(s.name for s in spans)
    for name, calls in made.items():
        assert len(starts[name]) == calls, name


def test_spans_lie_on_the_profilers_clock(traced):
    spans, _, starts = traced
    by_name = defaultdict(list)
    for s in spans:
        by_name[s.name].append(s.start_ns)
    for name, ours in by_name.items():
        for a, b in zip(sorted(ours), sorted(starts[name])):
            assert abs(a - b) < 1_000_000, (name, a - b)


def test_nothing_recorded_while_disabled(images):
    profiling.reset()
    Stitcher(device="cpu").stitch(images)
    with profiling.stage_timer("low/crop"):
        profiling.count("crop/flood_rounds", 5)
    assert profiling.get_spans() == []
    assert profiling.get_counters() == {}
    assert profiling.get_report() == {}


def _strip(kind, n):
    """A mask holding one region whose flood fill from its first pixel
    takes a known number of rounds: (mask, rounds)."""
    if kind == "row":               # 1 x n, off the mask's left edge
        m = np.zeros((1, n + 5), np.uint8)
        m[0, 3:3 + n] = 255
        return m, n
    if kind == "column":
        m = np.zeros((n + 2, 1), np.uint8)
        m[1:1 + n] = 1
        return m, n
    m = np.zeros((n + 2, n + 2), bool)   # n x n, grown from a corner
    m[1:1 + n, 1:1 + n] = True
    return m, 2 * n - 1


@pytest.mark.parametrize("kind,n", [("row", 2), ("row", 7), ("row", 64),
                                    ("column", 9), ("square", 6)])
def test_flood_rounds_fixed_by_the_shape(kind, n):
    """The region grows one pixel of reach a round, and one more round
    finds nothing new."""
    mask, rounds = _strip(kind, n)
    with tracing(fence=False):
        region = cropper.single_region(mask)
        counters = profiling.get_counters()
    assert np.array_equal(region, mask > 0)
    assert counters == {"crop/flood_rounds": rounds}


@pytest.mark.parametrize("max_iters", [3, 100])
def test_bundle_iterations_count_the_trial_steps(max_iters):
    """Rosenbrock's valley as residuals: the loop evaluates them once
    before its first step and once a trial step (the Jacobian's calls run
    under `jacfwd`'s transform and are not counted)."""
    calls = []

    def residual(x):
        if not is_functorch_wrapped_tensor(x):
            calls.append(1)
        return torch.stack([10 * (x[1] - x[0] ** 2), 1 - x[0]])

    with tracing(fence=False):
        x, _ = bundle._lm_engine(torch.tensor([-1.2, 1.0]), residual,
                                 max_iters)
        steps = profiling.get_counters()["bundle/iterations"]
    assert steps == len(calls) - 1
    if max_iters == 3:
        assert steps == 3
    else:
        assert 3 < steps < max_iters
        assert torch.allclose(x, torch.ones(2), atol=1e-2)


def test_spans_nest_per_thread():
    """A thread's spans take their parents from its own open spans."""
    def side():
        with profiling.stage_timer("side"):
            with profiling.stage_timer("side/step"):
                pass

    with tracing(fence=False):
        with profiling.stage_timer("outer"):
            worker = threading.Thread(target=side)
            with profiling.stage_timer("inner"):
                worker.start()
                worker.join()
        spans = {s.name: s for s in profiling.get_spans()}
    assert spans["inner"].parent == "outer"
    assert spans["outer"].parent is None
    assert spans["side"].parent is None
    assert spans["side/step"].parent == "side"
    assert spans["side"].thread != spans["outer"].thread


def test_threads_lose_no_count():
    """More threads than cores, switching often: every count and every
    stage lands."""
    threads, rounds = 16, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing(fence=False):
            def work():
                for _ in range(rounds):
                    with profiling.stage_timer("w"):
                        profiling.count("n")
                        profiling.count("m", 2)

            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
            counters = profiling.get_counters()
            calls = profiling.get_report()["w"]["calls"]
            spans = profiling.get_spans()
    finally:
        sys.setswitchinterval(interval)
    assert counters == {"n": threads * rounds, "m": 2 * threads * rounds}
    assert calls == len(spans) == threads * rounds
    assert all(s.parent is None for s in spans)


def test_span_list_is_bounded():
    with tracing(fence=False):
        for _ in range(profiling.SPAN_CAPACITY + 7):
            with profiling.stage_timer("s"):
                pass
        assert len(profiling.get_spans()) == profiling.SPAN_CAPACITY
        assert profiling.get_report()["s"]["calls"] == (
            profiling.SPAN_CAPACITY + 7)


def test_print_report_lists_the_counters(capsys):
    with tracing(fence=False):
        with profiling.stage_timer("low/crop"):
            profiling.count("crop/flood_rounds", 12)
        profiling.count("crop/flood_rounds", 3)
        profiling.print_report()
    out = capsys.readouterr().out
    assert "low/crop" in out and "calls=1" in out
    assert "crop/flood_rounds" in out and "count=15" in out
