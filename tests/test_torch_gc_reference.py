"""The port's graph cut against the plain reference `benchmark/
gc_reference.py` (float64, an exact max-flow, no iteration cap).

- `min_cut` against the port's `grid_min_cut` on seeded random grids (the
  same labels, the same value within `VALUE_RTOL`), and against every
  cut of grids of 12 pixels;
- the port's `gc_seams_stack` (and through it `seam_cut_pair`) against
  the reference's `gc_seams` on seeded overlap tiles: 3 and 4 views of
  48 x 64 tiles, and one pair whose 128 x 136 overlap takes the
  coarse-to-fine pass, for COST_COLOR and COST_COLOR_GRAD;
- two controls that must fail those tolerances: the port's loop cut to
  16 iterations, and the reference with its capacities in bfloat16;
- the span `low/seam_find/cut` and the counters `gc/levels`,
  `gc/iterations`, `gc/host_reads` and `gc/cut_launches` of a traced
  stitch, and the benchmark's reader of the last;
- on the card (`-m cuda`), one view set of the cell `pano-gc.rot6-12mp`
  at full size (`benchmark/gc_check.py`).

The tolerances are `gc_reference.VALUE_RTOL` (the port's float32
capacities move a cut by at most 2**-24 of it, the reference's float64
ones by far less) and `LABEL_SHARE` (the largest minimum source side is
unique). This file imports no JAX; on the card:

    python -m pytest --noconftest tests/test_torch_gc_reference.py -m cuda
"""

import ast
import functools
import itertools
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import gc_check, generators  # noqa: E402
from benchmark import gc_reference as ref  # noqa: E402
from stitching_tpu_torch import Stitcher, profiling  # noqa: E402
from stitching_tpu_torch.ops import graphcut, seam  # noqa: E402

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)

GRID_SEEDS = range(20)
CONTROL_ITERS = 16


def random_grid(seed, h, w):
    """Random edge capacities in [0.1, 2); the left column tied to the
    source and the right one to the sink (100), a tenth of the pixels
    with small source or sink capacities besides."""
    rng = np.random.RandomState(seed)
    cap = rng.uniform(0.1, 2.0, (4, h, w)).astype(np.float32)
    cap[0][:, -1] = 0
    cap[1][:, 0] = 0
    cap[2][-1, :] = 0
    cap[3][0, :] = 0
    s = np.zeros((h, w), np.float32)
    t = np.zeros((h, w), np.float32)
    s[:, 0] = 100
    t[:, -1] = 100
    s += ((rng.rand(h, w) < 0.1)
          * rng.uniform(0, 3, (h, w))).astype(np.float32)
    t += ((rng.rand(h, w) < 0.1)
          * rng.uniform(0, 3, (h, w))).astype(np.float32)
    return cap, s, t


def grid_of(seed):
    return random_grid(seed, *((24, 32) if seed % 2 else (9, 13)))


def port_cut(grid, **kw):
    got, stats = graphcut.grid_min_cut(*(torch.tensor(a)[None]
                                         for a in grid), **kw)
    return got[0].numpy(), stats


def bfloat16(*arrays):
    return [torch.tensor(a).to(torch.bfloat16).double().numpy()
            for a in arrays]


@pytest.mark.parametrize("seed", GRID_SEEDS)
def test_min_cut_equals_the_port(seed):
    grid = grid_of(seed)
    src, value = ref.min_cut(*grid)
    got, stats = port_cut(grid)
    assert 0 < stats["iterations"] < 2000
    np.testing.assert_array_equal(got, src)
    # the flow's value is the cut's capacity
    assert abs(ref.cut_value(*grid, src) - value) <= 1e-12 * value
    assert abs(ref.cut_value(*grid, got) - value) <= ref.VALUE_RTOL * value


def all_cuts(grid):
    """Every labelling's capacity: [(value, src_side)]."""
    h, w = grid[1].shape
    out = []
    for bits in itertools.product([False, True], repeat=h * w):
        src = np.array(bits).reshape(h, w)
        out.append((ref.cut_value(*grid, src), src))
    return out


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("tie", ["plain", "big"])
def test_min_cut_equals_every_cut(seed, tie):
    """On 3 x 4 grids: the least capacity of all 4,096 labellings, and the
    union of the minimal ones (the largest minimum source side). "big"
    ties two pixels to the terminals with BIG, which `min_cut` merges
    into them."""
    rng = np.random.RandomState(100 + seed)
    h, w = 3, 4
    cap = rng.uniform(0.1, 2.0, (4, h, w))
    cap[0][:, -1] = 0
    cap[1][:, 0] = 0
    cap[2][-1, :] = 0
    cap[3][0, :] = 0
    # whole numbers in a quarter of the edges make equal cuts likely
    cap = np.where(rng.rand(4, h, w) < 0.25, np.round(cap), cap)
    s = rng.uniform(0, 2, (h, w)) * (rng.rand(h, w) < 0.4)
    t = rng.uniform(0, 2, (h, w)) * (rng.rand(h, w) < 0.4)
    if tie == "big":
        s[0, 0], t[2, 3] = ref.BIG, ref.BIG
    grid = (cap, s, t)
    cuts = all_cuts(grid)
    least = min(v for v, _ in cuts)
    largest = np.any([c for v, c in cuts if v <= least * (1 + 1e-12)],
                     axis=0)
    src, value = ref.min_cut(*grid)
    assert abs(value - least) <= 1e-12 * least
    np.testing.assert_array_equal(src, largest)


def test_truncated_loop_fails_on_grids():
    """The control: the port's loop stopped at 16 iterations."""
    failed = 0
    for seed in GRID_SEEDS:
        grid = grid_of(seed)
        src, value = ref.min_cut(*grid)
        got, stats = port_cut(grid, max_iters=CONTROL_ITERS)
        assert stats["iterations"] <= CONTROL_ITERS
        excess = (ref.cut_value(*grid, got) - value) / value
        failed += excess > ref.VALUE_RTOL or bool((got != src).any())
    assert failed >= len(GRID_SEEDS) // 2, failed


def test_bfloat16_fails_on_grids():
    """The control: the reference with its capacities in bfloat16, the
    precision below the float32 the port states, reports a minimum off
    by more than VALUE_RTOL on every grid."""
    for seed in GRID_SEEDS:
        grid = grid_of(seed)
        _, value = ref.min_cut(*grid)
        _, low = ref.min_cut(*bfloat16(*grid))
        assert abs(low - value) > ref.VALUE_RTOL * value, seed


# ---------------------------------------------------------------------------
# Seams of overlap tiles
# ---------------------------------------------------------------------------

# (views, tile height, tile width, step): 48 x 64 tiles whose overlaps
# are cut flat, and one pair of 136 x 200 tiles whose 136 x 128 overlap
# (a 192 x 128 window) is cut coarse first
LAYOUTS = {"views3": (3, 48, 64, 22), "views4": (4, 48, 64, 18),
           "pair128": (2, 136, 200, 72)}


def tile_stack(layout, seed):
    """Views of one smooth scene, each with noise of its own, at corners
    `step` apart; each mask's left and right edges wave, so that every
    overlap holds pixels of one view only on either side. Returns (data
    (B, TH, TW, 3) float32, masks (B, TH, TW) {0, 255}, corners, sizes)."""
    n, th, tw, step = LAYOUTS[layout]
    rng = np.random.RandomState(seed)
    H, W = th + 8, step * (n - 1) + tw
    coarse = torch.tensor(rng.uniform(0, 255, (1, 3, H // 8 + 2,
                                                W // 8 + 2)))
    scene = F.interpolate(coarse, size=(H, W), mode="bilinear",
                          align_corners=False)[0].permute(1, 2, 0).numpy()
    corners = np.array([(k * step, rng.randint(0, 8)) for k in range(n)])
    sizes = np.array([(tw, th)] * n)
    data = np.zeros((n, th, tw, 3), np.float32)
    masks = np.zeros((n, th, tw), np.float32)
    y = np.arange(th)[:, None]
    x = np.arange(tw)[None, :]
    for k, (cx, cy) in enumerate(corners):
        data[k] = np.clip(scene[cy:cy + th, cx:cx + tw]
                          + rng.normal(0, 6, (th, tw, 3)), 0, 255)
        a, b = rng.uniform(2, 8, 2)
        p, q = rng.uniform(0, 6.3, 2)
        left = a + a * np.sin(y / rng.uniform(4, 12) + p)
        right = tw - 1 - b - b * np.sin(y / rng.uniform(4, 12) + q)
        masks[k] = np.where((x >= left) & (x <= right), 255.0, 0.0)
    return data, masks, corners, sizes


def port_seams(layout, seed, use_grad, **cut_kw):
    """The port's seams of a tile stack under `gc_check.Capture`, and the
    comparison with the reference: (pairs, seam mask disagreement, the
    port's min-cut levels)."""
    data, masks, corners, sizes = tile_stack(layout, seed)
    with gc_check.Capture() as cap:
        if cut_kw:
            graphcut.grid_min_cut = functools.partial(graphcut.grid_min_cut,
                                                      **cut_kw)
        out = seam.gc_seams_stack(torch.tensor(data), torch.tensor(masks),
                                  corners, sizes, use_grad)
    (own_i, levels), = cap.cuts
    stack = (torch.tensor(data), torch.tensor(masks), corners, sizes,
             use_grad, out)
    pairs, differ, _ = gc_check.compare_stack(stack, own_i, levels)
    return pairs, differ, levels


CASES = [(layout, seed) for layout in LAYOUTS for seed in (1, 2)]


@pytest.mark.parametrize("use_grad", [False, True])
@pytest.mark.parametrize("layout,seed", CASES)
def test_seams_equal_the_reference(layout, seed, use_grad):
    pairs, differ, levels = port_seams(layout, seed, use_grad)
    n = LAYOUTS[layout][0]
    assert len(pairs) == n * (n - 1) // 2
    # the coarse-to-fine pass runs where the window is 128 or more
    assert len(levels) == (2 if layout == "pair128" else 1)
    assert all(lv["stats"]["iterations"] < lv["max_iters"] for lv in levels)
    for p in pairs:
        assert not ref.faults(p), p
        assert p["disagree"] <= ref.LABEL_SHARE, p
    assert differ == 0.0
    # each cut is a seam: both views keep part of the overlap
    assert all(0 < p["share_i"] < 1 for p in pairs), pairs


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_truncated_loop_fails_on_seams(layout):
    pairs, _, levels = port_seams(layout, 1, False,
                                  max_iters=CONTROL_ITERS)
    assert levels[-1]["stats"]["iterations"] == CONTROL_ITERS
    assert any(ref.faults(p) or p["disagree"] > ref.LABEL_SHARE
               for p in pairs)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_bfloat16_fails_on_seams(layout, monkeypatch):
    data, masks, corners, sizes = tile_stack(layout, 1)
    _, cuts = ref.gc_seams(data, masks, corners, sizes, False)
    caps = ref.pair_caps

    def edges_in_bfloat16(*args):
        cap_dir, s_cap, t_cap = caps(*args)
        return bfloat16(cap_dir)[0], s_cap, t_cap

    monkeypatch.setattr(ref, "pair_caps", edges_in_bfloat16)
    _, low = ref.gc_seams(data, masks, corners, sizes, False)
    assert any(abs(c.value - b.value) > ref.VALUE_RTOL * max(c.value, 1.0)
               for c, b in zip(cuts, low))


# ---------------------------------------------------------------------------
# Tracing, and what the reference imports
# ---------------------------------------------------------------------------

GC_COUNTERS = ("gc/levels", "gc/iterations", "gc/host_reads",
               "gc/cut_launches")


def traced_stitch(finder):
    """One fenced stitch of 3 views of the cell's traffic, shrunk five
    times (its resolutions with it): the spans, the counters and the
    graph cut's levels."""
    traffic = json.load(open(os.path.join(ROOT, "benchmark", "traffic",
                                          "rot6-12mp.json")))
    views, _ = generators.make(dict(traffic, views=3),
                               generators.set_seed(7, 0),
                               torch.device("cpu"), 0.2)
    st = Stitcher(finder=finder, device="cpu", medium_megapix=0.024,
                  low_megapix=0.004)
    profiling.reset()
    profiling.enable()
    profiling.enable_fence()
    try:
        with gc_check.Capture() as cap:
            st.stitch(views)
        return profiling.get_spans(), profiling.get_counters(), cap.levels
    finally:
        profiling.enable(False)
        profiling.enable_fence(False)
        profiling.reset()


def test_traced_gc_stitch_records_the_cut():
    spans, counters, levels = traced_stitch("gc_color")
    cuts = [s for s in spans if s.name == "low/seam_find/cut"]
    assert len(cuts) == len(levels) >= 1
    assert all(s.parent == "low/seam_find" for s in cuts)
    (seam_span,) = [s for s in spans if s.name == "low/seam_find"]
    assert all(seam_span.start_ns <= s.start_ns <= s.end_ns
               <= seam_span.end_ns for s in cuts)
    assert counters["gc/levels"] == len(levels)
    for name in ("iterations", "host_reads"):
        assert counters["gc/" + name] == sum(lv["stats"][name]
                                             for lv in levels)
    assert counters["gc/host_reads"] > 0


def test_traced_cpu_cut_runs_the_plain_loop():
    """On the CPU each level runs the plain loop: no kernel launch, and
    its host reads: at least one of the loop's end, one of each global
    relabel's BFS, one of the last BFS and one of the iterations."""
    _, counters, levels = traced_stitch("gc_color")
    assert counters["gc/cut_launches"] == 0
    assert all(lv["stats"]["launches"] == 0 for lv in levels)
    assert counters["gc/host_reads"] == sum(lv["stats"]["host_reads"]
                                            for lv in levels)
    assert all(lv["stats"]["host_reads"] >= lv["stats"]["relabels"] + 3
               for lv in levels)


def test_benchmark_reader_counts_cut_launches(monkeypatch):
    from benchmark import program_record
    from benchmark.manifest import Manifest

    reader = Manifest().metric_reader("gc_cut_launches")
    kept = {"spans": [], "counters": {}, "allocs": []}
    monkeypatch.setattr(program_record, "_KEPT", kept)
    ctx = types.SimpleNamespace(fenced=3, traced=3)
    kept["counters"] = {"gc/cut_launches": 6, "gc/levels": 6}
    assert reader.read(ctx) == 2
    kept["counters"] = {"gc/levels": 6, "gc/host_reads": 300}  # no kernel
    assert reader.read(ctx) is None
    ctx.fenced = 0
    kept["counters"] = {"gc/cut_launches": 6}
    assert reader.read(ctx) is None
    entry, = [m for m in Manifest().data["per_layer"]
              if m["name"] == "gc_cut_launches"]
    assert entry["layer"] == "seams"
    assert entry["workloads"] == ["pano-gc.rot6-12mp"]


def test_traced_dp_stitch_records_no_cut():
    spans, counters, levels = traced_stitch("dp_color")
    assert not levels
    assert "low/seam_find" in {s.name for s in spans}
    assert "low/seam_find/cut" not in {s.name for s in spans}
    assert not set(GC_COUNTERS) & set(counters)


def test_reference_imports_nothing_of_the_port():
    path = os.path.join(ROOT, "benchmark", "gc_reference.py")
    tree = ast.parse(open(path).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or ".").split(".")[0])
    assert mods <= {"math", "collections", "numpy", "torch"}, mods
    code = ("import json, sys; from benchmark import gc_reference; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "cv2", "stitching_tpu",
                         "stitching_tpu_torch"}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's sizes run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cut_at_the_cells_size(card):
    """One view set of `pano-gc.rot6-12mp` (6 x 4032x3024) stitched with
    `Stitcher(finder="gc_color")` on the card: every pair's cut at the
    reference's minimum within VALUE_RTOL, no level at its cap."""
    from benchmark.manifest import Manifest

    man = Manifest()
    cell = man.workload("pano-gc.rot6-12mp")
    views, _ = generators.make(man.traffic(cell["traffic"]),
                               generators.set_seed(11, 0), card)
    st = Stitcher(device=card, **man.config(cell["config"])["kwargs"])
    row = gc_check.check_set(st, views)
    assert row["pairs"]
    assert not any(lv["at_cap"] for lv in row["levels"]), row["levels"]
    assert row["faults"] == 0, [p for p in row["pairs"] if p["faults"]]
