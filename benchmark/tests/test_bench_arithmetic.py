"""The metric arithmetic: nearest-rank p90, the union of device intervals,
idle gaps and the sampler's bytes and bound."""

import types

import numpy as np
import pytest

from benchmark import reference, stats, tracing
from benchmark.manifest import Manifest


def test_p90_nearest_rank_over_all_values():
    walls = [float(v) for v in range(1, 21)]          # 20 stitches
    assert stats.nearest_rank(walls, 0.9) == 18.0      # ceil(18) = 18th
    assert stats.nearest_rank(list(reversed(walls)), 0.9) == 18.0
    assert stats.nearest_rank([3.0], 0.9) == 3.0
    assert stats.nearest_rank([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0,
                               9.0, 10.0, 11.0], 0.9) == 10.0


def test_spread_is_iqr_over_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (4.5 - 1.5) / 3.0)
    # a tightness reading leaves out the run farthest off
    assert stats.trimmed_spread([1.0, 2.0, 3.0, 4.0, 5.0, 100.0]) == (
        pytest.approx(stats.spread([1.0, 2.0, 3.0, 4.0, 5.0])))


def test_union_counts_overlapping_streams_once():
    dev = [("k1", 0, 100), ("copy", 50, 150), ("k2", 200, 300),
           ("k3", 210, 220), ("set", 300, 310)]
    assert tracing.merged([(s, e) for _, s, e in dev]) == [[0, 150],
                                                           [200, 310]]
    assert tracing.busy_seconds(dev) == pytest.approx(260e-9)
    # the naive sum counts 100 + 100 + 100 + 10 + 10 = 320 ns
    assert sum(e - s for _, s, e in dev) == 320


def test_idle_share_reader():
    man = Manifest()
    r = man.metric_reader("device_idle_share")
    ctx = types.SimpleNamespace(device=[("k", 0, 250_000_000),
                                        ("c", 100_000_000, 500_000_000)],
                                window_s=1.0)
    assert r.read(ctx) == pytest.approx(0.5)
    assert r.read(types.SimpleNamespace(device=[], window_s=1.0)) is None


def test_idle_gaps_named_by_innermost_host_event():
    dev = [("a", 0, 10), ("b", 100, 110), ("c", 130, 140)]
    host = [("outer", 0, 200), ("aten::item", 40, 80), ("sync", 115, 129)]
    gaps = tracing.idle_gaps(dev, host)
    assert gaps[0] == ["aten::item", 90e-9]
    assert gaps[1] == ["sync", 20e-9]
    assert tracing.idle_gaps(dev, []) [0][0] == "host, no profiled event open"


def test_top_ops_sums_by_name():
    dev = [("k", 0, 10), ("k", 20, 40), ("m", 0, 25)]
    assert tracing.top_ops(dev) == [["k", 30e-9], ["m", 25e-9]]


IDENTITY = dict(focal=1.0, aspect=1.0, ppx=0.0, ppy=0.0, R=np.eye(3))
NATIVE = dict(warper="affine", medium_megapix=-1, low_megapix=-1,
              final_megapix=-1, crop=True)


def test_sampler_bytes_from_the_layout():
    r = Manifest().metric_reader("sampler_roofline")
    # output written once; source read once, counted at most the output
    assert r.warp_bytes(600 * 800, 1152 * 1472, 3) == (
        (1152 * 1472 + 600 * 800) * 3 * 4)
    assert r.warp_bytes(1200 * 1600, 100 * 100, 3) == 2 * 100 * 100 * 12
    # one view at native size under the identity: its LOW and its FINAL
    # warp each fill the view's own ROI
    shapes = [(120, 160, 3)]
    full = r.warp_bytes(120 * 160, 120 * 160, 3)
    assert r.stitch_bytes(shapes, [IDENTITY], None, NATIVE) == 2 * full
    # cropped: the FINAL warp needs only its part of the crop
    assert r.stitch_bytes(shapes, [IDENTITY], (0, 0, 80, 60), NATIVE) == (
        full + r.warp_bytes(120 * 160, 80 * 60, 3))


def test_sampler_share_of_its_bound():
    r = Manifest().metric_reader("sampler_roofline")
    last = {"cameras": [IDENTITY], "lir": (0, 0, 80, 60)}
    stitches = [([(120, 160, 3)], last)] * 2
    nbytes = 2 * r.stitch_bytes([(120, 160, 3)], [IDENTITY], (0, 0, 80, 60),
                                NATIVE)
    t_ns = 2 * nbytes / r.HBM_BYTES_PER_S * 1e9     # twice the bound
    ctx = types.SimpleNamespace(
        device=[("void bilinear_sample_kernel(float const*)", 0, t_ns),
                ("other", 0, 10 ** 9)],
        stitches=stitches, settings=NATIVE)
    assert r.read(ctx) == pytest.approx(50.0, rel=1e-6)
    # no sampler kernel in the trace: absent, never 0
    ctx.device = [("other", 0, 10 ** 9)]
    assert r.read(ctx) is None


def _brute_area(m):
    H, W = m.shape
    return max([(y1 - y0) * (x1 - x0)
                for y0 in range(H) for y1 in range(y0 + 1, H + 1)
                for x0 in range(W) for x1 in range(x0 + 1, W + 1)
                if m[y0:y1, x0:x1].all()] + [0])


def test_largest_rectangle_against_every_rectangle():
    rng = np.random.default_rng(0)
    for _ in range(150):
        m = rng.random((rng.integers(1, 7), rng.integers(1, 8))) < 0.7
        x, y, w, h = reference.largest_rectangle(m)
        assert w * h == _brute_area(m)
        assert m[y:y + h, x:x + w].all()


def test_crop_numbers():
    m = np.zeros((40, 60), bool)
    m[5:35, 10:50] = True
    m[5:8, 10:14] = False                 # a corner no view covers
    best = reference.largest_rectangle(m)
    sound = reference.crop_numbers(m, best)
    assert sound["crop_outside_share"] == 0.0
    assert sound["crop_area_short"] <= 0.0
    # a pixel of room: a rectangle one row larger is still sound
    x, y, w, h = best
    assert reference.crop_numbers(m, (x, y - 1, w, h + 1))[
        "crop_outside_share"] == 0.0
    # the bounding box reaches into the uncovered corner
    bbox = reference.crop_numbers(m, (10, 5, 40, 30))
    assert bbox["crop_outside_share"] == pytest.approx(2 * 3 / (40 * 30))
    halved = reference.crop_numbers(m, (x, y, w // 2, h))
    assert halved["crop_area_short"] > 0.4
