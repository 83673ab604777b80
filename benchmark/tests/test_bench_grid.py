"""Multi-row captures: the rotation generator's pitch-and-yaw grid, and
the judge over the truth's neighbour pairs. All on the CPU at shrunken
sizes.

- A single-row traffic draws the same views and truth as before grids
  were added (digests taken before that change, on the CPU).
- A grid comes in serpentine order, and its truth names every pair of
  grid neighbours: the views that overlap beyond a corner.
- With no `pairs` the judge reads as before; with them it sees a
  vertical pair that the pairs (i, i + 1) miss.
- A 3 x 6 grid of 12 MP views, shrunk, goes end to end through
  `run.main` from a manifest of its own, and comes out not correct with
  its rows fanned apart.
"""

import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from benchmark import generators, manifest, reference, run
from benchmark.manifest import Manifest

CPU = torch.device("cpu")
GRID_CELL = "pano-default.grid18-12mp"
# 3 rows x 6 columns of rot6-12mp's views: yaw +-1.55 rad in steps of
# 0.62 and pitch -0.49 / 0 / +0.49 rad, some 40% overlap each way; the
# scene as dense in blocks as rot6-12mp's, as large as every view needs
GRID = {"generator": "rotation", "views": 18, "rows": 3, "width": 4032,
        "height": 3024, "focal": 3528.0, "max_angle": 1.55,
        "max_pitch": 0.49,
        "scene": {"height": 2520, "width": 6400, "blocks": 4480,
                  "scale": 2.52},
        "pool": 3}
# a size and seed at which the port keeps every view of the grid
GRID_SHRINK, GRID_SEED = 0.3, 1


def digest(views, truth):
    h = hashlib.sha256()
    for v in views:
        h.update(str(v.shape).encode())
        h.update(np.ascontiguousarray(v).tobytes())
    for k in sorted(truth):
        val = truth[k]
        if k == "kind":
            h.update(val.encode())
        elif k == "offsets":
            h.update(json.dumps([list(map(int, o)) for o in val]).encode())
        elif k == "K":
            h.update(np.asarray(val, np.float64).tobytes())
        elif k == "Rs":
            for R in val:
                h.update(np.asarray(R, np.float64).tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("traffic, shrink, seed, want", [
    ("rot6-12mp", 0.1, 7, "26357a2c8d554294"),
    ("rot6-12mp", 0.1, 3000000019, "01dde2f1d7ad73aa"),
    ("rot8-2mp", 0.25, 7, "d57e27f5cbed98bd"),
    ("rot8-2mp", 0.25, 3000000019, "1a1ce233b2d145d9"),
    ("row8-2mp", 0.25, 7, "dd593a0ec41417e6"),
    ("row8-2mp", 0.25, 3000000019, "5bed9f65676ac89c"),
])
def test_single_row_traffic_draws_as_before(traffic, shrink, seed, want):
    views, truth = generators.make(Manifest().traffic(traffic),
                                   generators.set_seed(seed, 0), CPU, shrink)
    assert "pairs" not in truth
    assert digest(views, truth) == want


@pytest.mark.parametrize("rows, cols", [(3, 6), (2, 4), (4, 3), (1, 5)])
def test_grid_order_and_pairs(rows, cols):
    order = generators.grid_order(rows, cols)
    assert sorted(order) == [(r, c) for r in range(rows)
                             for c in range(cols)]
    pairs = generators.grid_pairs(rows, cols)
    assert len(pairs) == rows * (cols - 1) + cols * (rows - 1)
    assert len(set(pairs)) == len(pairs)
    for i, j in pairs:
        (ri, ci), (rj, cj) = order[i], order[j]
        assert i < j and abs(ri - rj) + abs(ci - cj) == 1
    # serpentine: each view and the next are grid neighbours
    assert set(zip(range(rows * cols - 1), range(1, rows * cols))) <= set(
        pairs)


def _judged_points(T, sizes, i, j):
    """How many of the judge's 9 x 9 points of view i the map T carries
    inside view j, in front of its camera."""
    q = reference._grid(sizes[i]) @ T.T
    want = q[:, :2] / q[:, 2:3]
    w, h = sizes[j]
    return int(((q[:, 2] > 0) & (want[:, 0] >= 0) & (want[:, 0] <= w - 1)
                & (want[:, 1] >= 0) & (want[:, 1] <= h - 1)).sum())


def test_grid_truth_pairs_are_the_views_that_overlap():
    views, truth = generators.make(GRID, generators.set_seed(7, 0), CPU,
                                   0.1)
    sizes = [(v.shape[1], v.shape[0]) for v in views]
    assert len(views) == 18 and len(set(sizes)) == 1
    assert truth["pairs"] == generators.grid_pairs(3, 6)
    assert len(truth["pairs"]) == 3 * 5 + 6 * 2 == 27
    K = truth["K"]
    w, h = sizes[0]
    near, far = [], []
    for i in range(18):
        for j in range(18):
            if i == j:
                continue
            T = K @ truth["Rs"][j].T @ truth["Rs"][i] @ np.linalg.inv(K)
            n = _judged_points(T, sizes, i, j)
            if tuple(sorted((i, j))) not in truth["pairs"]:
                far.append(n)
                continue
            # the point halfway between the two views' centres lies in
            # both, and the judge has points to compare
            other = np.linalg.inv(T) @ np.array([w / 2, h / 2, 1.0])
            mid = (np.array([w / 2, h / 2]) + other[:2] / other[2]) / 2
            q = T @ np.array([*mid, 1.0])
            q = q[:2] / q[2]
            assert 0 <= mid[0] < w and 0 <= mid[1] < h
            assert 0 <= q[0] < w and 0 <= q[1] < h, (i, j, q)
            near.append(n)
    # diagonal neighbours share a corner, views two columns or rows apart
    # less
    assert min(near) >= 9 and max(far) <= min(near) / 2, (min(near), max(far))


def test_grid_scene_too_small_or_rows_uneven_raises():
    small = dict(GRID, scene=dict(GRID["scene"], height=2300))
    with pytest.raises(ValueError, match="does not hold the view"):
        generators.make(small, 1, CPU, 0.1)
    with pytest.raises(ValueError, match="do not make 4 rows"):
        generators.make(dict(GRID, rows=4), 1, CPU, 0.1)


# ---------------------------------------------------------------------------
# The judge
# ---------------------------------------------------------------------------

def turn(axis, a):
    c, s = np.cos(a), np.sin(a)
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def true_cameras(truth, sizes, settings, perturb=True):
    """Cameras at MEDIUM resolution made from the truth, each turned a
    little where `perturb`, as a program's registration gives them."""
    s = reference.megapix_scale(settings["medium_megapix"], sizes[0])
    out = []
    for i in range(len(sizes)):
        if truth["kind"] == "rotation":
            K = truth["K"]
            e = 1e-3 * i if perturb else 0.0
            out.append(dict(focal=K[0, 0] * s * (1 + e), aspect=1.0,
                            ppx=K[0, 2] * s, ppy=K[1, 2] * s,
                            R=truth["Rs"][i] @ turn("y", 0.2 * e * i)))
        else:
            x, y = truth["offsets"][i]
            out.append(dict(focal=1.0, aspect=1.0, ppx=0.0, ppy=0.0,
                            R=np.array([[1.0, 1e-4 * i, -x * s],
                                        [0, 1, -y * s + 0.3 * i],
                                        [0, 0, 1]])))
    return out


@pytest.mark.parametrize("cell, shrink, reg, control", [
    ("pano-default.rot6-12mp", 0.1, 1.3579049080273236, 2.618446647338203),
    ("scan-sift.row8-2mp", 0.25, 0.30000000000001137, 1.375),
])
def test_judge_without_pairs_reads_as_before(cell, shrink, reg, control):
    """Readings taken before the judge took the truth's pairs."""
    man = Manifest()
    w = man.workload(cell)
    settings = man.config(w["config"])["reference"]
    views, truth = generators.make(man.traffic(w["traffic"]),
                                   generators.set_seed(7, 0), CPU, shrink)
    sizes = [(v.shape[1], v.shape[0]) for v in views]
    cams = true_cameras(truth, sizes, settings)
    assert reference.registration_error_px(cams, truth, sizes,
                                           settings) == reg
    assert reference.control_registration_error_px(truth, sizes) == control


def fan_angle(i, px, focal):
    """The rows of a 3 x 6 serpentine grid fanned apart about the world's
    vertical: the turn of view i, row 0's column c by (5 - c) steps, rows
    1 and 2 by -(5 - c), a step `px` pixels at `focal`. Each view and its
    row neighbour, and the pairs (5, 6) and (11, 12), stay within a step;
    the vertical pair of column 0 between rows 0 and 1, (0, 11), is ten
    steps off."""
    r, c = generators.grid_order(3, 6)[i]
    return (5 - c) * px / focal * (1 if r == 0 else -1)


def fan_rows(cameras, px, focal):
    return [dict(cam, R=turn("y", fan_angle(i, px, focal))
                 @ np.asarray(cam["R"])) for i, cam in enumerate(cameras)]


def turn_one(cameras, px, focal, k=8):
    """View k (row 1, column 3) pitched by `px` pixels: its vertical
    neighbours, views 3 and 15, see it that far off."""
    out = [dict(c) for c in cameras]
    out[k]["R"] = np.asarray(out[k]["R"]) @ turn("x", px / focal)
    return out


@pytest.mark.parametrize("fault, step", [(turn_one, 2.0), (fan_rows, 0.25)],
                         ids=["turn_one", "fan_rows"])
def test_judge_sees_a_vertical_pair_misregistered(fault, step):
    """`step` in shares of the limit."""
    settings = Manifest().config("pano-default")["reference"]
    limit = Manifest().limits("pano-default.rot6-12mp")["reg_err_px"]
    views, truth = generators.make(GRID, generators.set_seed(7, 0), CPU,
                                   0.1)
    sizes = [(v.shape[1], v.shape[0]) for v in views]
    cams = true_cameras(truth, sizes, settings, perturb=False)
    assert reference.registration_error_px(cams, truth, sizes,
                                           settings) < 1e-3
    bad = fault(cams, step * limit, cams[0]["focal"])
    assert reference.registration_error_px(bad, truth, sizes,
                                           settings) > limit
    if fault is fan_rows:
        # judged over (i, i + 1) alone, as before grids, it passes
        row = {k: v for k, v in truth.items() if k != "pairs"}
        assert reference.registration_error_px(bad, row, sizes,
                                               settings) <= limit / 2


# ---------------------------------------------------------------------------
# A reduced grid end to end
# ---------------------------------------------------------------------------

@pytest.fixture
def grid_manifest(tmp_path, monkeypatch):
    """A checkout whose benchmark holds one more cell, `Stitcher()` on
    the 3 x 6 grid, added by files and entries alone; `run.main` finds
    it."""
    bdir = tmp_path / "benchmark"
    shutil.copytree(manifest.HERE, bdir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bdir / "traffic" / "grid18-12mp.json").write_text(json.dumps(GRID))
    shutil.copy(bdir / "limits" / "pano-default.rot6-12mp.json",
                bdir / "limits" / (GRID_CELL + ".json"))
    data = json.loads(open(os.path.join(manifest.ROOT,
                                        "BENCHMARK.json")).read())
    data["workloads"].append(
        {"name": GRID_CELL, "config": "pano-default",
         "traffic": "grid18-12mp", "chips": 1, "why": "a 3 x 6 grid"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    orig = manifest.Manifest
    monkeypatch.setattr(manifest, "Manifest", lambda: orig(
        root=str(tmp_path), bench_dir=str(bdir)))


def rows_fanned(monkeypatch):
    # the registration's last step fans the rows apart by 3 px a column
    # (`fan_angle`): (0, 11) reads some 30 px, each row pair some 3 px more
    # than the sound run
    from stitching_tpu_torch.camera_wave_corrector import WaveCorrector

    orig = WaveCorrector.correct

    def fanned(self, cameras):
        cameras = orig(self, cameras)
        for i, cam in enumerate(cameras):
            a = fan_angle(i, 3.0, GRID["focal"] * GRID_SHRINK)
            cam.R = (turn("y", a) @ cam.R).astype(cam.R.dtype)
        return cameras

    monkeypatch.setattr(WaveCorrector, "correct", fanned)


@pytest.mark.parametrize("fault", [None, rows_fanned],
                         ids=["sound", "rows_fanned"])
def test_grid_dry_run(fault, grid_manifest, monkeypatch, capsys):
    if fault:
        fault(monkeypatch)
    judged = []
    orig = reference.registration_error_px
    monkeypatch.setattr(reference, "registration_error_px",
                        lambda cams, truth, *a: judged.append(
                            len(reference.neighbour_pairs(
                                truth, len(cams)))) or orig(cams, truth, *a))
    rc = run.main(["--workload", GRID_CELL, "--seed", str(GRID_SEED),
                   "--seconds", "0.1", "--trace", "0"], device="cpu",
                  shrink=GRID_SHRINK, pool=1)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert judged and set(judged) == {27}
    checks = line["checks"]
    if fault is None:
        assert line["correct"] is True and line["failed"] == 0
        assert all(c["value"] <= c["limit"] for c in checks.values())
    else:
        assert line["correct"] is False
        assert checks["reg_err_px"]["value"] > checks["reg_err_px"]["limit"]
