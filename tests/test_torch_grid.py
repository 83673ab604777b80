"""Multi-row captures through the port's registration, on the CPU at a
shrink of 0.3 (views of 1210 x 907 for a 12 MP grid).

- `Stitcher()`'s registration on a 3 x 6 and a 2 x 4 pitch-and-yaw grid
  (`benchmark.generators.rotation`) keeps every view, and its cameras map
  each view into each grid neighbour within the grid cell's limit of
  `reg_err_px` (`benchmark/limits/pano-default.grid18-12mp.json`).
- Both sets, and a 2 MP sweep, bent before minimal samples that fold were
  dropped (`ops/ransac._orientation_kept`): with the JAX package's sample
  test they read far over the limit, focals pulled down by a pair whose
  folded hypothesis took in matches hundreds of pixels off the truth.
- The port's bundle adjustment on the problem it packed lands where the
  plain float64 reference (`benchmark/bundle_reference.py`) lands from
  the same start, within the reference's tolerances; the same result
  rounded to bfloat16 does not.
- The counters `match/pairs` and `bundle/edges` count the candidate pairs
  and the packed edges.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import stitching_tpu_torch as pkg  # noqa: E402
from benchmark import (bundle_check, bundle_reference,  # noqa: E402
                       generators, reference)
from benchmark.manifest import Manifest  # noqa: E402
from stitching_tpu_torch import engine, profiling  # noqa: E402
from stitching_tpu_torch.ops import ransac  # noqa: E402

torch.set_num_threads(2)

SHRINK = 0.3
GRID_CELL = "pano-default.grid18-12mp"
# a 2 x 4 grid at the 3 x 6 grid's steps (yaw 0.62, pitch 0.49 rad): some
# 40% overlap each way, the scene as dense in blocks
GRID24 = {"generator": "rotation", "views": 8, "rows": 2, "width": 4032,
          "height": 3024, "focal": 3528.0, "max_angle": 0.93,
          "max_pitch": 0.245,
          "scene": {"height": 2520, "width": 4640, "blocks": 3248,
                    "scale": 2.52},
          "pool": 3}
# (traffic, seed of `generators.set_seed(seed, 0)`, pairs of 2-NN and
# RANSAC): each set bent before folded samples were dropped (at this
# shrink: 62.6, 5,980 and 22.3 px)
CASES = {
    "grid3x6": ("grid18-12mp", 2200002006, 153),
    "grid2x4": (GRID24, 1, 28),
    "sweep8": ("rot8-2mp", 9600000035, 28),
}


def _traffic(name):
    return Manifest().traffic(name) if isinstance(name, str) else name


def _settings():
    man = Manifest()
    s = dict(man.config(man.workload(GRID_CELL)["config"])["reference"])
    for k in ("medium_megapix", "low_megapix"):
        s[k] *= SHRINK ** 2
    return s


def register(case):
    """Register the case's set on the CPU with `Stitcher()`'s settings at
    the shrink, counters on: (cameras as dicts, truth, sizes, the bundle
    solve `bundle_check.Capture` kept, counters)."""
    traffic, seed, _ = CASES[case]
    settings = _settings()
    views, truth = generators.make(_traffic(traffic),
                                   generators.set_seed(seed, 0),
                                   torch.device("cpu"), SHRINK)
    st = pkg.Stitcher(device="cpu", medium_megapix=settings["medium_megapix"],
                      low_megapix=settings["low_megapix"])
    profiling.reset()
    profiling.enable()
    try:
        with bundle_check.Capture() as cap:
            reg = engine.register(st, views)
        counters = profiling.get_counters()
    finally:
        profiling.enable(False)
        profiling.reset()
    cams = [dict(focal=float(c.focal), aspect=float(c.aspect),
                 ppx=float(c.ppx), ppy=float(c.ppy),
                 R=np.asarray(c.R, np.float64)) for c in reg.cameras]
    assert len(cap.solves) == 1
    return cams, truth, [(v.shape[1], v.shape[0]) for v in views], \
        cap.solves[0], counters


@pytest.fixture(scope="module")
def registered():
    return {}


def registration(registered, case):
    if case not in registered:
        registered[case] = register(case)
    return registered[case]


def limit():
    return Manifest().limits(GRID_CELL)["reg_err_px"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_view_registered_within_the_cell_limit(registered, case):
    cams, truth, sizes, _, _ = registration(registered, case)
    assert len(cams) == len(sizes)
    err = reference.registration_error_px(cams, truth, sizes, _settings())
    assert err < limit(), err


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_set_bent_with_folded_samples(case, monkeypatch):
    """The JAX package's sample test, no orientation check: the same set
    misregisters far over the limit."""
    monkeypatch.setattr(ransac, "_orientation_kept",
                        lambda s4, d4: torch.ones(s4.shape[:2], dtype=bool))
    cams, truth, sizes, _, _ = register(case)
    err = reference.registration_error_px(cams, truth, sizes, _settings())
    assert err > 1.5 * limit(), err


@pytest.mark.parametrize("case", sorted(CASES))
def test_bundle_lands_on_the_reference(registered, case):
    _, _, _, solve, _ = registration(registered, case)
    got = bundle_reference.compare(solve["problem"], solve["start"],
                                   solve["result"])
    assert got["ok"], got
    assert got["ref_steps"] < bundle_reference.MAX_ITERS


@pytest.mark.parametrize("case", sorted(CASES))
def test_bundle_in_bfloat16_misses_the_reference(registered, case):
    """The control: the reference's own minimum held in bfloat16 fails
    every tolerance of `compare`."""
    _, _, _, solve, _ = registration(registered, case)
    ref = bundle_reference.solve(solve["problem"], solve["start"])
    bf16 = [dict(c, focal=float(torch.tensor(c["focal"]).bfloat16()),
                 R=torch.tensor(c["R"]).bfloat16().double().numpy())
            for c in ref[0]]
    got = bundle_reference.compare(solve["problem"], solve["start"], bf16,
                                   ref)
    assert not got["ok"]
    assert got["focal_rdiff"] > bundle_reference.FOCAL_RTOL
    assert got["angle_rad"] > bundle_reference.ANGLE_TOL
    assert got["cost_excess"] > bundle_reference.COST_RTOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_counters_count_pairs_and_edges(registered, case):
    _, truth, sizes, solve, counters = registration(registered, case)
    w = np.asarray(solve["problem"]["w"])
    assert counters["match/pairs"] == CASES[case][2]
    assert counters["bundle/edges"] == int((w.sum(1) > 0).sum())
    # a grid's bundle holds a loop in both directions: more edges than
    # grid neighbours
    assert counters["bundle/edges"] >= len(
        reference.neighbour_pairs(truth, len(sizes)))


def test_reference_solves_a_known_rotation_set():
    """The reference alone: cameras drawn from the truth and turned a
    little, inliers that the truth maps exactly; the loop returns the
    truth's relative rotations and focal, with a cost of rounding."""
    rng = np.random.default_rng(3)
    f, n = 700.0, 4
    pp = (320.0, 240.0)
    K = np.array([[f, 0, pp[0]], [0, f, pp[1]], [0, 0, 1.0]])

    def yaw(a):
        return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                         [-np.sin(a), 0, np.cos(a)]])

    Rs = [yaw(0.3 * i) for i in range(n)]
    edges = [(i, i + 1) for i in range(n - 1)] + [(0, 2)]
    M = 64
    prob = {k: [] for k in ("src_idx", "dst_idx", "pts_src", "pts_dst", "w")}
    for i, j in edges:
        p = np.c_[rng.uniform(400, 640, M), rng.uniform(0, 480, M)]
        if (i, j) == (0, 2):
            p[:, 0] = rng.uniform(560, 640, M)
        q = np.c_[p, np.ones(M)] @ (K @ Rs[j].T @ Rs[i]
                                    @ np.linalg.inv(K)).T
        prob["src_idx"].append(i)
        prob["dst_idx"].append(j)
        prob["pts_src"].append(p)
        prob["pts_dst"].append(q[:, :2] / q[:, 2:])
        prob["w"].append(np.ones(M))
    prob = {k: np.asarray(v) for k, v in prob.items()}
    start = [dict(focal=f * (1 + 0.02 * (i - 1)), ppx=pp[0], ppy=pp[1],
                  aspect=1.0, R=Rs[i] @ yaw(0.01 * i) if i else Rs[0])
             for i in range(n)]
    cams, cost, kept, _ = bundle_reference.solve(prob, start)
    assert cost < 1e-12 and kept < bundle_reference.MAX_ITERS
    for i in range(n):
        assert abs(cams[i]["focal"] - f) < 1e-6 * f
        d = (cams[0]["R"].T @ cams[i]["R"]) @ (Rs[0].T @ Rs[i]).T
        assert np.abs(d - np.eye(3)).max() < 1e-9


@pytest.mark.parametrize("rvec", [
    (0.0, 0.0, 0.0), (1e-9, -2e-9, 0.0), (0.3, -1.2, 0.4),
    (0.0, np.pi - 1e-8, 0.0), (np.pi / np.sqrt(3) * (1 - 1e-9),) * 3])
def test_reference_rotation_vector_inverts_rodrigues(rvec):
    r = torch.tensor(rvec, dtype=torch.float64)
    R = bundle_reference.rodrigues(r).numpy()
    np.testing.assert_allclose(bundle_reference.rotation_vector(R), rvec,
                               atol=1e-7)


def test_reference_imports_nothing_of_the_port():
    import ast
    import pathlib

    src = pathlib.Path(bundle_reference.__file__).read_text()
    names = {a.name.split(".")[0] for node in ast.walk(ast.parse(src))
             if isinstance(node, ast.Import) for a in node.names}
    names |= {node.module.split(".")[0] for node in ast.walk(ast.parse(src))
              if isinstance(node, ast.ImportFrom) and node.module}
    assert names == {"numpy", "torch"}
