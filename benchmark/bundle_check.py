"""The program's bundle adjustment against the plain reference, at a cell's
sizes.

    python3 benchmark/bundle_check.py --workload pano-default.grid18-12mp \
        --seed <n> [--sets 3]

Renders the cell's view sets from the seed as a run does (`--sets` of
them, the k-th from `generators.set_seed(seed, k)`), stitches each with
the cell's stitcher and captures, under `Capture`, the problem the
adjuster packs (`CameraAdjuster._pack_problem`: edges, inliers), the
cameras it starts from and the cameras it returns. Then
`bundle_reference.solve` minimises the same cost in float64 from the
same start, and one JSON line a set gives the edges and inliers, the
reference's kept and trial steps, and the program's result against the
reference's (`bundle_reference.compare`: the largest focal difference,
the largest rotation difference in the frame of the start's identity
camera, the program's cost over the reference's minimum), each beside
its tolerance. The last line sums the sets. It runs on the card; the
CPU tests use `Capture` and `bundle_reference.compare` on stitches of
their own.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import bundle_reference  # noqa: E402


def _cameras(cams):
    return [dict(focal=float(c.focal), aspect=float(c.aspect),
                 ppx=float(c.ppx), ppy=float(c.ppy),
                 R=np.array(c.R, np.float64)) for c in cams]


class Capture:
    """While open, keeps each ray or reproj adjustment the program runs:
    `solves` [{"problem", "start", "result"}], all on the host."""

    def __enter__(self):
        from stitching_tpu_torch.camera_adjuster import CameraAdjuster

        self.solves = []
        self._cls = CameraAdjuster
        self._saved = (CameraAdjuster._pack_problem,
                       CameraAdjuster._adjust_rotation)
        pack, rotation = self._saved

        def packed(adjuster, features, matches):
            problem = pack(adjuster, features, matches)
            if problem is not None:
                self.solves.append({"problem": {
                    k: np.array(v, copy=True) for k, v in problem.items()}})
            return problem

        def adjusted(adjuster, problem, cameras):
            self.solves[-1]["start"] = _cameras(cameras)
            out = rotation(adjuster, problem, cameras)
            self.solves[-1]["result"] = None if out is None else _cameras(
                out)
            return out

        CameraAdjuster._pack_problem = packed
        CameraAdjuster._adjust_rotation = adjusted
        return self

    def __exit__(self, *exc):
        self._cls._pack_problem, self._cls._adjust_rotation = self._saved


def compare_solve(solve):
    """One captured adjustment against the reference's from its start."""
    problem = solve["problem"]
    t0 = time.perf_counter()
    ref = bundle_reference.solve(problem, solve["start"])
    ref_s = time.perf_counter() - t0
    got = bundle_reference.compare(problem, solve["start"], solve["result"],
                                   ref)
    w = np.asarray(problem["w"])
    return {"edges": int((w.sum(1) > 0).sum()), "inliers": int(w.sum()),
            "reference_s": ref_s, **got}


def check_set(st, views):
    """Stitch one view set under `Capture`; the set's numbers."""
    with Capture() as cap:
        st.stitch(views)
    (solve,) = cap.solves
    return compare_solve(solve)


def main(argv=None):
    import argparse

    import torch

    import stitching_tpu_torch as pkg
    from benchmark import generators
    from benchmark.manifest import Manifest

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--sets", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the check runs the program on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    man = Manifest()
    cell = man.workload(args.workload)
    cfg = man.config(cell["config"])
    traffic = man.traffic(cell["traffic"])
    st = getattr(pkg, cfg["stitcher"])(device=dev, **cfg["kwargs"])
    rows = []
    for k in range(args.sets):
        views, _ = generators.make(traffic, generators.set_seed(args.seed, k),
                                   dev)
        row = {"seed": args.seed, "set": k, **check_set(st, views)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({
        "workload": cell["name"], "sets": len(rows),
        "device": torch.cuda.get_device_name(dev),
        "ok": sum(r["ok"] for r in rows),
        "worst_focal_rdiff": max(r["focal_rdiff"] for r in rows),
        "worst_angle_rad": max(r["angle_rad"] for r in rows),
        "worst_cost_excess": max(r["cost_excess"] for r in rows),
        "tolerances": {"focal_rdiff": bundle_reference.FOCAL_RTOL,
                       "angle_rad": bundle_reference.ANGLE_TOL,
                       "cost_excess": bundle_reference.COST_RTOL}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
