"""The control, and the readings that `limits/<cell>.json` are set from.

    python benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

The control is the reference put in the program's place and computed in
bfloat16, one step below the float32 that the configuration states:
`ControlBench` stitches like the program's `Bench`, keeps the program's
cameras, and replaces the crop by the largest rectangle of the LOW mask
warped in bfloat16 and the panorama by the views warped in bfloat16 to
that placement. Registration's control, the true maps between the views
in bfloat16, has no cameras to stand in for, so it is read apart
(`control_registration_error_px`). Put in place of `run.Bench`, the
control has to come out not correct (`tests/test_bench_control.py`).

For each seed this prints one JSON line: one stitch of the cell's first
view set by the program (set-up is shared across the seeds), judged as a
run judges it (the program's readings), the control's readings on the
same views, and the crop's numbers with the fault they exist for planted
in the control (`bounding_box`: the crop grown to the LOW mask's bounding
box); then the highest program reading and the lowest control and fault
reading of each number. It runs on the card; the CPU tests call `main`
with `device="cpu"` and a shrink.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from benchmark import run  # noqa: E402  (the checkout's paths and caches)


def bounding_box(bench, k, last):
    """The fault that the crop's numbers exist for, planted in the
    reference: the crop grown to the bounding box of the LOW mask."""
    from benchmark import reference

    sizes = [(v.shape[1], v.shape[0]) for v in bench.sets[k][0]]
    m = reference.low_mask(last["cameras"], sizes, bench.settings,
                           bench.dev)
    return (0, 0, m.shape[1], m.shape[0])


def control_outputs(bench, k, last, crop=None):
    """The control's crop (or `crop(bench, k, last)`) and panorama for
    view set k, placed by the cameras the program registered:
    (panorama, what it decided)."""
    from benchmark import reference

    views, _ = bench.sets[k]
    sizes = [(v.shape[1], v.shape[0]) for v in views]
    lir = (crop(bench, k, last) if crop else
           reference.control_crop(last["cameras"], sizes, bench.settings,
                                  bench.dev))
    lay = reference.layout(last["cameras"], sizes, lir, bench.settings)
    return (reference.control_panorama(views, lay, bench.dev),
            {**last, "lir": tuple(int(v) for v in lir)})


class ControlBench(run.Bench):
    """`run.Bench` with the control in the program's place."""

    def stitch(self, k):
        wall, _, last = super().stitch(k)
        pano, last = control_outputs(self, k, last)
        return wall, pano, last


def control_numbers(bench, k, last):
    from benchmark import reference

    views, truth = bench.sets[k]
    sizes = [(v.shape[1], v.shape[0]) for v in views]
    pano, ctl = control_outputs(bench, k, last)
    return {**bench.judge((k, pano, ctl)),
            "reg_err_px": reference.control_registration_error_px(
                truth, sizes)}


def main(argv=None, device=None, shrink=1.0):
    import argparse

    import torch

    from benchmark.manifest import Manifest

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if device is None:
        if not torch.cuda.is_available():
            run.log("the control runs on the card")
            return 2
        device = "cuda"
    dev = torch.device(device)
    man = Manifest()
    cell = man.workload(args.workload)
    bench = run.Bench(man, cell, args.seeds[0], dev, shrink)
    rows = []
    for seed in args.seeds:
        bench.make_sets(seed, pool=1)
        wall, pano, last = bench.stitch(0)
        bbox = bench.judge((0, *control_outputs(bench, 0, last,
                                                bounding_box)))
        row = {"seed": seed, "wall_s": wall,
               "program": bench.judge((0, pano, last)),
               "control": control_numbers(bench, 0, last),
               "crop_to_bbox": {k: bbox[k] for k in (
                   "uncovered_share", "crop_outside_share",
                   "crop_area_short")}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    names = rows[0]["program"].keys()
    print(json.dumps({
        "workload": cell["name"], "seeds": len(rows),
        "program_max": {k: max(r["program"][k] for r in rows)
                        for k in names},
        "control_min": {k: min(r["control"][k] for r in rows)
                        for k in names},
        "crop_to_bbox_min": {k: min(r["crop_to_bbox"][k] for r in rows)
                             for k in rows[0]["crop_to_bbox"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
