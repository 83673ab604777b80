"""Times of the two 2-NN kernels of the PyTorch port on one NVIDIA GPU.

    python3 scripts/bench_two_nn.py [--out FILE]

At the shapes the port's paths give the kernels (8 images of 500 rows, 28
pairs; one 500 x 500 pair; 256-bit binary rows and 128-wide float rows, made
from a seed) it prints, per row of the kernel table, device milliseconds
per call from a CUDA graph replay (`chip_smoke.graph_ms`, the median of
five graphs of 50 calls):

- the wrapper as it stands (`launch_plan`'s grid);
- every other grid: each tile of `ROWS_PER_BLOCK` times 1, 2, 4 or 8 target
  segments, each held equal to the planned grid's result first;
- the launch floor: an empty kernel launched as often as the planned call
  launches kernels (`kernel_launches`).

The card's name and power limit are printed first and, with `--out FILE`,
stored with the numbers as JSON.
"""

import argparse
import json
import os
import statistics
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import card_line, graph_ms  # noqa: E402
from stitching_tpu_torch.ops import kernels  # noqa: E402
from stitching_tpu_torch.ops.kernels import two_nn as nn  # noqa: E402


def median_ms(fn):
    return statistics.median(graph_ms(fn, 50) for _ in range(5))


def same(a, b, is_binary):
    if is_binary:
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return (torch.equal(a[2], b[2])
            and all(torch.allclose(x, y, rtol=1e-5, atol=1e-3)
                    for x, y in zip(a[:2], b[:2])))


def sweep(call, ref, nt, is_binary):
    """ms per call under every grid: each tile of `ROWS_PER_BLOCK` x 1, 2,
    4, 8 target segments; each grid's result is held equal to `ref` first."""
    grids = {}
    planned = nn.launch_plan
    try:
        for rows in nn.ROWS_PER_BLOCK[is_binary]:
            for splits in (1, 2, 4, 8):
                units = -(-nt // nn.SPLIT_UNIT)
                per_seg = -(-units // splits)
                plan = (rows, -(-units // per_seg), per_seg * nn.SPLIT_UNIT)
                key = "rows%d s%d seg%d" % plan
                nn.launch_plan = lambda *a, plan=plan: plan
                if not same(call(), ref, is_binary):
                    raise AssertionError(f"grid {key} differs")
                grids[key] = median_ms(call)
    finally:
        nn.launch_plan = planned
    return grids


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_two_nn: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    kernels.build()
    floor = kernels.load("launch_floor")
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    pairs = torch.as_tensor(
        np.asarray([(i, j) for i in range(8) for j in range(i + 1, 8)],
                   np.int32), device=dev)
    valid = torch.as_tensor(rng.rand(8, 500) > 0.05, device=dev)
    data = {
        True: torch.as_tensor((rng.rand(8, 500, 256) > 0.5)
                              .astype(np.float32), device=dev),
        False: torch.as_tensor(np.abs(rng.randn(8, 500, 128))
                               .astype(np.float32) * 40, device=dev),
    }
    sm = nn._sm_count(dev)
    report = {"card": card, "rows": {}}
    for is_binary in (True, False):
        desc = data[is_binary]
        kind = "binary" if is_binary else "float"
        calls = {
            f"two_nn_pairs ({kind})": (
                lambda: nn.two_nn_pairs(desc, valid, pairs,
                                        is_binary=is_binary),
                (500, 500, 56)),
            f"two_nn ({kind})": (
                lambda: nn.two_nn(desc[0], desc[1], valid[1],
                                  is_binary=is_binary),
                (500, 500, 1)),
        }
        for row, (call, (nq, nt, batch)) in calls.items():
            ref = call()
            torch.cuda.synchronize()
            plan = nn.launch_plan(nq, nt, batch, sm, is_binary)
            launches = nn.kernel_launches(plan[1])
            res = {"planned": list(plan), "ms": median_ms(call),
                   "launches": launches,
                   "floor_ms": median_ms(
                       lambda: floor(launches, kernels.stream_ptr(dev))),
                   "grids": sweep(call, ref, nt, is_binary)}
            report["rows"][row] = res
            print(row, json.dumps(res), flush=True)
    print(card_line(), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
