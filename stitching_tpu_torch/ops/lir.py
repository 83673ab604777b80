"""Largest interior rectangle of a binary mask.

Port of `stitching_tpu/ops/lir.py`. Classic histogram-of-heights
formulation, vectorized over the whole mask with no loop over rows or
pixels:

- per-row bar heights are a cumulative count: the row index minus the
  running maximum of the last empty row above;
- for every bar the maximal contiguous reach (bars at least as tall) to the
  left/right is found by greedy binary lifting over a sparse table of window
  minima, ~log2(W) batched gathers over all rows at once.

Everything is integer arithmetic, so the result equals the reference's
exactly; ties between equal-area rectangles go to the first one in row-major
order of the bar that spans them.
"""

import numpy as np
import torch

_BIG = 2 ** 30


def _left_reach(heights):
    """heights: (H, W) int32 bar heights, one histogram per row.

    Returns (H, W) int32: for each bar i of a row, the number of contiguous
    bars j <= i (including i itself) with heights[j] >= heights[i].
    """
    h, w = heights.shape
    dev = heights.device
    levels = max(int(np.ceil(np.log2(max(w, 2)))), 1)

    # Sparse table: table[k][:, a] = min(heights[:, a .. a + 2^k - 1]).
    table = [heights]
    for k in range(1, levels + 1):
        prev = table[-1]
        shift = 1 << (k - 1)
        shifted = torch.cat(
            [prev[:, shift:],
             torch.full((h, min(shift, w)), _BIG, dtype=prev.dtype,
                        device=dev)], dim=1)
        table.append(torch.minimum(prev, shifted))

    idx = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    # reach counts bars left of i (excluding i) that are >= heights[i];
    # grown greedily from the highest power of two down: is the entire
    # 2^k-wide window immediately left of the claimed region >= heights[i]?
    reach = torch.zeros((h, w), dtype=torch.int32, device=dev)
    for k in range(levels, -1, -1):
        step = 1 << k
        a = idx - reach - step  # window = [a, a + 2^k - 1]
        window_min = torch.gather(table[k], 1, a.clamp(0, w - 1).long())
        ok = (a >= 0) & (window_min >= heights)
        reach = torch.where(ok, reach + step, reach)
    return reach + 1  # include the bar itself


def largest_interior_rectangle(mask):
    """mask: (H, W) bool tensor (or array). Returns a (4,) int32 tensor
    (x, y, w, h) of the largest axis-aligned all-true rectangle
    (area-maximal; ties by scan order), on the mask's device."""
    m = torch.as_tensor(mask).to(torch.int32)
    n_rows, n_cols = m.shape
    dev = m.device
    rows = torch.arange(n_rows, dtype=torch.int32, device=dev)[:, None]
    last_empty = torch.cummax(torch.where(m == 0, rows, -1), dim=0).values
    heights = (rows - last_empty).to(torch.int32)

    left = _left_reach(heights)
    right = _left_reach(heights.flip(1)).flip(1)
    width = left + right - 1
    area = (heights * width).reshape(-1)
    # the first maximum in row-major order
    cells = torch.arange(area.numel(), device=dev)
    flat = torch.where(area == area.max(), cells, area.numel()).min()
    r = flat // n_cols
    c = flat % n_cols
    hh = heights[r, c]
    ww = width[r, c]
    x = c - left[r, c] + 1
    y = r - hh + 1
    return torch.stack([x, y, ww, hh]).to(torch.int32)
