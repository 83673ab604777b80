"""The L1 distance transform under the feather blend and the voronoi seams,
and the panorama's union ROI.

Port of `stitching_tpu/ops/blend.py::distance_transform_l1` and
`result_roi`. The reference
runs a row scan with a column scan inside it; the city-block distance is
separable, so here it is two 1-D transforms (down the columns, then along
the rows), each a forward and a backward `torch.cummin`:

    d[i] = min(i + cummin_{i' <= i}(D[i'] - i'), -i + cummin_{i' >= i}(D[i'] + i'))

The arithmetic is int64 with sources at 0 and every other pixel at
`BIG = 10**9`, clamped to `BIG` and converted to float32 at the end. The
reference's float32 scan saturates at exactly 1e9 (`1e9 + 1.0` rounds back to
1e9), so the two agree bit for bit; a float32 cummin would not, because
`1e9 - k` rounds.
"""

import torch

BIG = 10 ** 9


def _dt_1d(d, dim):
    """1-D L1 distance transform of int64 `d` along `dim`."""
    n = d.shape[dim]
    shape = [1] * d.ndim
    shape[dim] = n
    idx = torch.arange(n, dtype=torch.int64, device=d.device).view(shape)
    fwd = torch.cummin(d - idx, dim).values + idx
    bwd = torch.cummin((d + idx).flip(dim), dim).values.flip(dim) - idx
    return torch.minimum(fwd, bwd)


def distance_transform_l1(mask):
    """L1 (city-block) distance of every pixel of (..., H, W) `mask` to the
    nearest zero pixel, float32; 1e9 where the image has no zero."""
    d = torch.where(mask > 0, BIG, 0).to(torch.int64)
    d = _dt_1d(_dt_1d(d, -2), -1)
    return d.clamp_max(BIG).to(torch.float32)


def result_roi(corners, sizes):
    """Union bounding box: ((x, y), (w, h)), the cv.detail.resultRoi
    analogue."""
    xs = [c[0] for c in corners]
    ys = [c[1] for c in corners]
    x2 = [c[0] + s[0] for c, s in zip(corners, sizes)]
    y2 = [c[1] + s[1] for c, s in zip(corners, sizes)]
    tl = (min(xs), min(ys))
    return tl, (max(x2) - tl[0], max(y2) - tl[1])
