"""The L1 distance transform under the feather blend and the voronoi seams,
the panorama's union ROI, and the per-image blender backends.

Port of `stitching_tpu/ops/blend.py`. `NoBlender`, `FeatherBlender` and
`MultiBandBlender` are the step-by-step API's backends (`Blender.feed`,
verbose mode): their accumulators live on the device given to them and
each `feed` adds one host image at its corner. Their tile geometry is the
reference's and is part of the result: the feather blend pads each tile
to a 256 bucket with a zero mask before the distance transform (the
padding is a zero the transform can reach), the multiband blend takes a
reflect-padded window with a `3 * 2**nb` gap, aligned to `2**nb` and
bucketed to `max(256, 2**nb)` (its pyramid reflects at that window's
edge). The engine's `compose.StreamComposite` feeds are another geometry.

The reference's distance transform runs a row scan with a column scan
inside it; the city-block distance is separable, so here it is two 1-D
transforms (down the columns, then along the rows), each a forward and a
backward `torch.cummin`:

    d[i] = min(i + cummin_{i' <= i}(D[i'] - i'), -i + cummin_{i' >= i}(D[i'] + i'))

The arithmetic is int64 with sources at 0 and every other pixel at
`BIG = 10**9`, clamped to `BIG` and converted to float32 at the end. The
reference's float32 scan saturates at exactly 1e9 (`1e9 + 1.0` rounds back to
1e9), so the two agree bit for bit; a float32 cummin would not, because
`1e9 - k` rounds.
"""

import numpy as np
import torch

from .fma import fma
from .pyramid import build_gaussian, build_laplacian, collapse_laplacian

BIG = 10 ** 9
_TILE_BUCKET = 256


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


def _round_up(x, m):
    return int(-(-x // m) * m)


def _bucket_tile(img, mask, th, tw):
    """Pad an (h, w, C) tile to (th, tw): the image edge-replicated, the
    mask with zeros."""
    h, w = img.shape[:2]
    rows = torch.arange(th, device=img.device).clamp_max(h - 1)
    cols = torch.arange(tw, device=img.device).clamp_max(w - 1)
    out_mask = torch.zeros((th, tw), dtype=mask.dtype, device=mask.device)
    out_mask[:h, :w] = mask
    return img[rows][:, cols], out_mask


def _reflect_idx(i, n):
    """BORDER_REFLECT index of possibly out-of-range indices (a floor
    mod, as np.mod)."""
    if n == 1:
        return torch.zeros_like(i)
    i = torch.remainder(i, 2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def _tile_tensor(img, device):
    """A host image as an (h, w, 3) float32 tensor on `device` (a gray
    image repeated to three channels)."""
    t = torch.as_tensor(np.asarray(img), device=device).to(torch.float32)
    return t[..., None].expand(-1, -1, 3) if t.dim() == 2 else t


def _to_u8(img):
    return torch.round(img).clamp(0, 255).to(torch.uint8)


class NoBlender:
    """Paste-by-mask composite: a later image overwrites an earlier one."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    def prepare(self, corners, sizes):
        self.tl, (w, h) = result_roi(corners, sizes)
        self.dst_size = (w, h)
        ph, pw = h + _TILE_BUCKET, w + _TILE_BUCKET
        self.canvas = torch.zeros((ph, pw, 3), dtype=torch.float32,
                                  device=self.device)
        self.canvas_mask = torch.zeros((ph, pw), dtype=torch.uint8,
                                       device=self.device)

    def feed(self, img, mask, corner):
        tile = _tile_tensor(img, self.device)
        h, w = tile.shape[:2]
        inside = torch.as_tensor(np.asarray(mask), device=self.device) > 0
        y, x = corner[1] - self.tl[1], corner[0] - self.tl[0]
        region = self.canvas[y:y + h, x:x + w]
        region.copy_(torch.where(inside[..., None], tile, region))
        self.canvas_mask[y:y + h, x:x + w].masked_fill_(inside, 255)

    def blend(self):
        w, h = self.dst_size
        return (_to_u8(self.canvas[:h, :w]).cpu().numpy(),
                self.canvas_mask[:h, :w].cpu().numpy())


class FeatherBlender:
    """Weights: the L1 distance to the mask's edge times `sharpness`,
    clipped at 1; the blend is the weighted mean."""

    def __init__(self, sharpness, device="cuda"):
        self.sharpness = float(sharpness)
        self.device = torch.device(device)

    def prepare(self, corners, sizes):
        self.tl, (w, h) = result_roi(corners, sizes)
        self.dst_size = (w, h)
        ph, pw = h + _TILE_BUCKET, w + _TILE_BUCKET
        self.acc = torch.zeros((ph, pw, 3), dtype=torch.float32,
                               device=self.device)
        self.wsum = torch.zeros((ph, pw), dtype=torch.float32,
                                device=self.device)

    def feed(self, img, mask, corner):
        tile = _tile_tensor(img, self.device)
        h, w = tile.shape[:2]
        th = min(_round_up(h, _TILE_BUCKET), self.acc.shape[0])
        tw = min(_round_up(w, _TILE_BUCKET), self.acc.shape[1])
        inside = (torch.as_tensor(np.asarray(mask), device=self.device)
                  > 0).to(torch.uint8)
        tile, tmask = _bucket_tile(tile, inside, th, tw)
        # the reference's float32 scalar
        weight = (distance_transform_l1(tmask)
                  * float(np.float32(self.sharpness))).clamp_max(1.0)
        weight = torch.where(tmask > 0, weight, 0.0)
        y, x = corner[1] - self.tl[1], corner[0] - self.tl[0]
        region = self.acc[y:y + th, x:x + tw]
        # the reference's compiled CPU feed adds tile * weight to the first
        # two channels as one fma and to the third after a rounded product
        # (found by comparing its accumulators value for value)
        wt = weight[..., None]
        region[..., :2] = fma(tile[..., :2], wt.expand(-1, -1, 2),
                              region[..., :2])
        region[..., 2:] += tile[..., 2:] * wt
        self.wsum[y:y + th, x:x + tw] += weight

    def blend(self):
        w, h = self.dst_size
        out = self.acc / self.wsum[..., None].clamp_min(1e-5)
        mask = (self.wsum[:h, :w] > 1e-5).to(torch.uint8) * 255
        return _to_u8(out[:h, :w]).cpu().numpy(), mask.cpu().numpy()


class MultiBandBlender:
    """Each image's Laplacian pyramid times its mask's Gaussian pyramid,
    added into per-level canvases; the blend normalises each level by its
    weight and collapses the pyramid."""

    WEIGHT_EPS = 1e-5

    def __init__(self, num_bands, device="cuda"):
        self.num_bands = int(np.clip(num_bands, 1, 8))
        self.device = torch.device(device)

    def prepare(self, corners, sizes):
        self.tl, (w, h) = result_roi(corners, sizes)
        self.dst_size = (w, h)
        nb = self.num_bands
        m = 1 << nb
        self.bucket = max(_TILE_BUCKET, m)
        ph = _round_up(h, m) + self.bucket
        pw = _round_up(w, m) + self.bucket
        self.band_acc = [torch.zeros((ph >> lv, pw >> lv, 3),
                                     dtype=torch.float32, device=self.device)
                         for lv in range(nb + 1)]
        self.band_w = [torch.zeros((ph >> lv, pw >> lv, 1),
                                   dtype=torch.float32, device=self.device)
                       for lv in range(nb + 1)]

    def feed(self, img, mask, corner):
        nb = self.num_bands
        m = 1 << nb
        dev = self.device
        tile = _tile_tensor(img, dev)
        h, w = tile.shape[:2]
        cx, cy = self.tl
        cw, ch = self.dst_size
        # the window: the tile with a gap of border context, clamped to the
        # canvas, aligned to the pyramid's grid, then bucketed
        gap = 3 * m
        x0 = max(corner[0] - gap, cx)
        y0 = max(corner[1] - gap, cy)
        x1 = min(corner[0] + w + gap, cx + cw)
        y1 = min(corner[1] + h + gap, cy + ch)
        x0 = cx + ((x0 - cx) // m) * m
        y0 = cy + ((y0 - cy) // m) * m
        lw = _round_up(x1 - x0, self.bucket)
        lh = _round_up(y1 - y0, self.bucket)
        # image content reflects outside the tile, the mask reads 0
        ys = torch.arange(lh, device=dev) - (corner[1] - y0)
        xs = torch.arange(lw, device=dev) - (corner[0] - x0)
        local = tile[_reflect_idx(ys, h)][:, _reflect_idx(xs, w)]
        src = torch.as_tensor(np.asarray(mask), device=dev) > 0
        inside = ((ys >= 0) & (ys < h))[:, None] & ((xs >= 0) & (xs < w))[None]
        lmask = torch.where(
            inside, src[ys.clamp(0, h - 1)][:, xs.clamp(0, w - 1)], False)
        laps = build_laplacian(local, nb)
        wpyr = build_gaussian(lmask.to(torch.float32)[..., None], nb)
        oy, ox = y0 - cy, x0 - cx
        for lv in range(nb + 1):
            yy, xx = oy >> lv, ox >> lv
            bh, bw = laps[lv].shape[0], laps[lv].shape[1]
            self.band_acc[lv][yy:yy + bh, xx:xx + bw] += laps[lv] * wpyr[lv]
            self.band_w[lv][yy:yy + bh, xx:xx + bw] += wpyr[lv]

    def blend(self):
        nb = self.num_bands
        laps = [self.band_acc[lv] / (self.band_w[lv] + self.WEIGHT_EPS)
                for lv in range(nb + 1)]
        out = collapse_laplacian(laps)
        w, h = self.dst_size
        mask = (self.band_w[0][:h, :w, 0] > self.WEIGHT_EPS).to(
            torch.uint8) * 255
        return _to_u8(out[:h, :w]).cpu().numpy(), mask.cpu().numpy()
