"""Gaussian and Laplacian pyramids (the cv.pyrDown / cv.pyrUp analogues).

Port of `stitching_tpu/ops/pyramid.py`, the building blocks of the
multi-band blend (`compose._mb_feed_one`). The 5-tap binomial kernel
`KERNEL5` = [1, 4, 6, 4, 1] / 16 runs as two separable polyphase passes of
shifted adds, each sum in the reference's order:

    down: (e[j-1] + 6 e[j] + e[j+1] + 4 o[j-1] + 4 o[j]) / 16
    up:   even 0.125 v[i-1] + 0.75 v[i] + 0.125 v[i+1], odd 0.5 (v[i] + v[i+1])

No convolution library call: it would reorder the sums, and cuDNN may use
TF32. Images are (..., H, W, C) float32; H and W are axes -3 and -2.
"""

import numpy as np
import torch

KERNEL5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
# the passes' weights, exact in float32: down sums the taps in units of the
# outer one (1, 4, 6) and divides by 16 once; up applies twice the kernel
_DOWN = [float(t) for t in KERNEL5 / KERNEL5[0]]
_DOWN_NORM = float(1.0 / KERNEL5[0])
_UP = [float(t) for t in 2.0 * KERNEL5]


def _take(v, axis, sl):
    idx = [slice(None)] * v.ndim
    idx[axis] = sl
    return v[tuple(idx)]


def _pad1(v, axis, left_reflect, right_reflect):
    """Pad one element a side: reflect-101 or edge-replicate per side.

    The polyphase filters need mixed borders to reproduce the zero-stuffed
    and strided formulations exactly: reflecting a zero-stuffed signal
    lands on samples of the same parity, which is reflect on one side and
    edge on the other for the un-stuffed phase signals.
    """
    left = _take(v, axis, slice(1, 2) if left_reflect else slice(0, 1))
    right = _take(v, axis, slice(-2, -1) if right_reflect
                  else slice(-1, None))
    return torch.cat([left, v, right], dim=axis)


def _shift(vp, axis, a, n):
    return _take(vp, axis, slice(a, a + n))


def _down_axis(v, axis):
    axis %= v.ndim
    n = v.shape[axis] // 2
    shp = list(v.shape)
    shp[axis:axis + 1] = [n, 2]
    vv = v.reshape(shp)
    e, o = vv.select(axis + 1, 0), vv.select(axis + 1, 1)
    ep = _pad1(e, axis, left_reflect=True, right_reflect=False)
    op = _pad1(o, axis, left_reflect=False, right_reflect=False)
    return (_shift(ep, axis, 0, n) + _DOWN[2] * _shift(ep, axis, 1, n)
            + _shift(ep, axis, 2, n) + _DOWN[1] * _shift(op, axis, 0, n)
            + _DOWN[3] * _shift(op, axis, 1, n)) / _DOWN_NORM


def pyr_down(img):
    """Blur and 2x subsample of (..., H, W, C); H and W must be even."""
    return _down_axis(_down_axis(img, -3), -2)


def _up_axis(v, axis):
    axis %= v.ndim
    n = v.shape[axis]
    vp = _pad1(v, axis, left_reflect=True, right_reflect=False)
    even = (_UP[0] * _shift(vp, axis, 0, n) + _UP[2] * _shift(vp, axis, 1, n)
            + _UP[4] * _shift(vp, axis, 2, n))
    odd = _UP[1] * (_shift(vp, axis, 1, n) + _shift(vp, axis, 2, n))
    # interleave: stack on a new axis just after `axis`, then merge the two
    st = torch.stack([even, odd], dim=axis + 1)
    shp = list(v.shape)
    shp[axis] *= 2
    return st.reshape(shp)


def pyr_up(img, out_h, out_w):
    """2x upsample and blur with 4 x the kernel (cv.pyrUp analogue),
    cropped to (out_h, out_w)."""
    out = _up_axis(_up_axis(img, -3), -2)
    return out[..., :out_h, :out_w, :]


def build_gaussian(img, num_bands):
    pyr = [img]
    for _ in range(num_bands):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def build_laplacian(img, num_bands):
    """[lap_0 ... lap_{n-1}, gauss_n]; H and W divisible by 2^n."""
    pyr = build_gaussian(img, num_bands)
    laps = []
    for lvl in range(num_bands):
        hi = pyr[lvl]
        laps.append(hi - pyr_up(pyr[lvl + 1], hi.shape[-3], hi.shape[-2]))
    laps.append(pyr[num_bands])
    return laps


def collapse_laplacian(laps):
    """Inverse of `build_laplacian`."""
    img = laps[-1]
    for lvl in range(len(laps) - 2, -1, -1):
        img = pyr_up(img, laps[lvl].shape[-3], laps[lvl].shape[-2]) + laps[lvl]
    return img
