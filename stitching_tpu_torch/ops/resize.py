"""Host bilinear image resize (numpy).

Replacement for the reference's `cv.resize(..., INTER_LINEAR_EXACT)` calls
(`stitching/images.py:124-126`), using the half-pixel-center sampling
convention. Input-stage resizes are host-side API plumbing; the device
resize of whole stacks is `pipeline.resize_stack`.
"""

import numpy as np


def _axis_weights(n_in, n_out):
    """Half-pixel-center source indices + lerp weights for one axis."""
    scale = n_in / n_out
    centers = (np.arange(n_out) + 0.5) * scale - 0.5
    i0 = np.floor(centers).astype(np.int64)
    w1 = centers - i0
    i0c = np.clip(i0, 0, n_in - 1)
    i1c = np.clip(i0 + 1, 0, n_in - 1)
    return i0c, i1c, w1.astype(np.float32)


def resize(img: np.ndarray, size_wh) -> np.ndarray:
    """Resize HxW[xC] image to (width, height). uint8 in -> uint8 out."""
    out_w, out_h = int(size_wh[0]), int(size_wh[1])
    img = np.asarray(img)
    if (img.shape[1], img.shape[0]) == (out_w, out_h):
        return img
    was_int = np.issubdtype(img.dtype, np.integer)
    src = img.astype(np.float32)

    y0, y1, wy = _axis_weights(img.shape[0], out_h)
    x0, x1, wx = _axis_weights(img.shape[1], out_w)
    wy = wy.reshape(-1, *([1] * (src.ndim - 1)))
    rows = src[y0] * (1 - wy) + src[y1] * wy
    wx = wx.reshape(1, -1, *([1] * (src.ndim - 2)))
    out = rows[:, x0] * (1 - wx) + rows[:, x1] * wx

    if was_int:
        return np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out.astype(img.dtype)
