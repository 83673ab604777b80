"""A finished panorama band copied into its place in a host panorama.

No TPU kernel stands behind it: the JAX package fetches each band of a
streamed blend into a host array of its own and writes it into a host
panorama (`stitching_tpu/compose.py`, the blends' `stream_fetch`). On the
card the copy engine lands the band in place instead: `copy_band` issues
one strided device-to-host copy (`csrc/band_copy.cu`,
`cudaMemcpy2DAsync`) on the current stream into a pinned host tensor, so
the host neither zeroes the panorama nor writes a pixel of it. A column
band (axis 1) is `height` rows of `width` bytes, `dpitch` apart in the
panorama; a row band (axis 0) the same copy with equal pitches.

`band_geometry` computes that copy's bytes from the shapes on the host;
`copy_band_plain` repeats `cudaMemcpy2D`'s arithmetic on CPU byte views.
It lands the CPU's bands, so the CPU runs the geometry the card is
given.
"""

import math

import torch

from . import check, load, stream_ptr

# one copy a band
LAUNCHES = 1


def band_geometry(host_shape, axis, lo, band_shape, itemsize=1):
    """(offset, dpitch, spitch, width, height) in bytes of the copy that
    lands a band of `band_shape` at [lo, lo + extent) along `axis` of a
    contiguous host panorama of `host_shape` ((dh, dw) or (dh, dw, C))."""
    pixel = itemsize * math.prod(host_shape[2:])
    dw = int(host_shape[1])
    height, width = int(band_shape[0]), int(band_shape[1]) * pixel
    offset = lo * dw * pixel if axis == 0 else lo * pixel
    return offset, dw * pixel, width, width, height


def copy_band_plain(dst, offset, dpitch, src, spitch, width, height):
    """`cudaMemcpy2D`'s arithmetic on the CPU: `height` rows of `width`
    bytes from `src` (rows `spitch` apart) into `dst` from byte `offset`
    on (rows `dpitch` apart). Both tensors contiguous."""
    d = dst.reshape(-1).view(torch.uint8)
    s = src.reshape(-1).view(torch.uint8)
    d.as_strided((height, width), (dpitch, 1), offset).copy_(
        s.as_strided((height, width), (spitch, 1)))


def _check(dst, axis, lo, band):
    if axis not in (0, 1):
        raise ValueError("copy_band: axis must be 0 (rows) or 1 (columns)")
    if dst.device.type != "cpu" or not dst.is_contiguous():
        raise ValueError("copy_band: the panorama must be a contiguous host "
                         "tensor")
    if not band.is_contiguous() or band.dtype != dst.dtype:
        raise ValueError("copy_band: the band must be contiguous and of the "
                         "panorama's dtype")
    across = 1 - axis
    if (band.dim() != dst.dim() or band.shape[2:] != dst.shape[2:]
            or band.shape[across] != dst.shape[across]):
        raise ValueError(f"copy_band: a band {tuple(band.shape)} does not "
                         f"span the panorama {tuple(dst.shape)} across "
                         f"axis {axis}")
    if not 0 <= lo <= lo + band.shape[axis] <= dst.shape[axis]:
        raise ValueError(f"copy_band: [{lo}, {lo + band.shape[axis]}) lies "
                         f"outside the panorama along axis {axis}")


def copy_band(dst, axis, lo, band):
    """Write `band` into the host panorama `dst` at [lo, lo + extent)
    along `axis` (0: a row band (extent, dw[, C]); 1: a column band (dh,
    extent[, C])). A band on the card is one asynchronous copy on the
    current stream into `dst`, which must be pinned: the caller keeps both
    tensors alive until the stream has passed it. A band on the CPU is
    written at once, by the plain version."""
    _check(dst, axis, lo, band)
    geometry = band_geometry(dst.shape, axis, lo, band.shape,
                             dst.element_size())
    offset, dpitch, spitch, width, height = geometry
    if band.device.type == "cpu":
        copy_band_plain(dst, offset, dpitch, band, spitch, width, height)
        return
    if band.device.type != "cuda":
        raise ValueError("copy_band: the band must lie on the CPU or a CUDA "
                         "device")
    if not dst.is_pinned():
        raise ValueError("copy_band: a band on the card lands only in pinned "
                         "host memory")
    fn = load("copy_band_2d")
    with torch.cuda.device(band.device):
        status = fn(dst.data_ptr() + offset, dpitch, band.data_ptr(), spitch,
                    width, height, stream_ptr(band.device))
    check(status, "copy_band_2d")
    copy_band.launches += LAUNCHES


copy_band.launches = 0
