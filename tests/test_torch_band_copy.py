"""`ops/kernels/band_copy`: the geometry of the strided copy that lands a
panorama band in its place in a host panorama, through the plain version
of `cudaMemcpy2D` on the CPU, against the slice write it stands for. The
card's copy is held in `tests/test_torch_cuda.py`."""

import numpy as np
import pytest
import torch

from stitching_tpu_torch.ops.kernels.band_copy import (band_geometry,
                                                       copy_band)


def _bands(extent, rng, n=4):
    cuts = sorted({0, extent} | set(rng.randint(1, extent, n).tolist()))
    return list(zip(cuts, cuts[1:]))


@pytest.mark.parametrize("channels", [3, 1, None])
@pytest.mark.parametrize("axis", [0, 1])
def test_bands_land_where_the_slice_writes(axis, channels):
    """Bands cut at random points cover the panorama exactly as slice
    writes do, for (dh, dw, C) panoramas and (dh, dw) masks."""
    rng = np.random.RandomState(axis * 10 + (channels or 0))
    dh, dw = 37, 53
    shape = (dh, dw) if channels is None else (dh, dw, channels)
    want = torch.as_tensor(rng.randint(0, 256, shape).astype(np.uint8))
    got = torch.full(shape, 7, dtype=torch.uint8)
    for lo, hi in _bands(shape[axis], rng):
        band = (want[lo:hi] if axis == 0 else want[:, lo:hi]).contiguous()
        copy_band(got, axis, lo, band)
    assert torch.equal(got, want)


def test_geometry_in_bytes():
    # a column band of a (100, 400, 3) panorama at column 50, 20 wide
    assert band_geometry((100, 400, 3), 1, 50, (100, 20, 3)) == (
        150, 1200, 60, 60, 100)
    # a row band from row 10, 5 rows: the pitches equal
    assert band_geometry((100, 400, 3), 0, 10, (5, 400, 3)) == (
        12000, 1200, 1200, 1200, 5)
    # a mask's column band
    assert band_geometry((100, 400), 1, 50, (100, 20)) == (
        50, 400, 20, 20, 100)


def test_other_elements_move_as_bytes():
    """The plain version copies bytes: a float32 band lands whole."""
    want = torch.arange(6 * 8 * 2, dtype=torch.float32).reshape(6, 8, 2)
    got = torch.zeros_like(want)
    copy_band(got, 1, 0, want[:, :3].contiguous())
    copy_band(got, 1, 3, want[:, 3:].contiguous())
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["outside", "narrow", "strided", "dtype",
                                  "axis"])
def test_refuses_what_it_cannot_land(case):
    pano = torch.zeros((10, 20, 3), dtype=torch.uint8)
    band = torch.zeros((10, 4, 3), dtype=torch.uint8)
    axis, lo = 1, 0
    if case == "outside":
        lo = 18
    elif case == "narrow":
        band = band[:9].contiguous()
    elif case == "strided":
        band = torch.zeros((10, 8, 3), dtype=torch.uint8)[:, ::2]
    elif case == "dtype":
        band = band.float()
    else:
        axis = 2
    with pytest.raises(ValueError):
        copy_band(pano, axis, lo, band)
