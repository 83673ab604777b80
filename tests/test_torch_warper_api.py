"""The Warper's per-image methods against the JAX package's.

`warp_image` (bilinear, reflect border) and `create_and_warp_mask`
(nearest, constant border) on the spherical, cylindrical, plane, fisheye
and affine surfaces, at the registration scale and at another aspect, on
the same numpy inputs. Tolerances: ROIs (`warp_rois`) and warped masks
are equal; uint8 warps have every value within 1 LSB and at least 99.99%
equal; float32 warps have no value 1e-2 or more apart and at most 1e-3 of
values more than 2e-3 apart (PyTorch's and XLA's transcendentals differ
in the last bit, ROADMAP queue 3; the plane and affine maps, products and
sums rounded as the reference's compiled code, are exact).
"""

import numpy as np
import pytest
import torch

from fixtures import affine_set, rotation_set
from stitching_tpu import types as jax_types
from stitching_tpu import warper as jax_warper
from stitching_tpu_torch import types, warper

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)

SURFACES = ["spherical", "cylindrical", "plane", "fisheye", "affine"]
SIZE = (160, 120)


def case(surface):
    """Images and (focal, aspect, ppx, ppy, R) cameras for a surface."""
    if surface == "affine":
        imgs, offsets = affine_set(n=3, size=SIZE)
        cams = []
        for k, (dx, dy) in enumerate(offsets):
            a = 0.02 * (k - 1)
            R = np.array([[np.cos(a), -np.sin(a), dx],
                          [np.sin(a), np.cos(a), dy], [0, 0, 1]],
                         np.float32)
            cams.append((1.0, 1.0, 0.0, 0.0, R))
        return imgs, cams
    imgs, K, Rs = rotation_set(n=3, size=SIZE, focal=150.0, max_angle=0.3)
    return imgs, [(150.0, 1.0, SIZE[0] / 2, SIZE[1] / 2,
                   np.asarray(R, np.float32)) for R in Rs]


def pair(surface):
    imgs, cams = case(surface)
    ref = jax_warper.Warper(surface)
    got = warper.Warper(surface, device="cpu")
    ref.set_scale([jax_types.CameraParams(*c) for c in cams])
    got.set_scale([types.CameraParams(*c) for c in cams])
    return (imgs, [jax_types.CameraParams(*c) for c in cams],
            [types.CameraParams(*c) for c in cams], ref, got)


def within_lsb(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.9999


@pytest.mark.parametrize("aspect", [1, 0.5])
@pytest.mark.parametrize("surface", SURFACES)
def test_warp_image_uint8(surface, aspect):
    imgs, jcams, cams, ref, got = pair(surface)
    for img, jc, c in zip(imgs, jcams, cams):
        within_lsb(got.warp_image(img, c, aspect),
                   ref.warp_image(img, jc, aspect))


@pytest.mark.parametrize("surface", SURFACES)
def test_warp_image_float(surface):
    imgs, jcams, cams, ref, got = pair(surface)
    for img, jc, c in zip(imgs, jcams, cams):
        src = img.astype(np.float32) * 0.5
        a = got.warp_image(src, c)
        b = np.asarray(ref.warp_image(src, jc))
        assert a.shape == b.shape and a.dtype == np.float32
        diff = np.abs(a - b)
        assert diff.max() < 1e-2
        assert (diff > 2e-3).mean() <= 1e-3
        if surface in ("plane", "affine"):
            assert diff.max() == 0


@pytest.mark.parametrize("aspect", [1, 0.5])
@pytest.mark.parametrize("surface", SURFACES)
def test_create_and_warp_masks_equal(surface, aspect):
    imgs, jcams, cams, ref, got = pair(surface)
    sizes = [(im.shape[1], im.shape[0]) for im in imgs]
    for a, b in zip(got.create_and_warp_masks(sizes, cams, aspect),
                    ref.create_and_warp_masks(sizes, jcams, aspect)):
        assert a.dtype == np.uint8 and np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("surface", SURFACES)
def test_warp_rois_equal(surface):
    imgs, jcams, cams, ref, got = pair(surface)
    sizes = [(im.shape[1], im.shape[0]) for im in imgs]
    corners, out_sizes = got.warp_rois(sizes, cams, 0.5)
    want_c, want_s = ref.warp_rois(sizes, jcams, 0.5)
    assert corners == [tuple(c) for c in want_c]
    assert out_sizes == [tuple(s) for s in want_s]
    # each warped image has its ROI's size
    for img, c, (w, h) in zip(imgs, cams, out_sizes):
        assert got.warp_image(img, c, 0.5).shape[:2] == (h, w)


def test_gray_image_warps_to_gray():
    imgs, jcams, cams, ref, got = pair("spherical")
    gray = imgs[0][..., 1]
    a = got.warp_image(gray, cams[0])
    within_lsb(a, np.asarray(ref.warp_image(gray, jcams[0])))
    assert a.ndim == 2
