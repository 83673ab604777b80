"""The SeamFinder's step-by-step API against the JAX package's.

`find` on a small three-image layout (the rotation fixture warped onto
the sphere by the JAX warper, LOW-sized) for dp_color, dp_colorgrad,
voronoi, gc_color and no: the list forms cut pair by pair (i < j), each
pair seeing the cuts before it, so the seam masks are held equal. Then
`resize` (dilate, bilinear resize to the FINAL mask, AND), the draw
helpers, `extract_seam_lines` and `blend_seam_masks`, all equal. The
JAX package's jitted graph cut fails on a second variant in one process
(ROADMAP queue 3), so the gc case clears JAX's caches first.
"""

import jax
import numpy as np
import pytest
import torch

from fixtures import rotation_set
from stitching_tpu import seam_finder as jax_seam_finder
from stitching_tpu import types as jax_types
from stitching_tpu import warper as jax_warper
from stitching_tpu_torch import seam_finder

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)

JaxSeamFinder = jax_seam_finder.SeamFinder
SeamFinder = seam_finder.SeamFinder


def warped(size, focal):
    """Warped images, masks, corners and sizes of three rotated views."""
    imgs, _, Rs = rotation_set(n=3, size=size, focal=focal, max_angle=0.3)
    cams = [jax_types.CameraParams(focal, 1.0, size[0] / 2, size[1] / 2,
                                   np.asarray(R, np.float32)) for R in Rs]
    w = jax_warper.Warper("spherical")
    w.set_scale(cams)
    sizes = [size] * 3
    out = [np.asarray(x) for x in w.warp_images(imgs, cams)]
    masks = [np.asarray(m) for m in w.create_and_warp_masks(sizes, cams)]
    corners, out_sizes = w.warp_rois(sizes, cams)
    return out, masks, [tuple(c) for c in corners], out_sizes


@pytest.fixture(scope="module")
def low():
    return warped((128, 96), 120.0)


@pytest.fixture(scope="module")
def final():
    return warped((256, 192), 240.0)


@pytest.fixture(scope="module")
def seams(low):
    imgs, masks, corners, _ = low
    return JaxSeamFinder("dp_color").find(imgs, corners, masks)


@pytest.mark.parametrize("finder", ["dp_color", "dp_colorgrad", "voronoi",
                                    "gc_color", "no"])
def test_find_equals_jax(low, finder):
    imgs, masks, corners, _ = low
    if finder.startswith("gc"):
        jax.clear_caches()
    want = JaxSeamFinder(finder).find(imgs, corners, masks)
    got = SeamFinder(finder, device="cpu").find(imgs, corners, masks)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == np.uint8
        assert np.array_equal(a, b)
    if finder != "no":
        # the seams take pixels away where the images overlap
        assert sum(int((a > 0).sum()) for a in got) < sum(
            int((m > 0).sum()) for m in masks)


def test_resize_equals_jax(seams, final):
    _, fmasks, _, _ = final
    for seam, mask in zip(seams, fmasks):
        a = SeamFinder.resize(seam, mask, device="cpu")
        b = np.asarray(JaxSeamFinder.resize(seam, mask))
        assert a.shape == b.shape == mask.shape and a.dtype == b.dtype
        assert np.array_equal(a, b)


def test_draw_helpers_equal_jax(seams, low):
    imgs, _, corners, sizes = low
    for img, seam in zip(imgs, seams):
        assert np.array_equal(
            SeamFinder.draw_seam_mask(img, seam, (9, 8, 7)),
            JaxSeamFinder.draw_seam_mask(img, seam, (9, 8, 7)))
    want = np.asarray(JaxSeamFinder.blend_seam_masks(seams, corners, sizes))
    got = SeamFinder.blend_seam_masks(seams, corners, sizes, device="cpu")
    assert np.array_equal(got, want)
    pano = np.asarray(jax_seam_finder.Blender.create_panorama(
        imgs, seams, corners, sizes)[0])
    for linesize in (1, 3):
        assert np.array_equal(
            SeamFinder.extract_seam_lines(got, linesize),
            JaxSeamFinder.extract_seam_lines(want, linesize))
        assert np.array_equal(
            SeamFinder.draw_seam_lines(pano, got, linesize),
            JaxSeamFinder.draw_seam_lines(pano, want, linesize))
    for alpha in (0.5, 0.3):
        assert np.array_equal(
            SeamFinder.draw_seam_polygons(pano, got, alpha),
            JaxSeamFinder.draw_seam_polygons(pano, want, alpha))


def test_blend_seam_masks_takes_the_masks_shapes(seams, low):
    """A planned size a pixel larger than its mask (a rounded crop rect)
    colours the mask's own shape, where the reference raises."""
    _, _, corners, sizes = low
    grown = [(w + 1, h) for w, h in sizes]
    got = SeamFinder.blend_seam_masks(seams, corners, grown, device="cpu")
    want = SeamFinder.blend_seam_masks(seams, corners, sizes, device="cpu")
    assert got.shape[1] >= want.shape[1]
    assert np.array_equal(got[:, :want.shape[1]], want)
