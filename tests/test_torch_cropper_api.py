"""The Cropper's step-by-step API against the JAX package's.

On the LOW warps of three rotated views (the JAX warper's): the panorama
mask (`estimate_panorama_mask`), `prepare` (the LIR and every rect),
`crop_images` / `crop_img` at the LOW and at a FINAL aspect, `crop_rois`,
`Rectangle.draw_on` on a gray and a colour image, and the static helpers
(`get_zero_center_corners`, `get_rectangles`, `get_overlap`,
`get_intersection`). All host geometry and slicing: everything is equal.
"""

import numpy as np
import pytest
import torch

from fixtures import rotation_set
from stitching_tpu import cropper as jax_cropper
from stitching_tpu import types as jax_types
from stitching_tpu import warper as jax_warper
from stitching_tpu.errors import StitchingError as JaxStitchingError
from stitching_tpu_torch import cropper
from stitching_tpu_torch.errors import StitchingError

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def low():
    size, focal = (128, 96), 120.0
    imgs, _, Rs = rotation_set(n=3, size=size, focal=focal, max_angle=0.3)
    cams = [jax_types.CameraParams(focal, 1.0, size[0] / 2, size[1] / 2,
                                   np.asarray(R, np.float32)) for R in Rs]
    w = jax_warper.Warper("spherical")
    w.set_scale(cams)
    out = [np.asarray(x) for x in w.warp_images(imgs, cams)]
    masks = [np.asarray(m) for m in w.create_and_warp_masks([size] * 3,
                                                            cams)]
    corners, sizes = w.warp_rois([size] * 3, cams)
    return out, masks, [tuple(c) for c in corners], sizes


@pytest.fixture(scope="module")
def prepared(low):
    imgs, masks, corners, sizes = low
    corners = jax_cropper.Cropper.get_zero_center_corners(corners)
    ref = jax_cropper.Cropper()
    ref.prepare(imgs, masks, corners, sizes)
    got = cropper.Cropper(device="cpu")
    got.prepare(imgs, masks, corners, sizes)
    return ref, got


def test_panorama_mask_equals_jax(low):
    imgs, masks, corners, sizes = low
    want = np.asarray(jax_cropper.Cropper.estimate_panorama_mask(
        imgs, masks, corners, sizes))
    got = cropper.Cropper.estimate_panorama_mask(imgs, masks, corners,
                                                 sizes, device="cpu")
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_prepare_equals_jax(prepared):
    ref, got = prepared
    assert tuple(got.lir) == tuple(ref.lir)
    assert got.overlapping_rectangles == ref.overlapping_rectangles
    assert got.intersection_rectangles == ref.intersection_rectangles


@pytest.mark.parametrize("aspect", [1, 2.03])
def test_crop_images_and_rois_equal_jax(prepared, low, aspect):
    ref, got = prepared
    imgs, masks, corners, sizes = low
    if aspect != 1:     # a FINAL-sized set: the LOW warps upsampled
        imgs = [np.repeat(np.repeat(im, 3, 0), 3, 1) for im in imgs]
        masks = [np.repeat(np.repeat(m, 3, 0), 3, 1) for m in masks]
    for a, b in zip(got.crop_images(imgs, aspect),
                    ref.crop_images(imgs, aspect)):
        assert np.array_equal(a, b)
    for idx, m in enumerate(masks):
        assert np.array_equal(got.crop_img(m, idx, aspect),
                              ref.crop_img(m, idx, aspect))
    assert got.crop_rois(corners, sizes, aspect) == \
        ref.crop_rois(corners, sizes, aspect)


def test_no_crop_passes_through(low):
    imgs, masks, corners, sizes = low
    off = cropper.Cropper(False, device="cpu")
    off.prepare(imgs, masks, corners, sizes)
    assert all(a is b for a, b in zip(off.crop_images(imgs), imgs))
    assert off.crop_rois(corners, sizes) == (corners, sizes)


@pytest.mark.parametrize("gray", [True, False])
def test_rectangle_draw_on_equals_jax(low, gray):
    imgs, masks, corners, sizes = low
    mask = jax_cropper.Cropper.estimate_panorama_mask(
        imgs, masks, corners, sizes)
    img = np.asarray(mask) if gray else np.asarray(imgs[0])
    rect = (3, 4, 50, 30)
    a = cropper.Rectangle(*rect).draw_on(img.copy(), size=2)
    b = jax_cropper.Rectangle(*rect).draw_on(img.copy(), size=2)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b)


def test_static_helpers_equal_jax(low):
    _, _, corners, sizes = low
    C, J = cropper.Cropper, jax_cropper.Cropper
    assert C.get_zero_center_corners(corners) == \
        J.get_zero_center_corners(corners)
    rects = C.get_rectangles(corners, sizes)
    assert rects == J.get_rectangles(corners, sizes)
    bound = C.get_rectangles([(corners[0][0] + 5, corners[0][1] + 5)],
                             [(60, 40)])[0]
    for r in rects[:2]:
        got = C.get_overlap(r, bound)
        assert got == J.get_overlap(r, bound)
        assert C.get_intersection(r, got) == J.get_intersection(r, got)
    far = C.get_rectangles([(10 ** 6, 10 ** 6)], [(1, 1)])[0]
    with pytest.raises(StitchingError):
        C.get_overlap(rects[0], far)
    with pytest.raises(JaxStitchingError):
        J.get_overlap(rects[0], far)
