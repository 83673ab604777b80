"""Slice 6's device-resident entry against the JAX package.

`Stitcher.stitch_device` on a prestaged stack returns the panorama as a
uint8 tensor on the stitcher's device; it is held to the JAX package's
`stitch_device` by shape, as `tests/test_stitcher.py` holds that one to
the host path, with and without a noise image that subsetting drops.
`DeviceStack.image` gives an image back cropped to its true size.
"""

import warnings

import numpy as np
import pytest
import torch

import stitching_tpu
from fixtures import rotation_set
from stitching_tpu import pipeline as jax_pipeline
from stitching_tpu_torch import Stitcher, StitchingWarning
from stitching_tpu_torch.pipeline import stack_images

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)


def test_stitch_device_matches_jax():
    """`stitch_device` on a prestaged stack: a uint8 tensor on the
    stitcher's device, the JAX package's shape within 4 px."""
    imgs, _, _ = rotation_set(n=3, size=(640, 480), focal=560.0,
                              max_angle=0.3)
    ref = np.asarray(stitching_tpu.Stitcher(crop=False).stitch_device(
        imgs, prestaged=jax_pipeline.stack_images(imgs)))
    out = Stitcher(device="cpu", crop=False).stitch_device(
        imgs, prestaged=stack_images(imgs, "cpu"))
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint8
    assert out.device.type == "cpu"
    np.testing.assert_allclose(out.shape, ref.shape, atol=4)
    # without a prestaged stack, run_device stages the originals itself
    again = Stitcher(device="cpu", crop=False).stitch_device(imgs)
    assert torch.equal(again, out)


def test_stitch_device_subsets_noise_image():
    """A non-matching image is dropped with the reference's warning and
    the prestaged stack is gathered on the device."""
    imgs, _, _ = rotation_set(n=3, size=(512, 384), focal=450.0,
                              max_angle=0.35)
    noise = np.random.RandomState(7).randint(0, 255, imgs[0].shape,
                                             np.uint8)
    all_imgs = imgs + [noise]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = np.asarray(stitching_tpu.Stitcher(crop=False).stitch_device(
            all_imgs, prestaged=jax_pipeline.stack_images(all_imgs)))
    with pytest.warns(StitchingWarning):
        out = Stitcher(device="cpu", crop=False).stitch_device(
            all_imgs, prestaged=stack_images(all_imgs, "cpu"))
    assert out.dtype == torch.uint8
    np.testing.assert_allclose(out.shape, ref.shape, atol=6)


def test_device_stack_image():
    imgs, _, _ = rotation_set(n=2, size=(160, 120))
    imgs[1] = imgs[1][:100, :150]
    stack = stack_images(imgs, "cpu")
    for i, im in enumerate(imgs):
        got = stack.image(i)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, im.astype(np.float32))
