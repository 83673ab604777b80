"""The ExposureErrorCompensator's `feed` / `apply` against the JAX
package's, for all five kinds (`nr_feeds=2` for the scalar kinds, and
another block size).

Three rotated views, each at its own exposure, warped onto the sphere by
the JAX warper at a LOW size (feed) and a FINAL size (apply); the scalar
kinds with 1 to 3 feeds. The port's
float32 overlap and block sums run in another order than numpy's, so the
gains (gain, channel) and the smoothed gain maps (the blocks kinds) are
held to 1e-4, and each compensated FINAL warp to every value within 1 LSB
with at least 99.9% equal, the engine path's bars (ROADMAP queue 3).
"""

import numpy as np
import pytest
import torch

from fixtures import rotation_set
from stitching_tpu import exposure_error_compensator as jax_comp
from stitching_tpu import types as jax_types
from stitching_tpu import warper as jax_warper
from stitching_tpu_torch import exposure_error_compensator as comp

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)

EXPOSURE = (1.0, 0.8, 1.15)


def warped(size, focal):
    imgs, _, Rs = rotation_set(n=3, size=size, focal=focal, max_angle=0.3)
    imgs = [np.clip(im * e, 0, 255).astype(np.uint8)
            for im, e in zip(imgs, EXPOSURE)]
    cams = [jax_types.CameraParams(focal, 1.0, size[0] / 2, size[1] / 2,
                                   np.asarray(R, np.float32)) for R in Rs]
    w = jax_warper.Warper("spherical")
    w.set_scale(cams)
    sizes = [size] * 3
    out = [np.asarray(x) for x in w.warp_images(imgs, cams)]
    masks = [np.asarray(m) for m in w.create_and_warp_masks(sizes, cams)]
    corners, _ = w.warp_rois(sizes, cams)
    return out, masks, [tuple(c) for c in corners]


@pytest.fixture(scope="module")
def stages():
    return warped((128, 96), 120.0), warped((256, 192), 240.0)


# nr_feeds=3: the list form scales each round's images by the product of
# the gains so far on top of the last round's (ROADMAP queue 3), and the
# port's list form does the same
CASES = [("gain", 1, 32), ("gain", 2, 32), ("gain", 3, 32),
         ("channel", 1, 32), ("channel", 2, 32), ("gain_blocks", 1, 32),
         ("gain_blocks", 1, 16), ("channel_blocks", 1, 32), ("no", 1, 32)]


@pytest.mark.parametrize("kind,nr_feeds,block_size", CASES)
def test_feed_apply_equals_jax(stages, kind, nr_feeds, block_size):
    (limgs, lmasks, lcorners), (fimgs, fmasks, fcorners) = stages
    ref = jax_comp.ExposureErrorCompensator(kind, nr_feeds, block_size)
    got = comp.ExposureErrorCompensator(kind, nr_feeds, block_size,
                                        device="cpu")
    ref.feed(lcorners, limgs, lmasks)
    got.feed(lcorners, limgs, lmasks)
    if kind in ("gain", "channel"):
        np.testing.assert_allclose(got._gains, ref._gains, atol=1e-4)
        assert np.abs(np.asarray(ref._gains) - 1).max() > 0.05
    elif kind != "no":
        assert got._block_state[:2] == ref._block_state[:2]
        for a, b in zip(got._block_state[2], ref._block_state[2]):
            np.testing.assert_allclose(a, b, atol=1e-4)
    for idx, (img, mask, corner) in enumerate(zip(fimgs, fmasks, fcorners)):
        a = got.apply(idx, corner, img, mask)
        b = np.asarray(ref.apply(idx, corner, img, mask))
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
        if kind == "no":
            assert np.array_equal(a, img)


def test_apply_keeps_float_dtype(stages):
    (limgs, lmasks, lcorners), (fimgs, fmasks, fcorners) = stages
    ref = jax_comp.ExposureErrorCompensator("gain_blocks")
    got = comp.ExposureErrorCompensator("gain_blocks", device="cpu")
    ref.feed(lcorners, limgs, lmasks)
    got.feed(lcorners, limgs, lmasks)
    src = fimgs[1].astype(np.float32)
    a = got.apply(1, fcorners[1], src)
    b = np.asarray(ref.apply(1, fcorners[1], src))
    assert a.dtype == b.dtype == np.float32
    assert np.abs(a - b).max() <= 1


@pytest.mark.parametrize("kind", ["gain", "channel_blocks"])
def test_apply_after_the_engines_feed(stages, kind):
    """`apply` also serves a compensator fed by the engine's `feed_stack`
    (its state kept on the stack's device): within 1 LSB of the list
    feed's, at least 99.9% equal."""
    from stitching_tpu_torch.compose import TileStack

    (limgs, lmasks, lcorners), (fimgs, fmasks, fcorners) = stages
    th = max(im.shape[0] for im in limgs)
    tw = max(im.shape[1] for im in limgs)
    data = torch.zeros((3, th, tw, 3))
    masks = torch.zeros((3, th, tw))
    for k, (im, m) in enumerate(zip(limgs, lmasks)):
        data[k, :im.shape[0], :im.shape[1]] = torch.as_tensor(im).float()
        masks[k, :m.shape[0], :m.shape[1]] = torch.as_tensor(m).float()
    sizes = np.asarray([(im.shape[1], im.shape[0]) for im in limgs])
    stacked = comp.ExposureErrorCompensator(kind, device="cpu")
    stacked.feed_stack(lcorners, TileStack(data, masks, np.asarray(lcorners),
                                           sizes))
    listed = comp.ExposureErrorCompensator(kind, device="cpu")
    listed.feed(lcorners, limgs, lmasks)
    for idx, (img, corner) in enumerate(zip(fimgs, fcorners)):
        a = stacked.apply(idx, corner, img)
        b = listed.apply(idx, corner, img)
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
