"""The port's BRISK detector against `stitching_tpu.ops.brisk`.

Stated tolerances:

- the pattern tables equal the reference's, the short pairs in the
  reference's order (the port stores that order: the reference's
  `np.argsort` is not stable, and a stable sort orders the pattern's equal
  distances otherwise);
- the ring planes' blurs (7 taps) equal the reference's;
- the levels: the base equals the image; every other level is resized
  from it, within 1e-3 (of 255) of XLA's compiled `jax.image.resize`
  (5e-4 at the factor 1.5, where the weights' sums round most);
- keypoints: xy, size and valid equal, responses equal at the base level
  and within 1e-4 relative above it (the Harris sums carry the levels'
  gap); angles within 1e-3 degrees (the long
  pairs' gradient estimate is a product summed in another order, and the
  arctangents differ in the last bit);
- descriptor bits: at most 0.1% differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stitching_tpu.ops import brisk as jax_brisk
from stitching_tpu.ops.gaussian import gaussian_blur as jax_blur
from stitching_tpu_torch import pipeline as tp
from stitching_tpu_torch.ops import brisk
from stitching_tpu_torch.ops.color import bgr_to_gray
from stitching_tpu_torch.ops.gaussian import gaussian_blur
from stitching_tpu_torch.ops.orb import resize_linear_aa
from test_torch_sift import _detect_both, _masks, images  # noqa: F401

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def detections(images):  # noqa: F811
    return _detect_both("brisk", images, 1024)


@pytest.mark.parametrize("name", ["PATTERN_PTS", "PATTERN_RING",
                                  "PATTERN_SIGMAS", "SHORT_PAIRS",
                                  "LONG_PAIRS"])
def test_pattern_tables_equal_jax(name):
    got, ref = getattr(brisk, name), getattr(jax_brisk, name)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_short_pairs_are_the_512_shortest_in_order():
    pts = brisk.PATTERN_PTS
    sp = brisk.SHORT_PAIRS
    d = np.linalg.norm(pts[sp[:, 0]] - pts[sp[:, 1]], axis=1)
    assert (np.diff(d) >= 0).all() and d.max() < brisk._D_MAX
    ii, jj = np.triu_indices(len(pts), k=1)
    all_d = np.linalg.norm(pts[ii] - pts[jj], axis=1)
    shortest = np.argsort(all_d, kind="stable")[:brisk.N_BITS]
    assert (set(map(tuple, sp.tolist()))
            == set(zip(ii[shortest].tolist(), jj[shortest].tolist())))
    assert (sp[:, 0] < sp[:, 1]).all()


@pytest.mark.parametrize("sigma,radius", [
    *[(float(s), 3) for s in brisk.PATTERN_SIGMAS], (1.0, 2), (1.6, 3),
    (2.0, 3)])
def test_short_blurs_equal_jax(sigma, radius):
    """The 5- and 7-tap blurs (BRISK's rings, AKAZE's smoothing, ORB's
    descriptor plane) equal the reference's compiled convolution."""
    rng = np.random.RandomState(radius)
    x = (rng.rand(2, 64, 96) * 255).astype(np.float32)
    got = gaussian_blur(torch.as_tensor(x), sigma, radius=radius).numpy()
    ref = np.asarray(jax_blur(jnp.asarray(x), sigma, radius=radius))
    np.testing.assert_array_equal(got, ref)


def test_levels_close_to_jax_resize(images):  # noqa: F811
    gray = bgr_to_gray(tp.stack_images(images, device="cpu").data)
    h, w = gray.shape[1:]
    for s in brisk._SCALES:
        lh, lw = int(round(h / s)), int(round(w / s))
        if lh < 2 * brisk.BORDER + 1 or lw < 2 * brisk.BORDER + 1:
            break
        got = resize_linear_aa(gray, lh, lw).numpy()
        ref = np.asarray(jax.jit(jax.vmap(
            lambda y, sz=(lh, lw): jax.image.resize(y, sz, "linear")))(
                jnp.asarray(gray.numpy())))
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= (0 if s == 1.0 else 1e-3), s


def test_keypoints_match_jax(detections):
    ref, got = detections
    assert ref["valid"].sum() > 200
    for k in ("xy", "size", "valid"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    base = ref["size"] == 12.0
    assert base.sum() > 50
    np.testing.assert_array_equal(got["response"][base],
                                  ref["response"][base])
    np.testing.assert_allclose(got["response"], ref["response"], rtol=1e-4)
    valid = ref["valid"]
    diff = np.abs(got["angle_deg"] - ref["angle_deg"])[valid]
    assert np.minimum(diff, 360 - diff).max() <= 1e-3


def test_descriptor_bits_match_jax(detections):
    ref, got = detections
    assert got["desc"].shape == ref["desc"].shape == (2, 1024, 512)
    bits = got["desc"] != ref["desc"]
    assert bits.mean() <= 1e-3
    assert not got["desc"][~ref["valid"]].any()


def test_feature_masks_match_jax(images):  # noqa: F811
    masks = _masks(images)
    ref, got = _detect_both("brisk", images, 512, masks)
    for k in ("xy", "valid", "size"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for i in range(len(images)):
        assert (got["xy"][i][got["valid"][i], 0] < 160 + 60 * i).all()
