"""`Stitcher()` with every default setting against `stitching_tpu.Stitcher()`.

The defaults add the dp_color seams and the multiband blend to `SLICE2`.
The rotation fixture registers synchronously (inputs at MEDIUM size), so
the JAX package reaches its batched `blend_stack`, the path the port has.
With the reference's cameras handed over, the crop rects and the
panorama's shape are equal and every value is within 1 LSB, at least 99.9%
equal. Whole, the port's own registration moves the focal by up to ~1%
(ROADMAP queue 3), so shapes agree to 1% and focals to 2%.
"""

import numpy as np
import pytest
import torch

import stitching_tpu
from fixtures import rotation_set
from stitching_tpu import engine as jax_engine
from stitching_tpu_torch import Stitcher, convert, engine

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def images():
    imgs, _, _ = rotation_set(n=3, size=(640, 480))
    return imgs


@pytest.fixture(scope="module")
def jax_default(images):
    """One run of the JAX package with its defaults: final cameras, crop
    rects and panorama."""
    st = stitching_tpu.Stitcher()
    reg = jax_engine.register(st, images)
    assert reg.uploader is None          # the batched blend, not streamed
    cams = [c.copy() for c in reg.cameras]
    plan = jax_engine.plan_composition(st, reg)
    rects = [tuple(int(v) for v in r) for r in plan.crop_rects]
    return cams, rects, jax_engine.composite(st, reg, plan)


def test_default_panorama_with_jax_cameras(images, jax_default):
    cams, ref_rects, ref = jax_default
    st = Stitcher(device="cpu")
    reg = engine.register(st, images)
    reg.cameras = convert.cameras_from_numpy(
        [c.focal for c in cams], [c.aspect for c in cams],
        [c.ppx for c in cams], [c.ppy for c in cams],
        [np.asarray(c.R) for c in cams])
    st.warper.set_scale(reg.cameras)
    reg.scale = st.warper.scale
    plan = engine.plan_composition(st, reg)
    assert [tuple(int(v) for v in r) for r in plan.crop_rects] == ref_rects
    pano = engine.composite(st, reg, plan)
    assert pano.shape == ref.shape and pano.dtype == np.uint8
    diff = np.abs(pano.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999
    assert (pano.max(-1) > 0).mean() > 0.99


def test_default_stitch_matches_jax(images, jax_default):
    """The whole default pipeline through `Stitcher.stitch`, twice."""
    cams, _, ref = jax_default
    pano = Stitcher(device="cpu").stitch(images)
    assert pano.dtype == np.uint8 and pano.shape[2] == 3
    for a, b in zip(pano.shape[:2], ref.shape[:2]):
        assert abs(a - b) <= 0.01 * b + 1
    assert (pano.max(-1) > 0).mean() > 0.99
    reg = engine.register(Stitcher(device="cpu"), images)
    for c, r in zip(reg.cameras, cams):
        assert abs(c.focal - r.focal) <= 0.02 * r.focal
        np.testing.assert_allclose(c.R, r.R, atol=0.02)
    assert np.array_equal(Stitcher(device="cpu").stitch(images), pano)


@pytest.mark.parametrize("extra", [
    dict(finder="dp_colorgrad", blender_type="feather"),
    dict(finder="voronoi", blend_strength=0.2),
    dict(medium_megapix=0.1),
])
def test_default_variants_stitch(images, extra):
    """The other ported seam finders and blenders, a multiband blend of 0
    bands, and the downscaled registration branch run end to end."""
    pano = Stitcher(device="cpu", **extra).stitch(images)
    assert pano.dtype == np.uint8 and pano.ndim == 3 and pano.shape[2] == 3
    assert min(pano.shape[:2]) > 200 and (pano.max(-1) > 0).mean() > 0.99
