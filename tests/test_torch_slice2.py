"""The port's second slice against `stitching_tpu.Stitcher`.

`SLICE2 = dict(finder="no", blender_type="no")` leaves every other setting
at its default: ray bundle adjustment, horizontal wave correction, the
largest-interior-rectangle crop and gain_blocks exposure. It runs through
both packages on the rotation fixture: with the reference's final cameras
handed over (crop, exposure and compose alone), with its features and
matches handed over (camera estimate, bundle adjustment and wave correction
too), and whole.
"""

import numpy as np
import pytest
import torch

import stitching_tpu
from fixtures import rotation_set
from stitching_tpu import engine as jax_engine
from stitching_tpu_torch import SLICE2, Stitcher, convert, engine

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def images():
    imgs, _, _ = rotation_set(n=3, size=(640, 480))
    return imgs


def _features_and_matches(reg):
    feats = [convert.features_from_numpy(
        np.asarray(f.xy), np.asarray(f.response), np.asarray(f.size),
        np.asarray(f.angle), np.asarray(f.desc), np.asarray(f.valid),
        f.img_size) for f in reg.features]
    matches = [convert.matches_from_numpy(
        m.src_img_idx, m.dst_img_idx, m.matches, m.matches_valid,
        m.inliers_mask, m.num_inliers, m.H, m.confidence)
        for m in reg.matches]
    return feats, matches


@pytest.fixture(scope="module")
def jax_slice2(images):
    """One run of the JAX package under `SLICE2`: final cameras, crop
    rects, panorama, and its features and matches as the port's objects."""
    st = stitching_tpu.Stitcher(**SLICE2)
    reg = jax_engine.register(st, images)
    cams = [c.copy() for c in reg.cameras]
    feats, matches = _features_and_matches(reg)
    plan = jax_engine.plan_composition(st, reg)
    rects = [tuple(int(v) for v in r) for r in plan.crop_rects]
    pano = jax_engine.composite(st, reg, plan)
    return cams, rects, pano, feats, matches


def _slice2_composite(st, reg):
    plan = engine.plan_composition(st, reg)
    rects = [tuple(int(v) for v in r) for r in plan.crop_rects]
    return rects, engine.composite(st, reg, plan)


def test_slice2_panorama_with_jax_cameras(images, jax_slice2):
    """Crop, exposure and compose alone: with the reference's final
    cameras the crop rects and the panorama's shape are equal, and at
    least 99.9% of values are within 1 LSB (the block sums' order moves a
    few gains in the last bits, and `round(t * gain)` then flips)."""
    cams, ref_rects, ref = jax_slice2[:3]
    st = Stitcher(device="cpu", **SLICE2)
    reg = engine.register(st, images)
    reg.cameras = convert.cameras_from_numpy(
        [c.focal for c in cams], [c.aspect for c in cams],
        [c.ppx for c in cams], [c.ppy for c in cams],
        [np.asarray(c.R) for c in cams])
    st.warper.set_scale(reg.cameras)
    reg.scale = st.warper.scale
    rects, pano = _slice2_composite(st, reg)
    assert rects == ref_rects
    assert pano.shape == ref.shape and pano.dtype == np.uint8
    diff = np.abs(pano.astype(np.int16) - ref.astype(np.int16))
    assert (diff <= 1).mean() >= 0.999
    # cropped to the interior rectangle: no empty border is left
    assert (pano.max(-1) > 0).mean() > 0.99


def test_slice2_with_jax_registration_matches_jax(images, jax_slice2):
    """The reference's features and matches go in through `convert`; the
    port estimates, bundle-adjusts and wave-corrects the cameras, crops,
    compensates and composites. Cameras agree within the bundle tolerance
    (focal 1e-3 relative, R 1e-3) and the panorama's shape to 1%."""
    cams, _, ref, feats, matches = jax_slice2
    st = Stitcher(device="cpu", **SLICE2)
    own = engine.register(st, images)
    reg = engine._register_cameras(st, own.images, own.stack, feats,
                                   matches, low_stack=own.low_stack)
    assert len(reg.cameras) == len(cams)
    for c, r in zip(reg.cameras, cams):
        assert abs(c.focal - r.focal) <= 1e-3 * r.focal
        np.testing.assert_allclose(c.R, r.R, atol=1e-3)
    _, pano = _slice2_composite(st, reg)
    assert pano.dtype == np.uint8 and pano.shape[2] == 3
    for a, b in zip(pano.shape[:2], ref.shape[:2]):
        assert abs(a - b) <= 0.01 * b + 1


def test_slice2_stitch_matches_jax(images, jax_slice2):
    """The whole second slice through `Stitcher.stitch`, with the port's
    own registration (whose ORB rows differ, ROADMAP queue 3): cameras to
    2%, the cropped panorama's shape to 1%, and the same result twice."""
    cams, _, ref = jax_slice2[:3]
    st = Stitcher(device="cpu", **SLICE2)
    pano = st.stitch(images)
    assert pano.dtype == np.uint8 and pano.shape[2] == 3
    for a, b in zip(pano.shape[:2], ref.shape[:2]):
        assert abs(a - b) <= 0.01 * b + 1
    assert (pano.max(-1) > 0).mean() > 0.99
    reg = engine.register(Stitcher(device="cpu", **SLICE2), images)
    for c, r in zip(reg.cameras, cams):
        assert abs(c.focal - r.focal) <= 0.02 * r.focal
        np.testing.assert_allclose(c.R, r.R, atol=0.02)
    assert np.array_equal(Stitcher(device="cpu", **SLICE2).stitch(images),
                          pano)


@pytest.mark.parametrize("extra", [
    dict(adjuster="reproj", wave_correct_kind="auto",
         compensator="channel_blocks"),
    dict(wave_correct_kind="vert", crop=False, refinement_mask="x_x_x"),
    dict(medium_megapix=0.1),
])
def test_slice2_variants_stitch(images, extra):
    """The other ported choices run end to end, and so does the downscaled
    registration branch."""
    pano = Stitcher(device="cpu", **SLICE2, **extra).stitch(images)
    assert pano.dtype == np.uint8 and pano.ndim == 3 and pano.shape[2] == 3
    assert min(pano.shape[:2]) > 200 and (pano.max(-1) > 0).mean() > 0.5
