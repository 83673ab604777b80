"""`AffineStitcher(detector="sift")` end to end against the JAX package,
on the scan fixture (the reference's budapest-style case: translated
crops, float descriptors through the float 2-NN).

- With the reference's cameras handed over: the crop rects equal and
  every value within 1 LSB.
- With its own registration: each crop's offset within 1 px of the
  reference's, linear parts within 2e-3, the panorama's sides within 1%.
"""

import numpy as np
import pytest
import torch

import stitching_tpu
from fixtures import affine_set
from stitching_tpu import engine as jax_engine
from stitching_tpu_torch import AffineStitcher, convert, engine

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def images():
    return affine_set(n=3)[0]


@pytest.fixture(scope="module")
def jax_run(images):
    st = stitching_tpu.AffineStitcher(detector="sift")
    reg = jax_engine.register(st, images)
    plan = jax_engine.plan_composition(st, reg)
    rects = [tuple(int(v) for v in r) for r in plan.crop_rects]
    return ([c.copy() for c in reg.cameras], rects,
            jax_engine.composite(st, reg, plan))


def test_sift_affine_with_jax_cameras_within_one_lsb(images, jax_run):
    cams, rects, ref = jax_run
    st = AffineStitcher(detector="sift", device="cpu")
    reg = engine.register(st, images)
    assert st.detector.is_binary is False and st.matcher.match_conf == 0.65
    reg.cameras = convert.cameras_from_numpy(
        [c.focal for c in cams], [c.aspect for c in cams],
        [c.ppx for c in cams], [c.ppy for c in cams],
        [np.asarray(c.R) for c in cams])
    st.warper.set_scale(reg.cameras)
    reg.scale = st.warper.scale
    plan = engine.plan_composition(st, reg)
    assert [tuple(int(v) for v in r) for r in plan.crop_rects] == rects
    pano = engine.composite(st, reg, plan)
    assert pano.shape == ref.shape and pano.dtype == np.uint8
    diff = np.abs(pano.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1


def test_sift_affine_with_own_registration_close_to_jax(images, jax_run):
    cams, _, ref = jax_run
    st = AffineStitcher(detector="sift", device="cpu")
    reg = engine.register(st, images)
    assert len(reg.cameras) == len(cams) == 3
    for c, r in zip(reg.cameras, cams):
        assert np.abs(np.asarray(c.R)[:2, 2] - np.asarray(r.R)[:2, 2]).max() \
            <= 1.0
        np.testing.assert_allclose(np.asarray(c.R)[:2, :2],
                                   np.asarray(r.R)[:2, :2], atol=2e-3)
    pano = engine.composite(st, reg, engine.plan_composition(st, reg))
    for a, b in zip(pano.shape[:2], ref.shape[:2]):
        assert abs(a - b) <= 0.01 * b
