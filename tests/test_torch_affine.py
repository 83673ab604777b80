"""The affine family of the port against the JAX package: the similarity
RANSAC, the affine camera estimate, the affine bundle model and
`AffineStitcher` end to end on `fixtures.affine_set` (three translated
640x480 crops of one scene), with `crop=False`.

With the reference's features and matches handed over, the port's cameras
equal the reference's to 1e-4 and the panorama is within 1 LSB at 99.9%
of values or more; with the port's own ORB features (whose rows differ in
a few bits, ROADMAP queue 3) the offsets agree to a pixel and the shape to
1%.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import stitching_tpu
from fixtures import affine_set
from stitching_tpu import engine as jax_engine
from stitching_tpu.camera_adjuster import CameraAdjuster as JaxAdjuster
from stitching_tpu.camera_estimator import CameraEstimator as JaxEstimator
from stitching_tpu.ops.ransac import ransac_affine_partial as ransac_jax
from stitching_tpu_torch import (AffineStitcher, StitchingWarning, convert,
                                 engine)
from stitching_tpu_torch.camera_adjuster import CameraAdjuster
from stitching_tpu_torch.camera_estimator import CameraEstimator
from stitching_tpu_torch.ops.ransac import ransac_affine_partial
from test_torch_slice2 import _features_and_matches

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)


def _similarity_sets(m=150, seed=0):
    """Matched raw-pixel points under known similarities: noisy with
    outliers and invalid rows; exact on an integer grid (every good
    hypothesis scores the same: the first maximum wins); shared
    keypoints (coincident points, rejected samples); one valid row and
    none (the draw's ties among the invalid rows)."""
    rng = np.random.RandomState(seed)
    P = 6
    src = np.zeros((P, m, 2), np.float32)
    dst = np.zeros((P, m, 2), np.float32)
    valid = np.zeros((P, m), bool)
    for p in range(P):
        t = 0.03 * (p - 2)
        a, b = (1 + 0.02 * p) * np.cos(t), (1 + 0.02 * p) * np.sin(t)
        A = np.array([[a, -b, 350.0 - 30 * p], [b, a, 12.0 + 5 * p]])
        if p == 1:
            s = rng.randint(0, 640, (m, 2)).astype(np.float64)
            A = np.array([[1.0, 0.0, 352.0], [0.0, 1.0, 12.0]])
        else:
            s = rng.uniform(0, 640, (m, 2))
        d = s @ A[:, :2].T + A[:, 2]
        if p != 1:
            d += rng.normal(0, 0.5, d.shape)
            out = rng.rand(m) < 0.35
            d[out] = rng.uniform(0, 640, (out.sum(), 2))
        if p == 2:
            s[: m // 3] = s[0]
            d[: m // 3] = d[0]
        src[p], dst[p] = s, d
        valid[p] = rng.rand(m) < 0.9 if p != 1 else True
    valid[4] = False
    valid[4, 7] = True
    valid[5] = False
    return src, dst, valid


def test_ransac_affine_partial_matches_jax():
    src, dst, valid = _similarity_sets()
    seeds = np.array([3, 7, 11, 13, 17, 19], np.uint32)
    got = ransac_affine_partial(torch.as_tensor(src), torch.as_tensor(dst),
                                torch.as_tensor(valid),
                                torch.as_tensor(seeds.astype(np.int64)))
    n_ok = 0
    for p in range(len(seeds)):
        ref = {k: np.asarray(v) for k, v in ransac_jax(
            jnp.asarray(src[p]), jnp.asarray(dst[p]), jnp.asarray(valid[p]),
            jnp.uint32(seeds[p])).items()}
        assert bool(got["ok"][p]) == bool(ref["ok"])
        np.testing.assert_array_equal(got["inliers"][p].numpy(),
                                      ref["inliers"])
        assert int(got["num_inliers"][p]) == int(ref["num_inliers"])
        if not ref["ok"]:
            continue
        n_ok += 1
        H = got["H"][p].numpy()
        assert np.abs(H - ref["H"]).max() <= 1e-4 * np.abs(ref["H"]).max()
    assert n_ok == 4


@pytest.fixture(scope="module")
def images():
    return affine_set(n=3)[0]


@pytest.fixture(scope="module")
def jax_affine(images):
    """One run of the JAX package's `AffineStitcher(crop=False)`: its
    estimated and adjusted cameras, panorama, features and matches."""
    st = stitching_tpu.AffineStitcher(crop=False)
    reg = jax_engine.register(st, images)
    estimated = JaxEstimator("affine").estimate(reg.features, reg.matches)
    cams = [c.copy() for c in reg.cameras]
    feats, matches = _features_and_matches(reg)
    pano = jax_engine.composite(st, reg, jax_engine.plan_composition(st, reg))
    return estimated, cams, pano, feats, matches, reg


def test_estimate_and_adjust_affine_match_jax(jax_affine):
    """Given the reference's features and matches: the spanning-tree chain
    of similarities and the affine bundle adjustment, each to 1e-4."""
    estimated, cams, _, feats, matches, reg = jax_affine
    est = CameraEstimator("affine").estimate(feats, matches)
    for c, r in zip(est, estimated):
        np.testing.assert_allclose(c.R, r.R, rtol=1e-4, atol=1e-4)
        assert (c.focal, c.ppx, c.ppy) == (1.0, 0.0, 0.0)
    # the reference's adjuster from the same start
    want = JaxAdjuster("affine").adjust(reg.features, reg.matches,
                                        [c.copy() for c in estimated])
    got = CameraAdjuster("affine", device="cpu").adjust(feats, matches, est)
    for c, r, final in zip(got, want, cams):
        np.testing.assert_allclose(c.R, r.R, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r.R, final.R)
    # the chain recovers the crops' offsets (a translation per image)
    offsets = affine_set(n=3)[1]
    for c, (x, y) in zip(got, offsets):
        np.testing.assert_allclose(c.R[:2, :2], np.eye(2), atol=2e-3)
        np.testing.assert_allclose(
            -c.R[:2, 2], np.subtract((x, y), offsets[1]), atol=1.0)


def _panorama(st, reg):
    return engine.composite(st, reg, engine.plan_composition(st, reg))


def test_affine_stitcher_with_jax_registration_within_one_lsb(images,
                                                              jax_affine):
    _, cams, ref, feats, matches, _ = jax_affine
    st = AffineStitcher(crop=False, device="cpu")
    own = engine.register(st, images)
    reg = engine._register_cameras(st, own.images, own.stack, feats,
                                   matches, uploader=own.uploader,
                                   low_stack=own.low_stack)
    for c, r in zip(reg.cameras, cams):
        np.testing.assert_allclose(c.R, r.R, rtol=1e-4, atol=1e-4)
    pano = _panorama(st, reg)
    assert pano.shape == ref.shape and pano.dtype == np.uint8
    diff = np.abs(pano.astype(np.int16) - ref.astype(np.int16))
    assert (diff <= 1).mean() >= 0.999
    # a pure translation set: the panorama is the union of the crops
    assert (pano.max(-1) > 0).mean() > 0.98


def test_affine_stitcher_stitch_matches_jax(images, jax_affine):
    """Whole, with the port's own registration: offsets within a pixel of
    the reference's, the panorama's shape within 1%, the same result
    twice."""
    cams, ref = jax_affine[1], jax_affine[2]
    st = AffineStitcher(crop=False, device="cpu")
    reg = engine.register(st, images)
    for c, r in zip(reg.cameras, cams):
        assert np.abs(c.R[:2, 2] - r.R[:2, 2]).max() <= 1.0
        np.testing.assert_allclose(c.R[:2, :2], r.R[:2, :2], atol=2e-3)
    pano = st.stitch(images)
    for a, b in zip(pano.shape[:2], ref.shape[:2]):
        assert abs(a - b) <= 0.01 * b
    assert np.array_equal(AffineStitcher(crop=False,
                                         device="cpu").stitch(images), pano)


def test_affine_default_override_warns():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        st = AffineStitcher(estimator="homography", device="cpu")
    assert any(issubclass(x.category, StitchingWarning) for x in w)
    assert st.settings["estimator"] == "homography"
    assert st.settings["warper_type"] == "affine"
    assert (AffineStitcher.DEFAULT_SETTINGS
            == stitching_tpu.AffineStitcher.DEFAULT_SETTINGS)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        AffineStitcher(warper_type="affine", device="cpu")


@pytest.fixture(scope="module")
def jax_affine_cropped(images):
    """The JAX package's `AffineStitcher()` with its default crop: its
    cameras, crop rects (LOW) and panorama."""
    st = stitching_tpu.AffineStitcher()
    reg = jax_engine.register(st, images)
    cams = [c.copy() for c in reg.cameras]
    plan = jax_engine.plan_composition(st, reg)
    rects = [tuple(int(v) for v in r) for r in plan.crop_rects]
    return cams, rects, jax_engine.composite(st, reg, plan)


def _rects(plan):
    return [tuple(int(v) for v in r) for r in plan.crop_rects]


def test_affine_stitcher_cropped_matches_jax(images, jax_affine_cropped):
    """`AffineStitcher()` with its default crop. With the reference's
    cameras: the crop rects equal, every value within 1 LSB. With the
    port's own registration (offsets 1e-4 px apart) the DP seams may flip
    on the shift: the rects equal and at least 99.9% of values within 1
    LSB."""
    cams, rects, ref = jax_affine_cropped
    st = AffineStitcher(device="cpu")
    reg = engine.register(st, images)
    own = engine.plan_composition(st, reg)
    assert _rects(own) == rects
    pano = engine.composite(st, reg, own)
    assert pano.shape == ref.shape and pano.dtype == np.uint8
    diff = np.abs(pano.astype(np.int16) - ref.astype(np.int16))
    assert (diff <= 1).mean() >= 0.999

    reg = engine.register(st, images)
    reg.cameras = convert.cameras_from_numpy(
        [c.focal for c in cams], [c.aspect for c in cams],
        [c.ppx for c in cams], [c.ppy for c in cams],
        [np.asarray(c.R) for c in cams])
    st.warper.set_scale(reg.cameras)
    reg.scale = st.warper.scale
    plan = engine.plan_composition(st, reg)
    assert _rects(plan) == rects
    pano = engine.composite(st, reg, plan)
    assert pano.shape == ref.shape
    diff = np.abs(pano.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1
