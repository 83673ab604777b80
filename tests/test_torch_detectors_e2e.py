"""`Stitcher(detector=X)` end to end against the JAX package, for the
SIFT, BRISK and AKAZE detectors, every other setting at its default.

- With the reference's cameras handed over, the port's panorama has the
  reference's shape and every value within 1 LSB.
- With its own registration, the cameras' focals are within 0.5% of the
  reference's and the panorama's sides within 1%: the detectors' stated
  gaps (`test_torch_sift.py`, `test_torch_brisk.py`,
  `test_torch_akaze.py`) move a keypoint's angle or a descriptor bit and
  so, on a weak pair, RANSAC's inliers (ROADMAP queue 3).

SIFT runs on 640x480 views: on smaller ones the reference finds no pair
over the confidence threshold.
"""

import numpy as np
import pytest
import torch

import stitching_tpu
from fixtures import rotation_set
from stitching_tpu import engine as jax_engine
from stitching_tpu_torch import Stitcher, convert, engine

torch.set_num_threads(2)

SIZES = {"sift": (640, 480), "brisk": (480, 360), "akaze": (480, 360)}
_RUNS = {}


def _jax_run(detector):
    """The reference's stitch: its cameras and panorama (cached)."""
    if detector not in _RUNS:
        imgs = rotation_set(n=3, size=SIZES[detector])[0]
        st = stitching_tpu.Stitcher(detector=detector)
        reg = jax_engine.register(st, imgs)
        pano = jax_engine.composite(st, reg,
                                    jax_engine.plan_composition(st, reg))
        _RUNS[detector] = (imgs, [c.copy() for c in reg.cameras], pano)
    return _RUNS[detector]


@pytest.mark.parametrize("detector", list(SIZES))
def test_panorama_with_jax_cameras_within_one_lsb(detector):
    imgs, cams, ref = _jax_run(detector)
    st = Stitcher(detector=detector, device="cpu")
    reg = engine.register(st, imgs)
    assert len(reg.cameras) == len(cams)
    reg.cameras = convert.cameras_from_numpy(
        [c.focal for c in cams], [c.aspect for c in cams],
        [c.ppx for c in cams], [c.ppy for c in cams],
        [np.asarray(c.R) for c in cams])
    st.warper.set_scale(reg.cameras)
    reg.scale = st.warper.scale
    pano = engine.composite(st, reg, engine.plan_composition(st, reg))
    assert pano.shape == ref.shape and pano.dtype == np.uint8
    diff = np.abs(pano.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1


@pytest.mark.parametrize("detector", list(SIZES))
def test_stitch_with_own_registration_close_to_jax(detector):
    imgs, cams, ref = _jax_run(detector)
    st = Stitcher(detector=detector, device="cpu")
    reg = engine.register(st, imgs)
    assert len(reg.cameras) == len(cams)
    for c, r in zip(reg.cameras, cams):
        assert abs(c.focal - r.focal) <= 5e-3 * r.focal
    pano = engine.composite(st, reg, engine.plan_composition(st, reg))
    assert pano.dtype == np.uint8 and pano.shape[2] == 3
    for a, b in zip(pano.shape[:2], ref.shape[:2]):
        assert abs(a - b) <= 0.01 * b
