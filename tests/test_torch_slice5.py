"""This slice's `Stitcher` settings end to end against the JAX package:
the scalar exposure compensators (gain, channel) and the graph-cut seams
(gc_color), each with every other setting at its default. (gc_colorgrad's
seams and the other surfaces' warps are held equal on their own in
`test_torch_seam.py` and `test_torch_surfaces.py`.)

Both packages composite the rotation fixture with the reference's cameras
(one JAX registration serves every setting: they all act after it). The
crop rects and the panorama's shape are equal and at least 99.9% of values
are within 1 LSB.
"""

import copy

import jax
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

SETTINGS = [dict(compensator="gain"), dict(compensator="channel", nr_feeds=2),
            dict(finder="gc_color")]


@pytest.fixture(scope="module")
def images():
    imgs, _, _ = rotation_set(n=3, size=(640, 480))
    return imgs


@pytest.fixture(scope="module")
def jax_registration(images):
    """The JAX package's default registration of the fixture."""
    return jax_engine.register(stitching_tpu.Stitcher(), images)


@pytest.mark.parametrize("extra", SETTINGS,
                         ids=lambda e: "-".join(map(str, e.values())))
def test_panorama_with_jax_cameras_within_one_lsb(images, jax_registration,
                                                   extra):
    if "finder" in extra:
        # the reference's jitted graph cut fails on a second call once
        # another of its variants has compiled (ROADMAP queue 3)
        jax.clear_caches()
    st_ref = stitching_tpu.Stitcher(**extra)
    reg_ref = copy.copy(jax_registration)
    st_ref.warper.set_scale(reg_ref.cameras)
    plan_ref = jax_engine.plan_composition(st_ref, reg_ref)
    ref = jax_engine.composite(st_ref, reg_ref, plan_ref)
    cams = reg_ref.cameras

    st = Stitcher(device="cpu", **extra)
    reg = engine.register(st, images)
    reg.cameras = convert.cameras_from_numpy(
        [c.focal for c in cams], [c.aspect for c in cams],
        [c.ppx for c in cams], [c.ppy for c in cams],
        [np.asarray(c.R) for c in cams])
    st.warper.set_scale(reg.cameras)
    reg.scale = st.warper.scale
    plan = engine.plan_composition(st, reg)
    assert ([tuple(int(v) for v in r) for r in plan.crop_rects]
            == [tuple(int(v) for v in r) for r in plan_ref.crop_rects])
    pano = engine.composite(st, reg, plan)
    assert pano.shape == ref.shape and pano.dtype == np.uint8
    diff = np.abs(pano.astype(np.int16) - ref.astype(np.int16))
    assert (diff <= 1).mean() >= 0.999
    assert (pano.max(-1) > 0).mean() > 0.99
