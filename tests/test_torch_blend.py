"""The port's multiband and feather blends against `stitching_tpu.compose`.

`blend_stack` runs in both packages on the JAX package's FINAL tile stack
of the rotation fixture (warped, cropped and gain-compensated as its
default `Stitcher` does) with its resized dp_color seam masks. The
panoramas have equal shapes and coverage masks, every value within 1 LSB
and at least 99.9% equal: the sums are in the reference's order, but
XLA's CPU code may contract a multiply and an add into one FMA, which can
move a value across a rounding boundary (ROADMAP queue 3 has the counts).
"""

import numpy as np
import pytest
import torch

import stitching_tpu
from fixtures import rotation_set
from stitching_tpu import compose as jc
from stitching_tpu import engine as jax_engine
from stitching_tpu.images import Images
from stitching_tpu_torch import compose as tc

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def final_case():
    """The JAX package's FINAL stack and resized seam masks."""
    imgs, _, _ = rotation_set(n=3, size=(640, 480))
    st = stitching_tpu.Stitcher()
    reg = jax_engine.register(st, imgs)
    assert reg.uploader is None          # the batched blend, not streamed
    plan = jax_engine.plan_composition(st, reg)
    fin = jax_engine.warp_resolution(st, reg, Images.Resolution.FINAL)
    fin = jax_engine._crop_tiles(fin, st.cropper, plan.lir_aspect)
    fin = jc.apply_gains_stack(fin, st.compensator)
    seams = jc.resize_seam_masks_stack(plan.seam_masks_low, fin)
    port = tc.TileStack(torch.tensor(np.asarray(fin.data)),
                        torch.tensor(np.asarray(fin.masks)),
                        np.asarray(fin.corners), np.asarray(fin.sizes))
    return fin, seams, port, torch.tensor(np.asarray(seams))


@pytest.mark.parametrize("kind,strength,nb", [
    ("multiband", 5, 4),     # the default blend: 4 bands
    ("multiband", 0.2, 0),   # blend width in [1, 2): int() gives 0 bands
    ("feather", 5, None),
])
def test_blend_stack_matches_jax(final_case, kind, strength, nb):
    fin, seams, port, port_seams = final_case
    geometry = (np.asarray(fin.corners), np.asarray(fin.sizes),
                fin.data.shape[0], kind, strength, int(fin.data.shape[1]),
                int(fin.data.shape[2]))
    p = tc._plan_blend(*geometry)
    assert p["kind"] == kind
    if nb is not None:
        assert p["nb"] == nb
    want = jc._plan_blend(*geometry)
    for key, value in p.items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)
    ref, ref_mask = [np.asarray(v) for v in jc.blend_stack(
        fin, seams, kind, strength)]
    pano, mask = [v.numpy() for v in tc.blend_stack(port, port_seams, kind,
                                                    strength)]
    assert pano.shape == ref.shape and pano.dtype == np.uint8
    np.testing.assert_array_equal(mask, ref_mask)
    diff = np.abs(pano.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999

