"""Compositing stages of the port against `stitching_tpu.compose`.

The warp, the seam-mask resize and the paste blend each run in the JAX
package and in the port on the same stack and the same cameras.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fixtures import rotation_set
from stitching_tpu import compose as jc
from stitching_tpu import pipeline as jp
from stitching_tpu_torch import compose as tc
from stitching_tpu_torch import pipeline as tp

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def low_case():
    """The rotation set at LOW size with its true cameras, warped by the
    JAX package."""
    imgs, K, Rs = rotation_set(n=3, size=(640, 480))
    s = 0.4
    sizes = np.asarray([(256, 192), (250, 190), (256, 192)], np.int32)
    stack = jp.resize_stack(jp.stack_images(imgs), sizes)
    Ks = []
    for w, h in sizes:
        k = np.array(K, np.float32)
        k[:2] *= s
        k[0, 2], k[1, 2] = 0.5 * w, 0.5 * h
        Ks.append(k)
    Rs = [np.asarray(R, np.float32) for R in Rs]
    scale = 600.0 * s
    ref = jc.warp_stack(stack.data, stack.sizes, Ks, Rs, scale, "spherical")
    return np.asarray(stack.data), stack.sizes, Ks, Rs, scale, ref


def test_warp_stack_matches_jax(low_case):
    data, sizes, Ks, Rs, scale, ref = low_case
    got = tc.warp_stack(torch.tensor(data), sizes, Ks, Rs, scale,
                        "spherical")
    np.testing.assert_array_equal(got.corners, ref.corners)
    np.testing.assert_array_equal(got.sizes, ref.sizes)
    masks = got.masks.numpy()
    np.testing.assert_array_equal(masks, np.asarray(ref.masks))
    # Inside the mask every pixel is a `care` pixel of the sampler. The
    # backward map's sin/cos differ from XLA's in the last bit for some
    # pixels, which moves a sample by ~1e-5 px: on the steepest edges that
    # exceeds 2e-3 for a few values (ROADMAP queue 3).
    care = masks > 0
    diff = np.abs(got.data.numpy()[care] - np.asarray(ref.data)[care])
    assert (diff > 2e-3).mean() <= 1e-4
    assert diff.max() <= 1e-2


def test_resize_seam_masks_matches_jax(low_case):
    data, sizes, Ks, Rs, scale, ref = low_case
    fin = jc.warp_stack(jnp.asarray(data), sizes, Ks, Rs, scale * 1.5,
                        "spherical")
    lo = (ref.masks, np.asarray(ref.sizes))
    want = np.asarray(jc.resize_seam_masks_stack(lo, fin))
    tfin = tc.TileStack(torch.tensor(np.asarray(fin.data)),
                        torch.tensor(np.asarray(fin.masks)),
                        fin.corners, fin.sizes)
    got = tc.resize_seam_masks_stack(
        (torch.tensor(np.asarray(ref.masks)), np.asarray(ref.sizes)),
        tfin).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_array_equal(got > 0, want > 0)


def test_blend_no_matches_jax(low_case):
    _, _, _, _, _, ref = low_case
    pano, mask = [np.asarray(v) for v in jc.blend_stack(
        ref, ref.masks, "no", 5)]
    stack = tc.TileStack(torch.tensor(np.asarray(ref.data)),
                         torch.tensor(np.asarray(ref.masks)),
                         ref.corners, ref.sizes)
    got_pano, got_mask = tc.blend_stack(stack, None, "no", 5)
    np.testing.assert_array_equal(tc.fetch_image(got_pano), pano)
    np.testing.assert_array_equal(got_mask.numpy(), mask)


def test_stack_roundtrip_cpu_only(low_case):
    """The port's stacks stay on the device they were made on."""
    data, sizes, _, _, _, _ = low_case
    st = tp.stack_images([np.asarray(d[:h, :w]) for d, (w, h)
                          in zip(data, sizes)], device="cpu")
    assert st.data.device.type == "cpu" and st.data.dtype == torch.float32
