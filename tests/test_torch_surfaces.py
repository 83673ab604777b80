"""The port's warp on every surface against `stitching_tpu.compose`.

Each of the 15 surfaces that `tests/test_torch_compose.py` (spherical)
does not cover warps the same LOW stack with the same cameras in both
packages: the rotation fixture's true cameras for the 14 rotation surfaces,
and for "affine" similarity cameras over `fixtures.affine_set`'s
translated crops (identity K, R the panorama-to-image similarity, as the
affine estimator leaves them). ROIs are exact, masks agree on at least
99.99% of pixels, and inside the mask no value is 1e-2 or more apart.
The share of values more than 2e-3 apart is held to the spherical bar
(1e-4) where the backward map is products and sums, which the port rounds
as the reference's compiled code does (affine, plane), or one
transcendental deep (cylindrical, mercator); surfaces that chain
tan/arctan/arctanh/arcsin or arctan2 of a radius hold a bar of 1e-3:
PyTorch's and XLA's transcendentals differ in the last bit, and a sample
moved by one ulp moves a value on a steep edge by ~4e-3 (ROADMAP queue 3,
measured per surface there).
"""

import numpy as np
import pytest
import torch

from fixtures import affine_set, rotation_set
from stitching_tpu import compose as jc
from stitching_tpu import pipeline as jp
from stitching_tpu_torch import compose as tc
from stitching_tpu_torch.ops.warp import WARP_TYPES

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)

SIZES = np.asarray([(256, 192), (250, 190), (256, 192)], np.int32)
S = 0.4


def _stack(imgs):
    stack = jp.resize_stack(jp.stack_images(imgs), SIZES)
    return np.asarray(stack.data), stack.sizes


def rotation_case():
    imgs, K, Rs = rotation_set(n=3, size=(640, 480))
    data, sizes = _stack(imgs)
    Ks = []
    for w, h in sizes:
        k = np.array(K, np.float32)
        k[:2] *= S
        k[0, 2], k[1, 2] = 0.5 * w, 0.5 * h
        Ks.append(k)
    return data, sizes, Ks, [np.asarray(R, np.float32) for R in Rs], 600 * S


def affine_case():
    """Panorama -> image similarities: each crop's offset, turned by a few
    hundredths of a radian; K is the identity scaled to LOW."""
    imgs, offsets = affine_set(n=3)
    data, sizes = _stack(imgs)
    Rs = []
    for i, (x, y) in enumerate(offsets):
        t = 0.02 * (i - 1)
        a, b = np.cos(t), np.sin(t)
        Rs.append(np.array([[a, -b, offsets[0][0] - x],
                            [b, a, offsets[0][1] - y],
                            [0, 0, 1]], np.float32))
    K = np.diag([S, S, 1.0]).astype(np.float32)
    return data, sizes, [K] * 3, Rs, S


OTHER_SURFACES = [w for w in WARP_TYPES if w != "spherical"]
# share of care values more than 2e-3 apart allowed per surface
TIGHT = ("affine", "plane", "cylindrical", "mercator")


def test_every_reference_surface_is_listed():
    from stitching_tpu.ops.warp import WARP_TYPES as jax_types

    assert WARP_TYPES == jax_types and len(OTHER_SURFACES) == 15


@pytest.fixture(scope="module")
def cases():
    return {"rotation": rotation_case(), "affine": affine_case()}


@pytest.mark.parametrize("surface", OTHER_SURFACES)
def test_warp_stack_matches_jax(cases, surface):
    data, sizes, Ks, Rs, scale = cases["affine" if surface == "affine"
                                       else "rotation"]
    ref = jc.warp_stack(data, sizes, Ks, Rs, scale, surface)
    got = tc.warp_stack(torch.tensor(data), sizes, Ks, Rs, scale, surface)
    np.testing.assert_array_equal(got.corners, ref.corners)
    np.testing.assert_array_equal(got.sizes, ref.sizes)
    masks = got.masks.numpy()
    ref_masks = np.asarray(ref.masks)
    assert (masks == ref_masks).mean() >= 0.9999
    care = (masks > 0) & (ref_masks > 0)
    assert care.sum() > 0.5 * (ref_masks > 0).sum()
    diff = np.abs(got.data.numpy()[care] - np.asarray(ref.data)[care])
    assert (diff > 2e-3).mean() <= (1e-4 if surface in TIGHT else 1e-3)
    assert diff.max() < 1e-2
    assert np.isfinite(got.data.numpy()).all()
