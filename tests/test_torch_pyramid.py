"""The port's pyramids and L1 distance transform against the JAX package.

`stitching_tpu_torch.ops.pyramid` and `ops.blend.distance_transform_l1`
run beside `stitching_tpu.ops.pyramid` and `stitching_tpu.ops.blend` on
the same seeded inputs. Pyramid values (0...255 inputs) agree within 1e-4:
the sums are in the reference's order, but XLA's CPU code may contract a
multiply and an add into one FMA (ROADMAP queue 3). The distance transform
is integer arithmetic in the port and saturates where the reference's
float32 scan does, so it is equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stitching_tpu.ops import blend as jblend
from stitching_tpu.ops import pyramid as jpyr
from stitching_tpu_torch.ops import blend as tblend
from stitching_tpu_torch.ops import pyramid as tpyr

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)

SHAPES = [(2, 64, 96, 3), (1, 128, 64, 1)]


def _images(shape, seed=0):
    return (np.random.RandomState(seed).rand(*shape) * 255).astype(
        np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_pyr_down_and_up_match_jax(shape):
    x = _images(shape)
    for k in range(shape[0]):
        _close(tpyr.pyr_down(torch.tensor(x[k])),
               jpyr.pyr_down(jnp.asarray(x[k])))
        # odd target sizes crop the upsampled image
        for oh, ow in ((2 * shape[1], 2 * shape[2]),
                       (2 * shape[1] - 1, 2 * shape[2] - 3)):
            _close(tpyr.pyr_up(torch.tensor(x[k]), oh, ow),
                   jpyr.pyr_up(jnp.asarray(x[k]), oh, ow))
    # a leading batch axis gives each image's own pyramid
    down = tpyr.pyr_down(torch.tensor(x))
    for k in range(shape[0]):
        _close(down[k], jpyr.pyr_down(jnp.asarray(x[k])))


@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_pyramids_and_collapse_match_jax(shape, nb):
    x = _images(shape, seed=nb)
    laps_t = tpyr.build_laplacian(torch.tensor(x), nb)
    gauss_t = tpyr.build_gaussian(torch.tensor(x), nb)
    assert len(laps_t) == len(gauss_t) == nb + 1
    for k in range(shape[0]):
        laps_j = jpyr.build_laplacian(jnp.asarray(x[k]), nb)
        gauss_j = jpyr.build_gaussian(jnp.asarray(x[k]), nb)
        for a, b in zip(laps_t, laps_j):
            _close(a[k], b)
        for a, b in zip(gauss_t, gauss_j):
            _close(a[k], b)
        _close(tpyr.collapse_laplacian([lp[k] for lp in laps_t]),
               jpyr.collapse_laplacian(laps_j))
    # the collapse inverts the decomposition
    np.testing.assert_allclose(tpyr.collapse_laplacian(laps_t).numpy(), x,
                               atol=1e-3)


def _masks():
    rng = np.random.RandomState(3)
    yield "sparse_zeros", rng.rand(50, 70) > 0.03
    yield "half", rng.rand(64, 64) > 0.5
    blob = np.zeros((40, 90), bool)
    blob[5:33, 10:80] = True
    yield "blob", blob
    yield "all_ones", np.ones((30, 40), bool)
    yield "all_zeros", np.zeros((30, 40), bool)
    yield "one_zero", np.pad(np.ones((20, 20), bool), ((0, 1), (0, 0)))


@pytest.mark.parametrize("name,mask", list(_masks()),
                         ids=[n for n, _ in _masks()])
def test_distance_transform_l1_equals_jax(name, mask):
    m = mask.astype(np.uint8)
    want = np.asarray(jblend.distance_transform_l1(jnp.asarray(m)))
    got = tblend.distance_transform_l1(torch.tensor(m))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "all_ones":
        assert (want == 1e9).all()
    if name == "all_zeros":
        assert (want == 0).all()


def test_distance_transform_l1_batched_and_bool():
    """A leading axis transforms each mask alone; bool masks work."""
    masks = np.stack([m for _, m in list(_masks())[:1]] * 2)
    masks[1, 10:20, 10:20] = False
    got = tblend.distance_transform_l1(torch.tensor(masks))
    for k in range(2):
        want = jblend.distance_transform_l1(
            jnp.asarray(masks[k].astype(np.uint8)))
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))
