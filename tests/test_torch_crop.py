"""The crop path of the port against the JAX package: the largest interior
rectangle, the single-region check, the cropper's rect planning and
`compose.slice_stack`. Everything here is integer or a copy, so it is
held exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fixtures import rotation_set
from stitching_tpu import compose as compose_jax
from stitching_tpu import cropper as cropper_jax
from stitching_tpu.ops.lir import largest_interior_rectangle as lir_jax
from stitching_tpu_torch import SLICE, Stitcher, StitchingError, compose
from stitching_tpu_torch import cropper, engine
from stitching_tpu_torch.ops.lir import largest_interior_rectangle

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)


def _blob(seed):
    """A random mask: noise of some density, or a block with a notch."""
    rng = np.random.RandomState(seed)
    h, w = rng.randint(1, 70), rng.randint(1, 90)
    m = rng.rand(h, w) > rng.choice([0.02, 0.2, 0.5])
    if seed % 3 == 0:
        m[:] = False
        m[h // 4:h - h // 5, w // 5:w - w // 6] = True
        m[rng.randint(h), rng.randint(w)] = False
    return m


@pytest.mark.parametrize("seed", range(12))
def test_lir_equals_jax_on_random_masks(seed):
    m = _blob(seed)
    ref = np.asarray(lir_jax(jnp.asarray(m)))
    got = largest_interior_rectangle(torch.as_tensor(m))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_lir_ties_go_to_the_first_in_row_major_order():
    m = np.zeros((9, 12), bool)
    m[1:3, 1:4] = True      # 2 x 3
    m[1:4, 6:8] = True      # 3 x 2, same area, found first by its bar
    m[6:8, 2:5] = True
    ref = np.asarray(lir_jax(jnp.asarray(m)))
    got = largest_interior_rectangle(m).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[2] * got[3] == 6


@pytest.fixture(scope="module")
def low_panorama():
    """The LOW tile stack of the rotation fixture (the port's slice-1
    path) and its composited panorama mask."""
    imgs, _, _ = rotation_set(n=3, size=(640, 480))
    st = Stitcher(device="cpu", **SLICE)
    reg = engine.register(st, imgs)
    low = engine.warp_resolution(st, reg, engine.Resolution.LOW)
    _, mask = compose.blend_stack(low, None, "no", 0)
    return low, mask


def test_lir_equals_jax_on_a_low_panorama_mask(low_panorama):
    _, mask = low_panorama
    m = mask.numpy() > 0
    assert 0.5 < m.mean() < 1.0
    ref = np.asarray(lir_jax(jnp.asarray(m)))
    got = largest_interior_rectangle(mask > 0).numpy()
    np.testing.assert_array_equal(got, ref)
    x, y, w, h = got
    assert m[y:y + h, x:x + w].all() and w * h > 0.5 * m.sum()


def _region_masks():
    one = np.zeros((20, 30), np.uint8)
    one[3:15, 4:25] = 255
    two = one.copy()
    two[17:19, 1:3] = 255
    ring = one.copy()
    ring[6:9, 8:12] = 0
    touching = np.zeros((20, 30), np.uint8)
    touching[2:8, 2:8] = 255
    touching[8:12, 8:12] = 255      # corner contact only: two regions
    return dict(one=one, two=two, ring=ring, touching=touching,
                empty=np.zeros((5, 5), np.uint8))


@pytest.mark.parametrize("name", ["one", "two", "ring", "touching", "empty"])
def test_single_region_equals_jax(name):
    m = _region_masks()[name]
    ref = cropper_jax.single_region(m)
    got = cropper.single_region(m)
    assert (got is None) == (ref is None)
    if ref is not None:
        np.testing.assert_array_equal(got, ref)


def test_rect_algebra_equals_jax():
    R, Rj = cropper.Rectangle, cropper_jax.Rectangle
    r = R(5, 7, 25, 35)
    assert (r.area, r.corner, r.size, r.x2, r.y2) == (875, (5, 7),
                                                     (25, 35), 30, 42)
    # Python's round: halves go to the even integer
    for x in (0.5, 1.5, 2.5, 0.1, 3.7):
        assert tuple(r.times(x)) == tuple(Rj(*r).times(x))
    assert tuple(R(1, 1, 1, 1).times(2.5)) == (2, 2, 2, 2)
    assert tuple(R(1, 1, 3, 3).times(0.5)) == (0, 0, 2, 2)
    a, b = R(0, 0, 10, 10), R(5, 6, 10, 10)
    assert tuple(cropper.clip_rect(a, b)) == tuple(
        cropper_jax.clip_rect(Rj(*a), Rj(*b))) == (5, 6, 5, 4)
    assert tuple(cropper.to_local(R(5, 6, 5, 4), b)) == (0, 0, 5, 4)
    assert cropper.zero_center([(3, -2), (-4, 5)]) == [(7, 0), (0, 7)]
    with pytest.raises(StitchingError):
        cropper.clip_rect(a, R(20, 20, 5, 5))


@pytest.mark.parametrize("aspect", [1, 2.5, 7.416198])
def test_cropper_rects_equal_jax(low_panorama, aspect):
    low, mask = low_panorama
    corners = [tuple(int(v) for v in c) for c in low.corners]
    sizes = [tuple(int(v) for v in s) for s in low.sizes]
    ref = cropper_jax.Cropper(True)
    ref.prepare_from_mask(mask.numpy(), corners, sizes)
    got = cropper.Cropper(True)
    got.prepare_from_mask(mask, corners, sizes)
    assert tuple(got.lir) == tuple(ref.lir)
    for attr in ("overlapping_rectangles", "intersection_rectangles"):
        assert [tuple(r) for r in getattr(got, attr)] == [
            tuple(r) for r in getattr(ref, attr)]
    scaled = [(int(round(x * aspect)), int(round(y * aspect)))
              for x, y in corners]
    ssizes = [(int(round(w * aspect)), int(round(h * aspect)))
              for w, h in sizes]
    assert got.crop_rois(scaled, ssizes, aspect) == ref.crop_rois(
        scaled, ssizes, aspect)
    off = cropper.Cropper(False)
    assert off.crop_rois(corners, sizes) == (corners, sizes)


def test_cropper_rejects_two_regions():
    with pytest.raises(StitchingError, match="Invalid Contour"):
        cropper.Cropper(True).prepare_from_mask(
            _region_masks()["two"], [(0, 0)], [(30, 20)])


@pytest.mark.parametrize("case", ["inside", "past_the_edge"])
def test_slice_stack_equals_jax(case):
    """Exact copies; a rect whose 64-padded slice runs past the tile edge
    is padded, never clamped, so content stays at its rect origin."""
    rng = np.random.RandomState(0)
    data = rng.rand(3, 128, 192, 3).astype(np.float32) * 255
    masks = (rng.rand(3, 128, 192) > 0.3).astype(np.float32) * 255
    corners = np.asarray([(0, 0), (50, 3), (90, -4)])
    sizes = np.asarray([(180, 120), (192, 128), (170, 100)])
    rects = {"inside": [(0, 0, 60, 60), (3, 2, 64, 50), (10, 20, 30, 64)],
             "past_the_edge": [(100, 60, 92, 68), (0, 14, 100, 70),
                               (150, 90, 20, 10)]}[case]
    ref = compose_jax.slice_stack(
        compose_jax.TileStack(jnp.asarray(data), jnp.asarray(masks),
                              corners, sizes), rects)
    got = compose.slice_stack(
        compose.TileStack(torch.as_tensor(data), torch.as_tensor(masks),
                          corners, sizes), rects)
    np.testing.assert_array_equal(got.sizes, ref.sizes)
    np.testing.assert_array_equal(got.corners, ref.corners)
    assert tuple(got.data.shape) == tuple(ref.data.shape)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.masks.numpy(), np.asarray(ref.masks))
    for i, (x, y, w, h) in enumerate(rects):
        np.testing.assert_array_equal(got.data[i, :h, :w].numpy(),
                                      data[i, y:y + h, x:x + w])
