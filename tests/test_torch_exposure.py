"""Block-gain exposure compensation of the port against the JAX package:
the masked block sums, the solved and smoothed gain maps, and the gains
applied to a tile stack.

The block sums are float32 reductions taken in another order, so they are
held to 1e-3 relative, the gain maps to 1e-4, and the applied tiles to 1
LSB with at least 99.9% of values equal (`round(t * gain)` flips a few).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stitching_tpu import compose as compose_jax
from stitching_tpu.exposure_error_compensator import (
    ExposureErrorCompensator as JaxCompensator)
from stitching_tpu.ops import exposure as exposure_jax
from stitching_tpu_torch import compose
from stitching_tpu_torch.exposure_error_compensator import (
    ExposureErrorCompensator)
from stitching_tpu_torch.ops import exposure

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)


def _tiles(th, tw, sizes, seed=0):
    """Overlapping tiles of one smooth scene seen at per-image exposures,
    with warp-like masks (a slanted invalid corner)."""
    rng = np.random.RandomState(seed)
    n = len(sizes)
    corners = np.asarray([(-37 + 70 * i, 5 - 9 * i) for i in range(n)])
    yy, xx = np.mgrid[0:th, 0:tw].astype(np.float32)
    data = np.zeros((n, th, tw, 3), np.float32)
    masks = np.zeros((n, th, tw), np.float32)
    for i, (w, h) in enumerate(sizes):
        gx, gy = xx + corners[i, 0], yy + corners[i, 1]
        scene = np.stack([120 + 60 * np.sin(gx / 23.0 + c) * np.cos(gy / 31.0)
                          for c in range(3)], -1)
        scene += rng.randn(th, tw, 3) * 2
        valid = (xx < w) & (yy < h) & (xx + 0.4 * yy > 12 * i)
        data[i] = np.clip(scene * (0.8 + 0.15 * i), 0, 255) * valid[..., None]
        masks[i] = valid * 255.0
    return data, masks, corners, np.asarray(sizes)


LOW = dict(th=128, tw=192, sizes=[(180, 120), (192, 128), (170, 100)])
FINAL = dict(th=320, tw=448, sizes=[(447, 298), (448, 318), (422, 248)])


@pytest.mark.parametrize("per_channel", [False, True])
def test_block_stats_match_jax(per_channel):
    data, masks, corners, _ = _tiles(**LOW)
    sub = np.asarray([(5, 0), (31, 17), (12, 30)], np.int32)
    kw = dict(scy=6, scx=8, bs=32, per_channel=per_channel)
    ref_s, ref_c = [np.asarray(v) for v in exposure_jax._block_stats_kernel(
        jnp.asarray(data), jnp.asarray(masks), jnp.asarray(sub), **kw)]
    got_s, got_c = [v.numpy() for v in exposure._block_stats_kernel(
        torch.as_tensor(data), torch.as_tensor(masks), sub, **kw)]
    assert got_s.shape == ref_s.shape == (3, 6, 8, 3 if per_channel else 1)
    np.testing.assert_array_equal(got_c, ref_c)
    np.testing.assert_allclose(got_s, ref_s, rtol=1e-3, atol=1e-2)


@pytest.fixture(scope="module", params=["gain_blocks", "channel_blocks"])
def fed(request):
    """Both packages' compensators fed with the same LOW stack."""
    data, masks, corners, sizes = _tiles(**LOW)
    cl = [tuple(int(v) for v in c) for c in corners]
    ref = JaxCompensator(request.param, block_size=32)
    ref.feed_stack(cl, compose_jax.TileStack(
        jnp.asarray(data), jnp.asarray(masks), corners, sizes))
    got = ExposureErrorCompensator(request.param, block_size=32)
    got.feed_stack(cl, compose.TileStack(
        torch.as_tensor(data), torch.as_tensor(masks), corners, sizes))
    return ref, got


def test_gain_maps_match_jax(fed):
    ref, got = fed
    assert got._block_state[:2] == ref._block_state[:2]
    assert got._feed_corners == ref._feed_corners
    assert got._feed_sizes == ref._feed_sizes
    channels = 3 if got.compensator == "channel_blocks" else 1
    for g, r in zip(got._block_state[2], ref._block_state[2]):
        assert g.shape == r.shape and g.shape[-1] == channels
        np.testing.assert_allclose(g, r, atol=1e-4)
    # the exposures differ by 15% per image, so the maps are not all ones
    assert max(np.abs(g - 1).max() for g in got._block_state[2]) > 0.02


@pytest.mark.parametrize("resolution", ["low", "final"])
def test_apply_gains_stack_matches_jax(fed, resolution):
    """At the feed resolution and at a larger apply resolution (the gain
    map is sampled by the size ratio)."""
    ref, got = fed
    data, masks, corners, sizes = _tiles(**(LOW if resolution == "low"
                                            else FINAL), seed=1)
    want = np.asarray(compose_jax.apply_gains_stack(compose_jax.TileStack(
        jnp.asarray(data), jnp.asarray(masks), corners, sizes), ref).data)
    out = compose.apply_gains_stack(compose.TileStack(
        torch.as_tensor(data), torch.as_tensor(masks), corners, sizes), got)
    have = out.data.numpy()
    assert have.shape == want.shape and out.masks.shape == masks.shape
    diff = np.abs(have - want)
    assert diff.max() <= 1.0
    assert (diff == 0).mean() >= 0.999
    assert np.abs(have - data).max() > 5     # gains were applied
    np.testing.assert_array_equal(have, np.round(have))


def test_compensator_no_leaves_the_stack(fed):
    data, masks, corners, sizes = _tiles(**LOW)
    stack = compose.TileStack(torch.as_tensor(data), torch.as_tensor(masks),
                              corners, sizes)
    comp = ExposureErrorCompensator("no")
    comp.feed_stack([tuple(c) for c in corners], stack)
    assert compose.apply_gains_stack(stack, comp) is stack


def test_plan_gain_arrays_match_jax(fed):
    ref, got = fed
    sizes = np.asarray(FINAL["sizes"])
    mode, want = compose_jax.plan_gain_arrays(ref, sizes, 4, 3)
    have_mode, have = compose.plan_gain_arrays(got, sizes, 4, 3)
    assert mode == have_mode == "map"
    for h, w in zip(have, want):
        assert h.shape == w.shape and h.dtype == w.dtype
        np.testing.assert_allclose(h, w, atol=1e-4)
