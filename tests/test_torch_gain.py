"""The scalar exposure compensators (gain, channel) of the port against
the JAX package: the overlap statistics of every pair, the solved gains
over `nr_feeds` rounds, and the gains applied to a tile stack.

The statistics are float32 sums over each overlap taken in another order,
so the gains are held to 1e-4 relative; the applied tiles to 1 LSB with
at least 99.9% of values equal (`round(t * g)` flips a few).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stitching_tpu import compose as compose_jax
from stitching_tpu.exposure_error_compensator import (
    ExposureErrorCompensator as JaxCompensator)
from stitching_tpu.ops import exposure as exposure_jax
from stitching_tpu.ops import seam as seam_jax
from stitching_tpu_torch import compose
from stitching_tpu_torch.exposure_error_compensator import (
    ExposureErrorCompensator)
from stitching_tpu_torch.ops import exposure
from test_torch_exposure import FINAL, LOW, _tiles

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)


@pytest.mark.parametrize("per_channel", [False, True])
def test_pair_stats_match_jax(per_channel):
    data, masks, corners, sizes = _tiles(**LOW)
    pairs = seam_jax.plan_overlaps(corners, sizes)
    gains = np.asarray([[1.0, 1.0, 1.0], [1.3, 0.9, 1.1], [0.7, 1.2, 1.0]],
                       np.float32)
    want = exposure_jax._pair_stats_kernel(
        jnp.asarray(data), jnp.asarray(masks), jnp.asarray(gains),
        *(jnp.asarray([p[k] for p in pairs], jnp.int32) for k in range(5)),
        bh=64 * -(-max(p[4][1] for p in pairs) // 64),
        bw=64 * -(-max(p[4][0] for p in pairs) // 64),
        per_channel=per_channel)
    got = exposure._pair_stats(
        torch.as_tensor(data), torch.as_tensor(masks),
        torch.as_tensor(gains), pairs,
        64 * -(-max(p[4][1] for p in pairs) // 64),
        64 * -(-max(p[4][0] for p in pairs) // 64), per_channel)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert (got[0].numpy() > 0).sum() >= 2
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


@pytest.fixture(scope="module", params=[("gain", 1), ("channel", 1),
                                        ("gain", 2), ("channel", 3)])
def fed(request):
    """Both packages' compensators fed with the same LOW stack."""
    kind, nr_feeds = request.param
    data, masks, corners, sizes = _tiles(**LOW)
    cl = [tuple(int(v) for v in c) for c in corners]
    ref = JaxCompensator(kind, nr_feeds=nr_feeds)
    ref.feed_stack(cl, compose_jax.TileStack(
        jnp.asarray(data), jnp.asarray(masks), corners, sizes))
    got = ExposureErrorCompensator(kind, nr_feeds=nr_feeds)
    got.feed_stack(cl, compose.TileStack(
        torch.as_tensor(data), torch.as_tensor(masks), corners, sizes))
    return ref, got


def test_gains_match_jax(fed):
    ref, got = fed
    want = np.asarray(ref._gains)
    assert got._gains.shape == want.shape
    assert want.shape[1] == (3 if got.compensator == "channel" else 1)
    np.testing.assert_allclose(got._gains, want, rtol=1e-4)
    # the exposures differ by 15% per image, so the gains are not all ones
    assert np.abs(want - 1).max() > 0.02


@pytest.mark.parametrize("resolution", ["low", "final"])
def test_apply_gains_stack_matches_jax(fed, resolution):
    ref, got = fed
    data, masks, corners, sizes = _tiles(**(LOW if resolution == "low"
                                            else FINAL), seed=1)
    want = np.asarray(compose_jax.apply_gains_stack(compose_jax.TileStack(
        jnp.asarray(data), jnp.asarray(masks), corners, sizes), ref).data)
    out = compose.apply_gains_stack(compose.TileStack(
        torch.as_tensor(data), torch.as_tensor(masks), corners, sizes), got)
    have = out.data.numpy()
    assert have.shape == want.shape
    diff = np.abs(have - want)
    assert diff.max() <= 1.0
    assert (diff == 0).mean() >= 0.999
    assert np.abs(have - data).max() > 5     # gains were applied
    np.testing.assert_array_equal(have, np.round(have))


def test_plan_gain_arrays_match_jax(fed):
    ref, got = fed
    mode, want = compose_jax.plan_gain_arrays(ref, FINAL["sizes"], 4, 3)
    have_mode, have = compose.plan_gain_arrays(got, FINAL["sizes"], 4, 3)
    assert mode == have_mode == "scalar"
    assert have.shape == want.shape == (4, 3) and have.dtype == want.dtype
    np.testing.assert_allclose(have, want, rtol=1e-4)
    np.testing.assert_array_equal(have[3], 1.0)


def test_solve_gains_equals_jax():
    rng = np.random.RandomState(0)
    stats = [(i, j, float(rng.randint(50, 900)), rng.uniform(40, 200, 3),
              rng.uniform(40, 200, 3)) for i, j in ((0, 1), (1, 2), (0, 3))]
    np.testing.assert_array_equal(exposure.solve_gains(5, stats, 3),
                                  exposure_jax.solve_gains(5, stats, 3))
