"""RANSAC of the port against `stitching_tpu.ops.ransac`.

The hypotheses are the top-4 of `jax.random.uniform(PRNGKey(seed),
(n_iters, M))`, 512 draws unless the caller asks for another count, so
the port reproduces that draw bit for bit without JAX.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stitching_tpu.ops.ransac import ransac_homography as ransac_jax
from stitching_tpu_torch.ops.ransac import ransac_homography, threefry_uniform

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)


@pytest.mark.parametrize("seed", [0, 1, 57, 12345, 2**32 - 1])
def test_threefry_uniform_equals_jax_random(seed):
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (512, 300)))
    got = threefry_uniform([seed], (512, 300))[0].numpy()
    np.testing.assert_array_equal(got, ref)


def test_threefry_uniform_128_draws_equals_jax_random():
    """The pair path's draw (`__graft_entry__.entry` asks for 128), several
    seeds in one batched call."""
    seeds = [0, 1, 57, 12345, 2**32 - 1]
    got = threefry_uniform(seeds, (128, 257)).numpy()
    for k, seed in enumerate(seeds):
        ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed),
                                            (128, 257)))
        np.testing.assert_array_equal(got[k], ref)


def _point_sets(n_pairs=4, m=120, seed=0):
    """Matched points under a known homography, with noise, outliers and
    invalid rows; coordinates centred as the matcher centres them."""
    rng = np.random.RandomState(seed)
    src = np.zeros((n_pairs, m, 2), np.float32)
    dst = np.zeros((n_pairs, m, 2), np.float32)
    valid = np.zeros((n_pairs, m), bool)
    for p in range(n_pairs):
        H = np.array([[1.0 + 0.05 * p, 0.02, 40.0 * p - 60],
                      [-0.03, 0.97, 12.0],
                      [1e-4 * p, -5e-5, 1.0]])
        s = rng.uniform(-300, 300, (m, 2))
        d = np.c_[s, np.ones(m)] @ H.T
        d = d[:, :2] / d[:, 2:]
        d += rng.normal(0, 0.4, d.shape)
        out = rng.rand(m) < 0.3
        d[out] = rng.uniform(-300, 300, (out.sum(), 2))
        src[p], dst[p] = s, d
        valid[p] = rng.rand(m) < 0.9
    valid[-1, 3:] = False          # too few points: no model
    return src, dst, valid


def test_ransac_homography_matches_jax():
    src, dst, valid = _point_sets()
    seeds = np.array([3, 7, 11, 13], np.uint32)
    got = ransac_homography(torch.as_tensor(src), torch.as_tensor(dst),
                            torch.as_tensor(valid),
                            torch.as_tensor(seeds.astype(np.int64)))
    for p in range(len(seeds)):
        ref = {k: np.asarray(v) for k, v in ransac_jax(
            jnp.asarray(src[p]), jnp.asarray(dst[p]), jnp.asarray(valid[p]),
            jnp.uint32(seeds[p])).items()}
        assert bool(got["ok"][p]) == bool(ref["ok"])
        if not ref["ok"]:
            continue
        np.testing.assert_array_equal(got["inliers"][p].numpy(),
                                      ref["inliers"])
        assert int(got["num_inliers"][p]) == int(ref["num_inliers"])
        H = got["H"][p].numpy()
        assert np.abs(H - ref["H"]).max() <= 1e-4 * np.abs(ref["H"]).max()


def test_ransac_128_draws_matches_jax():
    """`n_iters=128` (the pair path's count) against the JAX function at
    the same count: ok, inliers and counts equal, H within 1e-4 of its
    largest entry."""
    src, dst, valid = _point_sets()
    seeds = np.arange(3, 3 + 2 * len(src), 2).astype(np.uint32)
    got = ransac_homography(torch.as_tensor(src), torch.as_tensor(dst),
                            torch.as_tensor(valid),
                            torch.as_tensor(seeds.astype(np.int64)),
                            n_iters=128)
    n_ok = 0
    for p in range(len(seeds)):
        ref = {k: np.asarray(v) for k, v in ransac_jax(
            jnp.asarray(src[p]), jnp.asarray(dst[p]), jnp.asarray(valid[p]),
            jnp.uint32(seeds[p]), n_iters=128).items()}
        assert bool(got["ok"][p]) == bool(ref["ok"])
        np.testing.assert_array_equal(got["inliers"][p].numpy(),
                                      ref["inliers"])
        assert int(got["num_inliers"][p]) == int(ref["num_inliers"])
        if not ref["ok"]:
            continue
        n_ok += 1
        H = got["H"][p].numpy()
        assert np.abs(H - ref["H"]).max() <= 1e-4 * np.abs(ref["H"]).max()
    assert n_ok >= 3
