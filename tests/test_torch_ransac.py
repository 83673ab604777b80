"""RANSAC of the port against `stitching_tpu.ops.ransac`.

The hypotheses are the top-4 of `jax.random.uniform(PRNGKey(seed),
(n_iters, M))`, 512 draws unless the caller asks for another count, so
the port reproduces that draw bit for bit without JAX.

One departure (`test_torch_parity.BEHAVIOUR`): the port drops a minimal
sample that folds (`ransac._orientation_kept`, as `cv::findHomography`
checks its samples), which the JAX package keeps. With that check
switched off the port is the JAX function; the witness is a pair of a
grid capture whose folded hypothesis won the vote with matches hundreds
of pixels off the truth.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stitching_tpu.ops.ransac import ransac_homography as ransac_jax
from stitching_tpu_torch.ops import ransac
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


def keep_folded_samples(monkeypatch):
    """The port with the JAX package's sample test: no orientation check."""
    monkeypatch.setattr(ransac, "_orientation_kept",
                        lambda s4, d4: torch.ones(s4.shape[:2], dtype=bool))


def test_ransac_128_draws_matches_jax(monkeypatch):
    """`n_iters=128` (the pair path's count) against the JAX function at
    the same count: ok, inliers and counts equal, H within 1e-4 of its
    largest entry. A folded sample wins one of these pairs in the JAX
    package, so the port's orientation check is off here
    (`test_folded_sample_loses_the_vote` holds it)."""
    keep_folded_samples(monkeypatch)
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


# Pair (2, 7) of `benchmark/traffic/rot8-2mp.json`'s set 0 of seed
# 9600000035 at a shrink of 0.3 (views of 480 x 360, MEDIUM 268 x 201), the
# matcher's seed 2 * 8 + 7: its valid matches in their order, (x, y) in
# view 2 and (u, v) in view 7, MEDIUM pixels. The views overlap in a strip
# some 8 px wide along x = 242-250; the truth maps view 2 into view 7 by
# `STRIP_TRUTH` (K R_7^T R_2 K^-1).
STRIP = [
    (215.0, 165.0, 130.8, 181.2), (149.0, 177.0, 105.0, 94.0),
    (248.0, 187.0, 34.0, 185.0), (183.0, 69.0, 207.0, 25.0),
    (248.0, 113.0, 33.0, 113.0), (243.0, 114.0, 29.0, 114.0),
    (248.0, 94.0, 33.0, 94.0), (242.0, 94.0, 28.0, 94.0),
    (109.0, 109.0, 123.0, 79.0), (103.0, 113.0, 218.0, 111.0),
    (164.0, 151.0, 123.0, 79.0), (166.8, 177.6, 28.0, 94.0),
    (135.6, 144.0, 179.0, 55.0), (148.8, 144.0, 76.032, 89.856),
    (247.2, 94.8, 32.4, 94.8), (91.2, 124.8, 218.0, 111.0),
    (108.0, 109.2, 123.0, 79.0), (249.6, 157.2, 34.56, 156.96),
    (247.2, 112.8, 32.4, 112.8), (184.32, 76.32, 75.6, 93.6),
    (247.68, 185.76, 34.0, 185.0), (244.8, 95.04, 30.24, 95.04),
    (184.32, 69.12, 75.6, 87.6), (244.8, 112.32, 30.0, 112.8),
    (135.36, 144.0, 178.8, 55.2), (249.12, 158.4, 34.56, 156.96),
    (247.68, 60.48, 33.12, 60.48), (150.336, 179.712, 179.0, 55.0),
    (247.104, 184.896, 33.12, 184.32), (243.648, 112.32, 30.24, 112.32),
    (134.784, 145.152, 177.12, 54.72), (247.104, 58.752, 33.12, 60.48),
    (184.5504, 72.576, 76.032, 89.856), (105.7536, 124.416, 218.4, 110.4),
    (244.6848, 95.3856, 30.24, 95.04), (242.6112, 109.9008, 30.24, 112.32),
    (103.2, 111.6, 198.72, 100.8), (91.2384, 43.5456, 126.72, 66.24),
    (183.168, 70.848, 74.88, 87.84)]
STRIP_SIZE = (268, 201)
STRIP_SEED = 2 * 8 + 7
STRIP_CAPACITY = 1000          # the matcher's rows: 2 x 500 features


def strip_pair():
    """The witness pair as the matcher hands it to RANSAC: coordinates
    centred on the view's centre, padded to the matcher's capacity.
    Returns (src, dst, valid, true error of each valid match in px)."""
    pts = np.asarray(STRIP, np.float32)
    c = np.asarray(STRIP_SIZE, np.float32) / 2
    src = np.zeros((1, STRIP_CAPACITY, 2), np.float32)
    dst = np.zeros_like(src)
    valid = np.zeros((1, STRIP_CAPACITY), bool)
    k = len(pts)
    src[0, :k], dst[0, :k], valid[0, :k] = pts[:, :2] - c, pts[:, 2:] - c, 1
    f = 1400.0 * 0.3 * np.sqrt(0.6 * 0.3 ** 2 * 1e6 / (480 * 360))
    K = np.array([[f, 0, c[0]], [0, f, c[1]], [0, 0, 1.0]])
    yaw = np.linspace(-0.6, 0.6, 8)

    def R(a):
        return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                         [-np.sin(a), 0, np.cos(a)]])

    T = K @ R(yaw[7]).T @ R(yaw[2]) @ np.linalg.inv(K)
    q = np.c_[pts[:, :2], np.ones(k)] @ T.T
    err = np.linalg.norm(q[:, :2] / q[:, 2:] - pts[:, 2:], axis=1)
    return src, dst, valid, err


def _strip_ransac(src, dst, valid):
    return ransac_homography(torch.as_tensor(src), torch.as_tensor(dst),
                             torch.as_tensor(valid),
                             torch.tensor([STRIP_SEED], dtype=torch.int64))


def test_folded_sample_loses_the_vote(monkeypatch):
    """With the JAX package's sample test the strip's vote goes to a
    folded hypothesis that takes in matches over 300 px off the truth,
    and its confidence passes the bundle's threshold of 1; the port
    draws the same hypotheses, drops the folded ones, and keeps the
    strip's matches alone, under the threshold, as `cv::findHomography`
    (18 inliers, 0.914) does."""
    src, dst, valid, err = strip_pair()
    k = int(valid.sum())
    got = _strip_ransac(src, dst, valid)
    inl = got["inliers"][0, :k].numpy()
    assert bool(got["ok"][0])
    assert err[inl].max() < 4 and inl.sum() == 17
    assert inl.sum() / (8 + 0.3 * k) < 1.0
    keep_folded_samples(monkeypatch)
    folded = _strip_ransac(src, dst, valid)["inliers"][0, :k].numpy()
    assert err[folded].max() > 300 and (err[folded] > 300).sum() == 2
    assert folded.sum() / (8 + 0.3 * k) > 1.0
    ref = ransac_jax(jnp.asarray(src[0]), jnp.asarray(dst[0]),
                     jnp.asarray(valid[0]), jnp.uint32(STRIP_SEED))
    np.testing.assert_array_equal(np.asarray(ref["inliers"])[:k], folded)


@pytest.mark.parametrize("flip", [None, 0, 1, 2, 3])
def test_orientation_check_takes_samples_that_turn_alike(flip):
    """A sample whose four triangles turn the same way in both views is
    kept, mirrored as a whole too; one with a point moved across the
    others, so that some triangles turn and some do not, is dropped."""
    s4 = torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    d4 = s4 * 2 + 0.5
    if flip is not None:
        d4 = d4.clone()
        d4[flip] = d4[(flip + 2) % 4] * 2 - d4[flip] * 0.5
    got = ransac._orientation_kept(s4[None, None], d4[None, None])[0, 0]
    mirrored = ransac._orientation_kept(
        s4[None, None], (d4 * torch.tensor([-1.0, 1.0]))[None, None])[0, 0]
    assert bool(got) == (flip is None)
    assert bool(mirrored) == (flip is None)
