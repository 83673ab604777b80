"""The per-pair matcher and the pair-registration path against the JAX
package: `ops/match.py::match_pair` and `pipeline.register_pair`, the
counterpart of `__graft_entry__.entry`'s detect -> match -> RANSAC step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import __graft_entry__ as graft
import stitching_tpu.ops.match as match_jax
from stitching_tpu_torch import pipeline
from stitching_tpu_torch.ops.match import match_pair

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)


def _binary_sets():
    """The inputs of the reference's backend-consistency test: targets are
    shuffled copies of the queries with 2% of bits flipped, plus noise
    rows."""
    rng = np.random.RandomState(3)
    a = (rng.rand(150, 256) > 0.5).astype(np.float32)
    b = np.concatenate([a[::-1],
                        (rng.rand(50, 256) > 0.5).astype(np.float32)])
    flip = rng.rand(*b.shape) < 0.02
    b = np.abs(b - flip.astype(np.float32))
    va = np.ones(150, bool)
    vb = np.ones(200, bool)
    va[-7:] = False
    vb[:4] = False
    return a, va, b, vb


def _float_sets():
    rng = np.random.RandomState(4)
    a = np.abs(rng.randn(150, 128)).astype(np.float32)
    b = np.concatenate([a[::-1] + 0.05 * rng.randn(150, 128),
                        np.abs(rng.randn(50, 128))]).astype(np.float32)
    va = np.ones(150, bool)
    vb = np.ones(200, bool)
    va[-7:] = False
    vb[:4] = False
    return a, va, b, vb


def _port(sets, conf, is_binary):
    out = match_pair(*[torch.as_tensor(x) for x in sets], conf,
                     is_binary=is_binary)
    assert out["pairs"].dtype == torch.int32
    return out["pairs"].numpy(), out["valid"].numpy()


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("is_binary,conf", [(True, 0.3), (False, 0.65)])
def test_match_pair_equals_jax(monkeypatch, backend, is_binary, conf):
    """`valid` equal and `pairs` equal where valid, against the reference
    with its Pallas kernel (interpret mode) and with its XLA fallback."""
    sets = _binary_sets() if is_binary else _float_sets()
    args = [jnp.asarray(x) for x in sets]
    if backend == "pallas":
        monkeypatch.setattr(match_jax, "use_pallas", lambda: True)
        with pltpu.force_tpu_interpret_mode():
            ref = match_jax.match_pair.__wrapped__(*args, conf,
                                                   is_binary=is_binary)
    else:
        ref = match_jax.match_pair(*args, conf, is_binary=is_binary)
    pairs, valid = _port(sets, conf, is_binary)
    ref_valid = np.asarray(ref["valid"])
    assert valid.sum() >= 100
    np.testing.assert_array_equal(valid, ref_valid)
    np.testing.assert_array_equal(pairs[valid],
                                  np.asarray(ref["pairs"])[ref_valid])


def test_match_pair_all_targets_invalid_matches_nothing():
    a, va, b, vb = _binary_sets()
    vb[:] = False
    _, valid = _port((a, va, b, vb), 0.3, True)
    assert not valid.any()


@pytest.fixture(scope="module")
def graft_entry():
    """`__graft_entry__.entry`'s crops and its result (128 draws)."""
    fn, (a, b) = graft.entry()
    H_ref, n_ref = [np.asarray(x) for x in jax.jit(fn)(a, b)]
    return np.asarray(a), np.asarray(b), H_ref, int(n_ref)


@pytest.mark.parametrize("n_iters", [128, 512])
def test_register_pair_matches_graft_entry(graft_entry, n_iters):
    """The pair path on the entry's two crops (an 80 px horizontal shift).
    At the entry's 128 draws the inlier count equals the entry's and H is
    within 2e-4 elementwise (1.1e-4 measured: ORB's descriptors differ in
    a few rows, ROADMAP's stated gaps). At the library default of 512
    draws the counts agree to 10%. Both homographies recover the shift to
    a pixel."""
    a, b, H_ref, n_ref = graft_entry
    H, n = pipeline.register_pair(a, b, nfeatures=256, n_iters=n_iters,
                                  device="cpu")
    H, n = H.numpy(), int(n)
    assert H.shape == (3, 3) and H.dtype == np.float32
    if n_iters == 128:
        assert n == n_ref
        np.testing.assert_allclose(H, H_ref, rtol=0, atol=2e-4)
    assert n >= 20 and abs(n - n_ref) <= max(3, 0.1 * n_ref)
    for h in (H, H_ref):
        assert abs(h[0, 2] + 80.0) < 1.0 and abs(h[1, 2]) < 1.0
        np.testing.assert_allclose(h[:2, :2], np.eye(2), atol=0.01)
        np.testing.assert_allclose(h[2], [0, 0, 1], atol=1e-4)
