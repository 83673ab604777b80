"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip without one. The machine with
the card has no JAX, so this file imports none and runs without the
suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The input builders here are shared with `test_torch_kernels.py`, which
holds the plain versions against the JAX package's Pallas kernels.
"""

import numpy as np
import pytest
import torch

from stitching_tpu_torch.ops.kernels.bilinear_sample import (
    bilinear_sample, bilinear_sample_plain)
from stitching_tpu_torch.ops.kernels.two_nn import (two_nn_pairs,
                                                    two_nn_pairs_plain)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _descriptors(case, seed=0):
    """(desc (B, N, 256) {0,1} f32, valid (B, N), pairs (P, 2) int32)."""
    rng = np.random.RandomState(seed)
    B, N = 4, 61
    desc = (rng.rand(B, N, 256) > 0.5).astype(np.float32)
    valid = rng.rand(B, N) > 0.1
    if case == "all_invalid":
        valid[2] = False
    if case == "ties":
        # duplicate target rows: equal distances at several columns
        desc[1, 10:20] = desc[1, 0:10]
        desc[3, 30:40] = desc[3, 0:10]
        desc[0, 5:8] = desc[1, 3]
    pairs = np.asarray([(i, j) for i in range(B) for j in range(i + 1, B)],
                       np.int32)
    return desc, valid, pairs


def _sampler_inputs(B=2, H=160, W=256, C=3, th=64, tw=256, seed=0):
    """A smooth backward map like the warp's, some pixels outside `care`."""
    rng = np.random.RandomState(seed)
    img = (rng.rand(B, H, W, C) * 255).astype(np.float32)
    yy, xx = np.mgrid[0:th, 0:tw].astype(np.float32)
    sx = np.stack([0.9 * xx + 0.05 * yy + 10 + 5 * b for b in range(B)])
    sy = np.stack([0.12 * xx + 0.95 * yy + 8 + 3 * b for b in range(B)])
    care = (sx <= W - 1) & (sy <= H - 1)
    sx = np.clip(sx, 0, W - 1).astype(np.float32)
    sy = np.clip(sy, 0, H - 1).astype(np.float32)
    return img, sx, sy, care


def _care_isolation_inputs():
    """`test_block_sample_care_mask_isolates_windows`' geometry: one block
    of care pixels and one !care pixel clamped to the origin."""
    rng = np.random.RandomState(1)
    img = (rng.rand(1, 160, 256, 3) * 255).astype(np.float32)
    sx = np.full((1, 8, 32), 100.0, np.float32)
    sy = np.full((1, 8, 32), 50.0, np.float32)
    care = np.ones((1, 8, 32), bool)
    sx[0, 0, 0] = 0.0
    sy[0, 0, 0] = 0.0
    care[0, 0, 0] = False
    return img, sx, sy, care


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "all_invalid", "ties"])
def test_two_nn_pairs_cuda_equals_plain(cuda_device, case):
    desc, valid, pairs = _descriptors(case)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (desc, valid, pairs)]
    before = two_nn_pairs.launches
    got = two_nn_pairs(*args)
    torch.cuda.synchronize()
    assert two_nn_pairs.launches == before + 1
    for g, r in zip(got, two_nn_pairs_plain(*args)):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["warp_like", "care_isolation"])
def test_bilinear_cuda_equals_plain(cuda_device, inputs):
    img, sx, sy, care = (_sampler_inputs() if inputs == "warp_like"
                         else _care_isolation_inputs())
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (img, sx, sy, care)]
    before = bilinear_sample.launches
    got = bilinear_sample(*args)
    torch.cuda.synchronize()
    assert bilinear_sample.launches == before + 1
    ref = bilinear_sample_plain(*args)
    assert torch.equal(got, ref)
