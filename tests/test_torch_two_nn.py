"""The port's `two_nn` and float 2-NN against the JAX package's kernels.

The plain PyTorch versions (the ones a CPU tensor runs) are held against
the Pallas kernels in interpret mode, as `tests/test_pallas.py` runs them.
`test_torch_cuda.py` holds the CUDA kernels against the plain versions on
the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from stitching_tpu.ops.pallas.two_nn import two_nn as two_nn_jax
from stitching_tpu.ops.pallas.two_nn import two_nn_pairs as two_nn_pairs_jax
from stitching_tpu_torch.ops.kernels.two_nn import (two_nn, two_nn_pairs,
                                                    two_nn_pairs_plain,
                                                    two_nn_plain)
from test_torch_cuda import (_descriptors, _float_descriptors,
                             _rect_descriptors, assert_two_nn_close)


def _pallas_two_nn(a, b, vb, is_binary):
    with pltpu.force_tpu_interpret_mode():
        return [np.asarray(x) for x in two_nn_jax(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(vb),
            is_binary=is_binary)]


def _plain_two_nn(a, b, vb, is_binary):
    return [x.numpy() for x in two_nn_plain(
        torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(vb),
        is_binary=is_binary)]


@pytest.mark.parametrize("nt", [237, 256, 1])
def test_two_nn_plain_binary_equals_pallas(nt):
    """Exact, i0 included; nt = 256 has no padded column (d1 may pass
    1e30), the others have one."""
    a, b, vb = _rect_descriptors(True, nt=nt)
    ref = _pallas_two_nn(a, b, vb, True)
    got = _plain_two_nn(a, b, vb, True)
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype and r.shape == g.shape
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("nt", [237, 256])
def test_two_nn_plain_float_close_to_pallas(nt):
    """Squared L2: d0, d1 within 1e-3 relative + 1e-3 absolute (the
    products are summed in another order), i0 equal wherever the two
    nearest are further apart than that."""
    a, b, vb = _rect_descriptors(False, nt=nt)
    ref = _pallas_two_nn(a, b, vb, False)
    got = _plain_two_nn(a, b, vb, False)
    assert got[2].dtype == np.int32
    assert_two_nn_close(got, ref, a, b)


def test_two_nn_plain_all_targets_invalid():
    a, b, vb = _rect_descriptors(True, nq=64, nt=64)
    vb[:] = False
    ref = _pallas_two_nn(a, b, vb, True)
    got = _plain_two_nn(a, b, vb, True)
    assert (got[0] >= 1e29).all()
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("case", ["random", "all_invalid", "ties"])
def test_two_nn_plain_equals_two_nn_pairs_forward(case):
    """With 61 rows both paddings (to 8 and to 128) leave a padded column,
    so `two_nn` of a pair equals `two_nn_pairs`' forward direction."""
    desc, valid, pairs = [torch.as_tensor(a) for a in _descriptors(case)]
    batched = two_nn_pairs_plain(desc, valid, pairs)
    for p, (i, j) in enumerate(pairs.tolist()):
        one = two_nn_plain(desc[i], desc[j], valid[j])
        for a, b in zip(one, batched):
            assert torch.equal(a, b[p, 0])


@pytest.mark.parametrize("case", ["random", "all_invalid", "ties"])
def test_two_nn_pairs_plain_float_close_to_pallas(case):
    desc, valid, pairs = _float_descriptors(case)
    with pltpu.force_tpu_interpret_mode():
        ref = [np.asarray(x) for x in two_nn_pairs_jax(
            jnp.asarray(desc), jnp.asarray(valid), jnp.asarray(pairs),
            is_binary=False)]
    got = [x.numpy() for x in two_nn_pairs_plain(
        torch.as_tensor(desc), torch.as_tensor(valid),
        torch.as_tensor(pairs), is_binary=False)]
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype and r.shape == g.shape
    assert_two_nn_close(got, ref, desc[pairs], desc[pairs[:, ::-1]])


@pytest.mark.parametrize("is_binary", [True, False])
def test_two_nn_cpu_tensor_runs_plain_version(is_binary):
    args = [torch.as_tensor(x) for x in _rect_descriptors(is_binary)]
    before = two_nn.launches
    out = two_nn(*args, is_binary=is_binary)
    assert two_nn.launches == before
    for a, b in zip(out, two_nn_plain(*args, is_binary=is_binary)):
        assert torch.equal(a, b)


def test_two_nn_pairs_float_cpu_tensor_runs_plain_version():
    args = [torch.as_tensor(x) for x in _float_descriptors("random")]
    before = two_nn_pairs.launches
    out = two_nn_pairs(*args, is_binary=False)
    assert two_nn_pairs.launches == before
    for a, b in zip(out, two_nn_pairs_plain(*args, is_binary=False)):
        assert torch.equal(a, b)
