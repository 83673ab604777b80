"""The port's kernel modules against the JAX package's Pallas kernels.

`two_nn_pairs` and the bilinear sampler each have a plain PyTorch version
(the one a CPU tensor runs) and a CUDA kernel. Here the plain versions are
held against the Pallas kernels in interpret mode and against the XLA
fallbacks. `test_torch_cuda.py` holds the CUDA kernels against their plain
versions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from stitching_tpu.ops.match import _two_nn_xla
from stitching_tpu.ops.match import ratio_union as ratio_union_jax
from stitching_tpu.ops.pallas.block_warp import block_sample, block_sample_dma
from stitching_tpu.ops.pallas.two_nn import two_nn_pairs as two_nn_pairs_jax
from stitching_tpu_torch.ops.kernels.bilinear_sample import (
    bilinear_sample, bilinear_sample_plain)
from stitching_tpu_torch.ops.kernels.two_nn import (two_nn_pairs,
                                                    two_nn_pairs_plain)
from stitching_tpu_torch.ops.match import ratio_union
from test_torch_cuda import (_care_isolation_inputs, _descriptors,
                             _sampler_inputs)


@pytest.mark.parametrize("case", ["random", "all_invalid", "ties"])
def test_two_nn_pairs_plain_equals_pallas(case):
    desc, valid, pairs = _descriptors(case)
    with pltpu.force_tpu_interpret_mode():
        ref = [np.asarray(x) for x in two_nn_pairs_jax(
            jnp.asarray(desc), jnp.asarray(valid), jnp.asarray(pairs),
            is_binary=True)]
    got = [x.numpy() for x in two_nn_pairs_plain(
        torch.as_tensor(desc), torch.as_tensor(valid),
        torch.as_tensor(pairs))]
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype and r.shape == g.shape
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("case", ["random", "all_invalid", "ties"])
def test_two_nn_pairs_plain_equals_xla_at_ratio_union(case):
    """The XLA fallback masks queries and uses another sentinel (3e38);
    at valid query rows with a valid target the 2-NN agrees exactly, and
    `ratio_union` gives the same matches either way."""
    desc, valid, pairs = _descriptors(case)
    d0, d1, i0 = [x.numpy() for x in two_nn_pairs_plain(
        torch.as_tensor(desc), torch.as_tensor(valid),
        torch.as_tensor(pairs))]
    for p, (i, j) in enumerate(pairs):
        nn = []
        for q, t, direction in ((i, j, 0), (j, i, 1)):
            xd0, xd1, xi0 = [np.asarray(v) for v in _two_nn_xla(
                jnp.asarray(desc[q]), jnp.asarray(valid[q]),
                jnp.asarray(desc[t]), jnp.asarray(valid[t]), True)]
            rows = valid[q] & (xd0 < 1e29)
            np.testing.assert_array_equal(d0[p, direction][rows], xd0[rows])
            np.testing.assert_array_equal(i0[p, direction][rows], xi0[rows])
            nn += [xd0, xd1, xi0]
        ref_pairs, ref_valid = [np.asarray(v) for v in ratio_union_jax(
            *[jnp.asarray(v) for v in nn], jnp.asarray(valid[i]),
            jnp.asarray(valid[j]), jnp.float32(0.3))]
        got_pairs, got_valid = ratio_union(
            *[torch.as_tensor(v[None]) for v in (
                d0[p, 0], d1[p, 0], i0[p, 0], d0[p, 1], d1[p, 1], i0[p, 1],
                valid[i], valid[j])], 0.3)
        got_pairs, got_valid = got_pairs[0].numpy(), got_valid[0].numpy()
        np.testing.assert_array_equal(got_valid, ref_valid)
        np.testing.assert_array_equal(got_pairs[got_valid],
                                      ref_pairs[ref_valid])


def test_two_nn_pairs_cpu_tensor_runs_plain_version():
    desc, valid, pairs = _descriptors("random")
    before = two_nn_pairs.launches
    out = two_nn_pairs(torch.as_tensor(desc), torch.as_tensor(valid),
                       torch.as_tensor(pairs))
    ref = two_nn_pairs_plain(torch.as_tensor(desc), torch.as_tensor(valid),
                             torch.as_tensor(pairs))
    assert two_nn_pairs.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("inputs", ["warp_like", "care_isolation"])
@pytest.mark.parametrize("tpu_kernel", ["block_sample_dma", "block_sample"])
def test_bilinear_plain_matches_block_samplers(inputs, tpu_kernel):
    img, sx, sy, care = (_sampler_inputs() if inputs == "warp_like"
                         else _care_isolation_inputs())
    kernel = {"block_sample_dma": block_sample_dma,
              "block_sample": block_sample}[tpu_kernel]
    ref = np.asarray(kernel(jnp.asarray(img), jnp.asarray(sx),
                            jnp.asarray(sy), jnp.asarray(care),
                            interpret=True))
    got = bilinear_sample_plain(torch.as_tensor(img), torch.as_tensor(sx),
                                torch.as_tensor(sy),
                                torch.as_tensor(care)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got[care], ref[care], atol=2e-3)


def test_bilinear_cpu_tensor_runs_plain_version():
    img, sx, sy, care = _sampler_inputs()
    args = [torch.as_tensor(a) for a in (img, sx, sy, care)]
    before = bilinear_sample.launches
    assert torch.equal(bilinear_sample(*args), bilinear_sample_plain(*args))
    assert bilinear_sample.launches == before
