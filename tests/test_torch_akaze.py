"""The port's AKAZE detector against `stitching_tpu.ops.akaze`.

The FED cycles amplify any rounding difference level by level, so the
port follows the reference's rounding (`ops/akaze.py`) and the scale
space is held bit for bit. Stated tolerances:

- the tables (M-LDB cell pairs, FED step sizes) equal the reference's;
- the contrast factor and all six evolution levels equal the reference's;
- keypoints: xy, size, response and valid equal; angles within 1e-3
  degrees (the window sums run in another order and the arctangents
  differ in the last bit);
- descriptor bits (486 of 512): at most 0.1% differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stitching_tpu.ops import akaze as jax_akaze
from stitching_tpu_torch import pipeline as tp
from stitching_tpu_torch.ops import akaze
from stitching_tpu_torch.ops.color import bgr_to_gray
from test_torch_sift import _detect_both, _masks, images  # noqa: F401

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def detections(images):  # noqa: F811
    return _detect_both("akaze", images, 1024)


def test_pair_tables_equal_jax():
    assert akaze._TOTAL_BITS == jax_akaze._TOTAL_BITS == 486
    assert set(akaze._PAIR_TABLES) == set(jax_akaze._PAIR_TABLES)
    for g, table in jax_akaze._PAIR_TABLES.items():
        np.testing.assert_array_equal(akaze._PAIR_TABLES[g], table)


@pytest.mark.parametrize("t_span", [0.001, 1.28, 2.56, 10.24, 40.96, 300.0])
def test_fed_taus_equal_jax(t_span):
    np.testing.assert_array_equal(akaze._fed_taus(t_span),
                                  jax_akaze._fed_taus(t_span))


def test_scale_space_equals_jax(images):  # noqa: F811
    gray = bgr_to_gray(tp.stack_images(images, device="cpu").data)
    g = jnp.asarray(gray.numpy())
    k_ref = np.asarray(jax.jit(jax.vmap(jax_akaze._contrast_k))(g))
    np.testing.assert_array_equal(akaze._contrast_k(gray).numpy(), k_ref)
    ref = jax.jit(jax.vmap(
        lambda x: jax_akaze.build_nonlinear_scale_space(x)[0]))(g)
    got, sigmas = akaze.build_nonlinear_scale_space(gray)
    assert len(got) == len(ref) == 6
    for lvl, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"level {lvl}")
    np.testing.assert_allclose(sigmas, [1.6 * 2 ** ((i + 1) / 2)
                                        for i in range(6)])


def test_keypoints_match_jax(detections):
    ref, got = detections
    assert ref["valid"].sum() > 500
    for k in ("xy", "size", "valid", "response"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    diff = np.abs(got["angle_deg"] - ref["angle_deg"])[ref["valid"]]
    assert np.minimum(diff, 360 - diff).max() <= 1e-3


def test_descriptor_bits_match_jax(detections):
    ref, got = detections
    assert got["desc"].shape == ref["desc"].shape == (2, 1024, 512)
    assert (got["desc"] != ref["desc"]).mean() <= 1e-3
    assert not got["desc"][..., akaze._TOTAL_BITS:].any()
    assert not got["desc"][~ref["valid"]].any()


def test_feature_masks_match_jax(images):  # noqa: F811
    masks = _masks(images)
    ref, got = _detect_both("akaze", images, 512, masks)
    for k in ("xy", "valid", "size"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for i in range(len(images)):
        assert (got["xy"][i][got["valid"][i], 0] < 160 + 60 * i).all()
