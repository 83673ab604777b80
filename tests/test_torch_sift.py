"""The port's SIFT detector against `stitching_tpu.ops.sift`.

The same images go through the JAX package's batched detection
(`pipeline.detect_stack(variant="sift")`, its detector vmapped over the
stack) and through the port's (`ops/sift.detect_sift` over the stack's
batch axis). Stated tolerances:

- the octaves: the base equals the reference's; each octave above it is
  the previous one resized, and the triangle-weight resize differs from
  XLA's compiled `jax.image.resize` in the last bit of some pixels, a gap
  that compounds per octave (at most 2 ulps of 1.0 here);
- the Gaussian stack (blurs of 9 to 19 taps, summed in the order of
  XLA's compiled convolution) and its DoG planes equal the reference's;
- keypoints: xy, size, angle, valid equal; responses equal in the base
  octave and within 2e-7 above it (|DoG| at the extrema, 0.0067 or more);
- descriptors: within 1e-6 (the histograms' sums run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import rotation_set
from stitching_tpu import pipeline as jp
from stitching_tpu.ops.gaussian import gaussian_blur as jax_blur
from stitching_tpu_torch import pipeline as tp
from stitching_tpu_torch.ops import sift
from stitching_tpu_torch.ops.color import bgr_to_gray
from stitching_tpu_torch.ops.gaussian import gaussian_blur
from stitching_tpu_torch.ops.orb import resize_linear_aa

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def images():
    return rotation_set(n=2, size=(320, 240))[0]


def _masks(images):
    """A feature mask per image: the left part only, wider for each."""
    out = []
    for i, im in enumerate(images):
        m = np.zeros(im.shape[:2], np.uint8)
        m[:, :160 + 60 * i] = 255
        out.append(m)
    return out


def _detect_both(variant, images, nfeatures, masks=None):
    """(reference, port) detections as dicts of numpy arrays."""
    ref = jp.detect_stack(jp.stack_images(images), nfeatures=nfeatures,
                          variant=variant, feature_masks=masks)
    got = tp.detect_stack(tp.stack_images(images, device="cpu"),
                          nfeatures=nfeatures, variant=variant,
                          feature_masks=masks)
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: v.numpy() for k, v in got.items()})


@pytest.fixture(scope="module")
def detections(images):
    return _detect_both("sift", images, 500)


def _gray01(images):
    stack = tp.stack_images(images, device="cpu")
    gray = bgr_to_gray(stack.data)
    return gray * float(np.float32(1 / 255))


def test_octaves_close_to_jax_resize_chain(images):
    gray = _gray01(images)
    shapes = sift._octave_shapes(*gray.shape[1:])
    assert len(shapes) == 4

    @jax.jit
    def chain(x):
        outs = [x]
        for oh, ow in shapes[1:]:
            x = jax.vmap(lambda y, s=(oh, ow): jax.image.resize(
                y, s, method="linear"))(x)
            outs.append(x)
        return outs

    ref = chain(jnp.asarray(gray.numpy()))
    base = gray
    for o, (oh, ow) in enumerate(shapes):
        if o:
            base = resize_linear_aa(base, oh, ow)
        diff = np.abs(base.numpy() - np.asarray(ref[o]))
        assert diff.max() <= (0.0 if o == 0 else 2.5e-7), (o, diff.max())


def test_gaussian_stack_equals_jax(images):
    x = _gray01(images)
    k = 2.0 ** (1.0 / sift.N_SCALES)
    prev, got, ref = 0.5, [], []
    jx = jnp.asarray(x.numpy())
    for s in range(sift.N_SCALES + 3):
        sigma = sift.SIGMA0 * k ** s
        add = float(np.sqrt(max(sigma ** 2 - prev ** 2, 0.01)))
        prev = sigma
        x = gaussian_blur(x, add)
        jx = jax_blur(jx, add)
        got.append(x.numpy())
        ref.append(np.asarray(jx))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_keypoints_match_jax(detections):
    ref, got = detections
    assert ref["valid"].sum() > 100
    for k in ("xy", "size", "valid", "angle_deg"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    base = ref["size"] < 7.0          # the base octave's sizes: 4.0 to 6.4
    assert base.sum() > 50
    np.testing.assert_array_equal(got["response"][base],
                                  ref["response"][base])
    np.testing.assert_allclose(got["response"], ref["response"], rtol=0,
                               atol=2e-7)


def test_descriptors_close_to_jax(detections):
    ref, got = detections
    assert got["desc"].shape == ref["desc"].shape == (2, 500, 128)
    np.testing.assert_allclose(got["desc"], ref["desc"], rtol=0, atol=1e-6)
    assert not got["desc"][~ref["valid"]].any()


def test_feature_masks_match_jax(images):
    masks = _masks(images)
    ref, got = _detect_both("sift", images, 300, masks)
    for k in ("xy", "valid", "size"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for i in range(len(images)):
        assert (got["xy"][i][got["valid"][i], 0] < 160 + 60 * i).all()


def test_octave_quotas():
    assert sift._octave_quotas(500, 4) == [250, 125, 62, 63]
    assert sift._octave_quotas(3, 4) == [1, 1, 1, 0]


@pytest.mark.parametrize("radius", [4, 5, 6, 7, 8, 9, 10, 11])
def test_long_blurs_equal_jax(radius):
    """9 to 23 taps: whole blocks of 8 taps by lanes (the second block by
    multiply-adds), then blocks of 4, 2 and 1, as XLA's convolution sums
    them."""
    rng = np.random.RandomState(radius)
    x = rng.rand(2, 40, 70).astype(np.float32)
    for sigma in (radius / 3.0, 1.0):
        got = gaussian_blur(torch.as_tensor(x), sigma, radius=radius)
        ref = jax_blur(jnp.asarray(x), sigma, radius=radius)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
