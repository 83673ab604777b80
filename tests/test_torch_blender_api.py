"""The Blender's step-by-step API against the JAX package's.

The three backends (no, feather, multiband) fed the same three random
overlapping tiles, with masks that leave holes and one tile at the
canvas's left and bottom edges, and `create_panorama`. The backends keep
the reference's tile geometry (the feather blend's 256 bucket, the
multiband window's gap, alignment and bucket). The paste and the feather
blend are equal value for value (the feather accumulate follows the
reference's compiled fused multiply-adds, `ops/blend.py`); the multiband
panorama has every value within 1 LSB and at least 99.99% equal (its
pyramids agree to 4.6e-5, ROADMAP queue 3; measured: at most 2 of 335,400
values 1 apart). Every mask is equal.
"""

import numpy as np
import pytest
import torch

from stitching_tpu import blender as jax_blender
from stitching_tpu_torch import blender

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)

# the third tile spans the canvas's left edge and its bottom
CORNERS = [(40, 0), (190, 25), (-20, 60)]
SIZES = [(200, 180), (220, 170), (150, 200)]


def tiles(seed=0, gray=False):
    rng = np.random.RandomState(seed)
    imgs, masks = [], []
    for w, h in SIZES:
        base = rng.randint(0, 255, (h // 8 + 1, w // 8 + 1, 3))
        img = np.kron(base, np.ones((8, 8, 1)))[:h, :w]
        img = np.clip(img + rng.randint(0, 40, (h, w, 3)), 0, 255)
        mask = np.full((h, w), 255, np.uint8)
        mask[:rng.randint(1, 9)] = 0
        mask[:, -rng.randint(1, 9):] = 0
        y, x = rng.randint(20, h - 40), rng.randint(20, w - 40)
        mask[y:y + 15, x:x + 25] = 0        # a hole
        img = img.astype(np.uint8)
        imgs.append(img[..., 1] if gray else img)
        masks.append(mask)
    return imgs, masks


def run(module, kind, strength, imgs, masks, **kw):
    b = module.Blender(kind, strength, **kw)
    b.prepare(CORNERS, SIZES)
    for img, mask, corner in zip(imgs, masks, CORNERS):
        b.feed(img, mask, corner)
    pano, mask = b.blend()
    return type(b.blender).__name__, np.asarray(pano), np.asarray(mask)


@pytest.mark.parametrize("kind,strength", [
    ("no", 5), ("feather", 5), ("feather", 20), ("multiband", 5),
    ("multiband", 30), ("multiband", 0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_backend_equals_jax(kind, strength, seed):
    imgs, masks = tiles(seed)
    want = run(jax_blender, kind, strength, imgs, masks)
    got = run(blender, kind, strength, imgs, masks, device="cpu")
    assert got[0] == want[0]        # the same backend resolved
    assert got[1].shape == want[1].shape and got[1].dtype == np.uint8
    held(kind, got[1], want[1])
    assert np.array_equal(got[2], want[2])


def held(kind, got, want):
    if kind != "multiband":
        assert np.array_equal(got, want)
        return
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.9999


@pytest.mark.parametrize("kind", ["feather", "multiband"])
def test_gray_tiles_equal_jax(kind):
    imgs, masks = tiles(2, gray=True)
    want = run(jax_blender, kind, 5, imgs, masks)
    got = run(blender, kind, 5, imgs, masks, device="cpu")
    held(kind, got[1], want[1])
    assert np.array_equal(got[2], want[2])


def test_create_panorama_equals_jax():
    imgs, masks = tiles(3)
    want = jax_blender.Blender.create_panorama(imgs, masks, CORNERS, SIZES)
    got = blender.Blender.create_panorama(imgs, masks, CORNERS, SIZES,
                                          device="cpu")
    for a, b in zip(got, want):
        assert np.array_equal(a, np.asarray(b))


def test_resolve_backend_parameters():
    for width in (0.5, 3, 40, 5000):
        a = jax_blender.resolve_backend("multiband", width)
        b = blender.resolve_backend("multiband", width, device="cpu")
        assert type(a).__name__ == type(b).__name__
        if hasattr(a, "num_bands"):
            assert a.num_bands == b.num_bands
    a = jax_blender.resolve_backend("feather", 40)
    b = blender.resolve_backend("feather", 40, device="cpu")
    assert a.sharpness == b.sharpness
