"""The port's seam finders against `stitching_tpu.ops.seam`.

The DP seam scan, the batched DP seams (dp_color, dp_colorgrad), the
graph-cut seams (gc_color, gc_colorgrad) and the voronoi seams run in both
packages on the same inputs: seeded costs, the
JAX package's LOW tile stack of the rotation fixture (as the default
`Stitcher` plans it: warped, then cropped), and a seeded three-image stack
whose overlaps need both orientations and leave pixels that the pairwise
cuts strip of every owner (`ensure_coverage`). Seam masks are equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import stitching_tpu
from fixtures import rotation_set
from stitching_tpu import compose as jc
from stitching_tpu import engine as jax_engine
from stitching_tpu.images import Images
from stitching_tpu.ops import seam as js
from stitching_tpu.seam_finder import SeamFinder as JaxSeamFinder
from stitching_tpu_torch.ops import seam as ts
from stitching_tpu_torch.seam_finder import SeamFinder
from stitching_tpu_torch.compose import TileStack

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)


@pytest.mark.parametrize("kind", ["uniform", "integer_ties", "penalised"])
def test_dp_seam_kernel_equals_jax(kind):
    rng = np.random.RandomState(7)
    P, h, w = 3, 40, 24
    if kind == "uniform":
        cost = rng.rand(P, h, w).astype(np.float32) * 100
    elif kind == "integer_ties":
        # few distinct values: every step has tied moves and tied ends
        cost = rng.randint(0, 3, (P, h, w)).astype(np.float32)
        cost[1] = 0.0
    else:
        cost = rng.rand(P, h, w).astype(np.float32) * 50
        cost[:, :, 17:] += 1e4          # padded columns
        cost[:, 31:] = 0.0              # padded rows are free
    got = ts._dp_seam_kernel(torch.tensor(cost)).numpy()
    for p in range(P):
        want = np.asarray(js._dp_seam_kernel(jnp.asarray(cost[p]), h, w))
        np.testing.assert_array_equal(got[p], want)


@pytest.fixture(scope="module")
def low_stack():
    """The JAX package's LOW tile stack of the rotation fixture, as its
    default `Stitcher` hands it to the seam finder."""
    imgs, _, _ = rotation_set(n=3, size=(640, 480))
    st = stitching_tpu.Stitcher()
    reg = jax_engine.register(st, imgs)
    low = jax_engine.warp_resolution(st, reg, Images.Resolution.LOW)
    _, pano_mask = jc.blend_stack(low, None, "no", 0)
    st.cropper.prepare_from_mask(np.asarray(pano_mask),
                                 [tuple(c) for c in low.corners],
                                 [tuple(s) for s in low.sizes])
    return jax_engine._crop_tiles(low, st.cropper, 1)


# The JAX caches are cleared before each call of the reference's graph cut:
# in this JAX version a second call of its jitted `_gc_pairs_kernel`, once
# another variant of it has compiled in the process, fails with "Execution
# supplied 7 buffers but compiled program expected 9" (a fault of the
# reference, ROADMAP queue 3).


def _port_stack(stack):
    return TileStack(torch.tensor(np.asarray(stack.data)),
                     torch.tensor(np.asarray(stack.masks)),
                     np.asarray(stack.corners), np.asarray(stack.sizes))


@pytest.mark.parametrize("finder", ["dp_color", "dp_colorgrad", "gc_color",
                                    "gc_colorgrad", "voronoi"])
def test_seams_on_the_low_stack_equal_jax(low_stack, finder):
    jax.clear_caches()
    want = np.asarray(JaxSeamFinder(finder).find_stack(low_stack))
    got = SeamFinder(finder).find_stack(_port_stack(low_stack))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the seams cut the overlaps: less is kept than the warp masks cover
    masks = np.asarray(low_stack.masks)
    assert (want > 0).sum() < (masks > 0).sum()
    assert ((want > 0) <= (masks > 0)).all()


def _three_way(seed):
    """Three 72x60 tiles at (0, 0), (40, 8), (18, 30): one overlap taller
    than wide (a vertical seam), two wider than tall (transposed), and a
    region covered by all three."""
    rng = np.random.RandomState(seed)
    n, (w, h) = 3, (72, 60)
    data = np.zeros((n, 128, 128, 3), np.float32)
    masks = np.zeros((n, 128, 128), np.float32)
    for i in range(n):
        data[i, :h, :w] = rng.rand(h, w, 3) * 255
        masks[i, :h, :w] = 255
    masks[2, 50:, :10] = 0              # a ragged warp mask
    return (data, masks, np.asarray([(0, 0), (40, 8), (18, 30)]),
            np.asarray([(w, h)] * n))


def _cuts_without_coverage(data, masks, corners, sizes, use_grad):
    d, m = torch.tensor(data), torch.tensor(masks)
    pairs = ts.plan_overlaps(corners, sizes)
    out = m
    for transpose in (False, True):
        group = [p for p in pairs if (p[4][1] < p[4][0]) == transpose]
        bw = ts._round64(max(p[4][0] for p in group))
        bh = ts._round64(max(p[4][1] for p in group))
        ki, kj = ts._pair_seams_kernel(d, m, group, bh, bw, use_grad,
                                       transpose)
        out = ts._apply_keeps(out, group, ki, kj, bh, bw)
    return out


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("use_grad", [False, True])
def test_dp_seams_three_way_overlap_equal_jax(seed, use_grad):
    data, masks, corners, sizes = _three_way(seed)
    groups = {p[4][1] < p[4][0] for p in ts.plan_overlaps(corners, sizes)}
    assert groups == {False, True}
    want = np.asarray(js.dp_seams_stack(jnp.asarray(data),
                                        jnp.asarray(masks), corners, sizes,
                                        use_grad))
    got = ts.dp_seams_stack(torch.tensor(data), torch.tensor(masks), corners,
                            sizes, use_grad).numpy()
    np.testing.assert_array_equal(got, want)
    # the cyclic ownership left orphans, and `ensure_coverage` gave them
    # back: every canvas pixel of an original mask has an owner again
    cut = _cuts_without_coverage(data, masks, corners, sizes,
                                 use_grad).numpy()
    assert ((cut > 0) != (got > 0)).any()
    covered = np.zeros((168, 168), bool)
    owned = np.zeros((168, 168), bool)
    for i, (x, y) in enumerate(corners):
        covered[y:y + 128, x:x + 128] |= masks[i] > 0
        owned[y:y + 128, x:x + 128] |= got[i] > 0
    assert np.array_equal(covered, owned)


def test_ensure_coverage_equals_jax_and_passes_padded_slots():
    data, masks, corners, sizes = _three_way(1)
    cut = _cuts_without_coverage(data, masks, corners, sizes, False)
    # a padded fourth batch slot passes through untouched
    padded_masks = np.concatenate([masks, masks[:1]])
    padded_cut = torch.cat([cut, torch.tensor(masks[:1])])
    want = np.asarray(js.ensure_coverage(
        jnp.asarray(padded_masks), jnp.asarray(padded_cut.numpy()), corners,
        sizes))
    got = ts.ensure_coverage(torch.tensor(padded_masks), padded_cut, corners,
                             sizes).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[3], masks[0])


@pytest.mark.parametrize("seed", [0, 3])
def test_voronoi_three_way_overlap_equal_jax(seed):
    _, masks, corners, sizes = _three_way(seed)
    want = np.asarray(js.voronoi_seams_stack(jnp.asarray(masks), corners,
                                             sizes))
    got = ts.voronoi_seams_stack(torch.tensor(masks), corners, sizes)
    np.testing.assert_array_equal(got.numpy(), want)


def test_no_overlap_keeps_the_warp_masks():
    data, masks, _, sizes = _three_way(0)
    corners = np.asarray([(0, 0), (200, 0), (400, 0)])
    got = ts.dp_seams_stack(torch.tensor(data), torch.tensor(masks), corners,
                            sizes, False)
    np.testing.assert_array_equal(got.numpy(), masks)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("use_grad", [False, True])
def test_gc_seams_three_way_overlap_equal_jax(seed, use_grad):
    """All three pairs' cuts in one batch, applied in pair order, then
    `ensure_coverage`: equal to the JAX package's masks."""
    data, masks, corners, sizes = _three_way(seed)
    jax.clear_caches()
    want = np.asarray(js.gc_seams_stack(jnp.asarray(data),
                                        jnp.asarray(masks), corners, sizes,
                                        use_grad))
    got = ts.gc_seams_stack(torch.tensor(data), torch.tensor(masks), corners,
                            sizes, use_grad).numpy()
    np.testing.assert_array_equal(got, want)
    assert ((got > 0) != (masks > 0)).any()
