"""The port's grid min-cut and graph-cut seams against
`stitching_tpu.ops.graphcut`.

`grid_min_cut` on seeded grids (the JAX package's own oracle grids, whose
cut cost the Edmonds-Karp oracle of `tests/test_graphcut.py` bounds),
`seam_cut_pair` at one flat and one coarse-to-fine shape, and the port's
batched form (several pairs at once, each frozen when its own loop ends)
all give the JAX package's cut exactly, whatever the number of iterations
between the host's checks of the loop's end.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stitching_tpu.ops import graphcut as jg
from stitching_tpu_torch.ops import graphcut as tg
from test_graphcut import _cut_cost, _edmonds_karp_cut

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)


def _oracle_grid(seed, h=8, w=10):
    """`tests/test_graphcut.py`'s grid: random edge capacities, the left
    column tied to the source and the right one to the sink."""
    rng = np.random.RandomState(seed)
    cap_dir = rng.uniform(0.1, 2.0, (4, h, w)).astype(np.float32)
    cap_dir[0][:, -1] = 0
    cap_dir[1][:, 0] = 0
    cap_dir[2][-1, :] = 0
    cap_dir[3][0, :] = 0
    s_cap = np.zeros((h, w), np.float32)
    t_cap = np.zeros((h, w), np.float32)
    s_cap[:, 0] = 100.0
    t_cap[:, -1] = 100.0
    return cap_dir, s_cap, t_cap


def _port_cut(grids, **kw):
    cap, s, t = (torch.tensor(np.stack(g)) for g in zip(*grids))
    return tg.grid_min_cut(cap, s, t, **kw)


def _port_cut_every(grids, every, monkeypatch, **kw):
    """`_port_cut` with the host reading the loop's end every `every`
    iterations."""
    monkeypatch.setattr(tg, "CHECK_EVERY", every)
    return _port_cut(grids, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grid_min_cut_equals_jax_and_the_oracle_cost(seed):
    grid = _oracle_grid(seed)
    want = np.asarray(jg.grid_min_cut(*(jnp.asarray(a) for a in grid),
                                      max_iters=600,
                                      global_relabel_every=16))
    got, stats = _port_cut([grid], max_iters=600, global_relabel_every=16)
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert 0 < stats["iterations"] < 600
    ref_cost = _cut_cost(*grid, _edmonds_karp_cut(*grid))
    assert abs(_cut_cost(*grid, got[0].numpy()) - ref_cost) <= 1e-3


def _ragged_grids():
    """Grids whose loops end after different numbers of iterations: the
    three oracle grids, one with a second sink column, and one whose
    source and sink edges cancel (no loop iteration at all)."""
    grids = [_oracle_grid(s) for s in range(3)]
    cap, s, t = _oracle_grid(4)
    t[:, 5] = 3.0
    grids.append((cap, s, t))
    cap, s, t = _oracle_grid(5)
    grids.append((cap, s, s.copy()))
    return grids


@pytest.mark.parametrize("check_every", [1, 3, 8, 64])
def test_batched_cut_is_each_grids_own_cut(check_every, monkeypatch):
    """Five grids in one batch, whose loops run for different lengths:
    each cut equals the JAX package's cut of that grid alone, and the
    cuts do not depend on how often the host reads the loop's end."""
    grids = _ragged_grids()
    got, stats = _port_cut_every(grids, check_every, monkeypatch,
                                 max_iters=600, global_relabel_every=16)
    for k, grid in enumerate(grids):
        want = np.asarray(jg.grid_min_cut(
            *(jnp.asarray(a) for a in grid), max_iters=600,
            global_relabel_every=16))
        np.testing.assert_array_equal(got[k].numpy(), want)
    alone = [int(_port_cut_every([g], 1, monkeypatch, max_iters=600,
                                 global_relabel_every=16)[1]["iterations"])
             for g in grids]
    assert alone[4] == 0 and len(set(alone)) > 2
    assert stats["iterations"] == max(alone)


def test_max_iters_stops_the_loop_exactly(monkeypatch):
    """A loop cut short by `max_iters` stops at exactly that iteration
    whatever the check interval: the cut equals the JAX package's."""
    grid = _oracle_grid(1, 12, 16)
    want = np.asarray(jg.grid_min_cut(*(jnp.asarray(a) for a in grid),
                                      max_iters=13, global_relabel_every=5))
    for every in (1, 4, 8):
        got, stats = _port_cut_every([grid], every, monkeypatch,
                                     max_iters=13, global_relabel_every=5)
        np.testing.assert_array_equal(got[0].numpy(), want)
        assert stats["iterations"] == 13


def _overlap(seed, h, w):
    """Two overlap tiles with seeded content: image i owns a left strip,
    j a right one, a ragged contested middle and a few invalid pixels; a
    cheap corridor where the two agree."""
    rng = np.random.RandomState(seed)
    img_i = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    img_j = np.clip(img_i + rng.uniform(-90, 90, (h, w, 3)), 0,
                    255).astype(np.float32)
    mid = w // 2
    img_j[:, mid - 6:mid + 6] = img_i[:, mid - 6:mid + 6]
    only_i = np.zeros((h, w), bool)
    only_j = np.zeros((h, w), bool)
    only_i[:, :w // 8 + 1] = True
    only_j[:, -(w // 8):] = True
    only_i[:h // 3, :w // 4] = True
    invalid = rng.rand(h, w) < 0.01
    both = ~(only_i | only_j | invalid)
    return img_i, img_j, both, only_i & ~invalid, only_j & ~invalid


@pytest.mark.parametrize("shape", [(32, 64), (128, 192)])
@pytest.mark.parametrize("use_grad", [False, True])
def test_seam_cut_pair_equals_jax(shape, use_grad):
    """Flat (32 x 64) and coarse-to-fine (128 x 192: a 32 x 48 cut first,
    then the banded full-size cut), two pairs in one batch."""
    cases = [_overlap(s, *shape) for s in (0, 1)]
    got = tg.seam_cut_pair(*(torch.tensor(np.stack(a))
                             for a in zip(*cases)), use_grad).numpy()
    for k, case in enumerate(cases):
        want = np.asarray(jg.seam_cut_pair(*(jnp.asarray(a) for a in case),
                                           use_grad))
        np.testing.assert_array_equal(got[k], want)
        img_i, img_j, both, only_i, only_j = case
        assert got[k][only_i].all() and not got[k][only_j].any()
        assert 0.1 < got[k][both].mean() < 0.9


def test_coarse_levels_equal_jax():
    """The 4x4 block mean (edge padding, the reference's sum order) and
    block OR (False padding) at a shape that is no multiple of 4."""
    rng = np.random.RandomState(3)
    img = rng.uniform(0, 255, (2, 37, 50, 3)).astype(np.float32)
    mask = rng.rand(2, 37, 50) < 0.1
    got = tg._down4_mean(torch.tensor(img)).numpy()
    got_any = tg._down4_any(torch.tensor(mask)).numpy()
    for k in range(2):
        np.testing.assert_array_equal(
            got[k], np.asarray(jg._down4_mean(jnp.asarray(img[k]))))
        np.testing.assert_array_equal(
            got_any[k], np.asarray(jg._down4_any(jnp.asarray(mask[k]))))


@pytest.mark.parametrize("use_grad", [False, True])
def test_pair_caps_equal_jax(use_grad):
    img_i, img_j, both, only_i, only_j = _overlap(2, 24, 40)
    got = tg._pair_caps(*(torch.tensor(a[None]) for a in
                          (img_i, img_j, both, only_i, only_j)), use_grad)
    want = jg._pair_caps(*(jnp.asarray(a) for a in
                           (img_i, img_j, both, only_i, only_j)), use_grad)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


@pytest.mark.parametrize("h,w,cluster", [(16, 16, 1), (64, 64, 1),
                                         (80, 96, 1), (91, 91, 2),
                                         (128, 128, 2), (160, 200, 4),
                                         (256, 256, 8), (1024, 512, 8)])
def test_cut_kernel_cluster_follows_the_pixels(h, w, cluster):
    """The card's cut takes one CTA a pair for a coarse 64 x 64 level and
    up to eight, the portable limit, from 256 x 256 on."""
    from stitching_tpu_torch.ops.kernels.push_relabel import cluster_size

    assert cluster_size(h, w) == cluster


def test_cut_kernel_refuses_what_it_does_not_take():
    """The kernel's wrapper takes contiguous float32 grids on the card;
    the plain loop is `grid_min_cut`'s for the CPU."""
    from stitching_tpu_torch.ops.kernels.push_relabel import push_relabel

    grid = [torch.tensor(np.stack([a])) for a in _oracle_grid(0)]
    with pytest.raises(ValueError, match="CUDA device"):
        push_relabel(*grid, 100, 16)
    with pytest.raises(ValueError, match="float32"):
        push_relabel(grid[0].double(), *grid[1:], 100, 16)
    with pytest.raises(ValueError, match=r"\(P, 4, H, W\)"):
        push_relabel(grid[0][:, :3], *grid[1:], 100, 16)
    with pytest.raises(ValueError, match="contiguous"):
        push_relabel(grid[0], grid[1].transpose(1, 2).contiguous()
                     .transpose(1, 2), grid[2], 100, 16)
