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
from stitching_tpu_torch.ops.kernels.two_nn import (two_nn, two_nn_pairs,
                                                    two_nn_pairs_plain,
                                                    two_nn_plain)


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


def _float_descriptors(case, seed=0):
    """(desc (B, N, 128) f32, valid (B, N), pairs (P, 2) int32): SIFT-like
    rows; image b + 1 holds noisy copies of image b's rows, so true
    matches exist."""
    rng = np.random.RandomState(seed)
    B, N = 4, 61
    desc = np.abs(rng.randn(B, N, 128)).astype(np.float32)
    for b in range(1, B):
        desc[b, :40] = desc[b - 1, rng.permutation(N)[:40]] \
            + 0.05 * rng.randn(40, 128).astype(np.float32)
    desc *= 512.0 / np.linalg.norm(desc, axis=-1, keepdims=True)
    valid = rng.rand(B, N) > 0.1
    if case == "all_invalid":
        valid[2] = False
    if case == "ties":
        desc[1, 10:20] = desc[1, 0:10]
        desc[3, 30:40] = desc[3, 0:10]
    pairs = np.asarray([(i, j) for i in range(B) for j in range(i + 1, B)],
                       np.int32)
    return desc.astype(np.float32), valid, pairs


def _rect_descriptors(is_binary, nq=200, nt=237, seed=1, d=128):
    """One query set against one target set of another length, as the
    reference's kernel test builds them (`d`: the float rows' width)."""
    rng = np.random.RandomState(seed)
    if is_binary:
        a = (rng.rand(nq, 256) > 0.5).astype(np.float32)
        b = (rng.rand(nt, 256) > 0.5).astype(np.float32)
    else:
        a = rng.randn(nq, d).astype(np.float32)
        b = rng.randn(nt, d).astype(np.float32)
    vb = np.ones(nt, bool)
    vb[:3] = False
    return a, b, vb


def assert_two_nn_close(got, ref, desc_q, desc_t, rtol=1e-3, atol=1e-3):
    """The float 2-NN's stated tolerance. got/ref: (d0, d1, i0) arrays with
    the query axis last; desc_q: (..., Nq, D), desc_t: (..., Nt, D) with
    the same leading axes. d0 and d1 agree within rtol * |ref| + atol; i0
    is equal wherever the reference's d1 - d0 exceeds that tolerance, and
    elsewhere it names a target no further away than the reference's d1
    (one of the two nearest)."""
    gd0, gd1, gi0 = [np.asarray(x) for x in got]
    rd0, rd1, ri0 = [np.asarray(x) for x in ref]
    real = rd0 < 1e29
    tol0 = rtol * np.abs(rd0) + atol
    assert (np.abs(gd0 - rd0) <= tol0).all()
    assert (np.abs(gd1 - rd1) <= rtol * np.abs(rd1) + atol).all()
    clear = (rd1 - rd0) > 2 * tol0
    np.testing.assert_array_equal(gi0[clear], ri0[clear])
    near = real & ~clear
    if near.any():
        q = np.asarray(desc_q, np.float64)
        t = np.take_along_axis(np.asarray(desc_t, np.float64),
                               gi0[..., None].astype(np.int64), axis=-2)
        direct = ((q - t) ** 2).sum(-1)
        assert (direct[near] <= rd1[near] * (1 + rtol) + atol).all()


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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "all_invalid", "ties"])
def test_two_nn_pairs_float_cuda_close_to_plain(cuda_device, case):
    desc, valid, pairs = _float_descriptors(case)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (desc, valid, pairs)]
    before = two_nn_pairs.launches
    got = two_nn_pairs(*args, is_binary=False)
    torch.cuda.synchronize()
    assert two_nn_pairs.launches == before + 1
    ref = two_nn_pairs_plain(*args, is_binary=False)
    assert_two_nn_close([g.cpu() for g in got], [r.cpu() for r in ref],
                        desc[pairs], desc[pairs[:, ::-1]])


@pytest.mark.cuda
@pytest.mark.parametrize("nt", [237, 256, 1, 9000])
@pytest.mark.parametrize("is_binary", [True, False])
def test_two_nn_cuda_against_plain(cuda_device, is_binary, nt):
    """Rectangular sets; nt = 256 has no padded column, 9000 goes through
    many target tiles (past the reference kernel's 8192-target limit)."""
    a, b, vb = _rect_descriptors(is_binary, nt=nt)
    args = [torch.as_tensor(x, device=cuda_device) for x in (a, b, vb)]
    before = two_nn.launches
    got = two_nn(*args, is_binary=is_binary)
    torch.cuda.synchronize()
    assert two_nn.launches == before + 1
    ref = two_nn_plain(*args, is_binary=is_binary)
    if is_binary:
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    else:
        assert_two_nn_close([g.cpu() for g in got], [r.cpu() for r in ref],
                            a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 160, 256])
def test_two_nn_float_cuda_other_widths(cuda_device, d):
    """Float rows narrower than the kernel's 128-column staging chunk, and
    wider: 160 ends in a partial second chunk, 256 fills two."""
    a, b, vb = _rect_descriptors(False, d=d)
    args = [torch.as_tensor(x, device=cuda_device) for x in (a, b, vb)]
    got = two_nn(*args, is_binary=False)
    ref = two_nn_plain(*args, is_binary=False)
    assert_two_nn_close([g.cpu() for g in got], [r.cpu() for r in ref], a, b)
    # the same rows as one pair of a batch, both directions
    n = min(a.shape[0], b.shape[0])
    desc = np.stack([a[:n], b[:n]])
    valid = np.stack([np.ones(n, bool), vb[:n]])
    pairs = np.asarray([[0, 1]], np.int32)
    dev = [torch.as_tensor(x, device=cuda_device)
           for x in (desc, valid, pairs)]
    got = two_nn_pairs(*dev, is_binary=False)
    ref = two_nn_pairs_plain(*dev, is_binary=False)
    assert_two_nn_close([g.cpu() for g in got], [r.cpu() for r in ref],
                        desc[pairs], desc[pairs[:, ::-1]])


@pytest.mark.cuda
def test_two_nn_cuda_all_targets_invalid(cuda_device):
    a, b, vb = _rect_descriptors(True, nq=64, nt=64)
    vb[:] = False
    d0, d1, i0 = two_nn(*[torch.as_tensor(x, device=cuda_device)
                          for x in (a, b, vb)])
    assert bool((d0 >= 1e29).all()) and bool((i0 == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "all_invalid", "ties"])
def test_two_nn_cuda_equals_two_nn_pairs_forward(cuda_device, case):
    """With 61 rows both paddings leave a padded column, so `two_nn` of a
    pair equals `two_nn_pairs`' forward direction exactly."""
    desc, valid, pairs = _descriptors(case)
    dev = [torch.as_tensor(a, device=cuda_device)
           for a in (desc, valid, pairs)]
    batched = two_nn_pairs(*dev)
    for p, (i, j) in enumerate(pairs):
        one = two_nn(dev[0][i], dev[0][j], dev[1][j])
        for a, b in zip(one, batched):
            assert torch.equal(a, b[p, 0])


# ---- the redesigned 2-NN kernels at their tile edges -------------------
# A warp owns 16 query rows (32 in the float kernel's larger tile); the
# binary kernel walks targets 32 at a time (four `mma` tiles of 8) and
# stages 1024 at a time, the float kernel takes 64 a tile; the target axis
# splits into segments of whole 64s.

def _edge_sets(is_binary, nq, nt, d, seed=0):
    """Query and target rows with planted near-duplicates, so ties and
    near-ties exist at any size, and a few invalid targets."""
    rng = np.random.RandomState(seed + 7 * nq + 13 * nt + d)
    if is_binary:
        q = (rng.rand(nq, d) > 0.5).astype(np.float32)
        t = (rng.rand(nt, d) > 0.5).astype(np.float32)
    else:
        q = rng.randn(nq, d).astype(np.float32)
        t = rng.randn(nt, d).astype(np.float32)
    # every third query is a copy of some target; some targets are copies
    # of each other (equal distances at two columns)
    for r in range(0, nq, 3):
        q[r] = t[rng.randint(nt)]
    for _ in range(max(nt // 8, 1)):
        t[rng.randint(nt)] = t[rng.randint(nt)]
    vt = rng.rand(nt) > 0.1
    return q, t, vt


def _check_two_nn(dev, q, t, vt, is_binary):
    args = [torch.as_tensor(x, device=dev) for x in (q, t, vt)]
    before = two_nn.launches
    got = two_nn(*args, is_binary=is_binary)
    torch.cuda.synchronize()
    assert two_nn.launches == before + 1
    ref = two_nn_plain(*args, is_binary=is_binary)
    if is_binary:
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    else:
        assert_two_nn_close([g.cpu() for g in got], [r.cpu() for r in ref],
                            q, t)
    return got


def _check_two_nn_pairs(dev, desc, valid, pairs, is_binary):
    args = [torch.as_tensor(x, device=dev) for x in (desc, valid, pairs)]
    got = two_nn_pairs(*args, is_binary=is_binary)
    torch.cuda.synchronize()
    ref = two_nn_pairs_plain(*args, is_binary=is_binary)
    if is_binary:
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    else:
        assert_two_nn_close([g.cpu() for g in got], [r.cpu() for r in ref],
                            desc[pairs], desc[pairs[:, ::-1]])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("nt", [1, 7, 8, 9, 63, 64, 65, 500, 4097, 9000])
@pytest.mark.parametrize("nq", [1, 15, 16, 17, 500, 513])
@pytest.mark.parametrize("is_binary", [True, False])
def test_two_nn_cuda_tile_edges(cuda_device, is_binary, nq, nt):
    q, t, vt = _edge_sets(is_binary, nq, nt, 256 if is_binary else 128)
    _check_two_nn(cuda_device, q, t, vt, is_binary)


@pytest.mark.cuda
@pytest.mark.parametrize("is_binary,d", [
    (True, 32), (True, 100), (True, 256), (False, 4), (False, 64),
    (False, 128), (False, 130), (False, 160), (False, 256)])
def test_two_nn_cuda_descriptor_widths(cuda_device, is_binary, d):
    """Binary rows narrower than 256 bits are zero-padded by the packer;
    float rows of 130 columns are not 16-byte aligned (4-byte copies), 160
    and 256 restage the query chunk with every step."""
    q, t, vt = _edge_sets(is_binary, 77, 203, d)
    _check_two_nn(cuda_device, q, t, vt, is_binary)
    desc = np.stack([q, t[:77], t[77:154]])
    valid = np.stack([np.ones(77, bool), vt[:77], vt[77:154]])
    pairs = np.asarray([[0, 1], [0, 2], [1, 2]], np.int32)
    _check_two_nn_pairs(cuda_device, desc, valid, pairs, is_binary)


@pytest.mark.cuda
@pytest.mark.parametrize("n_pairs", [1, 28])
@pytest.mark.parametrize("is_binary", [True, False])
def test_two_nn_pairs_cuda_pair_counts(cuda_device, is_binary, n_pairs):
    rng = np.random.RandomState(3)
    B, N, d = 8, 150, 256 if is_binary else 128
    rows = [_edge_sets(is_binary, N, N, d, seed=b)[0] for b in range(B)]
    for b in range(1, B):               # true matches between neighbours
        rows[b][:60] = rows[b - 1][rng.permutation(N)[:60]]
    desc = np.stack(rows)
    valid = rng.rand(B, N) > 0.1
    pairs = np.asarray([(i, j) for i in range(B)
                        for j in range(i + 1, B)], np.int32)[:n_pairs]
    _check_two_nn_pairs(cuda_device, desc, valid, pairs, is_binary)


@pytest.mark.cuda
@pytest.mark.parametrize("is_binary", [True, False])
def test_two_nn_pairs_cuda_image_with_itself(cuda_device, is_binary):
    """Every row's nearest is itself at distance 0 (unless it is invalid
    or an earlier duplicate exists)."""
    q, _, _ = _edge_sets(is_binary, 90, 90, 256 if is_binary else 128)
    q[40] = q[3]
    desc = np.stack([q, q[::-1].copy()])
    valid = np.ones((2, 90), bool)
    valid[0, 5] = False
    pairs = np.asarray([[0, 0], [1, 1], [0, 1]], np.int32)
    d0, d1, i0 = _check_two_nn_pairs(cuda_device, desc, valid, pairs,
                                     is_binary)
    if is_binary:
        assert int(i0[0, 0, 40]) == 3 and float(d1[0, 0, 40]) == 0.0
        assert int(i0[0, 0, 7]) == 7 and float(d0[0, 0, 7]) == 0.0
        assert int(i0[0, 0, 5]) != 5


# pairs of columns holding the same target row: one thread's two columns,
# two lanes of a quad, two quads, two `mma` tiles, the float tile's edge
# and the segment edge (64), one float thread's next column (+8), the
# binary staging chunk's edge (1024)
_TIE_COLUMNS = [(0, 1), (4, 6), (8, 17), (3, 11), (20, 21), (63, 64),
                (60, 70), (127, 128), (1023, 1024), (1000, 1100), (2, 1299)]


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [None, (64, 1), (128, 1), (64, 3),
                                  (128, 5), (64, 21)])
@pytest.mark.parametrize("is_binary", [True, False])
def test_two_nn_cuda_ties_across_edges(cuda_device, monkeypatch, is_binary,
                                       plan):
    """Query row k is nearest to the target row planted at both columns of
    `_TIE_COLUMNS[k]`: i0 is the lower column and d1 = d0, under the
    planned grid and under forced ones (query rows a block, target
    segments; the binary kernel has the 64-row block only)."""
    import stitching_tpu_torch.ops.kernels.two_nn as mod

    nt, d = 1300, 256 if is_binary else 128
    if plan is not None:
        rows, splits = plan
        rows = mod.ROWS_PER_BLOCK[is_binary][0] if is_binary else rows
        units = -(-nt // mod.SPLIT_UNIT)
        per_seg = -(-units // splits)
        forced = (rows, -(-units // per_seg), per_seg * mod.SPLIT_UNIT)
        monkeypatch.setattr(mod, "launch_plan", lambda *a: forced)
    rng = np.random.RandomState(5)
    nq = 70
    if is_binary:
        t = (rng.rand(nt, d) > 0.5).astype(np.float32)
        q = (rng.rand(nq, d) > 0.5).astype(np.float32)
    else:
        t = rng.randn(nt, d).astype(np.float32)
        q = rng.randn(nq, d).astype(np.float32)
    for k, (a, b) in enumerate(_TIE_COLUMNS):
        row = ((rng.rand(d) > 0.5).astype(np.float32) if is_binary
               else rng.randn(d).astype(np.float32))
        t[a] = t[b] = row
        q[k] = row
        if is_binary:
            q[k, k] = 1 - q[k, k]           # distance 1 to both
        else:
            q[k, :4] += 0.25
    vt = np.ones(nt, bool)
    d0, d1, i0 = _check_two_nn(cuda_device, q, t, vt, is_binary)
    for k, (a, b) in enumerate(_TIE_COLUMNS):
        assert int(i0[k]) == a
        assert float(d1[k]) == float(d0[k])
        if is_binary:
            assert float(d0[k]) == 1.0


# binary widths on both sides of the packed row's two sizes (8 words up to
# 256 bits, 16 up to 512): ORB's 256, BRISK's 512, AKAZE's 486
_BINARY_WIDTHS = [1, 255, 256, 257, 486, 512]


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [None, (64, 3), (64, 21)])
@pytest.mark.parametrize("d", _BINARY_WIDTHS)
def test_two_nn_binary_cuda_wide_rows(cuda_device, monkeypatch, d, plan):
    """Both binary entries at every width up to 512 bits, equal to their
    plain versions: invalid targets, planted duplicates, ties across the
    staging chunk's edge at either width (512 and 1024 rows), an uneven
    row count, under the planned grid and split target axes."""
    import stitching_tpu_torch.ops.kernels.two_nn as mod

    nq, nt = 70, 1300
    if plan is not None:
        units = -(-nt // mod.SPLIT_UNIT)
        per_seg = -(-units // plan[1])
        forced = (plan[0], -(-units // per_seg), per_seg * mod.SPLIT_UNIT)
        monkeypatch.setattr(mod, "launch_plan", lambda *a: forced)
    q, t, vt = _edge_sets(True, nq, nt, d)
    for k, (a, b) in enumerate([(511, 512), (1023, 1024), (0, 1299)]):
        t[a] = t[b] = q[k]
        vt[a] = vt[b] = True
    _check_two_nn(cuda_device, q, t, vt, True)
    desc = np.stack([q[:61], t[:61], t[61:122], t[122:183]])
    valid = np.stack([np.ones(61, bool), vt[:61], vt[61:122], vt[122:183]])
    pairs = np.asarray([[0, 1], [0, 2], [1, 3], [2, 2]], np.int32)
    _check_two_nn_pairs(cuda_device, desc, valid, pairs, True)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [257, 486, 512])
def test_two_nn_binary_cuda_wide_fragment_layout(cuda_device, d):
    """`test_two_nn_binary_cuda_fragment_layout` with the flipped bits in
    the second 256 (the second `mma` of a tile): dist(r, c) = r + c, and
    an invalid target at 512 + 4 bits' distance never wins."""
    nq, nt = 48, 100
    base = (np.random.RandomState(9).rand(d) > 0.5).astype(np.float32)
    q = np.stack([base] * nq)
    t = np.stack([base] * nt)
    for r in range(nq):
        q[r, d - r:] = 1 - q[r, d - r:]
    for c in range(nt):
        k = nt - 1 - c
        t[c, d - 1 - k - nq:d - 1 - nq] = 1 - t[c, d - 1 - k - nq:d - 1 - nq]
    vt = np.ones(nt, bool)
    vt[nt - 1 - 4] = False
    d0, d1, i0 = _check_two_nn(cuda_device, q, t, vt, True)
    for r in range(nq):
        assert int(i0[r]) == nt - 1
        assert float(d0[r]) == r and float(d1[r]) == r + 1


# target columns of the binary kernel's own edges, each pair planted with
# one target row: two steps of a fold window, the window's edge (128
# columns at 512 bits, 256 at 256), a bulk copy's edges (256 rows), the
# staging chunk's edge (1024 rows), a window that ends past the targets
_FOLD_EDGES = [(31, 32), (127, 128), (255, 256), (383, 384), (511, 512),
               (767, 768), (1023, 1024), (129, 1290), (0, 1299)]


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [None, (64, 1), (64, 3), (256, 1),
                                  (256, 5)])
@pytest.mark.parametrize("d", [257, 486, 512])
def test_two_nn_binary_cuda_fold_edges(cuda_device, monkeypatch, d, plan):
    """Wide binary rows against the plain versions with ties on every edge
    of the fold: query row 17 k (spread over a block's warps and a warp's
    four 16-row tiles) is at distance 1 from the row planted at both
    columns of `_FOLD_EDGES[k]`, so i0 is the lower column and d1 = d0;
    1300 targets (not a multiple of a window), under the planned grid and
    forced ones (64- and 256-row blocks, split target axes). Then the ends
    of the 16-bit key's range: queries of all ones and all zeros against
    targets of all ones and all zeros, valid and invalid, and a target
    set with every target invalid."""
    import stitching_tpu_torch.ops.kernels.two_nn as mod

    nq, nt = 160, 1300
    if plan is not None:
        units = -(-nt // mod.SPLIT_UNIT)
        per_seg = -(-units // plan[1])
        forced = (plan[0], -(-units // per_seg), per_seg * mod.SPLIT_UNIT)
        monkeypatch.setattr(mod, "launch_plan", lambda *a: forced)
    q, t, vt = _edge_sets(True, nq, nt, d, seed=4)
    rng = np.random.RandomState(d)
    rows = [17 * k for k in range(len(_FOLD_EDGES))]
    for k, (a, b) in enumerate(_FOLD_EDGES):
        row = (rng.rand(d) > 0.5).astype(np.float32)
        t[a] = t[b] = q[rows[k]] = row
        vt[a] = vt[b] = True
        q[rows[k], 3 * k] = 1 - q[rows[k], 3 * k]
    d0, d1, i0 = _check_two_nn(cuda_device, q, t, vt, True)
    for k, (a, _) in enumerate(_FOLD_EDGES):
        assert int(i0[rows[k]]) == a
        assert float(d0[rows[k]]) == 1.0 and float(d1[rows[k]]) == 1.0

    q[1:5], q[5:9] = 1.0, 0.0
    t[[7, 700, 1299]], t[[8, 900]] = 1.0, 0.0
    t[[100, 1000]], t[[101, 1001]] = 1.0, 0.0
    vt[[7, 700, 1299, 8, 900]] = True
    vt[[100, 1000, 101, 1001]] = False
    d0, d1, i0 = _check_two_nn(cuda_device, q, t, vt, True)
    assert bool((i0[1:5] == 7).all()) and bool((i0[5:9] == 8).all())
    assert bool((d0[1:9] == 0).all()) and bool((d1[1:9] == 0).all())
    desc = np.stack([q[:70], t[:70], t[1230:]])
    valid = np.stack([np.ones(70, bool), vt[:70], vt[1230:]])
    pairs = np.asarray([[0, 1], [0, 2], [2, 1], [1, 1]], np.int32)
    _check_two_nn_pairs(cuda_device, desc, valid, pairs, True)

    d0, d1, i0 = _check_two_nn(cuda_device, q, t, np.zeros(nt, bool), True)
    assert bool((i0 == 0).all()) and bool((d0 >= 1e29).all())


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("nq", [1, 127, 128, 129, 513])
def test_two_nn_float_cuda_large_tile(cuda_device, monkeypatch, nq, splits):
    """The float kernel's 128-row tile (8 query rows a thread), which the
    planned grid takes only for many query rows, at its row-block edges."""
    import stitching_tpu_torch.ops.kernels.two_nn as mod

    monkeypatch.setattr(mod, "launch_plan",
                        lambda *a: (128, splits, 320 if splits == 1 else 192))
    q, t, vt = _edge_sets(False, nq, 300, 128)
    _check_two_nn(cuda_device, q, t, vt, False)


@pytest.mark.cuda
@pytest.mark.parametrize("is_binary", [True, False])
def test_two_nn_binary_cuda_fragment_layout(cuda_device, is_binary):
    """Every (query row, target column) distance distinct: target c is
    query 0 with its first c bits flipped and query r is query 0 with its
    last r bits flipped, so dist(r, c) = r + c for the binary rows; a wrong
    row or column of the `mma` fragment changes some row's answer. Targets
    in decreasing order of c, so the nearest is the LAST column."""
    nq, nt, d = 48, 100, 256
    base = (np.random.RandomState(9).rand(d) > 0.5).astype(np.float32)
    q = np.stack([base] * nq)
    t = np.stack([base] * nt)
    for r in range(nq):
        q[r, d - r:] = 1 - q[r, d - r:]
    for c in range(nt):
        k = nt - 1 - c                       # column c holds distance k
        t[c, :k] = 1 - t[c, :k]
    vt = np.ones(nt, bool)
    vt[nt - 1 - 4] = False                   # the target at distance 4
    d0, d1, i0 = _check_two_nn(cuda_device, q, t, vt, is_binary)
    if is_binary:
        for r in range(nq):
            assert int(i0[r]) == nt - 1
            assert float(d0[r]) == r and float(d1[r]) == r + 1


@pytest.mark.cuda
@pytest.mark.parametrize("is_binary", [True, False])
def test_two_nn_cuda_all_invalid_any_grid(cuda_device, is_binary):
    """All targets invalid, with and without a padded column, split and
    unsplit: i0 = 0 and d0 = 1e30."""
    for nq, nt in [(40, 256), (40, 300), (600, 128), (1, 1)]:
        q, t, vt = _edge_sets(is_binary, nq, nt, 256 if is_binary else 128)
        vt[:] = False
        d0, d1, i0 = _check_two_nn(cuda_device, q, t, vt, is_binary)
        assert bool((i0 == 0).all()) and bool((d0 >= 1e29).all())
    desc, valid, pairs = (_descriptors("random") if is_binary
                          else _float_descriptors("random"))
    valid[:] = False
    d0, d1, i0 = _check_two_nn_pairs(cuda_device, desc, valid, pairs,
                                     is_binary)
    assert bool((i0 == 0).all()) and bool((d0 >= 1e29).all())


@pytest.mark.cuda
@pytest.mark.parametrize("is_binary", [True, False])
def test_two_nn_cuda_on_another_stream(cuda_device, is_binary):
    """Both launches of a call go to the current stream: results made on a
    side stream, with the default stream kept busy, are right after that
    stream alone is waited for."""
    q, t, vt = _edge_sets(is_binary, 500, 500, 256 if is_binary else 128)
    args = [torch.as_tensor(x, device=cuda_device) for x in (q, t, vt)]
    ref = two_nn_plain(*args, is_binary=is_binary)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    busy = torch.randn(4096, 4096, device=cuda_device)
    for _ in range(4):
        busy = busy @ busy * 1e-3            # default stream stays busy
    with torch.cuda.stream(side):
        got = [two_nn(*args, is_binary=is_binary) for _ in range(3)][-1]
    side.synchronize()
    if is_binary:
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    else:
        assert_two_nn_close([g.cpu() for g in got], [r.cpu() for r in ref],
                            q, t)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Seams and blends on the card (plain PyTorch ops) against the same code on
# the CPU, which `test_torch_seam.py`, `test_torch_pyramid.py` and
# `test_torch_blend.py` hold against the JAX package
# ---------------------------------------------------------------------------

def _seam_costs(kind, P=4, h=90, w=70, seed=7):
    rng = np.random.RandomState(seed)
    if kind == "ties":
        # three distinct values: tied moves at most steps, tied ends
        cost = rng.randint(0, 3, (P, h, w)).astype(np.float32)
        cost[1] = 0.0
        cost[2, :, ::2] = 1.0
    else:
        cost = (rng.rand(P, h, w) * 100).astype(np.float32)
        cost[:, :, 50:] += 1e4
        cost[:, 80:] = 0.0
    return cost


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ties", "random"])
def test_dp_seam_scan_cuda_equals_cpu(cuda_device, kind):
    """The DP seam scan takes the first of tied minima (the reference's
    argmin rule) on the card as on the CPU."""
    from stitching_tpu_torch.ops.seam import _dp_seam_kernel

    cost = torch.tensor(_seam_costs(kind))
    got = _dp_seam_kernel(cost.to(cuda_device)).cpu()
    assert torch.equal(got, _dp_seam_kernel(cost))
    if kind == "ties":
        # an all-zero cost: every move ties, so the seam is column 0
        assert bool((got[1] == 0).all())


def _seam_stack(seed=0):
    """Three 72x60 tiles at (0, 0), (40, 8), (18, 30): vertical and
    transposed seams and a three-way overlap."""
    rng = np.random.RandomState(seed)
    data = np.zeros((3, 128, 128, 3), np.float32)
    masks = np.zeros((3, 128, 128), np.float32)
    data[:, :60, :72] = rng.rand(3, 60, 72, 3) * 255
    masks[:, :60, :72] = 255
    return (data, masks, np.asarray([(0, 0), (40, 8), (18, 30)]),
            np.asarray([(72, 60)] * 3))


@pytest.mark.cuda
@pytest.mark.parametrize("finder", ["dp_color", "dp_colorgrad", "gc_color",
                                    "gc_colorgrad", "voronoi"])
def test_seam_finders_cuda_equal_cpu(cuda_device, finder):
    from stitching_tpu_torch.compose import TileStack
    from stitching_tpu_torch.seam_finder import SeamFinder

    data, masks, corners, sizes = _seam_stack()
    cpu = TileStack(torch.tensor(data), torch.tensor(masks), corners, sizes)
    gpu = TileStack(cpu.data.to(cuda_device), cpu.masks.to(cuda_device),
                    corners, sizes)
    got = SeamFinder(finder).find_stack(gpu)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), SeamFinder(finder).find_stack(cpu))


@pytest.mark.cuda
def test_distance_transform_and_pyramid_cuda_match_cpu(cuda_device):
    from stitching_tpu_torch.ops.blend import distance_transform_l1
    from stitching_tpu_torch.ops.pyramid import (build_laplacian,
                                                 collapse_laplacian)

    rng = np.random.RandomState(2)
    masks = torch.tensor(rng.rand(3, 96, 160) > 0.02)
    masks[1] = True
    assert torch.equal(distance_transform_l1(masks.to(cuda_device)).cpu(),
                       distance_transform_l1(masks))
    img = torch.tensor((rng.rand(2, 128, 192, 3) * 255).astype(np.float32))
    laps_gpu = build_laplacian(img.to(cuda_device), 4)
    for a, b in zip(laps_gpu, build_laplacian(img, 4)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4
    out = collapse_laplacian(laps_gpu).cpu()
    assert float((out - img).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("kind,strength", [("multiband", 5),
                                           ("multiband", 0.2),
                                           ("feather", 5)])
def test_blend_stack_cuda_close_to_cpu(cuda_device, kind, strength):
    from stitching_tpu_torch.compose import TileStack, blend_stack

    data, masks, corners, sizes = _seam_stack(1)
    cpu = TileStack(torch.tensor(data), torch.tensor(masks), corners, sizes)
    gpu = TileStack(cpu.data.to(cuda_device), cpu.masks.to(cuda_device),
                    corners, sizes)
    pano, mask = blend_stack(gpu, None, kind, strength)
    ref, ref_mask = blend_stack(cpu, None, kind, strength)
    assert pano.shape == ref.shape and torch.equal(mask.cpu(), ref_mask)
    diff = (pano.cpu().to(torch.int16) - ref.to(torch.int16)).abs()
    assert int(diff.max()) <= 1
    assert float((diff == 0).float().mean()) >= 0.999


# ---------------------------------------------------------------------------
# This slice's paths on the card (plain PyTorch ops around the same two
# kernels) against the same code on the CPU, which `test_torch_graphcut.py`,
# `test_torch_affine.py` and `test_torch_surfaces.py` hold against the JAX
# package
# ---------------------------------------------------------------------------

def _cut_grids(P=5, h=24, w=40, seed=0):
    """Seeded grids whose push-relabel loops end after different numbers
    of iterations (the last one at once: its terminal edges cancel)."""
    rng = np.random.RandomState(seed)
    cap = rng.uniform(0.1, 2.0, (P, 4, h, w)).astype(np.float32)
    cap[:, 0, :, -1] = 0
    cap[:, 1, :, 0] = 0
    cap[:, 2, -1, :] = 0
    cap[:, 3, 0, :] = 0
    s = np.zeros((P, h, w), np.float32)
    t = np.zeros((P, h, w), np.float32)
    s[:, :, 0] = 100.0
    t[:, :, -1] = 100.0
    t[1, :, w // 2] = 2.0
    s[2, : h // 2, : w // 3] = 50.0
    t[P - 1] = s[P - 1]
    return cap, s, t


@pytest.mark.cuda
@pytest.mark.parametrize("check_every", [1, 8])
def test_grid_min_cut_cuda_equals_cpu(cuda_device, monkeypatch, check_every):
    from stitching_tpu_torch.ops import graphcut

    grids = [torch.tensor(a) for a in _cut_grids()]
    want, want_stats = graphcut.grid_min_cut(*grids)
    monkeypatch.setattr(graphcut, "CHECK_EVERY", check_every)
    got, stats = graphcut.grid_min_cut(*(g.to(cuda_device) for g in grids))
    assert torch.equal(got.cpu(), want)
    assert stats["iterations"] == want_stats["iterations"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("use_grad", [False, True])
def test_seam_cut_pair_coarse_to_fine_cuda_equals_cpu(cuda_device,
                                                      use_grad):
    """128 x 192 overlaps: a quarter-size cut first, then the banded
    full-size one."""
    from stitching_tpu_torch.ops.graphcut import seam_cut_pair

    rng = np.random.RandomState(4)
    P, h, w = 2, 128, 192
    img_i = rng.uniform(0, 255, (P, h, w, 3)).astype(np.float32)
    img_j = np.clip(img_i + rng.uniform(-90, 90, img_i.shape), 0,
                    255).astype(np.float32)
    img_j[:, :, 90:102] = img_i[:, :, 90:102]
    only_i = np.zeros((P, h, w), bool)
    only_j = np.zeros((P, h, w), bool)
    only_i[:, :, :25] = True
    only_j[:, :, -24:] = True
    both = ~(only_i | only_j)
    args = [torch.tensor(a) for a in (img_i, img_j, both, only_i, only_j)]
    got = seam_cut_pair(*(a.to(cuda_device) for a in args), use_grad)
    assert torch.equal(got.cpu(), seam_cut_pair(*args, use_grad))


def _pair_grids(P, h, w, seed, frozen=()):
    """P seeded grids of h x w: random edge capacities, the left column
    tied to the source and the right one to the sink, a tenth of the
    pixels with small terminal capacities and a few with pins as large as
    the seams' band pins; the pairs in `frozen` have equal terminal
    capacities, so their loops end before their first iteration."""
    rng = np.random.RandomState(seed)
    cap = rng.uniform(0.1, 2.0, (P, 4, h, w)).astype(np.float32)
    cap[:, 0, :, -1] = 0
    cap[:, 1, :, 0] = 0
    cap[:, 2, -1, :] = 0
    cap[:, 3, 0, :] = 0
    s = np.zeros((P, h, w), np.float32)
    t = np.zeros((P, h, w), np.float32)
    s[:, :, 0] = 100.0
    t[:, :, -1] = 100.0
    s += (rng.rand(P, h, w) < 0.1) * rng.uniform(0, 3, (P, h, w))
    t += (rng.rand(P, h, w) < 0.1) * rng.uniform(0, 3, (P, h, w))
    s[rng.rand(P, h, w) < 0.01] = 1e8
    t[rng.rand(P, h, w) < 0.01] = 1e8
    for p in frozen:
        t[p] = s[p]
    return [torch.tensor(a.astype(np.float32)) for a in (cap, s, t)]


def _kernel_equals_plain(dev, grids, max_iters=2000, every=64):
    """The kernel's cut and each pair's iterations against the plain loop
    on the CPU: the batch's cut bit for bit, its longest loop, and each
    pair's own loop run alone."""
    from stitching_tpu_torch.ops import graphcut
    from stitching_tpu_torch.ops.kernels.push_relabel import push_relabel

    src, iters = push_relabel(*(g.to(dev) for g in grids), max_iters, every)
    torch.cuda.synchronize()
    want, stats = graphcut._push_relabel(*grids, max_iters, every)
    assert torch.equal(src.cpu(), want)
    iters = iters.cpu().tolist()
    assert max(iters) == stats["iterations"]
    for p, n in enumerate(iters):
        alone = graphcut._push_relabel(*(g[p:p + 1] for g in grids),
                                       max_iters, every)[1]
        assert n == alone["iterations"], (p, iters)
    return iters


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 3, 14])
@pytest.mark.parametrize("h,w", [(16, 16), (64, 64), (80, 96), (37, 53),
                                 (131, 97), (256, 256)])
def test_push_relabel_cuda_equals_plain(cuda_device, P, h, w):
    """Seeded grids of every shape, one, three and fourteen pairs a
    launch, the second pair frozen from the start beside live ones."""
    grids = _pair_grids(P, h, w, seed=P * 1000 + h + w,
                        frozen=(1,) if P > 1 else ())
    iters = _kernel_equals_plain(cuda_device, grids)
    assert max(iters) > 0
    if P > 1:
        assert iters[1] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("max_iters", [1, 63, 64, 65])
def test_push_relabel_cuda_stops_at_max_iters(cuda_device, max_iters):
    """Loops cut short around the global relabel's period (64): each
    stops at exactly `max_iters`, with the plain loop's cut."""
    grids = _pair_grids(3, 37, 53, seed=7)
    iters = _kernel_equals_plain(cuda_device, grids, max_iters=max_iters)
    assert iters == [max_iters] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", range(1, 9))
def test_push_relabel_cuda_any_cluster_size(cuda_device, monkeypatch,
                                            cluster):
    """Every cluster width on one grid, each CTA's share ending inside a
    row, so that pushes, heights and the BFS cross between the CTAs."""
    from stitching_tpu_torch.ops.kernels import push_relabel as pr

    grids = _pair_grids(3, 61, 47, seed=11, frozen=(2,))
    monkeypatch.setattr(pr, "PIXELS_PER_CTA", -(-61 * 47 // cluster))
    assert pr.cluster_size(61, 47) == cluster
    _kernel_equals_plain(cuda_device, grids)


@pytest.mark.cuda
def test_cut_launches_one_a_level(cuda_device):
    """`grid_min_cut` on the card: one launch and one host read a level,
    counted in `gc/cut_launches` and `gc/host_reads`; the coarse-to-fine
    pair cut runs two levels."""
    from stitching_tpu_torch import profiling
    from stitching_tpu_torch.ops import graphcut
    from stitching_tpu_torch.ops.kernels.push_relabel import push_relabel

    grids = [g.to(cuda_device) for g in _pair_grids(3, 40, 56, seed=3)]
    rng = np.random.RandomState(5)
    img = torch.tensor(rng.uniform(0, 255, (2, 128, 160, 3)),
                       dtype=torch.float32, device=cuda_device)
    only_i = torch.zeros((2, 128, 160), dtype=torch.bool, device=cuda_device)
    only_j = torch.zeros_like(only_i)
    only_i[:, :, :20] = True
    only_j[:, :, -20:] = True
    before = push_relabel.launches
    profiling.reset()
    profiling.enable()
    try:
        _, stats = graphcut.grid_min_cut(*grids)
        one = profiling.get_counters()
        profiling.reset()
        graphcut.seam_cut_pair(img, img.flip(2), ~(only_i | only_j), only_i,
                               only_j, False)
        two = profiling.get_counters()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert stats["launches"] == stats["host_reads"] == 1
    assert stats["relabels"] == -(-stats["iterations"] // 64)
    assert one["gc/cut_launches"] == one["gc/host_reads"] == 1
    assert one["gc/levels"] == 1
    assert two["gc/cut_launches"] == two["gc/host_reads"] == 2
    assert two["gc/levels"] == 2
    assert push_relabel.launches == before + 3


@pytest.mark.cuda
def test_ransac_affine_partial_cuda_equals_cpu(cuda_device):
    from stitching_tpu_torch.ops.ransac import ransac_affine_partial

    rng = np.random.RandomState(1)
    P, M = 6, 300
    src = rng.uniform(0, 1200, (P, M, 2)).astype(np.float32)
    t = rng.uniform(-0.05, 0.05, P)
    A = np.stack([np.array([[np.cos(a), -np.sin(a), 600.0 - 40 * k],
                            [np.sin(a), np.cos(a), 20.0 + 3 * k]])
                  for k, a in enumerate(t)])
    dst = (np.einsum("pij,pmj->pmi", A[:, :, :2], src) + A[:, None, :, 2]
           + rng.normal(0, 0.5, src.shape)).astype(np.float32)
    out = rng.rand(P, M) < 0.4
    dst[out] = rng.uniform(0, 1200, (out.sum(), 2))
    valid = rng.rand(P, M) < 0.9
    valid[5] = False
    args = [torch.tensor(a) for a in (src, dst, valid)]
    seeds = torch.arange(P, dtype=torch.int64) * 7 + 3
    got = ransac_affine_partial(*(a.to(cuda_device) for a in args),
                                seeds.to(cuda_device))
    want = ransac_affine_partial(*args, seeds)
    for k in ("ok", "inliers", "num_inliers"):
        assert torch.equal(got[k].cpu(), want[k])
    assert int(want["ok"].sum()) == 5
    H, Hw = got["H"].cpu(), want["H"]
    assert float((H - Hw).abs().max()) <= 1e-4 * float(Hw.abs().max())


_SURFACES_TIGHT = ("affine", "plane", "cylindrical", "mercator", "spherical")


@pytest.mark.cuda
@pytest.mark.parametrize("surface", [
    "affine", "spherical", "plane", "cylindrical", "fisheye",
    "stereographic", "compressedPlaneA2B1", "compressedPlaneA1.5B1",
    "compressedPlanePortraitA2B1", "compressedPlanePortraitA1.5B1",
    "paniniA2B1", "paniniA1.5B1", "paniniPortraitA2B1",
    "paniniPortraitA1.5B1", "mercator", "transverseMercator"])
def test_warp_stack_cuda_close_to_cpu(cuda_device, surface):
    """Every surface's warp (the backward map in plain ops, the sampler
    kernel) on the card against the CPU's: the same ROIs, masks equal at
    99.99% of pixels or more, and inside them the values within the bars
    `test_torch_surfaces.py` holds against the JAX package (the card's
    transcendentals differ from the CPU's in the last bit)."""
    from stitching_tpu_torch.compose import warp_stack
    from stitching_tpu_torch.ops.warp import WARP_TYPES

    assert surface in WARP_TYPES
    rng = np.random.RandomState(5)
    n, (w, h) = 3, (256, 192)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    data = np.stack([np.stack([127 + 100 * np.sin(xx / (7 + i + c)
                                                  + yy / 11.0)
                               for c in range(3)], -1) for i in range(n)])
    data = np.round(data + rng.rand(*data.shape) * 20).astype(np.float32)
    sizes = np.asarray([(w, h)] * n, np.int32)
    if surface == "affine":
        Ks = [np.diag([0.4, 0.4, 1.0]).astype(np.float32)] * n
        Rs = [np.array([[np.cos(a), -np.sin(a), -280.0 * i],
                        [np.sin(a), np.cos(a), 12.0 * (i % 2)],
                        [0, 0, 1]], np.float32)
              for i, a in enumerate((-0.02, 0.0, 0.02))]
        scale = 0.4
    else:
        Ks = [np.array([[240, 0, w / 2], [0, 240, h / 2], [0, 0, 1]],
                       np.float32)] * n
        Rs = [np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]], np.float32)
              for a in (-0.5, 0.0, 0.5)]
        scale = 240.0
    cpu = warp_stack(torch.tensor(data), sizes, Ks, Rs, scale, surface)
    gpu = warp_stack(torch.tensor(data).to(cuda_device), sizes, Ks, Rs,
                     scale, surface)
    assert np.array_equal(gpu.corners, cpu.corners)
    assert np.array_equal(gpu.sizes, cpu.sizes)
    masks, ref_masks = gpu.masks.cpu(), cpu.masks
    assert float((masks == ref_masks).float().mean()) >= 0.9999
    care = (masks > 0) & (ref_masks > 0)
    assert int(care.sum()) > 0.5 * int((ref_masks > 0).sum())
    diff = (gpu.data.cpu() - cpu.data)[care].abs()
    bar = 1e-4 if surface in _SURFACES_TIGHT else 1e-3
    assert float((diff > 2e-3).float().mean()) <= bar
    assert float(diff.max()) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gain", "channel"])
def test_scalar_gains_cuda_close_to_cpu(cuda_device, kind):
    """The scalar compensators' overlap statistics and solve on the card
    give the CPU's gains to 1e-4; applied, the tiles are within 1 LSB."""
    from stitching_tpu_torch.compose import TileStack, apply_gains_stack
    from stitching_tpu_torch.exposure_error_compensator import (
        ExposureErrorCompensator)

    data, masks, corners, sizes = _seam_stack(2)
    data[1] *= 0.8
    cpu = TileStack(torch.tensor(data), torch.tensor(masks), corners, sizes)
    gpu = TileStack(cpu.data.to(cuda_device), cpu.masks.to(cuda_device),
                    corners, sizes)
    comps = []
    for stack in (gpu, cpu):
        comp = ExposureErrorCompensator(kind, nr_feeds=2)
        comp.feed_stack([tuple(c) for c in corners], stack)
        comps.append(comp)
    np.testing.assert_allclose(comps[0]._gains, comps[1]._gains, rtol=1e-4)
    assert np.abs(comps[1]._gains - 1).max() > 0.02
    got = apply_gains_stack(gpu, comps[0]).data.cpu()
    want = apply_gains_stack(cpu, comps[1]).data
    diff = (got - want).abs()
    assert float(diff.max()) <= 1.0
    assert float((diff == 0).float().mean()) >= 0.999


# ---------------------------------------------------------------------------
# Slice 6: the upload stream, the streamed composite and the strips on the
# card, against the same code's batched and monolithic results there
# (`test_torch_stream.py` and `test_torch_transfer.py` hold them against
# the JAX package on the CPU)
# ---------------------------------------------------------------------------

def _upload_images(n=6, h=1200, w=1600, seed=0):
    rng = np.random.RandomState(seed)
    imgs = [rng.randint(0, 255, (h + 7 * i, w, 3), np.uint8)
            for i in range(n)]
    imgs.append(rng.randint(0, 255, (h // 3, w // 5), np.uint8))
    return imgs


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_bytes,depth", [(65_536, 2), (3_000_000, 2),
                                               (1_000_000, 6)])
def test_uploader_cuda_content_exact(cuda_device, chunk_bytes, depth):
    """Each image read on the caller's stream right after `image(i)`
    returns (no host sync in between) equals the host image: the caller's
    stream waits on the image's event."""
    from stitching_tpu_torch.transfer import Uploader

    imgs = _upload_images()
    up = Uploader(imgs, chunk_bytes=chunk_bytes, depth=depth,
                  device=cuda_device)
    sums = []
    for i in range(len(imgs)):
        got = up.image(i)
        assert got.device.type == "cuda" and got.dtype == torch.uint8
        # queued on the current stream before anything synchronises
        sums.append(got.to(torch.int64).sum())
        assert got.shape == imgs[i].shape
    for i, s in enumerate(sums):
        assert int(s) == int(imgs[i].astype(np.int64).sum())
        assert np.array_equal(up.image(i).cpu().numpy(), imgs[i])
    up.join()
    assert up.channels == 3


@pytest.mark.cuda
def test_uploader_cuda_consumer_on_another_stream(cuda_device):
    """`image(i)` orders the caller's current stream, whichever it is,
    after the copy."""
    from stitching_tpu_torch.transfer import Uploader

    imgs = _upload_images(n=3)
    up = Uploader(imgs, chunk_bytes=100_000, device=cuda_device)
    side = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(side):
        copies = [up.image(i).clone() for i in range(len(imgs))]
    side.synchronize()
    for c, im in zip(copies, imgs):
        assert np.array_equal(c.cpu().numpy(), im)


@pytest.mark.cuda
def test_uploader_cuda_staging_alive_until_copied(cuda_device, monkeypatch):
    """Every pinned staging buffer is released only after its copy has
    run: an event recorded right after the copy has fired by the time
    the buffer is freed."""
    import weakref

    from stitching_tpu_torch import transfer

    real = transfer._copy_chunk
    checks = []

    def copy_chunk(dst, src, stream):
        staging = real(dst, src, stream)
        ev = torch.cuda.Event()
        ev.record(stream)
        weakref.finalize(staging, lambda e=ev: checks.append(e.query()))
        return staging

    monkeypatch.setattr(transfer, "_copy_chunk", copy_chunk)
    imgs = _upload_images(n=4)
    up = transfer.Uploader(imgs, chunk_bytes=200_000, depth=2,
                           device=cuda_device)
    up.join()
    for i, im in enumerate(imgs):
        assert np.array_equal(up.image(i).cpu().numpy(), im)
    assert len(checks) > 4 * 20 and all(checks)


@pytest.mark.cuda
def test_bilinear_cuda_same_value_whatever_the_batch(cuda_device):
    """The streamed FINAL warp samples one image at a time: the kernel's
    value at a pixel does not depend on the batch it ran in."""
    from stitching_tpu_torch.compose import warp_single, warp_stack

    rng = np.random.RandomState(3)
    n, (w, h) = 3, (320, 240)
    data = torch.tensor(rng.rand(n, h, w, 3).astype(np.float32) * 255,
                        device=cuda_device)
    sizes = np.asarray([(w, h)] * n, np.int32)
    Ks = [np.array([[300, 0, w / 2], [0, 300, h / 2], [0, 0, 1]],
                   np.float32)] * n
    Rs = [np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]], np.float32)
          for a in (-0.4, 0.0, 0.4)]
    batched = warp_stack(data, sizes, Ks, Rs, 300.0, "spherical")
    th, tw = batched.data.shape[1:3]
    for i in range(n):
        tile, mask = warp_single(data[i], (w, h), Ks[i], Rs[i],
                                 batched.corners[i], batched.sizes[i], 300.0,
                                 "spherical", th, tw)
        assert torch.equal(tile[0], batched.data[i])
        assert torch.equal(mask[0], batched.masks[i])


def _strip_stack(name, device):
    """The `test_torch_stream.py` geometries at a larger scale: a wide row
    (X strips), a tall grid (Y strips) and big windows (the streamed
    monolithic blend)."""
    rng = np.random.RandomState(5)
    if name == "x":
        th, tw, corners = 600, 800, [(i * 700, (i % 2) * 20)
                                     for i in range(12)]
    elif name == "y":
        th, tw, corners = 500, 800, [(c * 650, r * 430) for r in range(8)
                                     for c in range(2)]
    elif name == "gap":     # two pairs far apart: X strips no tile reaches
        th, tw, corners = 600, 800, [(0, 0), (700, 20), (9000, 10),
                                     (9700, 0)]
    else:
        th, tw, corners = 900, 700, [(c * 600, r * 800) for r in range(3)
                                     for c in range(2)]
    n = len(corners)
    data = torch.tensor(rng.randint(0, 255, (n, th, tw, 3)).astype(
        np.float32), device=device)
    masks = torch.full((n, th, tw), 255.0, device=device)
    from stitching_tpu_torch.compose import TileStack

    return TileStack(data, masks, np.asarray(corners, np.int64),
                     np.asarray([(tw, th)] * n, np.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("name,kind,stream_fetch", [
    ("x", "multiband", False), ("x", "multiband", True),
    ("x", "feather", True), ("x", "no", False), ("y", "multiband", True),
    ("y", "feather", False), ("mono", "multiband", True),
    ("mono", "feather", True)])
def test_over_budget_blend_cuda_close_to_monolithic(cuda_device, name, kind,
                                                     stream_fetch):
    from stitching_tpu_torch import compose

    stack = _strip_stack(name, cuda_device)
    mono, mono_mask = compose.blend_stack(stack, None, kind, 5)
    got, got_mask = compose.blend_stack(stack, None, kind, 5,
                                        stream_fetch=stream_fetch,
                                        budget=20e6)
    if stream_fetch:
        assert isinstance(got, np.ndarray)
    else:
        got, got_mask = got.cpu().numpy(), got_mask.cpu().numpy()
    mono = mono.cpu().numpy()
    assert got.shape == mono.shape
    diff = np.abs(got.astype(np.int16) - mono.astype(np.int16))
    assert diff.max() <= 1
    assert np.array_equal(got_mask, mono_mask.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["multiband", "feather", "no"])
@pytest.mark.parametrize("frontier", [False, True])
def test_stream_composite_cuda_equals_blend_stack(cuda_device, kind,
                                                  frontier):
    """Fed in image order on the card, with or without the column
    frontier's side-stream copies, the streamed composite equals the
    batched blend."""
    from stitching_tpu_torch import compose

    stack = _strip_stack("x", cuda_device)
    pano, mask = compose.blend_stack(stack, None, kind, 5)
    th, tw = stack.data.shape[1:3]
    p = compose._plan_blend(stack.corners, stack.sizes, len(stack.sizes),
                            kind, 5, th, tw)
    stream = compose.StreamComposite(p, frontier_fetch=frontier,
                                     device=cuda_device)
    for i in range(stack.data.shape[0]):
        stream.feed(i, stack.data[i], stack.masks[i])
    got, got_mask = stream.finish(stream_fetch=True)
    assert isinstance(got, np.ndarray)
    assert np.array_equal(got, pano.cpu().numpy())
    assert np.array_equal(got_mask, mask.cpu().numpy())


@pytest.fixture
def landed_bands(monkeypatch):
    """Every band `compose._HostFetch` is given, kept on the card as it
    was submitted: (axis, lo, pano part, mask part)."""
    from stitching_tpu_torch import compose

    seen = []
    submit = compose._HostFetch.submit

    def keeping(self, axis, lo, seg, wseg=None):
        seen.append((axis, lo, *(None if t is None else t.clone()
                                 for t in (seg, wseg))))
        submit(self, axis, lo, seg, wseg)

    monkeypatch.setattr(compose._HostFetch, "submit", keeping)
    return seen


def _assembled_on_the_card(bands, pano_shape):
    """The submitted bands written into zeroed tensors on the card, the
    host assembly's arithmetic: (pano, mask or None)."""
    dev = next(t for b in bands for t in b[2:] if t is not None).device
    out = [torch.zeros(pano_shape, dtype=torch.uint8, device=dev),
           torch.zeros(pano_shape[:2], dtype=torch.uint8, device=dev)]
    has_mask = any(w is not None for *_, w in bands)
    for axis, lo, *parts in bands:
        for dst, part in zip(out, parts):
            if part is not None:
                n = part.shape[axis]
                (dst[lo:lo + n] if axis == 0 else dst[:, lo:lo + n]).copy_(
                    part)
    return out[0].cpu().numpy(), (out[1].cpu().numpy() if has_mask
                                  else None)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", [True, False])
@pytest.mark.parametrize("kind", ["multiband", "feather", "no"])
@pytest.mark.parametrize("frontier", [False, True])
def test_stream_composite_cuda_lands_bands_in_place(cuda_device, landed_bands,
                                                    frontier, kind, mask):
    """Column bands (the frontier) and row bands (`stream_fetch`) land in
    one pinned host panorama equal to the batched blend value for value,
    with the mask or without it, and `fetch/bands_in_place` counts each
    panorama band."""
    from stitching_tpu_torch import compose, profiling

    stack = _strip_stack("x", cuda_device)
    pano, wmask = compose.blend_stack(stack, None, kind, 5)
    th, tw = stack.data.shape[1:3]
    p = compose._plan_blend(stack.corners, stack.sizes, len(stack.sizes),
                            kind, 5, th, tw)
    stream = compose.StreamComposite(p, frontier_fetch=frontier,
                                     device=cuda_device)
    for i in range(stack.data.shape[0]):
        stream.feed(i, stack.data[i], stack.masks[i])
    profiling.reset()
    profiling.enable()
    try:
        got, got_mask = stream.finish(stream_fetch=True, mask=mask)
        landed = profiling.get_counters().get("fetch/bands_in_place")
    finally:
        profiling.enable(False)
        profiling.reset()
    assert isinstance(got, np.ndarray) and got.flags["C_CONTIGUOUS"]
    assert np.array_equal(got, pano.cpu().numpy())
    bands = [b for b in landed_bands if b[2] is not None]
    assert {b[0] for b in bands} == {1 if frontier else 0}
    # the frontier's columns leave in bands; this canvas is one row band
    assert landed == len(bands) >= (2 if frontier else 1)
    if mask:
        assert np.array_equal(got_mask, wmask.cpu().numpy())
    else:
        assert got_mask is None
        assert all(b[3] is None for b in landed_bands)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kind", [
    ("x", "multiband"), ("x", "feather"), ("y", "multiband"),
    ("y", "no"), ("mono", "multiband"), ("mono", "feather"),
    ("gap", "multiband")])
def test_over_budget_blend_cuda_lands_bands_in_place(cuda_device,
                                                     landed_bands, name,
                                                     kind):
    """X and Y strips and the streamed monolithic blend land their bands
    in place: the host panorama and mask equal the submitted bands
    written on the card value for value, and the strips equal their own
    assembly on the card (`stream_fetch=False`)."""
    from stitching_tpu_torch import compose

    stack = _strip_stack(name, cuda_device)
    got, got_mask = compose.blend_stack(stack, None, kind, 5,
                                        stream_fetch=True, budget=20e6)
    assert len(landed_bands) >= 2
    want, want_mask = _assembled_on_the_card(landed_bands, got.shape)
    assert np.array_equal(got, want)
    assert np.array_equal(got_mask, want_mask)
    if name != "mono":
        dev, dev_mask = compose.blend_stack(stack, None, kind, 5,
                                            stream_fetch=False, budget=20e6)
        assert np.array_equal(got, dev.cpu().numpy())
        assert np.array_equal(got_mask, dev_mask.cpu().numpy())


def _rot6(seed, k, device):
    """A set of the `rot6-12mp` traffic: six 12 MP views on the host."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark import generators
    from benchmark.manifest import Manifest

    views, _ = generators.make(Manifest().traffic("rot6-12mp"),
                               generators.set_seed(seed, k), device)
    return views


@pytest.mark.cuda
def test_held_panorama_survives_later_stitches(cuda_device):
    """`Stitcher.stitch` returns a view of a pinned host panorama whose
    block the caching host allocator hands out again once it is let go. A
    panorama the caller holds stays as it was through later stitches, and
    a stitch that lands in the freed block of another set's panorama (not
    zeroed) gives the panorama a fresh block gave."""
    from stitching_tpu_torch import Stitcher

    set_a, set_b = (_rot6(2400000017, k, cuda_device) for k in (0, 1))
    st = Stitcher(device=cuda_device)
    pano = st.stitch(set_b)
    want_b = pano.copy()
    del pano                          # its block goes back to the cache
    held = st.stitch(set_a)           # may land in set b's block
    want_a = held.copy()
    again = st.stitch(set_b)          # the held block is not handed out
    assert np.array_equal(held, want_a)
    _near(again, want_b, 0.999)
    del held, again
    stats = getattr(torch.cuda, "host_memory_stats", dict)
    before = stats()
    for _ in range(2):                # each lands in a freed block
        _near(st.stitch(set_b), want_b, 0.999)
    print("pinned host allocations", before.get("num_host_alloc"), "->",
          stats().get("num_host_alloc"))


def _host_blocks():
    """(pinned blocks made, their bytes held) of the caching host
    allocator."""
    s = torch.cuda.host_memory_stats()
    return s.get("num_host_alloc", 0), s.get("allocated_bytes.current", 0)


@pytest.mark.cuda
def test_held_panoramas_keep_their_pinned_blocks(cuda_device):
    """Each panorama the caller holds keeps a pinned host block of at
    least its bytes. Once they are dropped, the caching host allocator
    keeps the blocks, and later stitches land in them and page-lock
    nothing new; `torch.accelerator.empty_host_cache()`, where this
    PyTorch has it, hands the cached blocks back."""
    from stitching_tpu_torch import Stitcher

    views = _rot6(2400000021, 0, cuda_device)
    st = Stitcher(device=cuda_device)
    st.stitch(views)                      # its block goes back to the cache
    rows = [("warm", *_host_blocks())]
    held = []
    for k in range(1, 5):
        held.append(st.stitch(views))
        rows.append((f"held {k}", *_host_blocks()))
    nbytes = held[0].nbytes
    assert rows[-1][2] >= 4 * nbytes
    del held
    rows.append(("dropped", *_host_blocks()))
    for _ in range(3):
        st.stitch(views)
    rows.append(("3 more, not held", *_host_blocks()))
    empty = getattr(getattr(torch, "accelerator", None), "empty_host_cache",
                    None)
    if empty is not None:
        empty()
        rows.append(("emptied", *_host_blocks()))
    print("held panoramas of", nbytes, "bytes: (step, blocks made, bytes "
          "held)", rows)
    assert rows[5][1:] == rows[6][1:] == rows[4][1:]
    if empty is not None:
        assert rows[7][2] <= rows[6][2] - 4 * nbytes


@pytest.mark.cuda
def test_dropped_fetch_waits_on_its_copies(cuda_device):
    """A fetch dropped between `submit` and `assemble` (a stitch that
    failed) ends its copies before its pinned block can be handed out
    again."""
    from stitching_tpu_torch import compose

    band = torch.full((4096, 4096, 3), 9, dtype=torch.uint8,
                      device=cuda_device)
    fetch = compose._HostFetch(cuda_device, 4096, 4096, 3)
    fetch.submit(0, 0, band)
    done = fetch.done
    del fetch
    assert done.query()


# ---------------------------------------------------------------------------
# Slice 8: the step-by-step component API on the card against the same
# calls on the CPU (`test_torch_*_api.py` hold the CPU runs against the
# JAX package)
# ---------------------------------------------------------------------------

def _views(n=3, size=(192, 144), focal=180.0, seed=3):
    """Rendered textures of three yawed views and their cameras."""
    from stitching_tpu_torch.types import CameraParams

    rng = np.random.RandomState(seed)
    w, h = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs, cams = [], []
    for i, a in enumerate((-0.3, 0.0, 0.3)[:n]):
        img = np.stack([127 + 90 * np.sin((xx + 60 * i) / (6 + c)
                                          + yy / 9.0) for c in range(3)], -1)
        img = img * (0.8 + 0.2 * i) + rng.rand(h, w, 3) * 25
        imgs.append(np.clip(img, 0, 255).astype(np.uint8))
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]], np.float32)
        cams.append(CameraParams(focal, 1.0, w / 2, h / 2, R))
    return imgs, cams


def _warped(device, size=(192, 144), focal=180.0, surface="spherical"):
    from stitching_tpu_torch.warper import Warper

    imgs, cams = _views(size=size, focal=focal)
    w = Warper(surface, device=device)
    w.set_scale(cams)
    sizes = [size] * len(imgs)
    corners, _ = w.warp_rois(sizes, cams)
    return (list(w.warp_images(imgs, cams)),
            list(w.create_and_warp_masks(sizes, cams)), corners)


def _near(a, b, share=0.999):
    assert a.shape == b.shape and a.dtype == b.dtype
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= share


@pytest.mark.cuda
@pytest.mark.parametrize("surface", ["spherical", "cylindrical", "plane",
                                     "fisheye"])
def test_warper_per_image_cuda_close_to_cpu(cuda_device, surface):
    """`warp_image` and `create_and_warp_mask` on the card against the
    CPU: masks equal, uint8 images within 1 LSB at 99.99% equal (the
    card's transcendentals differ from the CPU's in the last bit)."""
    gi, gm, gc = _warped(cuda_device, surface=surface)
    ci, cm, cc = _warped("cpu", surface=surface)
    assert gc == cc
    for a, b in zip(gm, cm):
        assert np.array_equal(a, b)
    for a, b in zip(gi, ci):
        _near(a, b, 0.9999)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["no", "feather", "multiband"])
def test_blender_backends_cuda_close_to_cpu(cuda_device, kind):
    """Each backend fed the same warps on both devices: the masks equal,
    the panorama within 1 LSB at 99.99% equal."""
    from stitching_tpu_torch.blender import Blender

    imgs, masks, corners = _warped("cpu")
    sizes = [(m.shape[1], m.shape[0]) for m in masks]
    out = []
    for dev in (cuda_device, "cpu"):
        b = Blender(kind, device=dev)
        b.prepare(corners, sizes)
        for img, mask, corner in zip(imgs, masks, corners):
            b.feed(img, mask, corner)
        out.append(b.blend())
        assert b.blender.device.type == torch.device(dev).type
    assert np.array_equal(out[0][1], out[1][1])
    _near(out[0][0], out[1][0], 0.9999)


@pytest.mark.cuda
@pytest.mark.parametrize("finder", ["dp_color", "dp_colorgrad", "voronoi",
                                    "gc_color"])
def test_seam_find_cuda_equals_cpu(cuda_device, finder):
    """`SeamFinder.find` on the card equals the CPU's masks, and so does
    `resize` against a FINAL mask."""
    from stitching_tpu_torch.seam_finder import SeamFinder

    imgs, masks, corners = _warped("cpu")
    got = SeamFinder(finder, device=cuda_device).find(imgs, corners, masks)
    want = SeamFinder(finder, device="cpu").find(imgs, corners, masks)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    _, fmasks, _ = _warped("cpu", size=(384, 288), focal=360.0)
    for seam, mask in zip(want, fmasks):
        assert np.array_equal(SeamFinder.resize(seam, mask, cuda_device),
                              SeamFinder.resize(seam, mask, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,nr_feeds", [("gain_blocks", 1),
                                           ("channel_blocks", 1),
                                           ("gain", 2), ("channel", 1)])
def test_compensator_apply_cuda_close_to_cpu(cuda_device, kind, nr_feeds):
    """`feed` on LOW warps and `apply` to FINAL warps on both devices: the
    gains and gain maps to 1e-4, the compensated warps within 1 LSB at
    99.9% equal."""
    from stitching_tpu_torch.exposure_error_compensator import (
        ExposureErrorCompensator)

    limgs, lmasks, lcorners = _warped("cpu")
    fimgs, fmasks, fcorners = _warped("cpu", size=(384, 288), focal=360.0)
    comps = []
    for dev in (cuda_device, "cpu"):
        comp = ExposureErrorCompensator(kind, nr_feeds, device=dev)
        comp.feed(lcorners, limgs, lmasks)
        comps.append(comp)
    if kind in ("gain", "channel"):
        np.testing.assert_allclose(comps[0]._gains, comps[1]._gains,
                                   atol=1e-4)
    else:
        for a, b in zip(comps[0]._block_state[2], comps[1]._block_state[2]):
            np.testing.assert_allclose(a, b, atol=1e-4)
    for idx, (img, mask, corner) in enumerate(zip(fimgs, fmasks, fcorners)):
        _near(comps[0].apply(idx, corner, img, mask),
              comps[1].apply(idx, corner, img, mask))


# ---------------------------------------------------------------------------
# The mesh on the card: one NCCL rank in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_mesh(cuda_device):
    """A world of one in this process (NCCL), torn down afterwards."""
    import torch.distributed as dist

    from stitching_tpu_torch.parallel.mesh import make_mesh

    assert not dist.is_initialized()
    m = make_mesh()
    yield m
    dist.destroy_process_group()


@pytest.mark.cuda
def test_mesh_one_rank_stitch_cuda(nccl_mesh):
    """`Stitcher(mesh=)` on one NCCL rank launches both kernels, and at
    the mesh run's cameras the non-mesh composite gives its panorama
    (shape, crop rects, within 1 LSB, at least 99.9% equal)."""
    import copy

    from chip_smoke import rotation_set
    from stitching_tpu_torch import Stitcher, engine
    from stitching_tpu_torch.ops.kernels import bilinear_sample as bs
    from stitching_tpu_torch.ops.kernels import two_nn as nn

    assert nccl_mesh.backend == "nccl" and nccl_mesh.size == 1
    imgs, _ = rotation_set(3, (640, 480), 600.0, 0.5, nccl_mesh.device)
    st = Stitcher(mesh=nccl_mesh)
    nn.two_nn_pairs.launches = bs.bilinear_sample.launches = 0
    reg = engine.register(st, imgs)
    cams = [c.copy() for c in reg.cameras]
    plan = engine.plan_composition(st, reg)
    rects = [tuple(r) for r in plan.crop_rects]
    got = engine.composite(st, reg, plan)
    assert nn.two_nn_pairs.launches >= 1
    assert bs.bilinear_sample.launches >= 1
    ref = Stitcher()
    reg = copy.copy(engine.register(ref, imgs))
    reg.cameras = cams
    ref.warper.set_scale(cams)
    reg.scale = ref.warper.scale
    plan = engine.plan_composition(ref, reg)
    assert [tuple(r) for r in plan.crop_rects] == rects
    _near(got, engine.composite(ref, reg, plan))


@pytest.mark.cuda
def test_match_stack_dispatch_mesh_cuda(nccl_mesh):
    """The pair axis through the mesh on the card equals the unsharded
    call, each launching the 2-NN kernel once."""
    from stitching_tpu_torch import pipeline

    desc, valid, _ = _descriptors("ties")
    rng = np.random.RandomState(1)
    feats = dict(desc=torch.as_tensor(desc, device=nccl_mesh.device),
                 valid=valid,
                 xy=(rng.rand(*valid.shape, 2) * 300).astype(np.float32))
    sizes = np.full((len(desc), 2), 320.0, np.float32)
    two_nn_pairs.launches = 0
    pairs, want = pipeline.match_stack(feats, sizes)
    assert two_nn_pairs.launches == 1
    pairs_m, got = pipeline.match_stack(feats, sizes, mesh=nccl_mesh)
    assert two_nn_pairs.launches == 2
    np.testing.assert_array_equal(pairs_m, pairs)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# A multi-row capture: `Stitcher()` on the grid cell's 12 MP sets
# ---------------------------------------------------------------------------

# seed:set of `benchmark/traffic/grid18-12mp.json` that the card bent
# (51-93 px) before minimal samples that fold were dropped
# (`ops/ransac._orientation_kept`); the first bent on the card alone
GRID_BENT = [(2200002006, 0), (2200002002, 1), (2200002004, 2),
             (2200003004, 1)]


def _grid(seed, k, device):
    """The grid cell's set: (views on the host, truth, sizes, the cell's
    settings and limits)."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark import generators
    from benchmark.manifest import Manifest

    man = Manifest()
    cell = man.workload("pano-default.grid18-12mp")
    views, truth = generators.make(man.traffic(cell["traffic"]),
                                   generators.set_seed(seed, k), device)
    return (views, truth, [(v.shape[1], v.shape[0]) for v in views],
            man.config(cell["config"])["reference"], man.limits(cell["name"]))


def _registered(views, device):
    """`Stitcher()`'s registration of the views: cameras as dicts."""
    from stitching_tpu_torch import Stitcher, engine

    reg = engine.register(Stitcher(device=device), views)
    return [dict(focal=float(c.focal), aspect=float(c.aspect),
                 ppx=float(c.ppx), ppy=float(c.ppy),
                 R=np.asarray(c.R, np.float64)) for c in reg.cameras]


@pytest.mark.cuda
@pytest.mark.parametrize("seed,k", GRID_BENT)
def test_grid_set_registers_on_the_card(cuda_device, seed, k):
    from benchmark import reference

    views, truth, sizes, settings, limits = _grid(seed, k, cuda_device)
    cams = _registered(views, cuda_device)
    assert len(cams) == 18
    err = reference.registration_error_px(cams, truth, sizes, settings)
    assert err < limits["reg_err_px"], err


@pytest.mark.cuda
def test_grid_card_cameras_agree_with_the_cpu_run(cuda_device):
    """The set that bent on the card alone (74.85 px there, 4.03 on the
    CPU): the card's cameras and the CPU run's, on the same host views,
    map every view into each grid neighbour within half the cell's limit
    of each other, and each within the limit of the truth."""
    from benchmark import reference

    views, truth, sizes, settings, limits = _grid(*GRID_BENT[0], cuda_device)
    card = _registered(views, cuda_device)
    cpu = _registered(views, torch.device("cpu"))
    for cams in (card, cpu):
        assert len(cams) == 18
        assert reference.registration_error_px(
            cams, truth, sizes, settings) < limits["reg_err_px"]
    pairs = reference.neighbour_pairs(truth, 18)
    a = reference._program_maps(card, sizes, settings, pairs)
    b = reference._program_maps(cpu, sizes, settings, pairs)
    far = max(np.linalg.norm(
        reference._apply(a[p], reference._grid(sizes[p[0]]))
        - reference._apply(b[p], reference._grid(sizes[p[0]])), axis=1).max()
        for p in a)
    assert far < limits["reg_err_px"] / 2, far
