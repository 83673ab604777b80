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
from stitching_tpu_torch.ops.kernels import two_nn as two_nn_mod
from stitching_tpu_torch.ops.kernels.two_nn import (PAIRS_PAD, ROWS_PAD,
                                                    _top2,
                                                    hamming_from_words,
                                                    launch_plan,
                                                    pack_bits_plain,
                                                    top2_by_segments, two_nn,
                                                    two_nn_pairs,
                                                    two_nn_pairs_plain,
                                                    two_nn_plain)
from test_torch_cuda import (_descriptors, _float_descriptors,
                             _rect_descriptors, assert_two_nn_close)

torch.set_num_threads(2)


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


@pytest.mark.parametrize("d", [257, 486, 512])
def test_binary_plain_wide_rows_equal_pallas(d):
    """BRISK's 512 bits, AKAZE's 486 and an uneven 257: both plain
    versions equal the Pallas kernels exactly (invalid targets, planted
    duplicates, a pair of an image with itself)."""
    rng = np.random.RandomState(d)
    desc = (rng.rand(3, 61, d) > 0.5).astype(np.float32)
    desc[1, 10:20] = desc[1, 0:10]
    desc[2, :15] = desc[0, 20:35]
    valid = rng.rand(3, 61) > 0.1
    pairs = np.asarray([[0, 1], [0, 2], [1, 2], [1, 1]], np.int32)
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
    ref = _pallas_two_nn(desc[0], desc[2], valid[2], True)
    for r, g in zip(ref, _plain_two_nn(desc[0], desc[2], valid[2], True)):
        np.testing.assert_array_equal(g, r)


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


# ---- the CUDA kernels' inner steps, as plain functions -----------------

def _pair_distances(desc, valid, pairs):
    """The (P, 2, N, N) distance tensor `two_nn_pairs_plain` reduces."""
    desc, valid = torch.as_tensor(desc), torch.as_tensor(valid)
    pij = torch.as_tensor(pairs).long()
    norms = desc.sum(-1)
    tadj = norms + torch.where(valid, 0.0, two_nn_mod.BIG)
    prod = torch.matmul(desc[pij], desc[pij.flip(1)].transpose(-1, -2))
    return (norms[pij][..., None] + tadj[pij.flip(1)][..., None, :]
            - 2.0 * prod)


def _segment_width(n, segments):
    return -(-n // segments)


@pytest.mark.parametrize("segments", [1, 2, 3, 8, 63])
@pytest.mark.parametrize("case", ["random", "ties", "all_invalid"])
def test_top2_by_segments_equals_top2(case, segments):
    """Per-segment ordered top-2s merged by the kernels' rule give what the
    distance-matrix formula gives, exactly, `i0` included."""
    desc, valid, pairs = _descriptors(case)
    dist = _pair_distances(desc, valid, pairs)
    n = dist.shape[-1]
    got = top2_by_segments(dist, n, PAIRS_PAD, _segment_width(n, segments))
    for g, r in zip(got, _top2(dist, n, PAIRS_PAD)):
        assert g.dtype == r.dtype and torch.equal(g, r)
    for g, r in zip(got, two_nn_pairs_plain(
            torch.as_tensor(desc), torch.as_tensor(valid),
            torch.as_tensor(pairs))):
        assert torch.equal(g, r)


@pytest.mark.parametrize("segments", [1, 2, 3, 8, 63])
@pytest.mark.parametrize("nt", [1, 7, 9, 237, 256])
def test_top2_by_segments_duplicates_across_segment_edges(nt, segments):
    """Duplicate nearest targets on both sides of every segment edge: the
    lower column wins and d1 = d0, for any number of targets (with and
    without a padded column under `two_nn`'s padding to 128)."""
    rng = np.random.RandomState(nt + segments)
    dist = torch.as_tensor(rng.randint(5, 40, (23, nt)).astype(np.float32))
    seg = _segment_width(nt, segments)
    dist[:, rng.rand(nt) < 0.1] = two_nn_mod.BIG
    for k, edge in enumerate(range(seg, nt, seg)):
        dist[k % 23, edge - 1] = dist[k % 23, edge] = 1.0 + (k // 23)
    dist[22] = two_nn_mod.BIG               # a row with no valid target
    got = top2_by_segments(dist, nt, ROWS_PAD, seg)
    ref = _top2(dist, nt, ROWS_PAD)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert int(got[2][22]) == 0 and float(got[0][22]) >= 1e29
    if nt > seg and float(dist[0, seg]) == 1.0:
        assert int(got[2][0]) == seg - 1 and float(got[1][0]) == 1.0


@pytest.mark.parametrize("d", [32, 100, 256, 257, 486, 512])
def test_packed_words_give_the_plain_hamming_distances(d):
    """The packer and `s_q + s_t - 2 popc(q & t)` on packed words equal the
    Hamming distances the plain version takes from a float product."""
    rng = np.random.RandomState(d)
    q = torch.as_tensor((rng.rand(37, d) > 0.5).astype(np.float32))
    t = torch.as_tensor((rng.rand(53, d) > 0.5).astype(np.float32))
    q[5] = 0.0
    t[7] = 1.0
    q_words, q_count = pack_bits_plain(q)
    t_words, t_count = pack_bits_plain(t)
    assert q_words.shape == (37, 8 if d <= 256 else 16)
    assert int(q_words.max()) < 2 ** 32
    assert torch.equal(q_count, q.sum(-1)) and float(t_count[7]) == d
    # no bit past the row: an all-ones row sets d bits
    assert sum(bin(int(x)).count("1") for x in t_words[7]) == d
    got = hamming_from_words(q_words, q_count, t_words, t_count)
    plain = q.sum(-1)[:, None] + t.sum(-1)[None, :] - 2.0 * (q @ t.t())
    assert torch.equal(got, plain)
    assert torch.equal(got, (q[:, None, :] != t[None]).sum(-1).float())
    vt = torch.as_tensor(rng.rand(53) > 0.2)
    dist = torch.where(vt[None, :], got, two_nn_mod.BIG)
    for g, r in zip(_top2(dist, 53, ROWS_PAD), two_nn_plain(q, t, vt)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("d", [256, 257, 512])
def test_packed_words_follow_the_kernel_layout(d):
    """Column c is bit (c % 128) // 4 of k-word w = 4 (c // 128) + c % 4,
    and k-word w = 4 q + t sits at position t W / 4 + q: a row with one
    column set packs to one bit there."""
    W = 8 if d <= 256 else 16
    for c in (0, 1, 3, 4, 127, 128, 130, 255, d - 1):
        row = torch.zeros(d)
        row[c] = 1.0
        words, count = pack_bits_plain(row)
        w = 4 * (c // 128) + c % 4
        want = torch.zeros(W, dtype=torch.int64)
        want[(w % 4) * (W // 4) + w // 4] = 1 << ((c % 128) // 4)
        assert torch.equal(words, want) and float(count) == 1.0


@pytest.mark.parametrize("nq,nt,batch", [
    (500, 500, 56), (500, 500, 1), (1, 1, 1), (1, 9000, 1), (513, 4097, 1),
    (17, 65, 2), (9000, 63, 1), (500, 500, 5000), (3, 200000, 1),
    (100000, 200000, 1)])
@pytest.mark.parametrize("is_binary", [True, False])
def test_launch_plan_covers_the_targets(nq, nt, batch, is_binary):
    """Whole 64-target units, every segment non-empty, the target axis
    covered; the larger tile only where it gives every SM a block; a split
    only where the blocks are short of the kernel's target (or a segment
    would outgrow the kernel's column field), and no finer than needed."""
    _check_plan(nq, nt, batch, is_binary, None)


@pytest.mark.parametrize("nq,nt,batch", [
    (1024, 1024, 56), (1024, 1024, 1), (500, 500, 56), (1, 1, 1),
    (70, 1300, 1), (513, 4097, 1), (3, 200000, 1), (100000, 200000, 1)])
@pytest.mark.parametrize("d", [257, 486, 512])
def test_launch_plan_covers_the_targets_wide_rows(nq, nt, batch, d):
    """`test_launch_plan_covers_the_targets` for binary rows over 256 bits,
    whose blocks may take 256 query rows (four tiles a warp)."""
    assert two_nn_mod.rows_per_block_choices(True, d) == (256, 64)
    _check_plan(nq, nt, batch, True, d)


def _check_plan(nq, nt, batch, is_binary, d):
    rows, splits, seg = launch_plan(nq, nt, batch, 132, is_binary, d)
    choices = two_nn_mod.rows_per_block_choices(is_binary, d)
    assert rows in choices and seg % two_nn_mod.SPLIT_UNIT == 0
    assert (splits - 1) * seg < nt <= splits * seg
    assert seg <= two_nn_mod.MAX_SEGMENT[is_binary]
    blocks = -(-nq // rows) * batch
    assert blocks >= 132 or rows == choices[-1]
    want = two_nn_mod.BLOCKS_PER_SM[is_binary] * 132
    if splits > 1 and nt <= two_nn_mod.MAX_SEGMENT[is_binary]:
        assert blocks < want
        assert blocks * -(-splits // 2) < want or seg == 64
    scratch = two_nn_mod._scratch(torch.device("cpu"), 10 * (nq + nt), nq,
                                  batch, splits)
    assert scratch.dtype == torch.int32
    assert scratch.numel() == (10 * (nq + nt)
                               + (3 * splits * batch * nq if splits > 1
                                  else 0))
    assert two_nn_mod.kernel_launches(splits) == (3 if splits > 1 else 2)


def test_launch_plan_at_the_paths_shapes():
    """28 pairs of 500 binary rows fill the card without a split and the
    float kernel takes its 128-row tile there, in 4 segments; one pair of
    500 x 500 takes 64-row blocks and 8 segments of 64 targets."""
    assert launch_plan(500, 500, 56, 132, True) == (64, 1, 512)
    assert launch_plan(500, 500, 56, 132, False) == (128, 4, 128)
    assert launch_plan(500, 500, 1, 132, True) == (64, 8, 64)
    assert launch_plan(500, 500, 1, 132, False) == (64, 8, 64)
    # BRISK's and AKAZE's 28 pairs of 1024 rows of 512 bits: four tiles a
    # warp, no split; a pair of them per `two_nn` call: 64-row blocks
    assert launch_plan(1024, 1024, 56, 132, True, 512) == (256, 1, 1024)
    assert launch_plan(500, 500, 56, 132, True, 256) == (64, 1, 512)
    assert launch_plan(1024, 1024, 1, 132, True, 512) == (64, 8, 128)


def test_library_path_follows_the_shared_header(tmp_path, monkeypatch):
    """A kernel's library is keyed by its source, every header beside it and
    the flags: an edit to `top2.cuh` rebuilds both 2-NN libraries, an edit
    to one source only that one."""
    import shutil

    from stitching_tpu_torch.ops import kernels

    shutil.copytree(kernels.CSRC, tmp_path / "csrc")
    monkeypatch.setattr(kernels, "CSRC", str(tmp_path / "csrc"))
    names = ("two_nn", "two_nn_float", "bilinear_sample")
    before = {n: kernels.library_path(n) for n in names}
    assert len(set(before.values())) == len(names)
    assert before == {n: kernels.library_path(n) for n in names}
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-DX",))
    assert kernels.library_path("two_nn") != before["two_nn"]
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS[:-1])
    assert kernels.library_path("two_nn") == before["two_nn"]
    with open(tmp_path / "csrc" / "two_nn.cu", "a") as fh:
        fh.write("// edited\n")
    after = {n: kernels.library_path(n) for n in names}
    assert after["two_nn"] != before["two_nn"]
    assert after["two_nn_float"] == before["two_nn_float"]
    with open(tmp_path / "csrc" / "top2.cuh", "a") as fh:
        fh.write("// edited\n")
    assert all(kernels.library_path(n) != after[n] for n in names)
