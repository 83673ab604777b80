"""2-nearest-neighbour descriptor search.

Port of `stitching_tpu/ops/pallas/two_nn.py`:

- `two_nn_pairs`: for every pair p = (i, j) and both directions ([:, 0]: i
  queries j, [:, 1]: j queries i), the batched matcher's inner loop;
- `two_nn`: one query set against one target set, the per-pair matcher's
  (`ops/match.py::match_pair`).

Per query row, `d0` is the smallest distance to a valid target, `i0` the
lowest column attaining it and `d1` the smallest over the other columns.
Distances are Hamming counts (binary, {0,1} float rows) or squared L2
clamped at 0 (float; the caller takes the root). Invalid targets sit at
1e30; queries are not masked. The target axis behaves as if padded with
invalid columns, as the TPU kernels pad it: `two_nn_pairs` to a multiple
of 8, `two_nn` to a multiple of 128, so `d1 <= 1e30` whenever a padded
column exists.

Each wrapper launches its CUDA kernel (`csrc/two_nn.cu` for binary,
`csrc/two_nn_float.cu` for float descriptors) for tensors on the card and
runs its plain version for tensors on the CPU. The float kernel sums the
products in another order than the plain version's matmul: d0 and d1 agree
within 1e-3 relative + 1e-3 absolute, and i0 wherever the plain d1 - d0
exceeds that. The binary kernels equal the plain versions bit for bit.

A call on the card launches a pre-pass over the operand rows (bit packing
or norms) and the search. `launch_plan` picks the search's grid: the
query rows a block takes and, where the query rows alone give too few
blocks for the card, a split of the target axis whose partial top-2s a
third small launch merges (`csrc/top2.cuh`); `kernel_launches` says how
many kernels a call launches under a plan. `top2_by_segments`,
`pack_bits_plain` and `hamming_from_words` are plain versions of the
kernels' inner steps, for the CPU tests.
"""

import torch

from . import check, load, stream_ptr

BIG = 1.0e30
PAIRS_PAD = 8      # two_nn_pairs pads the target axis to a multiple of this
ROWS_PAD = 128     # two_nn does, to a multiple of this
MAX_BINARY_BITS = 512
SPLIT_UNIT = 64     # the target axis splits into multiples of this
# per kernel (keyed by is_binary): the query rows a block may take, largest
# first (the float kernel has a 128-row and a 64-row tile); the blocks per
# SM that `launch_plan` splits the target axis to reach; and the most
# targets a segment may hold (the binary kernel keeps a column in 16 bits of
# its fold key)
ROWS_PER_BLOCK = {True: (64,), False: (128, 64)}
BLOCKS_PER_SM = {True: 1, False: 6}
MAX_SEGMENT = {True: 1 << 16, False: 1 << 30}
# the binary kernel on rows of 16 words (over 256 bits): a warp may take four
# 16-row tiles (a block 256 rows), which share every B fragment it reads
# from shared memory; rows of 64 bytes read twice the bytes per distance of
# rows of 32
WIDE_ROWS_PER_BLOCK = (256, 64)


def _round_up(x, m):
    return -(-x // m) * m


def _has_pad(n, m):
    return _round_up(max(n, m), m) > n


def _top2(dist, n, pad):
    """min, lowest-index argmin and masked min over the last axis of a
    distance matrix whose target axis is padded to a multiple of `pad`."""
    if _has_pad(n, pad):
        extra = _round_up(max(n, pad), pad) - n
        dist = torch.cat(
            [dist, dist.new_full(dist.shape[:-1] + (extra,), BIG)], dim=-1)
    n_p = dist.shape[-1]
    cols = torch.arange(n_p, device=dist.device)
    d0 = dist.min(dim=-1).values
    i0 = torch.where(dist == d0[..., None], cols, n_p).min(dim=-1).values
    d1 = torch.where(cols == i0[..., None], 3.0e38, dist).min(dim=-1).values
    return d0, d1, i0.clamp_max(n - 1).to(torch.int32)


def top2_by_segments(dist, n, pad, seg):
    """`_top2` the way the kernels take it: an ordered top-2 of every
    segment of `seg` columns (what a walk in column order with a strict
    `<` leaves: the minimum, its lowest column, the minimum over the other
    columns), the segments merged by `csrc/top2.cuh`'s rule (the lower d0
    wins, equal d0 goes to the lower column, d1 = min(winner's d1, loser's
    d0)), padding and clamp at the end."""
    shape = dist.shape[:-1]
    d0 = dist.new_full(shape, 3.0e38)
    d1 = dist.new_full(shape, 3.0e38)
    i0 = torch.full(shape, 0x7fffffff, dtype=torch.int64, device=dist.device)
    for a in range(0, n, seg):
        part = dist[..., a:min(a + seg, n)]
        cols = torch.arange(part.shape[-1], device=dist.device)
        s0 = part.min(dim=-1).values
        si = torch.where(part == s0[..., None], cols,
                         part.shape[-1]).min(dim=-1).values
        s1 = torch.where(cols == si[..., None], 3.0e38,
                         part).min(dim=-1).values
        si = si + a
        mine = (d0 < s0) | ((d0 == s0) & (i0 < si))
        d1 = torch.where(mine, torch.minimum(d1, s0), torch.minimum(s1, d0))
        d0 = torch.where(mine, d0, s0)
        i0 = torch.where(mine, i0, si)
    if _has_pad(n, pad):
        d1 = d1.clamp_max(BIG)
    return d0, d1, i0.clamp_max(n - 1).to(torch.int32)


def binary_words(d):
    """32-bit words of a packed binary row of `d` bits in the kernel: 8
    up to 256 bits (ORB), 16 up to 512 (BRISK, AKAZE)."""
    if not 0 < d <= MAX_BINARY_BITS:
        raise ValueError(f"binary rows take 1 to {MAX_BINARY_BITS} bits, "
                         f"not {d}")
    return 8 if d <= 256 else 16


def pack_bits_plain(desc):
    """A {0,1} float row of up to 512 columns packed as the binary kernel
    packs it, into `binary_words(D)` = W words of 32 bits: bit k of k-word w
    holds column 128 (w // 4) + 4 k + w % 4 (zero beyond the row; any order
    of the bits that every row shares gives the same distances), and k-word
    w = 4 q + t is stored at position t W / 4 + q, where the `mma`
    fragments of quad lane t read it. Returns the words (..., W) int64 in
    [0, 2^32) and the bit count (...,) float32."""
    bits = desc > 0.5
    D = bits.shape[-1]
    W = binary_words(D)
    pad = bits.new_zeros(bits.shape[:-1] + (32 * W - D,))
    # (..., i, k, j): column 128 i + 4 k + j, bit k of k-word 4 i + j
    bits = torch.cat([bits, pad], dim=-1).reshape(
        bits.shape[:-1] + (W // 4, 32, 4)).transpose(-1, -2)
    bits = bits.reshape(bits.shape[:-3] + (W, 32)).to(torch.int64)
    weights = 1 << torch.arange(32, dtype=torch.int64, device=desc.device)
    kwords = (bits * weights).sum(-1)
    w = torch.arange(W, device=desc.device)
    words = torch.empty_like(kwords)
    words[..., (w % 4) * (W // 4) + w // 4] = kwords
    return words, bits.sum((-1, -2)).to(torch.float32)


def _popcount(x):
    """Set bits of each int64 in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0f0f0f0f
    return ((x * 0x01010101) & 0xffffffff) >> 24


def hamming_from_words(q_words, q_count, t_words, t_count):
    """Hamming distances (Nq, Nt) float32 of packed rows by the kernel's
    formula: s_q + s_t - 2 popc(q & t)."""
    both = _popcount(q_words[:, None, :] & t_words[None, :, :]).sum(-1)
    return q_count[:, None] + t_count[None, :] - 2.0 * both.to(torch.float32)


def rows_per_block_choices(is_binary, d=None):
    """The query rows a search block may take, largest first, for rows of
    `d` columns (binary rows over 256 bits: `WIDE_ROWS_PER_BLOCK`)."""
    if is_binary and d is not None and binary_words(d) == 16:
        return WIDE_ROWS_PER_BLOCK
    return ROWS_PER_BLOCK[is_binary]


def launch_plan(nq, nt, batch, sm_count, is_binary, d=None):
    """The search kernels' grid for `batch` query sets of nq rows of `d`
    columns against nt targets: (query rows a block, target segments,
    targets a segment). The largest tile of `rows_per_block_choices` that
    still gives every SM a block, else the smallest; then, if that leaves
    fewer than `BLOCKS_PER_SM` blocks an SM, the target axis splits into
    equal segments of whole `SPLIT_UNIT`s until the blocks suffice or a
    segment is one unit. A segment never exceeds `MAX_SEGMENT`."""
    for rows in rows_per_block_choices(is_binary, d):
        blocks = -(-nq // rows) * batch
        if blocks >= sm_count:
            break
    units = -(-nt // SPLIT_UNIT)
    want = BLOCKS_PER_SM[is_binary] * sm_count
    splits = max(min(units, -(-want // blocks)),
                 -(-nt // MAX_SEGMENT[is_binary]))
    per_seg = -(-units // splits)
    return rows, -(-units // per_seg), per_seg * SPLIT_UNIT


def kernel_launches(splits):
    """Kernels one call on the card launches under a plan of `splits`
    target segments: the pre-pass, the search and, with a split target
    axis, the merge."""
    return 3 if splits > 1 else 2


def _scratch(dev, rows_units, nq, batch, splits):
    """The kernels' scratch (int32 units): `rows_units` for the pre-pass's
    outputs and, with a split target axis, the partial top-2s (splits,
    batch, nq, 3)."""
    partial = 3 * splits * batch * nq if splits > 1 else 0
    return torch.empty((rows_units + partial,), dtype=torch.int32, device=dev)


def _sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _norms(desc, is_binary):
    return desc.sum(dim=-1) if is_binary else (desc * desc).sum(dim=-1)


def two_nn_pairs_plain(desc, valid, pair_ij, *, is_binary=True):
    """The distance-matrix formula: min, lowest-index argmin, masked min.

    desc: (B, N, D) float32; valid: (B, N) bool; pair_ij: (P, 2) int.
    Returns d0, d1 (P, 2, N) float32 and i0 (P, 2, N) int32.
    """
    N = desc.shape[1]
    pair = pair_ij.long()
    qidx = pair                          # (P, 2): query image per direction
    tidx = pair.flip(1)                  # target image per direction
    norms = _norms(desc, is_binary)
    tadj = norms + torch.where(valid, 0.0, BIG)          # (B, N)
    q = desc[qidx]                                       # (P, 2, N, D)
    t = desc[tidx]
    prod = torch.matmul(q, t.transpose(-1, -2))          # (P, 2, N, N)
    dist = norms[qidx][..., None] + tadj[tidx][..., None, :] - 2.0 * prod
    if not is_binary:
        dist = dist.clamp_min(0.0)
    return _top2(dist, N, PAIRS_PAD)


def two_nn_plain(desc_q, desc_t, valid_t, *, is_binary=True):
    """`two_nn` by the distance-matrix formula.

    desc_q: (Nq, D) float32; desc_t: (Nt, D) float32; valid_t: (Nt,) bool.
    Returns d0, d1 (Nq,) float32 and i0 (Nq,) int32.
    """
    tadj = _norms(desc_t, is_binary) + torch.where(valid_t, 0.0, BIG)
    prod = torch.matmul(desc_q, desc_t.t())              # (Nq, Nt)
    dist = _norms(desc_q, is_binary)[:, None] + tadj[None, :] - 2.0 * prod
    if not is_binary:
        dist = dist.clamp_min(0.0)
    return _top2(dist, desc_t.shape[0], ROWS_PAD)


def _check_desc(name, desc, ndim, is_binary):
    if (desc.dim() != ndim or desc.dtype != torch.float32
            or not desc.is_contiguous()):
        raise ValueError(f"{name}: descriptors must be contiguous float32 "
                         f"with {ndim} axes")
    if is_binary and desc.shape[-1] > MAX_BINARY_BITS:
        raise ValueError(f"{name}: the binary kernel takes at most "
                         f"{MAX_BINARY_BITS} descriptor bits")


def two_nn_pairs(desc, valid, pair_ij, *, is_binary=True):
    """2-NN for every pair; the CUDA kernel on the card, the plain version
    on the CPU. See `two_nn_pairs_plain` for the contract."""
    if desc.device.type == "cpu":
        return two_nn_pairs_plain(desc, valid, pair_ij, is_binary=is_binary)
    _check_desc("two_nn_pairs", desc, 3, is_binary)
    B, N, D = desc.shape
    P = pair_ij.shape[0]
    if valid.shape != (B, N) or valid.dtype != torch.bool:
        raise ValueError("two_nn_pairs: valid must be (B, N) bool")
    if pair_ij.shape != (P, 2) or pair_ij.dtype != torch.int32:
        raise ValueError("two_nn_pairs: pair_ij must be (P, 2) int32")
    dev = desc.device
    if valid.device != dev or pair_ij.device != dev:
        raise ValueError("two_nn_pairs: all inputs on one device")
    valid = valid.contiguous()
    pair_ij = pair_ij.contiguous()
    d0 = torch.empty((P, 2, N), dtype=torch.float32, device=dev)
    d1 = torch.empty((P, 2, N), dtype=torch.float32, device=dev)
    i0 = torch.empty((P, 2, N), dtype=torch.int32, device=dev)
    if P == 0 or N == 0:
        return d0, d1, i0
    pad_col = int(_has_pad(N, PAIRS_PAD))
    with torch.cuda.device(dev):
        is_binary = bool(is_binary)
        rows, splits, seg = launch_plan(N, N, 2 * P, _sm_count(dev),
                                        is_binary, D)
        # per operand row: its packed words and two bit counts, or two norms
        per_row = binary_words(D) + 2 if is_binary else 2
        scratch = _scratch(dev, B * N * per_row, N, 2 * P, splits)
        entry = "two_nn_pairs_binary" if is_binary else "two_nn_pairs_float"
        status = load(entry)(
            desc.data_ptr(), valid.data_ptr(), pair_ij.data_ptr(),
            scratch.data_ptr(), scratch.numel(), d0.data_ptr(),
            d1.data_ptr(), i0.data_ptr(), B, N, D, P, pad_col, rows, splits,
            seg, stream_ptr(dev))
    check(status, "two_nn_pairs")
    two_nn_pairs.launches += 1
    return d0, d1, i0


two_nn_pairs.launches = 0


def two_nn(desc_q, desc_t, valid_t, *, is_binary=True):
    """2-NN of one query set against one target set; the CUDA kernel on
    the card (any number of targets: they are staged tile by tile), the
    plain version on the CPU. See `two_nn_plain` for the contract."""
    if desc_q.device.type == "cpu":
        return two_nn_plain(desc_q, desc_t, valid_t, is_binary=is_binary)
    _check_desc("two_nn", desc_q, 2, is_binary)
    _check_desc("two_nn", desc_t, 2, is_binary)
    nq, D = desc_q.shape
    nt = desc_t.shape[0]
    if desc_t.shape[1] != D:
        raise ValueError("two_nn: query and target descriptor widths differ")
    if valid_t.shape != (nt,) or valid_t.dtype != torch.bool:
        raise ValueError("two_nn: valid_t must be (Nt,) bool")
    dev = desc_q.device
    if desc_t.device != dev or valid_t.device != dev:
        raise ValueError("two_nn: all inputs on one device")
    if nt == 0:
        raise ValueError("two_nn: no targets")
    valid_t = valid_t.contiguous()
    d0 = torch.empty((nq,), dtype=torch.float32, device=dev)
    d1 = torch.empty((nq,), dtype=torch.float32, device=dev)
    i0 = torch.empty((nq,), dtype=torch.int32, device=dev)
    if nq == 0:
        return d0, d1, i0
    pad_col = int(_has_pad(nt, ROWS_PAD))
    with torch.cuda.device(dev):
        is_binary = bool(is_binary)
        rows, splits, seg = launch_plan(nq, nt, 1, _sm_count(dev), is_binary,
                                        D)
        per_row = binary_words(D) + 2 if is_binary else 1
        scratch = _scratch(dev, (nq + nt) * per_row, nq, 1, splits)
        status = load("two_nn_binary" if is_binary else "two_nn_float")(
            desc_q.data_ptr(), desc_t.data_ptr(), valid_t.data_ptr(),
            scratch.data_ptr(), scratch.numel(), d0.data_ptr(),
            d1.data_ptr(), i0.data_ptr(), nq, nt, D, pad_col, rows, splits,
            seg, stream_ptr(dev))
    check(status, "two_nn")
    two_nn.launches += 1
    return d0, d1, i0


two_nn.launches = 0
