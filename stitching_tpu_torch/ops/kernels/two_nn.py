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
"""

import torch

from . import check, load, stream_ptr

BIG = 1.0e30
PAIRS_PAD = 8      # two_nn_pairs pads the target axis to a multiple of this
ROWS_PAD = 128     # two_nn does, to a multiple of this
MAX_BINARY_BITS = 256


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
        raise NotImplementedError(
            f"{name}: the binary CUDA kernel takes at most "
            f"{MAX_BINARY_BITS} descriptor bits (ORB); wider binary "
            "descriptors come with BRISK/AKAZE (ROADMAP queue 1: "
            "SIFT/BRISK/AKAZE)")


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
        if is_binary:
            words = torch.empty((B, N, 8), dtype=torch.int32, device=dev)
            status = load("two_nn_pairs_binary")(
                desc.data_ptr(), valid.data_ptr(), pair_ij.data_ptr(),
                words.data_ptr(), d0.data_ptr(), d1.data_ptr(),
                i0.data_ptr(), B, N, D, P, pad_col, stream_ptr(dev))
        else:
            norm = torch.empty((2, B, N), dtype=torch.float32, device=dev)
            status = load("two_nn_pairs_float")(
                desc.data_ptr(), valid.data_ptr(), pair_ij.data_ptr(),
                norm[0].data_ptr(), norm[1].data_ptr(), d0.data_ptr(),
                d1.data_ptr(), i0.data_ptr(), B, N, D, P, pad_col,
                stream_ptr(dev))
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
        if is_binary:
            words = torch.empty((nq + nt, 8), dtype=torch.int32, device=dev)
            status = load("two_nn_binary")(
                desc_q.data_ptr(), desc_t.data_ptr(), valid_t.data_ptr(),
                words[:nq].data_ptr(), words[nq:].data_ptr(), d0.data_ptr(),
                d1.data_ptr(), i0.data_ptr(), nq, nt, D, pad_col,
                stream_ptr(dev))
        else:
            norm = torch.empty((nq + nt,), dtype=torch.float32, device=dev)
            status = load("two_nn_float")(
                desc_q.data_ptr(), desc_t.data_ptr(), valid_t.data_ptr(),
                norm[:nq].data_ptr(), norm[nq:].data_ptr(), d0.data_ptr(),
                d1.data_ptr(), i0.data_ptr(), nq, nt, D, pad_col,
                stream_ptr(dev))
    check(status, "two_nn")
    two_nn.launches += 1
    return d0, d1, i0


two_nn.launches = 0
