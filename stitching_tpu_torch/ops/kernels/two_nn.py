"""2-nearest-neighbour descriptor search over every image pair.

Port of `stitching_tpu/ops/pallas/two_nn.py::two_nn_pairs`: for every pair
p = (i, j) and both directions ([:, 0]: i queries j, [:, 1]: j queries i),
per query row, `d0` is the smallest distance to a valid target, `i0` the
lowest column attaining it and `d1` the smallest over the other columns.
Invalid targets sit at 1e30; the target axis behaves as if padded to a
multiple of 8 with invalid columns, as the TPU kernel pads it.

`two_nn_pairs` launches the CUDA kernel (`csrc/two_nn.cu`) for tensors on
the card and runs `two_nn_pairs_plain` for tensors on the CPU.
"""

import torch

from . import check, load, stream_ptr

BIG = 1.0e30


def _round_up(x, m):
    return -(-x // m) * m


def two_nn_pairs_plain(desc, valid, pair_ij, *, is_binary=True):
    """The distance-matrix formula: min, lowest-index argmin, masked min.

    desc: (B, N, D) float32; valid: (B, N) bool; pair_ij: (P, 2) int.
    Returns d0, d1 (P, 2, N) float32 and i0 (P, 2, N) int32. Distances are
    Hamming counts (binary) or squared L2 clamped at 0 (float).
    """
    B, N, D = desc.shape
    n_p = _round_up(max(N, 8), 8)
    pair = pair_ij.long()
    qidx = pair                          # (P, 2): query image per direction
    tidx = pair.flip(1)                  # target image per direction
    if is_binary:
        norms = desc.sum(dim=2)
    else:
        norms = (desc * desc).sum(dim=2)
    tadj = norms + torch.where(valid, 0.0, BIG)          # (B, N)
    q = desc[qidx]                                       # (P, 2, N, D)
    t = desc[tidx]
    prod = torch.matmul(q, t.transpose(-1, -2))          # (P, 2, N, N)
    dist = norms[qidx][..., None] + tadj[tidx][..., None, :] - 2.0 * prod
    if not is_binary:
        dist = dist.clamp_min(0.0)
    if n_p > N:
        pad = dist.new_full(dist.shape[:-1] + (n_p - N,), BIG)
        dist = torch.cat([dist, pad], dim=-1)
    cols = torch.arange(n_p, device=desc.device)
    d0 = dist.min(dim=-1).values
    i0 = torch.where(dist == d0[..., None], cols, n_p).min(dim=-1).values
    d1 = torch.where(cols == i0[..., None], 3.0e38, dist).min(dim=-1).values
    return d0, d1, i0.clamp_max(N - 1).to(torch.int32)


def two_nn_pairs(desc, valid, pair_ij, *, is_binary=True):
    """2-NN for every pair; the CUDA kernel on the card, the plain version
    on the CPU. See `two_nn_pairs_plain` for the contract."""
    if desc.device.type == "cpu":
        return two_nn_pairs_plain(desc, valid, pair_ij, is_binary=is_binary)
    if not is_binary:
        raise NotImplementedError(
            "two_nn_pairs: the float (SIFT) case has no CUDA kernel yet "
            "(ROADMAP queue 2, float two_nn)")
    B, N, D = desc.shape
    P = pair_ij.shape[0]
    if desc.dtype != torch.float32 or not desc.is_contiguous():
        raise ValueError("two_nn_pairs: desc must be contiguous float32")
    if valid.shape != (B, N) or valid.dtype != torch.bool:
        raise ValueError("two_nn_pairs: valid must be (B, N) bool")
    if pair_ij.shape != (P, 2) or pair_ij.dtype != torch.int32:
        raise ValueError("two_nn_pairs: pair_ij must be (P, 2) int32")
    if D > 256:
        raise NotImplementedError(
            "two_nn_pairs: the CUDA kernel takes at most 256 descriptor bits "
            "(ORB); wider binary descriptors come with BRISK/AKAZE (ROADMAP "
            "queue 1: SIFT/BRISK/AKAZE)")
    dev = desc.device
    if valid.device != dev or pair_ij.device != dev:
        raise ValueError("two_nn_pairs: all inputs on one device")
    valid = valid.contiguous()
    pair_ij = pair_ij.contiguous()
    words = torch.empty((B, N, 8), dtype=torch.int32, device=dev)
    d0 = torch.empty((P, 2, N), dtype=torch.float32, device=dev)
    d1 = torch.empty((P, 2, N), dtype=torch.float32, device=dev)
    i0 = torch.empty((P, 2, N), dtype=torch.int32, device=dev)
    if P == 0 or N == 0:
        return d0, d1, i0
    fn = load("two_nn")
    pad_col = int(_round_up(max(N, 8), 8) > N)
    with torch.cuda.device(dev):
        status = fn(desc.data_ptr(), valid.data_ptr(), pair_ij.data_ptr(),
                    words.data_ptr(), d0.data_ptr(), d1.data_ptr(),
                    i0.data_ptr(), B, N, D, P, pad_col, stream_ptr(dev))
    check(status, "two_nn_pairs")
    two_nn_pairs.launches += 1
    return d0, d1, i0


two_nn_pairs.launches = 0
