"""Pairwise descriptor matching: 2-NN + ratio test, both directions.

Port of `stitching_tpu/ops/match.py`: `ratio_union` over a batch of pairs
(the batched matcher's 2-NN is the CUDA kernel
`kernels/two_nn.py::two_nn_pairs`), and `match_pair`, the matcher of one
pair of descriptor sets, whose 2-NN per direction is the CUDA kernel
`kernels/two_nn.py::two_nn`.
"""

import numpy as np
import torch

from .kernels.two_nn import two_nn


def ratio_union(d0f, d1f, fwd_j, d0b, d1b, bwd_i, valid_a, valid_b,
                match_conf):
    """Accept forward matches passing d0 < (1-match_conf)*d1, add backward
    matches that don't duplicate an accepted forward one.

    All inputs carry a leading pair axis: d0f/d1f/fwd_j (P, Na), d0b/d1b/
    bwd_i (P, Nb), valid_a (P, Na), valid_b (P, Nb). Returns (pairs
    (P, Na+Nb, 2) int64, valid (P, Na+Nb) bool).
    """
    # Upper bound below any invalid-entry sentinel (the kernel uses 1e30).
    real = 1e29
    na = valid_a.shape[-1]
    nb = valid_b.shape[-1]
    thr = float(np.float32(1.0) - np.float32(match_conf))  # as in float32
    fwd_ok = (d0f < thr * d1f) & (d0f < real) & valid_a
    bwd_ok = (d0b < thr * d1b) & (d0b < real) & valid_b
    dev = d0f.device
    ia = torch.arange(na, device=dev).expand_as(fwd_j)
    ib = torch.arange(nb, device=dev).expand_as(bwd_i)
    fwd_j = fwd_j.long()
    bwd_i = bwd_i.long()
    fwd_pairs = torch.stack([ia, fwd_j], dim=-1)
    bwd_pairs = torch.stack([bwd_i, ib], dim=-1)
    dup = (torch.gather(fwd_ok, -1, bwd_i)
           & (torch.gather(fwd_j, -1, bwd_i) == ib))
    bwd_keep = bwd_ok & ~dup
    pairs = torch.cat([fwd_pairs, bwd_pairs], dim=-2)
    valid = torch.cat([fwd_ok, bwd_keep], dim=-1)
    return pairs, valid


def match_pair(desc_a, valid_a, desc_b, valid_b, match_conf, *,
               is_binary=True):
    """2-NN cross-check-union matching between two descriptor sets.

    desc_a: (Na, D) float32 (binary descriptors are {0,1}-unpacked);
    valid_a: (Na,) bool; desc_b, valid_b: the other image's. A match is
    accepted if d0 < (1 - match_conf) * d1, with L2 (not squared)
    distances for float descriptors. Returns dict(pairs (Na+Nb, 2) int32
    of (idx_a, idx_b), valid (Na+Nb,) bool).
    """
    d0f, d1f, fwd_j = two_nn(desc_a, desc_b, valid_b, is_binary=is_binary)
    d0b, d1b, bwd_i = two_nn(desc_b, desc_a, valid_a, is_binary=is_binary)
    nn = [d0f, d1f, fwd_j, d0b, d1b, bwd_i]
    if not is_binary:
        for k in (0, 1, 3, 4):
            nn[k] = torch.sqrt(nn[k])
    pairs, valid = ratio_union(*[v[None] for v in nn], valid_a[None],
                               valid_b[None], float(match_conf))
    return dict(pairs=pairs[0].to(torch.int32), valid=valid[0])
