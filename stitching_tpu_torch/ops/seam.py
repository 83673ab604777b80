"""Seam estimation on the card: dynamic-programming, graph-cut and
voronoi seams.

Port of the batched paths of `stitching_tpu/ops/seam.py` (the engine's LOW
pass), the equivalents of cv.detail DpSeamFinder COLOR / COLOR_GRAD,
GraphCutSeamFinder COLOR / COLOR_GRAD and VoronoiSeamFinder:

- `dp_seams_stack`: every overlapping pair's seam from the ORIGINAL warp
  masks, one batched pass per orientation group (vertical seams where the
  overlap is at least as tall as wide, else the transposed problem), then
  all ownership cuts applied in pair order and `ensure_coverage` restoring
  pixels that cyclic ownership left with no owner;
- `gc_seams_stack`: the same plan with every pair's min cut
  (`ops/graphcut.seam_cut_pair`) in one batch;
- `voronoi_seams_stack`: each contested canvas pixel goes to the image
  whose unique territory is nearest (`ops/blend.distance_transform_l1`),
  ties to the lower index.

The DP runs its forward min scan as a loop over rows, each row one set of
tensor ops over pairs x columns, and its backtrack as one gather a row, all
on the card: the seam never visits the host.

The list forms of the step-by-step API (`SeamFinder.find`) are ported
too: `dp_pairwise_seams` and `gc_pairwise_seams` cut pair by pair (i < j),
each pair from the masks as the pairs before it left them (the native
PairwiseSeamFinder's order, unlike the batched stacks), each overlap
bucketed to 64 with the padding invalid; `voronoi_seams` is the stack's
ownership rule on the list's masks. They run on the device they are
given and return host uint8 {0, 255} masks.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .blend import distance_transform_l1
from .graphcut import seam_cut_pair

# invalid cells get a moderate additive penalty, not +inf: the running sum
# must stay small enough that real per-cell differences survive float32
_INVALID_PENALTY = 1e4
_DP_BIG = 3e37


def _round64(x):
    return int(-(-x // 64) * 64)


def _dp_seam_kernel(cost):
    """Vertical seam DP over a batch: cost (P, h, w) float32, pre-penalised
    by the caller. Returns each row's seam column, (P, h) int64.

    Forward: acc[r] = cost[r] + min(acc[r-1] at the column to the left, at
    the column, to the right), the move the first of tied minima (as
    jnp.argmin takes it; `torch.min` over a dim returns the first index).
    Backtrack from the first minimum of the last row, one gather a row.
    Two ops a row forward and three back: the host's dispatch is the cost.
    """
    P, h, w = cost.shape
    dev = cost.device
    # the running row with a BIG column each side: its (P, w, 3) windows
    # are every column's (left, mid, right)
    accp = torch.full((P, w + 2), _DP_BIG, dtype=torch.float32, device=dev)
    acc = accp[:, 1:-1]
    acc.copy_(cost[:, 0])
    windows = accp.unfold(1, 3, 1)
    best = torch.empty((P, w), dtype=torch.float32, device=dev)
    moves = torch.empty((h - 1, P, w), dtype=torch.int64, device=dev)
    for r in range(1, h):
        torch.min(windows, -1, out=(best, moves[r - 1]))
        torch.add(cost[:, r], best, out=acc)
    moves -= 1                          # column steps -1, 0, +1
    col = acc.min(-1).indices
    cols = [col]
    for r in range(h - 1, 0, -1):
        step = moves[r - 1].gather(1, col[:, None])[:, 0]
        col = (col + step).clamp_(0, w - 1)
        cols.append(col)
    return torch.stack(cols[::-1], dim=1)


def _sum_channels(x):
    """Sum over the last axis, left to right (the reference's order)."""
    out = x[..., 0]
    for c in range(1, x.shape[-1]):
        out = out + x[..., c]
    return out


def _grad_mag(a):
    """|d/dx| + |d/dy| of the channel mean, by central differences; 0 on
    the border rows and columns. a: (..., h, w, C)."""
    g = _sum_channels(a) / a.shape[-1]
    gx = torch.zeros_like(g)
    gy = torch.zeros_like(g)
    gx[..., :, 1:-1] = (g[..., :, 2:] - g[..., :, :-2]).abs()
    gy[..., 1:-1, :] = (g[..., 2:, :] - g[..., :-2, :]).abs()
    return gx + gy


def _windows(stack, idx, origins, bh, bw):
    """(P, bh, bw, ...) windows of `stack` (padded by (bh, bw) below and to
    the right, so no window is cut) at each pair's origin (x, y)."""
    return torch.stack([stack[int(i), int(o[1]):int(o[1]) + bh,
                              int(o[0]):int(o[0]) + bw]
                        for i, o in zip(idx, origins)])


def _pair_windows(data, masks, pairs, bh, bw):
    """Each pair's (bh, bw) windows at its overlap's origin in both images.

    data: (B, TH, TW, C) float32; masks: (B, TH, TW) float32 {0, 255};
    pairs: host list of (i, j, oxy_i, oxy_j, (ow, oh)). Returns the
    content (ai, aj), each (P, bh, bw, C), the masks (mi, mj), each
    (P, bh, bw) bool and false outside the overlap rect, and the rect
    sizes (ow, oh), each (P, 1, 1) int64.
    """
    dev = data.device
    data = F.pad(data, (0, 0, 0, bw, 0, bh))
    masks = F.pad(masks, (0, bw, 0, bh))
    ii = [p[0] for p in pairs]
    jj = [p[1] for p in pairs]
    ai = _windows(data, ii, [p[2] for p in pairs], bh, bw)
    aj = _windows(data, jj, [p[3] for p in pairs], bh, bw)
    mi = _windows(masks, ii, [p[2] for p in pairs], bh, bw)
    mj = _windows(masks, jj, [p[3] for p in pairs], bh, bw)
    wh = torch.as_tensor(np.asarray([p[4] for p in pairs], np.int64),
                         device=dev)
    ow, oh = wh[:, 0, None, None], wh[:, 1, None, None]
    inov = ((torch.arange(bw, device=dev)[None, None, :] < ow)
            & (torch.arange(bh, device=dev)[None, :, None] < oh))
    return ai, aj, (mi > 0) & inov, (mj > 0) & inov, ow, oh


def _pair_seams_kernel(data, masks, group, bh, bw, use_grad, transpose):
    """All pair seams of one orientation group.

    data: (B, TH, TW, C) float32; masks: (B, TH, TW) float32 {0, 255};
    group: host list of (i, j, oxy_i, oxy_j, (ow, oh)). With transpose the
    DP runs across the other axis (the seam along the longer side).
    Returns (keep_i, keep_j), each (P, bh, bw) float32 {0, 1} in
    un-transposed overlap coordinates.
    """
    dev = data.device
    ai, aj, mi_b, mj_b, ow, oh = _pair_windows(data, masks, group, bh, bw)
    cols = torch.arange(bw, device=dev)[None, None, :]
    rows = torch.arange(bh, device=dev)[None, :, None]
    both = mi_b & mj_b
    diff = _sum_channels((ai - aj).abs())
    if use_grad:
        diff = diff + (_grad_mag(ai) - _grad_mag(aj)).abs()
    # the bucket's cost layout: invalid cells penalised, padded columns
    # (of the DP's orientation) penalised, padded rows free
    cost = torch.where(both, diff, diff + _INVALID_PENALTY)
    if transpose:
        cost = torch.where(rows < oh, cost, cost + _INVALID_PENALTY)
        cost = torch.where(cols < ow, cost, 0.0)
        cost = cost.transpose(1, 2)
        w_eff = oh[:, :, 0]
        mi_b, mj_b, both = (t.transpose(1, 2) for t in (mi_b, mj_b, both))
    else:
        cost = torch.where(cols < ow, cost, cost + _INVALID_PENALTY)
        cost = torch.where(rows < oh, cost, 0.0)
        w_eff = ow[:, :, 0]
    dw = cost.shape[2]
    seam = _dp_seam_kernel(cost.contiguous())
    seam = torch.minimum(seam, (w_eff - 1).clamp_min(0))

    # ownership: the side of the seam holding each image's centroid. The
    # centroids are sums of column indices, exact in int64, then divided
    # in float32 as the reference does
    cidx = torch.arange(dw, device=dev)[None, None, :]

    def centroid(m):
        s = (m.to(torch.int64) * cidx).sum((1, 2)).to(torch.float32)
        c = m.sum((1, 2)).clamp_min(1).to(torch.float32)
        return s / c

    i_left = (centroid(mi_b) <= centroid(mj_b))[:, None, None]
    left_side = cidx < seam[:, :, None]
    seam_line = cidx == seam[:, :, None]
    own_i = torch.where(i_left, left_side | seam_line, ~left_side)
    keep_i = ~both | own_i
    keep_j = ~both | ~own_i | seam_line
    if transpose:
        keep_i, keep_j = keep_i.transpose(1, 2), keep_j.transpose(1, 2)
    return keep_i.to(torch.float32), keep_j.to(torch.float32)


def _apply_keeps(masks, group, keep_i, keep_j, bh, bw):
    """Multiply each pair's keep maps into the mask stack, pair by pair."""
    B, TH, TW = masks.shape
    out = F.pad(masks, (0, bw, 0, bh))
    for p, ki, kj in zip(group, keep_i, keep_j):
        for img, (x, y), k in ((p[0], p[2], ki), (p[1], p[3], kj)):
            out[img, y:y + bh, x:x + bw] *= k
    return out[:, :TH, :TW]


def _canvas_plan(corners, sizes, masks):
    """Canvas-relative corners and a canvas with a margin of one tile, so
    that no tile placed on it is cut."""
    corners = np.asarray(corners)
    sizes = np.asarray(sizes)
    x0, y0 = corners[:, 0].min(), corners[:, 1].min()
    rel = (corners - [x0, y0]).astype(np.int64)
    ch = int((corners[:, 1] + sizes[:, 1]).max() - y0)
    cw = int((corners[:, 0] + sizes[:, 0]).max() - x0)
    TH, TW = masks.shape[1], masks.shape[2]
    return rel, (_round64(ch) + TH, _round64(cw) + TW)


def ensure_coverage(orig_masks, out_masks, corners, sizes):
    """Restore pixels that the cuts left with no owner.

    Every pair's cut comes from the ORIGINAL masks and all keeps apply
    multiplicatively, so in a >= 3-image overlap a cyclic ownership (i
    loses to j, j to k, k to i) can strip a covered pixel of every owner.
    Such a pixel goes to the lowest-index image whose original mask covers
    it. Works on the first len(corners) slots of the mask stacks; padded
    batch slots pass through.
    """
    n = len(corners)
    rel, shape = _canvas_plan(corners, sizes, out_masks)
    TH, TW = out_masks.shape[1], out_masks.shape[2]
    dev = out_masks.device
    owned = torch.zeros(shape, dtype=torch.float32, device=dev)
    first = torch.full(shape, -1, dtype=torch.int64, device=dev)
    for i in range(n):
        x, y = rel[i]
        owned[y:y + TH, x:x + TW] += (out_masks[i] > 0).to(torch.float32)
    for i in range(n - 1, -1, -1):     # downward: the lowest index wins
        x, y = rel[i]
        reg = first[y:y + TH, x:x + TW]
        reg.copy_(torch.where(orig_masks[i] > 0, i, reg))
    orphan = (owned == 0) & (first >= 0)
    fixed = []
    for i in range(n):
        x, y = rel[i]
        take = orphan[y:y + TH, x:x + TW] & (first[y:y + TH, x:x + TW] == i)
        fixed.append(torch.where(take, 255.0, out_masks[i]))
    return torch.cat([torch.stack(fixed), out_masks[n:]])


def plan_overlaps(corners, sizes):
    """Host pair plan: [(i, j, oxy_i, oxy_j, (ow, oh))] for every pair of
    overlapping rects. corners/sizes: (N, 2) int (x, y) / (w, h)."""
    n = len(corners)
    out = []
    for i in range(n):
        for j in range(i + 1, n):
            ci, cj = corners[i], corners[j]
            wi, hi = sizes[i]
            wj, hj = sizes[j]
            x0 = max(ci[0], cj[0])
            y0 = max(ci[1], cj[1])
            x1 = min(ci[0] + wi, cj[0] + wj)
            y1 = min(ci[1] + hi, cj[1] + hj)
            if x1 <= x0 or y1 <= y0:
                continue
            out.append((i, j, (int(x0 - ci[0]), int(y0 - ci[1])),
                        (int(x0 - cj[0]), int(y0 - cj[1])),
                        (int(x1 - x0), int(y1 - y0))))
    return out


def dp_seams_stack(data, masks, corners, sizes, use_grad):
    """Batched DP seams over a tile stack on its device.

    data: (B, TH, TW, C) float32; masks: (B, TH, TW) float32 {0, 255};
    corners/sizes: host (N, 2) int. Returns (B, TH, TW) float32 seam masks
    in {0, 255}; padded batch slots pass through.
    """
    pairs = plan_overlaps(np.asarray(corners), np.asarray(sizes))
    if not pairs:
        return masks
    vert = [p for p in pairs if p[4][1] >= p[4][0]]
    horz = [p for p in pairs if p[4][1] < p[4][0]]
    out = masks
    for group, transpose in ((vert, False), (horz, True)):
        if not group:
            continue
        bw = _round64(max(p[4][0] for p in group))
        bh = _round64(max(p[4][1] for p in group))
        keep_i, keep_j = _pair_seams_kernel(data, masks, group, bh, bw,
                                            use_grad, transpose)
        out = _apply_keeps(out, group, keep_i, keep_j, bh, bw)
    out = ensure_coverage(masks, out, corners, sizes)
    return torch.where(out > 0, 255.0, 0.0)


def _gc_pairs(data, masks, pairs, bh, bw, use_grad):
    """Every pair's graph cut in one batched pass over (bh, bw) windows
    (the coarse-to-fine depth follows the bucket, as in the reference).
    Returns (keep_i, keep_j), each (P, bh, bw) float32 {0, 1}."""
    ai, aj, mi_b, mj_b, _, _ = _pair_windows(data, masks, pairs, bh, bw)
    both = mi_b & mj_b
    own_i = seam_cut_pair(ai, aj, both, mi_b & ~mj_b, mj_b & ~mi_b,
                          use_grad)
    return ((~both | own_i).to(torch.float32),
            (~both | ~own_i).to(torch.float32))


def gc_seams_stack(data, masks, corners, sizes, use_grad):
    """Batched graph-cut seams over a tile stack on its device.

    As `dp_seams_stack`: every pair's cut from the ORIGINAL warp masks, all
    pairs in one batch over one 64-bucketed window shape, then the cuts
    applied in pair order and `ensure_coverage`. Returns (B, TH, TW)
    float32 {0, 255}; padded batch slots pass through.
    """
    pairs = plan_overlaps(np.asarray(corners), np.asarray(sizes))
    if not pairs:
        return masks
    bw = _round64(max(p[4][0] for p in pairs))
    bh = _round64(max(p[4][1] for p in pairs))
    keep_i, keep_j = _gc_pairs(data, masks, pairs, bh, bw, use_grad)
    out = _apply_keeps(masks, pairs, keep_i, keep_j, bh, bw)
    out = ensure_coverage(masks, out, corners, sizes)
    return torch.where(out > 0, 255.0, 0.0)


def voronoi_seams_stack(masks, corners, sizes):
    """Batched voronoi seams over a mask stack on its device.

    masks: (B, TH, TW) float32 {0, 255}; corners/sizes: host (N, 2).
    Returns (B, TH, TW) float32 {0, 255}; padded batch slots pass through.
    A contested pixel (covered by >= 2 masks) goes to the image whose
    unique territory is nearest in L1, ties to the lower index.
    """
    n = len(corners)
    rel, shape = _canvas_plan(corners, sizes, masks)
    TH, TW = masks.shape[1], masks.shape[2]
    dev = masks.device
    placed = []
    cover = torch.zeros(shape, dtype=torch.float32, device=dev)
    for i in range(n):
        x, y = rel[i]
        cm = torch.zeros(shape, dtype=torch.float32, device=dev)
        cm[y:y + TH, x:x + TW] = (masks[i] > 0).to(torch.float32)
        placed.append(cm)
        cover += cm
    best_d = torch.full(shape, 1e9, dtype=torch.float32, device=dev)
    owner = torch.zeros(shape, dtype=torch.int64, device=dev)
    for i in range(n):
        unique = placed[i] * (cover == 1)
        # distance to the nearest pixel of this image's unique territory;
        # a strict < keeps the lower index on ties
        d = distance_transform_l1(unique == 0)
        win = d < best_d
        best_d = torch.where(win, d, best_d)
        owner = torch.where(win, i, owner)
    contested = cover >= 2
    keep = []
    for i in range(n):
        x, y = rel[i]
        c = contested[y:y + TH, x:x + TW]
        o = owner[y:y + TH, x:x + TW]
        keep.append((masks[i] > 0) & (~c | (o == i)))
    return torch.cat([torch.where(torch.stack(keep), 255.0, 0.0), masks[n:]])


# ---------------------------------------------------------------------------
# List forms: host images and masks in, pair by pair on a device
# ---------------------------------------------------------------------------

def _device_lists(imgs, masks, device):
    """float32 (h, w, C) images and (h, w) uint8 masks on `device`."""
    return ([torch.as_tensor(np.asarray(im, np.float32), device=device)
             for im in imgs],
            [torch.as_tensor(np.asarray(m), device=device).clone()
             for m in masks])


def _to_host_masks(masks):
    return [((m > 0).to(torch.uint8) * 255).cpu().numpy() for m in masks]


def _overlap_views(imgs, corners, masks, i, j):
    """Aligned overlap slices of a pair; None if the rects do not meet."""
    ci, cj = corners[i], corners[j]
    hi, wi = masks[i].shape
    hj, wj = masks[j].shape
    x0, y0 = max(ci[0], cj[0]), max(ci[1], cj[1])
    x1 = min(ci[0] + wi, cj[0] + wj)
    y1 = min(ci[1] + hi, cj[1] + hj)
    if x1 <= x0 or y1 <= y0:
        return None
    si = np.s_[y0 - ci[1]:y1 - ci[1], x0 - ci[0]:x1 - ci[0]]
    sj = np.s_[y0 - cj[1]:y1 - cj[1], x0 - cj[0]:x1 - cj[0]]
    return (si, sj, masks[i][si] > 0, masks[j][sj] > 0,
            imgs[i][si], imgs[j][sj])


def _cut(masks, i, j, si, sj, mi, mj, keep_i, keep_j):
    """Zero each image's pixels of the overlap that its keep map drops."""
    masks[i][si] = torch.where(mi & keep_i, masks[i][si], 0)
    masks[j][sj] = torch.where(mj & keep_j, masks[j][sj], 0)


def _dp_pair(imgs, corners, masks, i, j, use_grad):
    """One pair's DP seam, cut into `masks` in place."""
    ov = _overlap_views(imgs, corners, masks, i, j)
    if ov is None:
        return
    si, sj, mi, mj, ai, aj = ov
    both = mi & mj
    if int(both.sum()) < 2:
        return
    dev = both.device
    diff = _sum_channels((ai - aj).abs())
    if use_grad:
        diff = diff + (_grad_mag(ai) - _grad_mag(aj)).abs()
    oh, ow = diff.shape
    vertical = oh >= ow     # the seam runs along the longer side
    cost = diff if vertical else diff.T
    valid = both if vertical else both.T
    h, w = cost.shape
    # the bucket: padded rows free, padded columns penalised
    bh, bw = _round64(h), _round64(w)
    cost_b = torch.zeros((bh, bw), dtype=torch.float32, device=dev)
    cost_b[:h, :w] = torch.where(valid, cost, cost + _INVALID_PENALTY)
    cost_b[:h, w:] = _INVALID_PENALTY
    cols = _dp_seam_kernel(cost_b[None])[0, :h].clamp(0, w - 1)

    # the side of the seam holding each image's centroid (float64, as the
    # reference's numpy divides integer sums)
    col_idx = torch.arange(w, device=dev)[None, :]
    left_side = col_idx < cols[:, None]
    seam_line = col_idx == cols[:, None]
    mi_t = mi if vertical else mi.T
    mj_t = mj if vertical else mj.T

    def centroid(m):
        return (float((m.to(torch.int64) * col_idx).sum())
                / max(int(m.sum()), 1))

    own_i = ((left_side | seam_line) if centroid(mi_t) <= centroid(mj_t)
             else ~left_side)
    keep_i = ~valid | own_i
    keep_j = ~valid | ~own_i | seam_line
    if not vertical:
        keep_i, keep_j = keep_i.T, keep_j.T
    _cut(masks, i, j, si, sj, mi, mj, keep_i, keep_j)


def dp_pairwise_seams(imgs, corners, masks, use_grad, device="cuda"):
    """Pairwise DP seams, the masks updated pair by pair (i < j)."""
    imgs, masks = _device_lists(imgs, masks, device)
    for i in range(len(imgs)):
        for j in range(i + 1, len(imgs)):
            _dp_pair(imgs, corners, masks, i, j, use_grad)
    return _to_host_masks(masks)


def gc_pairwise_seams(imgs, corners, masks, use_grad, device="cuda"):
    """Pairwise graph-cut seams (`ops/graphcut.seam_cut_pair`), the masks
    updated pair by pair (i < j) like the native GraphCutSeamFinder."""
    imgs, masks = _device_lists(imgs, masks, device)
    n = len(imgs)
    for i in range(n):
        for j in range(i + 1, n):
            ov = _overlap_views(imgs, corners, masks, i, j)
            if ov is None:
                continue
            si, sj, mi, mj, ai, aj = ov
            both = mi & mj
            if int(both.sum()) < 2:
                continue
            # the overlap bucketed to 64; the padding is invalid space
            h, w = both.shape
            pad = (0, _round64(w) - w, 0, _round64(h) - h)

            def padded(t):
                if t.dim() == 3:
                    return F.pad(t, (0, 0) + pad)[None]
                return F.pad(t, pad)[None]

            own_i = seam_cut_pair(
                padded(ai), padded(aj), padded(both), padded(mi & ~mj),
                padded(mj & ~mi), use_grad)[0, :h, :w]
            _cut(masks, i, j, si, sj, mi, mj, ~both | own_i, ~both | ~own_i)
    return _to_host_masks(masks)


def voronoi_seams(corners, masks, device="cuda"):
    """Voronoi ownership of the list's masks: each contested pixel goes to
    the image whose unique territory is nearest in L1, ties to the lower
    index (`voronoi_seams_stack` on the masks padded to one shape)."""
    sizes = np.asarray([(m.shape[1], m.shape[0]) for m in masks])
    th, tw = int(sizes[:, 1].max()), int(sizes[:, 0].max())
    stack = torch.zeros((len(masks), th, tw), dtype=torch.float32,
                        device=device)
    for k, m in enumerate(masks):
        stack[k, :m.shape[0], :m.shape[1]] = torch.as_tensor(
            np.asarray(m) > 0, device=device) * 255.0
    out = voronoi_seams_stack(stack, np.asarray(corners), sizes)
    return [out[k, :h, :w].to(torch.uint8).cpu().numpy()
            for k, (w, h) in enumerate(sizes)]
