"""Exposure (gain) compensation.

Port of the batched paths of `stitching_tpu/ops/exposure.py`.

Model (Brown-Lowe gain adjustment): minimize over per-image gains g
    sum_pairs N_ij [ alpha (g_i I_ij - g_j I_ji)^2 + beta (g_i - 1)^2 ]
with alpha = 0.01, beta = 100. The scalar variants (gain, channel) take
the exact overlap statistics of every pair (`_pair_stats`, batched over
the pairs on the device) into one (N, N) solve per channel, `nr_feeds`
times, each round on the stack times the gains so far. The blocks
variants solve per canvas-aligned cell (block_size px): cells are
independent (blocks only ever overlap blocks at the same location), so
the solve is one batched (cells, N, N) linear solve, followed by
per-image gain-map smoothing. The masked sums run on the device over the
tile stack; the tiny normal systems and the smoothing run in numpy on the
host, as in the reference.

The list forms of the step-by-step API (`compute_scalar_gains`,
`compute_block_gains`) take per-image tensors on one device: the
reference's per-pair and per-image sums, then the same host solves.
Their float32 sums run in another order than numpy's, so they agree to
rounding.
"""

import numpy as np
import torch

from .seam import _pair_windows, _round64, plan_overlaps

ALPHA = 0.01
BETA = 100.0


def solve_gains(n_imgs, stats, n_channels):
    """stats: list of (i, j, N, I_i, I_j). Returns (n_imgs, n_channels)
    float64 gains (host numpy, as in the reference)."""
    gains = np.ones((n_imgs, n_channels))
    for c in range(n_channels):
        A = np.zeros((n_imgs, n_imgs))
        b = np.zeros(n_imgs)
        for i, j, n, I_i, I_j in stats:
            A[i, i] += n * (ALPHA * I_i[c] * I_i[c] + BETA)
            A[j, j] += n * (ALPHA * I_j[c] * I_j[c] + BETA)
            A[i, j] -= ALPHA * n * I_i[c] * I_j[c]
            A[j, i] -= ALPHA * n * I_i[c] * I_j[c]
            b[i] += BETA * n
            b[j] += BETA * n
        if A.any():
            try:
                gains[:, c] = np.linalg.solve(A + 1e-9 * np.eye(n_imgs), b)
            except np.linalg.LinAlgError:
                pass
    return gains


def _pair_overlap_stats(corner_i, img_i, mask_i, corner_j, img_j, mask_j,
                        per_channel):
    """Exact overlap statistics of one image pair: (N, I_i, I_j) with I_*
    host float32 arrays, per channel (3,) or scalar (1,). img_*: (h, w, C)
    tensors; mask_*: (h, w) tensors."""
    xi, yi = corner_i
    xj, yj = corner_j
    hi, wi = img_i.shape[:2]
    hj, wj = img_j.shape[:2]
    x0, y0 = max(xi, xj), max(yi, yj)
    x1, y1 = min(xi + wi, xj + wj), min(yi + hi, yj + hj)
    if x1 <= x0 or y1 <= y0:
        return 0.0, None, None
    si = img_i[y0 - yi:y1 - yi, x0 - xi:x1 - xi].to(torch.float32)
    sj = img_j[y0 - yj:y1 - yj, x0 - xj:x1 - xj].to(torch.float32)
    both = ((mask_i[y0 - yi:y1 - yi, x0 - xi:x1 - xi] > 0)
            & (mask_j[y0 - yj:y1 - yj, x0 - xj:x1 - xj] > 0))
    n = float(both.sum())
    if n < 1:
        return 0.0, None, None
    bf = both.to(torch.float32)
    if per_channel:
        I_i = (si * bf[..., None]).sum((0, 1)) / n
        I_j = (sj * bf[..., None]).sum((0, 1)) / n
    else:
        I_i = ((si.mean(-1) * bf).sum() / n)[None]
        I_j = ((sj.mean(-1) * bf).sum() / n)[None]
    return n, I_i.cpu().numpy(), I_j.cpu().numpy()


def compute_scalar_gains(corners, imgs, masks, per_channel):
    """One gain per image (or per image and channel) from the overlaps of
    every pair. imgs/masks: per-image tensors on one device. Returns (N,
    C') host float64 gains."""
    n = len(imgs)
    stats = []
    for i in range(n):
        for j in range(i + 1, n):
            N, I_i, I_j = _pair_overlap_stats(
                corners[i], imgs[i], masks[i],
                corners[j], imgs[j], masks[j], per_channel)
            if N > 0:
                stats.append((i, j, N, I_i, I_j))
    return solve_gains(n, stats, 3 if per_channel else 1)


def compute_block_gains(corners, imgs, masks, block_size, per_channel):
    """Per-image gain maps over canvas cells of `block_size` px.

    imgs/masks: per-image tensors on one device. Returns (cell_origin,
    block_size, gains (N, ncy, ncx, C), present): each image's masked
    sums and counts per cell run on the device, the per-cell solves on
    the host."""
    n = len(imgs)
    x0 = min(c[0] for c in corners)
    y0 = min(c[1] for c in corners)
    x1 = max(c[0] + im.shape[1] for c, im in zip(corners, imgs))
    y1 = max(c[1] + im.shape[0] for c, im in zip(corners, imgs))
    bs = int(block_size)
    ncx = -(-(x1 - x0) // bs)
    ncy = -(-(y1 - y0) // bs)
    C = 3 if per_channel else 1
    sums = np.zeros((n, ncy, ncx, C))
    cnts = np.zeros((n, ncy, ncx))
    for i, (corner, img, mask) in enumerate(zip(corners, imgs, masks)):
        h, w = img.shape[:2]
        gx0, gy0 = corner[0] - x0, corner[1] - y0
        px, py = gx0 % bs, gy0 % bs
        ph = -(-(h + py) // bs) * bs
        pw = -(-(w + px) // bs) * bs
        arr = torch.zeros((ph, pw, 3), dtype=torch.float32,
                          device=img.device)
        mar = torch.zeros((ph, pw), dtype=torch.float32, device=img.device)
        arr[py:py + h, px:px + w] = img.to(torch.float32)
        mar[py:py + h, px:px + w] = (mask > 0).to(torch.float32)
        by, bx = ph // bs, pw // bs
        a4 = arr.reshape(by, bs, bx, bs, 3)
        m4 = mar.reshape(by, bs, bx, bs)
        if per_channel:
            s_ = (a4 * m4[..., None]).sum((1, 3))
        else:
            s_ = (a4.mean(-1) * m4).sum((1, 3))[..., None]
        cy0, cx0 = gy0 // bs, gx0 // bs
        sums[i, cy0:cy0 + by, cx0:cx0 + bx] = s_.cpu().numpy()
        cnts[i, cy0:cy0 + by, cx0:cx0 + bx] = m4.sum((1, 3)).cpu().numpy()
    return _solve_block_gains(sums, cnts, (x0, y0), bs, C, n, ncy, ncx)


def _pair_stats(data, masks, gains, pairs, bh, bw, per_channel):
    """Overlap statistics of every pair at once.

    data: (B, TH, TW, C) float32; masks: (B, TH, TW); gains: (B, C)
    float32, applied (with saturation) before the statistics. Returns
    (N (P,), I_i (P, S), I_j (P, S)) with S = C or 1: the overlap's pixel
    count and each image's mean over it."""
    ai, aj, mi, mj, _, _ = _pair_windows(data, masks, pairs, bh, bw)
    ai = (ai * gains[[p[0] for p in pairs]][:, None, None, :]).clamp(0.0,
                                                                     255.0)
    aj = (aj * gains[[p[1] for p in pairs]][:, None, None, :]).clamp(0.0,
                                                                     255.0)
    both = (mi & mj).to(torch.float32)
    n = both.sum((1, 2))
    nz = n.clamp_min(1.0)
    if per_channel:
        s_i = (ai * both[..., None]).sum((1, 2)) / nz[:, None]
        s_j = (aj * both[..., None]).sum((1, 2)) / nz[:, None]
    else:
        s_i = ((ai.mean(-1) * both).sum((1, 2)) / nz)[:, None]
        s_j = ((aj.mean(-1) * both).sum((1, 2)) / nz)[:, None]
    return n, s_i, s_j


def compute_scalar_gains_stack(data, masks, corners, sizes, per_channel,
                               nr_feeds=1):
    """The scalar compensators' gains from a device tile stack.

    data/masks: device stacks; corners/sizes: host (N, 2) int arrays (the
    first N batch slots are the real images). Returns (N, C') float64
    gains, C' = C for "channel", 1 for "gain": the product of `nr_feeds`
    solves, each on the stack times the gains so far."""
    n_imgs = len(corners)
    C = int(data.shape[-1])
    ncol = C if per_channel else 1
    pairs = plan_overlaps(np.asarray(corners), np.asarray(sizes))
    if not pairs:
        return np.ones((n_imgs, ncol))
    bw = _round64(max(p[4][0] for p in pairs))
    bh = _round64(max(p[4][1] for p in pairs))
    total = np.ones((n_imgs, ncol))
    cur_gains = np.ones((data.shape[0], C), np.float32)
    for _ in range(max(1, int(nr_feeds))):
        N, I_i, I_j = (t.cpu().numpy() for t in _pair_stats(
            data, masks, torch.as_tensor(cur_gains, device=data.device),
            pairs, bh, bw, per_channel))
        stats = [(p[0], p[1], float(N[k]), I_i[k], I_j[k])
                 for k, p in enumerate(pairs) if N[k] > 0]
        total = total * solve_gains(n_imgs, stats, ncol)
        cur_gains[:n_imgs] = total if per_channel \
            else np.repeat(total, C, axis=1)
    return total


def _block_stats_kernel(data, masks, sub_xy, *, scy, scx, bs, per_channel):
    """Per-image per-cell masked sums + counts over each image's OWN cell
    span (not the whole canvas, so memory stays O(tile)).

    data: (B, TH, TW, C); masks: (B, TH, TW); sub_xy: host (B, 2) int
    sub-block offsets (gx0 % bs, gy0 % bs). Returns (sums (B, scy, scx, S),
    cnts (B, scy, scx)) on the image's local cell grid starting at cell
    (gy0 // bs, gx0 // bs). The sums are float32 reductions: their order
    differs from the reference's, so they agree to rounding (1e-3
    relative is the tests' bar).
    """
    B, TH, TW, C = data.shape
    dev = data.device
    buf = torch.zeros((B, scy * bs, scx * bs, C), dtype=torch.float32,
                      device=dev)
    mbuf = torch.zeros((B, scy * bs, scx * bs), dtype=torch.float32,
                       device=dev)
    for i in range(B):
        ox, oy = int(sub_xy[i][0]), int(sub_xy[i][1])
        buf[i, oy:oy + TH, ox:ox + TW] = data[i]
        mbuf[i, oy:oy + TH, ox:ox + TW] = (masks[i] > 0).to(torch.float32)
    a4 = buf.reshape(B, scy, bs, scx, bs, C)
    m4 = mbuf.reshape(B, scy, bs, scx, bs)
    if per_channel:
        s = (a4 * m4[..., None]).sum((2, 4))
    else:
        s = (a4.mean(-1) * m4).sum((2, 4))[..., None]
    return s, m4.sum((2, 4))


def compute_block_gains_stack(data, masks, corners, sizes, block_size,
                              per_channel):
    """Per-image gain maps over canvas cells from a device tile stack.

    data/masks: device stacks; corners/sizes: host (N, 2) int arrays.
    Returns (cell_origin, block_size, gains (N, ncy, ncx, C), present).
    """
    n = len(corners)
    corners = np.asarray(corners)
    sizes = np.asarray(sizes)
    x0 = int(corners[:, 0].min())
    y0 = int(corners[:, 1].min())
    x1 = int((corners[:, 0] + sizes[:, 0]).max())
    y1 = int((corners[:, 1] + sizes[:, 1]).max())
    bs = int(block_size)
    ncx = -(-(x1 - x0) // bs)
    ncy = -(-(y1 - y0) // bs)
    th, tw = int(data.shape[1]), int(data.shape[2])
    scy = -(-(th + bs - 1) // bs) + 1
    scx = -(-(tw + bs - 1) // bs) + 1
    gx = corners[:, 0] - x0
    gy = corners[:, 1] - y0
    sub = np.zeros((data.shape[0], 2), np.int32)
    sub[:n, 0] = gx % bs
    sub[:n, 1] = gy % bs
    sums_d, cnts_d = _block_stats_kernel(
        data, masks, sub, scy=scy, scx=scx, bs=bs, per_channel=per_channel)
    sums_l = sums_d.cpu().numpy()[:n]
    cnts_l = cnts_d.cpu().numpy()[:n]
    # scatter each image's local cell block into the canvas cell grid
    S = 3 if per_channel else 1
    sums = np.zeros((n, ncy, ncx, S))
    cnts = np.zeros((n, ncy, ncx))
    for i in range(n):
        cy0, cx0 = int(gy[i]) // bs, int(gx[i]) // bs
        ey = min(scy, ncy - cy0)
        ex = min(scx, ncx - cx0)
        sums[i, cy0:cy0 + ey, cx0:cx0 + ex] = sums_l[i, :ey, :ex]
        cnts[i, cy0:cy0 + ey, cx0:cx0 + ex] = cnts_l[i, :ey, :ex]
    return _solve_block_gains(sums, cnts, (x0, y0), bs, S, n, ncy, ncx)


def _solve_block_gains(sums, cnts, origin, bs, C, n, ncy, ncx):
    """Per-cell independent Brown-Lowe solves (shared by host/stack paths).

    The per-cell pair weights are assembled SPARSELY over the image pairs
    whose cell spans actually intersect: the dense (n, n, cells) tensor of
    the naive formulation is O(n^2 * canvas) and unusable at the 100+-image
    scale; the pair list is O(overlaps).
    """
    means = sums / np.maximum(cnts[..., None], 1.0)
    gains = np.ones((n, ncy, ncx, C))
    present = cnts > 0                                  # (n, ncy, ncx)
    cells = ncy * ncx
    pres = present.reshape(n, cells)
    cnts_f = cnts.reshape(n, cells).astype(np.float32)
    means_f = means.reshape(n, cells, C).astype(np.float32)

    # pair list via cell-bounding-box intersection
    boxes = []
    for i in range(n):
        ys, xs = np.where(present[i])
        boxes.append(None if len(ys) == 0
                     else (ys.min(), ys.max(), xs.min(), xs.max()))
    pairs = []
    for i in range(n):
        if boxes[i] is None:
            continue
        for j in range(i + 1, n):
            if boxes[j] is None:
                continue
            if (boxes[i][0] <= boxes[j][1] and boxes[j][0] <= boxes[i][1]
                    and boxes[i][2] <= boxes[j][3]
                    and boxes[j][2] <= boxes[i][3]):
                pairs.append((i, j))

    A_all = np.zeros((C, cells, n, n), np.float32)
    bvec = np.zeros((cells, n), np.float32)
    has_pair = np.zeros((cells, n), bool)
    for i, j in pairs:
        both = pres[i] & pres[j]
        if not both.any():
            continue
        w = np.where(both, np.minimum(cnts_f[i], cnts_f[j]), 0.0)
        for c in range(C):
            Ii = means_f[i][:, c]
            Ij = means_f[j][:, c]
            A_all[c, :, i, i] += w * (ALPHA * Ii ** 2 + BETA)
            A_all[c, :, j, j] += w * (ALPHA * Ij ** 2 + BETA)
            A_all[c, :, i, j] -= ALPHA * w * Ii * Ij
            A_all[c, :, j, i] -= ALPHA * w * Ii * Ij
        bvec[:, i] += BETA * w
        bvec[:, j] += BETA * w
        has_pair[:, i] |= both
        has_pair[:, j] |= both

    for c in range(C):
        # host numpy solve in float64, as in the reference: the system is
        # tiny ((cells, n, n) with n images and a few hundred cells)
        Ac = (A_all[c] + 1e-9 * np.eye(n, dtype=np.float32)).astype(
            np.float64)
        sol = np.linalg.solve(Ac, bvec.astype(np.float64)[..., None])[..., 0]
        g = np.where(has_pair, sol.astype(np.float32), 1.0)  # (cells, n)
        gains[..., c] = g.T.reshape(n, ncy, ncx)

    return origin, bs, gains, present


def smooth_gain_map(gain, present):
    """Neighborhood-smooth a (ncy, ncx, C) gain map, respecting coverage:
    two passes of a 3x3 weighted mean."""
    g = gain.copy()
    w = present.astype(np.float32)
    for _ in range(2):
        acc = np.zeros_like(g)
        wacc = np.zeros_like(w)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ws = 1.0 if (dy, dx) == (0, 0) else (
                    0.5 if dy == 0 or dx == 0 else 0.25)
                sh = np.roll(np.roll(g, dy, 0), dx, 1)
                shw = np.roll(np.roll(w, dy, 0), dx, 1) * ws
                acc += sh * shw[..., None]
                wacc += shw
        g = np.where(wacc[..., None] > 0, acc / np.maximum(
            wacc[..., None], 1e-9), g)
    return g
