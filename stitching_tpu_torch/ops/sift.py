"""SIFT-family detection + 128-d float descriptors on the card.

Port of `stitching_tpu/ops/sift.py::detect_sift`: difference-of-Gaussians
scale-space extrema, contrast and edge-response filtering, the dominant
gradient orientation from a 36-bin histogram, and the 4x4x8
gradient-histogram descriptor (L2-normalised, clipped at 0.2,
renormalised). Written over a batch of same-sized planes (B, H, W), the
reference's `vmap` axis: every image of a padded stack has the same octave
sizes, so each step runs once for the whole batch.

Each octave is the previous one resized by `jax.image.resize(...,
"linear")`'s triangle weights (`orb.resize_linear_aa`), so the octaves
above the base inherit the ORB pyramid's last-bit gap against XLA's
compiled resize, once per octave (ROADMAP queue 3). The histograms are
one-hot products, as in the reference; their sums run in another order
than XLA's, so the descriptors agree to a float tolerance and an
orientation can move one bin where two bins tie to the last bit. The
Gaussian stack's blurs (9 to 19 taps) sum in the order of XLA's compiled
convolution (`gaussian._sum_taps`), so the base octave's DoG equals the
reference's.
Selection reproduces `lax.top_k`'s order (ties: lower index first).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from .fma import fma
from .gaussian import gaussian_blur
from .orb import (NEG_INF, _max3, _min3, _roll, resize_linear_aa,
                  resize_nearest, select_candidates, topk_stable)

N_SCALES = 3          # layers per octave used for extrema
SIGMA0 = 1.6
CONTRAST_THR = 0.04
EDGE_R = 10.0
DESC_WIDTH = 4        # 4x4 cells
DESC_BINS = 8
N_ORI_BINS = 36
BORDER = 8
_BIN_RAD = float(np.float32(2 * np.pi) / np.float32(N_ORI_BINS))


def _octave_shapes(h, w, max_octaves=5):
    shapes = []
    oh, ow = h, w
    while min(oh, ow) >= 2 * BORDER + 8 and len(shapes) < max_octaves:
        shapes.append((oh, ow))
        oh, ow = oh // 2, ow // 2
    return shapes


def _octave_quotas(nfeatures, n_oct):
    """Keypoint quota per octave: half of what is left, the rest last."""
    quotas = []
    rem = nfeatures
    for o in range(n_oct):
        q = max(rem // 2, 1) if o < n_oct - 1 else rem
        q = int(min(q, rem))
        quotas.append(q)
        rem -= q
        if rem <= 0:
            quotas += [0] * (n_oct - len(quotas))
            break
    return quotas


def _grad(img):
    """Central differences with wrap-around, magnitude and angle."""
    gx = (_roll(img, 0, 1) - _roll(img, 0, -1)) * 0.5
    gy = (_roll(img, 1, 0) - _roll(img, -1, 0)) * 0.5
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)
    return mag, ang


def _gather(plane, yy, xx):
    """plane[b, yy, xx] for (B, H, W) planes and (B, ...) integer indices."""
    B, H, W = plane.shape
    idx = (yy * W + xx).reshape(B, -1)
    return torch.gather(plane.reshape(B, -1), 1, idx).reshape(yy.shape)


def _orientation_hist(mag, ang, xs, ys, sigma):
    """Dominant gradient direction per keypoint from a 36-bin histogram
    weighted by magnitude and a Gaussian of 1.5 sigma: (B, N) radians."""
    R = 8
    dev = mag.device
    h, w = mag.shape[-2], mag.shape[-1]
    d = torch.arange(-R, R + 1, device=dev)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    yy = (ys[..., None, None] + dy).clamp(0, h - 1)
    xx = (xs[..., None, None] + dx).clamp(0, w - 1)
    m = _gather(mag, yy, xx)                          # (B, N, 17, 17)
    a = _gather(ang, yy, xx)
    sig = np.float32(1.5) * np.float32(sigma)
    wgt = torch.exp(-(dx * dx + dy * dy).to(torch.float32)
                    / float(np.float32(2.0) * sig * sig))
    bins = torch.floor((a / (2 * math.pi) + 0.5) * N_ORI_BINS).long()
    bins = bins.clamp(0, N_ORI_BINS - 1)
    onehot = F.one_hot(bins, N_ORI_BINS).to(m.dtype)
    hist = torch.einsum("bnij,bnijk->bnk", m * wgt, onehot)
    for _ in range(2):
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    peak = torch.argmax(hist, dim=-1)
    # the bin centre's angle in [-pi, pi), rounded as the reference's
    # compiled code rounds it: its `/ 36 * 2 * pi - pi` becomes one
    # multiply-add by the folded constant 2 pi / 36
    return fma(peak.to(torch.float32) + 0.5, _BIN_RAD, -math.pi)


def _descriptors(gauss, xs, ys, angles, sigma):
    """4x4x8 gradient-histogram descriptors, (B, N, 128) L2-normalised."""
    mag, ang = _grad(gauss)
    dev = gauss.device
    h, w = gauss.shape[-2], gauss.shape[-1]
    g = torch.arange(16, dtype=torch.float32, device=dev) - 7.5
    gy, gx = torch.meshgrid(g, g, indexing="ij")      # (16, 16)
    cos = torch.cos(angles)[..., None, None]
    sin = torch.sin(angles)[..., None, None]
    spacing = float(np.float32(3.0) * np.float32(sigma) / np.float32(4.0))
    rx = gx * cos - gy * sin
    ry = gx * sin + gy * cos
    sx = torch.round(xs[..., None, None] + rx * spacing).clamp(0, w - 1)
    sy = torch.round(ys[..., None, None] + ry * spacing).clamp(0, h - 1)
    sxi, syi = sx.long(), sy.long()
    m = _gather(mag, syi, sxi)                        # (B, N, 16, 16)
    a = _gather(ang, syi, sxi) - angles[..., None, None]
    wgt = torch.exp(-(gx * gx + gy * gy) / (2 * (0.5 * 16) ** 2))
    mw = m * wgt

    cell_y = ((gy + 8) // 4).clamp(0, 3).long()
    cell_x = ((gx + 8) // 4).clamp(0, 3).long()
    cell = cell_y * 4 + cell_x                        # (16, 16)
    obin_f = (a / (2 * math.pi) + 0.5) * DESC_BINS
    fl = torch.floor(obin_f)
    obin0 = torch.remainder(fl.long(), DESC_BINS)
    frac = obin_f - fl
    obin1 = (obin0 + 1) % DESC_BINS

    cell_oh = F.one_hot(cell, 16).to(m.dtype)         # (16, 16, 16)
    o0 = F.one_hot(obin0, DESC_BINS).to(m.dtype)      # (B, N, 16, 16, 8)
    o1 = F.one_hot(obin1, DESC_BINS).to(m.dtype)
    contrib = mw[..., None] * ((1 - frac[..., None]) * o0
                               + frac[..., None] * o1)
    desc = torch.einsum("bnijk,ijc->bnck", contrib, cell_oh)
    desc = desc.reshape(desc.shape[0], desc.shape[1], 128)
    desc = desc / torch.clamp_min(
        torch.linalg.vector_norm(desc, dim=-1, keepdim=True), 1e-7)
    desc = torch.clamp_max(desc, 0.2)
    return desc / torch.clamp_min(
        torch.linalg.vector_norm(desc, dim=-1, keepdim=True), 1e-7)


def detect_sift(gray, mask=None, *, nfeatures=500):
    """SIFT detection on (B, H, W) float32 [0, 255] planes.

    mask: optional (B, H, W) bool region gate. Returns a dict of (B, N, ...)
    tensors with N = nfeatures, as `orb.detect_orb`: xy (base-level
    coords), response, size, angle_deg, desc (B, N, 128) float32, valid.
    """
    B, h, w = gray.shape
    dev = gray.device
    # the reference's compiled code divides by 255 as a multiply by 1/255
    img = gray * float(np.float32(1 / 255))
    shapes = _octave_shapes(h, w)
    quotas = _octave_quotas(nfeatures, len(shapes))
    k = 2.0 ** (1.0 / N_SCALES)

    cand = {kk: [] for kk in ("score", "xy", "angle", "desc", "size", "inq")}
    base = img
    for o, (oh, ow) in enumerate(shapes):
        if o > 0:
            base = resize_linear_aa(base, oh, ow)
        gs = []
        cur = base
        prev_sigma = 0.5
        for s in range(N_SCALES + 3):
            sigma = SIGMA0 * (k ** s)
            add = np.sqrt(max(sigma ** 2 - prev_sigma ** 2, 0.01))
            cur = gaussian_blur(cur, float(add))
            prev_sigma = sigma
            gs.append(cur)
        dogs = [gs[s + 1] - gs[s] for s in range(N_SCALES + 2)]

        ys_i = torch.arange(oh, device=dev)[:, None]
        xs_i = torch.arange(ow, device=dev)[None, :]
        inb = ((ys_i >= BORDER) & (ys_i < oh - BORDER)
               & (xs_i >= BORDER) & (xs_i < ow - BORDER))
        if mask is not None:
            inb = inb & (resize_nearest(mask.to(torch.float32), oh, ow)
                         > 0.5)

        for s in range(1, N_SCALES + 1):
            d = dogs[s]
            is_max = ((d >= _max3(d)) & (d >= _max3(dogs[s + 1]))
                      & (d >= _max3(dogs[s - 1])))
            is_min = ((d <= _min3(d)) & (d <= _min3(dogs[s + 1]))
                      & (d <= _min3(dogs[s - 1])))
            contrast = torch.abs(d) > (0.5 * CONTRAST_THR / N_SCALES)
            # edge rejection by the 2x2 spatial Hessian
            dxx = _roll(d, 0, 1) + _roll(d, 0, -1) - 2 * d
            dyy = _roll(d, 1, 0) + _roll(d, -1, 0) - 2 * d
            dxy = (_roll(d, 1, 1) - _roll(d, 1, -1) - _roll(d, -1, 1)
                   + _roll(d, -1, -1)) * 0.25
            tr = dxx + dyy
            det = dxx * dyy - dxy * dxy
            edge_ok = (det > 0) & (tr * tr * EDGE_R
                                   < (EDGE_R + 1) ** 2 * det)
            gate = (is_max | is_min) & contrast & edge_ok & inb
            score = torch.where(gate, torch.abs(d), NEG_INF)

            k_cap = min(max(quotas[o], 1) + 64, oh * ow)
            top_scores, top_idx = topk_stable(score.reshape(B, -1), k_cap)
            ys = top_idx // ow
            xs = top_idx % ow
            ok = top_scores > NEG_INF / 2

            sigma_kp = SIGMA0 * (k ** s)
            mag, ang = _grad(gs[s])
            theta = _orientation_hist(mag, ang, xs, ys, sigma_kp)
            desc = _descriptors(gs[s], xs, ys, theta, sigma_kp)

            scale_back = 2.0 ** o
            rank = torch.arange(k_cap, device=dev)
            per_layer_quota = max(quotas[o] // N_SCALES, 1)
            cand["score"].append(torch.where(ok, top_scores, NEG_INF))
            cand["xy"].append(torch.stack(
                [xs.to(torch.float32) * scale_back,
                 ys.to(torch.float32) * scale_back], dim=-1))
            cand["angle"].append(theta)
            cand["desc"].append(desc)
            cand["size"].append(torch.full(
                (B, k_cap), sigma_kp * scale_back * 2.0, device=dev))
            cand["inq"].append((rank < per_layer_quota) & ok)

    return select_candidates(cand, nfeatures, score_scale=1.0, boost=1e6)
