"""AKAZE keypoints + M-LDB descriptors on the card.

Port of `stitching_tpu/ops/akaze.py::detect_akaze` (Alcantarilla, Nuevo,
Bartoli, BMVC 2013): a nonlinear diffusion scale space (Fast Explicit
Diffusion steps of the Perona-Malik g2 conductivity, every level at base
resolution), the scale-normalised Hessian determinant with 3x3 non-maximum
suppression and per-level quotas, the dominant smoothed-gradient
orientation and the rotated M-LDB descriptor (intensity and x/y
derivative cell-mean comparisons over 2x2, 3x3 and 4x4 grids: 486 bits,
zero-padded to 512). Written over a batch of same-sized planes (B, H, W),
the reference's `vmap` axis.

The FED cycles amplify rounding differences (the reference's deepest
levels reach Hessian responses of 1e12), so the scale space follows the
reference's rounding step by step: the diffusion's fluxes are added in its
`.at[].add` order, the products that XLA's compiled code contracts into
multiply-adds are contracted here too (`fma`), the contrast factor is the
70th percentile by a sort per image with `jnp.percentile`'s linear
interpolation, and the blurs have 5 and 7 taps, where `gaussian_blur`
equals XLA's convolution. On the tests' inputs every level equals the
reference's bit for bit. What is left (the orientation's window sum and
the arctangent's last bit) moves an angle by an ulp and, where two cell
means are that close, can flip a descriptor bit.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .fma import fma
from .gaussian import gaussian_blur
from .orb import (BORDER, NEG_INF, _level_quotas, _max3, select_candidates,
                  topk_stable)
from .sift import _gather

N_BITS = 512
_N_LEVELS = 6
_TAU_MAX = 0.25          # explicit-step stability bound (grid spacing 1)
_MAX_FED_STEPS = 24      # per-cycle cap (deepest levels saturate here)
_GRIDS = (2, 3, 4)


def _grad(img):
    """Central differences, zero on the first and last row or column."""
    gx = F.pad(0.5 * (img[..., :, 2:] - img[..., :, :-2]), (1, 1))
    gy = F.pad(0.5 * (img[..., 2:, :] - img[..., :-2, :]), (0, 0, 1, 1))
    return gx, gy


def _diffusion_step(u, g, tau):
    """One explicit diffusion step with conductivity g (half-point fluxes
    a * b). The divergence adds the four fluxes in the reference's
    `.at[].add` order, each after the first as one multiply-add, and the
    step is one more, as the reference's compiled code rounds them."""
    ar = 0.5 * (g[..., :, 1:] + g[..., :, :-1])
    br = u[..., :, 1:] - u[..., :, :-1]
    ad = 0.5 * (g[..., 1:, :] + g[..., :-1, :])
    bd = u[..., 1:, :] - u[..., :-1, :]
    div = F.pad(ar * br, (0, 1))
    div = torch.cat([div[..., :, :1], fma(-ar, br, div[..., :, 1:])], dim=-1)
    div = torch.cat([fma(ad, bd, div[..., :-1, :]), div[..., -1:, :]], dim=-2)
    div = torch.cat([div[..., :1, :], fma(-ad, bd, div[..., 1:, :])], dim=-2)
    return fma(div, tau, u)


def _percentile(x, q):
    """`jnp.percentile(x, q)` per image of (B, ...) planes (linear
    interpolation between the two nearest ranks)."""
    flat = x.reshape(x.shape[0], -1)
    n = flat.shape[1]
    pos = np.float32(np.float32(q) / np.float32(100.0)) * np.float32(n - 1)
    low = min(max(int(np.floor(pos)), 0), n - 1)
    high = min(max(int(np.ceil(pos)), 0), n - 1)
    hw = np.float32(pos - np.floor(pos))
    lw = np.float32(1.0) - hw
    vals = torch.sort(flat, dim=1).values
    return fma(vals[:, low], float(lw), vals[:, high] * float(hw))


def _contrast_k(gray):
    """Perona-Malik contrast factor per image: the 70th percentile of the
    smoothed gradient magnitude (the paper's k estimate)."""
    s = gaussian_blur(gray, 1.0, radius=2)
    gx, gy = _grad(s)
    mag = torch.sqrt(fma(gy, gy, gx * gx))
    return torch.clamp_min(_percentile(mag, 70.0), 1e-3)


def _fed_taus(t_span):
    """Fast-Explicit-Diffusion cycle step sizes reaching total time
    `t_span`: n steps with tau_j = tau_max / (4 cos^2(pi (2j+1)/(4n+2)))
    sum to tau_max (n^2 + n) / 3 (Weickert's FED); individually unstable
    steps alternate so the cycle as a whole stays stable."""
    n = int(np.ceil(0.5 * (np.sqrt(1.0 + 12.0 * t_span / _TAU_MAX) - 1.0)))
    n = int(np.clip(n, 1, _MAX_FED_STEPS))
    j = np.arange(n)
    taus = _TAU_MAX / (4.0 * np.cos(np.pi * (2 * j + 1)
                                    / (4 * n + 2)) ** 2)
    return taus * (t_span / taus.sum())  # exact total time


def build_nonlinear_scale_space(gray, n_levels=_N_LEVELS):
    """Evolution levels u_1..u_n of FED nonlinear diffusion (list of
    (B, H, W) planes) and their evolution sigmas. The conductivity g
    refreshes once per cycle (per level)."""
    k = _contrast_k(gray)
    k2 = (k * k)[:, None, None]
    u = gaussian_blur(gray, 1.6, radius=3)
    levels, sigmas = [], []
    sigma = 1.6
    for lvl in range(n_levels):
        target = 1.6 * (2.0 ** ((lvl + 1) / 2.0))
        # diffusion time equivalent of a Gaussian sigma: t = sigma^2 / 2
        t_span = 0.5 * (target ** 2 - sigma ** 2)
        s = gaussian_blur(u, 1.0, radius=2)
        gx, gy = _grad(s)
        g = 1.0 / (1.0 + fma(gy, gy, gx * gx) / k2)
        for tau in _fed_taus(t_span):
            u = _diffusion_step(u, g, float(tau))
        sigma = target
        levels.append(u)
        sigmas.append(sigma)
    return levels, sigmas


def _hessian_response(u, sigma):
    """Scale-normalised determinant of the Hessian (sigma^4 det H)."""
    uxx = F.pad(u[..., :, 2:] - 2 * u[..., :, 1:-1] + u[..., :, :-2], (1, 1))
    uyy = F.pad(u[..., 2:, :] - 2 * u[..., 1:-1, :] + u[..., :-2, :],
                (0, 0, 1, 1))
    gx, _ = _grad(u)
    _, uxy = _grad(gx)
    return (sigma ** 4) * fma(uxx, uyy, -(uxy * uxy))


def _mldb_pairs():
    """Static cell-pair tables per grid size."""
    tables = {}
    for gsz in _GRIDS:
        n = gsz * gsz
        ii, jj = np.triu_indices(n, k=1)
        tables[gsz] = np.stack([ii, jj], 1).astype(np.int32)
    return tables


_PAIR_TABLES = _mldb_pairs()
_TOTAL_BITS = sum(3 * len(_PAIR_TABLES[g]) for g in _GRIDS)  # 486


def _mldb_descriptor(u, xs, ys, angles, size):
    """M-LDB bits (B, N, 512) for keypoints at (xs, ys) with patch side
    `size` px: cell means of (intensity, dx, dy) over rotated grids, one
    bit per cell pair per channel."""
    B, h, w = u.shape
    dev = u.device
    gx, gy = _grad(u)
    n = xs.shape[1]
    cos = torch.cos(angles)[..., None]
    sin = torch.sin(angles)[..., None]
    bits = []
    for gsz in _GRIDS:
        sub = 2
        m = gsz * sub
        lin = (torch.arange(m, dtype=torch.float32, device=dev) + 0.5) / m \
            - 0.5
        py, px = torch.meshgrid(lin, lin, indexing="ij")
        px = px.reshape(-1) * size
        py = py.reshape(-1) * size
        rx = px * cos - py * sin
        ry = px * sin + py * cos
        sx = torch.round(xs[..., None] + rx).long().clamp(0, w - 1)
        sy = torch.round(ys[..., None] + ry).long().clamp(0, h - 1)
        vi = _gather(u, sy, sx)                            # (B, N, m*m)
        vx = _gather(gx, sy, sx)
        vy = _gather(gy, sy, sx)
        # the gradient channel in the keypoint frame
        vxr = vx * cos + vy * sin
        vyr = -vx * sin + vy * cos

        def cell_means(v):
            v = v.reshape(B, n, gsz, sub, gsz, sub)
            return v.mean((3, 5)).reshape(B, n, gsz * gsz)

        pairs = torch.as_tensor(_PAIR_TABLES[gsz], device=dev).long()
        for chan in (cell_means(vi), cell_means(vxr), cell_means(vyr)):
            bits.append((chan[..., pairs[:, 0]]
                         > chan[..., pairs[:, 1]]).to(torch.float32))
    desc = torch.cat(bits, dim=-1)                         # (B, N, 486)
    return F.pad(desc, (0, N_BITS - _TOTAL_BITS))


def detect_akaze(gray, mask=None, *, nfeatures=1024):
    """AKAZE detection on (B, H, W) float32 [0, 255] planes.

    mask: optional (B, H, W) bool region gate. Returns a dict of (B, N, ...)
    tensors with N = nfeatures, as `orb.detect_orb`: xy, response, size,
    angle_deg, desc (B, N, 512) {0,1} float32, valid.
    """
    B, h, w = gray.shape
    dev = gray.device
    levels, sigmas = build_nonlinear_scale_space(gray)
    quotas = _level_quotas(nfeatures, len(levels))

    ys_i = torch.arange(h, device=dev)[:, None]
    xs_i = torch.arange(w, device=dev)[None, :]
    region = ((ys_i >= BORDER) & (ys_i < h - BORDER)
              & (xs_i >= BORDER) & (xs_i < w - BORDER))
    if mask is not None:
        region = region & mask

    cand = {k: [] for k in ("score", "xy", "angle", "desc", "size", "inq")}
    rad = 3
    d = torch.arange(-rad, rad + 1, device=dev)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    for lvl, (u, sigma) in enumerate(zip(levels, sigmas)):
        resp = _hessian_response(u, sigma)
        score = torch.where(region, resp, NEG_INF)
        score = torch.where((score >= _max3(score)) & (score > 0), score,
                            NEG_INF)
        cap = min(2 * quotas[lvl] + 32, h * w)
        top_scores, top_idx = topk_stable(score.reshape(B, -1), cap)
        ys = top_idx // w
        xs = top_idx % w
        ok = top_scores > NEG_INF / 2

        # main orientation: the dominant smoothed-gradient direction in a
        # sigma-scaled window around the keypoint
        gx, gy = _grad(u)
        step = max(int(np.round(np.float32(sigma))), 1)
        yy = (ys[..., None, None] + dy * step).clamp(0, h - 1)
        xx = (xs[..., None, None] + dx * step).clamp(0, w - 1)
        sgx = _gather(gx, yy, xx).sum((-2, -1))
        sgy = _gather(gy, yy, xx).sum((-2, -1))
        ang = torch.atan2(sgy, sgx)

        desc = _mldb_descriptor(u, xs, ys, ang, 10.0 * sigma)
        rank = torch.arange(cap, device=dev)
        cand["score"].append(torch.where(ok, top_scores, NEG_INF))
        cand["xy"].append(torch.stack([xs.to(torch.float32),
                                       ys.to(torch.float32)], dim=-1))
        cand["angle"].append(ang)
        cand["desc"].append(desc)
        cand["size"].append(torch.full((B, cap), 2.0 * sigma, device=dev))
        cand["inq"].append((rank < quotas[lvl]) & ok)
    return select_candidates(cand, nfeatures)
