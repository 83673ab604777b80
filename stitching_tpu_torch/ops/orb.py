"""ORB keypoint detection + steered BRIEF descriptors on the card.

Port of `stitching_tpu/ops/orb.py::detect_orb`: FAST-9 corners on a 1.2x
image pyramid, Harris ranking, per-level keypoint quotas, intensity-centroid
orientation and a steered 256-bit BRIEF descriptor. Written over a batch of
same-sized planes (B, H, W): every image of a padded stack has the same
level sizes, so each step runs once for the whole batch.

Selection reproduces `lax.top_k`'s order, which breaks ties by the lower
index: every top-k here is a stable descending sort. The reference's
`approx_max_k` is exact on the CPU, so the exact top-k is its counterpart.
The pyramid levels reproduce `jax.image.resize(..., "linear")` with its
default antialiasing (triangle-kernel weight matrices), and the mask levels
its "nearest" index rule.
"""

import functools
import math

import numpy as np
import torch

from .fma import fma
from .gaussian import gaussian_blur

# 16-point Bresenham circle of radius 3, (dx, dy), clockwise from 12 o'clock
# (y axis points down).
FAST_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
FAST_ARC = 9          # FAST-9: need 9 contiguous brighter/darker pixels
FAST_THRESHOLD = 20.0
PATCH_SIZE = 31       # orientation / descriptor patch
HALF_PATCH = 15
N_BITS = 256
BORDER = 21           # keep keypoints this far from level edges
N_LEVELS = 8
SCALE_FACTOR = 1.2
HARRIS_K = 0.04
NEG_INF = -3e38


def _make_brief_pattern() -> np.ndarray:
    """(N_BITS, 2, 2) int8 point-pair offsets, Gaussian(0, patch/5), clipped.

    Deterministic; generated once at import. Max |offset| kept <= 13 so that a
    rotated sample stays within the BORDER margin.
    """
    rng = np.random.RandomState(0xB121F)
    pts = rng.randn(N_BITS, 2, 2) * (PATCH_SIZE / 5.0)
    return np.clip(np.round(pts), -13, 13).astype(np.int8)


BRIEF_PATTERN = _make_brief_pattern()


def _circular_mask() -> np.ndarray:
    """(31, 31) float mask of the radius-15 disc, for orientation moments."""
    yy, xx = np.mgrid[-HALF_PATCH:HALF_PATCH + 1, -HALF_PATCH:HALF_PATCH + 1]
    return (xx * xx + yy * yy <= HALF_PATCH * HALF_PATCH).astype(np.float32)


CIRC_MASK = _circular_mask()


def _roll(img, dy, dx):
    """img[..., y + dy, x + dx] with wrap-around (jnp.roll by (-dy, -dx))."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1))


def fast_corners(gray):
    """FAST-9 corner boolean map for (..., H, W) float images."""
    hi = gray + FAST_THRESHOLD
    lo = gray - FAST_THRESHOLD
    brighter = []
    darker = []
    for dx, dy in FAST_OFFSETS:
        s = _roll(gray, dy, dx)
        brighter.append(s > hi)
        darker.append(s < lo)

    def arc_any(bits):
        out = torch.zeros_like(bits[0])
        for s in range(16):
            acc = bits[s]
            for i in range(1, FAST_ARC):
                acc = acc & bits[(s + i) % 16]
            out = out | acc
        return out

    return arc_any(brighter) | arc_any(darker)


def _box7(img):
    """7x7 SAME window sums (zero padding), row-major over the window."""
    h, w = img.shape[-2], img.shape[-1]
    p = torch.nn.functional.pad(img, (3, 3, 3, 3))
    out = None
    for dy in range(7):
        for dx in range(7):
            s = p[..., dy:dy + h, dx:dx + w]
            out = s if out is None else out + s
    return out


def harris_response(gray):
    """Harris corner response over the full plane (for FAST ranking)."""
    def shift(img, dy, dx):
        return _roll(img, dy, dx)

    gx = (
        (shift(gray, -1, 1) + 2 * shift(gray, 0, 1) + shift(gray, 1, 1))
        - (shift(gray, -1, -1) + 2 * shift(gray, 0, -1) + shift(gray, 1, -1))
    ) * 0.25
    gy = (
        (shift(gray, 1, -1) + 2 * shift(gray, 1, 0) + shift(gray, 1, 1))
        - (shift(gray, -1, -1) + 2 * shift(gray, -1, 0) + shift(gray, -1, 1))
    ) * 0.25
    ixx, iyy, ixy = gx * gx, gy * gy, gx * gy
    sxx, syy, sxy = _box7(ixx), _box7(iyy), _box7(ixy)
    # rounded as the reference's compiled CPU code rounds it (contracted
    # multiply-adds), so that rankings agree
    det = fma(sxx, syy, -(sxy * sxy))
    tr = sxx + syy
    return fma(-(HARRIS_K * tr), tr, det)


def _level_sizes(h: int, w: int):
    sizes = []
    for lvl in range(N_LEVELS):
        s = 1.0 / (SCALE_FACTOR ** lvl)
        lh, lw = int(round(h * s)), int(round(w * s))
        if lh < 2 * BORDER + 1 or lw < 2 * BORDER + 1:
            break
        sizes.append((lh, lw))
    return sizes


def _level_quotas(nfeatures: int, n_levels: int):
    """Geometric keypoint distribution over levels (factor 1/1.2)."""
    f = 1.0 / SCALE_FACTOR
    ndesired = nfeatures * (1 - f) / (1 - f ** n_levels)
    quotas = []
    total = 0
    for lvl in range(n_levels - 1):
        q = int(round(ndesired * (f ** lvl)))
        quotas.append(q)
        total += q
    quotas.append(max(nfeatures - total, 0))
    return quotas


@functools.lru_cache(maxsize=64)
def _triangle_weights_np(n_in, n_out):
    """(n_in, n_out) weights of `jax.image.resize(method="linear")` with
    antialiasing: a triangle kernel widened by the downscale factor,
    normalised per output sample, in float32 as JAX computes them (the
    normalising sum runs down the input axis in order)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :]
               - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0), f32(1) - np.abs(x))
    total = np.add.reduce(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(n_in - 0.5))
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def _triangle_weights(n_in, n_out, device):
    return torch.as_tensor(_triangle_weights_np(n_in, n_out), device=device)


def resize_linear_aa(img, lh, lw):
    """(B, H, W) -> (B, lh, lw) as `jax.image.resize(..., "linear")`."""
    H, W = img.shape[-2], img.shape[-1]
    out = img
    if lh != H:
        wy = _triangle_weights(H, lh, img.device)         # (H, lh)
        out = torch.einsum("bhw,hy->byw", out, wy)
    if lw != W:
        wx = _triangle_weights(W, lw, img.device)         # (W, lw)
        out = torch.einsum("byw,wx->byx", out, wx)
    return out


def resize_nearest(mask, lh, lw):
    """(B, H, W) -> (B, lh, lw) as `jax.image.resize(..., "nearest")`."""
    H, W = mask.shape[-2], mask.shape[-1]

    def idx(n_in, n_out):
        f = (torch.arange(n_out, dtype=torch.float32, device=mask.device)
             + 0.5) * n_in / n_out
        return torch.floor(f).long()

    out = mask
    if lh != H:
        out = out[:, idx(H, lh)]
    if lw != W:
        out = out[:, :, idx(W, lw)]
    return out


def _window3(score, op, pad):
    """3x3 SAME window reduction by `op` with `pad` beyond the edges."""
    h, w = score.shape[-2], score.shape[-1]
    p = torch.nn.functional.pad(score, (1, 1, 1, 1), value=pad)
    out = None
    for dy in range(3):
        for dx in range(3):
            s = p[..., dy:dy + h, dx:dx + w]
            out = s if out is None else op(out, s)
    return out


def _max3(score):
    """3x3 SAME window max with NEG_INF padding."""
    return _window3(score, torch.maximum, NEG_INF)


def _min3(score):
    """3x3 SAME window min with -NEG_INF padding."""
    return _window3(score, torch.minimum, -NEG_INF)


def topk_stable(x, k):
    """Top-k along the last axis with `lax.top_k`'s order (ties: lower
    index first)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_candidates(cand, nfeatures, score_scale=1e-20, boost=1e30):
    """The reference's final selection from per-level candidate lists
    (dicts of (B, K_level, ...) tensors: score, xy, angle, desc, size and
    inq, the in-quota flag): every in-quota candidate first, then the best
    of the rest, by `score * score_scale + boost` in float32 (BRISK's and
    AKAZE's scale ties every in-quota candidate, so candidate order ranks
    them; SIFT's keeps the score). Padded to `nfeatures` rows."""
    score_all = torch.cat(cand["score"], dim=1)
    B = score_all.shape[0]
    ok_all = score_all > -1e38
    bonus = torch.where(torch.cat(cand["inq"], dim=1), boost, 0.0)
    sel_score = torch.where(ok_all, score_all * score_scale + bonus,
                            -math.inf)
    n_out = min(nfeatures, sel_score.shape[1])
    _, sel = topk_stable(sel_score, n_out)

    def pick(v):
        idx = sel.reshape(sel.shape + (1,) * (v.dim() - 2))
        return torch.gather(v, 1, idx.expand(sel.shape + v.shape[2:]))

    valid = pick(ok_all)
    out = dict(
        xy=pick(torch.cat(cand["xy"], dim=1)),
        response=torch.where(valid, pick(score_all), 0.0),
        size=pick(torch.cat(cand["size"], dim=1)),
        angle_deg=torch.rad2deg(torch.remainder(
            pick(torch.cat(cand["angle"], dim=1)), 2 * math.pi)),
        desc=pick(torch.cat(cand["desc"], dim=1)) * valid[..., None],
        valid=valid,
    )
    if n_out < nfeatures:
        pad = nfeatures - n_out
        out = {k: torch.cat([v, v.new_zeros((B, pad) + tuple(v.shape[2:]))],
                            dim=1) for k, v in out.items()}
    return out


# per-keypoint window radius: BRIEF pattern offsets are clipped to
# |p| <= 13, so a rotated sample stays within ceil(13*sqrt(2)) = 19 of
# the keypoint; windows of (2R+2)^2 also cover the 31x31 orientation
# patch. BORDER (21) keeps every window inside its own pyramid level.
_WIN_R = 19
_WIN = 2 * _WIN_R + 2      # 40


def _kp_windows(stack, lvls, xs, ys):
    """One (40, 40) window per keypoint from the (B, L, H, W) level stack.

    lvls/xs/ys: (B, N). Window starts clamp so the window fits the stacked
    (L * H, W) plane, as `lax.dynamic_slice` clamps them."""
    B, L, H, W = stack.shape
    flat = stack.reshape(B, L * H * W)
    y0 = (lvls * H + ys - _WIN_R).clamp(0, L * H - _WIN)
    x0 = (xs - _WIN_R).clamp(0, W - _WIN)
    r = torch.arange(_WIN, device=stack.device)
    rows = y0[..., None, None] + r[:, None]                  # (B, N, 40, 1)
    cols = x0[..., None, None] + r[None, :]                  # (B, N, 1, 40)
    idx = (rows * W + cols).reshape(B, -1)
    return torch.gather(flat, 1, idx).reshape(B, -1, _WIN, _WIN)


def _orientation_pyr(pyr, lvls, xs, ys):
    """Intensity-centroid angle from each keypoint's window: (B, N)."""
    win = _kp_windows(pyr, lvls, xs, ys)
    d = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    dy, dx = np.meshgrid(d, d, indexing="ij")
    o = _WIN_R - HALF_PATCH                        # patch offset in window
    wx = np.zeros((_WIN, _WIN), np.float32)
    wy = np.zeros((_WIN, _WIN), np.float32)
    wx[o:o + PATCH_SIZE, o:o + PATCH_SIZE] = dx * CIRC_MASK
    wy[o:o + PATCH_SIZE, o:o + PATCH_SIZE] = dy * CIRC_MASK
    m10 = (win * torch.as_tensor(wx, device=win.device)).sum(dim=(-2, -1))
    m01 = (win * torch.as_tensor(wy, device=win.device)).sum(dim=(-2, -1))
    return torch.atan2(m01, m10)


def _brief_descriptors_pyr(pyr_blur, lvls, xs, ys, angles,
                           pattern=BRIEF_PATTERN):
    """Steered BRIEF bits from the blurred level stack: (B, N, 256) {0,1}."""
    win = _kp_windows(pyr_blur, lvls, xs, ys)           # (B, N, 40, 40)
    pat = torch.as_tensor(pattern, dtype=torch.float32, device=win.device)
    cos, sin = torch.cos(angles), torch.sin(angles)     # (B, N)
    px, py = pat[..., 0], pat[..., 1]                   # (256, 2)
    c = cos[..., None, None]
    s = sin[..., None, None]
    rx = torch.round(px * c - py * s)                   # (B, N, 256, 2)
    ry = torch.round(px * s + py * c)
    ri = (ry.long() + _WIN_R).clamp(0, _WIN - 1)
    ci = (rx.long() + _WIN_R).clamp(0, _WIN - 1)
    B, N = win.shape[0], win.shape[1]
    flat = win.reshape(B, N, _WIN * _WIN)
    vals = torch.gather(flat, 2, (ri * _WIN + ci).reshape(B, N, -1))
    vals = vals.reshape(B, N, N_BITS, 2)
    return (vals[..., 0] < vals[..., 1]).to(torch.float32)


def _blur_for_desc(img):
    return gaussian_blur(img, 2.0, radius=3)


def detect_orb(gray, mask=None, *, nfeatures=500):
    """ORB detection on (B, H, W) float32 [0,255] planes.

    mask: optional (B, H, W) bool region gate. Returns a dict of (B, N, ...)
    tensors with N = nfeatures: xy (base-level coords), response, size,
    angle_deg, desc (B, N, 256) {0,1} float32, valid.
    """
    B, h, w = gray.shape
    dev = gray.device
    sizes = _level_sizes(h, w)
    quotas = _level_quotas(nfeatures, len(sizes))

    cand = {k: [] for k in ("score", "x", "y", "lvl", "inq")}
    level_imgs = []
    for lvl, (lh, lw) in enumerate(sizes):
        img = gray if lvl == 0 else resize_linear_aa(gray, lh, lw)
        level_imgs.append(img)
        corners = fast_corners(img)
        score = harris_response(img)

        ys_i = torch.arange(lh, device=dev)[:, None]
        xs_i = torch.arange(lw, device=dev)[None, :]
        inb = ((ys_i >= BORDER) & (ys_i < lh - BORDER)
               & (xs_i >= BORDER) & (xs_i < lw - BORDER))
        gate = corners & inb
        if mask is not None:
            gate = gate & (resize_nearest(mask.to(torch.float32), lh, lw)
                           > 0.5)
        score = torch.where(gate, score, NEG_INF)
        mx = _max3(score)
        score = torch.where(score >= mx, score, NEG_INF)

        k_cap = min(2 * quotas[lvl] + 32, lh * lw)
        top_scores, top_idx = topk_stable(score.reshape(B, -1), k_cap)
        ys = top_idx // lw
        xs = top_idx % lw
        ok = top_scores > NEG_INF / 2
        rank = torch.arange(k_cap, device=dev)
        cand["score"].append(torch.where(ok, top_scores, NEG_INF))
        cand["x"].append(xs)
        cand["y"].append(ys)
        cand["lvl"].append(torch.full((B, k_cap), lvl, device=dev,
                                      dtype=torch.long))
        cand["inq"].append((rank < quotas[lvl]) & ok)

    score_all = torch.cat(cand["score"], dim=1)
    x_all = torch.cat(cand["x"], dim=1)
    y_all = torch.cat(cand["y"], dim=1)
    lvl_all = torch.cat(cand["lvl"], dim=1)
    inq_all = torch.cat(cand["inq"], dim=1)

    # Global selection: quota winners first (score boost), then best leftovers.
    boost = torch.where(inq_all, 1e30, 0.0)
    ok_all = score_all > -1e38
    sel_score = torch.where(ok_all, score_all * 1e-20 + boost, -math.inf)
    n_out = min(nfeatures, sel_score.shape[1])
    _, sel = topk_stable(sel_score, n_out)
    out_valid = torch.gather(ok_all, 1, sel)
    sel_x = torch.gather(x_all, 1, sel)
    sel_y = torch.gather(y_all, 1, sel)
    sel_lvl = torch.gather(lvl_all, 1, sel)

    # Phase 2: stack the levels (padded to the base extent) and sample
    # orientation + steered BRIEF only for the selected keypoints.
    def pad_to_base(im):
        return torch.nn.functional.pad(
            im, (0, w - im.shape[-1], 0, h - im.shape[-2]))

    pyr = torch.stack([pad_to_base(im) for im in level_imgs], dim=1)
    pyr_blur = torch.stack([pad_to_base(_blur_for_desc(im))
                            for im in level_imgs], dim=1)
    scales = torch.tensor([SCALE_FACTOR ** i for i in range(len(sizes))],
                          dtype=torch.float32, device=dev)
    ang = _orientation_pyr(pyr, sel_lvl, sel_x, sel_y)
    desc = _brief_descriptors_pyr(pyr_blur, sel_lvl, sel_x, sel_y, ang)

    sc = scales[sel_lvl]
    lvl_f = sel_lvl.to(torch.float32)
    out = dict(
        # Corner-aligned x*scale mapping (cv.ORB convention).
        xy=torch.stack([sel_x.to(torch.float32) * sc,
                        sel_y.to(torch.float32) * sc], dim=-1),
        response=torch.where(out_valid, torch.gather(score_all, 1, sel),
                             0.0),
        size=PATCH_SIZE * torch.pow(torch.tensor(SCALE_FACTOR,
                                                 dtype=torch.float32,
                                                 device=dev), lvl_f),
        angle_deg=torch.rad2deg(torch.remainder(ang, 2 * math.pi)),
        desc=desc * out_valid[..., None],
        valid=out_valid,
    )
    if n_out < nfeatures:
        pad = nfeatures - n_out

        def pad_n(v):
            z = v.new_zeros((B, pad) + tuple(v.shape[2:]))
            return torch.cat([v, z], dim=1)

        out = {k: pad_n(v) for k, v in out.items()}
    return out
