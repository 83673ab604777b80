"""BRISK keypoints + 512-bit descriptors on the card.

Port of `stitching_tpu/ops/brisk.py::detect_brisk` (Leutenegger, Chli,
Siegwart, ICCV 2011): a scale space of octaves and intra-octaves (factors
1, 1.5, 2, 3, 4, 6, 8, 12, each level resized from the image itself),
FAST-9 corners ranked by the Harris response, the concentric 60-point
sampling pattern with one Gaussian-smoothed plane per ring, the
orientation from the long pairs' gradient estimate and the 512 short
pairs' comparisons as the descriptor. Written over a batch of same-sized
planes (B, H, W), the reference's `vmap` axis.

The levels reproduce `jax.image.resize(..., "linear")` (`orb.
resize_linear_aa`), so levels other than the base carry the ORB pyramid's
last-bit gap (ROADMAP queue 3). The orientation's gradient estimate is a
product over the long pairs summed in another order than XLA's, so an
angle can differ in its last bits and, where a rotated sample lands on a
rounding edge, a descriptor bit can flip. Selection reproduces
`lax.top_k`'s order (ties: lower index first); the final selection ranks
every in-quota candidate equally in float32 (`score * 1e-20 + 1e30`), so
it rests on that order alone.
"""

import numpy as np
import torch

from .fma import fma
from .gaussian import gaussian_blur
from .orb import (BORDER, NEG_INF, _level_quotas, _max3, fast_corners,
                  harris_response, resize_linear_aa, resize_nearest,
                  select_candidates, topk_stable)

# BRISK pattern geometry (pattern scale 1.0 <-> keypoint size 12).
_RINGS = (
    (0.0, 1),
    (2.9, 10),
    (4.9, 14),
    (7.4, 15),
    (10.8, 20),
)
_D_MAX = 9.75    # short-pair distance bound (descriptor)
_D_MIN = 13.67   # long-pair distance bound (orientation)
N_BITS = 512
# octave/intra-octave ladder (paper: octaves c_i and intra-octaves d_i)
_SCALES = (1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0)

# The 512 short pairs (i, j) of pattern points in the reference's order, one
# byte a point. The reference takes the 512 shortest of `np.argsort`'s
# default (unstable) order, and the pattern has many equal distances, so
# that order is whatever the host's sort gave; a stable sort gives the same
# set in another order. The port keeps the order as data, so that every
# host gives the same bits (`tests/test_torch_brisk.py` holds it against
# the reference's table and checks that it is the 512 shortest pairs,
# shortest first).
_SHORT_PAIRS_HEX = (
    "04050708090a020301020506060703040809010a010b061208150916030e040f"
    "07130511020c0a1816170e0f11120d0e12130b180c0d0f10151610110b0c1314"
    "14151718051007140a17020d030d0917081404100b190c1a182717260d1b1625"
    "0e1c15240f1d0613010c061101181423101e1322111f12211220030f0816040e"
    "091513211120000a0008000900050002000400070003000100061422101f020b"
    "051207120a0b1f2021221a1b26272021252624251b1c1d1e22231c1d23241e1f"
    "1927191a0f1e152316240e1d0d1c1725050f020e0a160715383930313334292a"
    "35362b2c2e2f3a3b37383233282931322d2e2c2d283b3637393a2a2b34352f30"
    "25381c2c1f30223419280204020a0109040605070709010303050608080a1826"
    "0c1b203121331a29273b243726391d2d1b2b23351e2f0b1a0b27030c04110918"
    "081318190c190d1a1727010d01170610061424361d2e23361e2e263a1b2a273a"
    "213220321a2a16260e1b15250f1c0310040d091408171424101d0d0f0c181113"
    "141615170e10101216180b0d121413150b170c0e0f111323111e051307110218"
    "0a0c1c2d1f312233193b253719291c2b25391f2f22351222121f0722031c051f"
    "0119092506210823041e0620021b041d021a0a2708240a260716050e0a15020f"
    "13201121030a020905080407020506090306070a0108010410201421090b0812"
    "0412030b0127011a0723031d031b051e05200721092409260013001400180017"
    "00100011000d000c000b0012000e000f0016001515220f1f24381d2c1b2c2638"
    "2134203023341a2827281e3016230e1e010e06150116060f17240d1d061f0622"
    "0825041c041f08220a250a190219021c091308180311040c18250c1c0b1b0b26"
    "0309020802060307040a05090408060a01070105051407100a0d0217181a0c27"
    "203324351a2b21312739263b1d2f1b2923371e2d0d191719050a030802070409"
    "010607170a140210050d031a031e011b012607200927092305210724051d0b28"
    "12320d2b102f17391435153616380e2c0f2e16270e1a0c291333183b11310318"
    "090c081104131e20212323251a2719261a1c1c1e2022191b1d1f24261f212527"
    "22241b1d0c2a11301334183a15260f1b0b16121515180b0e13160d1810131417"
    "0c0f11140f120e110d100c17153716370f2d0e2d173a0d2a14341030010f060e"
    "06160115101c1425123312310b290b3b1324111d040b080b03120912102e1436"
    "0d2c17380623061e08210420041b0227021d0a1a08260a2425361c2e253a1c2a"
    "1f321f2e192a2236193a2232121e12230e2b163915350f2f070f0a0e02160515"
    "1122131f36383537283a282a30322b2d2d2f2c2e37393234293b3133383a292b"
    "2a2c33352e302f31393b34360c2818281132133202110a13050c071814201021"
)


def _build_pattern():
    """Sample points (60, 2), per-point ring index, per-ring sigmas, and
    the short/long pair index tables."""
    pts, ring_of = [], []
    sigmas = []
    for ring_idx, (radius, count) in enumerate(_RINGS):
        # sigma proportional to on-ring point spacing (paper sec. 4.1)
        spacing = (2 * np.pi * radius / count) if radius > 0 else 1.0
        sigmas.append(max(0.55 * spacing, 0.6))
        for k in range(count):
            a = 2.0 * np.pi * k / count
            pts.append((radius * np.cos(a), radius * np.sin(a)))
            ring_of.append(ring_idx)
    pts = np.asarray(pts, np.float32)
    ring_of = np.asarray(ring_of, np.int32)
    ii, jj = np.triu_indices(len(pts), k=1)
    d = np.linalg.norm(pts[ii] - pts[jj], axis=1)
    long_pairs = np.stack([ii[d > _D_MIN], jj[d > _D_MIN]], 1)
    short_pairs = np.frombuffer(bytes.fromhex("".join(_SHORT_PAIRS_HEX)),
                                np.uint8).reshape(N_BITS, 2).astype(np.int64)
    return pts, ring_of, np.asarray(sigmas, np.float32), short_pairs, \
        long_pairs


PATTERN_PTS, PATTERN_RING, PATTERN_SIGMAS, SHORT_PAIRS, LONG_PAIRS = \
    _build_pattern()


def _sample_pattern(planes, xs, ys, pat_x, pat_y, ring):
    """The pattern's intensities for every keypoint: planes (B, 5, H, W)
    (one blurred plane per ring), xs/ys (B, N), pat_x/pat_y (B, N, 60)
    offsets (already rotated); ring (60,). Returns (B, N, 60)."""
    B, R, h, w = planes.shape
    sx = torch.round(xs[..., None] + pat_x).long().clamp(0, w - 1)
    sy = torch.round(ys[..., None] + pat_y).long().clamp(0, h - 1)
    idx = (ring * h + sy) * w + sx
    return torch.gather(planes.reshape(B, -1), 1,
                        idx.reshape(B, -1)).reshape(idx.shape)


def _brisk_level(img, region, quota_cap):
    """Detect and describe on one scale-space level (B, h, w): per-candidate
    tensors of static length quota_cap."""
    dev = img.device
    B, h, w = img.shape
    corners = fast_corners(img)
    score = harris_response(img)
    ys_i = torch.arange(h, device=dev)[:, None]
    xs_i = torch.arange(w, device=dev)[None, :]
    inb = ((ys_i >= BORDER) & (ys_i < h - BORDER)
           & (xs_i >= BORDER) & (xs_i < w - BORDER))
    score = torch.where(corners & inb & region, score, NEG_INF)
    score = torch.where(score >= _max3(score), score, NEG_INF)
    top_scores, top_idx = topk_stable(score.reshape(B, -1), quota_cap)
    ys = top_idx // w
    xs = top_idx % w
    ok = top_scores > NEG_INF / 2

    # ring-sigma blurred planes for pattern sampling
    planes = torch.stack([gaussian_blur(img, float(s), radius=3)
                          for s in PATTERN_SIGMAS], dim=1)
    pts = torch.as_tensor(PATTERN_PTS, device=dev)              # (60, 2)
    ring = torch.as_tensor(PATTERN_RING, device=dev).long()
    px, py = pts[:, 0], pts[:, 1]
    # orientation from LONG pairs on the unrotated pattern
    zeros = torch.zeros((B, quota_cap, 1), device=dev)
    vals0 = _sample_pattern(planes, xs, ys, zeros + px, zeros + py, ring)
    lp = torch.as_tensor(LONG_PAIRS, device=dev)
    diff_i = pts[lp[:, 1]] - pts[lp[:, 0]]                       # (L, 2)
    inv_d2 = 1.0 / torch.clamp_min((diff_i ** 2).sum(-1), 1e-9)
    grad = vals0[..., lp[:, 1]] - vals0[..., lp[:, 0]]           # (B, N, L)
    g = torch.matmul(grad * inv_d2, diff_i)                      # (B, N, 2)
    angle = torch.atan2(g[..., 1], g[..., 0])

    # rotate the pattern per keypoint, sample, compare SHORT pairs
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx = px * cos - py * sin
    ry = px * sin + py * cos
    vals = _sample_pattern(planes, xs, ys, rx, ry, ring)
    sp = torch.as_tensor(SHORT_PAIRS, device=dev)
    desc = (vals[..., sp[:, 0]] < vals[..., sp[:, 1]]).to(torch.float32)
    return dict(score=torch.where(ok, top_scores, NEG_INF), xs=xs, ys=ys,
                ok=ok, angle=angle, desc=desc)


def detect_brisk(gray, mask=None, *, nfeatures=1024):
    """BRISK detection on (B, H, W) float32 [0, 255] planes.

    mask: optional (B, H, W) bool region gate. Returns a dict of (B, N, ...)
    tensors with N = nfeatures, as `orb.detect_orb`: xy (base coords),
    response, size, angle_deg, desc (B, N, 512) {0,1} float32, valid.
    """
    B, h, w = gray.shape
    dev = gray.device
    levels = []
    for s in _SCALES:
        lh, lw = int(round(h / s)), int(round(w / s))
        if lh < 2 * BORDER + 1 or lw < 2 * BORDER + 1:
            break
        levels.append((s, lh, lw))
    quotas = _level_quotas(nfeatures, len(levels))

    cand = {k: [] for k in ("score", "xy", "angle", "desc", "size", "inq")}
    for lvl, (s, lh, lw) in enumerate(levels):
        img = gray if s == 1.0 else resize_linear_aa(gray, lh, lw)
        if mask is not None:
            region = resize_nearest(mask.to(torch.float32), lh, lw) > 0.5
        else:
            region = torch.ones((B, lh, lw), dtype=torch.bool, device=dev)
        cap = min(2 * quotas[lvl] + 32, lh * lw)
        out = _brisk_level(img, region, cap)
        rank = torch.arange(cap, device=dev)
        cand["score"].append(out["score"])
        # half-pixel centres: level pixel x sits at base coordinate
        # (x + 0.5) * (w / lw) - 0.5, one multiply-add in the reference's
        # compiled code
        cand["xy"].append(torch.stack(
            [fma(out["xs"].to(torch.float32) + 0.5, w / lw, -0.5),
             fma(out["ys"].to(torch.float32) + 0.5, h / lh, -0.5)], dim=-1))
        cand["angle"].append(out["angle"])
        cand["desc"].append(out["desc"])
        cand["size"].append(torch.full((B, cap), 12.0 * s, device=dev))
        cand["inq"].append((rank < quotas[lvl]) & out["ok"])
    return select_candidates(cand, nfeatures)
