"""Batched fixed-iteration RANSAC over a batch of image pairs: the
homography and the 4-DoF similarity (partial affine) models.

Port of `stitching_tpu/ops/ransac.py`'s `ransac_homography` and
`ransac_affine_partial` (which the JAX matcher vmaps over pairs; here the
pair axis P is written out). A static batch of K minimal samples per
pair (K = 512; the homography takes another K as `n_iters`) is drawn at
once, all minimal systems are solved batched (8x8 solves for the
homography, the closed form for the similarity), every hypothesis is
scored against every point as one (P, K, M) tensor, and the best by inlier
count is refined by 2 reweighted least-squares passes on its inliers.

The minimal samples are the top-4 (homography) or top-2 (similarity) of
`jax.random.uniform(PRNGKey(seed), (K, M))`; `threefry_uniform`
reproduces that draw bit for bit (threefry 2x32 over a partitionable 64-bit
iota, as JAX draws it), so the port picks the same hypotheses as the
reference. Of those, the homography drops the samples that fold
(`_orientation_kept`), as `cv::findHomography` does and the JAX package
does not.
"""

import math

import torch

RANSAC_THRESH = 3.0       # px, cv.findHomography's default in cv.detail
N_HYPOTHESES = 512

_MASK32 = 0xFFFFFFFF
_CPU_CHUNK = 1 << 17      # draws a slice on the host (`threefry_uniform`)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & _MASK32


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 (20 rounds) on uint32 values held in int64 tensors."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def threefry_uniform(seeds, shape, device=None):
    """`jax.random.uniform(jax.random.PRNGKey(seed), shape)` per seed.

    seeds: (P,) uint32 seeds (any integer tensor or sequence). Returns
    (P, *shape) float32 in [0, 1): key (0, seed), counters the flat index
    split into high/low 32-bit words, bits = out0 ^ out1, and the float
    from the top 23 bits.
    """
    seeds = torch.as_tensor(seeds, device=device).to(torch.int64) & _MASK32
    n = math.prod(shape)
    if seeds.device.type == "cpu":
        # on the host the 20 rounds go through memory once each; a
        # cache-sized slice at a time takes a sixth of the time (153 pairs
        # of 512 x 1000 draws: 51 s -> 8 s on two threads)
        f = torch.empty(seeds.shape[0] * n, dtype=torch.float32)
        for lo in range(0, len(f), _CPU_CHUNK):
            at = torch.arange(lo, min(lo + _CPU_CHUNK, len(f)))
            f[lo:lo + len(at)] = _uniform(seeds[at // n], at % n)
    else:
        f = _uniform(seeds[:, None], torch.arange(n, device=seeds.device))
    return f.reshape((seeds.shape[0],) + tuple(shape))


def _uniform(k2, count):
    """The float in [0, 1) of key (0, k2) at counter `count` (broadcast)."""
    x0, x1 = threefry2x32(torch.zeros_like(k2), k2, count >> 32,
                          count & _MASK32)
    bits = x0 ^ x1
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0


def _normalize_points(pts, valid):
    """Hartley normalization over valid points -> (T (P,3,3), pts_norm)."""
    w = valid.to(torch.float32)
    n = torch.clamp_min(w.sum(-1), 1.0)                        # (P,)
    mean = (pts * w[..., None]).sum(-2) / n[:, None]           # (P, 2)
    d = torch.sqrt(((pts - mean[:, None]) ** 2).sum(-1)) * w
    scale = math.sqrt(2.0) / torch.clamp_min(d.sum(-1) / n, 1e-8)
    P = pts.shape[0]
    T = torch.zeros((P, 3, 3), dtype=pts.dtype, device=pts.device)
    T[:, 0, 0] = scale
    T[:, 1, 1] = scale
    T[:, 0, 2] = -mean[:, 0] * scale
    T[:, 1, 2] = -mean[:, 1] * scale
    T[:, 2, 2] = 1.0
    return T, (pts - mean[:, None]) * scale[:, None, None]


def _h_from_4pts(src4, dst4):
    """Batched DLT with h33=1: src4/dst4 (..., 4, 2) -> H (..., 3, 3)."""
    x, y = src4[..., 0], src4[..., 1]
    u, v = dst4[..., 0], dst4[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    rows_u = torch.stack([x, y, o, z, z, z, -u * x, -u * y], dim=-1)
    rows_v = torch.stack([z, z, z, x, y, o, -v * x, -v * y], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)                    # (..., 8, 8)
    b = torch.cat([u, v], dim=-1)[..., None]                   # (..., 8, 1)
    # Guard singular systems with a tiny ridge; degenerate hypotheses lose
    # the inlier vote anyway. A system that stays singular yields non-finite
    # entries (as the reference's solve does), never an error: its
    # projections fail every inlier test.
    A = A + 1e-9 * torch.eye(8, dtype=A.dtype, device=A.device)
    h = torch.linalg.solve_ex(A, b).result[..., 0]             # (..., 8)
    ones = torch.ones(h.shape[:-1] + (1,), dtype=h.dtype, device=h.device)
    return torch.cat([h, ones], dim=-1).reshape(h.shape[:-1] + (3, 3))


def _apply_h(H, pts):
    """H: (P, ..., 3, 3); pts (P, M, 2) -> (P, ..., M, 2)."""
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    if H.dim() == 4:
        q = torch.einsum("pkij,pmj->pkmi", H, ph)
    else:
        q = torch.einsum("pij,pmj->pmi", H, ph)
    z = q[..., 2:]
    z = torch.where(z.abs() < 1e-12, 1e-12, z)
    return q[..., :2] / z


def _fit_h_lsq(src, dst, weights):
    """Weighted DLT over all points: eigenvector of A^T W A (P, 9, 9)."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    ru = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=-1)
    rv = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], dim=-1)
    A = torch.cat([ru, rv], dim=-2)                            # (P, 2M, 9)
    w = torch.cat([weights, weights], dim=-1)
    M9 = (A * w[..., None]).transpose(-1, -2) @ A
    _, evecs = torch.linalg.eigh(M9)
    return evecs[..., :, 0].reshape(-1, 3, 3)


def _spread(pts, min_d):
    """(P, K, 4, 2) -> (P, K): every pair of the 4 points is farther apart
    than min_d (P,)."""
    d = pts[..., :, None, :] - pts[..., None, :, :]
    d2 = (d * d).sum(-1)
    off_diag = ~torch.eye(4, dtype=torch.bool, device=pts.device)
    far = (torch.where(off_diag, d2, math.inf)
           > (min_d ** 2)[:, None, None, None])
    return far.all(dim=-1).all(dim=-1)


def _orientation_kept(src4, dst4):
    """(P, K, 4, 2) x 2 -> (P, K): the sample keeps its orientation, as
    `cv::findHomography`'s check of a minimal sample takes it (Marquez-Neila
    et al. 2013): each of the four triangles of the four points turns the
    same way in both views, or each the other way. A sample that folds
    gives a homography that no turn of a camera gives to points both views
    see; on an overlap that is a thin strip such a hypothesis can take in
    matches far off the strip and win the vote with them."""
    def turns(p, a, b, c):
        u = p[..., b, :] - p[..., a, :]
        v = p[..., c, :] - p[..., a, :]
        return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]

    flips = sum(((turns(src4, *t) * turns(dst4, *t)) < 0).to(torch.int32)
                for t in ((0, 1, 2), (1, 2, 3), (0, 2, 3), (1, 0, 3)))
    return (flips == 0) | (flips == 4)


def _compact(src, dst, valid):
    """Valid points first, in order (a stable sort), so that the samples
    hit them. Returns (order, src_c, dst_c, valid_c)."""
    order = torch.sort((~valid).to(torch.uint8), dim=-1, stable=True).indices
    src_c = torch.gather(src, 1, order[..., None].expand(-1, -1, 2))
    dst_c = torch.gather(dst, 1, order[..., None].expand(-1, -1, 2))
    return order, src_c, dst_c, torch.gather(valid, 1, order)


def _minimal_samples(seeds, nvalid, M, k, dev, n_iters=N_HYPOTHESES):
    """Duplicate-free minimal samples: the top-k of per-hypothesis noise
    restricted to the compacted valid prefix, ties to the lower index as
    `lax.top_k` takes them. Returns (P, n_iters, k) indices."""
    noise = threefry_uniform(seeds, (n_iters, M), device=dev)
    cols = torch.arange(M, device=dev)
    noise = torch.where(cols[None, None, :] < nvalid[:, None, None],
                        noise, -1.0)
    return torch.sort(noise, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def _take(pts, idx):
    """pts (P, M, 2) at idx (P, K, k) -> (P, K, k, 2)."""
    P = idx.shape[0]
    g = torch.gather(pts, 1, idx.reshape(P, -1)[..., None].expand(-1, -1, 2))
    return g.reshape(*idx.shape, 2)


def ransac_homography(src, dst, valid, seeds, *, n_iters=N_HYPOTHESES):
    """RANSAC homography fit for P pairs at once.

    Args: src, dst (P, M, 2) float32; valid (P, M) bool; seeds (P,) uint32;
    n_iters: hypotheses drawn per pair.
    Returns dict(H (P,3,3) f32 src->dst, inliers (P,M) bool,
                 num_inliers (P,) int32, ok (P,) bool).
    """
    P, M = valid.shape
    dev = src.device
    nvalid = valid.sum(-1)                                      # (P,)

    order, src_c, dst_c, valid_c = _compact(src, dst, valid)
    Ts, src_n = _normalize_points(src_c, valid_c)
    Td, dst_n = _normalize_points(dst_c, valid_c)

    idx = _minimal_samples(seeds, nvalid, M, 4, dev, n_iters)    # (P, K, 4)
    s4, d4 = _take(src_n, idx), _take(dst_n, idx)
    scale_s = Ts[:, 0, 0]
    scale_d = Td[:, 0, 0]
    hyp_ok = (_spread(s4, scale_s) & _spread(d4, scale_d)
              & _orientation_kept(s4, d4))                      # (P, K)

    H_n = _h_from_4pts(s4, d4)                                  # (P,K,3,3)
    proj = _apply_h(H_n, src_n)                                 # (P,K,M,2)
    err2 = ((proj - dst_n[:, None]) ** 2).sum(-1)               # (P,K,M)
    th2 = (RANSAC_THRESH * scale_d) ** 2                        # (P,)
    inl = ((err2 < th2[:, None, None]) & valid_c[:, None, :]
           & hyp_ok[..., None])
    counts = inl.sum(-1)
    # Tie-break equal counts by total inlier error.
    score = counts.to(torch.float32) - torch.where(
        inl, err2, 0.0).sum(-1) * 1e-8
    score = torch.where(hyp_ok, score, -math.inf)
    best = torch.argmax(score, dim=-1)                          # (P,)
    inliers_c = torch.gather(
        inl, 1, best[:, None, None].expand(-1, 1, M))[:, 0]
    any_hyp = hyp_ok.any(-1)

    # Refine on inliers (2 reweighted passes).
    for _ in range(2):
        H_ref = _fit_h_lsq(src_n, dst_n, inliers_c.to(torch.float32))
        err2_1 = ((_apply_h(H_ref, src_n) - dst_n) ** 2).sum(-1)
        inliers_c = (err2_1 < th2[:, None]) & valid_c

    # Denormalize: H = Td^-1 @ H_n @ Ts.
    H = torch.linalg.solve(Td, H_ref @ Ts)
    h22 = H[:, 2, 2]
    H = H / torch.where(h22.abs() < 1e-12, 1e-12, h22)[:, None, None]

    # Scatter inlier mask back to the original point order.
    inliers = torch.zeros_like(valid).scatter(1, order, inliers_c)
    num = inliers.sum(-1).to(torch.int32)
    ok = (nvalid >= 4) & (num >= 4) & any_hyp
    return dict(H=H, inliers=inliers, num_inliers=num, ok=ok)


def _sim_from_2pts(src2, dst2):
    """Batched 4-DoF similarity from 2 point pairs: (..., 2, 2) x 2 ->
    (..., 2, 3), [a -b tx; b a ty] mapping both src points onto dst."""
    p0, p1 = src2[..., 0, :], src2[..., 1, :]
    q0, q1 = dst2[..., 0, :], dst2[..., 1, :]
    dp = p1 - p0
    dq = q1 - q0
    den = (dp * dp).sum(-1)
    den = torch.where(den < 1e-12, 1e-12, den)
    a = (dp[..., 0] * dq[..., 0] + dp[..., 1] * dq[..., 1]) / den
    b = (dp[..., 0] * dq[..., 1] - dp[..., 1] * dq[..., 0]) / den
    tx = q0[..., 0] - (a * p0[..., 0] - b * p0[..., 1])
    ty = q0[..., 1] - (b * p0[..., 0] + a * p0[..., 1])
    return torch.stack([torch.stack([a, -b, tx], dim=-1),
                        torch.stack([b, a, ty], dim=-1)], dim=-2)


def _apply_affine(A, pts):
    """A: (P, ..., 2, 3); pts (P, M, 2) -> (P, ..., M, 2)."""
    lin = torch.einsum("p...ij,pmj->p...mi", A[..., :2], pts)
    return lin + A[..., None, :, 2]


def _fit_sim_lsq(src, dst, w):
    """Weighted least-squares similarity (a, b, tx, ty) per pair:
    src/dst (P, M, 2), w (P, M) -> (P, 2, 3)."""
    sw = w.sum(-1).clamp_min(1e-8)[:, None]
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    sx = (w * x).sum(-1, keepdim=True) / sw
    sy = (w * y).sum(-1, keepdim=True) / sw
    su = (w * u).sum(-1, keepdim=True) / sw
    sv = (w * v).sum(-1, keepdim=True) / sw
    xc, yc, uc, vc = x - sx, y - sy, u - su, v - sv
    d = (w * (xc * xc + yc * yc)).sum(-1).clamp_min(1e-12)
    a = (w * (xc * uc + yc * vc)).sum(-1) / d
    b = (w * (xc * vc - yc * uc)).sum(-1) / d
    tx = su[:, 0] - (a * sx[:, 0] - b * sy[:, 0])
    ty = sv[:, 0] - (b * sx[:, 0] + a * sy[:, 0])
    return torch.stack([torch.stack([a, -b, tx], dim=-1),
                        torch.stack([b, a, ty], dim=-1)], dim=-2)


def ransac_affine_partial(src, dst, valid, seeds):
    """RANSAC 4-DoF similarity fit for P pairs at once (the analog of
    cv.estimateAffinePartial2D), in raw pixel coordinates.

    Args: src, dst (P, M, 2) float32; valid (P, M) bool; seeds (P,) uint32.
    Returns dict(H (P,3,3) with [0,0,1] last row, inliers (P,M) bool,
                 num_inliers (P,) int32, ok (P,) bool).
    """
    P, M = valid.shape
    dev = src.device
    nvalid = valid.sum(-1)
    order, src_c, dst_c, valid_c = _compact(src, dst, valid)
    idx = _minimal_samples(seeds, nvalid, M, 2, dev)           # (P, K, 2)
    s2, d2 = _take(src_c, idx), _take(dst_c, idx)

    # Degenerate-sample rejection: distinct rows may carry coincident
    # points (many matches can share a keypoint); a 2-point hypothesis on
    # coincident points collapses to scale ~0. Require > 1 px separation
    # on both sides.
    hyp_ok = ((((s2[..., 0, :] - s2[..., 1, :]) ** 2).sum(-1) > 1.0)
              & (((d2[..., 0, :] - d2[..., 1, :]) ** 2).sum(-1) > 1.0))

    A = _sim_from_2pts(s2, d2)                                 # (P,K,2,3)
    err2 = ((_apply_affine(A, src_c) - dst_c[:, None]) ** 2).sum(-1)
    th2 = RANSAC_THRESH ** 2
    inl = (err2 < th2) & valid_c[:, None, :] & hyp_ok[..., None]
    score = inl.sum(-1).to(torch.float32) - torch.where(
        inl, err2, 0.0).sum(-1) * 1e-8
    score = torch.where(hyp_ok, score, -math.inf)
    best = torch.argmax(score, dim=-1)                         # (P,)
    inliers_c = torch.gather(
        inl, 1, best[:, None, None].expand(-1, 1, M))[:, 0]
    any_hyp = hyp_ok.any(-1)

    for _ in range(2):
        A_ref = _fit_sim_lsq(src_c, dst_c, inliers_c.to(torch.float32))
        err2_1 = ((_apply_affine(A_ref, src_c) - dst_c) ** 2).sum(-1)
        inliers_c = (err2_1 < th2) & valid_c

    last = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(P, 1, 3)
    H = torch.cat([A_ref, last], dim=1)
    # reject collapsed refined models too (the weighted LSQ can shrink the
    # scale toward 0 if the inlier set is itself near-degenerate)
    sc2 = A_ref[:, 0, 0] ** 2 + A_ref[:, 1, 0] ** 2
    inliers = torch.zeros_like(valid).scatter(1, order, inliers_c)
    num = inliers.sum(-1).to(torch.int32)
    ok = (nvalid >= 2) & (num >= 2) & any_hyp & (sc2 > 1e-6)
    return dict(H=H, inliers=inliers, num_inliers=num, ok=ok)
