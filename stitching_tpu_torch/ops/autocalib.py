"""Focal self-calibration from pairwise homographies (host numpy).

Port of `stitching_tpu/ops/autocalib.py` (its host path): the equivalent of
cv.detail.focalsFromHomography / estimateFocal. Rotation-only
self-calibration of Shum & Szeliski: with H = K1 R K0^-1 and K = diag(f, f, 1)
(centered coords), orthogonality of the rows/columns of K1^-1 H K0 gives two
estimates each for f0 (source) and f1 (destination). A handful of 3x3s is
microseconds of numpy, so it stays on the host.
"""

import numpy as np


def focals_from_homography(H):
    """H: (..., 3, 3) acting on centered coords.

    Returns (f0, f0_ok, f1, f1_ok)."""
    h = H.reshape(H.shape[:-2] + (9,))
    h0, h1, h2, h3, h4, h5, h6, h7, h8 = [h[..., i] for i in range(9)]

    # f1 (destination image), from column orthogonality / equal norms:
    d1 = h6 * h7
    d2 = (h7 - h6) * (h7 + h6)
    v1 = -(h0 * h1 + h3 * h4) / np.where(d1 == 0, 1e-30, d1)
    v2 = (h0 * h0 + h3 * h3 - h1 * h1 - h4 * h4) / np.where(
        d2 == 0, 1e-30, d2)
    use1 = np.abs(d1) > np.abs(d2)
    both = (v1 > 0) & (v2 > 0)
    pick = np.where(both, np.where(use1, v1, v2),
                    np.where(v1 > 0, v1, v2))
    f1_ok = (v1 > 0) | (v2 > 0)
    f1 = np.sqrt(np.maximum(pick, 0.0))

    # f0 (source image), from row orthogonality / equal norms:
    d1s = h0 * h3 + h1 * h4
    d2s = h0 * h0 + h1 * h1 - h3 * h3 - h4 * h4
    w1 = -h2 * h5 / np.where(d1s == 0, 1e-30, d1s)
    w2 = (h5 * h5 - h2 * h2) / np.where(d2s == 0, 1e-30, d2s)
    use1s = np.abs(d1s) > np.abs(d2s)
    boths = (w1 > 0) & (w2 > 0)
    picks = np.where(boths, np.where(use1s, w1, w2),
                     np.where(w1 > 0, w1, w2))
    f0_ok = (w1 > 0) | (w2 > 0)
    f0 = np.sqrt(np.maximum(picks, 0.0))

    return f0, f0_ok, f1, f1_ok


def estimate_focals(Hs, conf):
    """Median pairwise focal estimate.

    Hs: (P, 3, 3) homographies (centered coords); conf: (P,) pair confidence
    (0 for absent pairs). Returns (focal, n_ok): median over sqrt(f0*f1) of
    pairs where both estimates are valid; focal is NaN if none.
    """
    with np.errstate(invalid="ignore", divide="ignore"):
        Hs = np.asarray(Hs, np.float32)
        conf = np.asarray(conf, np.float32)
        f0, ok0, f1, ok1 = focals_from_homography(Hs)
        ok = ok0 & ok1 & (conf > 0)
        vals = np.where(ok, np.sqrt(f0 * f1), np.nan)
        if not ok.any():
            return float("nan"), 0
        return float(np.nanmedian(vals)), int(ok.sum())
