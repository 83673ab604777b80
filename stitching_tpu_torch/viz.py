"""Host-side drawing helpers for keypoints and matches.

Port of `stitching_tpu/viz.py` (numpy only): the replacements for the
reference's cv.drawKeypoints / cv.drawMatches calls, used by
`FeatureDetector.draw_keypoints` and `FeatureMatcher.draw_matches`. Only
for human-facing debug artifacts, never on the compute path.
"""

import numpy as np


def _to_bgr(img):
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img.astype(np.uint8).copy()


def draw_circles(img, centers, radius=3, color=(0, 255, 0)):
    img = _to_bgr(img)
    h, w = img.shape[:2]
    t = np.arange(0, 2 * np.pi, 0.15)
    cx = np.cos(t) * radius
    cy = np.sin(t) * radius
    for x, y in np.asarray(centers).reshape(-1, 2):
        xs = np.clip(np.round(x + cx).astype(int), 0, w - 1)
        ys = np.clip(np.round(y + cy).astype(int), 0, h - 1)
        img[ys, xs] = color
    return img


def draw_line(img, p0, p1, color=(0, 255, 0)):
    h, w = img.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    xs = np.clip(np.round(np.linspace(p0[0], p1[0], n + 1)).astype(int), 0, w - 1)
    ys = np.clip(np.round(np.linspace(p0[1], p1[1], n + 1)).astype(int), 0, h - 1)
    img[ys, xs] = color
    return img


def draw_matches(img1, kps1, img2, kps2, pairs, inliers=None,
                 color=(0, 255, 0)):
    """Side-by-side match visualization (cv.drawMatches analog).

    pairs: (M, 2) integer indices into kps1/kps2; inliers: optional bool mask
    selecting which pairs to draw (the reference draws inliers only,
    `feature_matcher.py:38` drawMatches with matchesMask=inliers).
    """
    a, b = _to_bgr(img1), _to_bgr(img2)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    off = a.shape[1]
    pairs = np.asarray(pairs)
    if inliers is not None:
        pairs = pairs[np.asarray(inliers, bool)]
    for i, j in pairs:
        p0 = kps1[int(i)]
        p1 = (kps2[int(j)][0] + off, kps2[int(j)][1])
        draw_line(canvas, p0, p1, color)
    return canvas
