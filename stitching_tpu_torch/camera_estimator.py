"""Initial camera parameter estimation (host code).

Port of `stitching_tpu/camera_estimator.py`: choices homography (default) /
affine. The homography path is the equivalent of
`cv.detail_HomographyBasedEstimator` (SURVEY.md §2b):

1. per-pair focal estimates from homography self-calibration
   (`ops/autocalib.py`, numpy over the pair axis), global focal =
   median (fallback: mean image dimension sum when no pair yields one);
2. maximum spanning tree over the match graph (weights = num_inliers),
   rooted at the tree center;
3. rotations propagated along tree edges via
   R_child = R_parent @ K_parent^-1 @ H_parent->child^-1 @ K_child
   (verified convention vs the OpenCV oracle; see tests/test_cameras.py).

Principal points are set to the image center (OpenCV convention, verified).
MST + propagation run on host (tiny N); all per-pair math is vectorized.

The affine path mirrors `cv.detail_AffineBasedEstimator`: identity K, and R
the pairwise 2-D similarities chained along the same spanning tree
(R_v = H(u->v) @ R_u from the tree center), panorama -> image coordinates.
"""

from collections import OrderedDict

import numpy as np

from .errors import StitchingError
from .feature_matcher import FeatureMatcher
from .ops.autocalib import estimate_focals
from .types import CameraParams


def _k_matrix(focal):
    return np.array([[focal, 0, 0], [0, focal, 0], [0, 0, 1]], np.float64)


def _max_spanning_tree(n, weight):
    """Prim's max spanning tree. weight: (n, n) symmetric >= 0.
    Returns adjacency list and the tree center node."""
    in_tree = [0]
    edges = {i: [] for i in range(n)}
    while len(in_tree) < n:
        best = (-1.0, None, None)
        for a in in_tree:
            for b in range(n):
                if b in in_tree:
                    continue
                if weight[a, b] > best[0]:
                    best = (weight[a, b], a, b)
        _, a, b = best
        if a is None:
            break  # disconnected (should not happen post-subsetting)
        edges[a].append(b)
        edges[b].append(a)
        in_tree.append(b)

    # Tree center: node minimizing max hop distance.
    def bfs_depth(root):
        seen = {root: 0}
        frontier = [root]
        while frontier:
            nxt = []
            for u in frontier:
                for v in edges[u]:
                    if v not in seen:
                        seen[v] = seen[u] + 1
                        nxt.append(v)
            frontier = nxt
        return max(seen.values())

    center = min(range(n), key=bfs_depth)
    return edges, center


def _chain_along_tree(matrix, link):
    """Per-image transforms from the max spanning tree of the match graph
    (weights: inlier counts): the tree center gets the identity, and each
    child v of u gets `link(R_u, H_uv)`, or R_u where the pair has no H.
    Images the tree does not reach get None."""
    n = len(matrix)
    inl_w = np.asarray([[matrix[i][j].num_inliers for j in range(n)]
                        for i in range(n)], np.float64)
    edges, center = _max_spanning_tree(n, inl_w)
    Rs = [None] * n
    Rs[center] = np.eye(3)
    frontier = [center]
    while frontier:
        nxt = []
        for u in frontier:
            for v in edges[u]:
                if Rs[v] is None:
                    H_uv = matrix[u][v].H
                    Rs[v] = (Rs[u].copy() if H_uv is None
                             else link(Rs[u], H_uv))
                    nxt.append(v)
        frontier = nxt
    return Rs


class CameraEstimator:
    CAMERA_ESTIMATOR_CHOICES = OrderedDict(
        homography="homography",
        affine="affine",
    )
    DEFAULT_CAMERA_ESTIMATOR = list(CAMERA_ESTIMATOR_CHOICES.keys())[0]

    def __init__(self, estimator=DEFAULT_CAMERA_ESTIMATOR, **kwargs):
        if estimator not in self.CAMERA_ESTIMATOR_CHOICES:
            raise StitchingError("invalid estimator: " + str(estimator))
        self.estimator_type = estimator

    def estimate(self, features, pairwise_matches):
        if self.estimator_type == "affine":
            cameras = self._estimate_affine(features, pairwise_matches)
        else:
            cameras = self._estimate_homography(features, pairwise_matches)
        if cameras is None:
            raise StitchingError("Homography estimation failed.")
        for cam in cameras:
            cam.R = cam.R.astype(np.float32)
        return cameras

    # ---- homography-based (rotation model) ----

    def _estimate_homography(self, features, matches):
        n = len(features)
        matrix = FeatureMatcher.get_matches_matrix(matches)

        # Focals: vectorized self-calibration over all confident pairs.
        Hs, confs = [], []
        for i in range(n):
            for j in range(n):
                m = matrix[i][j]
                if i != j and m.H is not None and m.confidence > 0:
                    Hs.append(m.H)
                    confs.append(m.confidence)
        if Hs:
            # host numpy: a handful of 3x3s
            focal, n_ok = estimate_focals(
                np.stack(Hs).astype(np.float32),
                np.asarray(confs, np.float32))
        else:
            focal, n_ok = np.nan, 0
        if not np.isfinite(focal) or n_ok == 0:
            # Fallback when self-calibration fails: FOV-plausible focal from
            # image dimensions.
            focal = float(np.mean(
                [f.img_size[0] + f.img_size[1] for f in features]))

        K = _k_matrix(focal)
        K_inv = np.linalg.inv(K)
        Rs = _chain_along_tree(
            matrix, lambda R_u, H_uv: R_u @ K_inv @ np.linalg.inv(H_uv) @ K)

        cams = []
        for i in range(n):
            w, h = features[i].img_size
            cams.append(CameraParams(
                focal=focal, aspect=1.0, ppx=0.5 * w, ppy=0.5 * h,
                R=(Rs[i] if Rs[i] is not None else np.eye(3)).astype(
                    np.float32)))
        return cams

    # ---- affine-based ----

    def _estimate_affine(self, features, matches):
        # R_i maps panorama (= tree-center image) coords -> image i coords
        # (the affine H are 3x3 in raw pixels)
        Rs = _chain_along_tree(FeatureMatcher.get_matches_matrix(matches),
                               lambda R_u, H_uv: H_uv @ R_u)
        return [CameraParams(
            focal=1.0, aspect=1.0, ppx=0.0, ppy=0.0,
            R=(R if R is not None else np.eye(3)).astype(np.float32))
            for R in Rs]
