"""Camera bundle adjustment component.

Port of `stitching_tpu/camera_adjuster.py`: the adjuster registry (ray
default / reproj / affine / no), the 5-char "xxxxx" refinement mask over
(fx, skew, ppx, aspect, ppy) (skew accepted but ignored: K has none), the
confidence-threshold edge gating, and StitchingError on failure. The LM
machinery is `ops/bundle.py` (torch residuals + `torch.func.jacfwd`) and
runs on the stitcher's device; this component packs the fixed-capacity
(edge, match) problem tensors from the inlier matches on the host. The
affine adjuster refines the 4-DoF similarity cameras (a, b, tx, ty).
The profiler's counter `bundle/edges` takes the edges each packing keeps.
"""

from collections import OrderedDict

import numpy as np

from . import profiling as prof
from .errors import StitchingError
from .feature_matcher import FeatureMatcher
from .ops.bundle import solve_bundle
from .ops.rotation import matrix_to_rodrigues, rodrigues_to_matrix
from .types import CameraParams

_MATCH_CAP = 512  # per-edge inlier capacity (padded, static shape)


def _orthonormalize(R):
    u, _, vt = np.linalg.svd(R.astype(np.float64))
    return u @ vt


class CameraAdjuster:
    CAMERA_ADJUSTER_CHOICES = OrderedDict(
        ray="ray", reproj="reproj", affine="affine", no="no",
    )
    DEFAULT_CAMERA_ADJUSTER = list(CAMERA_ADJUSTER_CHOICES.keys())[0]
    DEFAULT_REFINEMENT_MASK = "xxxxx"
    mesh = None  # optional Mesh: splits the bundle-edge axis (engine sets)

    def __init__(
        self,
        adjuster=DEFAULT_CAMERA_ADJUSTER,
        refinement_mask=DEFAULT_REFINEMENT_MASK,
        confidence_threshold=1.0,
        device="cuda",
    ):
        if adjuster not in self.CAMERA_ADJUSTER_CHOICES:
            raise StitchingError("invalid adjuster: " + str(adjuster))
        self.adjuster = adjuster
        self.refinement_mask = refinement_mask
        self.confidence_threshold = confidence_threshold
        self.device = device

    def adjust(self, features, pairwise_matches, estimated_cameras):
        if self.adjuster == "no":
            return estimated_cameras
        problem = self._pack_problem(features, pairwise_matches)
        if problem is None:
            # No confident edges: nothing to adjust (mirrors the native
            # adjusters, which succeed trivially on an empty edge set).
            return estimated_cameras
        if self.adjuster == "affine":
            cams = self._adjust_affine(problem, estimated_cameras)
        else:
            cams = self._adjust_rotation(problem, estimated_cameras)
        if cams is None:
            raise StitchingError("Camera parameters adjusting failed.")
        return cams

    # ---- problem packing ----

    def _pack_problem(self, features, matches):
        n = len(features)
        matrix = FeatureMatcher.get_matches_matrix(matches)
        edges = []
        for i in range(n):
            for j in range(i + 1, n):
                if matrix[i][j].confidence > self.confidence_threshold:
                    edges.append((i, j))
        prof.count("bundle/edges", len(edges))
        if not edges:
            return None

        # the edge axis is padded to a multiple of 4, as in the reference
        # (padded edges carry w=0 and contribute nothing); under a mesh
        # the bucket must also divide over the ranks
        unit = 4 if self.mesh is None else int(np.lcm(4, self.mesh.size))
        E = -(-len(edges) // unit) * unit
        pts_src = np.zeros((E, _MATCH_CAP, 2), np.float32)
        pts_dst = np.zeros((E, _MATCH_CAP, 2), np.float32)
        w = np.zeros((E, _MATCH_CAP), np.float32)
        src_idx = np.zeros((E,), np.int32)
        dst_idx = np.zeros((E,), np.int32)
        for e, (i, j) in enumerate(edges):
            m = matrix[i][j]
            inl = m.inliers_mask & m.matches_valid
            pairs = m.matches[inl][:_MATCH_CAP]
            k = len(pairs)
            xy_i = np.asarray(features[i].xy)
            xy_j = np.asarray(features[j].xy)
            pts_src[e, :k] = xy_i[pairs[:, 0]]
            pts_dst[e, :k] = xy_j[pairs[:, 1]]
            w[e, :k] = 1.0
            src_idx[e], dst_idx[e] = i, j
        return dict(src_idx=src_idx, dst_idx=dst_idx, pts_src=pts_src,
                    pts_dst=pts_dst, w=w)

    def _intrinsics_mask(self):
        m = self.refinement_mask
        # positions: fx, skew (ignored), ppx, aspect, ppy
        return dict(
            focal=m[0] == "x", ppx=m[2] == "x",
            aspect=m[3] == "x", ppy=m[4] == "x",
        )

    # ---- rotation models (ray / reproj) ----

    def _adjust_rotation(self, problem, cameras):
        n = len(cameras)
        params0 = np.zeros((n, 7), np.float32)
        for i, c in enumerate(cameras):
            R = _orthonormalize(np.asarray(c.R, np.float64))
            rvec = np.asarray(matrix_to_rodrigues(R.astype(np.float32)))
            params0[i] = [c.focal, c.ppx, c.ppy, c.aspect, *rvec]

        im = self._intrinsics_mask()
        if self.adjuster == "ray":
            # The ray model optimizes only (focal, rotation) — 4 params per
            # camera, like cv.detail_BundleAdjusterRay; freeing pp/aspect
            # lets the optimizer bend rays and drift the focals.
            param_mask = np.array([
                im["focal"], False, False, False, True, True, True])
        else:
            param_mask = np.array([
                im["focal"], im["ppx"], im["ppy"], im["aspect"],
                True, True, True,
            ])
        full, _ = solve_bundle(problem, self.adjuster, param_mask, params0,
                               device=self.device, mesh=self.mesh)
        if not np.all(np.isfinite(full)):
            return None

        out = []
        for i, c in enumerate(cameras):
            R = np.asarray(
                rodrigues_to_matrix(np.asarray(full[i, 4:7], np.float32)))
            out.append(CameraParams(
                focal=float(full[i, 0]), aspect=float(full[i, 3]),
                ppx=float(full[i, 1]), ppy=float(full[i, 2]),
                R=R.astype(np.float32)))
        return out

    # ---- affine model (4-DoF similarity) ----

    def _adjust_affine(self, problem, cameras):
        params0 = np.zeros((len(cameras), 4), np.float32)
        for i, c in enumerate(cameras):
            A = np.asarray(c.R, np.float64)
            # (a, b, tx, ty) from the embedded 2x3 similarity
            params0[i] = [A[0, 0], A[1, 0], A[0, 2], A[1, 2]]
        full, _ = solve_bundle(problem, "affine", np.ones(4, bool), params0,
                               device=self.device, mesh=self.mesh)
        if not np.all(np.isfinite(full)):
            return None
        out = []
        for c, (a, b, tx, ty) in zip(cameras, full):
            R = np.array([[a, -b, tx], [b, a, ty], [0, 0, 1]], np.float32)
            out.append(CameraParams(focal=c.focal, aspect=c.aspect,
                                    ppx=c.ppx, ppy=c.ppy, R=R))
        return out
