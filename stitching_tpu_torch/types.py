"""Core data model: Features / MatchesInfo / CameraParams.

Counterparts of the OpenCV structs of the reference (`SURVEY.md` §1):

- `ImageFeatures` becomes :class:`Features`, a fixed-capacity
  struct-of-arrays with a validity mask instead of a variable-length
  keypoint list. The small per-keypoint fields are host numpy arrays; the
  descriptor rows may stay a tensor on the card.
- `MatchesInfo` becomes :class:`MatchesInfo`: fixed-capacity match index
  pairs + inlier mask + H.
- `CameraParams` becomes :class:`CameraParams` with the same `K()`
  assembly semantics.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Features:
    """Fixed-capacity keypoints + descriptors for one image.

    All arrays share leading dim N (the capacity); `valid` marks real
    entries. `desc` holds bit-unpacked {0,1} float32 (N, 256) rows for
    binary (ORB-family) descriptors, or float32 (N, 128) for SIFT-family.
    """

    xy: np.ndarray        # (N, 2) float32, (x, y) pixel coords at detect res
    response: np.ndarray  # (N,) float32
    size: np.ndarray      # (N,) float32 keypoint diameter
    angle: np.ndarray     # (N,) float32 orientation in degrees
    desc: object          # (N, D) float32 tensor (or numpy array)
    valid: np.ndarray     # (N,) bool
    img_size: tuple = (0, 0)  # (w, h) at detection resolution
    is_binary: bool = True

    @property
    def num_valid(self) -> int:
        return int(np.asarray(self.valid).sum())

    @property
    def keypoints_np(self) -> np.ndarray:
        """(num_valid, 2) numpy array of (x, y) keypoint coords."""
        return np.asarray(self.xy)[np.asarray(self.valid)]


@dataclasses.dataclass
class MatchesInfo:
    """Pairwise match result (host-level view, mirrors cv.detail.MatchesInfo).

    `matches` holds (M, 2) int32 index pairs (src kp idx, dst kp idx) with
    `matches_valid` marking real rows; `inliers_mask` marks RANSAC inliers
    among the valid rows. `H` maps src image points to dst image points
    (3x3 float64; None when confidence == 0).
    """

    src_img_idx: int = -1
    dst_img_idx: int = -1
    matches: np.ndarray = None          # (M, 2) int32
    matches_valid: np.ndarray = None    # (M,) bool
    inliers_mask: np.ndarray = None     # (M,) bool
    num_inliers: int = 0
    H: np.ndarray = None                # (3, 3) float64 or None
    confidence: float = 0.0

    @property
    def num_matches(self) -> int:
        if self.matches_valid is None:
            return 0
        return int(self.matches_valid.sum())


@dataclasses.dataclass
class CameraParams:
    """Pinhole camera: intrinsics (focal, aspect, ppx, ppy) + rotation R."""

    focal: float = 1.0
    aspect: float = 1.0
    ppx: float = 0.0
    ppy: float = 0.0
    R: np.ndarray = None   # (3, 3) float32
    t: np.ndarray = None   # (3, 1) float64

    def __post_init__(self):
        if self.R is None:
            self.R = np.eye(3, dtype=np.float32)
        if self.t is None:
            self.t = np.zeros((3, 1), dtype=np.float64)

    def K(self) -> np.ndarray:
        k = np.eye(3, dtype=np.float64)
        k[0, 0] = self.focal
        k[0, 2] = self.ppx
        k[1, 1] = self.focal * self.aspect
        k[1, 2] = self.ppy
        return k

    def copy(self) -> "CameraParams":
        return CameraParams(
            self.focal, self.aspect, self.ppx, self.ppy,
            self.R.copy(), self.t.copy(),
        )
