"""Rotation surface projections: the compositing-path geometry.

Port of `stitching_tpu/ops/warp.py`'s projector pair and ROI planning for
the spherical surface, the equivalent of `cv.PyRotationWarper`
(`stitching/warper.py:10-27`):

  ray X = R K^-1 p   (image pixel -> world ray)
  (u, v) = scale * proj(X)
  backward: p = K R^-1 unproj(u/scale, v/scale)

`_build_projectors(xp)` is written over an array namespace: the torch
instance feeds the warp's backward map on the card (`compose.py`), the
numpy instance plans ROIs on the host. The other 15 surfaces of the
reference wait for ROADMAP queue 1 (other settings); `WARP_TYPES` names
them all so that the warper can tell an unported surface from a wrong one.
"""

import math
import types

import numpy as np
import torch

PI = math.pi

WARP_TYPES = (
    "affine", "spherical", "plane", "cylindrical", "fisheye",
    "stereographic", "compressedPlaneA2B1", "compressedPlaneA1.5B1",
    "compressedPlanePortraitA2B1", "compressedPlanePortraitA1.5B1",
    "paniniA2B1", "paniniA1.5B1", "paniniPortraitA2B1",
    "paniniPortraitA1.5B1", "mercator", "transverseMercator",
)


def _build_projectors(xp):
    """Forward (x,y,z) -> (u,v) and backward (u,v) -> (x,y,z) projections,
    unscaled (the canvas scale multiplies u, v outside)."""
    def _sph_fwd(x, y, z):
        u = xp.arctan2(x, z)
        r = xp.sqrt(x * x + y * y + z * z)
        v = PI - xp.arccos(xp.clip(y / xp.maximum(r, 1e-12), -1.0, 1.0))
        return u, v

    def _sph_bwd(u, v):
        sinv = xp.sin(PI - v)
        return sinv * xp.sin(u), xp.cos(PI - v), sinv * xp.cos(u)

    return {"spherical": (_sph_fwd, _sph_bwd)}


def _torch_namespace():
    """The numpy-style names `_build_projectors` uses, over torch."""
    return types.SimpleNamespace(
        arctan2=torch.atan2, sqrt=torch.sqrt, arccos=torch.arccos,
        clip=torch.clip, maximum=torch.clamp_min, sin=torch.sin,
        cos=torch.cos)


PROJECTORS = _build_projectors(_torch_namespace())
PROJECTORS_NP = _build_projectors(np)

# ---------------------------------------------------------------------------
# Forward projection of source border -> destination ROI
# ---------------------------------------------------------------------------

def _border_points(w, h):
    xs = np.arange(w, dtype=np.float32)
    ys = np.arange(h, dtype=np.float32)
    top = np.stack([xs, np.zeros_like(xs)], -1)
    bot = np.stack([xs, np.full_like(xs, h - 1)], -1)
    left = np.stack([np.zeros_like(ys), ys], -1)
    right = np.stack([np.full_like(ys, w - 1), ys], -1)
    return np.concatenate([top, bot, left, right], 0)


def warp_points(pts, K, R, scale, warper_type):
    """Forward-project pixel points (N, 2) -> surface coords (N, 2)."""
    K = np.asarray(K, np.float64)
    R = np.asarray(R, np.float64)
    fwd, _ = PROJECTORS_NP[warper_type]
    r_kinv = R @ np.linalg.inv(K)
    ph = np.concatenate([pts, np.ones((len(pts), 1))], 1)
    ray = ph @ r_kinv.T
    u, v = fwd(ray[:, 0], ray[:, 1], ray[:, 2])
    return (np.stack([np.asarray(u), np.asarray(v)], -1)
            * scale).astype(np.float32)


def warp_roi(size_wh, K, R, scale, warper_type):
    """Destination ROI of the warped image: ((tl_x, tl_y), (w, h)).

    Mirrors cv.RotationWarper.warpRoi: border-point forward projection with
    pole handling for the spherical surface.
    """
    w, h = int(size_wh[0]), int(size_wh[1])
    pts = _border_points(w, h)
    uv = warp_points(pts, K, R, scale, warper_type)
    u_min, v_min = uv.min(0)
    u_max, v_max = uv.max(0)

    if warper_type == "spherical":
        # If a pole projects inside the source image, the v range extends to
        # the full pole coordinate (cv.SphericalWarper::detectResultRoi).
        K64 = np.asarray(K, np.float64)
        R64 = np.asarray(R, np.float64)
        k_rinv = K64 @ np.linalg.inv(R64)
        for pole_y, v_pole in ((-1.0, 0.0), (1.0, PI * scale)):
            d = k_rinv @ np.array([0.0, pole_y, 0.0])
            if d[2] > 0:
                px, py = d[0] / d[2], d[1] / d[2]
                if 0 <= px < w and 0 <= py < h:
                    v_min = min(v_min, v_pole)
                    v_max = max(v_max, v_pole)

    # OpenCV truncates both corners toward zero (static_cast<int>), and the
    # dst size is br - tl + 1; reproduced exactly for shape parity.
    tl = (int(u_min), int(v_min))
    br = (int(u_max), int(v_max))
    return tl, (br[0] - tl[0] + 1, br[1] - tl[1] + 1)
