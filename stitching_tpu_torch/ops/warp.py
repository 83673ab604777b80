"""Surface projections: the compositing-path geometry.

Port of `stitching_tpu/ops/warp.py`'s projector pairs and ROI planning for
all 16 surfaces of `cv.PyRotationWarper` / `cv.AffineWarper`
(`stitching/warper.py:10-27`). For the 15 rotation surfaces:

  ray X = R K^-1 p   (image pixel -> world ray)
  (u, v) = scale * proj(X)
  backward: p = K R^-1 unproj(u/scale, v/scale)

For "affine", R holds the 2-D similarity A mapping panorama to image
coordinates: forward uv = scale * (K A)^-1 p, backward p = K A (u, v, 1).

`_build_projectors(xp)` is written over an array namespace: the torch
instance feeds the warp's backward map on the card (`compose.py`), the
numpy instance plans ROIs on the host. The formulas, their order of
operations and their guards at singular points (`abs(z) < 1e-12`,
`abs(sin u) < 1e-7`, the clips near +-1) are the reference's.

`warp_image` warps one host image on a given device for the step-by-step
API (`Warper.warp_image`): the backward map and a plain-PyTorch gather,
bilinear with a reflect border for images and nearest with a constant
border for masks (the reference's `_warp_kernel`, not the sampler
kernel's edge-clamp contract), its products and lerps rounded as the
reference's compiled code fuses them (`ops/fma.py`).
"""

import math
import types

import numpy as np
import torch

from .blend import _reflect_idx
from .fma import fma

PI = math.pi


def _build_projectors(xp):
    """Forward (x,y,z) -> (u,v) and backward (u,v) -> (x,y,z) projections
    of the 15 rotation surfaces, unscaled (the canvas scale multiplies u, v
    outside)."""
    def _sph_fwd(x, y, z):
        u = xp.arctan2(x, z)
        r = xp.sqrt(x * x + y * y + z * z)
        v = PI - xp.arccos(xp.clip(y / xp.maximum(r, 1e-12), -1.0, 1.0))
        return u, v

    def _sph_bwd(u, v):
        sinv = xp.sin(PI - v)
        return sinv * xp.sin(u), xp.cos(PI - v), sinv * xp.cos(u)

    def _plane_fwd(x, y, z):
        zz = xp.where(xp.abs(z) < 1e-12, 1e-12, z)
        return x / zz, y / zz

    def _plane_bwd(u, v):
        return u, v, xp.ones_like(u)

    def _cyl_fwd(x, y, z):
        u = xp.arctan2(x, z)
        v = y / xp.maximum(xp.sqrt(x * x + z * z), 1e-12)
        return u, v

    def _cyl_bwd(u, v):
        return xp.sin(u), v, xp.cos(u)

    def _fish_fwd(x, y, z):
        u_ = xp.arctan2(x, z)
        r = xp.sqrt(x * x + y * y + z * z)
        v_ = PI - xp.arccos(xp.clip(y / xp.maximum(r, 1e-12), -1.0, 1.0))
        return v_ * xp.cos(u_), v_ * xp.sin(u_)

    def _fish_bwd(u, v):
        u_ = xp.arctan2(v, u)
        v_ = xp.sqrt(u * u + v * v)
        sinv = xp.sin(PI - v_)
        return sinv * xp.sin(u_), xp.cos(PI - v_), sinv * xp.cos(u_)

    def _stereo_fwd(x, y, z):
        u_ = xp.arctan2(x, z)
        r = xp.sqrt(x * x + y * y + z * z)
        v_ = PI - xp.arccos(xp.clip(y / xp.maximum(r, 1e-12), -1.0, 1.0))
        rad = xp.sin(v_) / xp.maximum(1.0 - xp.cos(v_), 1e-12)
        return rad * xp.cos(u_), rad * xp.sin(u_)

    def _stereo_bwd(u, v):
        u_ = xp.arctan2(v, u)
        rp = xp.sqrt(u * u + v * v)
        v_ = 2.0 * xp.arctan2(1.0, rp)  # r = cot(v_/2)
        sinv = xp.sin(PI - v_)
        return sinv * xp.sin(u_), xp.cos(PI - v_), sinv * xp.cos(u_)

    def _comp_fwd(a, b):
        def fwd(x, y, z):
            u_ = xp.arctan2(x, z)
            r = xp.sqrt(x * x + y * y + z * z)
            v_ = xp.arcsin(xp.clip(y / xp.maximum(r, 1e-12), -1.0, 1.0))
            u = a * xp.tan(u_ / a)
            v = b * xp.tan(v_ / b) / xp.cos(u_)
            return u, v
        return fwd

    def _comp_bwd(a, b):
        def bwd(u, v):
            u_ = a * xp.arctan2(u, a)
            lat = b * xp.arctan2(v * xp.cos(u_), b)
            cl = xp.cos(lat)
            return cl * xp.sin(u_), xp.sin(lat), cl * xp.cos(u_)
        return bwd

    def _pan_fwd(a, b):
        def fwd(x, y, z):
            u_ = xp.arctan2(x, z)
            tg = a * xp.tan(u_ / a)
            rho = xp.maximum(xp.sqrt(x * x + z * z), 1e-12)
            tanv = y / rho
            sinu = xp.sin(u_)
            v = xp.where(xp.abs(sinu) < 1e-7,
                         b * tanv,
                         b * tg * tanv / xp.where(
                             xp.abs(sinu) < 1e-7, 1.0, sinu))
            return tg, v
        return fwd

    def _pan_bwd(a, b):
        def bwd(u, v):
            u_ = a * xp.arctan2(u, a)
            sinu = xp.sin(u_)
            tanv = xp.where(xp.abs(sinu) < 1e-7,
                            v / b,
                            v * sinu / (b * xp.where(
                                xp.abs(u) < 1e-12, 1.0, u)))
            lat = xp.arctan(tanv)
            cl = xp.cos(lat)
            return cl * xp.sin(u_), xp.sin(lat), cl * xp.cos(u_)
        return bwd

    def _merc_fwd(x, y, z):
        u = xp.arctan2(x, z)
        rho = xp.maximum(xp.sqrt(x * x + z * z), 1e-12)
        v = xp.arcsinh(y / rho)
        return u, v

    def _merc_bwd(u, v):
        lat = xp.arctan(xp.sinh(v))
        cl = xp.cos(lat)
        return cl * xp.sin(u), xp.sin(lat), cl * xp.cos(u)

    def _tmerc_fwd(x, y, z):
        lon = xp.arctan2(x, z)
        r = xp.sqrt(x * x + y * y + z * z)
        lat = xp.arcsin(xp.clip(y / xp.maximum(r, 1e-12), -1.0, 1.0))
        B = xp.clip(xp.cos(lat) * xp.sin(lon), -0.9999999, 0.9999999)
        u = xp.arctanh(B)
        v = xp.arctan2(xp.tan(lat), xp.cos(lon))
        return u, v

    def _tmerc_bwd(u, v):
        lat = xp.arcsin(xp.clip(xp.sin(v) / xp.cosh(u), -1.0, 1.0))
        lon = xp.arctan2(xp.sinh(u), xp.cos(v))
        cl = xp.cos(lat)
        return cl * xp.sin(lon), xp.sin(lat), cl * xp.cos(lon)

    def _portrait(fwd, bwd):
        """Portrait: swap x<->y in the ray, negate u."""
        def pfwd(x, y, z):
            u, v = fwd(y, x, z)
            return -u, v

        def pbwd(u, v):
            x, y, z = bwd(-u, v)
            return y, x, z
        return pfwd, pbwd

    comp2 = (_comp_fwd(2.0, 1.0), _comp_bwd(2.0, 1.0))
    comp15 = (_comp_fwd(1.5, 1.0), _comp_bwd(1.5, 1.0))
    pan2 = (_pan_fwd(2.0, 1.0), _pan_bwd(2.0, 1.0))
    pan15 = (_pan_fwd(1.5, 1.0), _pan_bwd(1.5, 1.0))

    return {
        "spherical": (_sph_fwd, _sph_bwd),
        "plane": (_plane_fwd, _plane_bwd),
        "cylindrical": (_cyl_fwd, _cyl_bwd),
        "fisheye": (_fish_fwd, _fish_bwd),
        "stereographic": (_stereo_fwd, _stereo_bwd),
        "compressedPlaneA2B1": comp2,
        "compressedPlaneA1.5B1": comp15,
        "compressedPlanePortraitA2B1": _portrait(*comp2),
        "compressedPlanePortraitA1.5B1": _portrait(*comp15),
        "paniniA2B1": pan2,
        "paniniA1.5B1": pan15,
        "paniniPortraitA2B1": _portrait(*pan2),
        "paniniPortraitA1.5B1": _portrait(*pan15),
        "mercator": (_merc_fwd, _merc_bwd),
        "transverseMercator": (_tmerc_fwd, _tmerc_bwd),
    }


def _atan2(y, x):
    """torch.atan2 taking a Python number for either side (as float32)."""
    if not torch.is_tensor(y):
        y = torch.full_like(x, y)
    if not torch.is_tensor(x):
        x = torch.full_like(y, x)
    return torch.atan2(y, x)


def _torch_namespace():
    """The numpy-style names `_build_projectors` uses, over torch."""
    return types.SimpleNamespace(
        arctan2=_atan2, sqrt=torch.sqrt, arccos=torch.arccos,
        arcsin=torch.arcsin, arctan=torch.arctan, arcsinh=torch.arcsinh,
        arctanh=torch.arctanh, clip=torch.clip, maximum=torch.clamp_min,
        sin=torch.sin, cos=torch.cos, tan=torch.tan, sinh=torch.sinh,
        cosh=torch.cosh, abs=torch.abs, where=torch.where,
        ones_like=torch.ones_like)


PROJECTORS = _build_projectors(_torch_namespace())
PROJECTORS_NP = _build_projectors(np)

WARP_TYPES = ("affine",) + tuple(PROJECTORS)

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
    if warper_type == "affine":
        # R holds A, panorama -> image coordinates: uv = scale (K A)^-1 p
        q = np.concatenate([pts, np.ones((len(pts), 1))], 1) @ \
            np.linalg.inv(K @ R).T
        return (q[:, :2] * scale).astype(np.float32)
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
    pole handling for the spherical surface; the affine ROI spans the four
    projected corners.
    """
    w, h = int(size_wh[0]), int(size_wh[1])
    if warper_type == "affine":
        pts = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]],
                       np.float32)
    else:
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


# ---------------------------------------------------------------------------
# Per-image warp: backward map + bilinear / nearest sampling
# ---------------------------------------------------------------------------

def _warp_kernel(img, k_rinv, tl, inv_scale, dst_h, dst_w, warper_type,
                 interp, border):
    """Backward map over the (dst_h, dst_w) grid and the sample of `img`.

    img: (H, W, C) float32 tensor; k_rinv: (3, 3) float32 tensor, K R^-1
    (K A for "affine"); tl: the dst top-left (x, y); inv_scale: float32.
    Returns (dst_h, dst_w, C) float32 on img's device. Linear sampling
    reads four taps at reflected (border "reflect") or clamped indices;
    nearest reads the tap at the rounded coordinate (half to even, as
    jnp.round). Outside the projection's valid side the value is 0, and
    with a "constant" border so is every sample off the source.
    """
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    cols = torch.arange(dst_w, dtype=torch.float32, device=dev)[None, :]
    rows = torch.arange(dst_h, dtype=torch.float32, device=dev)[:, None]
    u = ((float(np.float32(tl[0])) + cols) * inv_scale).expand(dst_h, -1)
    v = ((float(np.float32(tl[1])) + rows) * inv_scale).expand(-1, dst_w)
    if warper_type == "affine":
        x, y, z = u, v, torch.ones_like(u)
    else:
        x, y, z = PROJECTORS[warper_type][1](u, v)
    # the reference's compiled map fuses k0 x + k1 y + k2 z as
    # fma(k2, z, fma(k0, x, k1 y)), as in `compose._bwd_coords`
    q0, q1, q2 = (fma(k_rinv[r, 2], z, fma(k_rinv[r, 0], x, k_rinv[r, 1] * y))
                  for r in range(3))
    valid = q2 > 0
    q2s = torch.where(q2.abs() < 1e-12, 1e-12, q2)
    sx = q0 / q2s
    sy = q1 / q2s

    if interp == "nearest":
        xi = torch.round(sx).to(torch.int64)
        yi = torch.round(sy).to(torch.int64)
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h) & valid
        out = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        if border == "constant":
            out = torch.where(inb[..., None], out, 0.0)
        return out

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    if border == "reflect":
        xa, xb = _reflect_idx(x0i, w), _reflect_idx(x0i + 1, w)
        ya, yb = _reflect_idx(y0i, h), _reflect_idx(y0i + 1, h)
    else:
        xa, xb = x0i.clamp(0, w - 1), (x0i + 1).clamp(0, w - 1)
        ya, yb = y0i.clamp(0, h - 1), (y0i + 1).clamp(0, h - 1)
    # and each lerp a (1 - f) + b f as fma(a, 1 - f, b f)
    gx, gy = (1 - fx).expand(-1, -1, img.shape[2]), \
        (1 - fy).expand(-1, -1, img.shape[2])
    top = fma(img[ya, xa], gx, img[ya, xb] * fx)
    bot = fma(img[yb, xa], gx, img[yb, xb] * fx)
    out = fma(top, gy, bot * fy)
    if border == "constant":
        keep = ((sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
                & valid)
    else:
        keep = valid
    return torch.where(keep[..., None], out, 0.0)


def warp_image(img, K, R, scale, warper_type, interp="linear",
               border="reflect", device="cuda"):
    """Warp one source image onto the surface on `device`. Returns
    (corner_xy, warped): the dst ROI's top-left in surface pixels and the
    warped host array at the ROI's exact size.

    img: numpy uint8 or float (H, W) or (H, W, C). An integer image comes
    back as uint8 (rounded half to even and saturated), a float one as
    float32.
    """
    img = np.asarray(img)
    size_wh = (img.shape[1], img.shape[0])
    tl, (dw, dh) = warp_roi(size_wh, K, R, scale, warper_type)
    K64 = np.asarray(K, np.float64)
    R64 = np.asarray(R, np.float64)
    k_rinv = K64 @ R64 if warper_type == "affine" \
        else K64 @ np.linalg.inv(R64)
    src = torch.as_tensor(np.ascontiguousarray(img), device=device).to(
        torch.float32)
    out = _warp_kernel(
        src if img.ndim == 3 else src[..., None],
        torch.as_tensor(k_rinv.astype(np.float32), device=device), tl,
        float(np.float32(1.0 / scale)), dh, dw, warper_type, interp, border)
    if img.ndim == 2:
        out = out[..., 0]
    if np.issubdtype(img.dtype, np.integer):
        out = torch.round(out).clamp(0, 255).to(torch.uint8)
    return tl, out.cpu().numpy()
