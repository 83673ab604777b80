"""The plain reference that decides `correct`.

Plain NumPy and PyTorch; it imports nothing of the program. It judges
what a timed stitch produced, in three stages:

- Registration, against the truth the generator rendered the views from:
  `registration_error_px` maps a grid of points of every view into each
  of its neighbours (the truth's grid neighbours, else the next view)
  through the program's cameras and through the true geometry, and gives
  the widest distance, in full-resolution pixels.
- The crop, against a crop planned here: `low_mask` warps every view's
  mask at LOW resolution from the program's cameras (nearest, in bounds,
  pasted at its ROI, as OpenStitching's cropper composes it), and
  `largest_rectangle` finds the largest interior rectangle of that mask.
  `crop_numbers` gives the share of the program's rectangle that lies
  outside the mask (a crop larger than the views' cover) and how much
  smaller its area is than the largest one (a crop that gives away
  panorama), both with a pixel of room for the edge of a mask warped in
  float32.
- The panorama, against the views themselves: `layout` works out again,
  from the program's cameras and its crop rectangle, where OpenStitching's
  pipeline places every view in the panorama (the warp ROIs at LOW and
  FINAL resolution, the crop planned at LOW and scaled to FINAL), and
  `panorama_gaps` warps every view to its place (the spherical or affine
  backward map, bilinear). A sound panorama pixel lies between the least
  and the greatest value that the views covering it give there (seams and
  the multiband blend mix views; exposure gains move a value a little);
  the gap is how far it lies outside, in levels. The share of the
  panorama's pixels that no view covers is compared apart.

The cameras are the program's: the reference follows the program's state
there and checks them by themselves against the truth, and the crop
against its own rectangle planned from those cameras.

`control_crop`, `control_panorama` and `control_registration_error_px`
are the reference put in the program's place and computed in bfloat16,
one step below the float32 that the configuration states: they must
fail.
"""

import math
import statistics

import numpy as np
import torch

PI = math.pi
LEFT_OUT = 1e9   # px: a view the program left out of the panorama


# ---------------------------------------------------------------------------
# Resolutions and warp ROIs (OpenStitching's conventions)
# ---------------------------------------------------------------------------

def megapix_scale(megapix, first_wh):
    """Resize factor of a resolution: sqrt(megapix / size), never above 1;
    1 for a non-positive target (native)."""
    if megapix <= 0:
        return 1.0
    return min(1.0, math.sqrt(megapix * 1e6 / (first_wh[0] * first_wh[1])))


def scaled_size(wh, s):
    return (int(round(wh[0] * s)), int(round(wh[1] * s)))


def camera_K(cam, aspect):
    """The camera's intrinsics at `aspect` times the registration
    resolution, in float32 as the warp takes them."""
    K = np.array([[cam["focal"], 0, cam["ppx"]],
                  [0, cam["focal"] * cam["aspect"], cam["ppy"]],
                  [0, 0, 1.0]]).astype(np.float32)
    K[:2] *= np.float32(aspect)
    K[2, 2] = 1.0
    return K


def _forward(pts, K, R, scale, kind):
    K = np.asarray(K, np.float64)
    R = np.asarray(R, np.float64)
    ph = np.concatenate([pts, np.ones((len(pts), 1))], 1)
    if kind == "affine":
        q = ph @ np.linalg.inv(K @ R).T
        return (q[:, :2] * scale).astype(np.float32)
    ray = ph @ (R @ np.linalg.inv(K)).T
    x, y, z = ray[:, 0], ray[:, 1], ray[:, 2]
    u = np.arctan2(x, z)
    r = np.sqrt(x * x + y * y + z * z)
    v = PI - np.arccos(np.clip(y / np.maximum(r, 1e-12), -1.0, 1.0))
    return (np.stack([u, v], -1) * scale).astype(np.float32)


def warp_roi(wh, K, R, scale, kind):
    """The warped image's ROI on the surface, ((x, y), (w, h)): the image
    border projected forward (the four corners for the affine warp), the
    spherical pole taken in where it falls inside the image, both corners
    truncated toward zero and the size br - tl + 1 (OpenCV's
    `detectResultRoi`)."""
    w, h = wh
    if kind == "affine":
        pts = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]],
                       np.float32)
    else:
        xs = np.arange(w, dtype=np.float32)
        ys = np.arange(h, dtype=np.float32)
        pts = np.concatenate([
            np.stack([xs, np.zeros_like(xs)], -1),
            np.stack([xs, np.full_like(xs, h - 1)], -1),
            np.stack([np.zeros_like(ys), ys], -1),
            np.stack([np.full_like(ys, w - 1), ys], -1)], 0)
    uv = _forward(pts, K, R, scale, kind)
    u0, v0 = uv.min(0)
    u1, v1 = uv.max(0)
    if kind == "spherical":
        k_rinv = np.asarray(K, np.float64) @ np.linalg.inv(
            np.asarray(R, np.float64))
        for pole_y, v_pole in ((-1.0, 0.0), (1.0, PI * scale)):
            d = k_rinv @ np.array([0.0, pole_y, 0.0])
            if d[2] > 0 and 0 <= d[0] / d[2] < w and 0 <= d[1] / d[2] < h:
                v0, v1 = min(v0, v_pole), max(v1, v_pole)
    tl = (int(u0), int(v0))
    br = (int(u1), int(v1))
    return tl, (br[0] - tl[0] + 1, br[1] - tl[1] + 1)


def _times(rect, a):
    return tuple(int(round(v * a)) for v in rect)


def layout(cameras, sizes, lir, settings):
    """Where every view lands in the cropped panorama.

    cameras: dicts (focal, aspect, ppx, ppy, R) at MEDIUM resolution;
    sizes: the views' (w, h); lir: the crop rectangle (x, y, w, h) on the
    LOW canvas, corners taken from zero; settings: the configuration's
    resolutions and warp. Returns the panorama's (h, w) and, per view,
    its FINAL K, R, surface scale, its placed rectangle (x, y, w, h) in
    the panorama and the surface point of the rectangle's first pixel."""
    kind = settings["warper"]
    first = sizes[0]
    s_med = megapix_scale(settings["medium_megapix"], first)
    s_low = megapix_scale(settings["low_megapix"], first)
    s_fin = megapix_scale(settings["final_megapix"], first)
    base = statistics.median(c["focal"] for c in cameras)

    def rois(s):
        aspect = s / s_med
        out = []
        for cam, wh in zip(cameras, sizes):
            K = camera_K(cam, aspect)
            out.append((K, warp_roi(scaled_size(wh, s), K, cam["R"],
                                    base * aspect, kind)))
        return out, base * aspect

    low, _ = rois(s_low)
    fin, fin_scale = rois(s_fin)
    ox = min(tl[0] for _, (tl, _) in low)
    oy = min(tl[1] for _, (tl, _) in low)
    lx, ly, lw, lh = lir
    a = s_fin / s_low
    placed = []
    for (_, (tl, wh)), (K, (ftl, _)), cam in zip(low, fin, cameras):
        x, y = tl[0] - ox, tl[1] - oy
        x1, y1 = max(x, lx), max(y, ly)
        x2, y2 = min(x + wh[0], lx + lw), min(y + wh[1], ly + lh)
        if x2 < x1 or y2 < y1:
            raise ValueError("a view's rectangle misses the crop")
        over = _times((x1, y1, x2 - x1, y2 - y1), a)
        local = _times((x1 - x, y1 - y, x2 - x1, y2 - y1), a)
        placed.append(dict(K=K, R=np.asarray(cam["R"], np.float64),
                           scale=fin_scale, over=over,
                           origin=(ftl[0] + local[0], ftl[1] + local[1])))
    mx = min(p["over"][0] for p in placed)
    my = min(p["over"][1] for p in placed)
    for p in placed:
        x, y, w, h = p["over"]
        p["rect"] = (x - mx, y - my, w, h)
    H = max(p["rect"][1] + p["rect"][3] for p in placed)
    W = max(p["rect"][0] + p["rect"][2] for p in placed)
    return dict(shape=(H, W), views=placed, kind=kind)


# ---------------------------------------------------------------------------
# The crop against a crop planned here
# ---------------------------------------------------------------------------

def low_mask(cameras, sizes, settings, device, dtype=torch.float32):
    """The LOW panorama's mask, as OpenStitching's cropper composes it:
    each view resized to LOW, its mask warped (nearest: the rounded source
    pixel lies in the image) into its ROI, pasted at the ROI's corner less
    the least corner. A (H, W) bool tensor; the backward map in
    `dtype`."""
    kind = settings["warper"]
    first = sizes[0]
    s_med = megapix_scale(settings["medium_megapix"], first)
    s_low = megapix_scale(settings["low_megapix"], first)
    aspect = s_low / s_med
    scale = statistics.median(c["focal"] for c in cameras) * aspect
    placed = []
    for cam, wh in zip(cameras, sizes):
        K = camera_K(cam, aspect)
        src = scaled_size(wh, s_low)
        placed.append((K, cam["R"], src,
                       warp_roi(src, K, cam["R"], scale, kind)))
    ox = min(tl[0] for _, _, _, (tl, _) in placed)
    oy = min(tl[1] for _, _, _, (tl, _) in placed)
    H = max(tl[1] - oy + wh[1] for _, _, _, (tl, wh) in placed)
    W = max(tl[0] - ox + wh[0] for _, _, _, (tl, wh) in placed)
    mask = torch.zeros((H, W), dtype=torch.bool, device=device)
    for K, R, (w, h), (tl, (rw, rh)) in placed:
        view = dict(K=K, R=np.asarray(R, np.float64), scale=scale,
                    rect=(tl[0] - ox, tl[1] - oy, rw, rh), origin=tl)
        x, y = view["rect"][:2]
        ys = torch.arange(y, y + rh, device=device)[:, None]
        xs = torch.arange(x, x + rw, device=device)[None, :]
        sx, sy, ok = _source_coords(view, ys, xs, kind, dtype)
        xi = torch.round(sx)
        yi = torch.round(sy)
        inb = ok & (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        mask[y:y + rh, x:x + rw] |= inb
    return mask


def largest_rectangle(mask):
    """(x, y, w, h) of the largest axis-aligned rectangle of true pixels
    of a 2-D bool array: per row the histogram of heights of true pixels
    ending there, and the largest rectangle under it with a stack."""
    m = np.asarray(mask, bool)
    H, W = m.shape
    heights = np.zeros(W, np.int64)
    best = (0, 0, 0, 0, 0)
    for y in range(H):
        heights = np.where(m[y], heights + 1, 0)
        bars = heights.tolist() + [0]
        stack = []                      # (start column, height)
        for x, hgt in enumerate(bars):
            start = x
            while stack and stack[-1][1] >= hgt:
                s, sh = stack.pop()
                if sh * (x - s) > best[0]:
                    best = (sh * (x - s), s, y - sh + 1, x - s, sh)
                start = s
            stack.append((start, hgt))
    return best[1:]


def _grow(m, grow):
    """The mask grown (`grow` True) or shrunk by one pixel in each of the
    eight directions; beyond the array counts as outside."""
    p = np.pad(m, 1, constant_values=False)
    H, W = m.shape
    shifts = [p[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
              for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    return np.logical_or.reduce(shifts) if grow else \
        np.logical_and.reduce(shifts)


def crop_numbers(mask, lir):
    """How the program's crop rectangle (x, y, w, h) on the LOW canvas
    fares against the mask, allowing the one pixel by which two sound
    float32 warps of a mask may differ at its edge (a rounded coordinate
    a rounding error from .5):

    - `crop_outside_share`: the share of the rectangle's pixels more than
      a pixel outside the mask (a crop larger than the views' cover);
    - `crop_area_short`: how much smaller its area is than the largest
      rectangle inside the mask shrunk by a pixel, as a share of that (a
      crop that gives away panorama).

    A sound crop reads at most 0 on both."""
    m = torch.as_tensor(mask).cpu().numpy().astype(bool)
    x, y, w, h = lir
    area = max(w, 0) * max(h, 0)
    if not area:
        return dict(crop_outside_share=1.0, crop_area_short=1.0)
    near = _grow(m, True)[max(y, 0):y + h, max(x, 0):x + w]
    best = largest_rectangle(_grow(m, False))
    return dict(crop_outside_share=1.0 - float(near.sum()) / area,
                crop_area_short=1.0 - area / max(best[2] * best[3], 1))


def control_crop(cameras, sizes, settings, device):
    """The reference's crop in the program's place, in bfloat16: the
    largest rectangle of the LOW mask warped with a bfloat16 backward
    map."""
    return largest_rectangle(low_mask(cameras, sizes, settings, device,
                                      torch.bfloat16).cpu().numpy())


# ---------------------------------------------------------------------------
# The panorama against the views
# ---------------------------------------------------------------------------

def _source_coords(view, ys, xs, kind, dtype):
    """Source pixel coordinates in a view of panorama pixels (ys, xs) of
    its rectangle: the surface point, the backward map, then K R^-1 (K A
    for the affine warp), all in `dtype`."""
    dev = ys.device
    x0, y0 = view["rect"][:2]
    u = (view["origin"][0] + (xs - x0)).to(dtype) / view["scale"]
    v = (view["origin"][1] + (ys - y0)).to(dtype) / view["scale"]
    u, v = torch.broadcast_tensors(u, v)
    if kind == "affine":
        k = np.asarray(view["K"], np.float64) @ view["R"]
        x, y, z = u, v, torch.ones_like(u)
    else:
        k = np.asarray(view["K"], np.float64) @ np.linalg.inv(view["R"])
        sinv = torch.sin(PI - v)
        x, y, z = sinv * torch.sin(u), torch.cos(PI - v), sinv * torch.cos(u)
    k = torch.as_tensor(k, dtype=dtype, device=dev)
    q0 = k[0, 0] * x + k[0, 1] * y + k[0, 2] * z
    q1 = k[1, 0] * x + k[1, 1] * y + k[1, 2] * z
    q2 = k[2, 0] * x + k[2, 1] * y + k[2, 2] * z
    ok = q2 > 0
    q2 = torch.where(ok, q2, torch.ones_like(q2))
    return q0 / q2, q1 / q2, ok


def _bilinear(img, sx, sy):
    """Bilinear samples of an (h, w, 3) float32 image at clamped float64
    coordinates."""
    h, w = img.shape[:2]
    sx = sx.to(torch.float64).clamp(0, w - 1)
    sy = sy.to(torch.float64).clamp(0, h - 1)
    x0 = sx.floor()
    y0 = sy.floor()
    fx = (sx - x0).to(torch.float32)[..., None]
    fy = (sy - y0).to(torch.float32)[..., None]
    x0 = x0.long()
    y0 = y0.long()
    x1 = (x0 + 1).clamp_max(w - 1)
    y1 = (y0 + 1).clamp_max(h - 1)
    top = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    bot = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    return top * (1 - fy) + bot * fy


def _view_values(view, img, ys, xs, kind, dtype):
    """A view's values at panorama pixels (ys, xs) and whether it covers
    them: the backward map falls inside the image, with half a pixel of
    margin beyond OpenStitching's nearest-pixel mask."""
    sx, sy, ok = _source_coords(view, ys, xs, kind, dtype)
    h, w = img.shape[:2]
    cover = ok & (sx >= -1) & (sx <= w) & (sy >= -1) & (sy <= h)
    return _bilinear(img, sx, sy), cover


def _rows(view, y0, y1, device):
    x, y, w, h = view["rect"]
    a, b = max(y, y0), min(y + h, y1)
    if a >= b:
        return None
    ys = torch.arange(a, b, device=device)[:, None]
    xs = torch.arange(x, x + w, device=device)[None, :]
    return ys, xs


def panorama_gaps(pano, views, lay, device, block=256):
    """Per-pixel gap (levels) of the panorama outside the range its
    covering views give, over the pixels some view covers, as a flat
    float32 tensor, and the share of the panorama's pixels that no view
    covers; a panorama of another shape than the layout's gives (None,
    None). What an uncovered pixel holds is not judged: OpenCV's blender
    blacks it out, the program (and the JAX package) leaves the blend
    pyramid's coarse levels there."""
    H, W = lay["shape"]
    if tuple(pano.shape[:2]) != (H, W):
        return None, None
    imgs = [torch.as_tensor(v, device=device).to(torch.float32)
            for v in views]
    out = []
    uncovered = 0
    for y0 in range(0, H, block):
        y1 = min(H, y0 + block)
        got = torch.as_tensor(pano[y0:y1], device=device).to(torch.float32)
        if got.dim() == 2:
            got = got[..., None]
        lo = torch.full((y1 - y0, W, 3), float("inf"), device=device)
        hi = torch.full((y1 - y0, W, 3), -float("inf"), device=device)
        for view, img in zip(lay["views"], imgs):
            r = _rows(view, y0, y1, device)
            if r is None:
                continue
            ys, xs = r
            val, cover = _view_values(view, img, ys, xs, lay["kind"],
                                      torch.float64)
            sl = (slice(ys[0, 0].item() - y0, ys[-1, 0].item() + 1 - y0),
                  slice(xs[0, 0].item(), xs[0, -1].item() + 1))
            c = cover[..., None]
            lo[sl] = torch.where(c, torch.minimum(lo[sl], val), lo[sl])
            hi[sl] = torch.where(c, torch.maximum(hi[sl], val), hi[sl])
        none = torch.isinf(lo[..., 0])
        uncovered += int(none.sum())
        gap = (lo - got).clamp_min(0) + (got - hi).clamp_min(0)
        out.append(gap.amax(-1)[~none])
    return torch.cat(out), uncovered / (H * W)


def gap_numbers(gaps, uncovered):
    """The compared statistics of the panorama: the gaps' mean and 99.9th
    percentile (nearest rank), in levels, and the share of its pixels
    that no view covers; a panorama of the wrong shape reads 255 on the
    gaps and 1 on the share."""
    if gaps is None or not gaps.numel():
        return dict(pano_gap_mean=255.0, pano_gap_p999=255.0,
                    uncovered_share=1.0)
    s = torch.sort(gaps).values
    k = max(0, math.ceil(0.999 * s.numel()) - 1)
    return dict(pano_gap_mean=float(gaps.double().mean()),
                pano_gap_p999=float(s[k]), uncovered_share=uncovered)


def control_panorama(views, lay, device, block=256):
    """The reference in the program's place, in bfloat16: every panorama
    pixel from the first view that covers it, with the surface point, the
    backward map and the source coordinates computed in bfloat16."""
    H, W = lay["shape"]
    imgs = [torch.as_tensor(v, device=device).to(torch.float32)
            for v in views]
    pano = torch.zeros((H, W, 3), device=device)
    done = torch.zeros((H, W), dtype=torch.bool, device=device)
    for y0 in range(0, H, block):
        y1 = min(H, y0 + block)
        for view, img in zip(lay["views"], imgs):
            r = _rows(view, y0, y1, device)
            if r is None:
                continue
            ys, xs = r
            val, cover = _view_values(view, img, ys, xs, lay["kind"],
                                      torch.bfloat16)
            sl = (slice(ys[0, 0].item(), ys[-1, 0].item() + 1),
                  slice(xs[0, 0].item(), xs[0, -1].item() + 1))
            take = cover & ~done[sl]
            pano[sl] = torch.where(take[..., None], val, pano[sl])
            done[sl] |= take
    return pano.round().clamp(0, 255).to(torch.uint8).cpu().numpy()


# ---------------------------------------------------------------------------
# Registration against the truth
# ---------------------------------------------------------------------------

def neighbour_pairs(truth, n):
    """The pairs of views (i, j) that registration is judged on: the
    truth's `pairs` where it has them (a grid's neighbours), else each
    view and the next (a single row or a scan)."""
    if "pairs" in truth:
        return [tuple(p) for p in truth["pairs"]]
    return [(i, i + 1) for i in range(n - 1)]


def _true_maps(truth, sizes):
    """The true map of view i's full-resolution pixels into view j's, per
    neighbour pair (i, j), as 3x3 matrices."""
    out = {}
    for i, j in neighbour_pairs(truth, len(sizes)):
        if truth["kind"] == "rotation":
            K = truth["K"]
            Rs = truth["Rs"]
            out[i, j] = K @ Rs[j].T @ Rs[i] @ np.linalg.inv(K)
        else:
            (xi, yi), (xj, yj) = truth["offsets"][i], truth["offsets"][j]
            out[i, j] = np.array([[1.0, 0, xi - xj], [0, 1, yi - yj],
                                  [0, 0, 1]])
    return out


def _grid(wh, n=9):
    w, h = wh
    xs, ys = np.meshgrid(np.linspace(0, w - 1, n), np.linspace(0, h - 1, n))
    return np.stack([xs.ravel(), ys.ravel(), np.ones(n * n)], 1)


def _apply(H, pts):
    q = pts @ H.T
    return q[:, :2] / q[:, 2:3]


def _program_maps(cameras, sizes, settings, pairs):
    """The map of view i into view j, per pair (i, j), that the program's
    cameras make, at full resolution: K_j R_j^-1 R_i K_i^-1 for
    rotations, K_j A_j (K_i A_i)^-1 for the affine cameras."""
    first = sizes[0]
    a = (megapix_scale(settings["final_megapix"], first)
         / megapix_scale(settings["medium_megapix"], first))
    Ks = [camera_K(c, a).astype(np.float64) for c in cameras]
    Rs = [np.asarray(c["R"], np.float64) for c in cameras]
    out = {}
    for i, j in pairs:
        if settings["warper"] == "affine":
            out[i, j] = (Ks[j] @ Rs[j]) @ np.linalg.inv(Ks[i] @ Rs[i])
        else:
            out[i, j] = (Ks[j] @ np.linalg.inv(Rs[j]) @ Rs[i]
                         @ np.linalg.inv(Ks[i]))
    return out


def _map_error(maps, truth, sizes, quantize=None):
    err = 0.0
    for (i, j), T in _true_maps(truth, sizes).items():
        pts = _grid(sizes[i])
        want = _apply(T, pts)
        w, h = sizes[j]
        inside = ((want[:, 0] >= 0) & (want[:, 0] <= w - 1)
                  & (want[:, 1] >= 0) & (want[:, 1] <= h - 1))
        if quantize is None:
            got = _apply(maps[i, j], pts[inside])
        else:
            got = quantize(T, pts[inside])
        err = max(err, float(np.abs(got - want[inside]).max(initial=0.0)))
    return err


def registration_error_px(cameras, truth, sizes, settings):
    """The widest distance, full-resolution pixels, between where the
    program's cameras and the truth map a grid of points of every view
    into each of its neighbours (`neighbour_pairs`). A view left out
    reads `LEFT_OUT` (a finite number, so that the result line stays
    JSON)."""
    if len(cameras) != len(sizes):
        return LEFT_OUT
    pairs = neighbour_pairs(truth, len(sizes))
    return _map_error(_program_maps(cameras, sizes, settings, pairs), truth,
                      sizes)


def control_registration_error_px(truth, sizes):
    """The true maps themselves, put in the program's place with the
    matrices, the points and the products in bfloat16."""
    def bf16(T, pts):
        t = torch.as_tensor(T, dtype=torch.bfloat16)
        p = torch.as_tensor(pts, dtype=torch.bfloat16)
        q = p @ t.T
        return (q[:, :2] / q[:, 2:3]).to(torch.float64).numpy()

    return _map_error(None, truth, sizes, quantize=bf16)
