"""Batched compositing on the card: warp, crop, gains, seam masks, blend.

Port of the parts of `stitching_tpu/compose.py` that the slices run. Every
stage is one batched pass over a stacked tile batch that stays in device
memory:

- `warp_stack`: all images warp onto the surface at once. The backward map
  (`_bwd_coords`) and the validity masks are batched tensor code; the
  bilinear gather is the CUDA kernel `ops/kernels/bilinear_sample`;
- `slice_stack`: every tile crops to its rect in one pass;
- `apply_gains_stack`: the scalar compensators' gains, or the blocks
  compensators' gain maps bilinearly upsampled per pixel, multiplied in;
- `resize_seam_masks_stack`: dilate + resize + mask-AND for all seam masks;
- `blend_stack`: the multiband blend (each tile's reflect-bordered window,
  its Laplacian pyramid times its seam mask's Gaussian pyramid added into
  per-level canvases, then one normalise-and-collapse), the feather blend
  (distance-transform weights) or the paste composite ("no"), tile after
  tile in batch order, then one uint8 conversion. The panorama leaves the
  card once. A canvas whose accumulators exceed the reference's 4 GB blend
  budget raises: its strip and streamed routes are not ported.

Tiles share one 64-bucketed (B, TH, TW, C) shape; true per-image corners
and sizes ride along as host metadata.
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .ops.blend import distance_transform_l1
from .ops.fma import fma
from .ops.kernels.bilinear_sample import bilinear_sample
from .ops.pyramid import build_gaussian, build_laplacian, collapse_laplacian
from .ops.warp import PROJECTORS, warp_roi


def _round_up(x, m=64):
    return int(-(-x // m) * m)


@dataclasses.dataclass(frozen=True)
class TileStack:
    """A batch of warped tiles resident on the card.

    data: (B, TH, TW, C) float32; tile i's true content is [0:h_i, 0:w_i].
    masks: (B, TH, TW) float32 in {0, 255}: warp validity.
    corners: host (B, 2) int (x, y) in surface/panorama coordinates.
    sizes: host (B, 2) int (w, h) true tile sizes.
    """

    data: torch.Tensor
    masks: torch.Tensor
    corners: np.ndarray
    sizes: np.ndarray


# ---------------------------------------------------------------------------
# Batched warp
# ---------------------------------------------------------------------------

def plan_warp_rois(sizes, Ks, Rs, scale, warper_type):
    """Host-side dst ROIs for every image: (corners (B,2), sizes (B,2))."""
    corners, out_sizes = [], []
    for size, K, R in zip(sizes, Ks, Rs):
        tl, wh = warp_roi(size, K, R, scale, warper_type)
        corners.append(tl)
        out_sizes.append(wh)
    return np.asarray(corners, np.int64), np.asarray(out_sizes, np.int64)


def _bwd_coords(k_rinv, tls, inv_scale, th, tw, warper_type):
    """Backward map over every image's dst grid.

    k_rinv: (B, 3, 3), K R^-1 (K A for "affine"); tls: (B, 2). Returns
    sx, sy, valid (B, th, tw) and the dst cols (1, 1, tw) / rows (1, th, 1)
    as float32."""
    dev = k_rinv.device
    cols = torch.arange(tw, dtype=torch.float32, device=dev)[None, None, :]
    rows = torch.arange(th, dtype=torch.float32, device=dev)[None, :, None]
    u = ((tls[:, 0, None, None] + cols) * inv_scale).expand(-1, th, tw)
    v = ((tls[:, 1, None, None] + rows) * inv_scale).expand(-1, th, tw)
    if warper_type == "affine":
        x, y, z = u, v, torch.ones_like(u)
    else:
        _, bwd = PROJECTORS[warper_type]
        x, y, z = bwd(u, v)
    k = k_rinv[:, :, :, None, None]

    def row(r):
        # the reference's compiled map fuses k0 x + k1 y + k2 z as
        # fma(k2, z, fma(k0, x, k1 y)): a sample moved by one ulp moves a
        # value on a steep edge by ~4e-3
        return fma(k[:, r, 2], z, fma(k[:, r, 0], x, k[:, r, 1] * y))

    q0, q1, q2 = row(0), row(1), row(2)
    valid = q2 > 0
    q2s = torch.where(q2.abs() < 1e-12, 1e-12, q2)
    return q0 / q2s, q1 / q2s, valid, cols, rows


def _warp_stack_kernel(data, src_sizes, k_rinv, tls, dst_sizes, inv_scale,
                       *, th, tw, warper_type):
    """Warp every image of the padded stack onto the surface.

    data: (B, H, W, C) float32; src_sizes/dst_sizes: (B, 2) (w, h);
    k_rinv: (B, 3, 3) float32; tls: (B, 2) float32 dst top-left. Returns
    tiles (B, th, tw, C) float32 and masks (B, th, tw) float32 {0, 255}.

    The sampler is exact at `care` pixels, the ones whose bilinear taps
    reach the source; pixels outside the mask are zeroed. The mask is the
    nearest-neighbour in-bounds indicator through the same backward map.
    """
    sx, sy, valid, cols, rows = _bwd_coords(k_rinv, tls, inv_scale, th, tw,
                                            warper_type)
    w = src_sizes[:, 0, None, None].to(torch.float32)
    h = src_sizes[:, 1, None, None].to(torch.float32)
    sxc = torch.minimum(sx.clamp_min(0.0), w - 1.0)
    syc = torch.minimum(sy.clamp_min(0.0), h - 1.0)
    care = valid & (sx >= -1) & (sx <= w) & (sy >= -1) & (sy <= h)
    xi = torch.round(sx)
    yi = torch.round(sy)
    inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1) & valid
    inroi = ((cols < dst_sizes[:, 0, None, None].to(torch.float32))
             & (rows < dst_sizes[:, 1, None, None].to(torch.float32)))
    mask = torch.where(inb & inroi, 255.0, 0.0)
    out = bilinear_sample(data, sxc, syc, care)
    out = torch.where((valid & inroi)[..., None], out, 0.0)
    return out, mask


def warp_stack(data, src_sizes, Ks, Rs, scale, warper_type) -> TileStack:
    """Warp the whole padded image stack in one batched pass.

    data: (B, H, W, C) tensor; src_sizes: (B, 2) host int (w, h);
    Ks/Rs: per-image 3x3. Returns a TileStack with true per-image ROIs.
    """
    b = data.shape[0]
    n = len(Ks)
    dev = data.device
    corners, dsizes = plan_warp_rois(
        [tuple(s) for s in src_sizes[:n]], Ks, Rs, scale, warper_type)
    th = _round_up(int(dsizes[:, 1].max()))
    tw = _round_up(int(dsizes[:, 0].max()))
    k_rinv = np.zeros((b, 3, 3), np.float32)
    for i in range(n):
        K64 = np.asarray(Ks[i], np.float64)
        R64 = np.asarray(Rs[i], np.float64)
        # the affine backward map is p = K A (u, v, 1)
        k_rinv[i] = (K64 @ R64 if warper_type == "affine"
                     else K64 @ np.linalg.inv(R64))
    tls = np.zeros((b, 2), np.float32)
    tls[:n] = corners
    # padded batch slots get a zero ROI, hence an all-zero mask
    dsz = np.zeros((b, 2), np.int32)
    dsz[:n] = dsizes
    tiles, masks = _warp_stack_kernel(
        data, torch.as_tensor(np.asarray(src_sizes, np.int32), device=dev),
        torch.as_tensor(k_rinv, device=dev), torch.as_tensor(tls, device=dev),
        torch.as_tensor(dsz, device=dev), float(np.float32(1.0 / scale)),
        th=th, tw=tw, warper_type=warper_type)
    return TileStack(tiles, masks, np.asarray(corners[:n]),
                     np.asarray(dsizes[:n]))


# ---------------------------------------------------------------------------
# Batched crop
# ---------------------------------------------------------------------------

def slice_stack(stack: TileStack, rects) -> TileStack:
    """Crop each tile to its (x, y, w, h) rect; corners/sizes updated by the
    caller (crop ROI math lives in the cropper)."""
    rects = [tuple(r) for r in rects]
    n = len(rects)
    b = stack.data.shape[0]
    rects = rects + [(0, 0, 1, 1)] * (b - n)  # padded batch slots
    ch = _round_up(max(r[3] for r in rects))
    cw = _round_up(max(r[2] for r in rects))
    th, tw = int(stack.data.shape[1]), int(stack.data.shape[2])
    # Pad bottom/right so every (ch, cw) slice starts exactly at its rect
    # origin: no clamping, so content never shifts against corners/sizes.
    pad_h = max(0, max(r[1] for r in rects) + ch - th)
    pad_w = max(0, max(r[0] for r in rects) + cw - tw)
    tiles = F.pad(stack.data, (0, 0, 0, pad_w, 0, pad_h))
    masks = F.pad(stack.masks, (0, pad_w, 0, pad_h))
    tiles = torch.stack([tiles[i, r[1]:r[1] + ch, r[0]:r[0] + cw]
                         for i, r in enumerate(rects)])
    masks = torch.stack([masks[i, r[1]:r[1] + ch, r[0]:r[0] + cw]
                         for i, r in enumerate(rects)])
    sizes = np.asarray([(r[2], r[3]) for r in rects[:n]], np.int64)
    return TileStack(tiles, masks, np.asarray(stack.corners), sizes)


# ---------------------------------------------------------------------------
# Batched exposure application
# ---------------------------------------------------------------------------

def _gain_map_kernel(tiles, gmaps, cell0, inv_bs):
    """tiles: (B, TH, TW, C); gmaps: (B, GY, GX, Cg) padded cell gain maps;
    cell0: (B, 2) float32, each image's sub-block offset (feed_corner % bs)
    / bs in cells; inv_bs: (B, 2) float32 cells per APPLY-resolution pixel
    (x, y). Bilinear-samples each image's gain map at every pixel and
    multiplies: apply pixel a maps to feed pixel center (a+0.5)*feed/apply,
    then to cell coordinate (off + (a+0.5)*ratio)/bs - 0.5 relative to the
    sub-map origin. The sample grid is separable (gx depends on the column
    only, gy on the row only)."""
    B, TH, TW = tiles.shape[0], tiles.shape[1], tiles.shape[2]
    GY, GX = gmaps.shape[1], gmaps.shape[2]
    dev = tiles.device
    gx = cell0[:, 0:1] + (torch.arange(TW, dtype=torch.float32, device=dev)
                          + 0.5)[None] * inv_bs[:, 0:1] - 0.5    # (B, TW)
    gy = cell0[:, 1:2] + (torch.arange(TH, dtype=torch.float32, device=dev)
                          + 0.5)[None] * inv_bs[:, 1:2] - 0.5    # (B, TH)
    gx = gx.clamp(0.0, GX - 1.0)
    gy = gy.clamp(0.0, GY - 1.0)
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fx = (gx - x0)[:, None, :, None]                # (B, 1, TW, 1)
    fy = (gy - y0)[:, :, None, None]                # (B, TH, 1, 1)
    x0i = x0.long().clamp(0, GX - 1)
    x1i = (x0i + 1).clamp(0, GX - 1)
    y0i = y0.long().clamp(0, GY - 1)
    y1i = (y0i + 1).clamp(0, GY - 1)
    bi = torch.arange(B, device=dev)[:, None, None]

    def tap(yy, xx):
        return gmaps[bi, yy[:, :, None], xx[:, None, :]]    # (B,TH,TW,Cg)

    r0 = tap(y0i, x0i) * (1 - fx) + tap(y0i, x1i) * fx
    r1 = tap(y1i, x0i) * (1 - fx) + tap(y1i, x1i) * fx
    gain = r0 * (1 - fy) + r1 * fy
    return torch.round(tiles * gain).clamp(0.0, 255.0)


def _gain_mul_kernel(tiles, gains):
    """tiles: (B, TH, TW, C); gains: (B, C). One gain per image and
    channel, rounded and saturated as the reference applies it."""
    return torch.round(tiles * gains[:, None, None, :]).clamp(0.0, 255.0)


def plan_gain_arrays(compensator, sizes, b, C):
    """Host arrays for gain application over `b` batch slots whose first
    len(sizes) are real images at the given APPLY-resolution sizes.

    Returns (mode, arrays): ("no", None); ("scalar", g (b, C)) for gain
    and channel; ("map", (gstack, cell0, inv_bs)) for the blocks variants.
    """
    mode = compensator.compensator
    if mode == "no":
        return "no", None
    n = len(sizes)
    if mode in ("gain", "channel"):
        g = np.ones((b, C), np.float32)
        for i in range(n):
            gi = compensator._gains[i]
            g[i] = gi if len(gi) == C else gi[0]
        return "scalar", g
    origin, bs, smoothed = compensator._block_state
    subs = []
    cell0 = np.zeros((b, 2), np.float32)
    inv_bs = np.full((b, 2), 1.0 / bs, np.float32)
    for i in range(n):
        gmap = smoothed[i]
        fw, fh = compensator._feed_sizes[i]
        gx0 = compensator._feed_corners[i][0] - origin[0]
        gy0 = compensator._feed_corners[i][1] - origin[1]
        cy0, cx0 = gy0 // bs, gx0 // bs
        ncy = -(-(gy0 % bs + fh) // bs)
        ncx = -(-(gx0 % bs + fw) // bs)
        subs.append(gmap[cy0:cy0 + ncy, cx0:cx0 + ncx])
        # sub-block offset of the image's (0,0) pixel inside cell (cy0, cx0)
        cell0[i] = ((gx0 % bs) / bs, (gy0 % bs) / bs)
        # cells per APPLY pixel, per image and axis (feed px / apply px / bs)
        aw, ah = sizes[i]
        inv_bs[i] = (fw / max(int(aw), 1) / bs, fh / max(int(ah), 1) / bs)
    gy = max(s.shape[0] for s in subs)
    gx = max(s.shape[1] for s in subs)
    cg = subs[0].shape[-1]
    gstack = np.ones((b, gy, gx, cg), np.float32)
    for i, s in enumerate(subs):
        gstack[i, :s.shape[0], :s.shape[1]] = s
        # edge-replicate so the bilinear taps at image edges stay sane
        gstack[i, s.shape[0]:, :s.shape[1]] = s[-1:, :]
        gstack[i, :, s.shape[1]:] = gstack[i, :, s.shape[1] - 1:s.shape[1]]
    return "map", (gstack, cell0, inv_bs)


def apply_gains_stack(stack: TileStack, compensator) -> TileStack:
    """Apply the fed compensator to the whole tile stack on its device."""
    mode, arrs = plan_gain_arrays(compensator, stack.sizes,
                                  stack.data.shape[0], stack.data.shape[-1])
    if mode == "no":
        return stack
    dev = stack.data.device
    if mode == "scalar":
        tiles = _gain_mul_kernel(stack.data, torch.as_tensor(arrs,
                                                             device=dev))
    else:
        tiles = _gain_map_kernel(
            stack.data, *[torch.as_tensor(a, device=dev) for a in arrs])
    return TileStack(tiles, stack.masks, stack.corners, stack.sizes)


# ---------------------------------------------------------------------------
# Batched seam-mask resize (dilate + bilinear resize + AND with warp mask)
# ---------------------------------------------------------------------------

def _seam_resize_kernel(seams, lo_sizes, fin_masks, fin_sizes):
    """seams: (B, LH, LW) float32; fin_masks: (B, TH, TW) float32 {0,255}.
    Per image: 3x3 dilate the LOW seam mask, bilinear-resize it to the
    image's FINAL size, zero outside the FINAL warp mask."""
    LH, LW = seams.shape[1], seams.shape[2]
    TH, TW = fin_masks.shape[1], fin_masks.shape[2]
    dev = seams.device
    # max_pool2d pads with -inf where the reference pads with 0: every
    # window holds a real mask value >= 0, so the two maxima agree
    dil = F.max_pool2d(seams[:, None], 3, stride=1, padding=1)[:, 0]
    lsz = lo_sizes.to(torch.float32)
    fsz = fin_sizes.to(torch.float32).clamp_min(1.0)

    def axis(n_out, lo, fin, limit):
        pos = ((torch.arange(n_out, dtype=torch.float32, device=dev)[None]
                + 0.5) * (lo / fin)[:, None] - 0.5)
        pos = torch.minimum(pos.clamp_min(0.0), lo[:, None] - 1.0)
        p0 = torch.floor(pos)
        i0 = p0.long().clamp(0, limit - 1)
        return i0, (i0 + 1).clamp_max(limit - 1), pos - p0

    x0, x1, fx = axis(TW, lsz[:, 0], fsz[:, 0], LW)
    y0, y1, fy = axis(TH, lsz[:, 1], fsz[:, 1], LH)
    bi = torch.arange(seams.shape[0], device=dev)[:, None, None]

    def tap(yy, xx):
        return dil[bi, yy[:, :, None], xx[:, None, :]]

    fx = fx[:, None, :]
    fy = fy[:, :, None]
    r0 = tap(y0, x0) * (1 - fx) + tap(y0, x1) * fx
    r1 = tap(y1, x0) * (1 - fx) + tap(y1, x1) * fx
    res = r0 * (1 - fy) + r1 * fy
    return torch.where(fin_masks > 0, res, 0.0)


def resize_seam_masks_stack(seam_masks_low, final_stack: TileStack):
    """Resize the LOW seam masks against the FINAL stack's masks.

    seam_masks_low: a tuple (masks (B, LH, LW) float32 on the card,
    low_sizes (B, 2)). Returns (B, TH, TW) float32 aligned with
    `final_stack.data`.
    """
    lo, low_sizes = seam_masks_low
    dev = final_stack.data.device
    b = final_stack.data.shape[0]
    lsz = np.ones((b, 2), np.int32)
    lsz[:len(low_sizes)] = np.asarray(low_sizes, np.int32)
    fsz = np.ones((b, 2), np.int32)
    fsz[:len(final_stack.sizes)] = final_stack.sizes
    return _seam_resize_kernel(lo, torch.as_tensor(lsz, device=dev),
                               final_stack.masks,
                               torch.as_tensor(fsz, device=dev))


# ---------------------------------------------------------------------------
# Blending
# ---------------------------------------------------------------------------

def _canvas_roi(corners, sizes):
    xs = corners[:, 0]
    ys = corners[:, 1]
    x2 = corners[:, 0] + sizes[:, 0]
    y2 = corners[:, 1] + sizes[:, 1]
    tl = (int(xs.min()), int(ys.min()))
    return tl, (int(x2.max()) - tl[0], int(y2.max()) - tl[1])


def _shifted_tile_window(tile, seam, shift, size):
    """View the tile inside its (clamped) canvas window: window pixel
    (r, s) maps to tile pixel (r - shift_y, s - shift_x); outside the true
    tile extent the seam reads 0 (no contribution)."""
    TH, TW = tile.shape[0], tile.shape[1]
    dev = tile.device
    ry = torch.arange(TH, device=dev) - int(shift[1])
    rx = torch.arange(TW, device=dev) - int(shift[0])
    yc = ry.clamp(0, TH - 1)
    xc = rx.clamp(0, TW - 1)
    win = tile[yc][:, xc]
    iny = (ry >= 0) & (ry < int(size[1]))
    inx = (rx >= 0) & (rx < int(size[0]))
    sm = torch.where(iny[:, None] & inx[None, :], seam[yc][:, xc], 0.0)
    return win, sm


def _paste_feed_batched(tiles, seams, offs, shifts, sizes, n, ph, pw):
    """Paste the first n tiles' seam-owned pixels onto the canvas, in batch
    order (later tiles overwrite earlier ones). The canvas updates in
    place."""
    C = tiles.shape[-1]
    TH, TW = tiles.shape[1], tiles.shape[2]
    dev = tiles.device
    canvas = torch.zeros((ph, pw, C), dtype=torch.float32, device=dev)
    cmask = torch.zeros((ph, pw), dtype=torch.float32, device=dev)
    for i in range(n):
        win, sm = _shifted_tile_window(tiles[i], seams[i], shifts[i],
                                       sizes[i])
        inside = sm > 0
        oy, ox = int(offs[i, 1]), int(offs[i, 0])
        region = canvas[oy:oy + TH, ox:ox + TW]
        region.copy_(torch.where(inside[..., None], win, region))
        mreg = cmask[oy:oy + TH, ox:ox + TW]
        mreg.masked_fill_(inside, 255.0)
    return canvas, cmask


# the multiband window's bucket (the reference's `_BUCKET`): the window
# size fixes the clamped window offsets and the reflect context, so every
# coarse band depends on it
_MB_BUCKET = 128
# accumulator bytes over which the reference leaves the batched blend for
# X/Y strips or a streamed fetch (its default `STITCHING_TPU_BLEND_BUDGET`)
_BLEND_BUDGET_BYTES = 4e9
_EPS = 1e-5


def _plan_blend(corners, sizes, b, blender_type, blend_strength, th, twd):
    """Host geometry plan of the blend: the blender kind (blend_width < 1
    -> "no", the reference rule), band count, window and canvas shapes,
    and each image's pyramid-aligned window offset and in-window tile
    shift."""
    corners = np.asarray(corners)
    sizes = np.asarray(sizes)
    tl, (dw, dh) = _canvas_roi(corners, sizes)
    n = len(sizes)
    szs = np.ones((b, 2), np.int32)
    szs[:n] = sizes

    blend_width = np.sqrt(dh * dw) * blend_strength / 100.0
    kind = blender_type if blend_width >= 1 else "no"

    nb = 1
    sharpness = 0.0
    offs = np.zeros((b, 2), np.int32)
    shifts = np.zeros((b, 2), np.int32)
    if kind == "multiband":
        # the reference's num_bands (stitching/blender.py:32), int()
        # truncating toward zero: 0 bands for blend_width in [1, 4)
        nb = int(np.clip(int(np.log(blend_width) / np.log(2.0) - 1.0), 0, 8))
        m = 1 << nb
        gap = 3 * m
        # the window is the tile plus the border-context gap on each side
        wh = _round_up(th + 2 * gap + m, max(_MB_BUCKET, m))
        ww = _round_up(twd + 2 * gap + m, max(_MB_BUCKET, m))
    else:
        m = 1
        gap = 0
        if kind == "feather":
            sharpness = 1.0 / blend_width
        wh, ww = th, twd
    ph = max(_round_up(dh + gap + m, max(64, m)), wh)
    pw = max(_round_up(dw + gap + m, max(64, m)), ww)
    # window offsets clamp so that every window fits a canvas only slightly
    # larger than the panorama (the window gathers its tile at a per-image
    # shift, so the clamp is exact)
    for i in range(n):
        for a, (pd, wd) in enumerate(((pw, ww), (ph, wh))):
            start = max(corners[i, a] - gap, tl[a])
            aligned = tl[a] + ((start - tl[a]) // m) * m
            aligned = min(aligned, tl[a] + pd - wd)
            offs[i, a] = aligned - tl[a]
            shifts[i, a] = corners[i, a] - aligned
    return dict(kind=kind, nb=nb, m=m, gap=gap, sharpness=sharpness,
                wh=wh, ww=ww, ph=ph, pw=pw, tl=tl, dh=dh, dw=dw,
                offs=offs, shifts=shifts, szs=szs, n=n)


def _mb_window(tile, seam, shift, size, wh, ww):
    """One tile's (wh, ww) multiband window: window pixel (r, s) is tile
    pixel (r - shift_y, s - shift_x). Outside the true (w, h) extent the
    image content reflects (the reference's BORDER_REFLECT feed) and the
    seam reads 0."""
    TH, TW = tile.shape[0], tile.shape[1]
    dev = tile.device
    w, h = int(size[0]), int(size[1])

    def reflect(i, n):
        i = torch.remainder(i, 2 * n)       # floor mod, as jnp.mod
        return torch.where(i >= n, 2 * n - 1 - i, i)

    ry = torch.arange(wh, device=dev) - int(shift[1])
    rx = torch.arange(ww, device=dev) - int(shift[0])
    win = tile[reflect(ry, h).clamp(0, TH - 1)][:, reflect(rx, w).clamp(
        0, TW - 1)]
    inside = ((ry >= 0) & (ry < h))[:, None] & ((rx >= 0) & (rx < w))[None]
    sm = torch.where(inside, seam[ry.clamp(0, TH - 1)][:, rx.clamp(
        0, TW - 1)], 0.0)
    return win, sm


def _mb_feed(tiles, seams, offs, shifts, sizes, n, nb, wh, ww, ph, pw):
    """Feed the tiles into per-level multiband accumulators, one window
    at a time in batch order (so the float sums are the reference's scan
    and only one window's pyramids are live). Returns (band_acc, band_w),
    level l of shape (ph >> l, pw >> l, C) and (..., 1)."""
    C = tiles.shape[-1]
    dev = tiles.device
    band_acc = [torch.zeros((ph >> lv, pw >> lv, C), dtype=torch.float32,
                            device=dev) for lv in range(nb + 1)]
    band_w = [torch.zeros((ph >> lv, pw >> lv, 1), dtype=torch.float32,
                          device=dev) for lv in range(nb + 1)]
    # only the n real tiles: padded batch slots have empty seams
    for i in range(n):
        win, sm = _mb_window(tiles[i], seams[i], shifts[i], sizes[i], wh, ww)
        laps = build_laplacian(win, nb)
        wpyr = build_gaussian((sm > 0).to(torch.float32)[..., None], nb)
        for lv in range(nb + 1):
            yy, xx = int(offs[i, 1]) >> lv, int(offs[i, 0]) >> lv
            bh, bw = laps[lv].shape[0], laps[lv].shape[1]
            band_acc[lv][yy:yy + bh, xx:xx + bw] += laps[lv] * wpyr[lv]
            band_w[lv][yy:yy + bh, xx:xx + bw] += wpyr[lv]
    return band_acc, band_w


def _mb_collapse(band_acc, band_w):
    """Normalise each band by its weight and collapse the pyramid.
    Returns the canvas (ph, pw, C) and the level-0 weight map (ph, pw)."""
    laps = [a / (w + _EPS) for a, w in zip(band_acc, band_w)]
    return collapse_laplacian(laps), band_w[0][..., 0]


def _feather_feed(tiles, seams, offs, shifts, sizes, n, sharpness, ph, pw):
    """Feather accumulators: each tile weighted by its L1 distance to the
    edge of its seam mask times `sharpness`, clipped at 1, added in batch
    order. Returns (acc (ph, pw, C), wsum (ph, pw))."""
    C = tiles.shape[-1]
    TH, TW = tiles.shape[1], tiles.shape[2]
    dev = tiles.device
    acc = torch.zeros((ph, pw, C), dtype=torch.float32, device=dev)
    wsum = torch.zeros((ph, pw), dtype=torch.float32, device=dev)
    sharp = float(np.float32(sharpness))   # the reference's float32 scalar
    for i in range(n):
        win, sm = _shifted_tile_window(tiles[i], seams[i], shifts[i],
                                       sizes[i])
        m = (sm > 0).to(torch.float32)
        wgt = (distance_transform_l1(m) * sharp).clamp_max(1.0)
        wgt = torch.where(m > 0, wgt, 0.0)
        oy, ox = int(offs[i, 1]), int(offs[i, 0])
        acc[oy:oy + TH, ox:ox + TW] += win * wgt[..., None]
        wsum[oy:oy + TH, ox:ox + TW] += wgt
    return acc, wsum


def _to_u8(img):
    return torch.round(img).clamp(0, 255).to(torch.uint8)


def blend_stack(stack: TileStack, seam_masks, blender_type, blend_strength):
    """Composite the stack into the panorama.

    seam_masks: (B, TH, TW) tensor (from `resize_seam_masks_stack`) or None
    (use the stack's warp masks). The blender kind comes from
    `_plan_blend`: "multiband", "feather" or the paste composite "no".
    Returns (pano_u8 (dh, dw, C), mask_u8 (dh, dw)) on the stack's device;
    `fetch_image` copies to the host.
    """
    if seam_masks is None:
        seam_masks = stack.masks
    b = stack.data.shape[0]
    C = stack.data.shape[-1]
    th, twd = int(stack.data.shape[1]), int(stack.data.shape[2])
    p = _plan_blend(stack.corners, stack.sizes, b, blender_type,
                    blend_strength, th, twd)
    kind, ph, pw, n = p["kind"], p["ph"], p["pw"], p["n"]
    # the reference's estimate: C + 1 float32 planes, with the coarser
    # levels and the working copies
    acc_bytes = ph * pw * (C + 1) * 4 * 8 // 3
    if acc_bytes > _BLEND_BUDGET_BYTES:
        raise NotImplementedError(
            f"a {pw} x {ph} blend canvas needs {acc_bytes / 1e9:.1f} GB of "
            f"accumulators, over the {_BLEND_BUDGET_BYTES / 1e9:.0f} GB "
            "blend budget: not ported yet (ROADMAP queue 1: streamed and "
            "strip composite)")
    args = (stack.data, seam_masks, p["offs"], p["shifts"], p["szs"], n)
    if kind == "multiband":
        canvas, wmap = _mb_collapse(*_mb_feed(
            *args, p["nb"], p["wh"], p["ww"], ph, pw))
    elif kind == "feather":
        acc, wmap = _feather_feed(*args, p["sharpness"], ph, pw)
        canvas = acc / wmap[..., None].clamp_min(_EPS)
    else:
        canvas, wmap = _paste_feed_batched(*args, ph, pw)
    dh, dw = p["dh"], p["dw"]
    return _to_u8(canvas[:dh, :dw]), (wmap[:dh, :dw] > _EPS).to(
        torch.uint8) * 255


def fetch_image(img):
    """Device -> host copy of an image tensor (host arrays pass through)."""
    if isinstance(img, np.ndarray):
        return img
    return img.cpu().numpy()
