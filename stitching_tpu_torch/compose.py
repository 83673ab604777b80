"""Compositing on the card: warp, crop, gains, seam masks, blend.

Port of `stitching_tpu/compose.py` for one card. The batched stages are
one pass over a stacked tile batch that stays in device memory:

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
  tile in batch order, then one uint8 conversion. A canvas whose
  accumulators pass `BLEND_BUDGET_BYTES` blends in X or Y strips
  (`_blend_strips`), or, when its windows span more than a third of both
  axes, as one canvas fed in row order whose finished row bands collapse
  and leave the card while later tiles feed (`_blend_monolithic_stream`).

The streamed stages do the same per image, as the reference's FINAL pass
schedules them. `FinalPlan` plans that pass once a stitch (the warp
ROIs, the crop, the gains and seam sizes on the card, the blend plan).
As each upload lands (`transfer.Uploader`), `final_tile` makes the
image's tile and seam (warp, crop, gains, seam resize) and
`StreamComposite` feeds them into the blend's accumulators at once; over
the budget, `warp_stack_streamed` warps each into a stack for the batched
stages instead. Both run the batched stages' own per-image code (the
B = 1 warp, the gain and seam kernels on one row, `_mb_feed_one`,
`_feather_feed_one`, `_paste_feed_one`) in image order, so the streamed
panorama equals the batched one value for value.

Tiles share one 64-bucketed (B, TH, TW, C) shape; true per-image corners
and sizes ride along as host metadata.

Under a mesh (`parallel.mesh`, SPMD) a stack holds this rank's block of
tiles while corners and sizes stay whole on the host, so every rank plans
the same geometry. The batched blend feeds each rank's tiles into
full-size accumulators that merge with one reduction (a sum for
multiband and feather, a maximum for the paste); strips spread over the
ranks (`_balance_strips`), each rank receiving the tiles its strips read
from the ranks that warped them, and the uint8 segments are gathered.
The streamed stages stay single-rank.
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from . import profiling as prof
from .ops.blend import _to_u8, distance_transform_l1
from .ops.fma import fma
from .ops.kernels.band_copy import copy_band
from .ops.kernels.bilinear_sample import bilinear_sample
from .ops.pyramid import build_gaussian, build_laplacian, collapse_laplacian
from .ops.warp import PROJECTORS, warp_roi
from .parallel.mesh import (all_gather_leading, all_reduce_max,
                            all_reduce_sum, exchange)
from .pipeline import DeviceStack, RankBlock, pad_sizes, resize_stack


def _round_up(x, m=64):
    return int(-(-x // m) * m)


@dataclasses.dataclass(frozen=True)
class TileStack(RankBlock):
    """A batch of warped tiles resident on the card.

    data: (B, TH, TW, C) float32; tile i's true content is [0:h_i, 0:w_i].
    masks: (B, TH, TW) float32 in {0, 255}: warp validity.
    corners: host (B, 2) int (x, y) in surface/panorama coordinates.
    sizes: host (B, 2) int (w, h) true tile sizes.
    mesh: None, or the mesh the batch is split over: then `data` and
    `masks` hold this rank's block of B / D tiles, corners and sizes all.
    """

    data: torch.Tensor
    masks: torch.Tensor
    corners: np.ndarray
    sizes: np.ndarray
    mesh: object = None

    def to_host(self):
        """Lists of per-image uint8 (img, mask) host arrays cropped to the
        true sizes: the pixels convert to uint8 on the card, so one copy
        moves a quarter of the bytes."""
        data = _to_u8(self.data).cpu().numpy()
        masks = self.masks.to(torch.uint8).cpu().numpy()
        imgs = [data[i, :h, :w] for i, (w, h) in enumerate(self.sizes)]
        ms = [masks[i, :h, :w] for i, (w, h) in enumerate(self.sizes)]
        return imgs, ms


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


def _k_rinv(K, R, warper_type):
    """The backward map's matrix K R^-1, float32; the affine backward map
    is p = K A (u, v, 1)."""
    K64 = np.asarray(K, np.float64)
    R64 = np.asarray(R, np.float64)
    return (K64 @ R64 if warper_type == "affine"
            else K64 @ np.linalg.inv(R64)).astype(np.float32)


def warp_stack(data, src_sizes, Ks, Rs, scale, warper_type,
               mesh=None) -> TileStack:
    """Warp the whole padded image stack in one batched pass.

    data: (B, H, W, C) tensor; src_sizes: (B, 2) host int (w, h);
    Ks/Rs: per-image 3x3. Returns a TileStack with true per-image ROIs.
    With a mesh, `data` is this rank's block of B / D images (sizes, Ks
    and Rs list all of them): every rank plans the tile shape from all
    ROIs and warps its block.
    """
    b = data.shape[0]
    n = len(Ks)
    dev = data.device
    lo = 0 if mesh is None else mesh.block(b * mesh.size)[0]
    corners, dsizes = plan_warp_rois(
        [tuple(s) for s in src_sizes[:n]], Ks, Rs, scale, warper_type)
    th = _round_up(int(dsizes[:, 1].max()))
    tw = _round_up(int(dsizes[:, 0].max()))
    k_rinv = np.zeros((b, 3, 3), np.float32)
    tls = np.zeros((b, 2), np.float32)
    # padded batch slots get a zero ROI, hence an all-zero mask
    dsz = np.zeros((b, 2), np.int32)
    for i in range(lo, min(lo + b, n)):
        k_rinv[i - lo] = _k_rinv(Ks[i], Rs[i], warper_type)
        tls[i - lo] = corners[i]
        dsz[i - lo] = dsizes[i]
    src = np.asarray(src_sizes, np.int32)[lo:lo + b]
    tiles, masks = _warp_stack_kernel(
        data, torch.as_tensor(src, device=dev),
        torch.as_tensor(k_rinv, device=dev), torch.as_tensor(tls, device=dev),
        torch.as_tensor(dsz, device=dev), float(np.float32(1.0 / scale)),
        th=th, tw=tw, warper_type=warper_type)
    return TileStack(tiles, masks, np.asarray(corners[:n]),
                     np.asarray(dsizes[:n]), mesh)


def gather_tiles(stack: TileStack) -> TileStack:
    """The whole stack on every rank of its mesh, as a TileStack without
    a mesh (the stack itself when it has none)."""
    if stack.mesh is None:
        return stack
    return TileStack(all_gather_leading(stack.data, stack.mesh),
                     all_gather_leading(stack.masks, stack.mesh),
                     stack.corners, stack.sizes)


def warp_single(raw, size_wh, K, R, corner, dsize, scale, warper_type,
                th, tw, channels=None):
    """Resize and warp ONE image: a (1, th, tw, C) tile and a (1, th, tw)
    mask, the B = 1 instance of `warp_stack` on `resize_stack`'s output,
    so its values equal the batched path's.

    raw: (h, w) or (h, w, C) uint8/float tensor on the card; size_wh: the
    target (w, h); `channels` = 3 widens a gray image as `stack_images`
    does in a mixed set."""
    img = raw.to(torch.float32)
    if img.dim() == 2:
        img = img[..., None]
    if channels == 3 and img.shape[-1] == 1:
        img = img.expand(-1, -1, 3).contiguous()
    w, h = int(size_wh[0]), int(size_wh[1])
    src = resize_stack(
        DeviceStack(img[None], np.asarray([[img.shape[1], img.shape[0]]],
                                          np.int32)),
        np.asarray([[w, h]], np.int32))
    dev = img.device
    return _warp_stack_kernel(
        src.data, torch.as_tensor([[w, h]], dtype=torch.int32, device=dev),
        torch.as_tensor(_k_rinv(K, R, warper_type)[None], device=dev),
        torch.as_tensor(np.asarray([corner], np.float32), device=dev),
        torch.as_tensor(np.asarray([dsize], np.int32), device=dev),
        float(np.float32(1.0 / scale)), th=th, tw=tw,
        warper_type=warper_type)


def warp_stack_streamed(source, plan) -> TileStack:
    """Per-image warp paced by an upload stream.

    source: a `transfer.Uploader` (`image(i)` waits until image i has
    landed); plan: the pass's `FinalPlan`. Each image warps into its ROI
    as soon as it lands, so the stack equals `warp_stack`'s."""
    tiles, masks = zip(*(plan.warp(i, source.image(i))
                         for i in range(len(plan.sizes))))
    return TileStack(torch.cat(tiles), torch.cat(masks), plan.corners,
                     plan.dsizes)


# ---------------------------------------------------------------------------
# Crop
# ---------------------------------------------------------------------------

def crop_shape(rects, th, tw):
    """The common (ch, cw) of tiles cropped to `rects` out of (th, tw)
    tiles, and the bottom/right padding (pad_h, pad_w) under which every
    (ch, cw) slice starts exactly at its rect origin: no clamping, so
    content never shifts against corners/sizes."""
    ch = _round_up(max(r[3] for r in rects))
    cw = _round_up(max(r[2] for r in rects))
    return (ch, cw, max(0, max(r[1] for r in rects) + ch - th),
            max(0, max(r[0] for r in rects) + cw - tw))


def crop_geometry(cropper, aspect, corners, sizes):
    """The crop by the prepared `cropper`, at `aspect` times its scale, of
    tiles at `corners` of `sizes`: each tile's (x, y, w, h) rect, and the
    cropped corners and sizes (the ROI math lives in the cropper)."""
    rects = [tuple(r.times(aspect)) for r in cropper.intersection_rectangles]
    corners, sizes = cropper.crop_rois([tuple(c) for c in corners],
                                       [tuple(s) for s in sizes], aspect)
    return rects, np.asarray(corners), np.asarray(sizes, np.int64)


def slice_tiles(data, masks, rects, ch, cw, pad_h, pad_w):
    """(B, ch, cw, C) tiles and (B, ch, cw) masks: tile i from rect i's
    origin, under the padding of `crop_shape`."""
    data = F.pad(data, (0, 0, 0, pad_w, 0, pad_h))
    masks = F.pad(masks, (0, pad_w, 0, pad_h))
    return (torch.stack([data[i, r[1]:r[1] + ch, r[0]:r[0] + cw]
                         for i, r in enumerate(rects)]),
            torch.stack([masks[i, r[1]:r[1] + ch, r[0]:r[0] + cw]
                         for i, r in enumerate(rects)]))


def slice_stack(stack: TileStack, rects) -> TileStack:
    """Crop each tile to its (x, y, w, h) rect; corners/sizes updated by the
    caller (crop ROI math lives in the cropper)."""
    rects = [tuple(r) for r in rects]
    n = len(rects)
    b, lo = stack.data.shape[0], stack.lo
    rects = rects + [(0, 0, 1, 1)] * (stack.batch - n)  # padded slots
    # one shape from every rect, on every rank of a mesh
    shape = crop_shape(rects, int(stack.data.shape[1]),
                       int(stack.data.shape[2]))
    tiles, masks = slice_tiles(stack.data, stack.masks, rects[lo:lo + b],
                               *shape)
    sizes = np.asarray([(r[2], r[3]) for r in rects[:n]], np.int64)
    return TileStack(tiles, masks, np.asarray(stack.corners), sizes,
                     stack.mesh)


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


def _gains(compensator, sizes, b, C, device):
    """`plan_gain_arrays` on `device`, as the one function that applies
    them: (tiles, batch rows) -> the tiles times those rows' gains."""
    mode, arrs = plan_gain_arrays(compensator, sizes, b, C)
    if mode == "no":
        return lambda tiles, rows: tiles
    kernel, arrs = ((_gain_mul_kernel, (arrs,)) if mode == "scalar"
                    else (_gain_map_kernel, arrs))
    arrs = [torch.as_tensor(a, device=device) for a in arrs]
    return lambda tiles, rows: kernel(tiles, *[a[rows] for a in arrs])


def apply_gains_stack(stack: TileStack, compensator) -> TileStack:
    """Apply the fed compensator to the whole tile stack on its device
    (under a mesh, to this rank's block)."""
    gains = _gains(compensator, stack.sizes, stack.batch,
                   stack.data.shape[-1], stack.data.device)
    tiles = gains(stack.data, slice(stack.lo, stack.lo + stack.data.shape[0]))
    return stack if tiles is stack.data else dataclasses.replace(stack,
                                                                 data=tiles)


# ---------------------------------------------------------------------------
# Batched seam-mask resize (dilate + bilinear resize + AND with warp mask)
# ---------------------------------------------------------------------------

def _seam_sizes(low_sizes, fin_sizes, b, device):
    """The LOW and the FINAL (w, h) of `b` batch slots (`pad_sizes`) on
    `device`: what `_seam_resize_kernel` reads."""
    return tuple(torch.as_tensor(pad_sizes(s, b), device=device)
                 for s in (low_sizes, fin_sizes))


def _seam_resize_kernel(seams, seam_sizes, rows, fin_masks):
    """seams: (B, LH, LW) float32; seam_sizes: `_seam_sizes`, whose batch
    rows `rows` are these B images'; fin_masks: (B, TH, TW) float32
    {0,255}. Per image: 3x3 dilate the LOW seam mask, bilinear-resize it
    to the image's FINAL size, zero outside the FINAL warp mask."""
    LH, LW = seams.shape[1], seams.shape[2]
    TH, TW = fin_masks.shape[1], fin_masks.shape[2]
    dev = seams.device
    # max_pool2d pads with -inf where the reference pads with 0: every
    # window holds a real mask value >= 0, so the two maxima agree
    dil = F.max_pool2d(seams[:, None], 3, stride=1, padding=1)[:, 0]
    lsz = seam_sizes[0][rows].to(torch.float32)
    fsz = seam_sizes[1][rows].to(torch.float32).clamp_min(1.0)

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
    `final_stack.data`. Under a mesh the LOW masks are whole on every
    rank (one row per image, or more) and this rank resizes its block.
    """
    lo_masks, low_sizes = seam_masks_low
    b, lo = final_stack.data.shape[0], final_stack.lo
    if final_stack.mesh is not None:
        part = lo_masks[lo:lo + b]
        lo_masks = torch.cat([part, part.new_zeros(
            (b - part.shape[0], *part.shape[1:]))])
    sizes = _seam_sizes(low_sizes, final_stack.sizes, final_stack.batch,
                        final_stack.data.device)
    return _seam_resize_kernel(lo_masks, sizes, slice(lo, lo + b),
                               final_stack.masks)


# ---------------------------------------------------------------------------
# Blending: the plan and the per-image feeds
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


# the multiband window's bucket (the reference's `_BUCKET`): the window
# size fixes the clamped window offsets and the reflect context, so every
# coarse band depends on it
_MB_BUCKET = 128
# accumulator bytes over which `blend_stack` leaves the batched blend for
# X/Y strips or the streamed monolithic blend (`_batched_bytes`), and over
# which the engine's FINAL pass leaves the streamed composite
# (`stream_fits`): the reference's default `STITCHING_TPU_BLEND_BUDGET`.
# Both read it at each call
BLEND_BUDGET_BYTES = 4e9
_EPS = 1e-5


def stream_fits(p, C):
    """Whether the accumulators that `StreamComposite` allocates for blend
    plan `p` and C channels (C + 1 float32 planes at every level of the
    canvas) fit `BLEND_BUDGET_BYTES`."""
    levels = p["nb"] + 1 if p["kind"] == "multiband" else 1
    return sum((p["ph"] >> lv) * (p["pw"] >> lv) * (C + 1) * 4
               for lv in range(levels)) <= BLEND_BUDGET_BYTES


def _batched_bytes(h, w, C):
    """`blend_stack`'s estimate for an (h, w) canvas, the reference's: C + 1
    float32 planes, with the coarser levels and the working copies."""
    return h * w * (C + 1) * 4 * 8 // 3


def _plan_blend(corners, sizes, b, blender_type, blend_strength, th, twd):
    """Host geometry plan of the blend: the blender kind (blend_width < 1
    -> "no", the reference rule), band count, window and canvas shapes,
    and each image's pyramid-aligned window offset and in-window tile
    shift."""
    corners = np.asarray(corners)
    sizes = np.asarray(sizes)
    tl, (dw, dh) = _canvas_roi(corners, sizes)
    n = len(sizes)
    szs = pad_sizes(sizes, b)

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


def _new_state(kind, nb, ph, pw, C, device):
    """Zeroed accumulators: per-level (band_acc, band_w) lists for
    multiband, (acc, wsum) for feather, (canvas, cmask) for the paste."""
    if kind == "multiband":
        return ([torch.zeros((ph >> lv, pw >> lv, C), dtype=torch.float32,
                             device=device) for lv in range(nb + 1)],
                [torch.zeros((ph >> lv, pw >> lv, 1), dtype=torch.float32,
                             device=device) for lv in range(nb + 1)])
    return (torch.zeros((ph, pw, C), dtype=torch.float32, device=device),
            torch.zeros((ph, pw), dtype=torch.float32, device=device))


def _mb_feed_one(band_acc, band_w, tile, seam, off, shift, size, nb, wh,
                 ww):
    """One tile's window into the multiband accumulators, in place: its
    Laplacian pyramid times its seam mask's Gaussian pyramid, added level
    by level at the window's offset."""
    win, sm = _mb_window(tile, seam, shift, size, wh, ww)
    laps = build_laplacian(win, nb)
    wpyr = build_gaussian((sm > 0).to(torch.float32)[..., None], nb)
    for lv in range(nb + 1):
        yy, xx = int(off[1]) >> lv, int(off[0]) >> lv
        bh, bw = laps[lv].shape[0], laps[lv].shape[1]
        band_acc[lv][yy:yy + bh, xx:xx + bw] += laps[lv] * wpyr[lv]
        band_w[lv][yy:yy + bh, xx:xx + bw] += wpyr[lv]


def _feather_feed_one(acc, wsum, tile, seam, off, shift, size, sharpness):
    """One tile into the feather accumulators, in place, weighted by its
    L1 distance to the edge of its seam mask times `sharpness`, clipped
    at 1."""
    TH, TW = tile.shape[0], tile.shape[1]
    win, sm = _shifted_tile_window(tile, seam, shift, size)
    m = (sm > 0).to(torch.float32)
    # the reference's float32 scalar
    wgt = (distance_transform_l1(m) * float(np.float32(sharpness))
           ).clamp_max(1.0)
    wgt = torch.where(m > 0, wgt, 0.0)
    oy, ox = int(off[1]), int(off[0])
    acc[oy:oy + TH, ox:ox + TW] += win * wgt[..., None]
    wsum[oy:oy + TH, ox:ox + TW] += wgt


def _paste_feed_one(canvas, cmask, tile, seam, off, shift, size):
    """One tile's seam-owned pixels pasted onto the canvas, in place
    (later tiles overwrite earlier ones)."""
    TH, TW = tile.shape[0], tile.shape[1]
    win, sm = _shifted_tile_window(tile, seam, shift, size)
    inside = sm > 0
    oy, ox = int(off[1]), int(off[0])
    region = canvas[oy:oy + TH, ox:ox + TW]
    region.copy_(torch.where(inside[..., None], win, region))
    cmask[oy:oy + TH, ox:ox + TW].masked_fill_(inside, 255.0)


def _feed_one(state, p, i, tile, seam, off):
    """Image i of plan `p` into `state` at window offset `off`."""
    a, b = state
    shift, size = p["shifts"][i], p["szs"][i]
    if p["kind"] == "multiband":
        _mb_feed_one(a, b, tile, seam, off, shift, size, p["nb"], p["wh"],
                     p["ww"])
    elif p["kind"] == "feather":
        _feather_feed_one(a, b, tile, seam, off, shift, size,
                          p["sharpness"])
    else:
        _paste_feed_one(a, b, tile, seam, off, shift, size)


def _mb_collapse_kernel(band_acc, band_w, nb):
    """Normalise each band by its weight and collapse the pyramid.
    Returns the canvas (ph, pw, C) and the level-0 weight map (ph, pw)."""
    laps = [band_acc[lv] / (band_w[lv] + _EPS) for lv in range(nb + 1)]
    return collapse_laplacian(laps), band_w[0][..., 0]


def _feather_norm_kernel(acc, wsum):
    return acc / wsum[..., None].clamp_min(_EPS), wsum


def _finish_state(state, kind, nb):
    """(canvas, weight map) of finished accumulators."""
    if kind == "multiband":
        return _mb_collapse_kernel(*state, nb)
    if kind == "feather":
        return _feather_norm_kernel(*state)
    return state


def _wmap_to_u8(wmap):
    return (wmap > _EPS).to(torch.uint8) * 255


def _state_wmap(state, kind):
    """The level-0 weight map (ph, pw) of accumulators `state`."""
    return state[1][0][..., 0] if kind == "multiband" else state[1]


def _merge_state(state, kind, mesh):
    """Every rank's accumulators merged, in place: summed for multiband
    and feather (both are sums of per-tile terms), the maximum for the
    paste (seam masks are disjoint, so each pixel has one owner and the
    canvas is 0 elsewhere)."""
    a, b = state
    if kind == "multiband":
        for t in (*a, *b):
            all_reduce_sum(t, mesh)
    elif kind == "feather":
        all_reduce_sum(a, mesh)
        all_reduce_sum(b, mesh)
    else:
        all_reduce_max(a, mesh)
        all_reduce_max(b, mesh)


def _blend_canvas(p, tiles, seams, offs, idx, ph, pw, rows=None,
                  mesh=None):
    """The batched blend over canvas (ph, pw): the tiles `idx` fed in that
    order at window offsets `offs` (one row per entry of idx), then one
    normalise-and-collapse. Tile idx[k] is `tiles[rows[k]]` (`tiles[idx[k]]`
    by default). With a mesh each rank feeds its own `idx` and the
    accumulators merge over the ranks before the collapse. Returns
    (canvas (ph, pw, C), wmap (ph, pw))."""
    rows = idx if rows is None else rows
    state = _new_state(p["kind"], p["nb"], ph, pw, tiles[0].shape[-1],
                       tiles[0].device)
    for k, (i, r) in enumerate(zip(idx, rows)):
        _feed_one(state, p, i, tiles[r], seams[r], offs[k])
    if mesh is not None:
        _merge_state(state, p["kind"], mesh)
    return _finish_state(state, p["kind"], p["nb"])


# ---------------------------------------------------------------------------
# Device -> host copies that overlap later work
# ---------------------------------------------------------------------------

class _HostFetch:
    """Copies finished panorama bands to host memory while later work runs.

    Each band has a panorama part and, where the caller keeps the weight
    mask, a mask part. The bands land in place: the first panorama part
    takes one host panorama (dh, dw, C) (the first mask part a (dh, dw)
    mask), zeroed nowhere, because the bands cover it, and each part is
    written into its place by `ops/kernels/band_copy.copy_band`.

    On the CPU a band is written at once. On the card the host panorama
    is pinned, and each band's copy waits on an event recorded on the
    caller's (compute) stream and runs on a side stream as one strided
    copy; the band tensors are marked as used on that stream, so the
    caching allocator keeps them until their copy is done. `assemble`
    waits on the last copy and returns views of the host arrays: pinned
    on the card, their blocks stay with the caller, and the caching host
    allocator hands them out again once the caller lets them go."""

    def __init__(self, device, dh, dw, C):
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self.shapes = ((dh, dw, C), (dh, dw))
        self.host = [None, None]    # the host pano and mask
        self.done = None            # card: the last copy's event
        self.landed = 0             # card: bands landed

    def __del__(self):
        # dropped between submit and assemble (a stitch that failed): its
        # copies must end before the pinned blocks go back to the cache
        if self.done is not None:
            self.done.synchronize()

    def _land(self, axis, lo, parts):
        for k, t in enumerate(parts):
            if t is None:
                continue
            if self.host[k] is None:
                self.host[k] = torch.empty(
                    self.shapes[k], dtype=torch.uint8,
                    pin_memory=self.stream is not None)
            copy_band(self.host[k], axis, lo, t)

    def submit(self, axis, lo, seg, wseg=None):
        """Land the panorama part `seg` and the mask part `wseg` (None
        where the caller keeps no mask) of the band at [lo, lo + extent)
        along `axis`; on the card, start their copy."""
        parts = (seg, wseg)
        if self.stream is None:
            self._land(axis, lo, parts)
            return
        ready = torch.cuda.Event()
        ready.record()
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(ready)
            self._land(axis, lo, parts)
            for t in parts:
                if t is not None:
                    t.record_stream(self.stream)
            self.done = torch.cuda.Event()
            self.done.record(self.stream)
        self.landed += 1

    def assemble(self):
        """The host (pano, mask) once every band has landed; mask None
        where no band had a mask part."""
        if self.done is not None:
            with prof.stage_timer("final/blend/wait"):
                self.done.synchronize()
            prof.count("fetch/bands_in_place", self.landed)
        host = self.host
        self.host, self.done, self.landed = [None, None], None, 0
        return tuple(None if t is None else t.numpy() for t in host)


def _collapse_band(state, kind, nb, m, halo, pa, d_other, r0, r1, axis=0,
                   mask=True):
    """Span [r0, r1) of the final panorama along `axis` (0 = rows,
    1 = columns) as (seg_u8, wseg_u8), collapsed from accumulator `state`
    over the span widened by `halo` (the pyr_up chain's support) and
    aligned to the coarsest level, so it equals the full collapse there.
    `pa` is the accumulator extent along the axis; `d_other` the
    panorama extent across it. mask=False: wseg_u8 is None."""
    a0 = max(r0 - halo, 0)
    a1 = min(-(-(r1 + halo) // m) * m, pa)
    a0 = (a0 // m) * m

    def span(x, lv=0):
        if axis == 0:
            return x[a0 >> lv:a1 >> lv]
        return x[:, a0 >> lv:a1 >> lv]

    if kind == "multiband":
        acc, wacc = state
        laps = [span(acc[lv], lv) / (span(wacc[lv], lv) + _EPS)
                for lv in range(nb + 1)]
        band = collapse_laplacian(laps)
    elif kind == "feather":
        acc, wsum = state
        band = span(acc) / span(wsum)[..., None].clamp_min(_EPS)
    else:
        band = span(state[0])
    cut = ((slice(r0 - a0, r1 - a0), slice(0, d_other)) if axis == 0
           else (slice(0, d_other), slice(r0 - a0, r1 - a0)))
    wseg = (_wmap_to_u8(span(_state_wmap(state, kind))[cut]) if mask
            else None)
    return _to_u8(band[cut]), wseg


def _halo(p):
    return max(2 ** (p["nb"] + 2), p["m"]) if p["kind"] == "multiband" else 0


# ---------------------------------------------------------------------------
# Strips and the streamed monolithic blend (canvases over the budget)
# ---------------------------------------------------------------------------

def _plan_strips(offs, szs, ww, m, gap, nb, dw, strip_w, kind="multiband"):
    """Host plan of the strips along one canvas axis: for each strip
    [cs, ce) of the panorama, the local canvas span [ls, le) and the
    members, every tile whose window reaches the strip's interior within
    the support margin S; then the most members of a strip and a common
    local extent. Returns None when no strip has a member.

    S: multiband needs border context for the feed and the collapse's
    pyr_up chain, S = gap + 2^(nb+1); feather and paste weights are
    computed per tile window, so their strips are exact with S = 0."""
    S = gap + (1 << (nb + 1)) if kind == "multiband" else 0
    offs = np.asarray(offs).reshape(-1)   # strip-axis window offsets
    members = []
    for cs in range(0, dw, strip_w):
        ce = min(cs + strip_w, dw)
        keep = [i for i in range(len(szs))
                if offs[i] + ww > cs - S and offs[i] < ce + S]
        if keep:
            ls = min(min(offs[i] for i in keep), cs)
            le = max(max(offs[i] + ww for i in keep), cs + strip_w)
        else:
            ls, le = cs, cs + strip_w
        ls = max((ls // m) * m, 0)
        members.append((cs, ce, ls, le, keep))
    if not any(keep for *_, keep in members):
        return None
    max_k = max(max((len(k) for *_, k in members)), 1)
    pw_local = _round_up(max(le - ls for _, _, ls, le, _ in members),
                         max(512, m))
    return members, max_k, pw_local


def _blend_strips(stack, seam_masks, p, strip_w, axis, stream_fetch,
                  mesh=None):
    """Blend in strips along canvas axis `axis` (0 = column/X strips,
    1 = row/Y strips), each strip's interior equal to the monolithic
    blend's: its local canvas takes every tile whose window reaches the
    interior within the support margin (`_plan_strips`), so only the
    accumulators' memory shrinks. The reference pads each strip's members
    to one count with zero-seam duplicates for its compiler; a zero weight
    adds exactly 0, so here a strip feeds its members only.

    stream_fetch=True: each strip's uint8 segment copies to the host while
    later strips compute (`_HostFetch`), and the result is a host
    (pano, mask) pair; otherwise a pair of tensors on the card. With a
    mesh the strips spread over the ranks (`_blend_strips_mesh`) and every
    rank returns the panorama on its device."""
    a = int(axis)
    dh, dw, ph, pw = p["dh"], p["dw"], p["ph"], p["pw"]
    n = p["n"]
    C = stack.data.shape[-1]
    dev = stack.data.device
    # every tile's window starts inside the panorama, so some strip has
    # members and the plan is never None here
    members, _, pa_local = _plan_strips(
        p["offs"][:n, a], p["szs"][:n], (p["ww"], p["wh"])[a], p["m"],
        p["gap"], p["nb"], (dw, dh)[a], strip_w, p["kind"])
    # the local canvas: the strip axis shrinks to pa_local
    lph, lpw = (ph, pa_local) if a == 0 else (pa_local, pw)
    if mesh is not None:
        return _blend_strips_mesh(stack, seam_masks, p, members, lph, lpw,
                                  strip_w, a, mesh)
    fetch = _HostFetch(dev, dh, dw, C) if stream_fetch else None
    if not stream_fetch:
        pano = torch.zeros((dh, dw, C), dtype=torch.uint8, device=dev)
        wmask = torch.zeros((dh, dw), dtype=torch.uint8, device=dev)
    for cs, ce, ls, _, keep in members:
        if not keep:
            if stream_fetch:
                # the host panorama is not zeroed: a strip that no tile
                # reaches lands as zeros
                shape = (dh, ce - cs) if a == 0 else (ce - cs, dw)
                fetch.submit(1 - a, cs, torch.zeros(
                    (*shape, C), dtype=torch.uint8, device=dev), torch.zeros(
                    shape, dtype=torch.uint8, device=dev))
            continue
        offs = p["offs"][keep].copy()
        offs[:, a] -= ls
        strip, w0 = _blend_canvas(p, stack.data, seam_masks, offs, keep,
                                  lph, lpw)
        x0 = cs - ls
        if a == 0:
            seg = _to_u8(strip[:dh, x0:x0 + ce - cs])
            wseg = _wmap_to_u8(w0[:dh, x0:x0 + ce - cs])
        else:
            seg = _to_u8(strip[x0:x0 + ce - cs, :dw])
            wseg = _wmap_to_u8(w0[x0:x0 + ce - cs, :dw])
        if stream_fetch:
            fetch.submit(1 - a, cs, seg, wseg)
        elif a == 0:
            pano[:, cs:ce] = seg
            wmask[:, cs:ce] = wseg
        else:
            pano[cs:ce] = seg
            wmask[cs:ce] = wseg
    if stream_fetch:
        return fetch.assemble()
    return pano, wmask


def _balance_strips(members, n_dev):
    """Order strips so each device's contiguous block carries a near-even
    share of tile-feed work (greedy longest-processing-time assignment by
    member count). Returns (perm, n_pad): strip perm[p] goes to slot p;
    device d owns slots [d*n_pad/D, (d+1)*n_pad/D)."""
    n_s = len(members)
    n_pad = -(-n_s // n_dev) * n_dev
    per_dev = n_pad // n_dev
    order = sorted(range(n_s), key=lambda s: -len(members[s][4]))
    buckets = [[] for _ in range(n_dev)]
    loads = [0] * n_dev
    for s in order:
        d = min(range(n_dev),
                key=lambda k: (loads[k], len(buckets[k])))
        if len(buckets[d]) >= per_dev:
            d = min((k for k in range(n_dev) if len(buckets[k]) < per_dev),
                    key=lambda k: (loads[k], len(buckets[k])))
        buckets[d].append(s)
        loads[d] += len(members[s][4])
    perm = []
    for d in range(n_dev):
        blk = buckets[d] + [-1] * (per_dev - len(buckets[d]))
        perm.extend(blk)
    return perm, n_pad


def _strip_tiles(stack, seam_masks, need, mesh):
    """This rank's tiles and seams for the strips it blends: need[d] lists
    the tiles rank d's strips read. Each rank sends every other rank the
    tiles it warped and that rank needs, tile and seam in one message, and
    receives its own in the same batch. Returns (tiles, seams, row of each
    needed tile)."""
    me = mesh.rank
    b, lo = stack.data.shape[0], stack.lo

    def owned(ids, d):
        return [i for i in ids if i // b == d]

    TH, TW, C = stack.data.shape[1:]
    sends = {}
    for d in range(mesh.size):
        ids = owned(need[d], me) if d != me else []
        if ids:
            sel = torch.as_tensor([i - lo for i in ids],
                                  device=stack.data.device)
            sends[d] = torch.cat([stack.data[sel], seam_masks[sel, ..., None]],
                                 -1)
    recvs = {d: ((len(owned(need[me], d)), TH, TW, C + 1), torch.float32)
             for d in range(mesh.size)
             if d != me and owned(need[me], d)}
    got = exchange(sends, recvs, mesh)
    tiles, seams, row = [], [], {}
    for i in need[me]:
        d = i // b
        if d == me:
            tiles.append(stack.data[i - lo])
            seams.append(seam_masks[i - lo])
        else:
            k = owned(need[me], d).index(i)
            tiles.append(got[d][k, ..., :C])
            seams.append(got[d][k, ..., C])
        row[i] = len(tiles) - 1
    return tiles, seams, row


def _blend_strips_mesh(stack, seam_masks, p, members, lph, lpw, strip_w, a,
                       mesh):
    """The strips spread over the ranks of a mesh.

    The strips are balanced over the ranks by member count
    (`_balance_strips`, greedy LPT), each rank receives the tiles its
    strips read (`_strip_tiles`) and blends its strips as `_blend_strips`
    does, with no collective in the arithmetic (each strip's members
    carry its border context), so every strip equals the single-rank
    one. The uint8 segments, each strip_w long, are gathered and put back
    in strip order: every rank returns the (pano, mask) tensors."""
    dh, dw = p["dh"], p["dw"]
    perm, n_pad = _balance_strips(members, mesh.size)
    per = n_pad // mesh.size
    need = [sorted({i for q in range(d * per, (d + 1) * per)
                    if perm[q] >= 0 for i in members[perm[q]][4]})
            for d in range(mesh.size)]
    tiles, seams, row = _strip_tiles(stack, seam_masks, need, mesh)
    C = stack.data.shape[-1]
    dev = stack.data.device
    seg_shape = (dh, strip_w) if a == 0 else (strip_w, dw)
    segs = torch.zeros((per, *seg_shape, C), dtype=torch.uint8, device=dev)
    wsegs = torch.zeros((per, *seg_shape), dtype=torch.uint8, device=dev)
    for k, q in enumerate(range(mesh.rank * per, (mesh.rank + 1) * per)):
        if perm[q] < 0 or not members[perm[q]][4]:
            continue
        cs, _, ls, _, keep = members[perm[q]]
        offs = p["offs"][keep].copy()
        offs[:, a] -= ls
        strip, w0 = _blend_canvas(p, tiles, seams, offs, keep, lph, lpw,
                                  rows=[row[i] for i in keep])
        x0 = cs - ls
        if a == 0:
            segs[k] = _to_u8(strip[:dh, x0:x0 + strip_w])
            wsegs[k] = _wmap_to_u8(w0[:dh, x0:x0 + strip_w])
        else:
            segs[k] = _to_u8(strip[x0:x0 + strip_w, :dw])
            wsegs[k] = _wmap_to_u8(w0[x0:x0 + strip_w, :dw])
    segs = all_gather_leading(segs, mesh)
    wsegs = all_gather_leading(wsegs, mesh)
    # un-permute: slot q holds strip perm[q]
    inv = [0] * len(members)
    for q, st in enumerate(perm):
        if st >= 0:
            inv[st] = q
    pano = torch.cat([segs[q] for q in inv], 1 - a)
    wmask = torch.cat([wsegs[q] for q in inv], 1 - a)
    if a == 0:
        return pano[:, :dw], wmask[:, :dw]
    return pano[:dh], wmask[:dh]


def _blend_monolithic_stream(stack, seam_masks, p):
    """One monolithic canvas fed in row order, its finished rows leaving
    the card while later tiles feed.

    For windows that span more than a third of both canvas axes (a few
    huge tiles, the boat-fisheye shape), strips would recompute most of
    the canvas per strip. Instead the tiles feed in ascending window-top
    order into one set of accumulators, and whenever every remaining
    tile's window lies below a row frontier, the finished rows above it
    collapse as a band (with the pyr_up halo: equal to the monolithic
    collapse there) and copy to the host while later tiles feed. The
    feed order differs from the batched blend's, so the sums may differ
    in the last bit. Returns host (pano_u8, mask_u8)."""
    kind, nb, m, dh, dw, ph, pw, n = (p["kind"], p["nb"], p["m"], p["dh"],
                                      p["dw"], p["ph"], p["pw"], p["n"])
    offs = p["offs"]
    order = sorted(range(n), key=lambda i: offs[i, 1])
    halo = _halo(p)
    state = _new_state(kind, nb, ph, pw, stack.data.shape[-1],
                       stack.data.device)
    fetch = _HostFetch(stack.data.device, dh, dw, stack.data.shape[-1])
    done = 0

    # one band per frontier: the collapse halo is paid once a band
    def emit(upto):
        nonlocal done
        r0, r1 = done, min(upto, dh)
        if r1 <= r0:
            return
        fetch.submit(0, r0, *_collapse_band(state, kind, nb, m, halo, ph, dw,
                                            r0, r1, axis=0))
        done = r1

    for k, i in enumerate(order):
        _feed_one(state, p, i, stack.data[i], seam_masks[i], offs[i])
        # frontier: rows above every remaining tile's window are final
        if k + 1 < n:
            frontier = min(int(offs[j, 1]) for j in order[k + 1:])
            safe = ((frontier - halo) // m) * m
            if safe - done >= max(1024, 2 * halo):
                emit(safe)
    emit(dh)
    return fetch.assemble()


def blend_stack(stack: TileStack, seam_masks, blender_type, blend_strength,
                stream_fetch=False, budget=BLEND_BUDGET_BYTES):
    """Composite the stack into the panorama.

    seam_masks: (B, TH, TW) tensor (from `resize_seam_masks_stack`) or None
    (use the stack's warp masks). The blender kind comes from
    `_plan_blend`: "multiband", "feather" or the paste composite "no".

    Accumulators under `budget` bytes (the reference's estimate: C + 1
    float32 planes, with the coarser levels and the working copies) blend
    in one batched pass. Over it the canvas blends in strips along the
    axis the windows are narrow against, if they span at most a third of
    it; otherwise, with `stream_fetch`, as the streamed monolithic blend;
    otherwise in one batched pass all the same.

    With a mesh (a stack split over it) each rank feeds its block of
    tiles into full-size accumulators and one reduction per accumulator
    merges them (`_merge_state`); over the budget the strips spread over
    the ranks (`_blend_strips_mesh`). Every rank returns the panorama, as
    tensors: the streamed copies are single-rank.

    Returns (pano_u8 (dh, dw, C), mask_u8 (dh, dw)): tensors on the
    stack's device, or host arrays where `stream_fetch` streamed the
    copy; `fetch_image` copies a tensor to the host.
    """
    if seam_masks is None:
        seam_masks = stack.masks
    mesh = stack.mesh
    if mesh is not None:
        stream_fetch = False
    b = stack.batch
    C = stack.data.shape[-1]
    th, twd = int(stack.data.shape[1]), int(stack.data.shape[2])
    p = _plan_blend(stack.corners, stack.sizes, b, blender_type,
                    blend_strength, th, twd)
    ph, pw, m = p["ph"], p["pw"], p["m"]
    if _batched_bytes(ph, pw, C) > budget:
        # strip axis: whichever canvas axis the tile windows are narrow
        # against (wide panoramas -> X strips; tall multi-row canvases ->
        # Y strips)
        ratios = (p["ww"] / pw, p["wh"] / ph)
        a = int(np.argmin(ratios))
        if ratios[a] <= 1 / 3:
            # bytes per unit length of the strip axis (a full column of
            # accumulators for X strips, a full row for Y strips)
            per_unit = _batched_bytes(ph if a == 0 else pw, 1, C)
            strip_w = max(int(budget // (2 * per_unit))
                          - 2 * (p["ww"], p["wh"])[a], max(256, m))
            return _blend_strips(stack, seam_masks, p, (strip_w // m) * m,
                                 a, stream_fetch, mesh)
        if stream_fetch:
            return _blend_monolithic_stream(stack, seam_masks, p)
    # this rank's block of the stack (all of it without a mesh)
    lo = stack.lo
    idx = range(lo, min(lo + stack.data.shape[0], p["n"]))
    rows = [i - lo for i in idx]
    canvas, wmap = _blend_canvas(p, stack.data, seam_masks,
                                 p["offs"][list(idx)], idx, ph, pw, rows,
                                 mesh)
    dh, dw = p["dh"], p["dw"]
    return _to_u8(canvas[:dh, :dw]), _wmap_to_u8(wmap[:dh, :dw])


# ---------------------------------------------------------------------------
# Streamed composition: feed each image as it lands
# ---------------------------------------------------------------------------

class FinalPlan:
    """The FINAL pass of the async branch, planned once a stitch and read
    by the streaming decision, `final_tile`, `StreamComposite` and
    `warp_stack_streamed`.

    Built from the images' FINAL sizes and cameras, the surface, the
    prepared `cropper` (None without a crop) with its LOW -> FINAL
    `aspect`, the fed compensator, the LOW seam masks (`seam_masks_low`:
    masks on the card, LOW sizes), the blender and the originals'
    channels. It holds the warp ROIs (`corners`, `dsizes`) and their
    `tile` shape; the crop rects at FINAL and their `crop_shape` (`rects`,
    `crop`: None without a crop) and the cropped ROIs (`fin_corners`,
    `fin_sizes`); `gains` (`_gains`); `seams_low` and their `seam_sizes`;
    and `blend`, the blend plan of the cropped geometry."""

    def __init__(self, sizes, Ks, Rs, scale, warper_type, cropper, aspect,
                 compensator, seam_masks_low, blender_type, blend_strength,
                 channels):
        self.sizes = sizes = [tuple(map(int, s)) for s in sizes]
        self.Ks, self.Rs, self.scale = Ks, Rs, scale
        self.warper_type, self.channels = warper_type, channels
        self.corners, self.dsizes = plan_warp_rois(sizes, Ks, Rs, scale,
                                                   warper_type)
        self.tile = (_round_up(int(self.dsizes[:, 1].max())),
                     _round_up(int(self.dsizes[:, 0].max())))
        self.rects = self.crop = None
        self.fin_corners, self.fin_sizes = self.corners, self.dsizes
        if cropper is not None:
            self.rects, self.fin_corners, self.fin_sizes = crop_geometry(
                cropper, aspect, self.corners, self.dsizes)
            self.crop = crop_shape(self.rects, *self.tile)
        n = len(sizes)
        self.seams_low, low_sizes = seam_masks_low
        dev = self.seams_low.device
        self.gains = _gains(compensator, self.fin_sizes, n, channels, dev)
        self.seam_sizes = _seam_sizes(low_sizes, self.fin_sizes, n, dev)
        self.blend = _plan_blend(self.fin_corners, self.fin_sizes, n,
                                 blender_type, blend_strength,
                                 *(self.crop or self.tile)[:2])

    def warp(self, i, raw):
        """Image i's original warped into its ROI (`warp_single`)."""
        return warp_single(raw, self.sizes[i], self.Ks[i], self.Rs[i],
                           self.corners[i], self.dsizes[i], self.scale,
                           self.warper_type, *self.tile,
                           channels=self.channels)


def final_tile(plan: FinalPlan, i, raw):
    """Image i of the FINAL pass from its landed original `raw`, made as
    the batched stages make row i of theirs: warped, cropped to its rect,
    its gains applied, and its LOW seam mask resized against its warp
    mask. Returns the (1, TH, TW, C) tile and the (1, TH, TW) seam."""
    tile, mask = plan.warp(i, raw)
    if plan.crop is not None:
        tile, mask = slice_tiles(tile, mask, plan.rects[i:i + 1],
                                 *plan.crop)
    rows = slice(i, i + 1)
    return (plan.gains(tile, rows),
            _seam_resize_kernel(plan.seams_low[rows], plan.seam_sizes, rows,
                                mask))


class StreamComposite:
    """Feed-as-it-lands composition over a known canvas geometry.

    Built from a blend plan (`_plan_blend`, as `blend_stack` plans; the
    FINAL pass's is `FinalPlan.blend`), fed one (tile, seam) pair at a
    time through the batched blend's own per-image feeds, in place, and
    finished with one collapse. Fed in image order, it equals
    `blend_stack` value for value.

    frontier_fetch: once every unfed image's window lies right of a column
    frontier, the finished columns left of it collapse (`_collapse_band`,
    exact) and copy to the host while later images feed; a panorama of a
    rotating camera is near-sorted by x, so most of the copy hides behind
    the feeds. `finish` then returns host arrays.
    """

    def __init__(self, p, C=3, frontier_fetch=False, device="cuda"):
        self.p = p
        self.C = C
        self.device = torch.device(device)
        self.state = _new_state(p["kind"], p["nb"], p["ph"], p["pw"], C,
                                self.device)
        self._frontier = bool(frontier_fetch)
        self._unfed = set(range(p["n"]))
        self._emitted = 0
        self._fetch = _HostFetch(self.device, p["dh"], p["dw"], C)
        self._halo = _halo(p)

    def _emit_cols(self, upto):
        """Collapse and start the copy of final columns [emitted, upto)."""
        p = self.p
        c0, c1 = self._emitted, min(upto, p["dw"])
        if c1 <= c0:
            return
        seg, _ = _collapse_band(self.state, p["kind"], p["nb"], p["m"],
                                self._halo, p["pw"], p["dh"], c0, c1, axis=1,
                                mask=False)
        self._fetch.submit(1, c0, seg)
        self._emitted = c1

    def feed(self, i, tile, seam):
        """tile: (TH, TW, C) float32; seam: (TH, TW) float32, on the
        device."""
        p = self.p
        _feed_one(self.state, p, i, tile, seam, p["offs"][i])
        if self._frontier:
            self._unfed.discard(i)
            if self._unfed:
                frontier = min(p["offs"][j, 0] for j in self._unfed)
                safe = ((int(frontier) - self._halo) // p["m"]) * p["m"]
                # the reference's smallest band (tuned for its link): the
                # bands change when the copies run, not the result
                min_cols = max(512, 2 * self._halo,
                               6_000_000 // max(p["dh"] * self.C, 1))
                if safe - self._emitted >= min_cols:
                    self._emit_cols(safe)

    def finish(self, stream_fetch=False, mask=True):
        """Collapse and crop: (pano_u8, mask_u8).

        stream_fetch=True (or frontier_fetch): collapse in bands, each
        copied to the host while the next collapses, and return host
        arrays; otherwise one collapse returning tensors on the device.
        The bands carry the panorama alone. mask=False, the engine's call:
        (pano_u8, None), and no mask is made. The mask is kept for the
        callers that hold (pano, mask) against the JAX package's
        `StreamComposite.finish` (the parity tests); streamed, it is made
        once at the end, since no band changes it, and fetched in one
        copy."""
        p = self.p
        dh, dw, m = p["dh"], p["dw"], p["m"]
        if not (stream_fetch or self._frontier):
            pano, wmap = _finish_state(self.state, p["kind"], p["nb"])
            return (_to_u8(pano[:dh, :dw]),
                    _wmap_to_u8(wmap[:dh, :dw]) if mask else None)
        if self._frontier:
            # the remaining columns in a couple of tail bands, so the last
            # copy overlaps the second-to-last collapse
            rest = dw - self._emitted
            band = max(512, -(-(max(rest, 1) // 2) // m) * m)
            while self._emitted < dw:
                self._emit_cols(self._emitted + band)
        else:
            band = max(1024, -(-(dh // 4) // m) * m)
            for r0 in range(0, dh, band):
                seg, _ = _collapse_band(self.state, p["kind"], p["nb"], m,
                                        self._halo, p["ph"], dw, r0,
                                        min(r0 + band, dh), axis=0,
                                        mask=False)
                self._fetch.submit(0, r0, seg)
        pano, _ = self._fetch.assemble()
        if not mask:
            return pano, None
        wmap = _state_wmap(self.state, p["kind"])
        return pano, _wmap_to_u8(wmap[:dh, :dw]).cpu().numpy()


def fetch_image(img):
    """Device -> host copy of an image tensor (host arrays, such as a
    streamed blend's, pass through). The reference copies in 16 MB chunks,
    the best size on its tunnelled link; on the card one copy does."""
    if isinstance(img, np.ndarray):
        return img
    return img.cpu().numpy()
