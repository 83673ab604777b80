"""Seam finder component.

Port of `stitching_tpu/seam_finder.py`: the registry dp_color (default) /
dp_colorgrad / gc_color / gc_colorgrad / voronoi / no. `find_stack` runs
on the LOW tile stack on its device: "no" keeps the warp masks, dp_color
and dp_colorgrad run `ops/seam.dp_seams_stack`, gc_color and gc_colorgrad
`ops/seam.gc_seams_stack`, voronoi `ops/seam.voronoi_seams_stack`.

The step-by-step API takes and returns host arrays: `find` runs the list
forms (`dp_pairwise_seams`, `gc_pairwise_seams`, `voronoi_seams`) on the
finder's device; `resize` (dilate the LOW seam mask, resize it to the
FINAL mask's size, AND with that mask) and `blend_seam_masks` (a colour per
mask, pasted by `Blender.create_panorama`) run on the device they are
given; the drawing helpers (`draw_seam_mask`, `draw_seam_lines`,
`extract_seam_lines`, `draw_seam_polygons`) are host numpy, like
`viz.py`: they only make pictures for people.
"""

import warnings
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from .blender import Blender
from .errors import StitchingError, StitchingWarning
from .ops.resize import _axis_weights
from .ops.seam import (dp_pairwise_seams, dp_seams_stack, gc_pairwise_seams,
                       gc_seams_stack, voronoi_seams, voronoi_seams_stack)

SEAM_COLORS = (
    (255, 000, 000),  # Red
    (000, 000, 255),  # Blue
    (000, 255, 000),  # Green
    (000, 255, 255),  # Yellow
    (255, 000, 255),  # Purple
    (128, 128, 255),  # Pink
    (128, 128, 128),  # Gray
    (000, 000, 128),  # Dark Blue
    (000, 128, 255),  # Light Blue
)


class SeamFinder:
    SEAM_FINDER_CHOICES = OrderedDict(
        dp_color=("dp", False),
        dp_colorgrad=("dp", True),
        gc_color=("gc", False),
        gc_colorgrad=("gc", True),
        voronoi=("voronoi", None),
        no=("no", None),
    )
    DEFAULT_SEAM_FINDER = list(SEAM_FINDER_CHOICES.keys())[0]

    def __init__(self, finder=DEFAULT_SEAM_FINDER, device="cuda"):
        if finder not in self.SEAM_FINDER_CHOICES:
            raise StitchingError("invalid seam finder: " + str(finder))
        self.finder_name = finder
        self.kind, self.use_grad = self.SEAM_FINDER_CHOICES[finder]
        self.device = torch.device(device)

    def find(self, imgs, corners, masks):
        """Seam masks (host uint8 {0, 255}) of warped LOW images."""
        imgs = [np.asarray(img).astype(np.float32) for img in imgs]
        masks = [np.asarray(m) for m in masks]
        if self.kind == "no":
            return [m.copy() for m in masks]
        if self.kind == "voronoi":
            return voronoi_seams(corners, masks, self.device)
        seams = dp_pairwise_seams if self.kind == "dp" else gc_pairwise_seams
        return seams(imgs, corners, masks, self.use_grad, self.device)

    def find_stack(self, stack):
        """Seam masks over a `compose.TileStack`: a (B, TH, TW) float32
        {0, 255} tensor on the stack's device."""
        if self.kind == "no":
            return stack.masks
        if self.kind in ("dp", "gc"):
            seams = dp_seams_stack if self.kind == "dp" else gc_seams_stack
            return seams(stack.data, stack.masks, stack.corners,
                         stack.sizes, self.use_grad)
        return voronoi_seams_stack(stack.masks, stack.corners, stack.sizes)

    @staticmethod
    def resize(seam_mask, mask, device="cuda"):
        """The LOW seam mask dilated by 3 x 3, resized bilinearly to the
        FINAL `mask`'s size and kept where `mask` is set; uint8."""
        dilated = _dilate3(torch.as_tensor(np.asarray(seam_mask),
                                           device=device))
        resized = _resize_u8(dilated, (mask.shape[1], mask.shape[0]))
        keep = torch.as_tensor(np.asarray(mask), device=device) > 0
        return torch.where(keep, resized, 0).cpu().numpy()

    @staticmethod
    def draw_seam_mask(img, seam_mask, color=(0, 0, 0)):
        seam_mask = np.asarray(seam_mask)
        overlaid_img = np.copy(img)
        overlaid_img[seam_mask == 0] = color
        return overlaid_img

    @staticmethod
    def draw_seam_polygons(panorama, blended_seam_masks, alpha=0.5):
        return add_weighted_image(panorama, blended_seam_masks, alpha)

    @staticmethod
    def draw_seam_lines(panorama, blended_seam_masks, linesize=1,
                        color=(0, 0, 255)):
        seam_lines = SeamFinder.extract_seam_lines(
            blended_seam_masks, linesize)
        out = panorama.copy()
        out[seam_lines == 255] = color
        return out

    @staticmethod
    def extract_seam_lines(blended_seam_masks, linesize=1):
        """The colour regions' boundaries (neighbour-difference edges),
        without the pixels that touch the black (invalid) region."""
        m = np.asarray(blended_seam_masks).astype(np.int32)
        diff = np.zeros(m.shape[:2], bool)
        diff[:, 1:] |= (m[:, 1:] != m[:, :-1]).any(-1)
        diff[1:, :] |= (m[1:, :] != m[:-1, :]).any(-1)
        lines = (diff * 255).astype(np.uint8)
        black = (m == 0).all(-1)
        near_black = black.copy()
        near_black[1:, :] |= black[:-1, :]
        near_black[:-1, :] |= black[1:, :]
        near_black[:, 1:] |= black[:, :-1]
        near_black[:, :-1] |= black[:, 1:]
        lines[near_black] = 0
        for _ in range(linesize - 1):
            lines = _dilate3(torch.from_numpy(lines)).numpy()
        return lines

    @staticmethod
    def blend_seam_masks(seam_masks, corners, sizes, colors=SEAM_COLORS,
                         device="cuda"):
        """Each seam mask filled with a colour and pasted at its corner.
        The coloured images take each seam mask's own shape: a FINAL size
        planned from a rounded crop rect can be a pixel larger than the
        cropped mask, where the reference raises instead."""
        shapes = [(m.shape[1], m.shape[0]) for m in seam_masks]
        imgs = colored_img_generator(shapes, colors)
        blended_seam_masks, _ = Blender.create_panorama(
            imgs, seam_masks, corners, sizes, device=device)
        return blended_seam_masks


def _dilate3(mask):
    """3 x 3 full-kernel dilation (cv.dilate(mask, None)) of a 2-D tensor.
    max_pool2d pads with -inf where the reference pads with 0: every window
    holds a real mask value >= 0, so the maxima agree."""
    return F.max_pool2d(mask[None, None].to(torch.float32), 3, stride=1,
                        padding=1)[0, 0].to(mask.dtype)


def _resize_u8(img, size_wh):
    """`ops/resize.resize` of a 2-D uint8 tensor on its device: the same
    float32 lerps in the same order, rounded half to even."""
    out_w, out_h = int(size_wh[0]), int(size_wh[1])
    if (img.shape[1], img.shape[0]) == (out_w, out_h):
        return img
    dev = img.device
    src = img.to(torch.float32)
    y0, y1, wy = (torch.as_tensor(a, device=dev)
                  for a in _axis_weights(img.shape[0], out_h))
    x0, x1, wx = (torch.as_tensor(a, device=dev)
                  for a in _axis_weights(img.shape[1], out_w))
    wy = wy[:, None]
    rows = src[y0] * (1 - wy) + src[y1] * wy
    out = rows[:, x0] * (1 - wx) + rows[:, x1] * wx
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def colored_img_generator(sizes, colors):
    if len(sizes) + 1 > len(colors):
        warnings.warn(
            "Without additional colors, there will be seam masks with identical colors",  # noqa: E501
            StitchingWarning,
        )
    for idx, size in enumerate(sizes):
        yield create_img_by_size(size, colors[idx % len(colors)])


def create_img_by_size(size, color=(0, 0, 0)):
    width, height = size
    img = np.zeros((height, width, 3), np.uint8)
    img[:] = color
    return img


def add_weighted_image(img1, img2, alpha):
    out = (np.asarray(img1, np.float32) * alpha
           + np.asarray(img2, np.float32) * (1.0 - alpha))
    return np.clip(np.round(out), 0, 255).astype(np.uint8)
