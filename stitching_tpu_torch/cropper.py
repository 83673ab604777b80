"""Auto-crop: remove the invalid border the warp creates.

Port of `stitching_tpu/cropper.py`: require exactly one simply-connected
foreground region in the panorama mask (else the "Invalid Contour" error
with the --no-crop hint), find the largest interior rectangle
(`ops/lir.py`), zero-center the corners, clip every image's warped rect
against the LIR ("Rectangles do not overlap!" on disjoint rects), and give
the per-image crops at a resolution aspect.

Rect algebra lives in module functions over a minimal `Rectangle` value
type, on the host. The engine calls `prepare_from_mask` with the panorama
mask it composited on the device and applies the rects with
`compose.slice_stack`; the single-region test (a region count on the
card for a mask there, a host flood fill for one on the host) and the
LIR search are timed as the stages `low/crop/flood_fill` and
`low/crop/lir`. The step-by-step API plans
from host lists: `prepare` composites the panorama mask on the
cropper's device (`estimate_panorama_mask`, `Blender.create_panorama`),
`crop_images` / `crop_img` slice host arrays, `Rectangle.draw_on` draws
the LIR, and the reference's static aliases (`get_zero_center_corners`,
`get_rectangles`, `get_overlap`, `get_intersection`) remain.
"""

from collections import namedtuple

import numpy as np
import torch

from . import profiling as prof
from .errors import StitchingError
from .ops.kernels.components import count_components
from .ops.lir import largest_interior_rectangle

_INVALID_CONTOUR = (
    "Invalid Contour. Run with --no-crop (using the stitch interface), "
    "crop=false (using the stitcher class) or Cropper(False) "
    "(using the cropper class)"
)


class Rectangle(namedtuple("Rectangle", "x y width height")):
    __slots__ = ()

    @property
    def area(self):
        return self.width * self.height

    @property
    def corner(self):
        return (self.x, self.y)

    @property
    def size(self):
        return (self.width, self.height)

    @property
    def x2(self):
        return self.x + self.width

    @property
    def y2(self):
        return self.y + self.height

    def times(self, x):
        return Rectangle(*(int(round(i * x)) for i in self))

    def draw_on(self, img, color=(0, 0, 255), size=1):
        """The rectangle's outline drawn on `img` (a gray image becomes
        BGR); `size` is accepted for the reference's signature."""
        from .viz import draw_line

        if len(img.shape) == 2:
            img = np.repeat(img[..., None], 3, -1).astype(np.uint8)
        p = [(self.x, self.y), (self.x2 - 1, self.y),
             (self.x2 - 1, self.y2 - 1), (self.x, self.y2 - 1)]
        for a, b in zip(p, p[1:] + p[:1]):
            draw_line(img, a, b, color)
        return img


# ---------------------------------------------------------------------------
# Rect algebra
# ---------------------------------------------------------------------------

def clip_rect(rect, bound):
    """rect ∩ bound in shared coords; error when they don't meet."""
    x1 = max(rect.x, bound.x)
    y1 = max(rect.y, bound.y)
    x2 = min(rect.x2, bound.x2)
    y2 = min(rect.y2, bound.y2)
    if x2 < x1 or y2 < y1:
        raise StitchingError("Rectangles do not overlap!")
    return Rectangle(x1, y1, x2 - x1, y2 - y1)


def to_local(rect, outer):
    """Express `rect` (global coords) relative to its image's rect."""
    return Rectangle(abs(rect.x - outer.x), abs(rect.y - outer.y),
                     rect.width, rect.height)


def zero_center(corners):
    ox = min(c[0] for c in corners)
    oy = min(c[1] for c in corners)
    return [(x - ox, y - oy) for x, y in corners]


def single_region(mask):
    """The flood-filled foreground region iff the mask is one
    simply-connected blob; None otherwise (the reference asserts exactly
    one outer contour, cropper.py:95-99).

    A mask on the card stays there: its 4-connected regions are counted
    there (`count_components`), and a count of 1 gives `mask > 0` on the
    card. A host array or CPU tensor is flood filled on the host: the
    region grows by one dilation a round until a round adds nothing, and
    the call's rounds go to the `crop/flood_rounds` counter."""
    if isinstance(mask, torch.Tensor) and mask.is_cuda:
        fg = mask if mask.dtype in (torch.uint8, torch.bool) else mask > 0
        n = int(count_components(fg.contiguous()).item())
        return mask > 0 if n == 1 else None
    m = np.asarray(mask) > 0
    if not m.any():
        return None
    region = np.zeros_like(m)
    seed = np.argwhere(m)[0]
    region[seed[0], seed[1]] = True
    count = 0
    rounds = 0
    while True:
        rounds += 1
        grown = region.copy()
        grown[1:, :] |= region[:-1, :]
        grown[:-1, :] |= region[1:, :]
        grown[:, 1:] |= region[:, :-1]
        grown[:, :-1] |= region[:, 1:]
        region = grown & m
        c = int(region.sum())
        if c == count:
            break
        count = c
    prof.count("crop/flood_rounds", rounds)
    return region if bool((region == m).all()) else None


# ---------------------------------------------------------------------------
# Component
# ---------------------------------------------------------------------------

class Cropper:
    DEFAULT_CROP = True

    def __init__(self, crop=DEFAULT_CROP, device="cuda"):
        self.do_crop = crop
        self.device = torch.device(device)
        self.overlapping_rectangles = []
        self.intersection_rectangles = []

    # -- planning ------------------------------------------------------------

    def prepare(self, imgs, masks, corners, sizes):
        """Plan the crop rects from host warps and their masks."""
        if self.do_crop:
            mask = self.estimate_panorama_mask(imgs, masks, corners, sizes,
                                               device=self.device)
            self.prepare_from_mask(mask, corners, sizes)

    def prepare_from_mask(self, mask, corners, sizes):
        """Plan crop rects from the composited panorama mask (a tensor on
        any device, or a host array)."""
        if not self.do_crop:
            return
        self.lir = self.estimate_largest_interior_rectangle(mask)
        corners = zero_center(corners)
        img_rects = [Rectangle(*c, *s) for c, s in zip(corners, sizes)]
        self.overlapping_rectangles = [
            clip_rect(r, self.lir) for r in img_rects]
        self.intersection_rectangles = [
            to_local(clipped, outer) for clipped, outer in
            zip(self.overlapping_rectangles, img_rects)]

    @staticmethod
    def estimate_panorama_mask(imgs, masks, corners, sizes, device="cuda"):
        """The paste composite's mask (host uint8) on `device`."""
        from .blender import Blender

        return Blender.create_panorama(imgs, masks, corners, sizes,
                                       device=device)[1]

    def estimate_largest_interior_rectangle(self, mask):
        mask = torch.as_tensor(mask)
        with prof.stage_timer("low/crop/flood_fill"):
            region = single_region(mask if mask.is_cuda
                                   else mask.cpu().numpy())
        if region is None:
            raise StitchingError(_INVALID_CONTOUR)
        with prof.stage_timer("low/crop/lir"):
            x, y, w, h = largest_interior_rectangle(mask > 0).tolist()
        return Rectangle(int(x), int(y), int(w), int(h))

    # -- application ---------------------------------------------------------

    def crop_images(self, imgs, aspect=1):
        for idx, img in enumerate(imgs):
            yield self.crop_img(img, idx, aspect)

    def crop_img(self, img, idx, aspect=1):
        if not self.do_crop:
            return img
        r = self.intersection_rectangles[idx].times(aspect)
        return img[r.y: r.y2, r.x: r.x2]

    def crop_rois(self, corners, sizes, aspect=1):
        if not self.do_crop:
            return corners, sizes
        scaled = [r.times(aspect) for r in self.overlapping_rectangles]
        return (zero_center([r.corner for r in scaled]),
                [r.size for r in scaled])

    # -- the reference's static aliases ---------------------------------------

    get_zero_center_corners = staticmethod(zero_center)

    @staticmethod
    def get_rectangles(corners, sizes):
        return [Rectangle(*c, *s) for c, s in zip(corners, sizes)]

    @staticmethod
    def get_overlap(rectangle1, rectangle2):
        return clip_rect(rectangle1, rectangle2)

    @staticmethod
    def get_intersection(rectangle, overlapping_rectangle):
        return to_local(overlapping_rectangle, rectangle)
