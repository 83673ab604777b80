"""Warper component: project images, masks and ROIs onto a surface.

Port of `stitching_tpu/warper.py`: the 16-surface registry, canvas scale =
median camera focal, and the `get_K` aspect correction for warping at a
resolution different from the registration one. The engine warps whole
stacks in `compose.warp_stack`; the per-image methods here (the
step-by-step API and verbose mode) warp one image at a time on the
warper's device through `ops/warp.warp_image`: images bilinear with a
reflect border, masks nearest with a constant border, as the reference's
warp flags. They take and return numpy arrays.
"""

from statistics import median

import numpy as np
import torch

from .errors import StitchingError
from .ops import warp as warp_ops

# (interp, border) per payload kind, the reference's warp flag pairs
_PAYLOAD_MODES = {
    "image": ("linear", "reflect"),
    "mask": ("nearest", "constant"),
}


class Warper:
    WARP_TYPE_CHOICES = warp_ops.WARP_TYPES
    DEFAULT_WARP_TYPE = "spherical"

    def __init__(self, warper_type=DEFAULT_WARP_TYPE, device="cuda"):
        if warper_type not in self.WARP_TYPE_CHOICES:
            raise StitchingError("invalid warper type: " + str(warper_type))
        self.warper_type = warper_type
        self.device = torch.device(device)
        self.scale = None

    def set_scale(self, cameras):
        """Canvas scale = median focal over the cameras."""
        self.scale = median(cam.focal for cam in cameras)

    # -- single-payload warps ------------------------------------------------

    def _warp(self, payload, camera, aspect, kind):
        interp, border = _PAYLOAD_MODES[kind]
        _, warped = warp_ops.warp_image(
            payload, self.get_K(camera, aspect), camera.R,
            self.scale * aspect, self.warper_type, interp=interp,
            border=border, device=self.device)
        return warped

    def warp_image(self, img, camera, aspect=1):
        return self._warp(img, camera, aspect, "image")

    def create_and_warp_mask(self, size, camera, aspect=1):
        full = np.full((size[1], size[0]), 255, np.uint8)
        return self._warp(full, camera, aspect, "mask")

    def warp_roi(self, size, camera, aspect=1):
        return warp_ops.warp_roi(
            size, self.get_K(camera, aspect), camera.R,
            self.scale * aspect, self.warper_type)

    # -- list conveniences ----------------------------------------------------

    def warp_images(self, imgs, cameras, aspect=1):
        return (self.warp_image(img, cam, aspect)
                for img, cam in zip(imgs, cameras))

    def create_and_warp_masks(self, sizes, cameras, aspect=1):
        return (self.create_and_warp_mask(size, cam, aspect)
                for size, cam in zip(sizes, cameras))

    def warp_rois(self, sizes, cameras, aspect=1):
        rois = [self.warp_roi(size, cam, aspect)
                for size, cam in zip(sizes, cameras)]
        return [r[0] for r in rois], [r[1] for r in rois]

    @staticmethod
    def get_K(camera, aspect=1):
        """Intrinsics rescaled for warping at `aspect` times the
        registration resolution."""
        K = camera.K().astype(np.float32)
        K[:2] *= np.float32(aspect)
        K[2, 2] = 1.0
        return K
