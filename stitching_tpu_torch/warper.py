"""Warper component: surface choice, canvas scale and intrinsics.

Port of `stitching_tpu/warper.py`'s engine surface: the 16-surface
registry, canvas scale = median camera focal, and the `get_K` aspect
correction for warping at a resolution different from the registration
one. The warp itself runs batched in `compose.warp_stack`, on every
surface of `ops/warp.WARP_TYPES` (the 15 rotation surfaces and "affine").
"""

from statistics import median

import numpy as np

from .errors import StitchingError
from .ops import warp as warp_ops


class Warper:
    WARP_TYPE_CHOICES = warp_ops.WARP_TYPES
    DEFAULT_WARP_TYPE = "spherical"

    def __init__(self, warper_type=DEFAULT_WARP_TYPE):
        if warper_type not in self.WARP_TYPE_CHOICES:
            raise StitchingError("invalid warper type: " + str(warper_type))
        self.warper_type = warper_type
        self.scale = None

    def set_scale(self, cameras):
        """Canvas scale = median focal over the cameras."""
        self.scale = median(cam.focal for cam in cameras)

    def warp_roi(self, size, camera, aspect=1):
        return warp_ops.warp_roi(
            size, self.get_K(camera, aspect), camera.R,
            self.scale * aspect, self.warper_type)

    @staticmethod
    def get_K(camera, aspect=1):
        """Intrinsics rescaled for warping at `aspect` times the
        registration resolution."""
        K = camera.K().astype(np.float32)
        K[:2] *= np.float32(aspect)
        K[2, 2] = 1.0
        return K
