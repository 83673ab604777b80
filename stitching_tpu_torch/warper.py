"""Warper component: surface choice, canvas scale and intrinsics.

Port of `stitching_tpu/warper.py`'s engine surface: the 16-surface
registry, canvas scale = median camera focal, and the `get_K` aspect
correction for warping at a resolution different from the registration
one. The warp itself runs batched in `compose.warp_stack`. This slice
implements the spherical surface; the others raise `NotImplementedError`.
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
        if warper_type != "spherical":
            raise NotImplementedError(
                f"warper_type={warper_type!r} is not ported yet (ROADMAP "
                "queue 1: other settings)")
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
