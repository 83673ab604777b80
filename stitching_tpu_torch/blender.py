"""Blender component.

Port of `stitching_tpu/blender.py`: choices multiband (default) / feather /
no and `blend_strength`; `blend_width = sqrt(canvas area) * strength /
100`, multiband `num_bands = int(log2(blend_width) - 1)`, feather
`sharpness = 1 / blend_width`, the paste composite below a width of 1.
The engine composites through `compose.blend_stack`, which resolves the
kind per canvas by the same rule. The step-by-step API (`prepare`, `feed`,
`blend`, `create_panorama`) runs the backends of `ops/blend.py` on the
blender's device: host images in, host (panorama, mask) out, the
accumulators on the device between calls.
"""

import numpy as np
import torch

from .errors import StitchingError
from .ops.blend import FeatherBlender, MultiBandBlender, NoBlender


def resolve_backend(blender_type, blend_width, device="cuda"):
    """Pick and parameterize the feed/blend backend for one canvas."""
    if blender_type == "no" or blend_width < 1:
        return NoBlender(device)
    if blender_type == "multiband":
        bands = int((np.log(blend_width) / np.log(2.0) - 1.0))
        return MultiBandBlender(bands, device)
    return FeatherBlender(1.0 / blend_width, device)


class Blender:
    BLENDER_CHOICES = ("multiband", "feather", "no")
    DEFAULT_BLENDER = "multiband"
    DEFAULT_BLEND_STRENGTH = 5

    def __init__(self, blender_type=DEFAULT_BLENDER,
                 blend_strength=DEFAULT_BLEND_STRENGTH, device="cuda"):
        if blender_type not in self.BLENDER_CHOICES:
            raise StitchingError(
                "invalid blender type: " + str(blender_type))
        self.blender_type = blender_type
        self.blend_strength = blend_strength
        self.device = torch.device(device)
        self.blender = None

    def prepare(self, corners, sizes):
        x0 = min(c[0] for c in corners)
        y0 = min(c[1] for c in corners)
        dst_w = max(c[0] + s[0] for c, s in zip(corners, sizes)) - x0
        dst_h = max(c[1] + s[1] for c, s in zip(corners, sizes)) - y0
        blend_width = np.sqrt(dst_w * dst_h) * self.blend_strength / 100
        self.blender = resolve_backend(self.blender_type, blend_width,
                                       self.device)
        self.blender.prepare(corners, sizes)

    def feed(self, img, mask, corner):
        self.blender.feed(np.asarray(img).astype(np.int16), mask, corner)

    def blend(self):
        return self.blender.blend()

    @classmethod
    def create_panorama(cls, imgs, masks, corners, sizes, device="cuda"):
        """The paste composite on `device` (the panorama mask the cropper
        estimates, the seam visualisation)."""
        composite = cls("no", device=device)
        composite.prepare(corners, sizes)
        for img, mask, corner in zip(imgs, masks, corners):
            composite.feed(img, mask, corner)
        return composite.blend()
