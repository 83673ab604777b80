"""Megapixel-target resize scales.

The scale math is an exact behavioral contract of the reference
(`stitching/megapix_scaler.py`, constants pinned by its
tests/test_megapix_scaler.py): ``scale = sqrt(megapix * 1e6 / (w * h))``
for positive targets, 1.0 otherwise; scaled sizes round to nearest int.
Implemented here as one class with a clamp switch; `MegapixDownscaler`
(scale capped at 1.0, used for all pipeline resolutions) is the clamped
instance.
"""

import math


def scale_for(megapix, resolution):
    """Resize factor hitting `megapix` for an image of `resolution` px."""
    return math.sqrt(megapix * 1e6 / resolution) if megapix > 0 else 1.0


class MegapixScaler:
    _clamp = False

    def __init__(self, megapix: float):
        self.megapix = megapix
        self.is_scale_set = False
        self.scale = None

    def get_scale_by_resolution(self, resolution):
        return scale_for(self.megapix, resolution)

    def set_scale_by_img_size(self, img_size):
        """img_size is (width, height)."""
        self.set_scale(scale_for(self.megapix, img_size[0] * img_size[1]))

    def set_scale(self, scale):
        self.scale = min(1.0, scale) if self._clamp else scale
        self.is_scale_set = True

    def get_scaled_img_size(self, img_size):
        return (int(round(img_size[0] * self.scale)),
                int(round(img_size[1] * self.scale)))


class MegapixDownscaler(MegapixScaler):
    """Never upscales (scale clamped to 1.0)."""

    _clamp = True

    @staticmethod
    def force_downscale(scale):
        return min(1.0, scale)
