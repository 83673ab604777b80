"""Blender component.

Port of `stitching_tpu/blender.py`'s settings surface: choices multiband
(default) / feather / no, and `blend_strength`. The batched engine
composites through `compose.blend_stack`, which resolves the kind per
canvas (`blend_width = sqrt(canvas area) * strength / 100`; below 1 the
paste composite, the reference rule).
"""

from .errors import StitchingError


class Blender:
    BLENDER_CHOICES = ("multiband", "feather", "no")
    DEFAULT_BLENDER = "multiband"
    DEFAULT_BLEND_STRENGTH = 5

    def __init__(self, blender_type=DEFAULT_BLENDER,
                 blend_strength=DEFAULT_BLEND_STRENGTH):
        if blender_type not in self.BLENDER_CHOICES:
            raise StitchingError(
                "invalid blender type: " + str(blender_type))
        self.blender_type = blender_type
        self.blend_strength = blend_strength
