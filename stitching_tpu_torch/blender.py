"""Blender component.

Port of `stitching_tpu/blender.py`'s settings surface: choices multiband
(default) / feather / no, and `blend_strength`. This slice implements "no"
(the paste composite of `compose.blend_stack`); the others raise
`NotImplementedError` (ROADMAP queue 1: multiband).
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
        if blender_type != "no":
            raise NotImplementedError(
                f"blender_type={blender_type!r} is not ported yet (ROADMAP "
                "queue 1: multiband)")
        self.blender_type = blender_type
        self.blend_strength = blend_strength
