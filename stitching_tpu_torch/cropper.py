"""Auto-crop component.

Port of `stitching_tpu/cropper.py`'s settings surface: `crop` True
(default) / False. This slice implements crop=False, under which nothing
is cropped; crop=True raises `NotImplementedError` (ROADMAP queue 1: crop
and LIR).
"""


class Cropper:
    DEFAULT_CROP = True

    def __init__(self, crop=DEFAULT_CROP):
        if crop:
            raise NotImplementedError(
                "crop=True is not ported yet (ROADMAP queue 1: crop and LIR)")
        self.do_crop = False
        self.intersection_rectangles = None
