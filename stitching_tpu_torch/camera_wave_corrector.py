"""Wave correction component.

Port of `stitching_tpu/camera_wave_corrector.py`'s settings surface: choices
horiz (default) / vert / auto / no. This slice implements "no", which
returns the cameras unchanged; the others raise `NotImplementedError`
(ROADMAP queue 1: wave correction).
"""

from collections import OrderedDict

from .errors import StitchingError


class WaveCorrector:
    WAVE_CORRECT_CHOICES = OrderedDict(
        horiz="horiz", vert="vert", auto="auto", no=None,
    )
    DEFAULT_WAVE_CORRECTION = list(WAVE_CORRECT_CHOICES.keys())[0]

    def __init__(self, wave_correct_kind=DEFAULT_WAVE_CORRECTION):
        if wave_correct_kind not in self.WAVE_CORRECT_CHOICES:
            raise StitchingError(
                "invalid wave correction kind: " + str(wave_correct_kind))
        if wave_correct_kind != "no":
            raise NotImplementedError(
                f"wave_correct_kind={wave_correct_kind!r} is not ported yet "
                "(ROADMAP queue 1: wave correction)")
        self.wave_correct_kind = self.WAVE_CORRECT_CHOICES[wave_correct_kind]

    def correct(self, cameras):
        return cameras
