"""Wave correction component.

Port of `stitching_tpu/camera_wave_corrector.py`: choices horiz (default) /
vert / auto / no; operates on copies of the camera R matrices. The math
lives in `ops/wave.py` (host numpy), the cv.detail.waveCorrect analog.
"""

from collections import OrderedDict

import numpy as np

from .errors import StitchingError
from .ops.wave import wave_correct


class WaveCorrector:
    WAVE_CORRECT_CHOICES = OrderedDict(
        horiz="horiz", vert="vert", auto="auto", no=None,
    )
    DEFAULT_WAVE_CORRECTION = list(WAVE_CORRECT_CHOICES.keys())[0]

    def __init__(self, wave_correct_kind=DEFAULT_WAVE_CORRECTION):
        if wave_correct_kind not in self.WAVE_CORRECT_CHOICES:
            raise StitchingError(
                "invalid wave correction kind: " + str(wave_correct_kind))
        self.wave_correct_kind = self.WAVE_CORRECT_CHOICES[wave_correct_kind]

    def correct(self, cameras):
        if self.wave_correct_kind is None:
            return cameras
        rmats = np.stack([np.copy(cam.R) for cam in cameras]).astype(
            np.float32)
        corrected = wave_correct(rmats, self.wave_correct_kind)
        for idx, cam in enumerate(cameras):
            cam.R = corrected[idx]
        return cameras
