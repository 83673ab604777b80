"""Timelapser component.

Port of `stitching_tpu/timelapser.py`'s settings surface: choices no
(default) / as_is / crop, and the file prefix. This slice implements "no";
the others raise `NotImplementedError` (ROADMAP queue 1: timelapse).
"""

from .errors import StitchingError


class Timelapser:
    TIMELAPSE_CHOICES = ("no", "as_is", "crop")
    DEFAULT_TIMELAPSE = "no"
    DEFAULT_TIMELAPSE_PREFIX = "fixed_"

    def __init__(self, timelapse=DEFAULT_TIMELAPSE,
                 timelapse_prefix=DEFAULT_TIMELAPSE_PREFIX):
        if timelapse not in self.TIMELAPSE_CHOICES:
            raise StitchingError("invalid timelapse type: " + str(timelapse))
        if timelapse != "no":
            raise NotImplementedError(
                f"timelapse={timelapse!r} is not ported yet (ROADMAP queue 1: "
                "timelapse)")
        self.timelapse_type = timelapse
        self.timelapse_prefix = timelapse_prefix
        self.do_timelapse = False
