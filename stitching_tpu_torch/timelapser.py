"""Timelapser component.

Port of `stitching_tpu/timelapser.py` (the reference's
`stitching/timelapser.py`): choices no (default) / as_is / crop;
`initialize(corners, sizes)` fixes the union canvas; each frame is the
warped image placed at its corner on that canvas, written as
`<prefix><name>` beside the input (prefix default "fixed_") through
`io.write_image`. Placement clips to the canvas, so the crop variant's
negative-corner parts are cut; as_is corners lie inside it already.
"""

import os

import numpy as np

from . import io as _io
from .errors import StitchingError
from .ops.blend import result_roi


class Timelapser:
    TIMELAPSE_CHOICES = ("no", "as_is", "crop")
    DEFAULT_TIMELAPSE = "no"
    DEFAULT_TIMELAPSE_PREFIX = "fixed_"

    def __init__(self, timelapse=DEFAULT_TIMELAPSE,
                 timelapse_prefix=DEFAULT_TIMELAPSE_PREFIX):
        if timelapse not in self.TIMELAPSE_CHOICES:
            raise StitchingError("invalid timelapse type: " + str(timelapse))
        self.timelapse_type = timelapse
        self.timelapse_prefix = timelapse_prefix
        self.do_timelapse = timelapse != "no"
        self.dst = None

    def initialize(self, corners, sizes):
        self.tl, (w, h) = result_roi(corners, sizes)
        self.dst_size = (w, h)

    def process_and_save_frame(self, img_name, img, corner):
        self.process_frame(img, corner)
        _io.write_image(self.get_fixed_filename(img_name), self.get_frame())

    def process_frame(self, img, corner):
        img = np.asarray(img)
        w, h = self.dst_size
        frame = np.zeros((h, w, 3), np.int16)
        x = corner[0] - self.tl[0]
        y = corner[1] - self.tl[1]
        ih, iw = img.shape[:2]
        sx0, sy0 = max(0, -x), max(0, -y)
        dx0, dy0 = max(0, x), max(0, y)
        cw = min(iw - sx0, w - dx0)
        ch = min(ih - sy0, h - dy0)
        if cw > 0 and ch > 0:
            frame[dy0:dy0 + ch, dx0:dx0 + cw] = (
                img[sy0:sy0 + ch, sx0:sx0 + cw].astype(np.int16))
        self.dst = frame

    def get_frame(self):
        return np.clip(np.abs(self.dst), 0, 255).astype(np.uint8)

    def get_fixed_filename(self, img_name):
        dirname, filename = os.path.split(img_name)
        return os.path.join(dirname, self.timelapse_prefix + filename)
