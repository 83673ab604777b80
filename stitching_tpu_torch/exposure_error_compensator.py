"""Exposure error compensation component.

Port of `stitching_tpu/exposure_error_compensator.py`'s settings surface:
choices gain_blocks (default) / gain / channel / channel_blocks / no, with
`nr_feeds` and `block_size`. This slice implements "no", which leaves the
tiles unchanged; the others raise `NotImplementedError` (ROADMAP queue 1:
exposure).
"""

from collections import OrderedDict

from .errors import StitchingError


class ExposureErrorCompensator:
    COMPENSATOR_CHOICES = OrderedDict(
        gain_blocks="gain_blocks",
        gain="gain",
        channel="channel",
        channel_blocks="channel_blocks",
        no="no",
    )

    DEFAULT_COMPENSATOR = list(COMPENSATOR_CHOICES.keys())[0]
    DEFAULT_NR_FEEDS = 1
    DEFAULT_BLOCK_SIZE = 32

    def __init__(self, compensator=DEFAULT_COMPENSATOR,
                 nr_feeds=DEFAULT_NR_FEEDS, block_size=DEFAULT_BLOCK_SIZE):
        if compensator not in self.COMPENSATOR_CHOICES:
            raise StitchingError(
                "invalid compensator: " + str(compensator))
        if compensator != "no":
            raise NotImplementedError(
                f"compensator={compensator!r} is not ported yet (ROADMAP "
                "queue 1: exposure)")
        self.compensator = compensator
        self.nr_feeds = nr_feeds
        self.block_size = block_size

    def feed_stack(self, corners, stack):
        return

    def apply_stack(self, stack):
        return stack
