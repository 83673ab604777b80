"""Exposure error compensation component.

Port of `stitching_tpu/exposure_error_compensator.py`: choices gain_blocks
(default) / gain / channel / channel_blocks / no, with `nr_feeds` and
`block_size`. `feed_stack` estimates on the LOW-resolution tile stack;
`compose.apply_gains_stack` compensates the FINAL-resolution one from the
state it leaves: one gain per image (gain) or per image and channel
(channel), or a gain map per image (the blocks variants). Each pair of
kinds shares one code path with a `per_channel` flag (`ops/exposure.py`).
"""

from collections import OrderedDict

import numpy as np

from .errors import StitchingError
from .ops.exposure import (compute_block_gains_stack,
                           compute_scalar_gains_stack, smooth_gain_map)


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
        self.compensator = compensator
        self.nr_feeds = nr_feeds
        self.block_size = block_size
        self._gains = None
        self._block_state = None

    def feed_stack(self, corners, stack):
        """Estimate the gains from a `compose.TileStack`: the masked sums
        run on the stack's device, only the tiny normal systems come to
        the host."""
        if self.compensator == "no":
            return
        per_channel = self.compensator in ("channel", "channel_blocks")
        sizes = np.asarray(stack.sizes)
        n = len(sizes)
        if self.compensator in ("gain", "channel"):
            self._gains = compute_scalar_gains_stack(
                stack.data, stack.masks, corners[:n], sizes, per_channel,
                nr_feeds=self.nr_feeds)
            return
        origin, bs, gains, present = compute_block_gains_stack(
            stack.data, stack.masks, corners[:n], sizes, self.block_size,
            per_channel)
        smoothed = [smooth_gain_map(gains[i], present[i]) for i in range(n)]
        self._block_state = (origin, bs, smoothed)
        # LOW-resolution corners and sizes map FINAL applies by ratio
        self._feed_corners = list(corners[:n])
        self._feed_sizes = [tuple(s) for s in sizes]
