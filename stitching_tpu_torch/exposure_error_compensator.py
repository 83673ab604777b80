"""Exposure error compensation component.

Port of `stitching_tpu/exposure_error_compensator.py`: choices gain_blocks
(default) / gain / channel / channel_blocks / no, with `nr_feeds` and
`block_size`. `feed_stack` estimates on the LOW-resolution tile stack;
`compose.apply_gains_stack` compensates the FINAL-resolution one from the
state it leaves: one gain per image (gain) or per image and channel
(channel), or a gain map per image (the blocks variants). Each pair of
kinds shares one code path with a `per_channel` flag (`ops/exposure.py`).

The step-by-step API runs on the compensator's device: `feed(corners,
imgs, masks)` estimates from host LOW warps (the scalar kinds re-estimate
`nr_feeds` times, each round on the images times the gains so far, as the
reference's list form does), and `apply(idx, corner, img, mask)`
compensates one host FINAL warp. The gains and each image's gain map stay
on the device they were fed on (the compensator's, or the stack's) between
the calls; an apply computes there in float64, as the reference's numpy
does.
"""

from collections import OrderedDict

import numpy as np
import torch

from .errors import StitchingError
from .ops.exposure import (compute_block_gains, compute_block_gains_stack,
                           compute_scalar_gains, compute_scalar_gains_stack,
                           smooth_gain_map)


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
                 nr_feeds=DEFAULT_NR_FEEDS, block_size=DEFAULT_BLOCK_SIZE,
                 device="cuda"):
        if compensator not in self.COMPENSATOR_CHOICES:
            raise StitchingError(
                "invalid compensator: " + str(compensator))
        self.compensator = compensator
        self.nr_feeds = nr_feeds
        self.block_size = block_size
        self.device = torch.device(device)
        self._gains = None
        self._block_state = None

    def feed(self, corners, imgs, masks):
        """Estimate the gains from host LOW warps and their masks."""
        if self.compensator == "no":
            return
        dev = self.device
        imgs = [torch.as_tensor(np.asarray(im), device=dev) for im in imgs]
        masks = [torch.as_tensor(np.asarray(m), device=dev) for m in masks]
        per_channel = self.compensator in ("channel", "channel_blocks")
        if self.compensator in ("gain", "channel"):
            gains = None
            cur = imgs
            for _ in range(max(1, int(self.nr_feeds))):
                g = compute_scalar_gains(corners, cur, masks, per_channel)
                gains = g if gains is None else gains * g
                # the next round's images: the current ones (as float32)
                # times the gains so far, in float64, saturated
                gd = torch.as_tensor(gains, device=dev)
                cur = [(im.to(torch.float32).to(torch.float64)
                        * (gi if per_channel else gi[0])).clamp(0, 255)
                       for im, gi in zip(cur, gd)]
            self._gains = gains
        else:
            origin, bs, gains, present = compute_block_gains(
                corners, imgs, masks, self.block_size, per_channel)
            smoothed = [smooth_gain_map(gains[i], present[i])
                        for i in range(len(imgs))]
            self._block_state = (origin, bs, smoothed)
            # the LOW corners and sizes map FINAL applies by ratio
            self._feed_corners = list(corners)
            self._feed_sizes = [(im.shape[1], im.shape[0]) for im in imgs]
        self._keep_on_device(dev)

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
        else:
            origin, bs, gains, present = compute_block_gains_stack(
                stack.data, stack.masks, corners[:n], sizes,
                self.block_size, per_channel)
            smoothed = [smooth_gain_map(gains[i], present[i])
                        for i in range(n)]
            self._block_state = (origin, bs, smoothed)
            # LOW-resolution corners and sizes map FINAL applies by ratio
            self._feed_corners = list(corners[:n])
            self._feed_sizes = [tuple(s) for s in sizes]
        self._keep_on_device(stack.data.device)

    def _keep_on_device(self, dev):
        """The fed state for `apply` on `dev` (where it was fed): the
        gains, or each image's cell span of its smoothed gain map."""
        if self.compensator in ("gain", "channel"):
            self._gains_dev = torch.as_tensor(self._gains, device=dev)
            return
        origin, bs, smoothed = self._block_state
        self._gain_maps = []
        for i, gmap in enumerate(smoothed):
            gx0 = self._feed_corners[i][0] - origin[0]
            gy0 = self._feed_corners[i][1] - origin[1]
            fw, fh = self._feed_sizes[i]
            ncy = -(-(gy0 % bs + fh) // bs)
            ncx = -(-(gx0 % bs + fw) // bs)
            sub = gmap[gy0 // bs:gy0 // bs + ncy, gx0 // bs:gx0 // bs + ncx]
            self._gain_maps.append(torch.as_tensor(sub.astype(np.float32),
                                                   device=dev))

    def apply(self, idx, corner, img, mask=None):
        """Compensate image `idx` (a host FINAL warp); same dtype out."""
        img = np.asarray(img)
        if self.compensator == "no":
            return img
        state = (self._gains_dev if self.compensator in ("gain", "channel")
                 else self._gain_maps[idx])
        x = torch.as_tensor(img, device=state.device).to(torch.float32).to(
            torch.float64)
        if self.compensator in ("gain", "channel"):
            g = self._gains_dev[idx]
            out = x * (g if len(g) == 3 else g[0])
        else:
            out = x * self._gain_map_at(idx, img.shape[0], img.shape[1])
        return torch.round(out).clamp(0, 255).to(
            getattr(torch, img.dtype.name)).cpu().numpy()

    def _gain_map_at(self, idx, h, w):
        """Image idx's cell gain map bilinearly sampled at every pixel of
        an (h, w) apply: pixel a maps to feed pixel centre (a + 0.5) * feed
        / apply, then to cell coordinate (sub-block offset + that) / bs -
        0.5 in the image's sub-map, the convention of
        `compose._gain_map_kernel`. (h, w, C') float64 on the device."""
        origin, bs, _ = self._block_state
        sub = self._gain_maps[idx]
        ncy, ncx = sub.shape[0], sub.shape[1]
        fw, fh = self._feed_sizes[idx]
        gx0 = self._feed_corners[idx][0] - origin[0]
        gy0 = self._feed_corners[idx][1] - origin[1]
        gx = ((gx0 % bs) + (np.arange(w) + 0.5) * (fw / w)) / bs - 0.5
        gy = ((gy0 % bs) + (np.arange(h) + 0.5) * (fh / h)) / bs - 0.5
        gx = np.clip(gx, 0.0, ncx - 1.0)
        gy = np.clip(gy, 0.0, ncy - 1.0)
        x0 = np.floor(gx).astype(np.int64)
        y0 = np.floor(gy).astype(np.int64)
        dev = sub.device
        fx = torch.as_tensor(gx - x0, device=dev)[None, :, None]
        fy = torch.as_tensor(gy - y0, device=dev)[:, None, None]
        x1 = torch.as_tensor(np.minimum(x0 + 1, ncx - 1), device=dev)
        y1 = torch.as_tensor(np.minimum(y0 + 1, ncy - 1), device=dev)
        x0 = torch.as_tensor(x0, device=dev)
        y0 = torch.as_tensor(y0, device=dev)
        s = sub.to(torch.float64)
        r0 = s[y0][:, x0] * (1 - fx) + s[y0][:, x1] * fx
        r1 = s[y1][:, x0] * (1 - fx) + s[y1][:, x1] * fx
        up = r0 * (1 - fy) + r1 * fy
        return up if up.shape[-1] == 3 else up[..., :1]
