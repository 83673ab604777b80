"""Separable Gaussian filtering on the card.

Two 1-D passes, each written as a weighted sum of shifted slices of the
edge-padded input (no convolution library call, so the same arithmetic runs
on the CPU and on the card, and cuDNN's TF32 default cannot enter).
"""

import numpy as np
import torch
import torch.nn.functional as F

from .fma import fma


def gaussian_kernel_1d(sigma: float, radius: int = None) -> np.ndarray:
    if radius is None:
        radius = max(1, int(round(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _conv1d(img, kernel, axis):
    """Convolve (..., H, W) along `axis` (-1 or -2) with SAME/edge padding."""
    r = len(kernel) // 2
    x = img if axis == -1 else img.transpose(-1, -2)
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, x.shape[-1]), (r, r), mode="replicate")
    xp = xp.reshape(lead + (xp.shape[-1],))
    n = x.shape[-1]
    taps = [xp[..., i:i + n] for i in range(len(kernel))]
    out = _sum_taps(taps, [float(k) for k in kernel])
    return out if axis == -1 else out.transpose(-1, -2)


def _sum_taps(taps, weights):
    """Sum of taps[i] * weights[i] in the order of the reference's compiled
    CPU convolution, so that the bits agree: whole blocks of 8 taps
    accumulate lane by lane into 8 partial sums (the first block's
    products, each later block by a multiply-add), which reduce as (0+1,
    2+3, 4+5, 6+7), then (01+45) + (23+67); the taps left over add on as a
    block of 4 ((0+1) + (2+3)), a pair and a single tap, in that order, as
    products rounded to float32. (Found by summing huge and tiny values,
    whose rounding shows which taps meet first, and held equal to the
    reference up to 23 taps; the port's blurs have at most 19. Up to 7
    taps it is neighbours in pairs, then the pairs in order.)"""
    prods = [t * w for t, w in zip(taps, weights)]
    full = len(prods) // 8 * 8
    out = None
    if full:
        lanes = list(prods[:8])
        for c in range(8, full, 8):
            lanes = [fma(t, w, a) for a, t, w in
                     zip(lanes, taps[c:c + 8], weights[c:c + 8])]
        w = [lanes[i] + lanes[i + 1] for i in range(0, 8, 2)]
        out = (w[0] + w[2]) + (w[1] + w[3])
    rest = prods[full:]
    parts = []
    if len(rest) >= 4:
        parts.append((rest[0] + rest[1]) + (rest[2] + rest[3]))
        rest = rest[4:]
    if len(rest) >= 2:
        parts.append(rest[0] + rest[1])
        rest = rest[2:]
    parts += rest
    for p in parts:
        out = p if out is None else out + p
    return out


def gaussian_blur(img: torch.Tensor, sigma: float,
                  radius: int = None) -> torch.Tensor:
    """Gaussian blur of (..., H, W) float image, edge-padded."""
    k = gaussian_kernel_1d(sigma, radius)
    out = _conv1d(img, k, -1)
    return _conv1d(out, k, -2)
