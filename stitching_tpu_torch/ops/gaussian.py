"""Separable Gaussian filtering on the card.

Two 1-D passes, each written as a weighted sum of shifted slices of the
edge-padded input (no convolution library call, so the same arithmetic runs
on the CPU and on the card, and cuDNN's TF32 default cannot enter).
"""

import numpy as np
import torch
import torch.nn.functional as F


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
    # The reference's compiled CPU convolution sums the taps in pairs of
    # neighbours, then adds the pair sums in order, each step rounded to
    # float32; the same order here gives the same bits.
    prods = [xp[..., i:i + n] * float(kernel[i]) for i in range(len(kernel))]
    pairs = [prods[i] + prods[i + 1] if i + 1 < len(prods) else prods[i]
             for i in range(0, len(prods), 2)]
    out = pairs[0]
    for p in pairs[1:]:
        out = out + p
    return out if axis == -1 else out.transpose(-1, -2)


def gaussian_blur(img: torch.Tensor, sigma: float,
                  radius: int = None) -> torch.Tensor:
    """Gaussian blur of (..., H, W) float image, edge-padded."""
    k = gaussian_kernel_1d(sigma, radius)
    out = _conv1d(img, k, -1)
    return _conv1d(out, k, -2)
