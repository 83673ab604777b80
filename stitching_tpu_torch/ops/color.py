"""Color conversions on the card (BGR channel order, matching host I/O)."""

import torch

from .fma import fma

# BT.601 luma weights, same as cv.cvtColor(BGR2GRAY).
_B, _G, _R = 0.114, 0.587, 0.299


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) BGR -> (..., H, W) luma. Works for uint8 or float.

    Rounded as the JAX reference's compiled CPU code rounds it:
    fma(R, r, fma(B, b, G * g))."""
    img = img.to(torch.float32)
    return fma(img[..., 2], _R, fma(img[..., 0], _B, img[..., 1] * _G))
