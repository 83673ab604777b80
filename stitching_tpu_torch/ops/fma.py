"""Fused multiply-add with one rounding, on any device.

The JAX reference's compiled CPU code contracts some `a * b + c` patterns
into fused multiply-adds. Where a ranking or a threshold depends on those
last bits (ORB's gray conversion and Harris score), the port rounds the same
way: the product of two float32 values is exact in float64, so one float64
add and one rounding to float32 give the fused result.
"""

import torch


def _f64(x, device):
    return torch.as_tensor(x, dtype=torch.float32,
                           device=device).to(torch.float64)


def fma(a, b, c):
    """float32 a * b + c with a single rounding (scalars round to float32
    first, as JAX's weakly typed constants do)."""
    dev = a.device
    return (_f64(a, dev) * _f64(b, dev) + _f64(c, dev)).to(torch.float32)
