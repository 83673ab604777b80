"""stitching_tpu_torch: the image stitcher on PyTorch and CUDA.

The port of `stitching_tpu` to one NVIDIA H100, slice by slice. Public
API: `Stitcher`, which runs with its default settings, `AffineStitcher`
for scans, and `SLICE` and `SLICE2`, two smaller configurations (no seams
and no blend; slice 1 also without adjuster, wave correction, crop and
exposure); `Stitcher.stitch_device` keeps the panorama on the card;
`pipeline.register_pair` registers one pair of frames; `profiling` times
the engine's stages.
"""

__version__ = "0.1.0"

from .errors import StitchingError, StitchingWarning  # noqa: F401
from .stitcher import SLICE, SLICE2, AffineStitcher, Stitcher  # noqa: F401
