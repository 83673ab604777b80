"""stitching_tpu_torch: the image stitcher on PyTorch and CUDA.

The port of `stitching_tpu` to one NVIDIA H100, slice by slice. Public
API: `Stitcher`, and `SLICE` and `SLICE2`, the settings that the port runs
so far; `pipeline.register_pair` registers one pair of frames.
"""

from .errors import StitchingError, StitchingWarning  # noqa: F401
from .stitcher import SLICE, SLICE2, Stitcher  # noqa: F401
