"""stitching_tpu_torch: the image stitcher on PyTorch and CUDA.

The port of `stitching_tpu` to one NVIDIA H100, slice by slice. Public
API: `Stitcher` and `SLICE`, the settings that the port runs so far.
"""

from .errors import StitchingError, StitchingWarning  # noqa: F401
from .stitcher import SLICE, Stitcher  # noqa: F401
