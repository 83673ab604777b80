"""Seam finder component.

Port of `stitching_tpu/seam_finder.py`'s settings surface: the registry
dp_color (default) / dp_colorgrad / gc_color / gc_colorgrad / voronoi / no.
`find_stack` runs on the LOW tile stack on its device: "no" keeps the warp
masks, dp_color and dp_colorgrad run `ops/seam.dp_seams_stack`, gc_color
and gc_colorgrad `ops/seam.gc_seams_stack`, voronoi
`ops/seam.voronoi_seams_stack`.
"""

from collections import OrderedDict

from .errors import StitchingError
from .ops.seam import dp_seams_stack, gc_seams_stack, voronoi_seams_stack


class SeamFinder:
    SEAM_FINDER_CHOICES = OrderedDict(
        dp_color=("dp", False),
        dp_colorgrad=("dp", True),
        gc_color=("gc", False),
        gc_colorgrad=("gc", True),
        voronoi=("voronoi", None),
        no=("no", None),
    )
    DEFAULT_SEAM_FINDER = list(SEAM_FINDER_CHOICES.keys())[0]

    def __init__(self, finder=DEFAULT_SEAM_FINDER):
        if finder not in self.SEAM_FINDER_CHOICES:
            raise StitchingError("invalid seam finder: " + str(finder))
        self.finder_name = finder
        self.kind, self.use_grad = self.SEAM_FINDER_CHOICES[finder]

    def find_stack(self, stack):
        """Seam masks over a `compose.TileStack`: a (B, TH, TW) float32
        {0, 255} tensor on the stack's device."""
        if self.kind == "no":
            return stack.masks
        if self.kind in ("dp", "gc"):
            seams = dp_seams_stack if self.kind == "dp" else gc_seams_stack
            return seams(stack.data, stack.masks, stack.corners,
                         stack.sizes, self.use_grad)
        return voronoi_seams_stack(stack.masks, stack.corners, stack.sizes)
