"""Seam finder component.

Port of `stitching_tpu/seam_finder.py`'s settings surface: the registry
dp_color (default) / dp_colorgrad / gc_color / gc_colorgrad / voronoi / no.
This slice implements "no", whose seam masks are the warp masks; the others
raise `NotImplementedError` (ROADMAP queue 1: seams).
"""

from collections import OrderedDict

from .errors import StitchingError


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
        if finder != "no":
            raise NotImplementedError(
                f"finder={finder!r} is not ported yet (ROADMAP queue 1: "
                "seams)")
        self.finder_name = finder
        self.kind, self.use_grad = self.SEAM_FINDER_CHOICES[finder]

    def find_stack(self, stack):
        """Seam masks over a `compose.TileStack`: the warp masks."""
        return stack.masks
