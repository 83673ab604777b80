"""Camera bundle adjustment component.

Port of `stitching_tpu/camera_adjuster.py`'s settings surface: the adjuster
registry (ray default / reproj / affine / no) and the 5-char refinement mask.
This slice implements "no", which returns the estimated cameras unchanged;
every other choice raises `NotImplementedError` (ROADMAP queue 1: bundle
adjustment).
"""

from collections import OrderedDict

from .errors import StitchingError


class CameraAdjuster:
    CAMERA_ADJUSTER_CHOICES = OrderedDict(
        ray="ray", reproj="reproj", affine="affine", no="no",
    )
    DEFAULT_CAMERA_ADJUSTER = list(CAMERA_ADJUSTER_CHOICES.keys())[0]
    DEFAULT_REFINEMENT_MASK = "xxxxx"

    def __init__(self, adjuster=DEFAULT_CAMERA_ADJUSTER,
                 refinement_mask=DEFAULT_REFINEMENT_MASK,
                 confidence_threshold=1.0):
        if adjuster not in self.CAMERA_ADJUSTER_CHOICES:
            raise StitchingError("invalid adjuster: " + str(adjuster))
        if adjuster != "no":
            raise NotImplementedError(
                f"adjuster={adjuster!r} is not ported yet (ROADMAP queue 1: "
                "bundle adjustment)")
        self.adjuster = adjuster
        self.refinement_mask = refinement_mask
        self.confidence_threshold = confidence_threshold

    def adjust(self, features, pairwise_matches, estimated_cameras):
        return estimated_cameras
