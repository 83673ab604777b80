"""Feature detection component.

Port of `stitching_tpu/feature_detector.py`: the registry of detector
choices (orb default / sift / brisk / akaze) with the same validation,
`detect`, `detect_with_masks`, `detect_features` and `draw_keypoints`.
The detectors are `ops/orb.py`, `ops/sift.py`, `ops/brisk.py` and
`ops/akaze.py`. `detect` runs ONE batched pass for the whole image list
(`pipeline.detect_stack`); the small per-keypoint fields land on host, the
descriptors stay on the card.
"""

from collections import OrderedDict

import numpy as np

from .errors import StitchingError
from .parallel.mesh import all_gather_leading
from .pipeline import detect_stack, stack_images
from .types import Features


class FeatureDetector:
    DETECTOR_CHOICES = OrderedDict(
        orb=dict(is_binary=True, default_nfeatures=500),
        sift=dict(is_binary=False, default_nfeatures=500),
        brisk=dict(is_binary=True, default_nfeatures=1024),
        akaze=dict(is_binary=True, default_nfeatures=1024),
    )
    DEFAULT_DETECTOR = list(DETECTOR_CHOICES.keys())[0]

    def __init__(self, detector=DEFAULT_DETECTOR, device="cuda", **kwargs):
        if detector not in self.DETECTOR_CHOICES:
            raise StitchingError("invalid detector: " + str(detector))
        self.detector_name = detector
        spec = self.DETECTOR_CHOICES[detector]
        self.is_binary = spec["is_binary"]
        self.nfeatures = int(kwargs.get("nfeatures",
                                        spec["default_nfeatures"]))
        self.device = device

    def detect(self, imgs):
        """Batched detection over an image list."""
        return self.detect_on_stack(stack_images(imgs, self.device))

    def detect_with_masks(self, imgs, masks):
        if len(imgs) != len(masks):
            raise StitchingError(
                "image and mask lists must be of same length")
        for idx, (img, mask) in enumerate(zip(imgs, masks)):
            if mask.shape[0] != img.shape[0] or mask.shape[1] != img.shape[1]:
                raise StitchingError(
                    f"Resolution of mask {idx + 1} {mask.shape} does not"
                    f" match the resolution of image {idx + 1}"
                    f" {img.shape[:2]}."
                )
        return self.detect_on_stack(stack_images(imgs, self.device), masks)

    def detect_features(self, img, mask=None):
        """Detect on one BGR (or gray) uint8 image -> Features."""
        return self.detect_on_stack(stack_images([img], self.device),
                                    None if mask is None else [mask])[0]

    def detect_on_stack_dispatch(self, stack, masks=None):
        """Detect on a DeviceStack without copying to host: the stacked
        dict of tensors."""
        return detect_stack(
            stack, nfeatures=self.nfeatures, variant=self.detector_name,
            feature_masks=masks)

    def features_from_host(self, desc, small, sizes):
        """Per-image Features from host copies of the small detection
        fields; descriptors stay on the card."""
        return [
            Features(
                xy=np.asarray(small["xy"][i]),
                response=np.asarray(small["response"][i]),
                size=np.asarray(small["size"][i]),
                angle=np.asarray(small["angle_deg"][i]),
                desc=desc[i],
                valid=np.asarray(small["valid"][i]),
                img_size=(int(w), int(h)),
                is_binary=self.is_binary,
            )
            for i, (w, h) in enumerate(sizes)
        ]

    def detect_on_stack(self, stack, masks=None):
        """Detect on an already device-resident DeviceStack. Under a mesh
        each rank detects on its block and the fixed-shape fields are
        gathered, so every rank holds every image's features."""
        out = self.detect_on_stack_dispatch(stack, masks)
        if stack.mesh is not None:
            out = {k: all_gather_leading(v, stack.mesh)
                   for k, v in out.items()}
        small = {k: out[k].cpu().numpy() for k in
                 ("xy", "response", "size", "angle_deg", "valid")}
        return self.features_from_host(out["desc"], small, stack.sizes)

    @staticmethod
    def draw_keypoints(img, features, color=(0, 255, 0), radius=3):
        """Host-side keypoint overlay (the reference's draw_keypoints)."""
        from .viz import draw_circles

        return draw_circles(np.asarray(img).copy(), features.keypoints_np,
                            radius, color)
