"""Public stitching API: `Stitcher` and `AffineStitcher`.

Port of `stitching_tpu/stitcher.py`: the same settings schema with the
same defaults, unknown-kwarg `StitchingError`, the ORB match_conf default
resolution and nfeatures forwarding, the MEDIUM / LOW / FINAL resolution
semantics, and `AffineStitcher`'s affine defaults with the override
warning. The pipeline runs on `device`, the card by default. `mesh=`, as
in the JAX package, splits the image, match-pair, bundle-edge and tile
axes over the ranks of a `parallel.mesh.Mesh` (one process per GPU,
SPMD: every rank calls `stitch` with the same inputs and gets the same
panorama); the components then run on the mesh's device.

`Stitcher()` runs with every default setting: ORB, homography matching,
ray bundle adjustment, horizontal wave correction, the spherical warp, the
LIR crop, gain_blocks exposure, dp_color seams and the multiband blend;
so do the other matchers, estimators, adjusters, wave corrections, all 16
warp surfaces, the five compensators, the five seam finders and the three
blenders, and the timelapse frames. `AffineStitcher()` stitches scans:
similarity matching, the affine estimate and adjuster, the affine warp, no
wave correction and no exposure compensation. `SLICE` and `SLICE2` are two
smaller configurations that switch stages off. `stitch` returns the
panorama on the host; `stitch_device` keeps it on the device;
`stitch_verbose` runs the step-by-step component API and writes every
stage's artifacts. Each sets TF32 off for the call only
(`pipeline.no_tf32`). Every component runs on the stitcher's device.
Every detector runs: ORB, SIFT (float descriptors, matched by the float
2-NN kernel), BRISK and AKAZE (512-bit rows).
"""

import warnings

import torch

from . import engine
from .blender import Blender
from .camera_adjuster import CameraAdjuster
from .camera_estimator import CameraEstimator
from .camera_wave_corrector import WaveCorrector
from .cropper import Cropper
from .errors import StitchingError, StitchingWarning
from .exposure_error_compensator import ExposureErrorCompensator
from .feature_detector import FeatureDetector
from .feature_matcher import FeatureMatcher
from .images import Images
from .pipeline import no_tf32
from .seam_finder import SeamFinder
from .subsetter import Subsetter
from .timelapser import Timelapser
from .warper import Warper

# The ported slice: the reference CLI's `--adjuster no --wave_correct_kind
# no --compensator no --finder no --blender_type no` with crop disabled.
SLICE = dict(crop=False, adjuster="no", wave_correct_kind="no",
             compensator="no", finder="no", blender_type="no")
# The second slice: every default (ray bundle adjustment, horizontal wave
# correction, the LIR crop, gain_blocks exposure) except the seam finder and
# the blender, which paste the warp masks.
SLICE2 = dict(finder="no", blender_type="no")


class Stitcher:
    DEFAULT_SETTINGS = {
        "medium_megapix": Images.Resolution.MEDIUM.value,
        "detector": FeatureDetector.DEFAULT_DETECTOR,
        "nfeatures": 500,
        "matcher_type": FeatureMatcher.DEFAULT_MATCHER,
        "range_width": FeatureMatcher.DEFAULT_RANGE_WIDTH,
        "try_use_gpu": False,
        "match_conf": None,
        "confidence_threshold": Subsetter.DEFAULT_CONFIDENCE_THRESHOLD,
        "matches_graph_dot_file": Subsetter.DEFAULT_MATCHES_GRAPH_DOT_FILE,
        "estimator": CameraEstimator.DEFAULT_CAMERA_ESTIMATOR,
        "adjuster": CameraAdjuster.DEFAULT_CAMERA_ADJUSTER,
        "refinement_mask": CameraAdjuster.DEFAULT_REFINEMENT_MASK,
        "wave_correct_kind": WaveCorrector.DEFAULT_WAVE_CORRECTION,
        "warper_type": Warper.DEFAULT_WARP_TYPE,
        "low_megapix": Images.Resolution.LOW.value,
        "crop": Cropper.DEFAULT_CROP,
        "compensator": ExposureErrorCompensator.DEFAULT_COMPENSATOR,
        "nr_feeds": ExposureErrorCompensator.DEFAULT_NR_FEEDS,
        "block_size": ExposureErrorCompensator.DEFAULT_BLOCK_SIZE,
        "finder": SeamFinder.DEFAULT_SEAM_FINDER,
        "final_megapix": Images.Resolution.FINAL.value,
        "blender_type": Blender.DEFAULT_BLENDER,
        "blend_strength": Blender.DEFAULT_BLEND_STRENGTH,
        "timelapse": Timelapser.DEFAULT_TIMELAPSE,
        "timelapse_prefix": Timelapser.DEFAULT_TIMELAPSE_PREFIX,
    }

    def __init__(self, device=None, mesh=None, **kwargs):
        if mesh is not None:
            d = torch.device(mesh.device if device is None else device)
            if d.type != mesh.device.type or d.index not in (
                    None, mesh.device.index):
                raise StitchingError(f"device {device} is not the mesh's "
                                     f"{mesh.device}")
            device = mesh.device
        self.device = torch.device("cuda" if device is None else device)
        self.mesh = mesh
        self.initialize_stitcher(**kwargs)

    def initialize_stitcher(self, **kwargs):
        self.validate_kwargs(kwargs)
        self.kwargs = kwargs
        self.settings = {**self.DEFAULT_SETTINGS, **kwargs}
        self._build_components(self.settings)

    def _build_components(self, s):
        """Construct the per-stage components from the resolved settings."""
        self.medium_megapix = s["medium_megapix"]
        self.low_megapix = s["low_megapix"]
        self.final_megapix = s["final_megapix"]

        detector_kwargs = (
            {"nfeatures": s["nfeatures"]}
            if s["detector"] in ("orb", "sift") else {})
        self.detector = FeatureDetector(s["detector"], device=self.device,
                                        **detector_kwargs)
        self.matcher = FeatureMatcher(
            s["matcher_type"], s["range_width"],
            try_use_gpu=s["try_use_gpu"],
            match_conf=FeatureMatcher.get_match_conf(
                s["match_conf"], s["detector"]))
        self.subsetter = Subsetter(
            s["confidence_threshold"], s["matches_graph_dot_file"])
        self.camera_estimator = CameraEstimator(s["estimator"])
        self.camera_adjuster = CameraAdjuster(
            s["adjuster"], s["refinement_mask"], s["confidence_threshold"],
            device=self.device)
        self.wave_corrector = WaveCorrector(s["wave_correct_kind"])
        self.warper = Warper(s["warper_type"], device=self.device)
        self.cropper = Cropper(s["crop"], device=self.device)
        self.compensator = ExposureErrorCompensator(
            s["compensator"], s["nr_feeds"], s["block_size"],
            device=self.device)
        self.seam_finder = SeamFinder(s["finder"], device=self.device)
        self.blender = Blender(s["blender_type"], s["blend_strength"],
                               device=self.device)
        self.timelapser = Timelapser(s["timelapse"], s["timelapse_prefix"])

    def stitch(self, images, feature_masks=[]):
        """Stitch the image set into a panorama (uint8 host array), or,
        with timelapse, write one frame per image and return None.

        On the card the streamed FINAL pass lands the panorama's bands in
        one pinned (page-locked) host block, and the array is a view of
        it: the block stays page-locked while the caller holds the array.
        Once it is let go, PyTorch's caching host allocator keeps the
        block (its size rounded up to a power of two) for the next stitch,
        for the life of the process, or until
        `torch.accelerator.empty_host_cache()` where PyTorch has it (2.11
        has not). A caller that keeps many panoramas can keep
        `pano.copy()`, in pageable memory, instead."""
        with no_tf32():
            return engine.run(self, images, feature_masks)

    def stitch_device(self, images, feature_masks=[], prestaged=None):
        """Device-resident stitch: the panorama as a uint8 tensor on the
        stitcher's device. `prestaged` optionally supplies the originals
        as a `pipeline.DeviceStack` already on the device, so the pipeline
        uploads no image (the MEDIUM resize runs on the device); under a
        mesh, this rank's block (`pipeline.stack_images(images,
        mesh=mesh)`). Copy the result on demand with
        `compose.fetch_image`."""
        with no_tf32():
            return engine.run_device(self, images, feature_masks, prestaged)

    def stitch_verbose(self, images, feature_masks=[], verbose_dir=None):
        """Stitch step by step through the components' per-image methods,
        writing the numbered artifacts of every stage into `verbose_dir`
        (`verbose.py`); returns the panorama."""
        from .verbose import verbose_stitching

        with no_tf32():
            return verbose_stitching(self, images, feature_masks,
                                     verbose_dir)

    def validate_kwargs(self, kwargs):
        for arg in kwargs:
            if arg not in self.DEFAULT_SETTINGS:
                raise StitchingError("Invalid Argument: " + arg)


class AffineStitcher(Stitcher):
    AFFINE_DEFAULTS = {
        "estimator": "affine",
        "wave_correct_kind": "no",
        "matcher_type": "affine",
        "adjuster": "affine",
        "warper_type": "affine",
        "compensator": "no",
    }

    DEFAULT_SETTINGS = {**Stitcher.DEFAULT_SETTINGS, **AFFINE_DEFAULTS}

    def initialize_stitcher(self, **kwargs):
        for key, value in kwargs.items():
            if (key in self.AFFINE_DEFAULTS
                    and value != self.AFFINE_DEFAULTS[key]):
                warnings.warn(
                    f"You are overwriting an affine default "
                    f"({key}={self.AFFINE_DEFAULTS[key]}) with another "
                    f"value ({value}). Make sure this is intended",
                    StitchingWarning,
                )
        super().initialize_stitcher(**kwargs)
