"""Command line tool of the stitching_tpu_torch package.

    python -m stitching_tpu_torch.cli.stitch img*.png --output pano.png [-v]

Port of `stitching_tpu/cli/stitch.py` with the same flag surface: one flag
per `Stitcher.DEFAULT_SETTINGS` key with defaults and choices from the
component class constants, plus --version, -v/--verbose/--verbose_dir,
--affine, --feature_masks, --preview, --output and --output_params, from
one declarative flag table. The stitch runs on the card; `main(device=)`
takes another device from Python (the tests pass "cpu"). The package has
no GUI: --preview stitches and writes --output as without the flag, then
says on stderr that no preview is available, as the reference does on a
host without a GUI backend.
"""

import argparse
import os
import sys
from datetime import datetime

from .. import AffineStitcher, Stitcher, __version__
from .. import io as _io
from ..blender import Blender
from ..camera_adjuster import CameraAdjuster
from ..camera_estimator import CameraEstimator
from ..camera_wave_corrector import WaveCorrector
from ..cropper import Cropper
from ..exposure_error_compensator import ExposureErrorCompensator
from ..feature_detector import FeatureDetector
from ..feature_matcher import FeatureMatcher
from ..images import Images
from ..seam_finder import SeamFinder
from ..subsetter import Subsetter
from ..timelapser import Timelapser
from ..warper import Warper


def _bool_flag(x):
    return x.lower() != "false"


def _setting_flags():
    """Declarative table: (name, kwargs) for every pipeline setting flag."""
    res = Images.Resolution
    return [
        ("medium_megapix", dict(
            type=float, default=res.MEDIUM.value,
            help="Resolution for image registration step. The default is "
                 f"{res.MEDIUM.value} Mpx")),
        ("detector", dict(
            default=FeatureDetector.DEFAULT_DETECTOR,
            choices=list(FeatureDetector.DETECTOR_CHOICES),
            help="Type of detector used to find features.")),
        ("nfeatures", dict(
            type=int, default=500,
            help="Number of features (used only for orb and sift "
                 "detector).")),
        ("matcher_type", dict(
            default=FeatureMatcher.DEFAULT_MATCHER,
            choices=FeatureMatcher.MATCHER_CHOICES,
            help="Matcher used for pairwise image matching.")),
        ("range_width", dict(
            type=int, default=FeatureMatcher.DEFAULT_RANGE_WIDTH,
            help="Limit the number of images to match with each other.")),
        ("try_use_gpu", dict(
            type=_bool_flag, default=False,
            help="Accepted for API parity; compute runs on the NVIDIA "
                 "card (CUDA) whatever its value.")),
        ("match_conf", dict(
            type=float, default=None,
            help="Confidence for feature matching step. The default is 0.3 "
                 "for ORB and 0.65 for other feature detectors.")),
        ("confidence_threshold", dict(
            type=float, default=Subsetter.DEFAULT_CONFIDENCE_THRESHOLD,
            help="Threshold for two images being from the same panorama.")),
        ("matches_graph_dot_file", dict(
            type=str, default=Subsetter.DEFAULT_MATCHES_GRAPH_DOT_FILE,
            help="Save matches graph represented in DOT language to file.")),
        ("estimator", dict(
            default=CameraEstimator.DEFAULT_CAMERA_ESTIMATOR,
            choices=list(CameraEstimator.CAMERA_ESTIMATOR_CHOICES),
            help="Type of estimator used for transformation estimation.")),
        ("adjuster", dict(
            default=CameraAdjuster.DEFAULT_CAMERA_ADJUSTER,
            choices=list(CameraAdjuster.CAMERA_ADJUSTER_CHOICES),
            help="Bundle adjustment cost function.")),
        ("refinement_mask", dict(
            default=CameraAdjuster.DEFAULT_REFINEMENT_MASK,
            help="Set refinement mask for bundle adjustment, as 'x_xxx'.")),
        ("wave_correct_kind", dict(
            default=WaveCorrector.DEFAULT_WAVE_CORRECTION,
            choices=list(WaveCorrector.WAVE_CORRECT_CHOICES),
            help="Perform wave effect correction.")),
        ("warper_type", dict(
            default=Warper.DEFAULT_WARP_TYPE,
            choices=Warper.WARP_TYPE_CHOICES,
            help="Warp surface type.")),
        ("low_megapix", dict(
            type=float, default=res.LOW.value,
            help="Resolution for seam estimation and exposure estimation "
                 f"step. The default is {res.LOW.value} Mpx")),
        ("crop", dict(
            type=_bool_flag, default=Cropper.DEFAULT_CROP,
            help="Crop black borders around images caused by warping "
                 "them.")),
        ("compensator", dict(
            default=ExposureErrorCompensator.DEFAULT_COMPENSATOR,
            choices=list(ExposureErrorCompensator.COMPENSATOR_CHOICES),
            help="Exposure compensation method.")),
        ("nr_feeds", dict(
            type=int, default=ExposureErrorCompensator.DEFAULT_NR_FEEDS,
            help="Number of exposure compensation feed.")),
        ("block_size", dict(
            type=int, default=ExposureErrorCompensator.DEFAULT_BLOCK_SIZE,
            help="Block size in pixels used by the exposure compensator.")),
        ("finder", dict(
            default=SeamFinder.DEFAULT_SEAM_FINDER,
            choices=list(SeamFinder.SEAM_FINDER_CHOICES),
            help="Seam estimation method.")),
        ("final_megapix", dict(
            type=float, default=res.FINAL.value,
            help="Resolution for compositing step. Use -1 for original "
                 f"resolution. The default is {res.FINAL.value}")),
        ("blender_type", dict(
            default=Blender.DEFAULT_BLENDER, choices=Blender.BLENDER_CHOICES,
            help="Blending method.")),
        ("blend_strength", dict(
            type=int, default=Blender.DEFAULT_BLEND_STRENGTH,
            help="Blending strength from [0,100] range.")),
        ("timelapse", dict(
            default=Timelapser.DEFAULT_TIMELAPSE,
            choices=Timelapser.TIMELAPSE_CHOICES,
            help="Output warped images separately as frames of a time "
                 "lapse movie, with 'fixed_' prepended to input file "
                 "names.")),
        ("timelapse_prefix", dict(
            default=Timelapser.DEFAULT_TIMELAPSE_PREFIX,
            help="Prefix to output filenames in timelapse mode.")),
    ]


def create_parser():
    parser = argparse.ArgumentParser(prog="stitch.py")
    parser.add_argument("--version", action="version", version=__version__)
    parser.add_argument("images", nargs="+", type=str,
                        help="Files to stitch")
    parser.add_argument(
        "-v", "--verbose", action="store_true",
        help="Creates a directory with verbose results.")
    parser.add_argument(
        "--verbose_dir",
        default=datetime.now().strftime("%Y%m%d_%H%M%S")
        + "_verbose_results",
        help="The directory where verbose results should be saved.")
    parser.add_argument(
        "--affine", action="store_true",
        help="Overwrites multiple parameters to optimize the stitching for "
             "scans and images captured by specialized devices. The "
             "following parameters are set: "
             + str(AffineStitcher.AFFINE_DEFAULTS))
    parser.add_argument(
        "--feature_masks", nargs="*", default=[], type=str,
        help="Masks for selecting where features should be detected.")
    for name, kwargs in _setting_flags():
        parser.add_argument(f"--{name}", **kwargs)
    parser.add_argument(
        "--no-crop", action="store_false", dest="crop",
        help="Don't crop black borders around images caused by warping.")
    parser.add_argument(
        "--preview", action="store_true",
        help="Show a preview of the panorama (this package has no GUI: "
             "the panorama is written to --output and a notice printed).")
    parser.add_argument(
        "--output", default="result.jpg",
        help="Name of the output file.")
    parser.add_argument(
        "--output_params", nargs="*", default=[], type=int,
        help="Parameters passed to the image writer (imwrite flag pairs).")
    return parser


def main(device="cuda"):
    opts = vars(create_parser().parse_args())

    img_names = Images.resolve_wildcards(opts.pop("images"))
    feature_masks = Images.resolve_wildcards(opts.pop("feature_masks"))
    io_opts = {k: opts.pop(k) for k in
               ("verbose", "verbose_dir", "preview", "output",
                "output_params")}

    if opts.pop("affine"):
        # flags left at their generic defaults inherit the affine ones
        for key, value in AffineStitcher.AFFINE_DEFAULTS.items():
            if opts.get(key) == Stitcher.DEFAULT_SETTINGS.get(key):
                opts[key] = value
        stitcher = AffineStitcher(device=device, **opts)
    else:
        stitcher = Stitcher(device=device, **opts)

    if io_opts["verbose"]:
        os.makedirs(io_opts["verbose_dir"], exist_ok=True)
        print(f"Stitching {img_names} into {io_opts['output']} "
              f"(verbose results in {io_opts['verbose_dir']})")
        panorama = stitcher.stitch_verbose(
            img_names, feature_masks, io_opts["verbose_dir"])
    else:
        print(f"Stitching {img_names} into {io_opts['output']}")
        panorama = stitcher.stitch(img_names, feature_masks)

    if panorama is not None:
        _io.write_image(io_opts["output"], panorama,
                        io_opts["output_params"])
        if io_opts["preview"]:
            print("preview unavailable (no GUI backend)", file=sys.stderr)


if __name__ == "__main__":
    main()
