"""Verbose mode: the pipeline stage by stage, with every stage's artifacts.

Port of `stitching_tpu/verbose.py`, the reference's numbered artifact
groups (`stitching/verbose.py`): 00_stitcher.txt, 01_features_img*.jpg,
02_matches_img*_to_img*.jpg (inlier matches), 03_matches_graph.txt (DOT),
04_warped_img*.jpg, 05_timelapse_img*.jpg, 06_estimated_mask_to_crop.jpg
and 06_lir.jpg, 07_timelapse_cropped_img*.jpg, 08_seam_mask*.jpg and
08_compensated*.jpg, 09_result.jpg and its seam lines and polygons.

An artifact sink is threaded through the components' per-image methods,
each on the stitcher's device: every stage computes with the ordinary
component API and writes its artifacts through `_Sink.put`. As in the
reference, this mode resizes the seam masks against the FINAL warp masks
(unlike `stitch()`) and always runs an `as_is` timelapse excursion for the
pictures. One departure: the seam visualisation colours each seam mask at
its own shape (`SeamFinder.blend_seam_masks`), so a cropped run whose
rounded FINAL size is a pixel larger than its cropped mask writes both
seam pictures where the reference raises.
"""

import os

from . import io as _io
from .images import Images
from .seam_finder import SeamFinder
from .timelapser import Timelapser

_MEDIUM = Images.Resolution.MEDIUM
_LOW = Images.Resolution.LOW
_FINAL = Images.Resolution.FINAL


class _Sink:
    """Numbered artifact writer for one verbose run."""

    def __init__(self, directory):
        self.dir = "." if directory is None else directory

    def path(self, name):
        return os.path.join(self.dir, name)

    def put(self, name, img):
        _io.write_image(self.path(name), img)

    def put_text(self, name, text):
        with open(self.path(name), "w") as fh:
            fh.write(text)

    def put_frames(self, pattern, timelapser, imgs, corners):
        for idx, (img, corner) in enumerate(zip(imgs, corners)):
            timelapser.process_frame(img, corner)
            self.put(pattern.format(idx + 1), timelapser.get_frame())


def verbose_stitching(stitcher, images, feature_masks=[], verbose_dir=None):
    sink = _Sink(verbose_dir)
    sink.put_text("00_stitcher.txt",
                  type(stitcher).__name__ + "(**" + str(stitcher.kwargs)
                  + ")")

    images = Images.of(images, stitcher.medium_megapix,
                       stitcher.low_megapix, stitcher.final_megapix)
    imgs = list(images.resize(_MEDIUM))

    features = _dump_features(stitcher, sink, imgs, feature_masks)
    matches = _dump_matches(stitcher, sink, imgs, features)
    imgs, features, matches = _dump_subset(
        stitcher, sink, images, imgs, features, matches)

    cameras = stitcher.camera_estimator.estimate(features, matches)
    cameras = stitcher.camera_adjuster.adjust(features, matches, cameras)
    cameras = stitcher.wave_corrector.correct(cameras)
    stitcher.warper.set_scale(cameras)

    low = _warp_at(stitcher, images, cameras, imgs, _LOW)
    final = _warp_at(stitcher, images, cameras, None, _FINAL)
    for idx, warped in enumerate(final["imgs"]):
        sink.put(f"04_warped_img{idx + 1}.jpg", warped)

    _dump_timelapse(sink, "05_timelapse_img{}.jpg", final)

    if stitcher.cropper.do_crop:
        _dump_crop(stitcher, sink, images, low, final)
        _dump_timelapse(sink, "07_timelapse_cropped_img{}.jpg", final)

    seam_masks = _dump_seams(stitcher, sink, low, final)
    compensated = _dump_compensation(stitcher, sink, low, final)

    panorama = _blend(stitcher, compensated, seam_masks, final)
    sink.put("09_result.jpg", panorama)
    _dump_seam_viz(stitcher, sink, panorama, seam_masks, final)
    return panorama


# ---------------------------------------------------------------------------
# Stage dumpers
# ---------------------------------------------------------------------------

def _dump_features(stitcher, sink, imgs, feature_masks):
    finder = stitcher.detector
    if len(feature_masks) == 0:
        features = finder.detect(imgs)
    else:
        mask_objs = Images.of(
            list(feature_masks), stitcher.medium_megapix,
            stitcher.low_megapix, stitcher.final_megapix)
        masks = [Images.to_binary(m) for m in mask_objs.resize(_MEDIUM)]
        features = finder.detect_with_masks(imgs, masks)
    for idx, img_features in enumerate(features):
        sink.put(f"01_features_img{idx + 1}.jpg",
                 finder.draw_keypoints(imgs[idx], img_features))
    return features


def _dump_matches(stitcher, sink, imgs, features):
    matcher = stitcher.matcher
    matches = matcher.match_features(features)
    drawn = matcher.draw_matches_matrix(
        imgs, features, matches,
        conf_thresh=stitcher.subsetter.confidence_threshold, inliers=True)
    for idx1, idx2, img in drawn:
        sink.put(f"02_matches_img{idx1 + 1}_to_img{idx2 + 1}.jpg", img)
    return matches


def _dump_subset(stitcher, sink, images, imgs, features, matches):
    subsetter = stitcher.subsetter
    subsetter.save_file = sink.path("03_matches_graph.txt")
    subsetter.save_matches_graph_dot_file(images.names, matches)
    indices = subsetter.get_indices_to_keep(features, matches)
    images.subset(indices)
    return (subsetter.subset_list(imgs, indices),
            subsetter.subset_list(features, indices),
            subsetter.subset_matches(matches, indices))


def _warp_at(stitcher, images, cameras, medium_imgs, resolution):
    """Warp every image and mask at one resolution: a stage dict."""
    warper = stitcher.warper
    aspect = images.get_ratio(_MEDIUM, resolution)
    sizes = images.get_scaled_img_sizes(resolution)
    imgs = list(images.resize(resolution, medium_imgs))
    warped = list(warper.warp_images(imgs, cameras, aspect))
    masks = list(warper.create_and_warp_masks(sizes, cameras, aspect))
    corners, out_sizes = warper.warp_rois(sizes, cameras, aspect)
    return dict(imgs=warped, masks=masks, corners=corners, sizes=out_sizes)


def _dump_timelapse(sink, pattern, stage):
    timelapser = Timelapser("as_is")
    timelapser.initialize(stage["corners"], stage["sizes"])
    sink.put_frames(pattern, timelapser, stage["imgs"], stage["corners"])


def _dump_crop(stitcher, sink, images, low, final):
    cropper = stitcher.cropper
    mask = cropper.estimate_panorama_mask(
        low["imgs"], low["masks"], low["corners"], low["sizes"],
        device=cropper.device)
    sink.put("06_estimated_mask_to_crop.jpg", mask)
    lir = cropper.estimate_largest_interior_rectangle(mask)
    sink.put("06_lir.jpg", lir.draw_on(mask, size=2))

    low["corners"] = cropper.get_zero_center_corners(low["corners"])
    cropper.prepare(low["imgs"], low["masks"], low["corners"], low["sizes"])

    for stage, aspect in ((low, 1), (final, images.get_ratio(_LOW, _FINAL))):
        stage["masks"] = list(cropper.crop_images(stage["masks"], aspect))
        stage["imgs"] = list(cropper.crop_images(stage["imgs"], aspect))
        stage["corners"], stage["sizes"] = cropper.crop_rois(
            stage["corners"], stage["sizes"], aspect)


def _dump_seams(stitcher, sink, low, final):
    finder = stitcher.seam_finder
    seam_masks = finder.find(low["imgs"], low["corners"], low["masks"])
    seam_masks = [finder.resize(seam, mask, device=finder.device)
                  for seam, mask in zip(seam_masks, final["masks"])]
    for idx, (img, seam) in enumerate(zip(final["imgs"], seam_masks)):
        sink.put(f"08_seam_mask{idx + 1}.jpg",
                 SeamFinder.draw_seam_mask(img, seam))
    return seam_masks


def _dump_compensation(stitcher, sink, low, final):
    compensator = stitcher.compensator
    compensator.feed(low["corners"], low["imgs"], low["masks"])
    out = [compensator.apply(idx, corner, img, mask)
           for idx, (img, mask, corner) in enumerate(
               zip(final["imgs"], final["masks"], final["corners"]))]
    for idx, img in enumerate(out):
        sink.put(f"08_compensated{idx + 1}.jpg", img)
    return out


def _blend(stitcher, imgs, seam_masks, final):
    blender = stitcher.blender
    blender.prepare(final["corners"], final["sizes"])
    for img, mask, corner in zip(imgs, seam_masks, final["corners"]):
        blender.feed(img, mask, corner)
    panorama, _ = blender.blend()
    return panorama


def _dump_seam_viz(stitcher, sink, panorama, seam_masks, final):
    finder = stitcher.seam_finder
    blended = finder.blend_seam_masks(
        seam_masks, final["corners"], final["sizes"], device=finder.device)
    sink.put("09_result_with_seam_lines.jpg",
             finder.draw_seam_lines(panorama, blended, linesize=3))
    sink.put("09_result_with_seam_polygons.jpg",
             finder.draw_seam_polygons(panorama, blended))
