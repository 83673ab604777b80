"""The batched stitching engine: registration, planning and compositing.

Port of `stitching_tpu/engine.py` for the ported slices: the `Stitcher` facade
drives `run`, which is register -> plan_composition -> composite, each a
function over explicit dataclasses (`Registration`, `CompositionPlan`) and
stacks that stay on the card.

Registration keeps the reference's branch rule (`same`: are the MEDIUM
sizes the original sizes?):

- sync (`same`): the originals upload once as one stack, which is also the
  MEDIUM stack that detection reads;
- otherwise the reference's transfer-scheduled numerics, without its
  background uploader: a GRAY MEDIUM stack from the host 8.8 fixed-point
  conversion (`_host_downscale`), a colour LOW stack from the host resize,
  one batched detect + match, and one host copy of the small results.
  The originals upload after subsetting, for the FINAL pass.

Compositing is the batched path only. The reference's streamed FINAL pass
is documented there as bit-identical to its batched one.
"""

import concurrent.futures as cf
import dataclasses

import numpy as np

from .compose import (TileStack, apply_gains_stack, blend_stack, fetch_image,
                      resize_seam_masks_stack, slice_stack, warp_stack)
from .errors import StitchingError
from .images import Images
from .ops.resize import resize as _host_resize
from .pipeline import match_stack_fetch, resize_stack, stack_images
from .subsetter import Subsetter
from .warper import Warper

Resolution = Images.Resolution


@dataclasses.dataclass
class Registration:
    """Everything the registration pass decides."""

    images: object          # Images (subset applied)
    stack: object           # DeviceStack of ORIGINAL-resolution images
    features: list
    matches: list
    cameras: list
    scale: float            # canvas scale (median focal)
    low_stack: object = None  # host-resized LOW stack (async branch)


@dataclasses.dataclass
class CompositionPlan:
    """LOW-pass products needed to composite at FINAL resolution."""

    seam_masks_low: tuple   # (masks (B, LH, LW) on the card, LOW sizes)
    crop_rects: list | None  # per-image Rectangle at LOW res, or None
    lir_aspect: float


# ---------------------------------------------------------------------------
# Registration
# ---------------------------------------------------------------------------

def register(st, images, feature_masks=()):
    """MEDIUM-resolution registration (see the module docstring)."""
    images_obj = Images.of(
        images, st.medium_megapix, st.low_megapix, st.final_megapix)
    originals = [np.asarray(img) for img in images_obj]
    med_sizes = images_obj.get_scaled_img_sizes(Resolution.MEDIUM)
    orig_sizes = [(im.shape[1], im.shape[0]) for im in originals]
    if list(map(tuple, med_sizes)) == orig_sizes:
        return _register_sync(st, images_obj, originals, feature_masks)
    return _register_async(st, images_obj, originals, med_sizes,
                           feature_masks)


def _register_sync(st, images_obj, originals, feature_masks):
    """One stack serves as MEDIUM and ORIGINAL (inputs already at MEDIUM
    size)."""
    n = len(originals)
    stack = stack_images(originals, st.device)
    masks_medium = _prepare_feature_masks(st, feature_masks, stack, n)
    features = st.detector.detect_on_stack(stack, masks_medium)[:n]
    matches = st.matcher.match_features(features)
    indices, features, matches = _subset(st, images_obj, features, matches)
    if len(indices) < n:
        stack = _subset_stack(stack, indices)
    return _register_cameras(st, images_obj, stack, features, matches)


def _register_async(st, images_obj, originals, med_sizes, feature_masks):
    """Downscaled registration: gray MEDIUM + colour LOW host stacks, one
    batched detect + match, one host copy of the results."""
    n = len(originals)
    low_sizes = images_obj.get_scaled_img_sizes(Resolution.LOW)
    med_gray, low_imgs = _host_downscale(originals, med_sizes, low_sizes)
    medium = stack_images(med_gray, st.device)
    low_stack = stack_images(low_imgs, st.device)
    masks_medium = _prepare_feature_masks(st, feature_masks, medium, n)
    feats_dev = st.detector.detect_on_stack_dispatch(medium, masks_medium)
    pair_ij, chunks = st.matcher.match_stacked_dispatch(
        {k: feats_dev[k] for k in ("desc", "valid", "xy")},
        np.asarray(med_sizes, np.float32), st.detector.is_binary,
        n_images=n)
    small = {k: feats_dev[k].cpu().numpy()
             for k in ("xy", "response", "size", "angle_deg", "valid")}
    features = st.detector.features_from_host(
        feats_dev["desc"], small, med_sizes)
    res = match_stack_fetch(chunks) if chunks is not None else None
    matches = st.matcher.matches_from_host(pair_ij, res, n)
    indices, features, matches = _subset(st, images_obj, features, matches)
    if len(indices) < n:
        low_stack = _subset_stack(low_stack, indices)
    stack = stack_images([originals[i] for i in indices], st.device)
    return _register_cameras(st, images_obj, stack, features, matches,
                             low_stack=low_stack)


def _subset(st, images_obj, features, matches):
    indices = st.subsetter.subset(images_obj.names, features, matches)
    features = Subsetter.subset_list(features, indices)
    matches = Subsetter.subset_matches(matches, indices)
    images_obj.subset(indices)
    return indices, features, matches


def _register_cameras(st, images_obj, stack, features, matches,
                      low_stack=None):
    """Shared tail: estimate -> bundle-adjust -> wave-correct -> scale."""
    cameras = st.camera_estimator.estimate(features, matches)
    cameras = st.camera_adjuster.adjust(features, matches, cameras)
    cameras = st.wave_corrector.correct(cameras)
    st.warper.set_scale(cameras)
    return Registration(images_obj, stack, features, matches, cameras,
                        st.warper.scale, low_stack=low_stack)


def _host_downscale(originals, med_sizes, low_sizes):
    """Threaded host downscales: GRAY at MEDIUM (detection reads luma only)
    and COLOR at LOW (planning input).

    Gray uses the BT.601 weights of the device path in 8.8 fixed point,
    off by at most 1 LSB from the float formula; converting before the
    resize makes the MEDIUM resize single-channel (both are linear).
    """
    def gray_med(im, size):
        if im.ndim == 3:
            im16 = im.astype(np.uint16)
            im = ((29 * im16[..., 0] + 150 * im16[..., 1]
                   + 77 * im16[..., 2] + 128) >> 8).astype(np.uint8)
        return _host_resize(im, size)

    with cf.ThreadPoolExecutor(max_workers=2) as pool:
        med = pool.map(gray_med, originals, med_sizes)
        low = pool.map(_host_resize, originals, low_sizes)
        return list(med), list(low)


def _pad_sizes(sizes, b):
    out = np.ones((b, 2), np.int32)
    out[:len(sizes)] = np.asarray(sizes, np.int32)
    return out


def _subset_stack(stack, indices):
    """Gather the kept images of a stack."""
    idx = np.asarray(list(indices))
    data = stack.data[idx]
    return dataclasses.replace(stack, data=data, sizes=stack.sizes[idx])


def _prepare_feature_masks(st, feature_masks, medium_stack, n):
    """Resize user feature masks to MEDIUM and validate sizes."""
    if not feature_masks or len(feature_masks) == 0:
        return None
    masks_obj = Images.of(list(feature_masks), st.medium_megapix,
                          st.low_megapix, st.final_megapix)
    masks = [Images.to_binary(m)
             for m in masks_obj.resize(Resolution.MEDIUM)]
    if len(masks) != n:
        raise StitchingError("image and mask lists must be of same length")
    for idx, m in enumerate(masks):
        w, h = medium_stack.sizes[idx]
        if m.shape[0] != h or m.shape[1] != w:
            raise StitchingError(
                f"Resolution of mask {idx + 1} {m.shape} does not match"
                f" the resolution of image {idx + 1} {(h, w)}.")
    return masks


# ---------------------------------------------------------------------------
# Warping, planning, compositing
# ---------------------------------------------------------------------------

def warp_resolution(st, reg: Registration, resolution) -> TileStack:
    """Warp every image onto the compositing surface at `resolution`: the
    host-resized LOW stack where registration made one, otherwise the
    ORIGINAL stack resized on the card."""
    sizes = reg.images.get_scaled_img_sizes(resolution)
    aspect = reg.images.get_ratio(Resolution.MEDIUM, resolution)
    Ks = [Warper.get_K(cam, aspect) for cam in reg.cameras]
    Rs = [cam.R for cam in reg.cameras]
    scale = reg.scale * aspect
    if resolution == Resolution.LOW and reg.low_stack is not None:
        src = reg.low_stack
    else:
        src = resize_stack(reg.stack, _pad_sizes(sizes, reg.stack.batch))
    return warp_stack(src.data, src.sizes, Ks, Rs, scale,
                      st.warper.warper_type)


def _crop_tiles(ts: TileStack, cropper, aspect) -> TileStack:
    """Apply the prepared cropper's per-image rects at `aspect` scale."""
    rects = [r.times(aspect) for r in cropper.intersection_rectangles]
    corners, sizes = cropper.crop_rois(
        [tuple(c) for c in ts.corners],
        [tuple(s) for s in ts.sizes], aspect)
    out = slice_stack(ts, [tuple(r) for r in rects])
    return dataclasses.replace(out, corners=np.asarray(corners),
                               sizes=np.asarray(sizes, np.int64))


def plan_composition(st, reg: Registration) -> CompositionPlan:
    """The LOW pass: warp, crop planning, exposure feed and seam search."""
    low = warp_resolution(st, reg, Resolution.LOW)
    if st.cropper.do_crop:
        _, pano_mask = blend_stack(low, None, "no", 0)
        st.cropper.prepare_from_mask(
            pano_mask, [tuple(c) for c in low.corners],
            [tuple(s) for s in low.sizes])
        low = _crop_tiles(low, st.cropper, 1)
    lir_aspect = reg.images.get_ratio(Resolution.LOW, Resolution.FINAL)
    st.compensator.feed_stack([tuple(c) for c in low.corners], low)
    seam_masks = st.seam_finder.find_stack(low)
    return CompositionPlan(
        (seam_masks, np.asarray(low.sizes)),
        st.cropper.intersection_rectangles if st.cropper.do_crop else None,
        lir_aspect)


def composite(st, reg: Registration, plan: CompositionPlan):
    """FINAL-resolution compositing; the panorama as a uint8 host array."""
    fin = warp_resolution(st, reg, Resolution.FINAL)
    # the originals have no further consumers: free them before the blend
    reg.stack = None
    reg.low_stack = None
    if plan.crop_rects is not None:
        fin = _crop_tiles(fin, st.cropper, plan.lir_aspect)
    # gains apply before the seam masks are resized against the tiles
    fin = apply_gains_stack(fin, st.compensator)
    seams = resize_seam_masks_stack(plan.seam_masks_low, fin)
    pano, _ = blend_stack(fin, seams, st.blender.blender_type,
                          st.blender.blend_strength)
    return fetch_image(pano)


def run(st, images, feature_masks=()):
    """The full pipeline: register -> plan -> composite."""
    reg = register(st, images, feature_masks)
    plan = plan_composition(st, reg)
    return composite(st, reg, plan)
