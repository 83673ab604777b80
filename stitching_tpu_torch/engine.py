"""The stitching engine: registration, planning and compositing.

Port of `stitching_tpu/engine.py`. The `Stitcher` facade
drives `run` (and `stitch_device` drives `run_device`), which is
register -> plan_composition -> composite, each a function over explicit
dataclasses (`Registration`, `CompositionPlan`) and stacks that stay on
the card. The stages are named for `profiling.stage_timer` as in the
reference; the port splits two of them further, `low/crop` into
`low/crop/paste`, `/flood_fill`, `/lir` and `/slice`, and each image of
`final/stream` into `final/upload_wait`, `final/stream/warp` and
`final/stream/feed`.

Registration keeps the reference's three branches (a mesh always takes
the sync one):

- async (downscaled registration, the production shape): the ORIGINAL
  upload starts at t=0 in the background (`transfer.Uploader`); a GRAY
  MEDIUM stack (the 8.8 fixed-point luma) and a colour LOW stack, made
  from each original as its upload lands (`_downscale_landed`), or for
  float views resized on the host and uploaded inside the uploader's
  yield lane; one batched detect + match and one host copy of the small
  results. The registration keeps the uploader, subset to the kept
  images, and no ORIGINAL stack;
- sync (inputs already at MEDIUM size, or a mesh): the originals upload
  once as one stack, which is also the MEDIUM stack that detection reads;
  larger inputs under a mesh resize to MEDIUM on the host first, and the
  originals upload after detection;
- prestaged (`prestaged`: a `pipeline.DeviceStack` of the originals
  already on the card): no image upload at all; MEDIUM is the stack
  resized on the card.

Compositing follows the reference's schedule too. The async branch plans
its FINAL pass once (`compose.FinalPlan`); when the streamed composite's
accumulators fit `compose.BLEND_BUDGET_BYTES` (`compose.stream_fits`),
the pass streams per image (`_composite_streamed`): each image warps,
crops, takes its gains and its seam mask (`compose.final_tile`) and feeds
the blend (`compose.StreamComposite`) as soon as its upload lands, and
the panorama collapses and copies to the host in bands. Otherwise one
batched pass: the FINAL warp (paced by the uploader where there is one),
crop, gains, seam masks and `blend_stack`, which takes strips or the
streamed monolithic blend over the budget. With timelapse the batched
pass writes one frame per image instead of blending.

Under a mesh (`Stitcher(mesh=)`, `parallel.mesh`; SPMD, every rank
called with the same inputs) each rank uploads, detects on, warps, crops,
gains and feeds its block of the images; detection and matching gather
their results, bundle adjustment sums its normal system over the ranks,
the LOW tiles are gathered for the exposure and seam planning (the same
on every rank), and the blend merges the ranks' accumulators. Every rank
returns the panorama; with timelapse only rank 0 writes the frames. The
streamed FINAL pass is single-rank.
"""

import concurrent.futures as cf
import dataclasses

import numpy as np
import torch

from . import compose
from . import profiling as prof
from .compose import (FinalPlan, StreamComposite, TileStack,
                      apply_gains_stack, blend_stack, crop_geometry,
                      fetch_image, final_tile, gather_tiles,
                      resize_seam_masks_stack, slice_stack, stream_fits,
                      warp_stack, warp_stack_streamed)
from .errors import StitchingError
from .images import Images
from .ops.kernels.downscale import downscale, resize_table
from .ops.resize import resize as _host_resize
from .parallel.mesh import all_gather_leading
from .pipeline import (empty_stack, match_stack_fetch, pad_batch,
                       pad_sizes, resize_stack, stack_images)
from .subsetter import Subsetter
from .transfer import Uploader
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
    # async branch: the originals streaming up in the background, and the
    # LOW stack made as they land
    uploader: object = None
    low_stack: object = None


@dataclasses.dataclass
class CompositionPlan:
    """LOW-pass products needed to composite at FINAL resolution."""

    seam_masks_low: tuple   # (masks (B, LH, LW) on the card, LOW sizes)
    crop_rects: list | None  # per-image Rectangle at LOW res, or None
    lir_aspect: float


# ---------------------------------------------------------------------------
# Registration
# ---------------------------------------------------------------------------

def _mesh_of(st):
    return getattr(st, "mesh", None)


def register(st, images, feature_masks=(), prestaged=None):
    """MEDIUM-resolution registration (see the module docstring)."""
    mesh = _mesh_of(st)
    images_obj = Images.of(
        images, st.medium_megapix, st.low_megapix, st.final_megapix)
    originals = [np.asarray(img) for img in images_obj]
    med_sizes = images_obj.get_scaled_img_sizes(Resolution.MEDIUM)
    orig_sizes = [(im.shape[1], im.shape[0]) for im in originals]
    same = list(map(tuple, med_sizes)) == orig_sizes
    if prestaged is None and mesh is None and not same:
        return _register_async(st, images_obj, originals, med_sizes,
                               feature_masks)
    return _register_sync(st, images_obj, originals, med_sizes, same,
                          feature_masks, prestaged, mesh)


def _register_sync(st, images_obj, originals, med_sizes, same,
                   feature_masks, prestaged=None, mesh=None):
    """One stack of the originals (uploaded here, or prestaged); MEDIUM is
    that stack, that stack resized on the card, or (a mesh, larger inputs)
    the host-resized images, with the originals uploaded after
    detection."""
    n = len(originals)
    with prof.stage_timer("registration/upload"):
        stack = None
        if prestaged is not None:
            stack = prestaged
            medium = stack if same else resize_stack(
                stack, pad_sizes(med_sizes, stack.batch))
        elif same:
            stack = stack_images(originals, st.device, mesh)
            medium = stack
        else:
            with prof.stage_timer("registration/resize_medium"):
                medium_imgs = [_host_resize(im, size)
                               for im, size in zip(originals, med_sizes)]
            medium = stack_images(medium_imgs, st.device, mesh)
    with prof.stage_timer("registration/detect"):
        masks_medium = _prepare_feature_masks(st, feature_masks, medium, n)
        features = st.detector.detect_on_stack(medium, masks_medium)[:n]
    if stack is None:
        # the originals upload only now: detection's small upload and its
        # copy back go first
        with prof.stage_timer("registration/upload"):
            stack = stack_images(originals, st.device, mesh)
    with prof.stage_timer("registration/match"):
        matches = st.matcher.match_features(features, mesh=mesh)
    with prof.stage_timer("registration/subset"):
        indices, features, matches = _subset(st, images_obj, features,
                                             matches)
        if len(indices) < n:
            stack = _subset_stack(stack, indices, mesh)
    return _register_cameras(st, images_obj, stack, features, matches, mesh)


def _register_async(st, images_obj, originals, med_sizes, feature_masks):
    """Downscaled registration: the ORIGINAL upload streams from t=0; the
    gray MEDIUM + colour LOW stacks are made as the originals land, or for
    float views on the host and uploaded inside its yield lane; one batched
    detect + match, one host copy of the results."""
    n = len(originals)
    low_sizes = images_obj.get_scaled_img_sizes(Resolution.LOW)
    uploader = Uploader(originals, device=st.device)
    landed = _downscalable(originals)
    with prof.stage_timer("registration/resize_medium"):
        if landed:
            medium, low_stack = _downscale_landed(uploader, originals,
                                                  med_sizes, low_sizes,
                                                  st.device)
        else:
            med_gray, low_imgs = _host_downscale(originals, med_sizes,
                                                 low_sizes)
    with uploader.yield_lane():
        with prof.stage_timer("registration/upload"):
            if not landed:
                medium = stack_images(med_gray, st.device)
                low_stack = stack_images(low_imgs, st.device)
            prof.fence(medium.data, low_stack.data)
        with prof.stage_timer("registration/detect"):
            masks_medium = _prepare_feature_masks(st, feature_masks, medium,
                                                  n)
            feats_dev = st.detector.detect_on_stack_dispatch(medium,
                                                             masks_medium)
            prof.fence(feats_dev)
        with prof.stage_timer("registration/match_dispatch"):
            pair_ij, chunks = st.matcher.match_stacked_dispatch(
                {k: feats_dev[k] for k in ("desc", "valid", "xy")},
                np.asarray(med_sizes, np.float32), st.detector.is_binary,
                n_images=n)
    with prof.stage_timer("registration/match"):
        # the registration's one host copy: detection fields + matches
        small = {k: feats_dev[k].cpu().numpy()
                 for k in ("xy", "response", "size", "angle_deg", "valid")}
        features = st.detector.features_from_host(
            feats_dev["desc"], small, med_sizes)
        res = match_stack_fetch(chunks) if chunks is not None else None
        matches = st.matcher.matches_from_host(pair_ij, res, n)
    with prof.stage_timer("registration/subset"):
        indices, features, matches = _subset(st, images_obj, features,
                                             matches)
        if len(indices) < n:
            uploader.subset(indices)
            low_stack = _subset_stack(low_stack, indices)
    return _register_cameras(st, images_obj, None, features, matches,
                             uploader=uploader, low_stack=low_stack)


def _subset(st, images_obj, features, matches):
    indices = st.subsetter.subset(images_obj.names, features, matches)
    features = Subsetter.subset_list(features, indices)
    matches = Subsetter.subset_matches(matches, indices)
    images_obj.subset(indices)
    return indices, features, matches


def _register_cameras(st, images_obj, stack, features, matches, mesh=None,
                      uploader=None, low_stack=None):
    """Shared tail: estimate -> bundle-adjust -> wave-correct -> scale."""
    with prof.stage_timer("registration/estimate"):
        cameras = st.camera_estimator.estimate(features, matches)
    with prof.stage_timer("registration/bundle_adjust"):
        st.camera_adjuster.mesh = mesh
        cameras = st.camera_adjuster.adjust(features, matches, cameras)
    with prof.stage_timer("registration/wave_correct"):
        cameras = st.wave_corrector.correct(cameras)
    st.warper.set_scale(cameras)
    return Registration(images_obj, stack, features, matches, cameras,
                        st.warper.scale, uploader=uploader,
                        low_stack=low_stack)


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


def _downscalable(originals):
    """Whether the async branch makes its stacks as the originals land
    (`_downscale_landed`): for uint8 views of one plane or three channels,
    the views `downscale` takes, on every device. Float views take
    `_host_downscale`; a mesh never takes the async branch."""
    return all(im.dtype == np.uint8
               and (im.ndim == 2 or im.ndim == 3 and im.shape[2] == 3)
               for im in originals)


def _downscale_landed(uploader, originals, med_sizes, low_sizes, device):
    """`_host_downscale`'s images as the stacks `stack_images` makes of
    them, made where the originals land: each view is downscaled
    (`ops/kernels/downscale.py`: the kernel on the card, its plain version
    on the CPU) into its slots once `uploader` has it on the device, while
    the later views keep uploading."""
    chans = 3 if any(im.ndim == 3 for im in originals) else 1
    medium = empty_stack(med_sizes, 1, device)
    low = empty_stack(low_sizes, chans, device)
    tables = [resize_table(im.shape[:2], size)
              for im, m, lo in zip(originals, med_sizes, low_sizes)
              for size in (m, lo)]
    tables = torch.from_numpy(np.concatenate(tables)).to(device).split(
        [len(t) for t in tables])
    for i in range(len(originals)):
        downscale(uploader.image(i), medium.data[i], med_sizes[i],
                  tables[2 * i], low.data[i], low_sizes[i], tables[2 * i + 1])
    return medium, low


def _subset_stack(stack, indices, mesh=None):
    """Gather the kept images of a stack. Under a mesh the kept images are
    re-padded to the mesh size (padded slots duplicate the last kept image
    at size (1, 1)) and re-distributed: every rank gathers the stack and
    keeps its new block."""
    idx = list(indices)
    b2 = pad_batch(len(idx), mesh)
    idx_full = idx + [idx[-1]] * (b2 - len(idx))
    sizes = np.ones((b2, 2), stack.sizes.dtype)
    sizes[:len(idx)] = stack.sizes[np.asarray(idx)]
    if mesh is None:
        data = stack.data[np.asarray(idx_full)]
    else:
        lo, hi = mesh.block(b2)
        data = all_gather_leading(stack.data, mesh)[
            np.asarray(idx_full[lo:hi])]
    return dataclasses.replace(stack, data=data, sizes=sizes)


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

def _geometry(reg, resolution):
    """Target sizes, Ks, Rs and canvas scale of every image at
    `resolution`."""
    sizes = reg.images.get_scaled_img_sizes(resolution)
    aspect = reg.images.get_ratio(Resolution.MEDIUM, resolution)
    Ks = [Warper.get_K(cam, aspect) for cam in reg.cameras]
    Rs = [cam.R for cam in reg.cameras]
    return sizes, Ks, Rs, reg.scale * aspect


def warp_resolution(st, reg: Registration, resolution,
                    final=None) -> TileStack:
    """Warp every image onto the compositing surface at `resolution`.

    Async branch: LOW warps the LOW stack made at registration; FINAL
    warps each image as its upload lands, into the ROIs of `final` (the
    pass's `compose.FinalPlan`). Otherwise the ORIGINAL stack resized on
    the card, in one batched pass."""
    if reg.uploader is not None and resolution == Resolution.FINAL:
        return warp_stack_streamed(reg.uploader, final)
    sizes, Ks, Rs, scale = _geometry(reg, resolution)
    wt = st.warper.warper_type
    src = reg.low_stack
    if reg.uploader is None:
        src = resize_stack(reg.stack, pad_sizes(sizes, reg.stack.batch))
    return warp_stack(src.data, src.sizes, Ks, Rs, scale, wt, src.mesh)


def _crop_tiles(ts: TileStack, cropper, aspect) -> TileStack:
    """Apply the prepared cropper's per-image rects at `aspect` scale."""
    rects, corners, sizes = crop_geometry(cropper, aspect, ts.corners,
                                          ts.sizes)
    return dataclasses.replace(slice_stack(ts, rects), corners=corners,
                               sizes=sizes)


def plan_composition(st, reg: Registration) -> CompositionPlan:
    """The LOW pass: warp, crop planning, exposure feed and seam search.

    Under a mesh each rank warps and crops its block and the crop's paste
    mask merges over the ranks; the small LOW tiles are then gathered, so
    every rank plans the same gains and seam masks from the whole set."""
    with prof.stage_timer("low/warp"):
        low = warp_resolution(st, reg, Resolution.LOW)
        prof.fence(low.data, low.masks)
    with prof.stage_timer("low/crop"):
        if st.cropper.do_crop:
            with prof.stage_timer("low/crop/paste"):
                _, pano_mask = blend_stack(low, None, "no", 0,
                                           budget=compose.BLEND_BUDGET_BYTES)
                prof.fence(pano_mask)
            st.cropper.prepare_from_mask(
                pano_mask, [tuple(c) for c in low.corners],
                [tuple(s) for s in low.sizes])
            with prof.stage_timer("low/crop/slice"):
                low = _crop_tiles(low, st.cropper, 1)
        lir_aspect = reg.images.get_ratio(Resolution.LOW, Resolution.FINAL)
        if low.mesh is not None:
            full = gather_tiles(low)
            n = len(low.sizes)
            low = dataclasses.replace(full, data=full.data[:n],
                                      masks=full.masks[:n])
    with prof.stage_timer("low/exposure_feed"):
        st.compensator.feed_stack([tuple(c) for c in low.corners], low)
    with prof.stage_timer("low/seam_find"):
        seam_masks = st.seam_finder.find_stack(low)
        prof.fence(seam_masks)
    return CompositionPlan(
        (seam_masks, np.asarray(low.sizes)),
        st.cropper.intersection_rectangles if st.cropper.do_crop else None,
        lir_aspect)


def composite(st, reg: Registration, plan: CompositionPlan, fetch=True):
    """FINAL-resolution compositing: the panorama as a uint8 host array,
    or with fetch=False as a uint8 tensor on the card; None with
    timelapse, which writes one frame per image instead."""
    mesh = _mesh_of(st)
    final = None
    if reg.uploader is not None:
        # the async branch (never under a mesh) plans its FINAL pass once
        with prof.stage_timer("final/plan"):
            final = FinalPlan(
                *_geometry(reg, Resolution.FINAL), st.warper.warper_type,
                st.cropper if plan.crop_rects is not None else None,
                plan.lir_aspect, st.compensator, plan.seam_masks_low,
                st.blender.blender_type, st.blender.blend_strength,
                reg.uploader.channels)
        if (not st.timelapser.do_timelapse
                and stream_fits(final.blend, final.channels)):
            pano = _composite_streamed(reg, final)
            return pano if fetch else torch.as_tensor(pano, device=st.device)
    with prof.stage_timer("final/warp"):
        fin = warp_resolution(st, reg, Resolution.FINAL, final)
        prof.fence(fin.data, fin.masks)
        # the originals have no further consumers: free them before the
        # blend allocates
        reg.stack = None
        reg.uploader = None
        reg.low_stack = None
    with prof.stage_timer("final/crop"):
        if plan.crop_rects is not None:
            fin = _crop_tiles(fin, st.cropper, plan.lir_aspect)

    if st.timelapser.do_timelapse:
        with prof.stage_timer("final/timelapse"):
            # under a mesh every rank gathers the tiles and rank 0 writes,
            # so that no file has two writers
            fin = gather_tiles(fin)
            if mesh is not None and mesh.rank != 0:
                return None
            corners = [tuple(c) for c in fin.corners]
            st.timelapser.initialize(corners, [tuple(s) for s in fin.sizes])
            imgs, _ = fin.to_host()
            for name, img, corner in zip(reg.images.names, imgs, corners):
                st.timelapser.process_and_save_frame(name, img, corner)
        return None

    with prof.stage_timer("final/gain_apply"):
        fin = apply_gains_stack(fin, st.compensator)
        prof.fence(fin.data)
    with prof.stage_timer("final/seam_resize"):
        seams = resize_seam_masks_stack(plan.seam_masks_low, fin)
        prof.fence(seams)
    with prof.stage_timer("final/blend"):
        # over the budget the blend may stream its copy to the host in
        # bands (without a mesh): a host array, which fetch_image passes
        # through
        pano, _ = blend_stack(fin, seams, st.blender.blender_type,
                              st.blender.blend_strength,
                              stream_fetch=fetch,
                              budget=compose.BLEND_BUDGET_BYTES)
        prof.fence(pano)
    if not fetch:
        return pano
    with prof.stage_timer("final/download"):
        return fetch_image(pano)


def _composite_streamed(reg: Registration, final):
    """The FINAL pass per image (async branch), on its plan `final`.

    Each image's tile and seam (`final_tile`) are made and fed to the
    blend as soon as its upload lands (`Uploader.image`), through the
    batched stages' own per-image code, so the panorama equals the batched
    pass's; after the last image only its feed, the banded collapse and
    the copy to the host remain. Returns the host panorama."""
    dev = final.seams_low.device
    with prof.stage_timer("final/stream"):
        # the column-frontier copy overlaps the card's work with the
        # panorama's trip to the host; on the CPU there is nothing to
        # overlap
        stream = StreamComposite(final.blend, final.channels,
                                 frontier_fetch=dev.type == "cuda",
                                 device=dev)
        for i in range(len(final.sizes)):
            with prof.stage_timer("final/upload_wait"):
                raw = reg.uploader.image(i)
            with prof.stage_timer("final/stream/warp"):
                tile, seam = final_tile(final, i, raw)
                prof.fence(tile, seam)
            with prof.stage_timer("final/stream/feed"):
                stream.feed(i, tile[0], seam[0])
                prof.fence(stream.state)
        # the originals have no further consumers
        reg.uploader = None
        reg.low_stack = None
    with prof.stage_timer("final/blend"):
        # the copy engine lands the bands in one pinned host panorama; the
        # weight mask is not wanted, so none is made or fetched
        pano, _ = stream.finish(stream_fetch=True, mask=False)
    return pano


def run(st, images, feature_masks=()):
    """The full pipeline: register -> plan -> composite."""
    reg = register(st, images, feature_masks)
    plan = plan_composition(st, reg)
    return composite(st, reg, plan)


def run_device(st, images, feature_masks=(), prestaged=None):
    """The device-resident pipeline: the originals on the card (prestaged,
    or staged here with one upload), the panorama returned as a uint8
    tensor on the card. `prestaged`: a `pipeline.DeviceStack` of the
    ORIGINAL-resolution images (a padded batch is allowed); under a mesh,
    this rank's block (`pipeline.stack_images(images, mesh=m)`). Copy the
    result on demand with `compose.fetch_image`."""
    if prestaged is None:
        prestaged = stack_images([np.asarray(im) for im in images],
                                 st.device, _mesh_of(st))
    reg = register(st, images, feature_masks, prestaged=prestaged)
    plan = plan_composition(st, reg)
    return composite(st, reg, plan, fetch=False)
