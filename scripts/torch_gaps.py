"""Measure the gaps between the PyTorch port and the JAX package on the
CPU, the figures ROADMAP queue 3 states for the surfaces, the scalar
gains, the graph-cut seams and the affine family:

    JAX_PLATFORMS=cpu python scripts/torch_gaps.py

1. every surface's warp of the LOW rotation fixture (the tests' cases in
   `tests/test_torch_surfaces.py`): ROIs, mask agreement, the share of
   care-pixel values more than 2e-3 apart and the largest gap;
2. the default `Stitcher` with one setting changed, composited by both
   packages with the reference's cameras: share of panorama values equal
   and within 1 LSB;
3. `AffineStitcher(crop=False)` on `fixtures.affine_set` with the
   reference's features and matches, and the offsets of its own
   registration against the reference's;
4. the affine chain's drift on a scan of 8 translated crops
   (`chip_smoke.scan_set`) at reduced sizes, in both packages: each crop's
   recovered position (relative to the tree center's) against the truth.

Takes a few minutes on a few CPU cores.
"""

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import stitching_tpu  # noqa: E402
from fixtures import affine_set, rotation_set  # noqa: E402
from stitching_tpu import compose as jc  # noqa: E402
from stitching_tpu import engine as je  # noqa: E402
from stitching_tpu_torch import (AffineStitcher, Stitcher, compose,  # noqa: E402
                                 convert, engine)
from test_torch_slice2 import _features_and_matches  # noqa: E402
from test_torch_surfaces import (OTHER_SURFACES, affine_case,  # noqa: E402
                                 rotation_case)


def surfaces():
    cases = {"rotation": rotation_case(), "affine": affine_case()}
    for surface in OTHER_SURFACES + ["spherical"]:
        data, sizes, Ks, Rs, scale = cases["affine" if surface == "affine"
                                           else "rotation"]
        ref = jc.warp_stack(data, sizes, Ks, Rs, scale, surface)
        got = compose.warp_stack(torch.tensor(data), sizes, Ks, Rs, scale,
                                 surface)
        roi = (np.array_equal(got.corners, ref.corners)
               and np.array_equal(got.sizes, ref.sizes))
        m, rm = got.masks.numpy(), np.asarray(ref.masks)
        care = (m > 0) & (rm > 0)
        d = np.abs(got.data.numpy()[care] - np.asarray(ref.data)[care])
        print(f"{surface:30s} rois equal {roi}, masks equal "
              f"{(m == rm).mean():.6f}, care values {d.size}, over 2e-3 "
              f"{(d > 2e-3).sum()} (share {(d > 2e-3).mean():.2e}), "
              f"largest {d.max():.3g}", flush=True)


def panorama_stats(pano, ref):
    if pano.shape != ref.shape:
        return f"shapes {pano.shape} and {ref.shape}"
    d = np.abs(pano.astype(np.int16) - ref.astype(np.int16))
    return (f"shape {pano.shape}, largest gap {d.max()}, within 1 LSB "
            f"{(d <= 1).mean():.6f}, equal {(d == 0).mean():.6f} "
            f"({(d > 1).sum()} of {d.size} values over 1 LSB)")


def settings_end_to_end():
    imgs, _, _ = rotation_set(n=3, size=(640, 480))
    jreg = je.register(stitching_tpu.Stitcher(), imgs)
    for extra in (dict(compensator="gain"),
                  dict(compensator="channel", nr_feeds=2),
                  dict(finder="gc_color"), dict(finder="gc_colorgrad"),
                  dict(warper_type="cylindrical"),
                  dict(warper_type="transverseMercator"),
                  dict(warper_type="paniniA1.5B1")):
        if "finder" in extra:
            # the reference's jitted graph cut fails on a second call once
            # another of its variants has compiled
            jax.clear_caches()
        st_ref = stitching_tpu.Stitcher(**extra)
        reg_ref = copy.copy(jreg)
        st_ref.warper.set_scale(reg_ref.cameras)
        ref = je.composite(st_ref, reg_ref,
                           je.plan_composition(st_ref, reg_ref))
        cams = reg_ref.cameras
        st = Stitcher(device="cpu", **extra)
        reg = engine.register(st, imgs)
        reg.cameras = convert.cameras_from_numpy(
            [c.focal for c in cams], [c.aspect for c in cams],
            [c.ppx for c in cams], [c.ppy for c in cams],
            [np.asarray(c.R) for c in cams])
        st.warper.set_scale(reg.cameras)
        reg.scale = st.warper.scale
        pano = engine.composite(st, reg, engine.plan_composition(st, reg))
        print(f"{extra}: {panorama_stats(pano, ref)}", flush=True)


def affine_end_to_end():
    imgs, _ = affine_set(n=3)
    st_ref = stitching_tpu.AffineStitcher(crop=False)
    reg_ref = je.register(st_ref, imgs)
    feats, matches = _features_and_matches(reg_ref)
    ref = je.composite(st_ref, reg_ref, je.plan_composition(st_ref, reg_ref))
    st = AffineStitcher(crop=False, device="cpu")
    own = engine.register(st, imgs)
    reg = engine._register_cameras(st, own.images, own.stack, feats,
                                   matches, uploader=own.uploader,
                                   low_stack=own.low_stack)
    pano = engine.composite(st, reg, engine.plan_composition(st, reg))
    gap = max(float(np.abs(a.R - b.R).max())
              for a, b in zip(reg.cameras, reg_ref.cameras))
    print(f"AffineStitcher(crop=False), the reference's features and "
          f"matches: cameras within {gap:.2e}; {panorama_stats(pano, ref)}",
          flush=True)
    own = engine.register(AffineStitcher(crop=False, device="cpu"), imgs)
    off = max(float(np.abs(np.asarray(a.R)[:2, 2]
                           - np.asarray(b.R)[:2, 2]).max())
              for a, b in zip(own.cameras, reg_ref.cameras))
    print(f"AffineStitcher, own registration: offsets within {off:.3g} px "
          "of the reference's", flush=True)


def positions(cameras, offsets, size, ms):
    """Each crop's recovered position relative to the tree center's,
    against the truth: largest error per crop (full-resolution px)."""
    Rs = [np.asarray(c.R, np.float64) for c in cameras]
    c = int(np.argmin([np.abs(R[:2, 2]).sum() for R in Rs]))
    ctr = np.array([size[0] / 2, size[1] / 2]) * ms
    got = np.asarray([np.linalg.solve(R[:2, :2], ctr - R[:2, 2]) / ms
                      for R in Rs])
    true = np.asarray(offsets, np.float64)
    return c, np.abs((got - got[c]) - (true - true[c])).max(1)


def affine_drift():
    for size in ((800, 600), (1000, 750)):
        scan, offsets = chip_smoke.scan_set(8, size)
        ms = min(1.0, (0.6e6 / (size[0] * size[1])) ** 0.5)
        for name, cams in (
                ("JAX ", je.register(stitching_tpu.AffineStitcher(),
                                     scan).cameras),
                ("port", engine.register(AffineStitcher(device="cpu"),
                                         scan).cameras)):
            c, err = positions(cams, offsets, size, ms)
            print(f"scan of 8 x {size[0]}x{size[1]}, {name}: center {c}, "
                  f"position errors {np.round(err, 3).tolist()} px",
                  flush=True)


if __name__ == "__main__":
    torch.set_num_threads(4)
    surfaces()
    settings_end_to_end()
    affine_end_to_end()
    affine_drift()
