"""`Stitcher(mesh=)` and `AffineStitcher(mesh=)` end to end on two gloo
ranks, 3 images (so the second rank holds a padded slot).

`rotation_set(n=3)` is at MEDIUM size, so the unsharded port takes the
sync branch too; one case lowers `medium_megapix` to take the mesh's
host MEDIUM resize. Each rank calls the entry points with the same inputs;
the bundle solve sums its normal system over the ranks, which moves the
cameras in the last bits (focal 2e-6 relative here), and a camera that
moves by that much moves a steep edge of the panorama by several LSB. So
the compositing is held at equal cameras. Tolerances:

- every rank returns the same panorama, bit for bit, and the same crop
  rects; `stitch_device` returns `stitch`'s panorama as a uint8 tensor;
- features (keypoints, descriptors) and matches (confidences, H,
  inliers) equal the unsharded port run's;
- cameras within 1e-4 of the unsharded run's (focal relative, R);
- the panorama, `crop=False` and with the default crop, has the unsharded
  sync branch's shape and crop rects given the mesh run's cameras, every
  value within 1 LSB and at least 99.9% equal;
- with the JAX package's cameras handed over (as
  `test_torch_slice6.py::test_gray_defaults_with_jax_cameras` does), the
  `crop=False` panorama is within 1 LSB of `stitching_tpu.Stitcher(
  crop=False)`'s, at least 99.9% equal;
- inputs over the MEDIUM size (`medium_megapix=0.1`, the host resize to
  MEDIUM with the originals uploaded after detection): MEDIUM sizes,
  keypoints and feature scales equal the JAX package's mesh run
  (`stitching_tpu.Stitcher(mesh=make_mesh(1))`, the same branch),
  descriptors within the stated ORB gap (at most 3% of rows differ),
  cameras within 1e-2 (focal relative, R) of it;
- `AffineStitcher(mesh=)` on `affine_set(n=3)` the same way against the
  unsharded `AffineStitcher` at the mesh run's cameras;
- a noise image among the inputs: the subset's three images re-pad to
  four slots over the ranks, and the panorama is held as above;
- timelapse: only rank 0 writes the three frames, each within 1 LSB of
  the unsharded run's frame at the mesh run's cameras, at least 99.9%
  equal, and `stitch` returns None on both ranks.
"""

import dataclasses
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

from fixtures import affine_set, rotation_set
from stitching_tpu_torch import (AffineStitcher, Stitcher, convert, engine,
                                 io, timelapser)
from stitching_tpu_torch.errors import StitchingError, StitchingWarning
from stitching_tpu_torch.parallel import mesh as pmesh
from test_torch_mesh import run_ranks

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)


def _with_cameras(st, reg, cams):
    reg = dataclasses.replace(reg, cameras=[c.copy() for c in cams])
    st.warper.set_scale(reg.cameras)
    reg.scale = st.warper.scale
    return reg


def _composite(st, imgs, cams=None):
    """register -> (cameras handed over) -> plan -> composite: the
    panorama, the registration and the crop rects."""
    reg = engine.register(st, imgs)
    if cams is not None:
        reg = _with_cameras(st, reg, cams)
    plan = engine.plan_composition(st, reg)
    rects = (None if plan.crop_rects is None
             else [tuple(int(v) for v in r) for r in plan.crop_rects])
    return engine.composite(st, reg, plan), reg, rects


def _summary(reg):
    return dict(
        xy=[np.asarray(f.xy) for f in reg.features],
        desc=[f.desc.numpy() for f in reg.features],
        conf=[m.confidence for m in reg.matches],
        H=[m.H for m in reg.matches],
        inliers=[np.asarray(m.inliers_mask) for m in reg.matches],
        cams=[c.copy() for c in reg.cameras])


def stitch_rank(mesh, inputs):
    imgs, scan, jax_cams, frame_dir = inputs
    out = {}
    out["stitch"] = Stitcher(mesh=mesh, crop=False).stitch(imgs)
    dev = Stitcher(mesh=mesh, crop=False).stitch_device(imgs)
    out["device"] = (dev.device.type, dev.dtype, dev.numpy())
    pano, reg, _ = _composite(Stitcher(mesh=mesh, crop=False), imgs)
    out["nocrop"] = (pano, _summary(reg))
    st = Stitcher(mesh=mesh)
    out["crop_stitch"] = st.stitch(imgs)
    out["crop_rects"] = [tuple(int(v) for v in r)
                         for r in st.cropper.intersection_rectangles]
    out["crop_cams"] = [c.copy() for c in engine.register(st, imgs).cameras]
    out["jax_cams"] = _composite(Stitcher(mesh=mesh, crop=False), imgs,
                                 jax_cams)[0]
    ast = AffineStitcher(mesh=mesh)
    out["affine"] = ast.stitch(scan)
    out["affine_cams"] = [c.copy() for c in engine.register(ast, scan)
                          .cameras]
    # subsetting drops the noise image: the kept three re-pad to four
    # slots and re-distribute over the ranks
    noisy = list(imgs) + [np.random.RandomState(5).randint(
        0, 255, imgs[0].shape, np.uint8)]
    st = Stitcher(mesh=mesh, crop=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", StitchingWarning)
        reg = engine.register(st, noisy)
    slots = (reg.stack.batch, reg.stack.data.shape[0])
    pano = engine.composite(st, reg, engine.plan_composition(st, reg))
    out["subset"] = (pano, [c.copy() for c in reg.cameras], *slots)
    written = []
    write = timelapser._io.write_image
    timelapser._io.write_image = lambda name, img: (
        written.append(os.path.basename(name)), write(name, img))
    try:
        paths = [os.path.join(frame_dir, f"view{i}.png")
                 for i in range(len(imgs))]
        out["timelapse"] = Stitcher(mesh=mesh, crop=False,
                                    timelapse="as_is").stitch(paths)
    finally:
        timelapser._io.write_image = write
    out["written"] = written
    # inputs over the MEDIUM size: each rank resizes them to MEDIUM on the
    # host, detects, and uploads its block of the originals only then
    resized = []
    resize = engine._host_resize
    engine._host_resize = lambda im, size: (
        resized.append(tuple(int(v) for v in size)), resize(im, size))[1]
    try:
        reg = engine.register(Stitcher(mesh=mesh, crop=False,
                                       medium_megapix=0.1), imgs)
    finally:
        engine._host_resize = resize
    out["medium"] = (_summary(reg), resized, tuple(reg.stack.data.shape),
                     reg.stack.sizes.tolist(),
                     [f.img_size for f in reg.features])
    return out


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    import stitching_tpu
    from stitching_tpu import engine as jax_engine

    from stitching_tpu.parallel.mesh import make_mesh

    imgs, _, _ = rotation_set(n=3)
    scan, _ = affine_set(n=3)
    st = stitching_tpu.Stitcher(crop=False)
    reg = jax_engine.register(st, imgs)
    cams = reg.cameras
    jax_pano = jax_engine.composite(st, reg,
                                    jax_engine.plan_composition(st, reg))
    # the JAX package's mesh takes the same host MEDIUM branch
    med = jax_engine.register(stitching_tpu.Stitcher(
        mesh=make_mesh(1), crop=False, medium_megapix=0.1), imgs)
    jax_medium = dict(
        sizes=[tuple(int(v) for v in s) for s in
               med.images.get_scaled_img_sizes(med.images.Resolution.MEDIUM)],
        xy=[np.asarray(f.xy) for f in med.features],
        desc=[np.asarray(f.desc) for f in med.features],
        img_size=[tuple(f.img_size) for f in med.features],
        cams=[c.copy() for c in med.cameras])
    jax_cams = convert.cameras_from_numpy(
        [c.focal for c in cams], [c.aspect for c in cams],
        [c.ppx for c in cams], [c.ppy for c in cams],
        [np.asarray(c.R) for c in cams])
    frames = tmp_path_factory.mktemp("frames")
    for i, im in enumerate(imgs):
        io.write_image(str(frames / f"view{i}.png"), im)
    outs = run_ranks(stitch_rank, (imgs, scan, jax_cams, str(frames)),
                     tmp_path_factory.mktemp("stitch"), timeout=240)
    return dict(imgs=imgs, scan=scan, jax_cams=jax_cams, jax_pano=jax_pano,
                frames=frames, outs=outs, jax_medium=jax_medium)


def _lsb(got, want):
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.999


def _cams_close(got, want, tol):
    for a, b in zip(got, want):
        assert abs(a.focal - b.focal) <= tol * b.focal
        np.testing.assert_allclose(a.R, b.R, atol=tol)


@pytest.mark.parametrize("key", ["stitch", "nocrop", "crop_stitch",
                                 "crop_rects", "jax_cams", "affine",
                                 "subset", "timelapse"])
def test_every_rank_returns_the_same(case, key):
    a, b = (out[key] for out in case["outs"])
    if key in ("nocrop", "subset"):
        a, b = a[0], b[0]
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_stitch_is_the_engine_path(case):
    out = case["outs"][0]
    np.testing.assert_array_equal(out["stitch"], out["nocrop"][0])


def test_stitch_device_under_the_mesh(case):
    """`stitch_device` stages each rank's block (`run_device`) and returns
    the panorama as a uint8 tensor on the mesh's device, equal on both
    ranks and to `stitch`'s."""
    for out in case["outs"]:
        kind, dtype, pano = out["device"]
        assert (kind, dtype) == ("cpu", torch.uint8)
        np.testing.assert_array_equal(pano, out["stitch"])


def test_features_and_matches_equal_the_unsharded_run(case):
    got = case["outs"][0]["nocrop"][1]
    want = _summary(engine.register(Stitcher(device="cpu", crop=False),
                                    case["imgs"]))
    for k in ("xy", "desc", "inliers"):
        for a, b in zip(got[k], want[k]):
            np.testing.assert_array_equal(a, b)
    assert got["conf"] == want["conf"]
    for a, b in zip(got["H"], want["H"]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    _cams_close(got["cams"], want["cams"], 1e-4)


def test_host_medium_branch_equals_jax(case):
    """Inputs over the MEDIUM size (`medium_megapix=0.1`): each rank
    resizes every image to MEDIUM on the host and uploads its block of
    the originals after detection, as the JAX package's mesh does. The
    MEDIUM sizes, keypoints and feature scales equal the JAX mesh run's;
    descriptors within the stated ORB gap (ROADMAP: at most 3% of rows
    differ); cameras within it too (focal 1%, R 1e-2)."""
    summary, resized, shape, sizes, img_sizes = case["outs"][0]["medium"]
    assert case["outs"][1]["medium"][0]["xy"][0].shape == \
        summary["xy"][0].shape
    want = case["jax_medium"]
    assert resized == want["sizes"]
    assert img_sizes == want["img_size"]
    # this rank's block of the ORIGINAL images, padded to 4 slots
    h, w = case["imgs"][0].shape[:2]
    assert shape[0] == 2 and sizes == [[w, h]] * 3 + [[1, 1]]
    for a, b in zip(summary["xy"], want["xy"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(summary["desc"], want["desc"]):
        assert (a != b).any(axis=1).mean() <= 0.03
    _cams_close(summary["cams"], want["cams"], 1e-2)


@pytest.mark.parametrize("crop", [False, True])
def test_panorama_equals_the_sync_branch(case, crop):
    """At the mesh run's cameras the unsharded sync branch gives the mesh
    run's panorama (shape, crop rects, 1 LSB)."""
    out = case["outs"][0]
    if crop:
        got, cams = out["crop_stitch"], out["crop_cams"]
    else:
        got, cams = out["nocrop"][0], out["nocrop"][1]["cams"]
    want, reg, rects = _composite(Stitcher(device="cpu", crop=crop),
                                  case["imgs"], cams)
    assert reg.uploader is None           # the sync branch
    if crop:
        assert rects == out["crop_rects"]
    _lsb(got, want)


def test_with_jax_cameras_equals_jax(case):
    _lsb(case["outs"][0]["jax_cams"], case["jax_pano"])


def test_affine_stitcher_mesh(case):
    out = case["outs"][0]
    want, _, _ = _composite(AffineStitcher(device="cpu"), case["scan"],
                            out["affine_cams"])
    want_cams = engine.register(AffineStitcher(device="cpu"),
                                case["scan"]).cameras
    for a, b in zip(out["affine_cams"], want_cams):
        np.testing.assert_allclose(a.R, b.R, rtol=1e-4, atol=1e-3)
    _lsb(out["affine"], want)


def test_subset_under_the_mesh(case):
    pano, cams, batch, local = case["outs"][0]["subset"]
    assert (batch, local) == (4, 2)
    noisy = list(case["imgs"]) + [np.random.RandomState(5).randint(
        0, 255, case["imgs"][0].shape, np.uint8)]
    with pytest.warns(StitchingWarning):
        want, reg, _ = _composite(Stitcher(device="cpu", crop=False), noisy,
                                  cams)
    assert len(reg.cameras) == 3
    _lsb(pano, want)


def test_timelapse_rank0_writes(case, tmp_path):
    outs = case["outs"]
    names = [f"fixed_view{i}.png" for i in range(3)]
    assert outs[0]["timelapse"] is None
    assert outs[0]["written"] == names and outs[1]["written"] == []
    for i in range(3):
        shutil.copy(case["frames"] / f"view{i}.png", tmp_path)
    # the frames of the unsharded run at the mesh run's cameras (the
    # registration of the same images with the same settings)
    _composite(Stitcher(device="cpu", crop=False, timelapse="as_is"),
               [str(tmp_path / f"view{i}.png") for i in range(3)],
               outs[0]["nocrop"][1]["cams"])
    for name in names:
        _lsb(io.read_image(str(case["frames"] / name)),
             io.read_image(str(tmp_path / name)))


def test_stitcher_takes_the_mesh_device():
    m = pmesh.Mesh(None, 1, 0, torch.device("cpu"), "gloo")
    st = AffineStitcher(mesh=m)
    assert st.mesh is m and st.device == torch.device("cpu")
    assert st.blender.device == torch.device("cpu")
    assert Stitcher(device="cpu", mesh=m).device == torch.device("cpu")
    with pytest.raises(StitchingError, match="mesh"):
        Stitcher(device="cuda", mesh=m)
