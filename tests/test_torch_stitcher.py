"""The port's `Stitcher` against `stitching_tpu.Stitcher` on the slices.

The slice configurations (`stitching_tpu_torch.SLICE` and `SLICE2`) run
through both packages on the rotation fixture. `SLICE` runs on both
registration branches: the sync one (inputs already at MEDIUM size) and
the downscaled one (`medium_megapix=0.1`, gray MEDIUM stack from the host
8.8 conversion). `SLICE2` adds bundle adjustment, wave correction, the crop
and block-gain exposure; `test_torch_slice2.py` holds it against the JAX
package.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import stitching_tpu
import stitching_tpu_torch
import stitching_tpu_torch.ops.warp
from fixtures import rotation_set
from stitching_tpu import engine as jax_engine
from stitching_tpu_torch import (SLICE, SLICE2, Stitcher, StitchingError,
                                 compose, convert)
from stitching_tpu_torch import engine

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)

BRANCHES = {"sync": {}, "downscaled": {"medium_megapix": 0.1}}


@pytest.fixture(scope="module")
def images():
    imgs, _, _ = rotation_set(n=3, size=(640, 480))
    return imgs


@pytest.fixture(scope="module")
def jax_runs(images):
    """One JAX package run per branch: its cameras, its panorama, and its
    features and matches as plain numpy fields."""
    out = {}
    for name, extra in BRANCHES.items():
        st = stitching_tpu.Stitcher(**SLICE, **extra)
        reg = jax_engine.register(st, images)
        cams = [c.copy() for c in reg.cameras]
        feats = [(np.asarray(f.xy), np.asarray(f.response),
                  np.asarray(f.size), np.asarray(f.angle),
                  np.asarray(f.desc), np.asarray(f.valid), f.img_size)
                 for f in reg.features]
        matches = [(m.src_img_idx, m.dst_img_idx, m.matches,
                    m.matches_valid, m.inliers_mask, m.num_inliers, m.H,
                    m.confidence) for m in reg.matches]
        pano = jax_engine.composite(st, reg,
                                    jax_engine.plan_composition(st, reg))
        out[name] = (cams, pano, feats, matches)
    return out


def _port_panorama(images, extra, cameras=None):
    st = Stitcher(device="cpu", **SLICE, **extra)
    reg = engine.register(st, images)
    if cameras is not None:
        reg.cameras = convert.cameras_from_numpy(
            [c.focal for c in cameras], [c.aspect for c in cameras],
            [c.ppx for c in cameras], [c.ppy for c in cameras],
            [np.asarray(c.R) for c in cameras])
        st.warper.set_scale(reg.cameras)
        reg.scale = st.warper.scale
    return reg, engine.composite(st, reg, engine.plan_composition(st, reg))


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_slice_panorama_with_jax_cameras_within_one_lsb(images, jax_runs,
                                                        branch):
    """Compose alone: with the reference's cameras the port's panorama
    equals the reference's to 1 LSB at every pixel."""
    cams, ref = jax_runs[branch][:2]
    _, pano = _port_panorama(images, BRANCHES[branch], cams)
    assert pano.shape == ref.shape and pano.dtype == np.uint8
    diff = np.abs(pano.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_slice_with_jax_registration_matches_jax(images, jax_runs, branch):
    """The slice with its registration pinned: the reference's features
    and matches go in through `convert`, and the port estimates the
    cameras, plans and composites. Cameras agree to 1e-4 and every value
    of the panorama is within 1 LSB, which meets the whole slice's bar
    (at least 99% of values within 1 LSB)."""
    cams, ref, feats, matches = jax_runs[branch]
    st = Stitcher(device="cpu", **SLICE, **BRANCHES[branch])
    own = engine.register(st, images)
    features = [convert.features_from_numpy(*f) for f in feats]
    matches = [convert.matches_from_numpy(*m) for m in matches]
    reg = engine._register_cameras(st, own.images, own.stack, features,
                                   matches, uploader=own.uploader,
                                   low_stack=own.low_stack)
    assert len(reg.cameras) == len(cams)
    for c, r in zip(reg.cameras, cams):
        np.testing.assert_allclose(c.K(), r.K(), rtol=1e-4)
        np.testing.assert_allclose(c.R, r.R, atol=1e-4)
    pano = engine.composite(st, reg, engine.plan_composition(st, reg))
    assert pano.shape == ref.shape and pano.dtype == np.uint8
    diff = np.abs(pano.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_slice_stitch_matches_jax(images, jax_runs, branch):
    """The whole slice. The fixture's weakest pair has 5 inliers, and
    there the reference's last-bit choices (pyramid resize, LAPACK
    eigh) move the focal estimate by up to ~1%, so the panoramas agree
    in size to 1%, not to the pixel (ROADMAP queue 3)."""
    cams, ref = jax_runs[branch][:2]
    reg, pano = _port_panorama(images, BRANCHES[branch])
    assert len(reg.cameras) == len(cams)
    for c, r in zip(reg.cameras, cams):
        assert abs(c.focal - r.focal) <= 0.02 * r.focal
        np.testing.assert_allclose(c.R, r.R, atol=0.02)
    assert pano.dtype == np.uint8 and pano.shape[2] == 3
    for a, b in zip(pano.shape[:2], ref.shape[:2]):
        assert abs(a - b) <= 0.01 * b
    assert np.array_equal(
        Stitcher(device="cpu", **SLICE, **BRANCHES[branch]).stitch(images),
        pano)


def test_settings_schema_equals_jax():
    assert Stitcher.DEFAULT_SETTINGS == stitching_tpu.Stitcher.DEFAULT_SETTINGS


def test_unknown_setting_raises():
    with pytest.raises(StitchingError):
        Stitcher(device="cpu", **SLICE, not_a_setting=1)


@pytest.mark.parametrize("setting,value,nfeatures", [
    ("detector", "sift", 500),
    ("detector", "akaze", 1024),
    ("detector", "brisk", 1024),
])
def test_unported_setting_raises_not_implemented(setting, value, nfeatures):
    """The detectors that once raised construct now, with the reference's
    settings: its feature count (`nfeatures` reaches orb and sift only,
    the others keep their default), descriptor kind and ratio-test
    confidence."""
    st = Stitcher(device="cpu", **{**SLICE, setting: value, "nfeatures": 77})
    ref = stitching_tpu.Stitcher(**{**SLICE, setting: value,
                                    "nfeatures": 77})
    assert st.settings == ref.settings
    assert st.detector.detector_name == value
    assert st.detector.nfeatures == (77 if value == "sift" else nfeatures)
    assert st.detector.nfeatures == ref.detector.nfeatures
    assert st.detector.is_binary == ref.detector.is_binary == (
        value != "sift")
    assert st.matcher.match_conf == ref.matcher.match_conf == (
        0.65 if value == "sift" else 0.3)


def test_default_settings_construct():
    """Every default setting is ported: `Stitcher()` constructs and reports
    the reference's defaults, dp_color seams and the multiband blend
    among them."""
    st = Stitcher(device="cpu")
    assert st.settings == stitching_tpu.Stitcher.DEFAULT_SETTINGS
    assert st.seam_finder.finder_name == "dp_color"
    assert st.blender.blender_type == "multiband"
    assert st.blender.blend_strength == 5


@pytest.mark.parametrize("setting,value", [
    ("finder", "dp_color"), ("finder", "dp_colorgrad"),
    ("finder", "gc_color"), ("finder", "gc_colorgrad"),
    ("finder", "voronoi"), ("blender_type", "multiband"),
    ("blender_type", "feather"), ("adjuster", "affine"),
    ("compensator", "gain"), ("compensator", "channel"),
    ("matcher_type", "affine"), ("estimator", "affine"),
] + [("warper_type", w) for w in stitching_tpu_torch.ops.warp.WARP_TYPES])
def test_ported_setting_constructs(setting, value):
    st = Stitcher(device="cpu", **{**SLICE, setting: value})
    assert st.settings[setting] == value


def test_canvas_over_the_blend_budget_blends():
    """Two small tiles 12000 x 9000 pixels apart need 4.7 GB of
    accumulators by the reference's estimate, over its 4 GB budget: the
    paste blends in X strips (the empty middle strip stays black), each
    tile at its corner."""
    rng = np.random.RandomState(0)
    data = torch.as_tensor(rng.randint(1, 255, (2, 64, 64, 3)).astype(
        np.float32))
    stack = compose.TileStack(data, torch.full((2, 64, 64), 255.0),
                              np.asarray([(0, 0), (12000, 9000)]),
                              np.asarray([(64, 64), (64, 64)]))
    pano, mask = compose.blend_stack(stack, None, "no", 5)
    assert pano.shape == (9064, 12064, 3) and mask.shape == (9064, 12064)
    assert torch.equal(pano[:64, :64], data[0].to(torch.uint8))
    assert torch.equal(pano[9000:, 12000:], data[1].to(torch.uint8))
    assert int(mask.sum()) == 2 * 64 * 64 * 255
    assert int(pano.sum()) == int(data.to(torch.uint8).sum())


@pytest.mark.parametrize("caller", [(True, True), (False, True),
                                    (True, False)])
@pytest.mark.parametrize("entry", ["stitch", "stitch_device",
                                   "register_pair"])
def test_tf32_is_off_inside_each_entry_and_restored(monkeypatch, caller,
                                                    entry):
    """Every public entry point computes in full float32 and leaves the
    caller's TF32 flags as it found them."""
    from stitching_tpu_torch import pipeline

    seen = []

    def probe(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return "done"

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = caller
    try:
        if entry == "register_pair":
            monkeypatch.setattr(pipeline, "_register_pair", probe)
            out = pipeline.register_pair(None, None, device="cpu")
        else:
            monkeypatch.setattr(engine, "run" if entry == "stitch"
                                else "run_device", probe)
            out = getattr(Stitcher(device="cpu"), entry)([])
        after = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    assert out == "done" and seen == [(False, False)]
    assert after == caller


def test_tf32_restored_when_the_entry_raises():
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with pytest.raises(StitchingError):
            Stitcher(device="cpu").stitch([np.zeros((8, 8, 3), np.uint8)])
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def test_read_image_equals_cv2_without_cv2(monkeypatch, tmp_path):
    """The port decodes with Pillow alone: a PNG (colour, and gray, which
    both read as 3 BGR channels) equals `cv2.imread` of the same file with
    OpenCV made unimportable; a written PNG reads back exactly."""
    import cv2

    from stitching_tpu_torch import io

    imgs, _, _ = rotation_set(n=1, size=(64, 48))
    cases = {"color.png": imgs[0], "gray.png": imgs[0][..., 1]}
    want = {}
    for name, img in cases.items():
        cv2.imwrite(str(tmp_path / name), img)
        want[name] = cv2.imread(str(tmp_path / name))
    monkeypatch.setitem(sys.modules, "cv2", None)
    for name in cases:
        got = io.read_image(str(tmp_path / name))
        assert got.dtype == np.uint8 and got.shape == want[name].shape
        np.testing.assert_array_equal(got, want[name])
    io.write_image(str(tmp_path / "out.png"), imgs[0])
    np.testing.assert_array_equal(io.read_image(str(tmp_path / "out.png")),
                                  imgs[0])
    with pytest.raises(StitchingError):
        io.read_image(str(tmp_path / "missing.png"))


@pytest.mark.parametrize("setting,value", [
    ("adjuster", "ray"), ("adjuster", "reproj"), ("adjuster", "no"),
    ("wave_correct_kind", "horiz"), ("wave_correct_kind", "vert"),
    ("wave_correct_kind", "auto"), ("wave_correct_kind", "no"),
    ("crop", True), ("crop", False),
    ("compensator", "gain_blocks"), ("compensator", "channel_blocks"),
    ("compensator", "no"),
])
def test_ported_setting_is_accepted(setting, value):
    st = Stitcher(device="cpu", **{**SLICE2, setting: value})
    assert st.settings[setting] == value


def test_package_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import stitching_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'stitching_tpu', 'cv2'))\n"
        "print(len([n for n in sys.modules\n"
        "           if n.startswith('stitching_tpu_torch.')]))\n"
        "assert not bad, bad\n"
        "need = ['stitching_tpu_torch.' + m for m in\n"
        "        ('cli.stitch', 'verbose', 'registration',\n"
        "         'parallel.mesh')]\n"
        "assert all(m in sys.modules for m in need), need\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=stitching_tpu_torch.__path__[0] + "/..")
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


@pytest.mark.parametrize("size", [(512, 384), (1200, 900)])
def test_slice_stitches_grayscale_inputs(size):
    """2-D inputs give a 1-channel panorama on both registration branches
    (sync at 512x384, downscaled at 1200x900), as in the JAX package."""
    imgs, _, _ = rotation_set(n=3, size=size, focal=450.0, max_angle=0.3)
    gray = [im.mean(-1).astype(np.uint8) for im in imgs]
    pano = Stitcher(device="cpu", **SLICE).stitch(gray)
    assert pano.ndim == 3 and pano.shape[-1] == 1
    assert pano.shape[0] > 300 and pano.shape[1] > 600


@pytest.mark.parametrize("size", [(640, 480), (1200, 900)])
def test_slice_drops_noise_image(size):
    """Subsetting drops an unmatchable image on both branches: the stacks
    re-index consistently and the geometry agrees with the clean run."""
    imgs, _, _ = rotation_set(n=3, size=size, focal=1000.0, max_angle=0.3)
    noise = np.random.RandomState(5).randint(0, 255, imgs[0].shape,
                                             np.uint8)
    with pytest.warns(stitching_tpu_torch.StitchingWarning):
        pano = Stitcher(device="cpu", **SLICE).stitch(list(imgs) + [noise])
    clean = Stitcher(device="cpu", **SLICE).stitch(list(imgs))
    np.testing.assert_allclose(pano.shape[:2], clean.shape[:2], atol=3)
