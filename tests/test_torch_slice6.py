"""Slice 6 end to end against the JAX package: the FINAL pass as the
reference schedules it, the device-resident entry and the profiler.

On `rotation_set(n=3, size=(1200, 900), focal=1000, max_angle=0.3)` both
packages register on the downscaled branch, where the FINAL pass streams
per image behind the uploader. With the JAX package's cameras handed over:

- `Stitcher()` through the streamed branch: crop rects equal, every value
  within 1 LSB, at least 99.99% equal;
- the port's batched branch on the same plan equals its streamed branch;
- the FINAL pass plans its warp ROIs and its blend once, and decides to
  stream on its cropped blend plan as the uncropped estimate did;
- gray inputs with the defaults: within 1 LSB, at least 99.99% equal.

With the blend budget forced down (`compose.BLEND_BUDGET_BYTES` here,
`STITCHING_TPU_BLEND_BUDGET` there), `AffineStitcher` on a scan of 8
crops takes X strips in both packages: within 1 LSB, at least 99.99%
equal, with the JAX package's cameras; the rotation set, whose windows
span more than a third of both axes, takes the streamed monolithic blend.
`test_torch_slice6_device.py` holds the device-resident entry.
"""

import dataclasses

import numpy as np
import pytest
import torch

import stitching_tpu
from fixtures import affine_set, rotation_set
from stitching_tpu import engine as jax_engine
from stitching_tpu_torch import (AffineStitcher, Stitcher, compose, convert,
                                 engine, profiling)
from stitching_tpu_torch.pipeline import stack_images

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def images():
    imgs, _, _ = rotation_set(n=3, size=(1200, 900), focal=1000,
                              max_angle=0.3)
    return imgs


def _jax_run(images):
    """The JAX package's defaults on its streamed branch: cameras, crop
    rects and panorama."""
    st = stitching_tpu.Stitcher()
    reg = jax_engine.register(st, images)
    assert reg.uploader is not None
    cams = [c.copy() for c in reg.cameras]
    plan = jax_engine.plan_composition(st, reg)
    rects = [tuple(int(v) for v in r) for r in plan.crop_rects]
    return cams, rects, jax_engine.composite(st, reg, plan)


@pytest.fixture(scope="module")
def jax_default(images):
    return _jax_run(images)


def _with_cameras(st, reg, cams):
    reg.cameras = convert.cameras_from_numpy(
        [c.focal for c in cams], [c.aspect for c in cams],
        [c.ppx for c in cams], [c.ppy for c in cams],
        [np.asarray(c.R) for c in cams])
    st.warper.set_scale(reg.cameras)
    reg.scale = st.warper.scale
    return reg


def _close(pano, ref):
    assert pano.shape == ref.shape and pano.dtype == np.uint8
    diff = np.abs(pano.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.9999


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_streamed_default_with_jax_cameras(monkeypatch, images,
                                           jax_default):
    cams, ref_rects, ref = jax_default
    streamed = _spy(monkeypatch, engine, "_composite_streamed")
    st = Stitcher(device="cpu")
    reg = _with_cameras(st, engine.register(st, images), cams)
    assert reg.uploader is not None and reg.stack is None
    plan = engine.plan_composition(st, reg)
    assert [tuple(int(v) for v in r) for r in plan.crop_rects] == ref_rects
    pano = engine.composite(st, reg, plan)
    assert streamed == ["_composite_streamed"]
    _close(pano, ref)


def test_batched_branch_equals_streamed(images, jax_default):
    """One registration and one LOW plan; the FINAL pass once streamed
    (the uploader) and once batched (the originals as one stack)."""
    st = Stitcher(device="cpu")
    reg = _with_cameras(st, engine.register(st, images), jax_default[0])
    plan = engine.plan_composition(st, reg)
    batched = dataclasses.replace(reg, uploader=None, low_stack=None,
                                  stack=stack_images(images, "cpu"))
    streamed = engine.composite(st, dataclasses.replace(reg), plan)
    np.testing.assert_array_equal(engine.composite(st, batched, plan),
                                  streamed)


def test_strips_through_the_engine_equal_jax(monkeypatch):
    """A budget of 1 byte on a scan of 8 crops (windows narrow against
    the canvas's width): the engine leaves the streamed composite for the
    batched pass, whose LOW crop plan and FINAL blend both take X strips,
    the FINAL one streamed to the host, in both packages."""
    imgs, _ = affine_set(n=8, size=(480, 360))
    settings = dict(medium_megapix=0.1)      # the uploader's branch
    monkeypatch.setenv("STITCHING_TPU_BLEND_BUDGET", "1")
    st_j = stitching_tpu.AffineStitcher(**settings)
    reg_j = jax_engine.register(st_j, imgs)
    cams = [c.copy() for c in reg_j.cameras]
    ref = jax_engine.composite(st_j, reg_j,
                               jax_engine.plan_composition(st_j, reg_j))

    monkeypatch.setattr(compose, "BLEND_BUDGET_BYTES", 1)
    strips = _spy(monkeypatch, compose, "_blend_strips")
    streamed = _spy(monkeypatch, engine, "_composite_streamed")
    st = AffineStitcher(device="cpu", **settings)
    reg = _with_cameras(st, engine.register(st, imgs), cams)
    assert reg.uploader is not None
    pano = engine.composite(st, reg, engine.plan_composition(st, reg))
    assert strips == ["_blend_strips"] * 2 and not streamed
    assert isinstance(pano, np.ndarray)
    _close(pano, ref)


def test_monolithic_stream_through_the_engine_equal_jax(monkeypatch, images,
                                                        jax_default):
    cams = jax_default[0]
    monkeypatch.setenv("STITCHING_TPU_BLEND_BUDGET", "1")
    st_j = stitching_tpu.Stitcher()
    reg_j = jax_engine.register(st_j, images)
    reg_j.cameras = [c.copy() for c in cams]
    st_j.warper.set_scale(reg_j.cameras)
    reg_j.scale = st_j.warper.scale
    ref = jax_engine.composite(st_j, reg_j,
                               jax_engine.plan_composition(st_j, reg_j))

    monkeypatch.setattr(compose, "BLEND_BUDGET_BYTES", 1)
    mono = _spy(monkeypatch, compose, "_blend_monolithic_stream")
    st = Stitcher(device="cpu")
    reg = _with_cameras(st, engine.register(st, images), cams)
    pano = engine.composite(st, reg, engine.plan_composition(st, reg))
    assert mono == ["_blend_monolithic_stream"]
    _close(pano, ref)


def test_final_pass_plans_once(monkeypatch, images):
    """One streamed stitch's FINAL pass (`engine.composite`) plans the
    warp ROIs once and the blend once; the LOW crop's paste blend, before
    it, plans on its own and is not counted."""
    counts, inside = {"plan_warp_rois": 0, "_plan_blend": 0}, []

    def counted(name, real):
        def spy(*args, **kwargs):
            counts[name] += len(inside)
            return real(*args, **kwargs)
        return spy

    # the engine's own binding too, where it imports the name
    for name in counts:
        for module in (compose, engine):
            if hasattr(module, name):
                monkeypatch.setattr(module, name,
                                    counted(name, getattr(module, name)))
    real_composite = engine.composite

    def composite(*args, **kwargs):
        inside.append(1)
        try:
            return real_composite(*args, **kwargs)
        finally:
            inside.pop()

    monkeypatch.setattr(engine, "composite", composite)
    streamed = _spy(monkeypatch, engine, "_composite_streamed")
    Stitcher(device="cpu").stitch(images)
    assert streamed == ["_composite_streamed"]
    assert counts == {"plan_warp_rois": 1, "_plan_blend": 1}


def _uncropped_estimate(st, reg):
    """The streaming estimate that the FINAL pass made before it was
    planned once: the accumulators' level sum for the blend plan of the
    uncropped warp ROIs, in bytes."""
    sizes, Ks, Rs, scale = engine._geometry(reg, engine.Resolution.FINAL)
    corners, dsizes = compose.plan_warp_rois(
        [tuple(map(int, s)) for s in sizes], Ks, Rs, scale,
        st.warper.warper_type)
    th, tw = (-(-int(dsizes[:, a].max()) // 64) * 64 for a in (1, 0))
    p = compose._plan_blend(corners, dsizes, len(dsizes),
                            st.blender.blender_type,
                            st.blender.blend_strength, th, tw)
    levels = p["nb"] + 1 if p["kind"] == "multiband" else 1
    return sum((p["ph"] >> lv) * (p["pw"] >> lv)
               * (reg.uploader.channels + 1) * 4 for lv in range(levels))


@pytest.mark.parametrize("canvas", ["rotation", "scan"])
def test_stream_decision_as_the_uncropped_estimate(monkeypatch, images,
                                                   jax_default, canvas):
    """`compose.stream_fits` on the cropped blend plan decides as the
    uncropped estimate did, at the default budget and at the 1-byte budget
    of the strip and monolithic tests through the engine: the rotation
    set with the JAX package's cameras (the default and monolithic
    tests' canvas) and the scan of 8 crops (the strip test's)."""
    if canvas == "rotation":
        st, imgs = Stitcher(device="cpu"), images
    else:
        st = AffineStitcher(device="cpu", medium_megapix=0.1)
        imgs, _ = affine_set(n=8, size=(480, 360))
    seen = []
    fits = engine.stream_fits
    monkeypatch.setattr(engine, "stream_fits", lambda p, C: seen.append(
        (p, C)) or fits(p, C))
    reg = engine.register(st, imgs)
    if canvas == "rotation":
        reg = _with_cameras(st, reg, jax_default[0])
    before = _uncropped_estimate(st, reg)
    engine.composite(st, reg, engine.plan_composition(st, reg))
    [(p, C)] = seen
    assert 0 < before < compose.BLEND_BUDGET_BYTES
    for budget in (compose.BLEND_BUDGET_BYTES, 1):
        monkeypatch.setattr(compose, "BLEND_BUDGET_BYTES", budget)
        assert compose.stream_fits(p, C) is (before <= budget)


def test_gray_defaults_with_jax_cameras(images):
    """2-D inputs: the uploader's one channel through the streamed FINAL
    pass, against the JAX package with its cameras."""
    gray = [im.mean(-1).astype(np.uint8) for im in images]
    cams, rects, ref = _jax_run(gray)
    st = Stitcher(device="cpu")
    reg = _with_cameras(st, engine.register(st, gray), cams)
    assert reg.uploader.channels == 1
    plan = engine.plan_composition(st, reg)
    assert [tuple(int(v) for v in r) for r in plan.crop_rects] == rects
    pano = engine.composite(st, reg, plan)
    assert pano.ndim == 3 and pano.shape[-1] == 1
    _close(pano, ref)


def test_profiler_stage_names(images):
    """One fenced stitch on the streamed branch records the reference's
    stage names; the profiler is off again afterwards."""
    profiling.enable()
    profiling.enable_fence()
    profiling.reset()
    try:
        Stitcher(device="cpu").stitch(images)
        report = profiling.get_report()
    finally:
        profiling.enable(False)
        profiling.enable_fence(False)
        profiling.reset()
    assert {"registration/resize_medium", "registration/upload",
            "registration/detect", "registration/match_dispatch",
            "registration/match", "registration/subset",
            "registration/estimate", "registration/bundle_adjust",
            "registration/wave_correct", "low/warp", "low/crop",
            "low/crop/paste", "low/crop/flood_fill", "low/crop/lir",
            "low/crop/slice", "low/exposure_feed", "low/seam_find",
            "final/plan", "final/stream",
            "final/upload_wait", "final/stream/warp", "final/stream/feed",
            "final/blend",
            "transfer/originals_stream"} <= set(report)
    assert "final/warp" not in report     # the batched pass did not run
    assert report["final/upload_wait"]["calls"] == 3
    assert report["final/stream/warp"]["calls"] == 3
    assert report["final/stream/feed"]["calls"] == 3
    assert all(v["total_s"] >= 0 for v in report.values())
    Stitcher(device="cpu", crop=False).stitch(images)
    assert profiling.get_report() == {}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """`profiling.device_trace` wraps `torch.profiler` and writes the
    block's trace to `logdir/trace.json`."""
    import json

    with profiling.device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
