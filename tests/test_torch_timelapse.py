"""The port's `Timelapser` and the engine's timelapse branch against the
JAX package.

The three cases of `tests/test_timelapse.py` on the port's component, and
`Stitcher(timelapse="as_is")` and `"crop"` end to end on files, on the
downscaled registration branch (the FINAL warp paced by the uploader):
with the JAX package's cameras handed over, every `fixed_<name>` frame the
port writes (Pillow, PNG) has the shape of the one the JAX package writes,
and its values are within 1 LSB, at least 99.99% equal: the warp's
transcendentals differ from XLA's in the last bit (ROADMAP queue 3), which
moves 4 of the 1.48 M values here by 1. `stitch` returns None.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import stitching_tpu
from fixtures import rotation_set
from stitching_tpu import engine as jax_engine
from stitching_tpu_torch import Stitcher, convert, engine, io
from stitching_tpu_torch.timelapser import Timelapser

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)

SETTINGS = dict(medium_megapix=0.1)   # the downscaled (uploader) branch


def test_timelapse_frame_placement():
    timelapser = Timelapser("as_is")
    corners = [(0, 0), (100, 0)]
    sizes = [(120, 80), (120, 80)]
    timelapser.initialize(corners, sizes)

    img = np.full((80, 120, 3), 200, np.uint8)
    timelapser.process_frame(img, corners[0])
    frame = timelapser.get_frame()
    assert frame.shape == (80, 220, 3)
    assert (frame[:, :120] == 200).all()
    assert (frame[:, 120:] == 0).all()


def test_timelapse_filename():
    t = Timelapser("as_is")
    assert t.get_fixed_filename("a/b.jpg") == "a/fixed_b.jpg"


def test_no_timelapse():
    assert not Timelapser("no").do_timelapse
    assert Timelapser("crop").do_timelapse


def test_timelapse_crop_clips_negative_corners():
    t = Timelapser("crop")
    t.initialize([(0, 0), (50, 10)], [(60, 40), (60, 40)])
    t.process_frame(np.full((40, 60, 3), 9, np.uint8), (-10, -5))
    frame = t.get_frame()
    assert frame.shape == (50, 110, 3)
    assert (frame[:35, :50] == 9).all() and (frame[35:] == 0).all()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The rotation set as PNG files in a directory of its own."""
    imgs, _, _ = rotation_set(n=3, size=(640, 480))
    root = tmp_path_factory.mktemp("views")
    names = []
    for i, im in enumerate(imgs):
        names.append(str(root / f"view{i}.png"))
        io.write_image(names[-1], im)
    return names


@pytest.fixture(scope="module")
def jax_cameras(files):
    reg = jax_engine.register(stitching_tpu.Stitcher(**SETTINGS), files)
    assert reg.uploader is not None
    return [c.copy() for c in reg.cameras]


def _copy(names, where):
    os.makedirs(where)
    out = []
    for name in names:
        out.append(os.path.join(where, os.path.basename(name)))
        shutil.copy(name, out[-1])
    return out


def _frames(names):
    return [io.read_image(os.path.join(os.path.dirname(n),
                                       "fixed_" + os.path.basename(n)))
            for n in names]


@pytest.mark.parametrize("kind", ["as_is", "crop"])
def test_timelapse_frames_equal_jax(tmp_path, files, jax_cameras, kind):
    runs = {}
    for name, make, eng in (("jax", stitching_tpu.Stitcher, jax_engine),
                            ("port", Stitcher, engine)):
        extra = {} if name == "jax" else {"device": "cpu"}
        st = make(timelapse=kind, **SETTINGS, **extra)
        names = _copy(files, str(tmp_path / name))
        reg = eng.register(st, names)
        if name == "port":
            reg.cameras = convert.cameras_from_numpy(
                [c.focal for c in jax_cameras],
                [c.aspect for c in jax_cameras],
                [c.ppx for c in jax_cameras], [c.ppy for c in jax_cameras],
                [np.asarray(c.R) for c in jax_cameras])
        else:
            reg.cameras = [c.copy() for c in jax_cameras]
        st.warper.set_scale(reg.cameras)
        reg.scale = st.warper.scale
        assert eng.composite(st, reg, eng.plan_composition(st, reg)) is None
        runs[name] = _frames(names)
    for got, want in zip(runs["port"], runs["jax"]):
        assert got.shape == want.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1
        assert (diff == 0).mean() >= 0.9999


def test_timelapse_stitch_returns_none(tmp_path, files):
    """`Stitcher(timelapse="as_is").stitch` writes one frame per input
    beside it, each the size of the union canvas, and returns None."""
    names = _copy(files, str(tmp_path / "run"))
    assert Stitcher(device="cpu", timelapse="as_is", **SETTINGS).stitch(
        names) is None
    frames = _frames(names)
    assert len(frames) == len(names)
    assert len({f.shape for f in frames}) == 1
    assert all((f.max(-1) > 0).mean() > 0.1 for f in frames)
