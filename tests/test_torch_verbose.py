"""`Stitcher.stitch_verbose` against the JAX package's verbose mode, with
the JAX registration handed over.

The port stitcher's detector, matcher, estimator, adjuster and wave
corrector stand in for the JAX run's results (its features, matches and
cameras, carried across by `convert`), so every later stage runs on the
same inputs. Both packages' `io.write_image` are patched to record the
arrays each artifact is written from: the files differ byte for byte (the
JAX package encodes with OpenCV here, the port with Pillow), the arrays
are held. Tolerances: the artifact names are equal; 00_stitcher.txt and
03_matches_graph.txt are equal; 01_* and 02_* are equal; every array of
04-09 has the reference's shape, every value within 1 LSB and at least
99.9% of values equal.

With crop=True the reference raises in its seam visualisation (its
coloured images take the rounded FINAL sizes, a pixel larger than the
cropped masks; ROADMAP queue 3): every artifact it writes before that is
held, and the port also writes both seam-visualisation artifacts.
"""

import os
from unittest import mock

import numpy as np
import pytest
import torch

import stitching_tpu
import stitching_tpu.verbose as jax_verbose
import stitching_tpu_torch.verbose as port_verbose
from fixtures import rotation_set
from stitching_tpu_torch import Stitcher, convert

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)

SEAM_VIZ = ("09_result_with_seam_lines.jpg",
            "09_result_with_seam_polygons.jpg")


@pytest.fixture(scope="module")
def images():
    imgs, _, _ = rotation_set(n=3)
    return imgs


def _recording(module):
    """Patch `module._io.write_image` to record each artifact's array."""
    written = {}

    def record(path, img, params=None):
        written[os.path.basename(path)] = np.array(img)
        return True

    return written, mock.patch.object(module._io, "write_image", record)


def jax_verbose_run(images, crop, tmp):
    """The JAX package's verbose run: its artifacts' arrays, whether it
    raised, and its registration as numpy fields."""
    st = stitching_tpu.Stitcher(crop=crop)
    state = {}

    def keep(name, fn):
        def wrapped(*args):
            state[name] = fn(*args)
            return state[name]
        return wrapped

    st.detector.detect = keep("features", st.detector.detect)
    st.matcher.match_features = keep("matches", st.matcher.match_features)
    st.wave_corrector.correct = keep("cameras", st.wave_corrector.correct)
    written, patch = _recording(jax_verbose)
    raised = None
    with patch:
        try:
            st.stitch_verbose(images, verbose_dir=str(tmp))
        except Exception as exc:   # the reference's fault, held below
            raised = exc
    feats = [(np.asarray(f.xy), np.asarray(f.response), np.asarray(f.size),
              np.asarray(f.angle), np.asarray(f.desc), np.asarray(f.valid),
              f.img_size) for f in state["features"]]
    matches = [(m.src_img_idx, m.dst_img_idx, m.matches, m.matches_valid,
                m.inliers_mask, m.num_inliers, m.H, m.confidence)
               for m in state["matches"]]
    cams = [(c.focal, c.aspect, c.ppx, c.ppy, np.asarray(c.R))
            for c in state["cameras"]]
    texts = {name: open(os.path.join(tmp, name)).read()
             for name in ("00_stitcher.txt", "03_matches_graph.txt")}
    return written, texts, raised, (feats, matches, cams)


def port_verbose_run(images, crop, tmp, registration):
    """The port's verbose run on the CPU with the JAX registration."""
    feats, matches, cams = registration
    st = Stitcher(device="cpu", crop=crop)
    features = [convert.features_from_numpy(*f) for f in feats]
    pairs = [convert.matches_from_numpy(*m) for m in matches]
    cameras = convert.cameras_from_numpy(*zip(*cams))
    st.detector.detect = lambda imgs: features
    st.matcher.match_features = lambda f: pairs
    st.camera_estimator.estimate = lambda f, m: cameras
    st.camera_adjuster.adjust = lambda f, m, c: c
    st.wave_corrector.correct = lambda c: c
    written, patch = _recording(port_verbose)
    with patch:
        pano = st.stitch_verbose(images, verbose_dir=str(tmp))
    texts = {name: open(os.path.join(tmp, name)).read()
             for name in ("00_stitcher.txt", "03_matches_graph.txt")}
    return written, texts, pano


@pytest.fixture(scope="module", params=[False, True], ids=["nocrop", "crop"])
def runs(request, images, tmp_path_factory):
    crop = request.param
    ref = jax_verbose_run(images, crop, tmp_path_factory.mktemp("jax"))
    got = port_verbose_run(images, crop, tmp_path_factory.mktemp("port"),
                           ref[3])
    return crop, ref, got


def test_artifact_names(runs):
    crop, (ref, _, raised, _), (got, _, _) = runs
    if crop:
        # the reference stops in its seam visualisation; the port goes on
        assert raised is not None
        assert set(got) == set(ref) | set(SEAM_VIZ)
    else:
        assert raised is None
        assert set(got) == set(ref)
    assert all(name in got for name in SEAM_VIZ)


def test_text_artifacts_equal(runs):
    _, (_, ref_texts, _, _), (_, texts, _) = runs
    assert texts == ref_texts


@pytest.mark.parametrize("group", ["01", "02"])
def test_drawings_equal(runs, group):
    _, (ref, _, _, _), (got, _, _) = runs
    names = sorted(n for n in ref if n.startswith(group))
    assert names
    for name in names:
        assert np.array_equal(got[name], ref[name]), name


@pytest.mark.parametrize("group", ["04", "05", "06", "07", "08", "09"])
def test_stage_artifacts_within_one_lsb(runs, group):
    crop, (ref, _, _, _), (got, _, _) = runs
    names = sorted(n for n in ref if n.startswith(group))
    if group in ("06", "07") and not crop:
        assert not names and not any(n.startswith(group) for n in got)
        return
    assert names
    for name in names:
        a, b = got[name], ref[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert diff.max() <= 1, (name, int(diff.max()))
        assert (diff == 0).mean() >= 0.999, (name, (diff == 0).mean())


def test_panorama_is_the_result_artifact(runs):
    _, _, (got, _, pano) = runs
    assert np.array_equal(pano, got["09_result.jpg"])
    assert pano.dtype == np.uint8 and pano.ndim == 3
