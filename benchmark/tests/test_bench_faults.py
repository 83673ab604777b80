"""A run with the timed path broken underneath comes out not correct:
once for each fault a stitching cell can have. The cell runs on one card,
so there is no exchange between chips to leave out."""

import json

import numpy as np
import pytest

from benchmark import run

CELL, SHRINK, SEED = "pano-default.rot6-12mp", 0.2, 7


def half_the_views(monkeypatch):
    from stitching_tpu_torch.stitcher import Stitcher

    orig = Stitcher.stitch
    monkeypatch.setattr(Stitcher, "stitch", lambda self, imgs, *a, **k:
                        orig(self, imgs[:len(imgs) // 2], *a, **k))


def panorama_altered(monkeypatch):
    from stitching_tpu_torch import engine

    orig = engine.composite

    def altered(st, reg, plan, fetch=True):
        pano = np.array(orig(st, reg, plan, fetch), copy=True)
        h, w = pano.shape[:2]
        block = pano[h // 4:h // 2, w // 4:w // 2].astype(np.int16) + 40
        pano[h // 4:h // 2, w // 4:w // 2] = block.clip(0, 255)
        return pano

    monkeypatch.setattr(engine, "composite", altered)


def blend_feed_skipped(monkeypatch):
    from stitching_tpu_torch import compose

    monkeypatch.setattr(compose.StreamComposite, "feed",
                        lambda self, *a, **k: None)


def cameras_altered(monkeypatch):
    # the registration's last step gives every focal 10% too long; the
    # panorama stays consistent with those cameras, so only the
    # comparison with the truth can see it
    from stitching_tpu_torch.camera_wave_corrector import WaveCorrector

    orig = WaveCorrector.correct

    def altered(self, cameras):
        cameras = orig(self, cameras)
        for cam in cameras:
            cam.focal *= 1.1
        return cameras

    monkeypatch.setattr(WaveCorrector, "correct", altered)


def _crop_planned(monkeypatch, change):
    from stitching_tpu_torch.cropper import Cropper, Rectangle

    orig = Cropper.estimate_largest_interior_rectangle

    def planned(self, mask):
        return Rectangle(*change(orig(self, mask), mask))

    monkeypatch.setattr(Cropper, "estimate_largest_interior_rectangle",
                        planned)


def crop_to_bounding_box(monkeypatch):
    # the crop grown to the bounding box of the views' cover: the
    # panorama keeps black corners where no view lies
    import torch

    def bbox(lir, mask):
        ys, xs = torch.nonzero(torch.as_tensor(mask) > 0, as_tuple=True)
        x0, y0 = int(xs.min()), int(ys.min())
        return x0, y0, int(xs.max()) + 1 - x0, int(ys.max()) + 1 - y0

    _crop_planned(monkeypatch, bbox)


def crop_halved(monkeypatch):
    # a crop inside the cover that gives away panorama
    _crop_planned(monkeypatch, lambda r, mask: (
        r.x + r.width // 4, r.y + r.height // 4, r.width // 2,
        r.height // 2))


def window_stitch_raises(monkeypatch):
    from stitching_tpu_torch import engine

    orig = engine.composite
    calls = []

    def composite(*a, **k):
        calls.append(1)
        if len(calls) > 1:          # the warm-up passes, the window fails
            raise RuntimeError("planted")
        return orig(*a, **k)

    monkeypatch.setattr(engine, "composite", composite)


def run_cell(capsys):
    rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                   "0.1"], device="cpu", shrink=SHRINK, pool=1)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1]) if out else None


def test_sound_run_is_correct(capsys):
    rc, line = run_cell(capsys)
    assert rc == 0 and line["correct"] is True


@pytest.mark.parametrize("fault", [half_the_views, panorama_altered,
                                   blend_feed_skipped, cameras_altered,
                                   crop_to_bounding_box, crop_halved,
                                   window_stitch_raises],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault, monkeypatch, capsys):
    fault(monkeypatch)
    rc, line = run_cell(capsys)
    assert rc == 0 and line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values()) \
        or line["failed"] == line["attempted"]
