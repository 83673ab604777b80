"""`Stitcher.stitch_verbose` with the port's own registration against the
JAX package's verbose run, on the CPU (crop off: with its crop the
reference raises in the seam visualisation, ROADMAP queue 3).

ORB's upper pyramid levels are not bit-exact against XLA (ROADMAP queue
3), which moves the focal by up to 0.9%, so the bar is the artifacts'
names (equal) and the panorama's sides (within 1% of the reference's).
"""

import os
from unittest import mock

import numpy as np
import torch

import stitching_tpu
import stitching_tpu.verbose as jax_verbose
from fixtures import rotation_set
from stitching_tpu_torch import Stitcher

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)


def test_own_registration_names_and_sides(tmp_path):
    imgs, _, _ = rotation_set(n=3)
    written = []

    def record(path, img, params=None):
        written.append(os.path.basename(path))
        return True

    (tmp_path / "jax").mkdir()
    with mock.patch.object(jax_verbose._io, "write_image", record):
        ref = stitching_tpu.Stitcher(crop=False).stitch_verbose(
            imgs, verbose_dir=str(tmp_path / "jax"))
    out = tmp_path / "port"
    out.mkdir()
    pano = Stitcher(device="cpu", crop=False).stitch_verbose(
        imgs, verbose_dir=str(out))
    assert sorted(os.listdir(out)) == sorted(
        written + ["00_stitcher.txt", "03_matches_graph.txt"])
    assert pano.dtype == np.uint8 and pano.shape[2] == ref.shape[2]
    for got, want in zip(pano.shape[:2], ref.shape[:2]):
        assert abs(got - want) <= 0.01 * want, (pano.shape, ref.shape)
    assert (pano.max(-1) > 0).mean() > 0.9
