"""The port's `transfer.Uploader` on the CPU: the four cases of
`tests/test_transfer.py` (content exact, subset reindexes, the yield lane
and its fast phase, an error in the thread raised in every consumer).
`tests/test_torch_cuda.py` holds the card's copy stream, events and
pinned staging."""

import numpy as np
import pytest

from stitching_tpu_torch import transfer
from stitching_tpu_torch.transfer import Uploader


def _imgs(n=3, h=100, w=64):
    rng = np.random.RandomState(1)
    return [rng.randint(0, 255, (h + i, w, 3), np.uint8) for i in range(n)]


@pytest.mark.parametrize("chunk_bytes", [5000, 3_000_000])
def test_uploader_content_exact(chunk_bytes):
    imgs = _imgs() + [np.random.RandomState(2).rand(37, 21).astype(
        np.float32)]
    up = Uploader(imgs, chunk_bytes=chunk_bytes, depth=2, device="cpu")
    for i, im in enumerate(imgs):
        got = up.image(i)
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), im)
    up.join()
    assert up._imgs is None       # host copies released
    assert up.channels == 3


def test_uploader_subset_reindexes():
    imgs = _imgs(4)
    up = Uploader(imgs, device="cpu")
    up.join()
    up.subset([0, 2, 3])
    np.testing.assert_array_equal(up.image(1).numpy(), imgs[2])
    assert len(up) == 3


def test_uploader_yield_lane_and_fast_phase():
    imgs = _imgs(3)
    up = Uploader(imgs, chunk_bytes=5000, device="cpu")
    with up.yield_lane():
        pass  # releasing flips to full-throttle mode
    assert up._lane_done.is_set()
    up.join()
    np.testing.assert_array_equal(up.image(2).numpy(), imgs[2])


def test_uploader_gray_channels():
    gray = [im[..., 0] for im in _imgs(2)]
    up = Uploader(gray, device="cpu")
    assert up.channels == 1
    np.testing.assert_array_equal(up.image(1).numpy(), gray[1])


def test_uploader_error_propagates(monkeypatch):
    """A copy failing in the background thread must surface in every
    consumer instead of hanging it."""
    def bad_copy(*args):
        raise RuntimeError("boom")

    monkeypatch.setattr(transfer, "_copy_chunk", bad_copy)
    up = Uploader(_imgs(2), device="cpu")
    with pytest.raises(RuntimeError, match="boom"):
        up.image(0)
    with pytest.raises(RuntimeError, match="boom"):
        up.join()
