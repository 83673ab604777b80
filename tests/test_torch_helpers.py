"""Small public pieces of the port: `ops/pyramid.KERNEL5` against the JAX
package's and as the taps the pyramid applies, and `DeviceStack.image`
under a mesh, which takes only an entry of this rank's block.
"""

import numpy as np
import pytest
import torch

from stitching_tpu.ops import pyramid as pyramid_jax
from stitching_tpu_torch import pipeline
from stitching_tpu_torch.ops import pyramid
from stitching_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(2)


def test_kernel5_equals_jax():
    assert pyramid.KERNEL5.dtype == pyramid_jax.KERNEL5.dtype
    np.testing.assert_array_equal(pyramid.KERNEL5, pyramid_jax.KERNEL5)


def test_pyramid_applies_kernel5():
    """An impulse through each pass gives the kernel's taps: the down pass
    keeps every other tap ([1, 6, 1] / 16), the up pass applies twice the
    kernel; both separable, so the 2-D response is an outer product."""
    k = pyramid.KERNEL5
    img = torch.zeros(1, 16, 16, 1)
    img[0, 8, 8, 0] = 1.0
    down = pyramid.pyr_down(img)[0, :, :, 0].numpy()
    want = np.zeros((8, 8), np.float32)
    want[3:6, 3:6] = np.outer(k[::2], k[::2])
    np.testing.assert_array_equal(down, want)
    img = torch.zeros(1, 8, 8, 1)
    img[0, 4, 4, 0] = 1.0
    up = pyramid.pyr_up(img, 16, 16)[0, :, :, 0].numpy()
    want = np.zeros((16, 16), np.float32)
    want[6:11, 6:11] = np.outer(2 * k, 2 * k)
    np.testing.assert_array_equal(up, want)


def _rank_stack(rank):
    """Rank `rank` of 2's block of a 4-image DeviceStack: images 2r, 2r+1,
    each filled with its index."""
    mesh = pmesh.Mesh(group=None, size=2, rank=rank,
                      device=torch.device("cpu"), backend="gloo")
    data = torch.arange(2 * rank, 2 * rank + 2, dtype=torch.float32)
    data = data.view(2, 1, 1, 1).expand(2, 6, 8, 3).contiguous()
    sizes = np.array([[8, 6], [7, 5], [8, 6], [6, 4]], np.int64)
    return pipeline.DeviceStack(data, sizes, mesh)


@pytest.mark.parametrize("rank", [0, 1])
def test_device_stack_image_takes_its_rank_block(rank):
    stack = _rank_stack(rank)
    assert stack.batch == 4 and stack.lo == 2 * rank
    for i in (2 * rank, 2 * rank + 1):
        w, h = stack.sizes[i]
        np.testing.assert_array_equal(
            stack.image(i), np.full((h, w, 3), i, np.float32))


@pytest.mark.parametrize("rank,i", [(1, 0), (1, 1), (0, 2), (0, 3), (1, 4),
                                    (0, -1)])
def test_device_stack_image_outside_rank_block_raises(rank, i):
    """Entry i of another rank's block raises: a negative row would wrap
    to another image of this block."""
    with pytest.raises(IndexError, match="not in this rank's block"):
        _rank_stack(rank).image(i)
