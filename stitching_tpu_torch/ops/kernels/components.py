"""The number of 4-connected foreground regions of a binary mask.

No TPU kernel stands behind it: the JAX package tests the crop's single
region with a host flood fill (`stitching_tpu/cropper.py::single_region`).
The port's crop planner counts the regions of the LOW panorama mask where
the paste composite left it, on the card, and reads one int32 back.

`count_components` launches the CUDA kernel (`csrc/components.cu`) for a
mask on the card and runs `count_components_plain` for one on the CPU.
The plain version takes the kernel's steps over the whole mask at once:
row runs labelled by their first pixel inside each 32-pixel tile row,
unions of vertically touching runs inside each tile, unions across the
tile borders, then the count of roots. Both join pixels by 4-connectivity
only: pixels that touch at a corner lie in two regions.
"""

import torch

from ... import profiling
from . import check, load, stream_ptr

TILE = 32
# tile labels, border unions, root count
LAUNCHES = 3


def _compress(parent):
    """Point every foreground label at its root (pointer jumping)."""
    fg = parent >= 0
    while True:
        up = parent[parent.clamp_min(0)]
        nxt = torch.where(fg, up, parent)
        if torch.equal(nxt, parent):
            return
        parent.copy_(nxt)


def _unite(parent, a, b):
    """Join the regions of the label pairs (a[k], b[k]): each round links
    every root that still differs from its partner under the smallest
    root it is paired with, as the kernel's atomicMin does."""
    while a.numel():
        _compress(parent)
        ra, rb = parent[a], parent[b]
        apart = ra != rb
        if not bool(apart.any()):
            return
        ra, rb = ra[apart], rb[apart]
        parent.scatter_reduce_(0, torch.maximum(ra, rb),
                               torch.minimum(ra, rb), "amin")


def count_components_plain(mask):
    """The kernel's steps on the CPU; (1,) int32."""
    h, w = mask.shape
    fg = mask != 0
    xs = torch.arange(w)
    ys = torch.arange(h)
    idx = ys[:, None] * w + xs
    cut = xs % TILE == 0                    # a tile's first column
    top = (ys % TILE == 0)[:, None]         # a tile's first row

    # tile labels: each pixel's label is its row run's first pixel in the
    # tile row
    left = torch.zeros_like(fg)
    left[:, 1:] = fg[:, :-1] & ~cut[1:]
    starts = torch.where(fg & ~left, xs.expand(h, w), -1)
    parent = torch.where(fg, ys[:, None] * w + starts.cummax(1).values,
                         -1).flatten()

    # vertical pairs, one union per stretch: none where the pair to the
    # left, in the same tile column, is foreground too
    pair = torch.zeros_like(fg)
    pair[1:] = fg[1:] & fg[:-1]
    stretch = pair.clone()
    stretch[:, 1:] &= ~(pair[:, :-1] & ~cut[1:])
    # horizontal pairs across a tile column border, one union per stretch:
    # none where the pair above, in the same tile row, is foreground too
    side = torch.zeros_like(fg)
    side[:, 1:] = fg[:, 1:] & fg[:, :-1] & cut[1:]
    side_stretch = side.clone()
    side_stretch[1:] &= ~(side[:-1] & ~top[1:])

    inner = stretch & ~top
    _unite(parent, idx[inner], idx[inner] - w)
    across = stretch & top
    _unite(parent, torch.cat([idx[across], idx[side_stretch]]),
           torch.cat([idx[across] - w, idx[side_stretch] - 1]))

    roots = parent == torch.arange(h * w)
    return roots.sum().to(torch.int32).reshape(1)


def count_components(mask):
    """The number of 4-connected foreground regions of a 2-D uint8 or bool
    mask, as a (1,) int32 tensor on the mask's device: the CUDA kernel on
    the card, the plain version on the CPU."""
    if mask.dim() != 2:
        raise ValueError("count_components: mask must be 2-D (h, w)")
    if mask.dtype not in (torch.uint8, torch.bool):
        raise ValueError("count_components: mask must be uint8 or bool")
    if not mask.is_contiguous():
        raise ValueError("count_components: mask must be contiguous")
    if mask.device.type == "cpu":
        return count_components_plain(mask)
    if mask.device.type != "cuda":
        raise ValueError("count_components: mask must lie on the CPU or a "
                         "CUDA device")
    h, w = mask.shape
    if h * w >= 2 ** 31:
        raise ValueError("count_components: the mask's pixels must fit "
                         "int32 labels")
    parent = torch.empty(h * w, dtype=torch.int32, device=mask.device)
    count = torch.empty(1, dtype=torch.int32, device=mask.device)
    fn = load("count_components")
    with torch.cuda.device(mask.device):
        status = fn(mask.data_ptr(), parent.data_ptr(), count.data_ptr(),
                    h, w, stream_ptr(mask.device))
    check(status, "count_components")
    launches = LAUNCHES if h * w else 0
    count_components.launches += launches
    profiling.count("crop/label_launches", launches)
    return count


count_components.launches = 0
