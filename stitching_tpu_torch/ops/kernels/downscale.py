"""The registration inputs of one view, downscaled where its original lies.

No TPU kernel stands behind it: the JAX package makes the gray MEDIUM
and colour LOW images of its downscaled registration on the host
(`stitching_tpu/engine.py::_host_downscale`, through `ops/resize.resize`)
and uploads them as stacks. The port's registration downscales each
original on the card as soon as its upload lands, into the slots of the
padded stacks that `pipeline.stack_images` would have made of the host
images, with the same values bit for bit.

`downscale` launches the CUDA kernel (`csrc/downscale.cu`) for an
original on the card and runs `downscale_plain` for one on the CPU. Both
take each output's taps and weights from `resize_table`, which computes
them on the host exactly as `ops/resize.resize` does, and repeat its
float32 arithmetic in its order: rows, then columns, then round half to
even and clip. The MEDIUM image is gray: a colour source becomes its 8.8
fixed-point BT.601 luma before the lerp, as `_host_downscale` has it.
Pixels of a slot past its image repeat the last row and column (the
stack's edge replication); a gray view in a colour LOW stack fills all
three channels.
"""

import numpy as np
import torch

from ... import profiling
from ..resize import _axis_weights
from . import check, load, stream_ptr

# one launch a view covers both outputs
LAUNCHES = 1


def _axis_table(n_in, n_out):
    i0, i1, w1 = _axis_weights(n_in, n_out)
    # `resize` lerps with (1 - w), the float32 difference
    w0 = (1 - w1).astype(np.float32)
    return np.concatenate([i0.astype(np.int32), i1.astype(np.int32),
                           w1.view(np.int32), w0.view(np.int32)])


def resize_table(src_hw, size_wh):
    """The taps of resizing an (h, w) image to (width, height), as the
    kernel reads them: int32 words, the rows' i0, i1, w1 and 1 - w1 (the
    weights as float32 bits), then the columns' the same way."""
    return np.concatenate([_axis_table(int(src_hw[0]), int(size_wh[1])),
                           _axis_table(int(src_hw[1]), int(size_wh[0]))])


def _taps(table, n, at):
    """One axis's (i0, i1, w1, w0) from `table`, starting at word `at`."""
    t = table[at:at + 4 * n].reshape(4, n)
    return (t[0].long(), t[1].long(), t[2].view(torch.float32),
            t[3].view(torch.float32))


def _resize_plain(img, size_wh, table):
    ow, oh = int(size_wh[0]), int(size_wh[1])
    y0, y1, wy1, wy0 = _taps(table, oh, 0)
    x0, x1, wx1, wx0 = _taps(table, ow, 4 * oh)
    col = (-1,) + (1,) * (img.dim() - 1)
    rows = img[y0].float() * wy0.view(col) + img[y1].float() * wy1.view(col)
    row = (1, -1) + (1,) * (img.dim() - 2)
    out = rows[:, x0] * wx0.view(row) + rows[:, x1] * wx1.view(row)
    return out.round().clamp(0, 255)


def _fill_slot(slot, img):
    """Write `img` (h, w[, c]) into `slot` (hp, wp, oc), repeating its last
    row and column and widening one channel to `oc`."""
    hp, wp, oc = slot.shape
    h, w = img.shape[:2]
    ys = torch.arange(hp).clamp_max(h - 1)
    xs = torch.arange(wp).clamp_max(w - 1)
    slot.copy_(img.reshape(h, w, -1)[ys][:, xs].expand(hp, wp, oc))


def _luma(src):
    """The 8.8 fixed-point BT.601 luma of an (h, w, 3) uint8 image."""
    c = src.int()
    return ((29 * c[..., 0] + 150 * c[..., 1] + 77 * c[..., 2] + 128)
            >> 8).to(torch.uint8)


def downscale_plain(src, med, med_size, med_table, low, low_size,
                    low_table):
    """The kernel's arithmetic on the CPU; writes `med` and `low`."""
    gray = src if src.dim() == 2 else _luma(src)
    _fill_slot(med, _resize_plain(gray, med_size, med_table))
    _fill_slot(low, _resize_plain(src, low_size, low_table))


def _check(src, med, med_size, med_table, low, low_size, low_table):
    if src.dtype != torch.uint8 or not (
            src.dim() == 2 or src.dim() == 3 and src.shape[2] == 3):
        raise ValueError("downscale: the source must be (h, w) or (h, w, 3) "
                         "uint8")
    src_c = 1 if src.dim() == 2 else 3
    for name, out, size, table, chans in (
            ("med", med, med_size, med_table, (1,)),
            ("low", low, low_size, low_table, (src_c, 3))):
        ow, oh = int(size[0]), int(size[1])
        if (out.dtype != torch.float32 or out.dim() != 3
                or out.shape[2] not in chans):
            raise ValueError(f"downscale: {name} must be a float32 (hp, wp, "
                             f"{' or '.join(map(str, chans))}) slot")
        if not 1 <= oh <= out.shape[0] or not 1 <= ow <= out.shape[1]:
            raise ValueError(f"downscale: {name} size {(ow, oh)} does not "
                             f"fit its slot {tuple(out.shape[:2])}")
        if table.dtype != torch.int32 or table.shape != (4 * (oh + ow),):
            raise ValueError(f"downscale: {name}_table must be "
                             "resize_table's int32 words for its size")
        for t in (out, table):
            if t.device != src.device or not t.is_contiguous():
                raise ValueError("downscale: every tensor must be contiguous "
                                 "and on the source's device")
    if not src.is_contiguous():
        raise ValueError("downscale: the source must be contiguous")


def downscale(src, med, med_size, med_table, low, low_size, low_table):
    """Write one view's gray MEDIUM image into `med` and its LOW image into
    `low`, each a (hp, wp, c) float32 slot of a padded stack: `src` is
    the (h, w) or (h, w, 3) uint8 original, each size a (width, height)
    and each table `resize_table(src.shape[:2], size)` on the source's
    device. The CUDA kernel on the card, the plain version on the CPU."""
    _check(src, med, med_size, med_table, low, low_size, low_table)
    if src.device.type == "cpu":
        downscale_plain(src, med, med_size, med_table, low, low_size,
                        low_table)
        return
    if src.device.type != "cuda":
        raise ValueError("downscale: the tensors must lie on the CPU or a "
                         "CUDA device")
    fn = load("downscale_view")
    with torch.cuda.device(src.device):
        status = fn(src.data_ptr(), src.shape[1], 1 if src.dim() == 2 else 3,
                    med.data_ptr(), med_table.data_ptr(), med.shape[0],
                    med.shape[1], int(med_size[1]), int(med_size[0]),
                    low.data_ptr(), low_table.data_ptr(), low.shape[0],
                    low.shape[1], low.shape[2], int(low_size[1]),
                    int(low_size[0]), stream_ptr(src.device))
    check(status, "downscale_view")
    downscale.launches += LAUNCHES
    profiling.count("registration/device_downscales")


downscale.launches = 0
