"""The min cut of one graph-cut level on the card, every pair's
push-relabel loop in one launch.

No TPU kernel stands behind it: the JAX package cuts a level with a
plain `lax.while_loop` (`stitching_tpu/ops/graphcut.py::grid_min_cut`).
The port's plain version is `ops/graphcut._push_relabel`, which runs the
same loop as PyTorch ops; `ops/graphcut.grid_min_cut` runs it for grids
on the CPU and launches this kernel (`csrc/push_relabel.cu`) for grids on
the card. The kernel gives the plain version's cut and iteration counts
exactly: each pair runs its own loop to its own end, as the plain
version's shared loop freezes a pair once its own condition is false.

Each pair is one thread-block cluster of `cluster_size(h, w)` CTAs, one
for a 64 x 64 grid, up to eight (the portable limit) from 256 x 256 on.
"""

import torch

from . import check, load, stream_ptr

# one launch a level covers every pair's loop and its last BFS
LAUNCHES = 1
# a CTA's share of a pair's pixels (8 a thread of its 1024), and the
# largest cluster that every Hopper card schedules
PIXELS_PER_CTA = 8192
MAX_CLUSTER = 8
# scratch floats a pixel: 4 residuals, excess, sink residual, 2 heights,
# 2 pushed amounts (the BFS's distances share the first)
SCRATCH_PER_PIXEL = 10


def cluster_size(h, w):
    """CTAs a pair: enough that each holds at most PIXELS_PER_CTA of its
    pixels, at most MAX_CLUSTER."""
    return min(MAX_CLUSTER, max(1, -(-h * w // PIXELS_PER_CTA)))


def push_relabel(cap_dir, s_cap, t_cap, max_iters, global_relabel_every):
    """The min cut of P grids on the card: `ops/graphcut.grid_min_cut`'s
    contract (cap_dir (P, 4, H, W), s_cap and t_cap (P, H, W), float32,
    contiguous, on one CUDA device). Returns (src_side (P, H, W) bool,
    iterations (P,) int32), both on the card; nothing is read back."""
    if s_cap.dim() != 3 or cap_dir.shape != (s_cap.shape[0], 4,
                                             *s_cap.shape[1:]) \
            or t_cap.shape != s_cap.shape:
        raise ValueError("push_relabel: cap_dir must be (P, 4, H, W) and "
                         "s_cap, t_cap (P, H, W)")
    P, h, w = s_cap.shape
    if not (P and h and w):
        raise ValueError("push_relabel: the grids must not be empty")
    grids = (("cap_dir", cap_dir), ("s_cap", s_cap), ("t_cap", t_cap))
    for name, x in grids:
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"push_relabel: {name} must be contiguous "
                             "float32")
    if any(x.device.type != "cuda" or x.device != s_cap.device
           for _, x in grids):
        raise ValueError("push_relabel: the grids must lie on one CUDA "
                         "device (the plain version runs on the CPU)")
    if 4 * h * w >= 2 ** 31:
        raise ValueError("push_relabel: a grid's residuals must fit int32 "
                         "indices (4 * h * w < 2**31)")
    if global_relabel_every < 1 or max_iters < 0:
        raise ValueError("push_relabel: global_relabel_every must be >= 1 "
                         "and max_iters >= 0")
    dev = s_cap.device
    scratch = torch.empty(P * h * w * SCRATCH_PER_PIXEL, dtype=torch.float32,
                          device=dev)
    src_side = torch.empty((P, h, w), dtype=torch.bool, device=dev)
    iters = torch.empty(P, dtype=torch.int32, device=dev)
    fn = load("push_relabel")
    with torch.cuda.device(dev):
        status = fn(cap_dir.data_ptr(), s_cap.data_ptr(), t_cap.data_ptr(),
                    scratch.data_ptr(), src_side.data_ptr(),
                    iters.data_ptr(), P, h, w, int(max_iters),
                    int(global_relabel_every), cluster_size(h, w),
                    stream_ptr(dev))
    check(status, "push_relabel")
    push_relabel.launches += LAUNCHES
    return src_side, iters


push_relabel.launches = 0
