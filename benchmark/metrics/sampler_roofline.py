"""`sampler_roofline`: the bilinear sampler's share of its bound, in %.

The bound is the least time the warps of the profiled stitches need at
the H100's published 3.35 TB/s of HBM (NVIDIA's data sheet, SXM). It
counts the work, not the calls: from what each stitch decided (its
cameras and crop, `ctx.stitches`) and the views' shapes it works out, as
OpenStitching's pipeline places them (`reference.layout`), every view
warped at LOW into its whole ROI (the crop is planned on those) and at
FINAL into its part of the crop. A warp writes its output once as
float32 and reads its source once as float32, the source counted at no
more than the output's pixels. The coordinates are left out: a sampler
that computes them inside needs no such bytes. So a sampler that is
fused into another kernel, or does less than the whole ROIs, is still
read against the same bound. The time is the device time of the kernels
named in `KERNELS`; where none ran, the metric is absent.
"""

import statistics

HBM_BYTES_PER_S = 3.35e12
KERNELS = ("bilinear_sample_kernel",)
F32 = 4


def warp_bytes(src_px, out_px, channels):
    """Bytes one view's warp must move: its output written once, its
    source read once but never counted above the output's pixels."""
    return (out_px + min(src_px, out_px)) * channels * F32


def stitch_bytes(shapes, cameras, lir, settings):
    """Bytes of every warp of one stitch: views of (h, w, c) `shapes`,
    the program's `cameras` and crop `lir` (None: no crop)."""
    from benchmark import reference

    kind = settings["warper"]
    sizes = [(s[1], s[0]) for s in shapes]
    chans = [s[2] if len(s) > 2 else 1 for s in shapes]
    s_med = reference.megapix_scale(settings["medium_megapix"], sizes[0])
    base = statistics.median(c["focal"] for c in cameras)
    total = 0

    def rois(megapix):
        s = reference.megapix_scale(megapix, sizes[0])
        for cam, wh in zip(cameras, sizes):
            K = reference.camera_K(cam, s / s_med)
            src = reference.scaled_size(wh, s)
            _, (w, h) = reference.warp_roi(src, K, cam["R"],
                                           base * s / s_med, kind)
            yield src[0] * src[1], w * h

    for (src, out), c in zip(rois(settings["low_megapix"]), chans):
        total += warp_bytes(src, out, c)
    fin = list(rois(settings["final_megapix"]))
    if lir is not None:
        lay = reference.layout(cameras, sizes, lir, settings)
        fin = [(src, v["over"][2] * v["over"][3])
               for (src, _), v in zip(fin, lay["views"])]
    for (src, out), c in zip(fin, chans):
        total += warp_bytes(src, out, c)
    return total


def read(ctx):
    ns = sum(e - s for name, s, e in ctx.device
             if any(k in name for k in KERNELS))
    if ns <= 0 or not ctx.stitches:
        return None
    nbytes = sum(stitch_bytes(shapes, last["cameras"], last.get("lir"),
                              ctx.settings)
                 for shapes, last in ctx.stitches)
    return 100.0 * nbytes / HBM_BYTES_PER_S / (ns / 1e9)
