"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit), the versions and a
   digest of the detectors' static tables;
2. builds every CUDA kernel of the port from `stitching_tpu_torch/csrc`,
   then holds the two 2-NN kernels against their plain versions at the
   shapes where their tiles end (query rows around 16 and 64, targets
   around 8, 64 and 1024, other descriptor widths, binary rows of 257,
   486 and 512 bits among them, ties planted across every kind of edge,
   forced grids, the ends of the binary fold key's range), before
   anything is timed; then splits the binary pairs call into its phases
   (pre-pass, search, merge, search without the fold) at 256 and at 512
   bits, in the kernel's design and in the one it replaced
   (`csrc/two_nn_key32.cu`);
3. drives the port's paths on 8 rendered views of 1600x1200 (the bench
   workload: focal 1400, +-0.6 rad), each once to warm up and once with
   the kernels' launch counters set to 0 just before and read just after,
   and fails unless each kernel of the path launched as often as the path
   states (on the downscaled branch the FINAL pass streams per image: one
   batched LOW warp and one FINAL warp per kept view):
   - `Stitcher(**SLICE).stitch` (the first slice),
   - `Stitcher(**SLICE2).stitch` (bundle adjustment, wave correction,
     crop, block-gain exposure), with its stages timed between syncs,
   - `Stitcher().stitch`, every default setting (adds the dp_color seams
     and the multiband blend), with the profiler's fenced stage table,
     the blend's memory plan and the card's peak memory,
   - `Stitcher(finder="gc_color").stitch` (the graph-cut seams), staged
     the same way, with each graph-cut level's iterations, global
     relabels, host syncs and seconds,
   - `Stitcher(warper_type="cylindrical").stitch` (another surface),
   - `AffineStitcher().stitch` on a scan: 8 translated 1600x1200 crops of
     one textured scene, each crop's recovered offset from its neighbour
     held to 1 px of the truth,
   - `Stitcher(detector=X).stitch` for X = sift, brisk and akaze (SIFT's
     float rows through the float 2-NN kernel, BRISK's and AKAZE's
     512-bit rows through the binary one) and `AffineStitcher(detector=
     "sift").stitch` on the scan, each with its profiler stage table
     (`registration/detect` among the stages) and its cameras held to the
     truth,
   - `pipeline.register_pair` on the first two views at MEDIUM size, and
     on `__graft_entry__.entry`'s two crops at its 256 features and 128
     RANSAC draws (`n_iters`), held to the CPU run of the same call
     (inliers equal, H within 1e-4) and to the 80 px shift,
   - the matchers on float descriptors (128 wide, made from a seed):
     `FeatureMatcher.match_features` and `ops.match.match_pair`,
   - `Stitcher().stitch_verbose` (the step-by-step component API: no
     sampler launch, one 2-NN launch), with every artifact's name checked,
     its wall beside a `stitch()` wall and a fenced stage table,
   - `cli.stitch.main()` in this process on the views written as PNG, its
     panorama equal to `Stitcher().stitch` on the same files;
   - `Stitcher(mesh=make_mesh())`, the mesh of one NCCL rank in this
     process (the sync branch: one batched LOW and one batched FINAL
     warp), with its peak memory and a `Stitcher()` wall beside it;
4. the mesh phases: the one-rank mesh's panorama against the non-mesh
   composite at its cameras, and `STRIPS["x"]` split over it against the
   non-mesh strips (equal); then the group is destroyed and two ranks,
   each a process of its own (`chip_smoke.py --mesh-rank`), share the
   card over gloo: each stitches the views (its images, pairs, launches
   and wall printed, the walls no scaling numbers), the two panoramas
   equal bit for bit, and at the one-rank run's cameras within 1 LSB of
   its panorama, and each holds the strips split over both ranks (tiles
   sent point to point) against the non-mesh strips; then
   the slice-8 phases: the CLI in a process of its own on 3 views, plain,
   with -v and with --preview (written, and the no-GUI notice on
   stderr); `stitch_verbose` on 3 views against the CPU's run with
   the card's registration; the verbose run's cameras saved and loaded;
   then the slice-6 phases: the streamed FINAL pass against the batched one on
   the same cameras; `Stitcher.stitch_device` on a prestaged stack; a
   109.4 MP canvas (6 tiles of 5120x4096, `scripts/giant_bench.py`'s
   layout) through the streamed monolithic blend against the batched
   blend of the same stack; X strips on a wide row and Y strips on a tall
   grid against their monolithic blends; `Stitcher(timelapse="as_is")`
   on 3 views against the CPU run's frames; each of SIFT, BRISK and AKAZE
   on one MEDIUM view against the port's own CPU run;
5. holds each kernel against its plain PyTorch version on the very inputs
   the paths gave it (the sampler at the batched LOW and the per-image
   FINAL calls; the region count on every LOW panorama mask a path with
   the crop on planned from, also against the host flood fill it
   replaces; the MEDIUM/LOW downscale, against the host downscale it
   replaces, bit for bit, at 6 views of 4032x3024 and 8 of 1600x1200;
   the graph cut's push-relabel at the graph-cut cell's two levels, 14
   pairs at 64 x 64 and in the band at 256 x 256, cut and iterations
   equal to the plain loop's on the card),
   and times kernel, plain version (for the region count: the host flood
   fill, for the downscale: the host downscale and upload of a view, for
   the graph cut: the plain loop, which reads the host, on the host's
   clock) and, where one exists, a
   PyTorch library call computing the same function (device time per
   call from a CUDA graph replay; the kernel wrapper's CUDA-event time,
   host launch included, beside it), and the launch floor: an empty
   kernel launched as often as the call launches kernels (counted by
   capturing one call, and held against what the wrapper's module
   states);
6. profiles one `SLICE2` stitch and one default stitch (device busy
   share, the device operations that take longest);
7. checks the output: the cameras against the rendered ground truth, the
   pair's homography against the rendered one, and the card's panoramas
   against the CPU's on a small input (3 views of 640x480) with the same
   cameras: both slices, the defaults, every other surface, the gain and
   channel compensators, both graph-cut finders and `AffineStitcher` on a
   small scan;
8. prints the kernels line, the card line and, last, the result line.

Any failure raises and exits non-zero; so does a machine without CUDA.
"""

import copy
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_FLOPS_PER_S = 67e12
# 1-bit operands have no published peak. scripts/probe_mma_rate.cu measured
# the `m16n8k256 .and.popc` product at 21,703 bit products a clock an SM on
# this card (as many instructions a clock as the int8 `mma`, each 8 times as
# deep), 5.3 times the 4,096 byte products a clock an SM behind the int8
# peak: a rate the card has shown, so a lower bound of its 1-bit peak
B1_OPS_PER_S = 5.3 * INT8_OPS_PER_S

FOCAL = 1400.0
MAX_ANGLE = 0.6
N_VIEWS = 8
# kernel launches of one stitch on the downscaled branch: one MEDIUM/LOW
# downscale per view, one 2-NN call over all pairs, one batched LOW warp
# and one FINAL warp per kept view
STITCH_LAUNCHES = {"two_nn_pairs": 1, "two_nn": 0,
                   "bilinear_sample": 1 + N_VIEWS, "downscale": N_VIEWS}
# kernel launches of one stitch under a mesh, each rank: the sync branch
# (the MEDIUM resize on the host, one batched LOW and one batched FINAL
# warp of its images) and one 2-NN call over its pairs
MESH_LAUNCHES = {"two_nn_pairs": 1, "two_nn": 0, "bilinear_sample": 2,
                 "downscale": 0}
# the two-rank phase: processes of their own sharing the one card over
# gloo, each with a time limit
MESH_RANKS = 2
MESH_RANK_DEVICE = "cuda:0"
MESH_RANK_TIMEOUT = 600
# scripts/giant_bench.py's layout: (rows, cols) of (h, w) tiles at (y, x)
# steps, a 14480 x 7556 canvas (109.4 MP), blended under the port's
# default budget (its accumulators pass it)
GIANT = dict(grid=(3, 2), tile=(5120, 4096), step=(4680, 3460), budget=4e9)
# strips: a wide row and a tall grid of (h, w) tiles at (y, x) steps, each
# with a budget under its accumulators' estimate
STRIPS = {"x": dict(grid=(1, 24), tile=(1200, 1600), step=(0, 1400),
                    budget=2e9, stream_fetch=True),
          "y": dict(grid=(8, 2), tile=(1200, 1600), step=(1000, 1400),
                    budget=1e9, stream_fetch=False)}


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def textured_scene(h=1000, w=1800, seed=0, blocks=500):
    """`tests/fixtures.textured_scene` without OpenCV: corner-rich blocks,
    two low-frequency gradients and a 5-tap Gaussian blur (sigma 1.2)."""
    rng = np.random.RandomState(seed)
    img = np.zeros((h, w, 3), np.float32)
    img[:] = rng.uniform(40, 80, 3)
    for _ in range(blocks):
        x, y = rng.randint(0, w - 10), rng.randint(0, h - 10)
        bw, bh = rng.randint(4, 60), rng.randint(4, 60)
        color = rng.uniform(0, 255, 3)
        img[y:y + bh, x:x + bw] = 0.5 * img[y:y + bh, x:x + bw] + 0.5 * color
    yy, xx = np.mgrid[0:h, 0:w]
    img[..., 0] += 20 * np.sin(xx / 97.0)
    img[..., 1] += 20 * np.cos(yy / 71.0)
    img = np.clip(img, 0, 255).astype(np.uint8).astype(np.float32)
    k = np.exp(-np.arange(-2, 3) ** 2 / (2 * 1.2 ** 2))
    k /= k.sum()
    for axis in (0, 1):
        pad = [(0, 0)] * 3
        pad[axis] = (2, 2)
        p = np.pad(img, pad, mode="reflect")
        n = img.shape[axis]
        img = sum(k[i] * np.take(p, np.arange(i, i + n), axis=axis)
                  for i in range(5))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def rotation_set(n, size, focal, max_angle, device):
    """n views of the scene from a purely rotating camera, rendered on the
    card by the inverse homography H = K R^T K_scene^-1 (bilinear, black
    outside the scene). Returns (uint8 BGR images, true rotations)."""
    w, h = size
    scene = textured_scene()
    sh, sw = scene.shape[:2]
    K_scene = np.array([[focal, 0, sw / 2], [0, focal, sh / 2], [0, 0, 1.0]])
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1.0]])
    src = torch.as_tensor(scene, dtype=torch.float32,
                          device=device).permute(2, 0, 1)[None]
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float64, device=device),
        torch.arange(w, dtype=torch.float64, device=device), indexing="ij")
    pix = torch.stack([xx, yy, torch.ones_like(xx)], -1)
    imgs, Rs = [], []
    for ang in np.linspace(-max_angle, max_angle, n):
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        Hinv = np.linalg.inv(K @ R.T @ np.linalg.inv(K_scene))
        q = pix @ torch.as_tensor(Hinv.T, device=device)
        sx = q[..., 0] / q[..., 2]
        sy = q[..., 1] / q[..., 2]
        grid = torch.stack([2 * sx / (sw - 1) - 1, 2 * sy / (sh - 1) - 1],
                           -1).to(torch.float32)[None]
        out = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=True)[0].permute(1, 2, 0)
        imgs.append(out.round().clamp(0, 255).to(torch.uint8).cpu().numpy())
        Rs.append(R)
    return imgs, Rs


def scan_set(n, size, seed=0):
    """n translated crops of one textured scene, as
    `tests/fixtures.affine_set` makes them: each 55% of the width right of
    the last, every other one 12 px lower (a flatbed or drone scan), the
    scene as dense in blocks as the rotation set's. Returns (uint8 BGR
    crops, their (x, y) offsets in the scene)."""
    w, h = size
    step = int(w * 0.55)
    sh, sw = h + 80, step * (n - 1) + w + 80
    scene = textured_scene(sh, sw, seed, blocks=int(500 * sh * sw / 1.8e6))
    offsets = [(40 + i * step, 40 + (i % 2) * 12) for i in range(n)]
    return ([np.ascontiguousarray(scene[y:y + h, x:x + w])
             for x, y in offsets], offsets)


def graft_crops():
    """`__graft_entry__.entry`'s two crops, rebuilt here with numpy (that
    module imports JAX): two 256 x 320 views of one structured scene, the
    second 80 px right of the first."""
    rng = np.random.RandomState(0)
    scene = np.zeros((300, 460), np.float32)
    for _ in range(250):
        x, y = rng.randint(0, 440), rng.randint(0, 280)
        w, h = rng.randint(4, 24), rng.randint(4, 24)
        scene[y:y + h, x:x + w] += rng.uniform(20, 90)
    scene = np.clip(scene, 0, 255)
    return scene[20:276, 0:320], scene[20:276, 80:400]


def time_ms(fn, iters):
    """Mean milliseconds per call on the card (CUDA events, warmed up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters):
    """Mean milliseconds per call of `fn` replayed from one CUDA graph of
    `iters` calls: the device's time for the calls back to back, without
    the host's launch overhead between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def times_text(t):
    return " ".join(f"{'kernel_ms' if k == 'ms' else k}="
                    f"{'none' if v is None else f'{v:.5f}'}"
                    for k, v in t.items())


def host_ms(fn, iters):
    """Mean milliseconds per call of `fn` on the host's clock (warmed up);
    for a plain version that runs on the host."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def kernel_times(kernel, plain, launches, library=None, iters=20,
                 plain_on_host=False):
    """ms, plain_ms and library_ms of one function on the same inputs,
    each from a CUDA graph replay (plain_ms on the host's clock where the
    plain version runs on the host: `plain_on_host`); call_ms is the
    CUDA-event time of back-to-back calls of the kernel's wrapper, host
    launch included; floor_ms is the graph-replay time of an empty kernel
    launched `launches` times, as often as one call of `kernel` launches
    kernels."""
    from stitching_tpu_torch.ops import kernels

    empty = kernels.load("launch_floor")
    dev = torch.device("cuda")
    return {"ms": graph_ms(kernel, iters),
            "call_ms": time_ms(kernel, iters),
            # the stream is read inside the capture: it is the graph's own
            "floor_ms": graph_ms(
                lambda: kernels.check(empty(launches,
                                            kernels.stream_ptr(dev)),
                                      "launch_floor"), iters),
            "plain_ms": (host_ms if plain_on_host else graph_ms)(
                plain, max(iters // 4, 3)),
            "library_ms": None if library is None else graph_ms(library,
                                                                iters)}


def launched_kernels(fn, expect, what):
    """Kernels one call of `fn` launches, counted by capturing the call on
    a side stream (nothing captured runs); fails unless that equals
    `expect`, the figure the wrapper's module states."""
    from stitching_tpu_torch.ops import kernels

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        kernels.check(kernels.load("capture_begin")(
            ctypes.c_void_p(side.cuda_stream)), "capture_begin")
        try:
            fn()
        finally:
            seen = kernels.load("capture_end")(
                ctypes.c_void_p(side.cuda_stream))
    if seen != expect:
        raise AssertionError(f"{what}: one call launched {seen} kernels "
                             f"(negative: a CUDA error), {expect} expected")
    return seen


def two_nn_launches(call, nq, nt, batch, is_binary, d, what):
    """Kernels one 2-NN call launches: counted, and held against what the
    wrapper's module states for the planned grid."""
    from stitching_tpu_torch.ops.kernels import two_nn as nn

    splits = nn.launch_plan(nq, nt, batch, nn._sm_count(torch.device("cuda")),
                            bool(is_binary), d)[1]
    return launched_kernels(call, nn.kernel_launches(splits), what)


class Recorder:
    """Stands in for a kernel wrapper at its call site in the port and
    keeps the arguments of every call; the wrapper itself still runs and
    counts its launches."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.fn(*args, **kwargs)


def bounds_of(nbytes, ops, ops_per_s):
    """bound_ms and bound_by from the bytes moved and operations done."""
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
              "operations": ops / ops_per_s * 1e3}
    by = max(bounds, key=bounds.get)
    return dict(bound_ms=bounds[by], bound_by=by), bounds


def float_two_nn_err(got, ref, desc_q, desc_t, what):
    """The float 2-NN's stated tolerance: d0 and d1 within 1e-3 relative +
    1e-3 absolute of the plain version's; i0 equal wherever the plain
    d1 - d0 exceeds twice that, and elsewhere a target no further than the
    plain d1. desc_q/desc_t: (..., N, D) with the outputs' leading axes.
    Returns the largest absolute error of d0 and d1 at valid targets."""
    (gd0, gd1, gi0), (rd0, rd1, ri0) = got, ref
    tol0 = 1e-3 * rd0.abs() + 1e-3
    tol1 = 1e-3 * rd1.abs() + 1e-3
    if not (bool(((gd0 - rd0).abs() <= tol0).all())
            and bool(((gd1 - rd1).abs() <= tol1).all())):
        raise AssertionError(f"{what}: distances differ from the plain "
                             "version beyond 1e-3 relative + 1e-3")
    clear = (rd1 - rd0) > 2 * tol0
    if not torch.equal(gi0[clear], ri0[clear]):
        raise AssertionError(f"{what}: i0 differs from the plain version "
                             "where its two nearest are apart")
    near = (rd0 < 1e29) & ~clear
    picked = torch.gather(
        desc_t, -2, gi0.long()[..., None].expand(*gi0.shape,
                                                 desc_t.shape[-1]))
    direct = ((desc_q.double() - picked.double()) ** 2).sum(-1)
    if not bool((direct[near] <= rd1[near] * 1.001 + 1e-3).all()):
        raise AssertionError(f"{what}: i0 is not one of the two nearest")
    real = rd1 < 1e29
    if not bool(real.any()):
        return 0.0
    return float(torch.stack([(gd0 - rd0).abs()[real].max(),
                              (gd1 - rd1).abs()[real].max()]).max())


def equal_two_nn_pairs(call, what):
    """`two_nn_pairs` (binary) equal to its plain version on one recorded
    call, without timing it."""
    from stitching_tpu_torch.ops.kernels.two_nn import (two_nn_pairs,
                                                        two_nn_pairs_plain)

    args, kw = call
    out = two_nn_pairs(*args, **kw)
    ref = two_nn_pairs_plain(*args, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("d0", "d1", "i0"), out, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"{what} {name} differs from the plain "
                                 "version")
    print(f"{what} desc {tuple(args[0].shape)}: equal to plain", flush=True)


def check_two_nn_pairs(call, what):
    """`two_nn_pairs` against its plain version on one recorded call."""
    from stitching_tpu_torch.ops.kernels.two_nn import (two_nn_pairs,
                                                        two_nn_pairs_plain)

    (desc, valid, pair_ij), kw = call
    is_binary = kw.get("is_binary", True)
    out = two_nn_pairs(desc, valid, pair_ij, **kw)
    ref = two_nn_pairs_plain(desc, valid, pair_ij, **kw)
    torch.cuda.synchronize()
    if is_binary:
        for name, a, b in zip(("d0", "d1", "i0"), out, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"{what} {name} differs from the "
                                     "plain version")
        err = 0.0
    else:
        pij = pair_ij.long()
        err = float_two_nn_err(out, ref, desc[pij], desc[pij.flip(1)], what)
    B, N, D = desc.shape
    P = pair_ij.shape[0]
    def kernel():
        return two_nn_pairs(desc, valid, pair_ij, **kw)

    times = kernel_times(
        kernel, lambda: two_nn_pairs_plain(desc, valid, pair_ij, **kw),
        two_nn_launches(kernel, N, N, 2 * P, is_binary, D, what), iters=50)
    nbytes = (desc.numel() * 4 + valid.numel() + pair_ij.numel() * 4
              + 3 * P * 2 * N * 4)
    # the distance products: 2 operations per element pair; 1-bit tensor
    # products for {0,1} rows, float32 FMAs outside the tensor cores
    # otherwise. One N x N product per pair serves both directions (the
    # backward direction's is its transpose)
    ops = 2.0 * P * N * N * D
    bound, both = bounds_of(nbytes, ops, B1_OPS_PER_S if is_binary
                            else FP32_FLOPS_PER_S)
    print(f"{what} desc {tuple(desc.shape)} P={P}: max_abs_err={err:.3g} "
          f"against plain; {times_text(times)} bound_us "
          f"bytes={both['bytes'] * 1e3:.2f} "
          f"ops={both['operations'] * 1e3:.2f}", flush=True)
    return dict(max_abs_err=err, **bound, **times)


def check_two_nn(calls, what):
    """`two_nn` against its plain version on the recorded calls, and (for
    binary rows of equal count) against `two_nn_pairs`' forward direction:
    with a padded column under both paddings the two are equal exactly.
    Also a rectangular case: the first call's queries against its first
    300 targets. Times the first call."""
    from stitching_tpu_torch.ops.kernels.two_nn import (two_nn,
                                                        two_nn_pairs,
                                                        two_nn_plain)

    (q, t, vt), kw = calls[0]
    is_binary = kw.get("is_binary", True)
    cases = [c[0] for c in calls] + [(q, t[:300].contiguous(), vt[:300])]
    err = 0.0
    for dq, dt, dv in cases:
        out = two_nn(dq, dt, dv, **kw)
        ref = two_nn_plain(dq, dt, dv, **kw)
        torch.cuda.synchronize()
        if is_binary:
            for name, a, b in zip(("d0", "d1", "i0"), out, ref):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"{what} {name} differs from the plain version at "
                        f"{tuple(dq.shape)} x {tuple(dt.shape)}")
        else:
            err = max(err, float_two_nn_err(out, ref, dq, dt, what))
    if (is_binary and q.shape[0] == t.shape[0] and q.shape[0] % 128
            and q.shape[0] % 8):
        pair = torch.tensor([[0, 1]], dtype=torch.int32, device=q.device)
        both = two_nn_pairs(torch.stack([q, t]),
                            torch.stack([torch.ones_like(vt), vt]), pair)
        for name, a, b in zip(("d0", "d1", "i0"), two_nn(q, t, vt), both):
            if not torch.equal(a, b[0, 0]):
                raise AssertionError(f"{what} {name} differs from "
                                     "two_nn_pairs' forward direction")
    nq, D = q.shape
    nt = t.shape[0]

    def kernel():
        return two_nn(q, t, vt, **kw)

    times = kernel_times(kernel, lambda: two_nn_plain(q, t, vt, **kw),
                         two_nn_launches(kernel, nq, nt, 1, is_binary, D,
                                         what),
                         iters=50)
    nbytes = (nq + nt) * D * 4 + nt + 3 * nq * 4
    ops = 2.0 * nq * nt * D
    bound, both = bounds_of(nbytes, ops, B1_OPS_PER_S if is_binary
                            else FP32_FLOPS_PER_S)
    print(f"{what} {nq} x {nt} x {D} (and {nq} x 300): max_abs_err="
          f"{err:.3g} against plain; {times_text(times)} bound_us "
          f"bytes={both['bytes'] * 1e3:.2f} "
          f"ops={both['operations'] * 1e3:.2f}", flush=True)
    return dict(max_abs_err=err, **bound, **times)


def check_sampler(calls, timed):
    """`bilinear_sample` against its plain version on every recorded call;
    timed at the largest of the `timed` calls."""
    from stitching_tpu_torch.ops.kernels.bilinear_sample import (
        bilinear_sample, bilinear_sample_plain)

    errs = []
    for (data, sxc, syc, care), _ in calls:
        out = bilinear_sample(data, sxc, syc, care)
        ref = bilinear_sample_plain(data, sxc, syc, care)
        torch.cuda.synchronize()
        err = float((out - ref).abs()[care].max())
        if not err <= 2e-3:
            raise AssertionError(f"bilinear_sample differs from the plain "
                                 f"version by {err} at care pixels")
        errs.append(err)
        print(f"bilinear_sample data {tuple(data.shape)} coords "
              f"{tuple(sxc.shape)}: max_abs_err={err}", flush=True)
    # time at the FINAL call, the larger of the two
    (data, sxc, syc, care), _ = max(timed, key=lambda c: c[0][0].numel())
    B, H, W, C = data.shape
    th, tw = sxc.shape[1:]
    # library yardstick: one grid_sample on the same samples (NCHW input
    # and a normalised grid prepared outside the timing)
    planes = data.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([2 * sxc / (W - 1) - 1, 2 * syc / (H - 1) - 1], -1)
    lib = F.grid_sample(planes, grid, mode="bilinear",
                        padding_mode="border", align_corners=True)
    lib_err = float((lib.permute(0, 2, 3, 1)
                     - bilinear_sample(data, sxc, syc, care)).abs()[care]
                    .max())

    def kernel():
        return bilinear_sample(data, sxc, syc, care)

    times = kernel_times(
        kernel, lambda: bilinear_sample_plain(data, sxc, syc, care),
        launched_kernels(kernel, 1, "bilinear_sample"),
        lambda: F.grid_sample(planes, grid, mode="bilinear",
                              padding_mode="border", align_corners=True))
    # the stack, both coordinate planes and the output; `care` is not read
    nbytes = data.numel() * 4 + sxc.numel() * 8 + B * th * tw * C * 4
    ops = 9.0 * B * th * tw * C
    bound, both = bounds_of(nbytes, ops, FP32_FLOPS_PER_S)
    print(f"bilinear_sample timing at {tuple(sxc.shape)}: {times_text(times)} "
          f"(library: grid_sample, max diff {lib_err:.3g}) bound_us "
          f"bytes={both['bytes'] * 1e3:.2f} "
          f"ops={both['operations'] * 1e3:.2f}", flush=True)
    return dict(max_abs_err=max(errs), **bound, **times)


def check_components(by_path, timed):
    """`count_components` on every LOW panorama mask the paths handed it:
    its count against the plain version's and against the host flood fill
    (`single_region` on the mask moved to the host: one region exactly when
    the count is 1). Timed at the masks of the paths in `timed` (the
    default path's has the 12 MP cell's LOW shape, the scan's the scan
    cell's); the plain time is the host flood fill's, the loop the card
    path replaces. No PyTorch call counts regions: no library column."""
    from stitching_tpu_torch import cropper
    from stitching_tpu_torch.ops.kernels.components import (
        LAUNCHES, count_components, count_components_plain)

    n_masks = 0
    for path, calls in by_path.items():
        for (mask,), _ in calls:
            n = int(count_components(mask))
            torch.cuda.synchronize()
            host = mask.cpu()
            plain = int(count_components_plain(host))
            flood = cropper.single_region(host.numpy()) is not None
            if n != plain or flood != (n == 1):
                raise AssertionError(
                    f"count_components on the {path} path's mask "
                    f"{tuple(mask.shape)}: {n} regions, plain {plain}, "
                    f"host flood fill one region: {flood}")
            n_masks += 1
    if not n_masks:
        raise AssertionError("count_components was not called on any path")
    print(f"count_components: {n_masks} LOW masks of {len(by_path)} paths "
          "equal to plain and to the host flood fill", flush=True)
    rows = {}
    for path in timed:
        (mask,), _ = by_path[path][-1]
        h, w = mask.shape
        host = mask.cpu().numpy()

        def kernel():
            return count_components(mask)

        times = kernel_times(
            kernel, lambda: cropper.single_region(host),
            launched_kernels(kernel, LAUNCHES, "count_components"),
            iters=50, plain_on_host=True)
        # the mask read once, the int32 parents written once and read once
        nbytes = 9.0 * h * w
        bound, both = bounds_of(nbytes, 0.0, FP32_FLOPS_PER_S)
        print(f"count_components timing at the {path} path's LOW mask "
              f"{h}x{w}: {times_text(times)} (plain: the host flood fill; "
              f"no library call) bound_us bytes={both['bytes'] * 1e3:.2f}",
              flush=True)
        rows[path] = dict(shape=[h, w], **bound, **times)
    # the table's row: the largest mask
    path = max(rows, key=lambda p: rows[p]["shape"][0] * rows[p]["shape"][1])
    return dict(max_abs_err=0.0, timed_at=path, by_shape=rows,
                **{k: v for k, v in rows[path].items() if k != "shape"})


# the benchmark's view shapes: (views, (w, h)) of the 12 MP cells and of
# the scan cell (and of this script's paths)
DOWNSCALE_SHAPES = {"12mp": (6, (4032, 3024)), "scan": (8, (1600, 1200))}


def check_downscale(dev):
    """The registration inputs made on the card
    (`engine._downscale_landed`: one `downscale` launch a view, each after
    its upload lands) against the host path they replace (`stack_images`
    of `engine._host_downscale`), bit for bit, on random views of each shape
    of `DOWNSCALE_SHAPES`. Timed per view at each shape: the kernel, and
    as the plain time the host downscale of one view and the upload of
    its two small images, on the host's clock. The byte bound counts each
    source row the taps read once and each slot written once. No PyTorch
    call computes it: no library column."""
    from stitching_tpu_torch import engine
    from stitching_tpu_torch.images import Images
    from stitching_tpu_torch.ops.kernels.downscale import (
        LAUNCHES, downscale, resize_table)
    from stitching_tpu_torch.pipeline import stack_images
    from stitching_tpu_torch.transfer import Uploader

    rng = np.random.RandomState(19)
    rows = {}
    for name, (n, (w, h)) in DOWNSCALE_SHAPES.items():
        views = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
                 for _ in range(n)]
        images = Images.of(views)
        list(images)
        med = images.get_scaled_img_sizes(Images.Resolution.MEDIUM)
        low = images.get_scaled_img_sizes(Images.Resolution.LOW)
        up = Uploader(views, device=dev)
        got = engine._downscale_landed(up, views, med, low, dev)
        up.join()
        torch.cuda.synchronize()
        gray, colour = engine._host_downscale(views, med, low)
        for g, want in zip(got, (gray, colour)):
            ref = stack_images(want, "cpu")
            if not (torch.equal(g.data.cpu(), ref.data)
                    and np.array_equal(g.sizes, ref.sizes)):
                raise AssertionError(f"downscale at {n} x {w}x{h}: the "
                                     "card's stacks differ from the host's")
        src = torch.from_numpy(views[0]).to(dev)
        medium, low_stack = got
        t_med, t_low = (torch.from_numpy(resize_table((h, w), s)).to(dev)
                        for s in (med[0], low[0]))

        def kernel():
            downscale(src, medium.data[0], med[0], t_med, low_stack.data[0],
                      low[0], t_low)

        def host():
            g1, c1 = engine._host_downscale(views[:1], med[:1], low[:1])
            stack_images(g1, dev), stack_images(c1, dev)
            torch.cuda.synchronize()

        times = kernel_times(
            kernel, host, launched_kernels(kernel, LAUNCHES, "downscale"),
            iters=50, plain_on_host=True)
        # the source rows the taps name (both outputs, each row once), the
        # two slots written
        taps = set()
        for s in (med[0], low[0]):
            table = resize_table((h, w), s)
            taps.update(table[:2 * int(s[1])].tolist())
        nbytes = (len(taps) * w * 3 + medium.data[0].numel() * 4
                  + low_stack.data[0].numel() * 4)
        bound, both = bounds_of(nbytes, 0.0, FP32_FLOPS_PER_S)
        print(f"downscale: {n} views of {w}x{h} to MEDIUM {tuple(med[0])} "
              f"and LOW {tuple(low[0])} equal to the host path; one view: "
              f"{times_text(times)} (plain: the host downscale and upload; "
              f"no library call) bound_us bytes={both['bytes'] * 1e3:.2f} "
              f"({len(taps)} of {h} rows read)", flush=True)
        rows[name] = dict(shape=[h, w], rows_read=len(taps), **bound,
                          **times)
    return dict(max_abs_err=0.0, timed_at="12mp", by_shape=rows,
                **{k: v for k, v in rows["12mp"].items() if k != "shape"})


# the graph-cut cell's window (`pano-gc.rot6-12mp`: 14 pairs in one 256 x
# 256 window, cut first at 64 x 64, then in a band at full size)
CUT_PAIRS, CUT_SIDE = 14, 256


def cut_levels(dev, pairs=CUT_PAIRS, side=CUT_SIDE, seed=21):
    """The grids `seam_cut_pair` hands `grid_min_cut` for `pairs` seeded
    side x side overlaps (noisy content, a corridor where the views agree,
    each view's own 25 px strip at either side): [(cap_dir, s_cap, t_cap)]
    on `dev`, the coarse level first, then the full-size level with
    everything outside the band around the coarse seam pinned."""
    from stitching_tpu_torch.ops import graphcut

    rng = np.random.RandomState(seed)
    img_i = rng.uniform(0, 255, (pairs, side, side, 3)).astype(np.float32)
    img_j = np.clip(img_i + rng.uniform(-90, 90, img_i.shape), 0,
                    255).astype(np.float32)
    for p in range(pairs):
        at = rng.randint(side // 3, 2 * side // 3)
        img_j[p, :, at:at + 12] = img_i[p, :, at:at + 12]
    only_i = np.zeros((pairs, side, side), bool)
    only_j = np.zeros((pairs, side, side), bool)
    only_i[:, :, :25] = True
    only_j[:, :, -25:] = True
    args = [torch.from_numpy(a).to(dev)
            for a in (img_i, img_j, ~(only_i | only_j), only_i, only_j)]
    cut = graphcut.grid_min_cut
    levels = []

    def keep(cap_dir, s_cap, t_cap, **kwargs):
        levels.append((cap_dir, s_cap, t_cap))
        return cut(cap_dir, s_cap, t_cap, **kwargs)

    graphcut.grid_min_cut = keep
    try:
        graphcut.seam_cut_pair(*args, False)
    finally:
        graphcut.grid_min_cut = cut
    return levels


def l2_bytes_per_s(dev, nbytes=12 << 20):
    """Bytes a second of a copy whose source and destination (2 x 12 MB)
    stay in the card's 50 MB L2, from a CUDA graph replay: the L2 rate a
    plain streaming kernel reaches."""
    a = torch.empty(nbytes // 4, dtype=torch.float32, device=dev)
    b = torch.empty_like(a)
    return 2 * nbytes / (graph_ms(lambda: b.copy_(a), 50) * 1e-3)


def check_graphcut(dev):
    """`push_relabel` (one launch a graph-cut level) at the cell's two
    levels against the plain version (`ops/graphcut._push_relabel`) on the
    same grids on the card: the cut bit for bit and the longest loop's
    iterations. Timed per level: the kernel (a CUDA graph replay of the
    launch), its launch floor, and the plain version, which reads the
    host, on the host's clock. The bounds are one pass over the state
    (10 floats a pixel) an iteration of the longest loop, at the HBM rate
    and at the L2 rate of a copy that stays in L2. No PyTorch call cuts a
    graph: no library column."""
    from stitching_tpu_torch.ops import graphcut
    from stitching_tpu_torch.ops.kernels.push_relabel import (
        LAUNCHES, SCRATCH_PER_PIXEL, cluster_size, push_relabel)

    l2_rate = l2_bytes_per_s(dev)
    rows = {}
    for name, (cap, s, t) in zip(("coarse", "fine"), cut_levels(dev)):
        P, h, w = s.shape
        src, iters = push_relabel(cap, s, t, 2000, 64)
        want, stats = graphcut._push_relabel(cap, s, t, 2000, 64)
        torch.cuda.synchronize()
        n_it = stats["iterations"]
        if not torch.equal(src, want) or int(iters.max()) != n_it:
            raise AssertionError(
                f"push_relabel at the {name} level {P} x {h}x{w}: the cut or "
                f"the iterations ({int(iters.max())} against {n_it}) differ "
                "from the plain version's")

        def kernel():
            push_relabel(cap, s, t, 2000, 64)

        def plain():
            graphcut._push_relabel(cap, s, t, 2000, 64)

        times = kernel_times(
            kernel, plain, launched_kernels(kernel, LAUNCHES, "push_relabel"),
            iters=10, plain_on_host=True)
        nbytes = n_it * SCRATCH_PER_PIXEL * 4 * P * h * w
        bound, both = bounds_of(nbytes, 0.0, FP32_FLOPS_PER_S)
        l2_ms = nbytes / l2_rate * 1e3
        print(f"push_relabel at the {name} level {P} x {h}x{w} (cluster "
              f"{cluster_size(h, w)}, {n_it} iterations, pairs' "
              f"{sorted(iters.tolist())}) equal to the plain version: "
              f"{times_text(times)} (plain: the PyTorch loop on the card, "
              f"host clock; no library call) bound_ms one pass a step "
              f"hbm={both['bytes']:.5f} l2={l2_ms:.5f} (l2 rate "
              f"{l2_rate / 1e12:.2f} TB/s)", flush=True)
        rows[name] = dict(shape=[P, h, w], iterations=n_it,
                          cluster=cluster_size(h, w), l2_bound_ms=l2_ms,
                          **bound, **times)
    return dict(max_abs_err=0.0, timed_at="fine", by_shape=rows,
                **{k: v for k, v in rows["fine"].items() if k != "shape"})


# pairs of columns holding the same target row: one thread's two columns
# of an `mma` tile, two lanes of a quad, two tiles of a step, one float
# thread's next column, two float lanes, the segment's and the float
# tile's edge (64), two steps, the binary fold window's edges (128 columns
# at 512 bits, 256 at 256), a bulk copy's edges (256 rows), the binary
# staging chunk's edge (1024 rows), a window that ends past the targets
TIE_COLUMNS = [(0, 1), (4, 6), (8, 17), (3, 11), (20, 21), (63, 64),
               (60, 70), (127, 128), (1023, 1024), (1000, 1100), (2, 1299),
               (511, 512), (255, 256), (383, 384), (767, 768), (129, 1290)]


def boundary_sets(is_binary, nq, nt, d, rng):
    """Query and target rows with near-duplicates planted (every third query
    copies a target, some targets copy each other) and ~10% invalid
    targets."""
    if is_binary:
        q = (rng.rand(nq, d) > 0.5).astype(np.float32)
        t = (rng.rand(nt, d) > 0.5).astype(np.float32)
    else:
        q = rng.randn(nq, d).astype(np.float32)
        t = rng.randn(nt, d).astype(np.float32)
    for r in range(0, nq, 3):
        q[r] = t[rng.randint(nt)]
    for _ in range(max(nt // 8, 1)):
        t[rng.randint(nt)] = t[rng.randint(nt)]
    return q, t, rng.rand(nt) > 0.1


def boundary_phase(dev):
    """Both 2-NN kernels against their plain versions where their tiles
    end, binary rows bit for bit and float rows to the stated tolerance,
    then the binary pairs call's phase split (`phase_split`, which times
    only calls it has held equal first). Raises on the first
    disagreement."""
    from stitching_tpu_torch.ops.kernels import two_nn as nn

    def check(q, t, vt, is_binary, what):
        args = [torch.as_tensor(x, device=dev) for x in (q, t, vt)]
        got = nn.two_nn(*args, is_binary=is_binary)
        ref = nn.two_nn_plain(*args, is_binary=is_binary)
        torch.cuda.synchronize()
        if is_binary:
            for name, a, b in zip(("d0", "d1", "i0"), got, ref):
                if not torch.equal(a, b):
                    raise AssertionError(f"boundary {what}: {name} differs "
                                         "from the plain version")
        else:
            float_two_nn_err(got, ref, args[0], args[1], f"boundary {what}")
        return got

    def check_pairs(desc, valid, pairs, is_binary, what):
        args = [torch.as_tensor(x, device=dev) for x in (desc, valid, pairs)]
        got = nn.two_nn_pairs(*args, is_binary=is_binary)
        ref = nn.two_nn_pairs_plain(*args, is_binary=is_binary)
        torch.cuda.synchronize()
        if is_binary:
            for name, a, b in zip(("d0", "d1", "i0"), got, ref):
                if not torch.equal(a, b):
                    raise AssertionError(f"boundary {what}: {name} differs "
                                         "from the plain version")
        else:
            pij = args[2].long()
            float_two_nn_err(got, ref, args[0][pij], args[0][pij.flip(1)],
                             f"boundary {what}")

    planned = nn.launch_plan
    rng = np.random.RandomState(11)
    n_cases = 0
    for is_binary in (True, False):
        kind = "binary" if is_binary else "float"
        width = 256 if is_binary else 128
        # query rows and targets around the tiles' edges
        for nq in (1, 15, 16, 17, 63, 65, 500, 513):
            for nt in (1, 7, 8, 9, 63, 64, 65, 500, 1025, 4097):
                q, t, vt = boundary_sets(is_binary, nq, nt, width, rng)
                check(q, t, vt, is_binary, f"{kind} {nq} x {nt}")
                n_cases += 1
        q, t, vt = boundary_sets(is_binary, 70, 9000, width, rng)
        check(q, t, vt, is_binary, f"{kind} 70 x 9000")
        # other descriptor widths (130 floats: rows not 16-byte aligned; 160
        # and 256: the query chunk restaged with every step; binary rows of
        # 257, 486 and 512 bits: 16 packed words, two `mma`s a tile), as
        # rows and as pairs of a batch, a pair of an image with itself
        # included
        for d in ((32, 100, 257, 486, 512) if is_binary
                  else (4, 64, 130, 160, 256)):
            q, t, vt = boundary_sets(is_binary, 77, 203, d, rng)
            check(q, t, vt, is_binary, f"{kind} width {d}")
            desc = np.stack([q, t[:77], t[77:154]])
            valid = np.stack([np.ones(77, bool), vt[:77], vt[77:154]])
            pairs = np.asarray([[0, 1], [0, 2], [1, 2], [1, 1]], np.int32)
            check_pairs(desc, valid, pairs, is_binary,
                        f"{kind} pairs width {d}")
            n_cases += 2
        # every target invalid, with and without a padded column (and at
        # 512 bits, where an invalid target's count is largest)
        for nq, nt, d in ((40, 256, width), (40, 300, width), (1, 1, width),
                          (40, 300, 512 if is_binary else width)):
            q, t, vt = boundary_sets(is_binary, nq, nt, d, rng)
            got = check(q, t, np.zeros(nt, bool), is_binary,
                        f"{kind} all invalid {nq} x {nt} x {d}")
            if not (bool((got[2] == 0).all())
                    and bool((got[0] >= 1e29).all())):
                raise AssertionError(f"boundary {kind}: all targets invalid "
                                     "must give i0 = 0, d0 = 1e30")
            n_cases += 1
        # ties across every kind of edge, under the planned grid and forced
        # ones (query rows a block, target segments); binary rows at both
        # packed widths (at 512 bits the 256-row block too: four 16-row
        # tiles a warp), the tied queries spread over a block's warps and
        # tiles
        nt = 1300
        plans = ([None, (64, 1), (64, 3), (64, 21), (256, 1), (256, 5)]
                 if is_binary else
                 [None, (64, 1), (128, 1), (64, 3), (128, 5), (64, 21)])
        for plan, width in [(p_, w_) for w_ in ((256, 512) if is_binary
                                                 else (128,))
                            for p_ in plans]:
            if plan is not None:
                if plan[0] not in nn.rows_per_block_choices(is_binary,
                                                            width):
                    continue
                units = -(-nt // nn.SPLIT_UNIT)
                per_seg = -(-units // plan[1])
                forced = (plan[0], -(-units // per_seg),
                          per_seg * nn.SPLIT_UNIT)
                nn.launch_plan = lambda *a, forced=forced: forced
            nq = 130
            q, t, _ = boundary_sets(is_binary, nq, nt, width, rng)
            rows = [(17 * k) % nq for k in range(len(TIE_COLUMNS))]
            for k, (a, b) in enumerate(TIE_COLUMNS):
                row = ((rng.rand(width) > 0.5).astype(np.float32)
                       if is_binary else rng.randn(width).astype(np.float32))
                t[a] = t[b] = q[rows[k]] = row
                if is_binary:
                    q[rows[k], k] = 1 - q[rows[k], k]
                else:
                    q[rows[k], :4] += 0.25
            d0, d1, i0 = check(q, t, np.ones(nt, bool), is_binary,
                               f"{kind} ties, grid {plan}, width {width}")
            nn.launch_plan = planned
            want = torch.tensor([a for a, _ in TIE_COLUMNS], device=dev)
            idx = torch.tensor(rows, device=dev)
            if not (torch.equal(i0[idx].long(), want)
                    and torch.equal(d0[idx], d1[idx])):
                raise AssertionError(
                    f"boundary {kind} ties, grid {plan}, width {width}: the "
                    "lower of two equal columns must win and d1 = d0")
            n_cases += 1
        if is_binary:
            # the ends of the 16-bit fold key's range: rows of all ones
            # (the largest counts, distance 0 to each other) and of all
            # zeros (the largest distance to all ones), valid and invalid
            for width in (256, 257, 486, 512):
                q, t, vt = boundary_sets(True, 70, 1300, width, rng)
                q[:10], q[10:20] = 1.0, 0.0
                t[[5, 700, 1299]], t[[6, 900]] = 1.0, 0.0
                t[[100, 1000]], t[[101, 1001]] = 1.0, 0.0
                vt[[5, 700, 1299, 6, 900]] = True
                vt[[100, 1000, 101, 1001]] = False
                got = check(q, t, vt, True, f"binary key range {width}")
                if not (bool((got[2][:10] == 5).all())
                        and bool((got[0][:20] == 0).all())
                        and bool((got[2][10:20] == 6).all())):
                    raise AssertionError(f"boundary binary key range "
                                         f"{width}: wrong nearest")
                desc = np.stack([q[:70], t[:70], t[1230:]])
                valid = np.stack([np.ones(70, bool), vt[:70], vt[1230:]])
                pairs = np.asarray([[0, 1], [0, 2], [2, 1]], np.int32)
                check_pairs(desc, valid, pairs, True,
                            f"binary key range pairs {width}")
                n_cases += 2
    print(f"boundary shapes: {n_cases} cases of two_nn and two_nn_pairs, "
          "binary equal to plain, float within 1e-3 relative + 1e-3",
          flush=True)
    phase_split(dev)


# the binary pairs call's phases (`two_nn_pairs_binary_phase`): the whole
# call, the pre-pass, the search, the merge, the search with the fold left
# out
PHASES = {"call_ms": 0, "prepass_ms": 1, "search_ms": 2, "merge_ms": 4,
          "search_nofold_ms": 3}


def phase_split(dev):
    """The binary pairs call split into its phases at the paths' shapes (8
    images of 500 rows of 256 bits, ORB's; of 1024 rows of 512 bits,
    BRISK's and AKAZE's; 28 pairs), in the kernel's design and in the one
    it replaced (`csrc/two_nn_key32.cu`), each call first held equal to
    the plain version. Graph-replay ms per launch of each phase alone;
    the merge runs only where the plan splits the target axis."""
    from stitching_tpu_torch.ops import kernels
    from stitching_tpu_torch.ops.kernels import two_nn as nn

    rng = np.random.RandomState(17)
    pairs = torch.as_tensor(np.asarray(
        [(i, j) for i in range(8) for j in range(i + 1, 8)], np.int32),
        device=dev)
    P = pairs.shape[0]
    for d, n in ((256, 500), (512, 1024)):
        desc = torch.as_tensor((rng.rand(8, n, d) > 0.5).astype(np.float32),
                               device=dev)
        valid = torch.as_tensor(rng.rand(8, n) > 0.05, device=dev)
        ref = nn.two_nn_pairs_plain(desc, valid, pairs)
        planned = nn.launch_plan(n, n, 2 * P, nn._sm_count(dev), True, d)
        units = -(-n // nn.SPLIT_UNIT)
        # the replaced design's plan: 64-row blocks, which fill the card at
        # these shapes without a split
        runs = [("key32", "two_nn_pairs_binary_key32_phase",
                 (64, 1, units * nn.SPLIT_UNIT)),
                ("window16", "two_nn_pairs_binary_phase", planned)]
        for design, entry, (rows, splits, seg) in runs:
            fn = kernels.load(entry)
            scratch = nn._scratch(dev, 8 * n * (nn.binary_words(d) + 2), n,
                                  2 * P, splits)
            got = [torch.empty((P, 2, n), dtype=dt, device=dev)
                   for dt in (torch.float32, torch.float32, torch.int32)]

            def run(phase):
                kernels.check(fn(
                    phase, desc.data_ptr(), valid.data_ptr(),
                    pairs.data_ptr(), scratch.data_ptr(), scratch.numel(),
                    *(x.data_ptr() for x in got), 8, n, d, P,
                    int(nn._has_pad(n, nn.PAIRS_PAD)), rows, splits, seg,
                    kernels.stream_ptr(dev)), f"{entry} phase {phase}")

            run(0)
            torch.cuda.synchronize()
            for name, a, b in zip(("d0", "d1", "i0"), got, ref):
                if not torch.equal(a, b):
                    raise AssertionError(f"phase split, {d} bits, {design} "
                                         f"grid {rows, splits, seg}: {name} "
                                         "differs from the plain version")
            times = {k: (None if k == "merge_ms" and splits == 1 else
                         float(np.median([graph_ms(lambda: run(ph), 50)
                                          for _ in range(3)])))
                     for k, ph in PHASES.items()}
            print(f"phase split {d} bits, {design}, grid "
                  f"{rows}/{splits}/{seg} (equal to plain): "
                  + " ".join(f"{k}={'none' if v is None else f'{v:.5f}'}"
                             for k, v in times.items()), flush=True)


def profile_stitch(st, imgs):
    """One stitch under torch.profiler: the device's busy share of the wall
    time and the device operations that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        st.stitch(imgs)
        torch.cuda.synchronize()
        wall = time.time() - t0
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    if not ops:
        print("profile: the profiler recorded no device operations; device "
              "busy share not measured", flush=True)
        return
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
    print(f"profile (one stitch under the profiler): wall_s={wall:.4f} "
          f"device_busy_ms={busy_ms:.3f} busy_share="
          f"{busy_ms / (wall * 1e3):.4f} device_ops="
          f"{sum(e.count for e in ops)}", flush=True)
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<6d} "
              f"{e.key[:100]}", flush=True)


def composite_reg(st, reg, cameras):
    """Compositing with the given cameras on a copy of a registration made
    on the stitcher's device. Returns the panorama and the plan's crop
    rects."""
    from stitching_tpu_torch import engine

    reg = copy.copy(reg)
    reg.cameras = [c.copy() for c in cameras]
    st.warper.set_scale(reg.cameras)
    reg.scale = st.warper.scale
    plan = engine.plan_composition(st, reg)
    rects = (None if plan.crop_rects is None
             else [tuple(int(v) for v in r) for r in plan.crop_rects])
    return engine.composite(st, reg, plan), rects


class StageClock:
    """Seconds spent inside wrapped callables, each call fenced by a
    device sync before and after."""

    def __init__(self):
        self.seconds = {}

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.time() - t0)
            return out
        return timed


class CutRecorder:
    """Stands in for `ops.graphcut.grid_min_cut` and keeps, for each call,
    the grid shape, the loop's stats (iterations, global relabels, host
    reads) and its seconds (the call ends in a host read)."""

    def __init__(self, fn):
        self.fn = fn
        self.levels = []

    def __call__(self, cap_dir, *args, **kwargs):
        t0 = time.time()
        out = self.fn(cap_dir, *args, **kwargs)
        self.levels.append((tuple(cap_dir.shape), out[1], time.time() - t0))
        return out


def path_stages(name, st, imgs, pano, table=False):
    """A path's stages once more under the port's profiler with fences:
    register / LOW plan / FINAL composite between syncs, and inside them
    the profiler's stages (the seam search, the FINAL stream of warps and
    feeds, the banded collapse and copy), the graph cut's levels where it
    runs, the blend's memory plan from the `StreamComposite` the FINAL
    pass builds and the card's peak memory over the run. `table` prints
    the whole stage table. Returns the registration."""
    from stitching_tpu_torch import engine, profiling
    from stitching_tpu_torch.ops import graphcut

    plans = []
    stream_cls = engine.StreamComposite

    class Recording(stream_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            plans.append((self.p, self.C))

    cut = graphcut.grid_min_cut
    engine.StreamComposite = Recording
    graphcut.grid_min_cut = levels = CutRecorder(cut)
    profiling.enable()
    profiling.enable_fence()
    profiling.reset()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        reg = engine.register(st, imgs)
        torch.cuda.synchronize()
        t1 = time.time()
        plan = engine.plan_composition(st, reg)
        torch.cuda.synchronize()
        t2 = time.time()
        again = engine.composite(st, reg, plan)
        torch.cuda.synchronize()
        t3 = time.time()
        report = profiling.get_report()
    finally:
        engine.StreamComposite = stream_cls
        graphcut.grid_min_cut = cut
        profiling.enable(False)
        profiling.enable_fence(False)
        profiling.reset()
    peak = torch.cuda.max_memory_allocated() / 1e9
    wall = t3 - t0
    inside = {"seam_find_s": "low/seam_find",
              "final_stream_s": "final/stream",
              "final_blend_s": "final/blend"}
    print(f"{name} stages (fenced): register_s={t1 - t0:.4f} "
          f"plan_low_s={t2 - t1:.4f} composite_final_s={t3 - t2:.4f}; "
          "inside them: "
          + " ".join(f"{k}={report[v]['total_s']:.4f} "
                     f"({report[v]['total_s'] / wall:.3f} of the stages' "
                     f"{wall:.4f} s)" for k, v in inside.items()),
          flush=True)
    if table:
        print(f"{name} stage table (profiler, fenced):", flush=True)
        for k, v in sorted(report.items(), key=lambda kv: kv[0]):
            print(f"  {k:<32s} calls={v['calls']:<3d} "
                  f"total_s={v['total_s']:.4f}", flush=True)
    for shape, stats, sec in levels.levels:
        print(f"{name} graph cut level {shape} (pairs, h, w): "
              f"iterations={stats['iterations']} relabels="
              f"{stats['relabels']} host_syncs={stats['host_reads']} "
              f"seconds={sec:.4f}", flush=True)
    if levels.levels:
        print(f"{name} graph cut: {len(levels.levels)} levels, host_syncs="
              f"{sum(lv[1]['host_reads'] for lv in levels.levels)}",
              flush=True)
    (p, c), = plans
    acc = sum((p["ph"] >> lv) * (p["pw"] >> lv) * (c + 1) * 4
              for lv in range(p["nb"] + 1))
    win = sum((p["wh"] >> lv) * (p["ww"] >> lv) * (c + 1) * 4
              for lv in range(p["nb"] + 1))
    print(f"{name} blend plan (streamed): kind={p['kind']} nb={p['nb']} "
          f"window {p['wh']}x{p['ww']} canvas {p['ph']}x{p['pw']} (panorama "
          f"{p['dh']}x{p['dw']}); accumulators {acc / 1e6:.1f} MB, one "
          f"window's Laplacian and weight pyramids {win / 1e6:.1f} MB; "
          f"card peak allocated over the stages {peak:.3f} GB", flush=True)
    if not np.array_equal(pano, again):
        raise AssertionError(f"two runs of the {name} path gave different "
                             "panoramas")
    return reg


def lsb_check(what, got, want, min_equal):
    """Fails unless two uint8 images have one shape, every value within
    1 LSB and at least `min_equal` of them equal; prints the count of
    differing values."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} against "
                             f"{want.shape}")
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    n_diff = int((diff > 0).sum())
    equal = 1.0 - n_diff / diff.size
    print(f"{what}: {n_diff} of {diff.size} values differ (largest "
          f"{int(diff.max())}), {equal:.6f} equal", flush=True)
    if diff.max() > 1 or equal < min_equal:
        raise AssertionError(f"{what}: over 1 LSB or under {min_equal} "
                             "equal")


def streamed_vs_batched(imgs, dev):
    """The default FINAL pass streamed and batched on one plan: one
    registration on the uploader's branch and its LOW plan (crop rects,
    gains, seam masks); a second registration on the prestaged originals
    takes its cameras. Composited once through the streamed branch (the
    uploader) and once through the batched one (the prestaged stack), the
    panoramas are equal: the per-image warps, crops, gains, seam resizes
    and feeds are the batched stages' own code in the same order."""
    from stitching_tpu_torch import Stitcher, engine, pipeline

    st = Stitcher()
    reg_b = engine.register(st, imgs,
                            prestaged=pipeline.stack_images(imgs, dev))
    reg_s = engine.register(st, imgs)
    if reg_s.uploader is None or reg_b.uploader is not None:
        raise AssertionError("streamed/batched: wrong registration branch")
    reg_b.cameras = [c.copy() for c in reg_s.cameras]
    reg_b.scale = reg_s.scale
    plan = engine.plan_composition(st, reg_s)
    routes = []
    streamed = engine._composite_streamed
    engine._composite_streamed = lambda *a: routes.append(
        "streamed") or streamed(*a)
    try:
        pano_s = engine.composite(st, reg_s, plan)
        pano_b = engine.composite(st, reg_b, plan)
    finally:
        engine._composite_streamed = streamed
    if routes != ["streamed"]:
        raise AssertionError(f"streamed/batched: routes {routes}")
    lsb_check("streamed against batched FINAL pass (one plan)", pano_s,
              pano_b, 0.9999)


def stitch_device_phase(imgs, dev):
    """`stitch_device` on a prestaged stack: a CUDA uint8 tensor within
    4 px of the host path's shape (crop off, as the reference's test)."""
    from stitching_tpu_torch import Stitcher, pipeline

    host = Stitcher(crop=False).stitch(imgs)
    st = Stitcher(crop=False)
    stack = pipeline.stack_images(imgs, dev)
    st.stitch_device(imgs, prestaged=stack)
    torch.cuda.synchronize()
    t0 = time.time()
    out = st.stitch_device(imgs, prestaged=stack)
    torch.cuda.synchronize()
    wall = time.time() - t0
    print(f"stitch_device (prestaged, crop=False): wall_s={wall:.4f} "
          f"pano={tuple(out.shape)} {out.dtype} on {out.device}; host path "
          f"{host.shape}", flush=True)
    if (not isinstance(out, torch.Tensor) or out.device.type != dev.type
            or out.dtype != torch.uint8 or out.dim() != 3
            or max(abs(a - b) for a, b in zip(out.shape, host.shape)) > 4):
        raise AssertionError("stitch_device: not a CUDA uint8 panorama of "
                             "the host path's shape")


def tile_layout(grid, tile, step, dev, seed):
    """A TileStack of random tiles synthesized on the card from a seeded
    generator: `grid` (rows, cols) of `tile` (h, w) at `step` (y, x)."""
    from stitching_tpu_torch.compose import TileStack

    (rows, cols), (th, tw), (sy, sx) = grid, tile, step
    corners = [(c * sx, r * sy) for r in range(rows) for c in range(cols)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    data = torch.rand((len(corners), th, tw, 3), generator=gen,
                      device=dev) * 255
    masks = torch.full((len(corners), th, tw), 255.0, device=dev)
    return TileStack(data, masks, np.asarray(corners, np.int64),
                     np.asarray([(tw, th)] * len(corners), np.int64))


def giant_phase(dev, card):
    """`scripts/giant_bench.py`'s canvas: the multiband blend at strength
    5 with `stream_fetch` takes the streamed monolithic blend (the windows
    span more than a third of both axes), held within 1 LSB of the batched
    blend of the same stack (the budget raised past its accumulators)."""
    from stitching_tpu_torch import compose

    stack = tile_layout(GIANT["grid"], GIANT["tile"], GIANT["step"], dev, 0)
    b, th, tw, c = stack.data.shape
    p = compose._plan_blend(stack.corners, stack.sizes, b, "multiband", 5,
                            th, tw)
    bands = []
    collapse = compose._collapse_band
    compose._collapse_band = lambda *a, **k: bands.append(a[7:9]) \
        or collapse(*a, **k)
    try:
        compose.blend_stack(stack, None, "multiband", 5, stream_fetch=True,
                            budget=GIANT["budget"])
        bands.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        got, got_mask = compose.blend_stack(stack, None, "multiband", 5,
                                            stream_fetch=True,
                                            budget=GIANT["budget"])
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        compose._collapse_band = collapse
    if not isinstance(got, np.ndarray) or not bands:
        raise AssertionError("giant canvas: the streamed monolithic blend "
                             "did not run")
    torch.cuda.synchronize()
    t0 = time.time()
    ref, ref_mask = compose.blend_stack(stack, None, "multiband", 5,
                                        budget=float("inf"))
    ref, ref_mask = ref.cpu().numpy(), ref_mask.cpu().numpy()
    wall_b = time.time() - t0
    mp = got.shape[0] * got.shape[1] / 1e6
    print(f"giant canvas ({card}): {b} tiles of {th}x{tw} (h x w), panorama "
          f"{got.shape} ({mp:.1f} MP), nb={p['nb']}, canvas "
          f"{p['ph']}x{p['pw']}, windows {p['wh']}x{p['ww']}; streamed "
          f"monolithic blend wall_s={wall:.4f} (to host) in {len(bands)} "
          f"row bands {bands}; peak allocated {peak:.3f} GB; batched blend "
          f"wall_s={wall_b:.4f} (to host)", flush=True)
    lsb_check("giant canvas, streamed against batched", got, ref, 0.999)
    if not np.array_equal(got_mask, ref_mask):
        raise AssertionError("giant canvas: coverage masks differ")


def strips_phase(dev, card):
    """X strips on a wide row and Y strips on a tall grid (`STRIPS`), each
    against the monolithic blend of the same stack within 1 LSB."""
    from stitching_tpu_torch import compose

    for axis, cfg in STRIPS.items():
        stack = tile_layout(cfg["grid"], cfg["tile"], cfg["step"], dev, 1)
        plans = []
        plan_strips = compose._plan_strips
        compose._plan_strips = lambda *a: plans.append(plan_strips(*a)) \
            or plans[-1]
        try:
            compose.blend_stack(stack, None, "multiband", 5,
                                stream_fetch=cfg["stream_fetch"],
                                budget=cfg["budget"])
            torch.cuda.synchronize()
            t0 = time.time()
            got, got_mask = compose.blend_stack(
                stack, None, "multiband", 5,
                stream_fetch=cfg["stream_fetch"], budget=cfg["budget"])
            if not cfg["stream_fetch"]:
                got, got_mask = got.cpu().numpy(), got_mask.cpu().numpy()
            wall = time.time() - t0
        finally:
            compose._plan_strips = plan_strips
        torch.cuda.synchronize()
        t0 = time.time()
        ref, ref_mask = compose.blend_stack(stack, None, "multiband", 5)
        ref, ref_mask = ref.cpu().numpy(), ref_mask.cpu().numpy()
        wall_m = time.time() - t0
        if len(plans) != 2 or plans[-1] is None:
            raise AssertionError(f"{axis} strips did not run")
        members = plans[-1][0]
        fed = sum(len(k) for *_, k in members)
        print(f"{axis} strips ({card}): {stack.data.shape[0]} tiles, "
              f"panorama {got.shape}, budget {cfg['budget']:.0e} B: "
              f"{sum(1 for *_, k in members if k)} strips feeding {fed} "
              f"windows, wall_s={wall:.4f} (stream_fetch="
              f"{cfg['stream_fetch']}); monolithic wall_s={wall_m:.4f}",
              flush=True)
        lsb_check(f"{axis} strips against the monolithic blend", got, ref,
                  0.999)
        if not np.array_equal(got_mask, ref_mask):
            raise AssertionError(f"{axis} strips: coverage masks differ")


def timelapse_phase(imgs):
    """`Stitcher(timelapse="as_is")` on 3 views written as PNG files: the
    stitch returns None and writes `fixed_<name>` beside each input; the
    card's frames with the CPU run's cameras against the CPU run's."""
    import os
    import tempfile

    from stitching_tpu_torch import Stitcher, engine, io

    with tempfile.TemporaryDirectory() as tmp:
        names = {}
        for where in ("card", "cpu", "stitch"):
            os.makedirs(os.path.join(tmp, where))
            names[where] = [os.path.join(tmp, where, f"view{i}.png")
                            for i in range(3)]
            for name, im in zip(names[where], imgs[:3]):
                io.write_image(name, im)

        def frames(where):
            return [io.read_image(os.path.join(os.path.dirname(n),
                                               "fixed_" + os.path.basename(n)))
                    for n in names[where]]

        t0 = time.time()
        out = Stitcher(timelapse="as_is").stitch(names["stitch"])
        wall = time.time() - t0
        written = sorted(f for f in os.listdir(os.path.join(tmp, "stitch"))
                         if f.startswith("fixed_"))
        print(f"timelapse: stitch returned {out!r} in {wall:.4f} s, frames "
              f"{written}", flush=True)
        if out is not None or written != [f"fixed_view{i}.png"
                                          for i in range(3)]:
            raise AssertionError("timelapse: stitch must return None and "
                                 "write one fixed_ frame per view")
        st_cpu = Stitcher(device="cpu", timelapse="as_is")
        reg_cpu = engine.register(st_cpu, names["cpu"])
        engine.composite(st_cpu, reg_cpu,
                         engine.plan_composition(st_cpu, reg_cpu))
        st = Stitcher(timelapse="as_is")
        reg = engine.register(st, names["card"])
        reg.cameras = [c.copy() for c in reg_cpu.cameras]
        st.warper.set_scale(reg.cameras)
        reg.scale = st.warper.scale
        if engine.composite(st, reg, engine.plan_composition(st, reg)) \
                is not None:
            raise AssertionError("timelapse: composite must return None")
        for i, (got, want) in enumerate(zip(frames("card"), frames("cpu"))):
            lsb_check(f"timelapse frame {i} (card against CPU, same "
                      "cameras)", got, want, 0.999)


def one_rank_mesh():
    """The mesh of one NCCL rank in this process (a world of one)."""
    from stitching_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    if mesh.backend != "nccl" or mesh.size != 1:
        raise AssertionError(f"one-rank mesh: {mesh.backend}, "
                             f"{mesh.size} ranks")
    return mesh


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def mesh_strips(mesh, what):
    """`STRIPS["x"]`'s tiles split over the mesh and blended under its
    budget: the strips spread over the ranks (each receiving the tiles
    its strips read) equal the non-mesh strips of the whole stack, value
    for value."""
    import dataclasses

    from stitching_tpu_torch import compose
    from stitching_tpu_torch.parallel.mesh import shard_leading

    cfg = STRIPS["x"]
    whole = tile_layout(cfg["grid"], cfg["tile"], cfg["step"], mesh.device,
                        1)
    split = dataclasses.replace(whole, data=shard_leading(whole.data, mesh),
                                masks=shard_leading(whole.masks, mesh),
                                mesh=mesh)
    routes = []
    strips_mesh = compose._blend_strips_mesh
    compose._blend_strips_mesh = lambda *a: routes.append(a[-1].size) \
        or strips_mesh(*a)
    try:
        _sync(mesh.device)
        t0 = time.time()
        got, got_mask = compose.blend_stack(split, None, "multiband", 5,
                                            budget=cfg["budget"])
        _sync(mesh.device)
        wall = time.time() - t0
    finally:
        compose._blend_strips_mesh = strips_mesh
    want, want_mask = compose.blend_stack(whole, None, "multiband", 5,
                                          budget=cfg["budget"])
    equal = bool(torch.equal(got, want) and torch.equal(got_mask, want_mask))
    print(f"{what}: X strips of {whole.data.shape[0]} tiles over "
          f"{mesh.size} rank(s), panorama {tuple(got.shape)}, wall_s="
          f"{wall:.4f}; equal to the non-mesh strips: {equal}", flush=True)
    if routes != [mesh.size] or not equal:
        raise AssertionError(f"{what}: the strips over the mesh ran "
                             f"{routes} or differ from the non-mesh strips")


def mesh_check(imgs, Rs_true, mesh, pano):
    """The one-rank mesh's cameras against the rendered ground truth (its
    MEDIUM stack is the host resize, which no other phase runs), its
    panorama against the non-mesh composite at the mesh run's cameras
    (shape, crop rects, 1 LSB), and its strips.
    The non-mesh run is the batched branch (a prestaged stack), whose LOW
    stack is the originals resized on the card as under a mesh (the
    uploader's branch resizes LOW on the host). Returns the mesh run's
    cameras."""
    from stitching_tpu_torch import Stitcher, engine, pipeline

    st = Stitcher(mesh=mesh)
    reg = engine.register(st, imgs)
    cams = [c.copy() for c in reg.cameras]
    check_cameras("mesh", cams, Rs_true, 0.02)
    plan = engine.plan_composition(st, reg)
    rects = [tuple(int(v) for v in r) for r in plan.crop_rects]
    if not np.array_equal(engine.composite(st, reg, plan), pano):
        raise AssertionError("mesh: two runs gave different panoramas")
    ref = Stitcher()
    want, want_rects = composite_reg(ref, engine.register(
        ref, imgs, prestaged=pipeline.stack_images(imgs, mesh.device)), cams)
    if want_rects != rects:
        raise AssertionError(f"mesh: crop rects {rects} against the "
                             f"non-mesh {want_rects}")
    lsb_check("mesh (one NCCL rank) against the non-mesh composite at its "
              "cameras", pano, want, 0.999)
    mesh_stages(st, imgs)
    mesh_strips(mesh, "mesh (one NCCL rank)")
    return cams


def mesh_stages(st, imgs):
    """One more mesh stitch with no kernel inputs held by the script: its
    peak memory, then its stages under the port's profiler with fences."""
    from stitching_tpu_torch import profiling

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    st.stitch(imgs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    profiling.enable()
    profiling.enable_fence()
    profiling.reset()
    try:
        st.stitch(imgs)
        report = profiling.get_report()
    finally:
        profiling.enable(False)
        profiling.enable_fence(False)
        profiling.reset()
    print(f"mesh (one NCCL rank): wall_s={wall:.4f} peak_gb={peak:.3f} "
          "(no kernel inputs kept); fenced stages: " + " ".join(
              f"{k}={v['total_s']:.4f}" for k, v in sorted(
                  report.items(), key=lambda kv: -kv[1]["total_s"])),
          flush=True)


def mesh_rank_main(rank, tmp, device):
    """One rank of the two-rank phase, in a process of its own: joins the
    gloo group through a FileStore in `tmp`, stitches the views written
    there, prints what it took, stitches again at the one-rank run's
    cameras, runs the strips over both ranks and writes its results."""
    import torch.distributed as dist

    from stitching_tpu_torch import Stitcher, engine, pipeline
    from stitching_tpu_torch.ops.kernels.bilinear_sample import (
        bilinear_sample)
    from stitching_tpu_torch.ops.kernels.two_nn import two_nn_pairs
    from stitching_tpu_torch.parallel.mesh import make_mesh
    from stitching_tpu_torch.types import CameraParams

    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), MESH_RANKS), rank=rank,
        world_size=MESH_RANKS)
    try:
        mesh = make_mesh(device=device)
        data = np.load(os.path.join(tmp, "in.npz"))
        imgs = list(data["imgs"])
        n = len(imgs)
        st = Stitcher(mesh=mesh)
        st.stitch(imgs)
        _sync(mesh.device)
        two_nn_pairs.launches = bilinear_sample.launches = 0
        t0 = time.time()
        pano = st.stitch(imgs)
        _sync(mesh.device)
        wall = time.time() - t0
        counts = {"two_nn_pairs": two_nn_pairs.launches,
                  "bilinear_sample": bilinear_sample.launches}
        lo, hi = mesh.block(pipeline.pad_batch(n, mesh))
        n_pairs = len(pipeline.make_pairs(n))
        per = -(-n_pairs // mesh.size)
        took = max(0, min(per, n_pairs - rank * per))
        print(f"mesh rank {rank} of {mesh.size} ({mesh.backend}, "
              f"{mesh.device}): images {list(range(lo, min(hi, n)))} and "
              f"{hi - min(hi, n)} padded slot(s), pairs {took} of "
              f"{n_pairs}, launches {counts}, wall_s={wall:.4f} (ranks "
              f"sharing one card: not a scaling number)", flush=True)
        if mesh.device.type == "cuda" and counts != {
                k: MESH_LAUNCHES[k] for k in counts}:
            raise AssertionError(f"mesh rank {rank}: launches {counts}")
        reg = engine.register(st, imgs)
        own = [c.copy() for c in reg.cameras]
        reg.cameras = [CameraParams(float(f), float(a), float(x), float(y),
                                    R) for f, a, x, y, R in zip(
            data["focal"], data["aspect"], data["ppx"], data["ppy"],
            data["R"])]
        st.warper.set_scale(reg.cameras)
        reg.scale = st.warper.scale
        pano_at = engine.composite(st, reg, engine.plan_composition(st, reg))
        mesh_strips(mesh, f"mesh rank {rank}")
        np.savez(os.path.join(tmp, f"out{rank}.npz"), pano=pano,
                 pano_at=pano_at, focal=[c.focal for c in own],
                 R=np.stack([c.R for c in own]), wall=wall)
    finally:
        dist.destroy_process_group()
    return 0


def two_rank_phase(imgs, cams, pano):
    """Two ranks on the one card, each a process of its own over gloo:
    their panoramas equal bit for bit, their cameras within 1e-4 of the
    one-rank run's, and at the one-rank run's cameras their panorama
    within 1 LSB of its panorama."""
    import tempfile

    tmp = tempfile.mkdtemp()
    procs = []
    try:
        np.savez(os.path.join(tmp, "in.npz"), imgs=np.stack(imgs),
                 focal=[c.focal for c in cams],
                 aspect=[c.aspect for c in cams],
                 ppx=[c.ppx for c in cams], ppy=[c.ppy for c in cams],
                 R=np.stack([c.R for c in cams]))
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank",
             str(r), tmp, MESH_RANK_DEVICE], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(MESH_RANKS)]
        deadline = time.time() + MESH_RANK_TIMEOUT
        outs = [p.communicate(timeout=max(deadline - time.time(), 1))
                for p in procs]
        for r, (p, (out, err)) in enumerate(zip(procs, outs)):
            print(out, end="", flush=True)
            if p.returncode != 0:
                raise AssertionError(f"mesh rank {r} failed: {err[-3000:]}")
        res = [np.load(os.path.join(tmp, f"out{r}.npz"))
               for r in range(MESH_RANKS)]
        for k in ("pano", "pano_at", "focal", "R"):
            if not all(np.array_equal(x[k], res[0][k]) for x in res):
                raise AssertionError(f"two ranks: their {k} differ")
        focal = np.asarray([c.focal for c in cams])
        f_err = float(np.abs(res[0]["focal"] / focal - 1).max())
        r_err = float(np.abs(res[0]["R"] - np.stack([c.R for c in cams]))
                      .max())
        own = res[0]["pano"]
        print(f"two gloo ranks on one card: panoramas equal bit for bit, "
              f"{own.shape} (one rank: {pano.shape}); cameras against the "
              f"one-rank run's: focal {f_err:.2e} relative, R {r_err:.2e}; "
              f"walls {[round(float(x['wall']), 4) for x in res]} s (not "
              f"a scaling number)", flush=True)
        if f_err > 1e-4 or r_err > 1e-4:
            raise AssertionError("two ranks: cameras beyond 1e-4 of the "
                                 "one-rank run's")
        lsb_check("two gloo ranks at the one-rank cameras against the "
                  "one-rank panorama", res[0]["pano_at"], pano, 0.999)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def pattern_digest():
    """sha256 of the detectors' static tables (BRISK's pattern and pair
    tables, AKAZE's cell pairs), so that runs on two hosts can be seen to
    use the same ones."""
    import hashlib

    from stitching_tpu_torch.ops import akaze, brisk

    h = hashlib.sha256()
    for table in (brisk.PATTERN_PTS, brisk.PATTERN_RING, brisk.PATTERN_SIGMAS,
                  brisk.SHORT_PAIRS, brisk.LONG_PAIRS,
                  *(akaze._PAIR_TABLES[g] for g in akaze._GRIDS)):
        h.update(np.ascontiguousarray(table).tobytes())
    return h.hexdigest()[:16]


def detection_phase(view, dev):
    """Each of SIFT, BRISK and AKAZE on one MEDIUM view on the card against
    the port's own run on the CPU. Bars, stated before the first card run:
    at least 99% of keypoints equal (position and validity; the card's
    resize products, arctangents and histogram sums round otherwise, which
    can reorder near-ties), and on the keypoints both keep at least 99% of
    binary descriptor bits equal, or float descriptors within 1e-3."""
    from stitching_tpu_torch import pipeline

    for det, nf in (("sift", 500), ("brisk", 1024), ("akaze", 1024)):
        runs = []
        for where in (dev, torch.device("cpu")):
            stack = pipeline.stack_images([view], where)
            with pipeline.no_tf32():
                got = pipeline.detect_stack(stack, nfeatures=nf, variant=det)
            runs.append({k: v.cpu() for k, v in got.items()})
        card, cpu = runs
        same = (card["xy"] == cpu["xy"]).all(-1) & (card["valid"]
                                                    == cpu["valid"])
        both = same & card["valid"]
        kp_equal = float(same.float().mean())
        if det == "sift":
            diff = (card["desc"] - cpu["desc"]).abs()[both]
            err = float(diff.max()) if diff.numel() else 0.0
            d0 = float(((card["desc"] - cpu["desc"]) ** 2).sum(-1)[both]
                       .max()) if diff.numel() else 0.0
            what = (f"float rows: largest difference {err:.3g}, largest "
                    f"squared distance of a card row to its CPU row {d0:.3g}")
            ok = err <= 1e-3
        else:
            bits = float((card["desc"] == cpu["desc"])[both].float().mean())
            what = f"descriptor bits equal {bits:.6f}"
            ok = bits >= 0.99
        print(f"detection {det} on one MEDIUM view {tuple(view.shape)}, card "
              f"against CPU: keypoints equal {kp_equal:.6f} (valid "
              f"{int(card['valid'].sum())} / {int(cpu['valid'].sum())}); "
              f"{what}", flush=True)
        if kp_equal < 0.99 or not ok:
            raise AssertionError(f"detection {det}: the card's run is "
                                 "beyond the stated bar from the CPU's")


def counted_run(name, fn, wrappers, expect, recorders=()):
    """Drive one path: once to warm up, then with every kernel's launch
    count set to 0 (and the recorders emptied) just before and read just
    after. Fails unless the counts of the wrappers in `expect` equal it.
    Returns (result, wall seconds, counts)."""
    fn()
    torch.cuda.synchronize()
    for r in recorders:
        r.calls.clear()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    print(f"{name}: wall_s={wall:.4f} launches={counts}", flush=True)
    if {k: counts[k] for k in expect} != expect:
        raise AssertionError(f"{name}: kernel launches {counts}, expected "
                             f"{expect}")
    return out, wall, counts


def check_cameras(name, cameras, Rs_true, focal_tol):
    """Cameras against the rendered ground truth: focal at MEDIUM scale and
    the relative yaw (the estimate fixes rotations up to a common one and
    a sign)."""
    medium_scale = (0.6e6 / (1600 * 1200)) ** 0.5
    f_true = FOCAL * medium_scale
    focals = [c.focal for c in cameras]
    yaw = [float(np.arctan2(c.R[0, 2], c.R[2, 2])) for c in cameras]
    yaw_true = [float(np.arctan2(R[0, 2], R[2, 2])) for R in Rs_true]
    yaw_err = max(abs(abs(a - yaw[0]) - abs(b - yaw_true[0]))
                  for a, b in zip(yaw, yaw_true))
    f_err = max(abs(f - f_true) for f in focals) / f_true
    print(f"{name} cameras: focal {focals[0]:.2f} (true {f_true:.2f}, worst "
          f"relative error {f_err:.4f}), relative yaw max error "
          f"{yaw_err:.4f} rad", flush=True)
    if f_err > focal_tol or yaw_err > 0.02:
        raise AssertionError(f"{name}: cameras far from the rendered ground "
                             "truth")
    return focals[0], abs(yaw[-1] - yaw[0]), medium_scale


def check_offsets(cameras, offsets, shape):
    """The affine cameras against the scan's truth. Each camera maps the
    panorama (the tree center's frame) to its crop at MEDIUM scale; the
    crop's centre, mapped back, is where the registration put the crop
    (up to a shift common to all: the panorama's frame is free).
    Each crop's offset from the one before it must be within 1 px (full
    resolution) of the truth. Only neighbours overlap, so the spanning
    tree is a chain and those errors add up along it (the reference's
    estimate does the same): a crop's position may be off by 1 px for each
    link between it and the tree center. The linear parts must stay within
    2e-3 of the identity (no turn, no zoom), and the cropped panorama must
    span the crops' common rows and their union's columns."""
    ms = (0.6e6 / (1600 * 1200)) ** 0.5
    if len(cameras) != len(offsets):
        raise AssertionError("affine: an image of the scan was dropped")
    Rs = [np.asarray(c.R, np.float64) for c in cameras]
    lin = max(float(np.abs(R[:2, :2] - np.eye(2)).max()) for R in Rs)
    c = int(np.argmin([np.abs(R[:2, 2]).sum() for R in Rs]))  # t ~ 0
    ctr = np.array([800.0, 600.0]) * ms
    got = np.asarray([np.linalg.solve(R[:2, :2], ctr - R[:2, 2]) / ms
                      for R in Rs])
    true = np.asarray(offsets, np.float64)
    step_err = np.abs(np.diff(got, axis=0) - np.diff(true, axis=0)).max(1)
    # the adjuster moves every camera, the center's too: positions are
    # read relative to the center crop's
    drift = np.abs((got - got[c]) - (true - true[c])).max(1)
    hops = np.abs(np.arange(len(Rs)) - c)
    print(f"affine cameras: center {c}; each crop's offset from the one "
          f"before within {step_err.max():.3f} px of the truth "
          f"({np.round(step_err, 3).tolist()}); positions off by "
          f"{np.round(drift, 3).tolist()} px, 0 to {hops.max()} links from "
          f"the center; linear parts within {lin:.2e} of the identity",
          flush=True)
    xs = [o[0] for o in offsets]
    ys = [o[1] for o in offsets]
    want_w = max(xs) + 1600 - min(xs)
    want_h = 1200 - (max(ys) - min(ys))
    if (step_err.max() > 1.0 or (drift > hops + 1e-9).any() or lin > 2e-3
            or abs(shape[1] - want_w) > 0.01 * want_w
            or abs(shape[0] - want_h) > 0.01 * want_h):
        raise AssertionError(f"affine: panorama {shape} (want about "
                             f"{want_h} x {want_w}) or crop offsets wrong")


def float_features(n_images, n, device, seed=0):
    """Synthetic float features, 128 wide like SIFT's: image k + 1 holds
    noisy copies of 300 of image k's rows, its keypoints shifted by
    (-60, 5) (60 of them thrown off by up to 40 px: the matcher zeroes a
    pair whose matches are all inliers), and 200 fresh rows."""
    from stitching_tpu_torch import convert

    rng = np.random.RandomState(seed)
    w, h = 884, 663
    feats = []
    desc = np.abs(rng.randn(n, 128)).astype(np.float32)
    xy = (rng.rand(n, 2) * [w, h]).astype(np.float32)
    for _ in range(n_images):
        d = desc * (512.0 / np.linalg.norm(desc, axis=-1, keepdims=True))
        f = convert.features_from_numpy(
            xy, np.ones(n), np.full(n, 31.0), np.zeros(n), d,
            np.ones(n, bool), (w, h), is_binary=False)
        f.desc = f.desc.to(device)
        feats.append(f)
        keep = rng.permutation(n)[:300]
        desc = np.concatenate([
            desc[keep] + 0.05 * rng.randn(300, 128),
            np.abs(rng.randn(n - 300, 128))]).astype(np.float32)
        moved = xy[keep] + np.float32([-60, 5])
        moved[:60] += rng.uniform(-40, 40, (60, 2))
        xy = np.concatenate([
            moved, rng.rand(n - 300, 2) * [w, h]]).astype(np.float32)
    return feats


VERBOSE_LAUNCHES = {"two_nn_pairs": 1, "two_nn": 0, "bilinear_sample": 0,
                    "downscale": 0}


class EncodeClock:
    """Stands in for `verbose._io.write_image`: the artifacts are written
    as before, and the seconds spent writing them are summed."""

    def __init__(self, fn):
        self.fn = fn
        self.seconds = 0.0
        self.count = 0

    def __call__(self, *args, **kwargs):
        t0 = time.time()
        out = self.fn(*args, **kwargs)
        self.seconds += time.time() - t0
        self.count += 1
        return out


def check_verbose_names(names, n):
    """The verbose run's artifacts with the default settings (crop on):
    one of each per kept view of 01, 04, 05, 07 and 08 (seam mask and
    compensated), both 06, all three 09, and at least n - 1 of 02 (the
    pairs over the confidence threshold)."""
    want = {"00_stitcher.txt", "03_matches_graph.txt",
            "06_estimated_mask_to_crop.jpg", "06_lir.jpg", "09_result.jpg",
            "09_result_with_seam_lines.jpg",
            "09_result_with_seam_polygons.jpg"}
    for i in range(1, n + 1):
        want |= {f"01_features_img{i}.jpg", f"04_warped_img{i}.jpg",
                 f"05_timelapse_img{i}.jpg",
                 f"07_timelapse_cropped_img{i}.jpg",
                 f"08_seam_mask{i}.jpg", f"08_compensated{i}.jpg"}
    pairs = {f"02_matches_img{i}_to_img{j}.jpg" for i in range(1, n + 1)
             for j in range(1, n + 1) if i != j}
    got = set(names)
    matches = got & pairs
    if got - matches != want or len(matches) < n - 1:
        raise AssertionError(
            f"verbose artifacts: missing {sorted(want - got)}, unexpected "
            f"{sorted(got - want - pairs)}, {len(matches)} match pictures")
    return len(matches)


def keep_registration(st):
    """Wrap a stitcher's detector, matcher and wave corrector so that the
    features, matches and final cameras of its next run are kept."""
    state = {}

    def keep(name, fn):
        def wrapped(*args):
            state[name] = fn(*args)
            return state[name]
        return wrapped

    st.detector.detect = keep("features", st.detector.detect)
    st.matcher.match_features = keep("matches", st.matcher.match_features)
    st.wave_corrector.correct = keep("cameras", st.wave_corrector.correct)
    return state


def verbose_card_vs_cpu(imgs, tmp):
    """`stitch_verbose` on 3 views on the card, then on the CPU with the
    card's features, matches and cameras standing in for its registration:
    the same panorama shape, every value within 1 LSB, 99.9% equal."""
    import dataclasses
    import os

    from stitching_tpu_torch import Stitcher

    st = Stitcher()
    state = keep_registration(st)
    os.makedirs(os.path.join(tmp, "card3"))
    os.makedirs(os.path.join(tmp, "cpu3"))
    pano = st.stitch_verbose(imgs[:3], verbose_dir=os.path.join(tmp, "card3"))
    feats = [dataclasses.replace(f, desc=f.desc.cpu())
             for f in state["features"]]
    cams = [c.copy() for c in state["cameras"]]
    cpu = Stitcher(device="cpu")
    cpu.detector.detect = lambda _: feats
    cpu.matcher.match_features = lambda _: state["matches"]
    cpu.camera_estimator.estimate = lambda f, m: cams
    cpu.camera_adjuster.adjust = lambda f, m, c: c
    cpu.wave_corrector.correct = lambda c: c
    t0 = time.time()
    want = cpu.stitch_verbose(imgs[:3],
                              verbose_dir=os.path.join(tmp, "cpu3"))
    print(f"verbose, 3 views on the CPU: {time.time() - t0:.1f} s",
          flush=True)
    lsb_check("verbose panorama, 3 views (card against CPU, the card's "
              "registration)", pano, want, 0.999)
    if sorted(os.listdir(os.path.join(tmp, "card3"))) != sorted(
            os.listdir(os.path.join(tmp, "cpu3"))):
        raise AssertionError("verbose, 3 views: the card and the CPU wrote "
                             "other artifacts")


def registration_phase(cameras, scale, tmp):
    """The verbose run's cameras saved and loaded: every value equal."""
    import os

    from stitching_tpu_torch.registration import (load_registration,
                                                  save_registration)

    path = os.path.join(tmp, "registration.npz")
    save_registration(path, cameras, indices=list(range(len(cameras))),
                      scale=scale)
    back = load_registration(path)
    same = (len(back["cameras"]) == len(cameras)
            and back["scale"] == scale
            and list(back["indices"]) == list(range(len(cameras)))
            and all((a.focal, a.aspect, a.ppx, a.ppy)
                    == (b.focal, b.aspect, b.ppx, b.ppy)
                    and np.array_equal(a.R, np.asarray(b.R, np.float32))
                    for a, b in zip(back["cameras"], cameras)))
    print(f"registration: {len(cameras)} cameras and the scale {scale:.4f} "
          f"through {os.path.getsize(path)} bytes of .npz, round trip "
          f"{'exact' if same else 'WRONG'}", flush=True)
    if not same:
        raise AssertionError("registration: the loaded cameras differ")


PREVIEW_NOTICE = "preview unavailable (no GUI backend)"


def cli_subprocess(paths, tmp):
    """`python -m stitching_tpu_torch.cli.stitch` on 3 views, plain, with
    -v and with --preview, in processes of their own: each must exit 0 and
    write its panorama; --preview (this host has no GUI) also prints the
    reference's no-GUI notice on stderr."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    for tag, extra in (("", []),
                       ("_v", ["-v", "--verbose_dir",
                               os.path.join(tmp, "cli_v")]),
                       ("_preview", ["--preview"])):
        out = os.path.join(tmp, f"cli3{tag}.jpg")
        t0 = time.time()
        run = subprocess.run(
            [sys.executable, "-m", "stitching_tpu_torch.cli.stitch",
             *paths[:3], "--output", out, *extra], cwd=root,
            capture_output=True, text=True, timeout=600)
        notice = PREVIEW_NOTICE in run.stderr
        print(f"cli subprocess {' '.join(extra) or '(default)'}: exit "
              f"{run.returncode} in {time.time() - t0:.1f} s, output "
              f"{os.path.exists(out)}, no-GUI notice on stderr {notice}",
              flush=True)
        if (run.returncode != 0 or not os.path.exists(out)
                or notice != ("--preview" in extra)):
            raise AssertionError("cli subprocess failed: "
                                 + run.stderr[-2000:])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    from stitching_tpu_torch import (SLICE, SLICE2, AffineStitcher, Stitcher,
                                     compose, cropper, engine, pipeline)
    from stitching_tpu_torch.ops.warp import WARP_TYPES
    from stitching_tpu_torch.feature_matcher import FeatureMatcher
    from stitching_tpu_torch.images import Images
    from stitching_tpu_torch.ops import kernels, match
    from stitching_tpu_torch.ops.kernels.bilinear_sample import (
        bilinear_sample)
    from stitching_tpu_torch.ops.kernels.components import count_components
    from stitching_tpu_torch.ops.kernels.downscale import downscale
    from stitching_tpu_torch.ops.kernels.push_relabel import push_relabel
    from stitching_tpu_torch.ops.kernels.two_nn import two_nn, two_nn_pairs

    t_start = time.time()
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)

    t0 = time.time()
    kernels.build()
    print(f"build: {len(kernels.KERNELS)} sources "
          f"({len(kernels.ENTRIES)} C entries) in {time.time() - t0:.1f} s",
          flush=True)

    print(f"detector tables sha256 {pattern_digest()}", flush=True)

    dev = torch.device("cuda")
    t0 = time.time()
    boundary_phase(dev)
    print(f"boundary phase: {time.time() - t0:.1f} s", flush=True)
    for w in (two_nn, two_nn_pairs):
        w.launches = 0

    imgs, Rs_true = rotation_set(N_VIEWS, (1600, 1200), FOCAL, MAX_ANGLE,
                                 dev)
    print(f"rendered {len(imgs)} views of {imgs[0].shape}", flush=True)

    # every kernel wrapper, with its inputs recorded at its call sites
    wrappers = {"two_nn_pairs": two_nn_pairs, "two_nn": two_nn,
                "bilinear_sample": bilinear_sample,
                "count_components": count_components,
                "downscale": downscale, "push_relabel": push_relabel}
    # the crop planner's region counts, kept per path (a path's launch
    # expectations leave them out: they follow where the crop is on)
    rec_cc = Recorder(cropper.count_components)
    cropper.count_components = rec_cc
    cc_calls = {}
    rec_pairs = Recorder(pipeline.two_nn_pairs)
    rec_rows = Recorder(match.two_nn)
    rec_bs = Recorder(compose.bilinear_sample)
    pipeline.two_nn_pairs = rec_pairs
    match.two_nn = rec_rows
    compose.bilinear_sample = rec_bs
    recs = (rec_pairs, rec_rows, rec_bs)
    launches = {}

    def drive(name, fn, expect):
        rec_cc.calls.clear()
        out, wall, counts = counted_run(name, fn, wrappers, expect, recs)
        launches[name] = counts
        if rec_cc.calls:
            cc_calls[name] = list(rec_cc.calls)
        return out, wall, [list(r.calls) for r in recs]

    # ---- path 1: the first slice -------------------------------------
    st = Stitcher(**SLICE)
    pano, wall, (nn_calls, _, bs_calls) = drive(
        "slice1", lambda: st.stitch(imgs),
        STITCH_LAUNCHES)
    mp = pano.shape[0] * pano.shape[1] / 1e6
    print(f"slice1 stitch: wall_s={wall:.4f} pano={pano.shape} mp={mp:.3f} "
          f"mp_per_s={mp / wall:.3f} nonzero_share="
          f"{float((pano.max(-1) > 0).mean()):.4f}", flush=True)

    # where the time goes: the stages once more, each ended by a sync
    t0 = time.time()
    reg = engine.register(st, imgs)
    torch.cuda.synchronize()
    t1 = time.time()
    plan = engine.plan_composition(st, reg)
    torch.cuda.synchronize()
    t2 = time.time()
    pano_again = engine.composite(st, reg, plan)
    torch.cuda.synchronize()
    t3 = time.time()
    print(f"slice1 stages (fenced): register_s={t1 - t0:.4f} "
          f"plan_low_warp_s={t2 - t1:.4f} composite_final_s={t3 - t2:.4f}",
          flush=True)
    if pano.dtype != np.uint8 or pano.ndim != 3 or pano.shape[2] != 3:
        raise AssertionError(f"panorama {pano.dtype} {pano.shape}")
    if not np.array_equal(pano, pano_again):
        raise AssertionError("two runs of the slice gave different panoramas")
    focal, yaw_span, ms = check_cameras("slice1", reg.cameras, Rs_true, 0.05)
    want_w = (focal * yaw_span + 1600 * ms) / ms
    if not 0.9 * want_w <= pano.shape[1] <= 1.2 * want_w:
        raise AssertionError(f"panorama width {pano.shape[1]} vs "
                             f"{want_w:.0f} expected")

    # ---- path 2: the second slice ------------------------------------
    st2 = Stitcher(**SLICE2)
    pano2, wall2, (nn_calls2, _, bs_calls2) = drive(
        "slice2", lambda: st2.stitch(imgs),
        STITCH_LAUNCHES)
    mp2 = pano2.shape[0] * pano2.shape[1] / 1e6
    share2 = float((pano2.max(-1) > 0).mean())
    print(f"slice2 stitch: wall_s={wall2:.4f} pano={pano2.shape} "
          f"mp={mp2:.3f} mp_per_s={mp2 / wall2:.3f} nonzero_share="
          f"{share2:.4f}", flush=True)
    # the views themselves are black where they look past the scene, so
    # the crop shows in the shape (inside slice 1's), not in the share
    if (pano2.dtype != np.uint8 or pano2.ndim != 3 or pano2.shape[2] != 3
            or pano2.shape[0] >= pano.shape[0]
            or pano2.shape[1] > pano.shape[1]
            or pano2.shape[0] < 0.5 * pano.shape[0]
            or pano2.shape[1] < 0.5 * pano.shape[1]):
        raise AssertionError(f"slice2 panorama {pano2.dtype} {pano2.shape}: "
                             f"not a cropped interior of {pano.shape}")

    # its stages once more, each fenced; the named parts are timed inside
    clock = StageClock()
    parts = [(st2.camera_adjuster, "adjust", "bundle_adjust_s"),
             (st2.wave_corrector, "correct", "wave_correct_s"),
             (st2.cropper, "prepare_from_mask", "crop_plan_s"),
             (engine, "_crop_tiles", "crop_tiles_s"),
             (st2.compensator, "feed_stack", "exposure_feed_s"),
             (engine, "apply_gains_stack", "gain_apply_s")]
    saved = [(o, a, getattr(o, a)) for o, a, _ in parts]
    for o, a, label in parts:
        setattr(o, a, clock.wrap(label, getattr(o, a)))
    t0 = time.time()
    reg2 = engine.register(st2, imgs)
    torch.cuda.synchronize()
    t1 = time.time()
    plan2 = engine.plan_composition(st2, reg2)
    torch.cuda.synchronize()
    t2 = time.time()
    pano2_again = engine.composite(st2, reg2, plan2)
    torch.cuda.synchronize()
    t3 = time.time()
    for o, a, fn in saved:
        if o is engine:
            setattr(o, a, fn)
        else:
            delattr(o, a)
    print(f"slice2 stages (fenced): register_s={t1 - t0:.4f} "
          f"plan_low_s={t2 - t1:.4f} composite_final_s={t3 - t2:.4f}; "
          "inside them: "
          + " ".join(f"{k}={v:.4f}" for k, v in clock.seconds.items()),
          flush=True)
    if not np.array_equal(pano2, pano2_again):
        raise AssertionError("two runs of slice 2 gave different panoramas")
    check_cameras("slice2", reg2.cameras, Rs_true, 0.02)
    profile_stitch(st2, imgs)

    # ---- path 3: every default setting ---------------------------------
    st3 = Stitcher()
    pano3, wall3, (nn_calls3, _, bs_calls3) = drive(
        "default", lambda: st3.stitch(imgs),
        STITCH_LAUNCHES)
    mp3 = pano3.shape[0] * pano3.shape[1] / 1e6
    print(f"default stitch: wall_s={wall3:.4f} pano={pano3.shape} "
          f"mp={mp3:.3f} mp_per_s={mp3 / wall3:.3f} nonzero_share="
          f"{float((pano3.max(-1) > 0).mean()):.4f}", flush=True)
    # the seams and the blend change values, not the crop: slice 2's shape
    if (pano3.dtype != np.uint8 or pano3.shape != pano2.shape
            or np.array_equal(pano3, pano2)):
        raise AssertionError(f"default panorama {pano3.dtype} {pano3.shape}: "
                             f"not a blend of slice 2's {pano2.shape}")
    reg3 = path_stages("default", st3, imgs, pano3, table=True)
    check_cameras("default", reg3.cameras, Rs_true, 0.02)
    profile_stitch(st3, imgs)

    # ---- path 4: graph-cut seams -------------------------------------
    st_gc = Stitcher(finder="gc_color")
    pano_gc, wall_gc, (nn_gc, _, bs_gc) = drive(
        "gc", lambda: st_gc.stitch(imgs),
        STITCH_LAUNCHES)
    mp_gc = pano_gc.shape[0] * pano_gc.shape[1] / 1e6
    print(f"gc stitch: wall_s={wall_gc:.4f} pano={pano_gc.shape} "
          f"mp={mp_gc:.3f} mp_per_s={mp_gc / wall_gc:.3f}", flush=True)
    # the seams move values, not the crop: the default path's shape
    if pano_gc.dtype != np.uint8 or pano_gc.shape != pano3.shape:
        raise AssertionError(f"gc panorama {pano_gc.dtype} {pano_gc.shape}: "
                             f"not the default's {pano3.shape}")
    reg_gc = path_stages("gc", st_gc, imgs, pano_gc)
    check_cameras("gc", reg_gc.cameras, Rs_true, 0.02)
    profile_stitch(st_gc, imgs)

    # ---- path 5: another surface -------------------------------------
    st_cyl = Stitcher(warper_type="cylindrical")
    pano_cyl, wall_cyl, (nn_cyl, _, bs_cyl) = drive(
        "surfaces", lambda: st_cyl.stitch(imgs),
        STITCH_LAUNCHES)
    mp_cyl = pano_cyl.shape[0] * pano_cyl.shape[1] / 1e6
    print(f"surfaces (cylindrical) stitch: wall_s={wall_cyl:.4f} "
          f"pano={pano_cyl.shape} mp={mp_cyl:.3f} mp_per_s="
          f"{mp_cyl / wall_cyl:.3f}", flush=True)
    # the cylinder keeps the sphere's width (the same yaw span at the same
    # scale) and its straight vertical edges let the crop keep more height
    if (pano_cyl.dtype != np.uint8
            or abs(pano_cyl.shape[1] - pano3.shape[1]) > 0.02 * pano3.shape[1]
            or pano_cyl.shape[0] < 0.9 * pano3.shape[0]):
        raise AssertionError(f"cylindrical panorama {pano_cyl.shape} against "
                             f"the spherical {pano3.shape}")
    reg_cyl = path_stages("surfaces", st_cyl, imgs, pano_cyl)
    check_cameras("surfaces", reg_cyl.cameras, Rs_true, 0.02)

    # ---- path 6: AffineStitcher on a scan ----------------------------
    scan, offsets = scan_set(N_VIEWS, (1600, 1200))
    print(f"scan set: {len(scan)} crops of {scan[0].shape}", flush=True)
    st_af = AffineStitcher()
    pano_af, wall_af, (nn_af, _, bs_af) = drive(
        "affine", lambda: st_af.stitch(scan),
        STITCH_LAUNCHES)
    mp_af = pano_af.shape[0] * pano_af.shape[1] / 1e6
    print(f"affine stitch: wall_s={wall_af:.4f} pano={pano_af.shape} "
          f"mp={mp_af:.3f} mp_per_s={mp_af / wall_af:.3f} nonzero_share="
          f"{float((pano_af.max(-1) > 0).mean()):.4f}", flush=True)
    reg_af = path_stages("affine", st_af, scan, pano_af)
    check_offsets(reg_af.cameras, offsets, pano_af.shape)

    # ---- paths 6b: the SIFT, BRISK and AKAZE detectors ------------------
    # Stitcher(detector=X) with every other default on the views, and
    # AffineStitcher(detector="sift") on the scan; cameras held to the
    # truth as the default path's (focal within 2%, yaw within 0.02 rad)
    det_calls = {}
    for det in ("sift", "brisk", "akaze", "affine_sift"):
        if det == "affine_sift":
            st_d, inputs = AffineStitcher(detector="sift"), scan
        else:
            st_d, inputs = Stitcher(detector=det), imgs
        pano_d, wall_d, det_calls[det] = drive(
            det, lambda st_d=st_d, inputs=inputs: st_d.stitch(inputs),
            STITCH_LAUNCHES)
        mp_d = pano_d.shape[0] * pano_d.shape[1] / 1e6
        print(f"{det} stitch: wall_s={wall_d:.4f} pano={pano_d.shape} "
              f"mp={mp_d:.3f} mp_per_s={mp_d / wall_d:.3f}", flush=True)
        if pano_d.dtype != np.uint8 or pano_d.ndim != 3:
            raise AssertionError(f"{det} panorama {pano_d.dtype} "
                                 f"{pano_d.shape}")
        reg_d = path_stages(det, st_d, inputs, pano_d, table=True)
        if det == "affine_sift":
            check_offsets(reg_d.cameras, offsets, pano_d.shape)
        else:
            check_cameras(det, reg_d.cameras, Rs_true, 0.02)

    # ---- path 7: one pair of frames ----------------------------------
    images_obj = Images.of(imgs[:2], st.medium_megapix, st.low_megapix,
                           st.final_megapix)
    med_sizes = images_obj.get_scaled_img_sizes(Images.Resolution.MEDIUM)
    gray, _ = engine._host_downscale(imgs[:2], med_sizes, med_sizes)
    (H, n_inl), wall_pair, (_, rows_calls, _) = drive(
        "pair", lambda: pipeline.register_pair(gray[0], gray[1],
                                               nfeatures=500),
        {"two_nn_pairs": 0, "two_nn": 2, "bilinear_sample": 0})
    H = H.double().cpu().numpy()
    mw, mh = med_sizes[0]
    K = np.array([[FOCAL * ms, 0, mw / 2], [0, FOCAL * ms, mh / 2],
                  [0, 0, 1.0]])
    H_true = K @ Rs_true[1].T @ Rs_true[0] @ np.linalg.inv(K)
    pts = np.array([[mw * fx, mh * fy, 1.0] for fx in (0.3, 0.6, 0.9)
                    for fy in (0.2, 0.5, 0.8)]).T
    got, want = H @ pts, H_true @ pts
    h_err = float(np.abs(got[:2] / got[2] - want[:2] / want[2]).max())
    print(f"pair: {int(n_inl)} inliers of {gray[0].shape} frames, "
          f"homography within {h_err:.3f} px of the rendered one",
          flush=True)
    if int(n_inl) < 30 or not h_err < 3.0:
        raise AssertionError("the pair path's homography is wrong")

    # the entry's own pair (`__graft_entry__.entry`): its two crops, 256
    # features, 128 RANSAC draws; the card's run against the CPU's
    crop_a, crop_b = graft_crops()
    (H_e, n_e), wall_e, (_, entry_rows, _) = drive(
        "pair_entry", lambda: pipeline.register_pair(
            crop_a, crop_b, nfeatures=256, n_iters=128),
        {"two_nn_pairs": 0, "two_nn": 2, "bilinear_sample": 0})
    H_c, n_c = pipeline.register_pair(crop_a, crop_b, nfeatures=256,
                                      n_iters=128, device="cpu")
    H_e, H_c = H_e.cpu().numpy(), H_c.numpy()
    h_gap = float(np.abs(H_e - H_c).max())
    print(f"pair_entry (the entry's crops, 256 features, 128 draws): "
          f"{int(n_e)} inliers on the card, {int(n_c)} on the CPU; shift "
          f"x {H_e[0, 2]:.4f} y {H_e[1, 2]:.4f} px (truth -80, 0); H within "
          f"{h_gap:.3g} of the CPU's", flush=True)
    if (int(n_e) != int(n_c) or not h_gap <= 1e-4
            or abs(H_e[0, 2] + 80.0) > 1.0 or abs(H_e[1, 2]) > 1.0):
        raise AssertionError("the entry's pair on the card differs from its "
                             "CPU run or misses the 80 px shift")

    # ---- path 8: the matchers on float descriptors -------------------
    feats = float_features(8, 500, dev)
    matcher = FeatureMatcher(match_conf=0.65)

    def float_path():
        ms_ = matcher.match_features(feats)
        m = match.match_pair(feats[0].desc, torch.ones(500, dtype=torch.bool,
                                                       device=dev),
                             feats[1].desc, torch.ones(500, dtype=torch.bool,
                                                       device=dev), 0.65,
                             is_binary=False)
        return ms_, m

    (all_matches, one), wall4, (fnn_calls, frows_calls, _) = drive(
        "float_match", float_path,
        {"two_nn_pairs": 1, "two_nn": 2, "bilinear_sample": 0})
    conf = FeatureMatcher.get_confidence_matrix(all_matches)
    chain = [float(conf[k, k + 1]) for k in range(7)]
    m01 = all_matches[1]
    shift = m01.H[:2, 2] if m01.H is not None else None
    n_one = int(one["valid"].sum())
    print(f"float_match: neighbour confidences {np.round(chain, 3)}, H[0->1] "
          f"shift {shift}, match_pair matches {n_one}", flush=True)
    if (min(chain) < 1.0 or shift is None
            or np.abs(shift - [-60, 5]).max() > 0.5 or n_one < 250):
        raise AssertionError("the float matchers did not recover the "
                             "synthetic shift")

    # ---- path 9: verbose mode, the step-by-step component API ----------
    import os
    import tempfile
    from unittest import mock

    from stitching_tpu_torch import io, verbose
    from stitching_tpu_torch.cli import stitch as cli_stitch

    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    st_v = Stitcher()
    kept = keep_registration(st_v)
    encode = EncodeClock(verbose._io.write_image)
    verbose._io.write_image = encode
    vdir = os.path.join(tmp, "verbose")

    def verbose_run():
        shutil.rmtree(vdir, ignore_errors=True)
        os.makedirs(vdir)
        encode.seconds, encode.count = 0.0, 0
        return st_v.stitch_verbose(imgs, verbose_dir=vdir)

    t0 = time.time()
    pano_s = st_v.stitch(imgs)
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    pano_v, wall_v, (nn_v, _, _) = drive("verbose", verbose_run,
                                         VERBOSE_LAUNCHES)
    verbose._io.write_image = encode.fn
    n_pairs = check_verbose_names(os.listdir(vdir), N_VIEWS)
    mp_v = pano_v.shape[0] * pano_v.shape[1] / 1e6
    print(f"verbose stitch: wall_s={wall_v:.4f} (stitch() wall_s="
          f"{wall_s:.4f} in the same call) pano={pano_v.shape} mp={mp_v:.3f} "
          f"artifacts={len(os.listdir(vdir))} (match pictures {n_pairs}) "
          f"encode_s={encode.seconds:.4f} over {encode.count} writes; "
          f"stitch() pano={pano_s.shape}", flush=True)
    if pano_v.dtype != np.uint8 or pano_v.ndim != 3 or not (
            0.9 * pano_s.shape[1] <= pano_v.shape[1] <= 1.1 * pano_s.shape[1]):
        raise AssertionError(f"verbose panorama {pano_v.shape} against "
                             f"stitch()'s {pano_s.shape}")
    check_cameras("verbose", kept["cameras"], Rs_true, 0.02)
    # where its time goes: once more, each stage fenced (the two warps,
    # LOW and FINAL, add up under warp_at; every stage's artifact writes
    # are inside it and are summed apart as encode_s)
    clock_v = StageClock()
    stages_v = ("_dump_features", "_dump_matches", "_dump_subset",
                "_warp_at", "_dump_timelapse", "_dump_crop", "_dump_seams",
                "_dump_compensation", "_blend", "_dump_seam_viz")
    saved_v = {n: getattr(verbose, n) for n in stages_v}
    for n in stages_v:
        setattr(verbose, n, clock_v.wrap(n.lstrip("_"), saved_v[n]))
    verbose._io.write_image = encode
    t0 = time.time()
    verbose_run()
    torch.cuda.synchronize()
    fenced_v = time.time() - t0
    verbose._io.write_image = encode.fn
    for n, fn in saved_v.items():
        setattr(verbose, n, fn)
    print(f"verbose stages (fenced): total_s={fenced_v:.4f} "
          + " ".join(f"{k}={v:.4f}" for k, v in clock_v.seconds.items())
          + f"; encode_s={encode.seconds:.4f} over {encode.count} writes, "
          f"registration (estimate, adjust, wave) and the rest "
          f"{fenced_v - sum(clock_v.seconds.values()):.4f}", flush=True)

    # ---- path 10: the stitch CLI, in this process --------------------
    view_files = [os.path.join(tmp, f"view{i}.png") for i in range(N_VIEWS)]
    for name, im in zip(view_files, imgs):
        io.write_image(name, im)
    cli_out = os.path.join(tmp, "cli_pano.png")

    def cli_run():
        with mock.patch.object(sys, "argv", ["stitch", *view_files,
                                             "--output", cli_out]):
            cli_stitch.main()

    _, wall_cli, (nn_cli, _, bs_cli) = drive("cli", cli_run, STITCH_LAUNCHES)
    got_cli = io.read_image(cli_out)
    want_cli = Stitcher().stitch(view_files)
    print(f"cli: wall_s={wall_cli:.4f} pano={got_cli.shape}, equal to "
          f"Stitcher().stitch on the files: "
          f"{np.array_equal(got_cli, want_cli)}", flush=True)
    if not np.array_equal(got_cli, want_cli):
        raise AssertionError("cli: the written panorama differs from "
                             "Stitcher().stitch on the same files")

    # ---- path 11: the mesh, one NCCL rank in this process -------------
    mesh = one_rank_mesh()
    st_m = Stitcher(mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    pano_m, wall_m, (nn_m, _, bs_m) = drive(
        "mesh", lambda: st_m.stitch(imgs), MESH_LAUNCHES)
    peak_m = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.time()
    st3.stitch(imgs)
    torch.cuda.synchronize()
    wall_d = time.time() - t0
    mp_m = pano_m.shape[0] * pano_m.shape[1] / 1e6
    print(f"mesh stitch (one NCCL rank; {card}): wall_s={wall_m:.4f} "
          f"pano={pano_m.shape} mp={mp_m:.3f} mp_per_s={mp_m / wall_m:.3f} "
          f"peak_gb={peak_m:.3f}; Stitcher() wall_s={wall_d:.4f} in the "
          "same call", flush=True)

    pipeline.two_nn_pairs = rec_pairs.fn
    match.two_nn = rec_rows.fn
    compose.bilinear_sample = rec_bs.fn

    for name, phase in (
            ("cli subprocess", lambda: cli_subprocess(view_files, tmp)),
            ("verbose card/cpu", lambda: verbose_card_vs_cpu(imgs, tmp)),
            ("registration", lambda: registration_phase(
                kept["cameras"], st_v.warper.scale, tmp))):
        t0 = time.time()
        phase()
        print(f"{name} phase: {time.time() - t0:.1f} s", flush=True)
    tmp_dir.cleanup()

    # ---- the mesh: the one-rank check, then two ranks on the card -----
    import torch.distributed as dist

    t0 = time.time()
    try:
        cams_m = mesh_check(imgs, Rs_true, mesh, pano_m)
    finally:
        dist.destroy_process_group()
    print(f"mesh check phase: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    two_rank_phase(imgs, cams_m, pano_m)
    print(f"mesh two-rank phase: {time.time() - t0:.1f} s", flush=True)

    # ---- slice 6: streamed against batched, the device entry, the
    # giant canvas, strips and timelapse --------------------------------
    for name, phase in (
            ("streamed/batched", lambda: streamed_vs_batched(imgs, dev)),
            ("stitch_device", lambda: stitch_device_phase(imgs, dev)),
            ("giant", lambda: giant_phase(dev, card)),
            ("strips", lambda: strips_phase(dev, card)),
            ("timelapse", lambda: timelapse_phase(imgs)),
            ("detection card/cpu", lambda: detection_phase(gray[0], dev))):
        t0 = time.time()
        phase()
        torch.cuda.empty_cache()
        print(f"{name} phase: {time.time() - t0:.1f} s", flush=True)

    # ---- small input: the card against the CPU, same cameras ---------
    small, _ = rotation_set(3, (640, 480), 600.0, 0.5, dev)
    small_scan, _ = scan_set(3, (640, 480))
    settings = ([("slice1", SLICE), ("slice2", SLICE2), ("default", {})]
                + [(f"warper_type={w}", dict(warper_type=w))
                   for w in WARP_TYPES if w not in ("spherical", "affine")]
                + [("compensator=gain", dict(compensator="gain")),
                   ("compensator=channel", dict(compensator="channel")),
                   ("finder=gc_color", dict(finder="gc_color")),
                   ("finder=gc_colorgrad", dict(finder="gc_colorgrad"))])
    regs = {}
    for name, settings_of, make, inputs in (
            [(n, s_, Stitcher, small) for n, s_ in settings]
            + [("AffineStitcher", {}, AffineStitcher, small_scan)]):
        # one registration per registration setting and device; each
        # setting composites the CPU's cameras on both
        key = (make, tuple(sorted((k, str(v)) for k, v in settings_of.items()
                                  if k in ("crop", "adjuster",
                                           "wave_correct_kind"))))
        if key not in regs:
            cpu_reg = engine.register(make(device="cpu", **settings_of),
                                      inputs)
            gpu_reg = engine.register(make(**settings_of), inputs)
            regs[key] = (cpu_reg, gpu_reg)
        cpu_reg, gpu_reg = regs[key]
        f_cpu, f_gpu = cpu_reg.cameras[0].focal, gpu_reg.cameras[0].focal
        pano_cpu, rects_cpu = composite_reg(make(device="cpu", **settings_of),
                                            cpu_reg, cpu_reg.cameras)
        pano_gpu, rects_gpu = composite_reg(make(**settings_of), gpu_reg,
                                            cpu_reg.cameras)
        if pano_cpu.shape != pano_gpu.shape or rects_cpu != rects_gpu:
            raise AssertionError(
                f"small input, {name}: {pano_gpu.shape} {rects_gpu} on the "
                f"card, {pano_cpu.shape} {rects_cpu} on the CPU")
        near = float((np.abs(pano_gpu.astype(np.int16)
                             - pano_cpu.astype(np.int16)) <= 1).mean())
        print(f"small input, {name}: focal card {f_gpu:.3f} cpu {f_cpu:.3f}; "
              f"panorama {pano_gpu.shape} crop rects {rects_gpu} within 1 "
              f"LSB of the CPU's at {near:.6f} of values", flush=True)
        if abs(f_gpu - f_cpu) > 0.02 * abs(f_cpu) or near < 0.999:
            raise AssertionError(f"the card's {name} disagrees with the "
                                 "CPU's")

    # ---- every kernel against its plain version at the paths' inputs --
    new_nn = {"gc": nn_gc, "surfaces": nn_cyl, "affine": nn_af}
    new_bs = bs_gc + bs_cyl + bs_af
    det_bs = [c for calls in det_calls.values() for c in calls[2]]
    per_stitch = STITCH_LAUNCHES["bilinear_sample"]
    if (len(nn_calls) != 1 or len(nn_calls2) != 1 or len(nn_calls3) != 1
            or len(bs_calls) != per_stitch or len(bs_calls2) != per_stitch
            or len(bs_calls3) != per_stitch or len(rows_calls) != 2
            or len(entry_rows) != 2
            or len(fnn_calls) != 1 or len(frows_calls) != 2
            or any(len(c) != 1 for c in new_nn.values())
            or any(len(c[0]) != 1 for c in det_calls.values())
            or len(new_bs) != 3 * per_stitch
            or len(det_bs) != len(det_calls) * per_stitch):
        raise AssertionError("kernel calls were not recorded")
    # the sampler's calls: one batched LOW warp, then B = 1 FINAL warps
    batches = [c[0][0].shape[0] for c in bs_calls3]
    if batches != [N_VIEWS] + [1] * N_VIEWS:
        raise AssertionError(f"sampler batches {batches} on the default "
                             "path: expected the batched LOW warp and one "
                             "FINAL warp per view")
    equal_two_nn_pairs(nn_calls[0], "two_nn_pairs (binary), slice1's call")
    equal_two_nn_pairs(nn_calls3[0], "two_nn_pairs (binary), the default "
                       "path's call")
    for name, calls in new_nn.items():
        equal_two_nn_pairs(calls[0], f"two_nn_pairs (binary), the {name} "
                           "path's call")
    if len(nn_v) != 1 or len(nn_cli) != 1 or len(bs_cli) != per_stitch:
        raise AssertionError("verbose/cli kernel calls were not recorded")
    if (len(nn_m) != MESH_LAUNCHES["two_nn_pairs"]
            or len(bs_m) != MESH_LAUNCHES["bilinear_sample"]):
        raise AssertionError("mesh kernel calls were not recorded")
    equal_two_nn_pairs(nn_m[0], "two_nn_pairs (binary), the mesh path's "
                       "call")
    equal_two_nn_pairs(nn_v[0], "two_nn_pairs (binary), the verbose path's "
                       "call")
    equal_two_nn_pairs(nn_cli[0], "two_nn_pairs (binary), the cli path's "
                       "call")
    equal_two_nn_pairs(det_calls["akaze"][0][0], "two_nn_pairs (binary, "
                       "512 bits), the akaze path's call")
    check_two_nn_pairs(det_calls["affine_sift"][0][0], "two_nn_pairs "
                       "(float), the affine_sift path's call")
    results = {
        "two_nn_pairs (binary)": check_two_nn_pairs(
            nn_calls2[0], "two_nn_pairs (binary)"),
        "two_nn_pairs (binary, 512 bits)": check_two_nn_pairs(
            det_calls["brisk"][0][0], "two_nn_pairs (binary, 512 bits)"),
        "two_nn_pairs (float)": check_two_nn_pairs(
            det_calls["sift"][0][0], "two_nn_pairs (float)"),
        "two_nn_pairs (float, synthetic)": check_two_nn_pairs(
            fnn_calls[0], "two_nn_pairs (float, synthetic)"),
        "two_nn (binary)": check_two_nn(rows_calls + entry_rows,
                                        "two_nn (binary)"),
        "two_nn (float)": check_two_nn(frows_calls, "two_nn (float)"),
        "bilinear_sample": check_sampler(
            bs_calls + bs_calls2 + bs_calls3 + new_bs + det_bs + bs_cli
            + bs_m, bs_calls + bs_calls2 + bs_calls3),
        "count_components": check_components(cc_calls,
                                             ("default", "affine")),
        "downscale": check_downscale(dev),
        "push_relabel": check_graphcut(dev),
    }
    stitches = ("slice1", "slice2", "default", "gc", "surfaces", "affine")
    paths = {"two_nn_pairs (binary)": ("two_nn_pairs",
                                       stitches + ("verbose", "cli",
                                                   "mesh")),
             "two_nn_pairs (binary, 512 bits)": ("two_nn_pairs",
                                                 ("brisk", "akaze")),
             "two_nn_pairs (float)": ("two_nn_pairs",
                                      ("sift", "affine_sift")),
             "two_nn_pairs (float, synthetic)": ("two_nn_pairs",
                                                 ("float_match",)),
             "two_nn (binary)": ("two_nn", ("pair", "pair_entry")),
             "two_nn (float)": ("two_nn", ("float_match",)),
             "bilinear_sample": ("bilinear_sample",
                                 stitches + tuple(det_calls)
                                 + ("cli", "mesh")),
             "count_components": ("count_components", ("default",
                                                       "affine")),
             "downscale": ("downscale", stitches + tuple(det_calls)
                           + ("cli",)),
             "push_relabel": ("push_relabel", ("gc",))}
    meta = {
        "two_nn_pairs (binary)": (
            "stitching_tpu_torch/csrc/two_nn.cu",
            "stitching_tpu/ops/pallas/two_nn.py:144"),
        "two_nn_pairs (binary, 512 bits)": (
            "stitching_tpu_torch/csrc/two_nn.cu",
            "stitching_tpu/ops/pallas/two_nn.py:144"),
        "two_nn_pairs (float)": (
            "stitching_tpu_torch/csrc/two_nn_float.cu",
            "stitching_tpu/ops/pallas/two_nn.py:144"),
        "two_nn_pairs (float, synthetic)": (
            "stitching_tpu_torch/csrc/two_nn_float.cu",
            "stitching_tpu/ops/pallas/two_nn.py:144"),
        "two_nn (binary)": (
            "stitching_tpu_torch/csrc/two_nn.cu",
            "stitching_tpu/ops/pallas/two_nn.py:67"),
        "two_nn (float)": (
            "stitching_tpu_torch/csrc/two_nn_float.cu",
            "stitching_tpu/ops/pallas/two_nn.py:67"),
        "bilinear_sample": (
            "stitching_tpu_torch/csrc/bilinear_sample.cu",
            "stitching_tpu/ops/pallas/block_warp.py:213 (and block_sample, "
            "block_warp.py:74)"),
        "count_components": (
            "stitching_tpu_torch/csrc/components.cu",
            "none: the JAX package's single_region is a host flood fill"),
        "downscale": (
            "stitching_tpu_torch/csrc/downscale.cu",
            "none: the JAX package's _host_downscale resizes on the host "
            "(stitching_tpu/engine.py)"),
        "push_relabel": (
            "stitching_tpu_torch/csrc/push_relabel.cu",
            "none: the JAX package's grid_min_cut is a plain lax.while_loop "
            "(stitching_tpu/ops/graphcut.py)"),
    }
    rows = []
    for name, res in results.items():
        wrapper, on = paths[name]
        by_path = {p: launches[p][wrapper] for p in on}
        if min(by_path.values()) < 1:
            raise AssertionError(f"{name} was not launched on {by_path}")
        rows.append(dict(name=name, route="cuda", source=meta[name][0],
                         replaces=meta[name][1],
                         launches=sum(by_path.values()),
                         launches_by_path=by_path,
                         status=("added" if name in ("count_components",
                                                     "downscale",
                                                     "push_relabel")
                                 else "ported"), **res))
    total = time.time() - t_start
    print(f"total {total:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main())
