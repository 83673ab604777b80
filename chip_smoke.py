"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds every CUDA kernel of the port from `stitching_tpu_torch/csrc`;
3. drives the port's main path, `Stitcher(**SLICE).stitch`, on 8 rendered
   views of 1600x1200 (the bench workload: focal 1400, +-0.6 rad), once
   to warm up and once with the kernels' launch counters set to 0, and
   fails unless each kernel of the path launched;
4. holds each kernel against its plain PyTorch version on the very inputs
   the main path gave it, and times kernel, plain version and, where one
   exists, a PyTorch library call computing the same function (device
   time per call from a CUDA graph replay; the kernel wrapper's
   CUDA-event time, host launch included, beside it);
5. times the stages once more, each ended by a sync, and profiles one
   stitch (device busy share, the device operations that take longest);
6. checks the output: the cameras against the rendered ground truth, and
   the card's panorama against the CPU's on a small input;
7. prints the kernels line, the card line and, last, the result line.

Any failure raises and exits non-zero; so does a machine without CUDA.
"""

import json
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

FOCAL = 1400.0
MAX_ANGLE = 0.6


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def textured_scene(h=1000, w=1800, seed=0):
    """`tests/fixtures.textured_scene` without OpenCV: corner-rich blocks,
    two low-frequency gradients and a 5-tap Gaussian blur (sigma 1.2)."""
    rng = np.random.RandomState(seed)
    img = np.zeros((h, w, 3), np.float32)
    img[:] = rng.uniform(40, 80, 3)
    for _ in range(500):
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


def kernel_times(kernel, plain, library=None, iters=20):
    """ms, plain_ms and library_ms of one function on the same inputs,
    each from a CUDA graph replay; call_ms is the CUDA-event time of
    back-to-back calls of the kernel's wrapper, host launch included."""
    return {"ms": graph_ms(kernel, iters),
            "call_ms": time_ms(kernel, iters),
            "plain_ms": graph_ms(plain, max(iters // 4, 3)),
            "library_ms": None if library is None else graph_ms(library,
                                                                iters)}


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


def check_two_nn(call):
    from stitching_tpu_torch.ops.kernels.two_nn import (two_nn_pairs,
                                                        two_nn_pairs_plain)

    (desc, valid, pair_ij), kw = call
    out = two_nn_pairs(desc, valid, pair_ij, **kw)
    ref = two_nn_pairs_plain(desc, valid, pair_ij, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("d0", "d1", "i0"), out, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"two_nn_pairs {name} differs from the "
                                 "plain version")
    B, N, D = desc.shape
    P = pair_ij.shape[0]
    times = kernel_times(
        lambda: two_nn_pairs(desc, valid, pair_ij, **kw),
        lambda: two_nn_pairs_plain(desc, valid, pair_ij, **kw), iters=50)
    nbytes = (desc.numel() * 4 + valid.numel() + pair_ij.numel() * 4
              + 3 * P * 2 * N * 4)
    # the distance products: 2 ops per bit pair, exact in int8
    ops = 2.0 * P * 2 * N * N * D
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
              "operations": ops / INT8_OPS_PER_S * 1e3}
    print(f"two_nn_pairs desc {tuple(desc.shape)} P={P}: equal to plain; "
          f"{times_text(times)} bound_us bytes={bounds['bytes'] * 1e3:.2f} "
          f"ops={bounds['operations'] * 1e3:.2f}", flush=True)
    bound_by = max(bounds, key=bounds.get)
    return dict(max_abs_err=0.0, bound_ms=bounds[bound_by],
                bound_by=bound_by, **times)


def check_sampler(calls):
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
    (data, sxc, syc, care), _ = max(calls, key=lambda c: c[0][0].numel())
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
    times = kernel_times(
        lambda: bilinear_sample(data, sxc, syc, care),
        lambda: bilinear_sample_plain(data, sxc, syc, care),
        lambda: F.grid_sample(planes, grid, mode="bilinear",
                              padding_mode="border", align_corners=True))
    # the stack, both coordinate planes and the output; `care` is not read
    nbytes = data.numel() * 4 + sxc.numel() * 8 + B * th * tw * C * 4
    ops = 9.0 * B * th * tw * C
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
              "operations": ops / FP32_FLOPS_PER_S * 1e3}
    print(f"bilinear_sample timing at {tuple(sxc.shape)}: {times_text(times)} "
          f"(library: grid_sample, max diff {lib_err:.3g}) bound_us "
          f"bytes={bounds['bytes'] * 1e3:.2f} "
          f"ops={bounds['operations'] * 1e3:.2f}", flush=True)
    bound_by = max(bounds, key=bounds.get)
    return dict(max_abs_err=max(errs), bound_ms=bounds[bound_by],
                bound_by=bound_by, **times)


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


def composite_with(st, imgs, cameras):
    """The slice's compositing with the given cameras (registration runs
    for its image bookkeeping, then its cameras are replaced)."""
    from stitching_tpu_torch import engine

    reg = engine.register(st, imgs)
    reg.cameras = [c.copy() for c in cameras]
    st.warper.set_scale(reg.cameras)
    reg.scale = st.warper.scale
    return engine.composite(st, reg, engine.plan_composition(st, reg))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    from stitching_tpu_torch import SLICE, Stitcher, compose, engine, pipeline
    from stitching_tpu_torch.ops import kernels
    from stitching_tpu_torch.ops.kernels.bilinear_sample import (
        bilinear_sample)
    from stitching_tpu_torch.ops.kernels.two_nn import two_nn_pairs

    t_start = time.time()
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)

    t0 = time.time()
    kernels.build()
    print(f"build: {len(kernels.KERNELS)} kernels in {time.time() - t0:.1f} "
          "s", flush=True)

    dev = torch.device("cuda")
    imgs, Rs_true = rotation_set(8, (1600, 1200), FOCAL, MAX_ANGLE, dev)
    print(f"rendered {len(imgs)} views of {imgs[0].shape}", flush=True)

    # the main path, with the kernels' inputs recorded at their call sites
    rec_nn = Recorder(pipeline.two_nn_pairs)
    rec_bs = Recorder(compose.bilinear_sample)
    pipeline.two_nn_pairs = rec_nn
    compose.bilinear_sample = rec_bs
    st = Stitcher(**SLICE)
    t0 = time.time()
    st.stitch(imgs)
    torch.cuda.synchronize()
    print(f"warm-up stitch: {time.time() - t0:.3f} s", flush=True)
    rec_nn.calls.clear()
    rec_bs.calls.clear()
    two_nn_pairs.launches = 0
    bilinear_sample.launches = 0
    t0 = time.time()
    pano = st.stitch(imgs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"two_nn_pairs": two_nn_pairs.launches,
                "bilinear_sample": bilinear_sample.launches}
    pipeline.two_nn_pairs = rec_nn.fn
    compose.bilinear_sample = rec_bs.fn
    mp = pano.shape[0] * pano.shape[1] / 1e6
    print(f"stitch: wall_s={wall:.4f} pano={pano.shape} mp={mp:.3f} "
          f"mp_per_s={mp / wall:.3f} nonzero_share="
          f"{float((pano.max(-1) > 0).mean()):.4f} launches={launches}",
          flush=True)
    if launches != {"two_nn_pairs": 1, "bilinear_sample": 2}:
        raise AssertionError(f"kernel launches on the main path: {launches}")

    # where the time goes: the stages once more, each ended by a sync
    t0 = time.time()
    reg = engine.register(st, imgs)
    torch.cuda.synchronize()
    t1 = time.time()
    plan = engine.plan_composition(st, reg)
    torch.cuda.synchronize()
    t2 = time.time()
    pano2 = engine.composite(st, reg, plan)
    torch.cuda.synchronize()
    t3 = time.time()
    print(f"stages (fenced): register_s={t1 - t0:.4f} "
          f"plan_low_warp_s={t2 - t1:.4f} composite_final_s={t3 - t2:.4f}",
          flush=True)
    profile_stitch(st, imgs)

    # the output: its shape, cameras against the rendered ground truth
    if pano.dtype != np.uint8 or pano.ndim != 3 or pano.shape[2] != 3:
        raise AssertionError(f"panorama {pano.dtype} {pano.shape}")
    if not np.array_equal(pano, pano2):
        raise AssertionError("two runs of the slice gave different panoramas")
    medium_scale = (0.6e6 / (1600 * 1200)) ** 0.5
    f_true = FOCAL * medium_scale
    focals = [c.focal for c in reg.cameras]
    yaw = [float(np.arctan2(c.R[0, 2], c.R[2, 2])) for c in reg.cameras]
    yaw_true = [float(np.arctan2(R[0, 2], R[2, 2])) for R in Rs_true]
    # the estimate fixes the rotations up to a common one and a sign
    yaw_err = max(abs(abs(a - yaw[0]) - abs(b - yaw_true[0]))
                  for a, b in zip(yaw, yaw_true))
    print(f"cameras: focal {focals[0]:.2f} (true {f_true:.2f}), relative "
          f"yaw max error {yaw_err:.4f} rad", flush=True)
    if abs(focals[0] - f_true) > 0.05 * f_true or yaw_err > 0.02:
        raise AssertionError("cameras far from the rendered ground truth")
    want_w = (focals[0] * abs(yaw[-1] - yaw[0])
              + 1600 * medium_scale) / medium_scale
    if not 0.9 * want_w <= pano.shape[1] <= 1.2 * want_w:
        raise AssertionError(f"panorama width {pano.shape[1]} vs "
                             f"{want_w:.0f} expected")

    # small input: the card against the CPU (plain versions), same cameras
    small, _ = rotation_set(3, (640, 480), 600.0, 0.5, dev)
    cpu = Stitcher(device="cpu", **SLICE)
    cpu_reg = engine.register(cpu, small)
    gpu_reg = engine.register(Stitcher(**SLICE), small)
    f_cpu, f_gpu = cpu_reg.cameras[0].focal, gpu_reg.cameras[0].focal
    pano_cpu = composite_with(cpu, small, cpu_reg.cameras)
    pano_gpu = composite_with(Stitcher(**SLICE), small, cpu_reg.cameras)
    if pano_cpu.shape != pano_gpu.shape:
        raise AssertionError(f"small input: {pano_gpu.shape} on the card, "
                             f"{pano_cpu.shape} on the CPU")
    near = float((np.abs(pano_gpu.astype(np.int16)
                         - pano_cpu.astype(np.int16)) <= 1).mean())
    print(f"small input: focal card {f_gpu:.3f} cpu {f_cpu:.3f}; panorama "
          f"{pano_gpu.shape} within 1 LSB of the CPU's at {near:.6f} of "
          "values", flush=True)
    if abs(f_gpu - f_cpu) > 0.02 * f_cpu or near < 0.999:
        raise AssertionError("the card's slice disagrees with the CPU's")

    # every kernel against its plain version at the main path's inputs
    if len(rec_nn.calls) != 1 or len(rec_bs.calls) != 2:
        raise AssertionError("kernel calls were not recorded")
    results = {"two_nn_pairs": check_two_nn(rec_nn.calls[0]),
               "bilinear_sample": check_sampler(rec_bs.calls)}
    rows = [
        dict(name="two_nn_pairs", route="cuda",
             source="stitching_tpu_torch/csrc/two_nn.cu",
             replaces="stitching_tpu/ops/pallas/two_nn.py:143",
             launches=launches["two_nn_pairs"], status="ported",
             **results["two_nn_pairs"]),
        dict(name="bilinear_sample", route="cuda",
             source="stitching_tpu_torch/csrc/bilinear_sample.cu",
             replaces="stitching_tpu/ops/pallas/block_warp.py:212",
             launches=launches["bilinear_sample"],
             status="ported (also covers block_sample, block_warp.py:73)",
             **results["bilinear_sample"]),
    ]
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
