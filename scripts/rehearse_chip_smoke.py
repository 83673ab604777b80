"""Rehearse `chip_smoke.py` on a machine without a GPU.

    python scripts/rehearse_chip_smoke.py

Runs `chip_smoke.main()` with the port on the CPU: `torch.cuda` and the
CUDA-only measurement aids (kernel builds, the boundary phase, graph-replay
timings, launch capture, the profiler, the region count's check, which
needs masks on the card, and the graph cut's, whose kernel takes no grid
on the CPU) are stubbed, the launch counts are
not checked (a CPU tensor runs a kernel's plain version, which does not
count), the 8-view workloads shrink to 3 views at the bench's spacing
between neighbours and 3 scan crops, and the giant canvas and the strip
layouts to an eighth of their size (under a 1-byte budget); the CLI's
subprocess runs and the two-rank mesh phase (processes of their own on
the card) are skipped, and the one-rank mesh is a gloo world of one on
the CPU. It finds wrong shapes, arguments and control
flow in the script and in the paths it drives; it can say nothing
of the kernels or of any time. Takes 2-3 minutes on a few cores.
"""

import functools
import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import stitching_tpu_torch.pipeline as pipeline  # noqa: E402
import stitching_tpu_torch.stitcher as stitcher  # noqa: E402
from stitching_tpu_torch.ops import kernels  # noqa: E402
from stitching_tpu_torch.parallel.mesh import make_mesh  # noqa: E402


class _Event:
    def __init__(self, **kwargs):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 0.0


def _stub_torch():
    """chip_smoke's view of torch: CUDA present, every device the CPU."""
    fake = types.SimpleNamespace(**{k: getattr(torch, k) for k in dir(torch)
                                    if not k.startswith("__")})
    fake.__version__ = torch.__version__
    fake.version = torch.version
    fake.device = lambda *args, **kwargs: torch.device("cpu")
    fake.cuda = types.SimpleNamespace(
        is_available=lambda: True, synchronize=lambda: None, Event=_Event,
        reset_peak_memory_stats=lambda: None, max_memory_allocated=lambda: 0,
        empty_cache=lambda: None,
        get_device_name=lambda i=0: "CPU rehearsal",
        device_count=lambda: 1)
    return fake


def counted_run(name, fn, wrappers, expect, recorders=()):
    """`chip_smoke.counted_run` without the launch check."""
    fn()
    for r in recorders:
        r.calls.clear()
    t0 = time.time()
    out = fn()
    wall = time.time() - t0
    print(f"{name}: wall_s={wall:.4f} launches not counted (CPU)",
          flush=True)
    return out, wall, {k: expect.get(k, 1) for k in wrappers}


def main():
    torch.set_num_threads(4)
    cs.torch = _stub_torch()
    cs.card_line = lambda: "CPU rehearsal, no power limit"
    kernels.build = lambda *args, **kwargs: None
    cs.boundary_phase = lambda dev: print("boundary phase: CUDA only")
    cs.kernel_times = lambda *args, **kwargs: dict(
        ms=0.0, call_ms=0.0, floor_ms=0.0, plain_ms=0.0, library_ms=None)
    cs.launched_kernels = lambda fn, expect, what: expect
    # a mask on the CPU is flood filled on the host: no region count
    cs.check_components = lambda by_path, timed: dict(
        max_abs_err=0.0, bound_ms=0.0, bound_by="bytes",
        **cs.kernel_times())
    # a grid on the CPU runs the plain loop: no push-relabel kernel
    cs.check_graphcut = lambda dev: dict(
        max_abs_err=0.0, bound_ms=0.0, bound_by="bytes",
        **cs.kernel_times())
    cs.two_nn_launches = lambda *args, **kwargs: 1
    cs.profile_stitch = lambda st, imgs: print("profile: CUDA only")
    # a process of its own runs on the card: the in-process CLI run and
    # the test suite cover the same code here
    cs.cli_subprocess = lambda paths, tmp: print("cli subprocess: CUDA only")
    cs.counted_run = counted_run
    cs.one_rank_mesh = lambda: make_mesh(device="cpu")
    cs.two_rank_phase = lambda imgs, cams, pano: print(
        "mesh two ranks: processes on the card only (the gloo ranks run in "
        "tests/test_torch_mesh*.py)")
    rotation_set = cs.rotation_set
    # 3 views with the 8-view set's spacing between neighbours
    views = cs.N_VIEWS
    cs.N_VIEWS = 3
    cs.STITCH_LAUNCHES = dict(cs.STITCH_LAUNCHES, bilinear_sample=4,
                              downscale=3)
    # the downscale's check at a quarter of the views' sides
    cs.DOWNSCALE_SHAPES = {"12mp": (2, (1008, 756)), "scan": (3, (400, 300))}
    cs.rotation_set = lambda n, size, focal, angle, device: (
        rotation_set(3, size, focal, angle * 2 / (views - 1), "cpu")
        if size == (1600, 1200)
        else rotation_set(n, size, focal, angle, "cpu"))
    cs.GIANT = dict(grid=(3, 2), tile=(640, 512), step=(585, 433),
                    budget=1)
    cs.STRIPS = {
        "x": dict(grid=(1, 24), tile=(150, 200), step=(0, 175), budget=1,
                  stream_fetch=True),
        "y": dict(grid=(8, 2), tile=(150, 200), step=(125, 175), budget=1,
                  stream_fetch=False)}
    init = stitcher.Stitcher.__init__
    stitcher.Stitcher.__init__ = (
        lambda self, device="cpu", **kw: init(self, device="cpu", **kw))
    pipeline.register_pair = functools.partial(pipeline.register_pair,
                                               device="cpu")
    return cs.main()


if __name__ == "__main__":
    sys.exit(main())
