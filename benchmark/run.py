"""Run one cell of the port's benchmark and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One process, one cell of `BENCHMARK.json`, on one H100 (a run that finds
no card fails). Set-up builds the configuration's stitcher from
`configs/<name>.json`, makes a pool of view sets on the card from the
seed (`traffic/<name>.json`, `generators.py`) and stitches each set once,
which loads the kernel libraries (built once into `build/` inside the
checkout) and warms every shape. Then:

- `--trace 0` stitches the pool's sets in turn, one caller, each stitch
  starting when the last returns, for `--seconds`, and reports the
  end-to-end metrics: `panorama_mp_per_s` (megapixels of every panorama
  completed over the window's seconds), `stitch_s_p90` (nearest rank over
  every stitch) and `setup_s` (process start to the window);
- `--trace 1` stitches each set once under `torch.profiler` (device
  metrics, read from the events in memory) and once more with the
  program's stage timers fenced (stage seconds), and reports the cell's
  per-layer metrics, each read by `metrics/<name>.py` (its `read(ctx)`).

Standard error also carries, per run, the process's CPU seconds over the
window and the collections of Python's garbage collector in it.

Once the window has closed and the stitcher is freed, the plain reference
(`reference.py`) judges a sample of the window's stitches drawn from the
seed; each number it compares, with its limit from `limits/<cell>.json`,
ends standard error and the result line.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# kernel caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = {"jax", "jaxlib", "flax", "stitching_tpu"}
CHECK_SAMPLES = 3


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    """Top-level names of loaded modules that belong to JAX or to the JAX
    package, each name compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


class HostWatch:
    """What a window cost the host: the process's CPU seconds, and the
    collections of Python's garbage collector with their seconds."""

    def __enter__(self):
        self.gc_s, self.gc_n, self._t = 0.0, 0, 0.0
        gc.callbacks.append(self._gc)
        self._cpu = time.process_time()
        return self

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n += 1

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)
        log(f"host: cpu_s {time.process_time() - self._cpu:.3f}, gc "
            f"{self.gc_n} collections {self.gc_s:.4f} s")


class Bench:
    """The stitcher of a cell, its pool of view sets and what each stitch
    leaves to be judged."""

    def __init__(self, man, cell, seed, device, shrink=1.0, pool=None):
        import stitching_tpu_torch as pkg
        from stitching_tpu_torch import engine

        from benchmark import generators

        self.dev = device
        cfg = man.config(cell["config"])
        self.settings = dict(cfg["reference"])
        kwargs = dict(cfg["kwargs"])
        if shrink != 1.0:
            # the CPU tests shrink every length; the resolutions follow
            for k in ("medium_megapix", "low_megapix"):
                self.settings[k] *= shrink ** 2
                kwargs[k] = self.settings[k]
        self.st = getattr(pkg, cfg["stitcher"])(device=device, **kwargs)
        self.traffic = man.traffic(cell["traffic"])
        self._make = generators.make
        self._set_seed = generators.set_seed
        self.shrink = shrink
        self.make_sets(seed, pool)
        self.last = {}
        self._engine = engine
        self._plan = engine.plan_composition

        def plan(st, reg):
            out = self._plan(st, reg)
            self.last = dict(
                cameras=[dict(focal=float(c.focal), aspect=float(c.aspect),
                              ppx=float(c.ppx), ppy=float(c.ppy),
                              R=np.array(c.R, copy=True))
                         for c in reg.cameras],
                kept=[int(n) - 1 for n in reg.images.names],
                lir=tuple(int(v) for v in st.cropper.lir)
                if st.cropper.do_crop else None)
            return out

        engine.plan_composition = plan

    def make_sets(self, seed, pool=None):
        """The run's pool of view sets, each from its own seed derived
        from `seed`: [(views, truth)]."""
        n = self.traffic["pool"] if pool is None else pool
        self.sets = [self._make(self.traffic, self._set_seed(seed, k),
                                self.dev, self.shrink) for k in range(n)]

    def stitch(self, k):
        """Stitch set k; (seconds, panorama, what the stitch decided)."""
        views, _ = self.sets[k]
        self.last = {}
        t0 = time.perf_counter()
        pano = self.st.stitch(views)
        wall = time.perf_counter() - t0
        return wall, pano, self.last

    def close(self):
        """Free the program's state: the stitcher and its hook."""
        self._engine.plan_composition = self._plan
        self.st = None
        gc.collect()
        if self.dev.type == "cuda":
            import torch

            torch.cuda.empty_cache()

    def judge(self, sample):
        """The numbers the reference compares for one kept stitch."""
        from benchmark import reference

        k, pano, last = sample
        views, truth = self.sets[k]
        sizes = [(v.shape[1], v.shape[0]) for v in views]
        cams = last.get("cameras", [])
        if last.get("kept") != list(range(len(views))):
            cams = []
        reg = reference.registration_error_px(cams, truth, sizes,
                                              self.settings)
        gaps = uncovered = None
        crop = dict(crop_outside_share=1.0, crop_area_short=1.0)
        if cams and last.get("lir") is not None:
            mask = reference.low_mask(cams, sizes, self.settings, self.dev)
            crop = reference.crop_numbers(mask, last["lir"])
            del mask
            try:
                lay = reference.layout(cams, sizes, last["lir"],
                                       self.settings)
                gaps, uncovered = reference.panorama_gaps(pano, views, lay,
                                                          self.dev)
            except ValueError as exc:
                log(f"reference: {exc}")
        return {"reg_err_px": reg, **reference.gap_numbers(gaps, uncovered),
                **crop}


def main(argv=None, device=None, shrink=1.0, pool=None):
    """Run a cell; print the result line and return the exit code.
    `device`, `shrink` and `pool` serve the CPU tests only: the command
    line always runs on the card, at full size, with the traffic's
    pool."""
    args = parse(argv)
    import torch

    from benchmark import tracing
    from benchmark.manifest import Manifest
    from benchmark.stats import nearest_rank

    man = Manifest()
    cell = man.workload(args.workload)
    limits = man.limits(cell["name"])
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            log(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
                f"found {torch.cuda.device_count()}")
            return 2
        device = "cuda"
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t_sets = time.time()
    bench = Bench(man, cell, args.seed, dev, shrink, pool)
    sync()
    t_warm = time.time()
    pool = len(bench.sets)
    warm = []
    for k in range(pool):           # warm-up: every set once
        warm.append(bench.stitch(k)[0])
    sync()
    setup_s = time.time() - T_START
    log(f"set-up {setup_s:.3f} s: to the stitcher {t_sets - T_START:.3f} s, "
        f"stitcher and view sets {t_warm - t_sets:.3f} s, warm-up stitches "
        f"{[round(w, 4) for w in warm]}")

    rng = random.Random(args.seed)
    kept, seen, stitched = [], 0, []
    walls, mp = [], 0.0
    attempted = failed = 0

    def one(i):
        nonlocal attempted, failed, seen, mp
        attempted += 1
        try:
            wall, pano, last = bench.stitch(i % pool)
        except Exception as exc:  # a failed stitch is counted, not fatal
            failed += 1
            log(f"stitch {i} raised {type(exc).__name__}: {exc}")
            return
        walls.append(wall)
        mp += pano.shape[0] * pano.shape[1] / 1e6
        seen += 1
        stitched.append((i % pool, last))
        sample = (i % pool, pano, last)
        if len(kept) < CHECK_SAMPLES:
            kept.append(sample)
        else:
            j = rng.randrange(seen)
            if j < CHECK_SAMPLES:
                kept[j] = sample

    metrics, device_info, breakdown = {}, {}, None
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    if args.trace == 0:
        with HostWatch():
            t0 = time.perf_counter()
            i = 0
            while time.perf_counter() - t0 < args.seconds:
                one(i)
                i += 1
            window = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        values = {"setup_s": setup_s}
        if walls:
            values["panorama_mp_per_s"] = mp / window
            values["stitch_s_p90"] = nearest_rank(walls, 0.9)
        for m in man.end_to_end(cell["name"]):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        log(f"window {window:.3f} s, {len(walls)} stitches, walls "
            f"{[round(w, 4) for w in walls]}")
    else:
        from torch.profiler import ProfilerActivity, profile
        from stitching_tpu_torch import profiling

        readers = [(m, man.metric_reader(m["name"]))
                   for m in man.per_layer(cell["name"])]
        activities = [ProfilerActivity.CPU]
        if on_card:
            activities.append(ProfilerActivity.CUDA)
        with tracing.Spans(profiling, ranges=True) as ranged, \
                profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for i in range(pool):
                one(i)
            sync()
            window = time.perf_counter() - t0
        traced = len(walls)
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        dev_events, host_events = tracing.digest(
            prof, {name for name, _, _ in ranged.spans})
        del prof
        with tracing.Spans(profiling) as spans:
            profiling.reset()
            profiling.enable()
            profiling.enable_fence()
            try:
                for i in range(pool):
                    one(pool + i)
            finally:
                profiling.enable(False)
                profiling.enable_fence(False)
                profiling.reset()
        shapes = [[v.shape for v in bench.sets[k][0]] for k in range(pool)]
        ctx = types.SimpleNamespace(
            device=dev_events, host=host_events, window_s=window,
            traced=traced, spans=spans, fenced=len(walls) - traced,
            peak_bytes=peak, on_card=on_card,
            settings=bench.settings,
            stitches=[([shapes[k][j] for j in last["kept"]], last)
                      for k, last in stitched[:traced] if last])
        for m, r in readers:
            v = r.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info = {"busy_s": tracing.busy_seconds(dev_events),
                       "window_s": window}
        breakdown = {"device_ops": tracing.top_ops(dev_events),
                     "idle_gaps": tracing.idle_gaps(dev_events, host_events)}
        log(f"traced part {window:.3f} s over {traced} stitches, "
            f"{len(dev_events)} device operations")

    # the window has closed: free the program's state, then judge
    bench.close()
    numbers = {}
    rejected = 0
    for sample in kept:
        got = bench.judge(sample)
        log("judged: " + " ".join(f"{k}={v:.6g}" for k, v in got.items()))
        if any(not v <= limits[k] for k, v in got.items()):
            rejected += 1
        for k, v in got.items():
            numbers[k] = max(numbers.get(k, v), v)
    failed += rejected
    correct = failed == 0 and bool(kept)
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in numbers.items()}

    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process: {', '.join(bad)}; no result")
        return 3
    if on_card:
        kind = torch.cuda.get_device_name(dev)
        power = power_limit()
    else:
        kind, power = "cpu", "none"
    result = {
        "correct": correct, "attempted": attempted, "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": int(peak),
                   "power_limit": power, **device_info},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k} {c['value']:.6g} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
