"""The registration inputs made on the card (`ops/kernels/downscale.py`).

On the CPU: the plain version, through `engine._downscale_landed` with
the uploader on the CPU, against `stack_images(_host_downscale(...))` bit
for bit (data and sizes) at the cells' shapes, on ragged and odd sizes,
gray views, a batch that mixes gray and colour, and taps that clamp at
both edges, and once against the JAX package's host stacks; the
wrapper's checks; the engine's choice of path (uint8 views of one plane
or three channels take `downscale` on every device), a CPU stitch that
runs the plain version for uint8 views and the host path for float ones
with nothing counted, the host path under a mesh, a CPU stitch forced
onto the host path equal to the plain version's; and the benchmark's
reader of the counter.

On the card (`-m cuda`; this file imports the JAX package only inside its
CPU tests, so it runs there too): the kernel's stacks against the host
stacks on the same cases, its launches and counter, and one
`Stitcher().stitch` byte-equal to the same stitch forced onto the host
path.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from stitching_tpu_torch import Stitcher, engine, profiling
from stitching_tpu_torch.images import Images
from stitching_tpu_torch.ops.kernels.downscale import (
    LAUNCHES, downscale, downscale_plain, resize_table)
from stitching_tpu_torch.pipeline import stack_images
from stitching_tpu_torch.transfer import Uploader

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTER = "registration/device_downscales"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _scaled(shapes, medium=Images.Resolution.MEDIUM.value,
            low=Images.Resolution.LOW.value):
    """The MEDIUM and LOW sizes that registration gives views of `shapes`
    (the first view sets the scale, as in the stitcher)."""
    n = len(shapes)
    # `Images` takes two views or more
    images = Images.of([np.zeros(s, np.uint8) for s in shapes * 2], medium,
                       low)
    list(images)
    return (images.get_scaled_img_sizes(Images.Resolution.MEDIUM)[:n],
            images.get_scaled_img_sizes(Images.Resolution.LOW)[:n])


def _case(name):
    """(views, MEDIUM sizes, LOW sizes) of a case."""
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "clamp":
        # LOW above the source size: the first and last taps clamp on both
        # axes; MEDIUM an odd reduction
        shapes, med, low = [(9, 13, 3), (7, 5)], [(5, 4), (3, 6)], \
            [(29, 21), (11, 17)]
    else:
        shapes = {"12mp": [(3024, 4032, 3)],
                  "scan": [(1200, 1600, 3), (1200, 1600, 3)],
                  "ragged": [(301, 403, 3), (255, 411, 3), (97, 120, 3)],
                  "gray": [(480, 640), (333, 517)],
                  "mixed": [(480, 640, 3), (470, 651), (481, 639, 3)]}[name]
        med, low = _scaled(shapes, medium=0.6 if name in ("12mp", "scan")
                           else 0.05, low=0.1 if name in ("12mp", "scan")
                           else 0.01)
    views = [rng.randint(0, 256, s).astype(np.uint8) for s in shapes]
    return views, med, low


CASES = ("12mp", "scan", "ragged", "gray", "mixed", "clamp")


def _host_stacks(views, med, low):
    gray, colour = engine._host_downscale(views, med, low)
    return stack_images(gray, "cpu"), stack_images(colour, "cpu")


def _card_stacks(views, med, low, device):
    up = Uploader(views, device=device)
    try:
        return engine._downscale_landed(up, views, med, low, device)
    finally:
        up.join()


def _assert_equal_stacks(got, want):
    for g, w in zip(got, want):
        assert g.data.dtype == torch.float32
        assert g.data.shape == w.data.shape
        assert torch.equal(g.data.cpu(), w.data)
        np.testing.assert_array_equal(g.sizes, w.sizes)
        assert g.sizes.dtype == w.sizes.dtype and g.mesh is None


# ---------------------------------------------------------------------------
# The CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_plain_stacks_equal_the_host_stacks(name):
    views, med, low = _case(name)
    _assert_equal_stacks(_card_stacks(views, med, low, "cpu"),
                         _host_stacks(views, med, low))


def test_plain_stacks_equal_the_jax_host_stacks():
    from stitching_tpu import engine as jax_engine
    from stitching_tpu import pipeline as jax_pipeline
    from stitching_tpu.ops.resize import resize

    views, med, low = _case("mixed")
    gray, colour = jax_engine._host_downscale(views, med, low, resize)
    got = _card_stacks(views, med, low, "cpu")
    for g, imgs in zip(got, (gray, colour)):
        ref = jax_pipeline.stack_images(imgs)
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(ref.data))
        np.testing.assert_array_equal(g.sizes, ref.sizes)


def test_resize_table_holds_resize_taps():
    from stitching_tpu_torch.ops.resize import _axis_weights

    table = resize_table((7, 10), (4, 3))
    assert table.dtype == np.int32 and table.shape == (4 * (3 + 4),)
    for words, (n_in, n_out) in ((table[:12], (7, 3)), (table[12:], (10, 4))):
        i0, i1, w1 = _axis_weights(n_in, n_out)
        words = words.reshape(4, n_out)
        np.testing.assert_array_equal(words[0], i0)
        np.testing.assert_array_equal(words[1], i1)
        np.testing.assert_array_equal(words[2].view(np.float32), w1)
        np.testing.assert_array_equal(words[3].view(np.float32), 1 - w1)
    # 7 rows to 3: centres 2/3, 3 and 16/3; 10 columns to 4: 3/4 + 5/2 k
    np.testing.assert_array_equal(table[:3], [0, 3, 5])
    np.testing.assert_array_equal(table[12:16], [0, 3, 5, 8])


def _args(src, med_c=1, low_c=3, med_size=(5, 4), low_size=(3, 2)):
    h, w = src.shape[:2]
    return (src, torch.zeros(64, 64, med_c), med_size,
            torch.from_numpy(resize_table((h, w), med_size)),
            torch.zeros(64, 64, low_c), low_size,
            torch.from_numpy(resize_table((h, w), low_size)))


BAD = {
    "float source": lambda: _args(torch.zeros(9, 9, 3)),
    "four channels": lambda: _args(torch.zeros(9, 9, 4, dtype=torch.uint8)),
    "one channel": lambda: _args(torch.zeros(9, 9, 1, dtype=torch.uint8)),
    "colour med": lambda: _args(torch.zeros(9, 9, 3, dtype=torch.uint8),
                                med_c=3),
    "gray low of colour": lambda: _args(
        torch.zeros(9, 9, 3, dtype=torch.uint8), low_c=1),
    "size past the slot": lambda: _args(
        torch.zeros(9, 9, 3, dtype=torch.uint8), med_size=(65, 4)),
    "non-contiguous source": lambda: _args(
        torch.zeros(9, 18, 3, dtype=torch.uint8)[:, ::2]),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        downscale(*BAD[bad]())


def test_wrapper_raises_on_a_table_of_another_size():
    args = list(_args(torch.zeros(9, 9, 3, dtype=torch.uint8)))
    args[3] = args[3][:-1]
    with pytest.raises(ValueError):
        downscale(*args)


def test_wrapper_on_the_cpu_runs_the_plain_version():
    src = torch.from_numpy(_case("clamp")[0][0])
    args = _args(src)
    want = _args(src)
    before = downscale.launches
    profiling.reset()
    profiling.enable()
    try:
        downscale(*args)
        counters = profiling.get_counters()
    finally:
        profiling.enable(False)
        profiling.reset()
    downscale_plain(*want)
    assert torch.equal(args[1], want[1]) and torch.equal(args[4], want[4])
    assert downscale.launches == before and COUNTER not in counters


@pytest.mark.parametrize("device,kind,landed", [
    ("cuda", "colour", True), ("cuda:0", "gray", True),
    ("cuda", "mixed", True), ("cpu", "colour", True),
    ("cpu", "gray", True), ("cuda", "float", False),
    ("cuda", "rgba", False), ("cuda", "one channel", False)])
def test_the_card_path_needs_a_cuda_device_and_uint8_views(device, kind,
                                                           landed):
    """The views choose the path, the device does not: uint8 views of one
    plane or three channels go through `downscale` on the card and on the
    CPU alike, the others through `_host_downscale`."""
    views = {"colour": [np.zeros((8, 8, 3), np.uint8)] * 2,
             "gray": [np.zeros((8, 8), np.uint8)] * 2,
             "mixed": [np.zeros((8, 8, 3), np.uint8), np.zeros((8, 8),
                                                               np.uint8)],
             "float": [np.zeros((8, 8, 3), np.uint8),
                       np.zeros((8, 8, 3), np.float32)],
             "rgba": [np.zeros((8, 8, 4), np.uint8)],
             "one channel": [np.zeros((8, 8, 1), np.uint8)]}[kind]
    assert engine._downscalable(views) is landed


@pytest.fixture(scope="module")
def views():
    from fixtures import rotation_set

    imgs, _, _ = rotation_set(n=3, size=(640, 480))
    return imgs


def _stitch_counted(st, imgs):
    profiling.reset()
    profiling.enable()
    try:
        pano = st.stitch(imgs)
        counters = profiling.get_counters()
    finally:
        profiling.enable(False)
        profiling.reset()
    return pano, counters


def test_cpu_stitch_downscales_on_the_host(views, monkeypatch):
    """A uint8 stitch on the CPU runs `downscale` (its plain version) on
    each view as it lands; a float stitch runs `_host_downscale`. Neither
    counts: the counter is the card's."""
    host, landed = [], []
    real_host, real_downscale = engine._host_downscale, engine.downscale
    monkeypatch.setattr(engine, "_host_downscale",
                        lambda *a: host.append(1) or real_host(*a))
    monkeypatch.setattr(engine, "downscale",
                        lambda *a: landed.append(1) or real_downscale(*a))
    _, counters = _stitch_counted(
        Stitcher(device="cpu", medium_megapix=0.1), views)
    assert landed == [1] * len(views) and host == []
    assert COUNTER not in counters
    floats = [v.astype(np.float32) for v in views]
    _, counters = _stitch_counted(
        Stitcher(device="cpu", medium_megapix=0.1), floats)
    assert landed == [1] * len(views) and host == [1]
    assert COUNTER not in counters


def test_card_branch_forced_on_the_cpu_equals_the_host_path(views,
                                                            monkeypatch):
    """The async branch through `_downscale_landed` (the plain version on
    the CPU), then the same stitch forced onto the host downscale: the
    same panorama."""
    made, host = [], []
    landed, real_host = engine._downscale_landed, engine._host_downscale
    monkeypatch.setattr(engine, "_downscale_landed",
                        lambda *a: made.append(1) or landed(*a))
    got, counters = _stitch_counted(
        Stitcher(device="cpu", medium_megapix=0.1), views)
    assert made == [1]
    # the plain version counts nothing: the counter is the card's
    assert COUNTER not in counters
    monkeypatch.setattr(engine, "_downscalable", lambda *a: False)
    monkeypatch.setattr(engine, "_host_downscale",
                        lambda *a: host.append(1) or real_host(*a))
    want, _ = _stitch_counted(Stitcher(device="cpu", medium_megapix=0.1),
                              views)
    assert made == [1] and host == [1]
    np.testing.assert_array_equal(got, want)


def mesh_rank(mesh, imgs):
    """A mesh registration with the landed downscale offered: larger views
    are resized on the host (`_host_resize`) and nothing is counted."""
    resized, made = [], []
    resize = engine._host_resize
    engine._host_resize = lambda im, size: (
        resized.append(tuple(int(v) for v in size)), resize(im, size))[1]
    engine._downscalable = lambda *a: True
    landed = engine._downscale_landed
    engine._downscale_landed = lambda *a: made.append(1) or landed(*a)
    profiling.reset()
    profiling.enable()
    try:
        engine.register(Stitcher(mesh=mesh, crop=False, medium_megapix=0.1),
                        imgs)
        counters = profiling.get_counters()
    finally:
        profiling.enable(False)
        profiling.reset()
    return resized, made, counters


def test_mesh_keeps_the_host_resize(views, tmp_path):
    from test_torch_mesh import run_ranks

    [(resized, made, counters)] = run_ranks(mesh_rank, views, tmp_path,
                                            world=1)
    assert len(resized) == len(views) and made == []
    assert COUNTER not in counters


def test_benchmark_reader_counts_downscales_per_fenced_stitch(monkeypatch):
    sys.path.insert(0, ROOT)
    from benchmark import program_record
    from benchmark.manifest import Manifest

    reader = Manifest().metric_reader("device_downscales")
    kept = {"spans": [], "counters": {}, "allocs": []}
    monkeypatch.setattr(program_record, "_KEPT", kept)
    ctx = types.SimpleNamespace(fenced=3, traced=3)
    kept["counters"] = {COUNTER: 18}
    assert reader.read(ctx) == 6
    kept["counters"] = {"crop/label_launches": 9}    # the host path
    assert reader.read(ctx) is None
    ctx.fenced = 0
    kept["counters"] = {COUNTER: 18}
    assert reader.read(ctx) is None
    [entry] = [m for m in json.load(open(os.path.join(ROOT,
                                                      "BENCHMARK.json")))
               ["per_layer"] if m["name"] == "device_downscales"]
    assert (entry["layer"], entry["unit"], entry["moves"]) == (
        "registration", "images", "panorama_mp_per_s")


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_stacks_equal_the_host_stacks(cuda_device, name):
    views, med, low = _case(name)
    before = downscale.launches
    profiling.reset()
    profiling.enable()
    try:
        got = _card_stacks(views, med, low, cuda_device)
        torch.cuda.synchronize()
        counters = profiling.get_counters()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert all(s.data.is_cuda for s in got)
    assert downscale.launches == before + LAUNCHES * len(views)
    assert counters.get(COUNTER) == len(views)
    _assert_equal_stacks(got, _host_stacks(views, med, low))


@pytest.mark.cuda
def test_stitch_on_the_card_equals_the_host_downscale(cuda_device,
                                                      monkeypatch):
    sys.path.insert(0, ROOT)
    import chip_smoke

    imgs, _ = chip_smoke.rotation_set(4, (1200, 900), 1000.0, 0.4,
                                      cuda_device)
    got, counters = _stitch_counted(Stitcher(), imgs)
    assert counters.get(COUNTER) == len(imgs)
    monkeypatch.setattr(engine, "_downscalable", lambda *a: False)
    want, counters = _stitch_counted(Stitcher(), imgs)
    assert COUNTER not in counters
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
