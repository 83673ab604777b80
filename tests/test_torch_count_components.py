"""The region count of the crop planner (`ops/kernels/components.py`).

On the CPU: `count_components_plain` against `single_region` of both
packages (one region exactly when the count is 1) and against
`scipy.ndimage.label` with 4-connectivity (the count itself), on masks
that cross the kernel's 32-pixel tiles in every way; the wrapper's checks;
the host path of `single_region`, which still counts its flood rounds; and
the benchmark's reader of the kernel's launches.

On the card (`-m cuda`; this file imports the JAX package only inside
its CPU tests, so it runs there too): the kernel's count against the
plain version and `single_region` on the same masks and on the LOW
panorama masks of both traffic generators, a fault surfacing at
`torch.cuda.synchronize()`, and a scan stitch that plans its crop on
the card.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from scipy import ndimage

from stitching_tpu_torch import cropper, profiling
from stitching_tpu_torch.ops.kernels.components import (
    LAUNCHES, count_components, count_components_plain)

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOUR = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])
N_BLOBS = 300


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _region_masks():
    """`test_torch_crop._region_masks`: one block, a block and a speck, a
    block with a hole, two blocks meeting at a corner, nothing."""
    one = np.zeros((20, 30), np.uint8)
    one[3:15, 4:25] = 255
    two = one.copy()
    two[17:19, 1:3] = 255
    ring = one.copy()
    ring[6:9, 8:12] = 0
    touching = np.zeros((20, 30), np.uint8)
    touching[2:8, 2:8] = 255
    touching[8:12, 8:12] = 255      # corner contact only: two regions
    return dict(one=one, two=two, ring=ring, touching=touching,
                empty=np.zeros((5, 5), np.uint8))


def _spiral(h, w):
    """A one-pixel path winding inwards from the top left corner with
    one-pixel walls between its turns: the longest geodesic a mask of its
    size can hold, a flood round for each of its pixels."""
    m = np.zeros((h, w), np.uint8)
    steps = ((0, 1), (1, 0), (0, -1), (-1, 0))
    y = x = d = turns = 0
    m[0, 0] = 1

    def free(yy, xx):
        return not (0 <= yy < h and 0 <= xx < w) or not m[yy, xx]

    while turns < 2:
        dy, dx = steps[d]
        ny, nx = y + dy, x + dx
        if (0 <= ny < h and 0 <= nx < w and not m[ny, nx]
                and free(ny + dy, nx + dx)):
            y, x, turns = ny, nx, 0
            m[y, x] = 1
        else:
            d, turns = (d + 1) % 4, turns + 1
    return m


def _comb(h, w, joined=True):
    """Teeth every third column from the top, joined only by a bar below
    the first tile row; without the bar every tooth is a region."""
    m = np.zeros((h, w), np.uint8)
    m[:h - 4, ::3] = 1
    if joined:
        m[h - 6:h - 3, :] = 1
    return m


def _ring(h, w, island=False):
    m = np.zeros((h, w), np.uint8)
    m[4:h - 4, 5:w - 5] = 1
    m[20:h - 20, 25:w - 25] = 0         # a hole across tile borders
    if island:
        m[h // 2 - 2:h // 2 + 2, w // 2 - 2:w // 2 + 2] = 1
    return m


def _families():
    """name -> mask: every family the kernel has to count right."""
    fam = {f"region_{k}": v for k, v in _region_masks().items()}
    alt = np.zeros(70, np.uint8)
    alt[::2] = 1
    gap = np.ones(70, np.uint8)
    gap[32] = 0
    fam.update({
        "strip_1x1_on": np.ones((1, 1), np.uint8),
        "strip_1x1_off": np.zeros((1, 1), np.uint8),
        "strip_1x70": np.ones((1, 70), np.uint8),
        "strip_70x1": np.ones((70, 1), np.uint8),
        "strip_1x70_cut_at_tile": gap[None, :],
        "strip_70x1_cut_at_tile": gap[:, None].copy(),
        "strip_1x70_dashes": alt[None, :],
        "strip_70x1_dashes": alt[:, None].copy(),
    })
    for h, w in ((33, 65), (31, 97), (32, 32), (64, 96), (97, 33)):
        full = np.ones((h, w), np.uint8)
        cross = np.zeros((h, w), np.uint8)
        cross[h // 2, :] = 1
        cross[:, w // 2] = 1
        border = np.zeros((h, w), np.uint8)   # pixels only on tile borders
        border[::32, :] = 1
        border[:, ::32] = 1
        fam[f"tiles_{h}x{w}_full"] = full
        fam[f"tiles_{h}x{w}_cross"] = cross
        fam[f"tiles_{h}x{w}_borders"] = border
    fam.update({
        "spiral_67x131": _spiral(67, 131),
        "spiral_96x96": _spiral(96, 96),
        "comb_70x100": _comb(70, 100),
        "comb_70x100_open": _comb(70, 100, joined=False),
        "diagonal_40x40": np.eye(40, dtype=np.uint8),
        "antidiagonal_33x65": np.fliplr(np.eye(33, 65, 20, np.uint8)).copy(),
        "checkerboard_35x67": (np.add.outer(np.arange(35), np.arange(67))
                               % 2).astype(np.uint8),
        "staircase_70x70": (np.eye(70, dtype=np.uint8)
                            | np.eye(70, k=1, dtype=np.uint8)),
        "ring_80x120": _ring(80, 120),
        "ring_80x120_island": _ring(80, 120, island=True),
        "full_50x70": np.ones((50, 70), np.uint8),
        "empty_40x40": np.zeros((40, 40), np.uint8),
    })
    return fam


FAMILIES = _families()


def _blob(seed):
    """A random mask up to the size of a LOW panorama (300 x 800; the
    benchmark's are about 300 x 750 and 300 x 1770): warped views side by
    side that may or may not overlap, random ellipses, or thresholded
    smooth noise."""
    rng = np.random.RandomState(seed)
    h, w = rng.randint(1, 301), rng.randint(1, 801)
    yy, xx = np.mgrid[:h, :w]
    kind = seed % 3
    if kind == 0:
        m = np.zeros((h, w), bool)
        n = rng.randint(2, 7)
        x0 = 0.0
        for _ in range(n):
            vw = w / n * rng.uniform(0.8, 1.4)
            tilt = rng.uniform(-0.15, 0.15)
            dy = rng.uniform(-0.1, 0.1) * h
            top = 0.05 * h + dy + tilt * (xx - x0)
            m |= ((xx >= x0) & (xx < x0 + vw) & (yy >= top)
                  & (yy < top + 0.9 * h))
            x0 += vw * rng.uniform(0.6, 1.05)
    elif kind == 1:
        m = np.zeros((h, w), bool)
        for _ in range(rng.randint(1, 5)):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            ry, rx = rng.uniform(1, h / 2 + 1), rng.uniform(1, w / 3 + 1)
            m |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
    else:
        noise = rng.rand(h + 4, w + 4)
        k = rng.randint(1, 4)
        c = np.cumsum(np.cumsum(np.pad(noise, ((1, 0), (1, 0))), 0), 1)
        box = c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]
        m = box[:h, :w] / k ** 2 > rng.uniform(0.45, 0.6)
    return m.astype(np.uint8) * 255


CASES = [*FAMILIES, *(f"blob_{s}" for s in range(N_BLOBS))]


def _case(name):
    if name.startswith("blob_"):
        return _blob(int(name[5:]))
    return FAMILIES[name]


def _regions(mask):
    return int(ndimage.label(mask > 0, FOUR)[1])


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def test_region_masks_are_the_crop_tests():
    from test_torch_crop import _region_masks as crop_masks

    ours, theirs = _region_masks(), crop_masks()
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_families_hold_what_they_claim():
    want = {"region_one": 1, "region_two": 2, "region_ring": 1,
            "region_touching": 2, "region_empty": 0,
            "strip_1x70_cut_at_tile": 2, "strip_70x1_dashes": 35,
            "spiral_67x131": 1, "spiral_96x96": 1, "comb_70x100": 1,
            "comb_70x100_open": 34, "diagonal_40x40": 40,
            "checkerboard_35x67": 1172, "staircase_70x70": 1,
            "ring_80x120": 1, "ring_80x120_island": 2,
            "tiles_33x65_borders": 1}
    for name, n in want.items():
        assert _regions(FAMILIES[name]) == n, name
    # the spiral's path is long: the flood fill needs a round a pixel
    assert FAMILIES["spiral_96x96"].sum() > 4000
    counts = [_regions(_blob(s)) for s in range(N_BLOBS)]
    assert sum(c == 1 for c in counts) > N_BLOBS // 4
    assert sum(c > 1 for c in counts) > N_BLOBS // 4


@pytest.fixture(scope="module")
def cropper_jax():
    from stitching_tpu import cropper as ref

    return ref


@pytest.mark.parametrize("name", CASES)
def test_plain_count_against_single_region(cropper_jax, name):
    mask = _case(name)
    got = count_components_plain(torch.as_tensor(mask))
    assert got.dtype == torch.int32 and got.shape == (1,)
    n = int(got)
    assert n == _regions(mask)
    one = cropper.single_region(mask)
    ref = cropper_jax.single_region(mask)
    assert (one is not None) == (ref is not None) == (n == 1)
    if ref is not None:
        np.testing.assert_array_equal(one, ref)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bool])
def test_wrapper_on_the_cpu_runs_the_plain_version(dtype):
    mask = torch.as_tensor(FAMILIES["ring_80x120_island"] > 0).to(dtype)
    before = count_components.launches
    profiling.reset()
    profiling.enable()
    try:
        got = count_components(mask)
        counters = profiling.get_counters()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert int(got) == 2 and got.device.type == "cpu"
    assert count_components.launches == before
    assert "crop/label_launches" not in counters


@pytest.mark.parametrize("bad", ["3d", "float", "int32", "transposed"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad):
    m = torch.ones(6, 40, dtype=torch.uint8)
    mask = {"3d": m[None], "float": m.float(), "int32": m.int(),
            "transposed": m.t()}[bad]
    with pytest.raises(ValueError):
        count_components(mask)


@pytest.mark.parametrize("kind", ["array", "tensor"])
def test_host_single_region_still_flood_fills(cropper_jax, kind):
    """A host array or CPU tensor takes the dilation loop: the same region
    as the JAX package, its rounds counted, no region count."""
    mask = FAMILIES["spiral_67x131"] * 255
    given = mask if kind == "array" else torch.as_tensor(mask)
    profiling.reset()
    profiling.enable()
    try:
        region = cropper.single_region(given)
        counters = profiling.get_counters()
    finally:
        profiling.enable(False)
        profiling.reset()
    np.testing.assert_array_equal(region, cropper_jax.single_region(mask))
    # a round for each pixel of the path after the first, and one round
    # that adds nothing
    assert counters == {"crop/flood_rounds": int((mask > 0).sum())}


def test_cropper_plans_from_a_cpu_tensor_on_the_host():
    """`estimate_largest_interior_rectangle` with a CPU tensor floods on
    the host; a mask of two regions still raises the reference's
    error."""
    c = cropper.Cropper(True, device="cpu")
    profiling.reset()
    profiling.enable()
    try:
        lir = c.estimate_largest_interior_rectangle(
            torch.as_tensor(FAMILIES["region_one"]))
        with pytest.raises(cropper.StitchingError, match="Invalid Contour"):
            c.estimate_largest_interior_rectangle(
                torch.as_tensor(FAMILIES["region_two"]))
        counters = profiling.get_counters()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert tuple(lir) == (4, 3, 21, 12)
    assert set(counters) == {"crop/flood_rounds"}


def test_benchmark_reader_counts_launches_per_fenced_stitch(monkeypatch):
    sys.path.insert(0, ROOT)
    from benchmark import program_record
    from benchmark.manifest import Manifest

    reader = Manifest().metric_reader("crop_label_launches")
    kept = {"spans": [], "counters": {}, "allocs": []}
    monkeypatch.setattr(program_record, "_KEPT", kept)
    ctx = types.SimpleNamespace(fenced=3, traced=3)
    kept["counters"] = {"crop/label_launches": 9}
    assert reader.read(ctx) == 3
    kept["counters"] = {"crop/flood_rounds": 2000}    # the host path
    assert reader.read(ctx) is None
    ctx.fenced = 0
    kept["counters"] = {"crop/label_launches": 9}
    assert reader.read(ctx) is None
    entry = [m for m in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
             ["per_layer"] if m["name"] == "crop_label_launches"]
    assert entry and entry[0]["layer"] == "crop"


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

def _card_count(mask, dev):
    got = count_components(torch.as_tensor(mask).to(dev))
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (1,)
    return int(got)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_equals_plain_and_single_region(cuda_device, name):
    mask = _case(name)
    before = count_components.launches
    n = _card_count(mask, cuda_device)
    assert count_components.launches == before + (LAUNCHES if mask.size
                                                  else 0)
    assert n == int(count_components_plain(torch.as_tensor(mask)))
    assert n == _regions(mask)
    assert (cropper.single_region(mask) is not None) == (n == 1)
    on_card = cropper.single_region(torch.as_tensor(mask).to(cuda_device))
    assert (on_card is not None) == (n == 1)
    if on_card is not None:
        assert on_card.is_cuda and on_card.dtype == torch.bool
        assert torch.equal(on_card.cpu(), torch.as_tensor(mask > 0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.bool])
def test_kernel_takes_both_mask_types_and_repeats(cuda_device, dtype):
    """The same count from a uint8 and a bool mask, from call to call (the
    unions' order changes between runs; the count does not)."""
    mask = torch.as_tensor(_blob(2) > 0).to(dtype).to(cuda_device)
    counts = {int(count_components(mask)) for _ in range(20)}
    assert counts == {_regions(_blob(2))}


def _low_masks(cell, seeds, dev):
    """The LOW panorama masks that `Cropper.prepare_from_mask` receives in
    stitches of a benchmark cell's views, with the corners and sizes."""
    sys.path.insert(0, ROOT)
    import stitching_tpu_torch as pkg
    from benchmark import generators
    from benchmark.manifest import Manifest

    man = Manifest()
    spec = man.workload(cell)
    cfg = man.config(spec["config"])
    traffic = man.traffic(spec["traffic"])
    st = getattr(pkg, cfg["stitcher"])(device=dev, **cfg["kwargs"])
    got = []
    plan = st.cropper.prepare_from_mask

    def keep(mask, corners, sizes):
        got.append((mask.clone(), corners, sizes, st.cropper))
        return plan(mask, corners, sizes)

    st.cropper.prepare_from_mask = keep
    for seed in seeds:
        views, _ = generators.make(traffic, seed, dev)
        st.stitch(views)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["scan-sift.row8-2mp",
                                  "pano-default.rot6-12mp"])
def test_kernel_on_the_generators_low_masks(cuda_device, cell):
    masks = _low_masks(cell, range(1, 6), cuda_device)
    assert len(masks) == 5
    for mask, *_ in masks:
        assert mask.is_cuda and mask.dim() == 2
        n = _card_count(mask, cuda_device)
        host = mask.cpu().numpy()
        assert n == int(count_components_plain(mask.cpu())) == 1
        assert n == _regions(host)
        assert cropper.single_region(host) is not None


@pytest.mark.cuda
def test_a_fault_in_the_run_surfaces_at_synchronize(cuda_device):
    """Parents at an address the card cannot write: the launch itself
    reports success, and the fault comes out at the next synchronize. In
    a process of its own, since a fault spoils the process's context."""
    code = "\n".join([
        "import torch",
        "from stitching_tpu_torch.ops import kernels",
        "mask = torch.ones(64, 64, dtype=torch.uint8, device='cuda')",
        "count = torch.empty(1, dtype=torch.int32, device='cuda')",
        "fn = kernels.load('count_components')",
        "status = fn(mask.data_ptr(), 256, count.data_ptr(), 64, 64,",
        "            kernels.stream_ptr(mask.device))",
        "print('launch', status, flush=True)",
        "try:",
        "    torch.cuda.synchronize()",
        "except Exception as e:",
        "    print('synchronize raised', type(e).__name__, e, flush=True)",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert "launch 0" in out.stdout, out.stdout + out.stderr
    assert "synchronize raised" in out.stdout, out.stdout + out.stderr


@pytest.mark.cuda
def test_scan_stitch_counts_regions_on_the_card(cuda_device):
    """One scan stitch plans its crop with the region count (its launches
    counted, no flood round), and the same crop as the host flood fill
    plans from the same mask moved to the host."""
    profiling.reset()
    profiling.enable()
    try:
        [(mask, corners, sizes, planned)] = _low_masks(
            "scan-sift.row8-2mp", [11], cuda_device)
        counters = profiling.get_counters()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert counters.get("crop/label_launches") == LAUNCHES
    assert "crop/flood_rounds" not in counters
    host = cropper.Cropper(True, device="cpu")
    host.prepare_from_mask(mask.cpu(), corners, sizes)
    assert host.lir == planned.lir
    assert host.overlapping_rectangles == planned.overlapping_rectangles
    assert host.intersection_rectangles == planned.intersection_rectangles
