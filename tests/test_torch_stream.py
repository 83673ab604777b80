"""The streamed and strip composite against the JAX package.

`StreamComposite` (built from the stack's blend plan, with and without
the column-frontier copy), the X and Y strips and the streamed
monolithic blend of the port's `compose.blend_stack`, each against the
JAX package's on the geometries of
`tests/test_compose.py`, the strips and the monolithic stream with the
JAX package's budget forced down through `STITCHING_TPU_BLEND_BUDGET` and
the port's through `budget=`. The streamed composite runs the batched
blend's own per-image feeds in the same order, so it equals the port's
`blend_stack` exactly; against the JAX package, and for the strips and
the row-ordered monolithic stream against the port's own monolithic
blend, panoramas are held within 1 LSB.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stitching_tpu import compose as jax_compose
from stitching_tpu_torch import compose

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)


def _geometry(name):
    """(data (B, th, tw, 3), masks, seams, corners, sizes) float32 numpy,
    as `tests/test_compose.py` builds them."""
    if name == "x":         # a wide row: X strips
        rng = np.random.RandomState(5)
        th, tw = 192, 256
        data = np.stack([rng.randint(0, 255, (th, tw, 3)).astype(np.float32)
                         for _ in range(8)])
        corners = [(i * 180, (i % 2) * 16) for i in range(8)]
        sizes = [(tw, th)] * 8
    elif name == "y":       # 8 rows of 2: Y strips
        rng = np.random.RandomState(6)
        th, tw = 160, 256
        data = np.stack([rng.randint(0, 255, (th, tw, 3)).astype(np.float32)
                         for _ in range(16)])
        corners = [(c * 200, r * 140) for r in range(8) for c in range(2)]
        sizes = [(tw, th)] * 16
    elif name == "mono":    # windows over a third of both axes
        rng = np.random.RandomState(8)
        th, tw = 256, 192
        data = np.stack([rng.randint(0, 255, (th, tw, 3)).astype(np.float32)
                         for _ in range(6)])
        corners = [(c * 160, r * 220) for r in range(3) for c in range(2)]
        sizes = [(tw, th)] * 6
    elif name == "gap":     # two pairs far apart: X strips no tile reaches
        rng = np.random.RandomState(9)
        th, tw = 192, 256
        data = np.stack([rng.randint(0, 255, (th, tw, 3)).astype(np.float32)
                         for _ in range(4)])
        corners = [(0, 0), (180, 12), (2400, 4), (2580, 10)]
        sizes = [(tw, th)] * 4
    elif name == "stream":  # ragged sizes, seams cut at two thirds
        rng = np.random.default_rng(7)
        th, tw = 128, 256
        data = rng.uniform(0, 255, (3, th, tw, 3)).astype(np.float32)
        sizes = [(200, 100), (256, 128), (180, 90)]
        corners = [(0, 0), (150, 20), (310, 5)]
        masks = np.zeros((3, th, tw), np.float32)
        seams = np.zeros((3, th, tw), np.float32)
        for i, (w, h) in enumerate(sizes):
            masks[i, :h, :w] = 255
            seams[i, :h, :(w * 2) // 3] = 255
        return data, masks, seams, np.asarray(corners), np.asarray(sizes)
    else:                   # "frontier": six tiles in a row
        rng = np.random.default_rng(11)
        th, tw = 128, 192
        data = rng.uniform(0, 255, (6, th, tw, 3)).astype(np.float32)
        corners = [(i * 150, (i % 2) * 10) for i in range(6)]
        sizes = [(tw, th)] * 6
    masks = np.full(data.shape[:3], 255.0, np.float32)
    return (data, masks, masks, np.asarray(corners, np.int64),
            np.asarray(sizes, np.int64))


def _stacks(name):
    data, masks, seams, corners, sizes = _geometry(name)
    port = compose.TileStack(torch.as_tensor(data), torch.as_tensor(masks),
                             corners, sizes)
    ref = jax_compose.TileStack(jnp.asarray(data), jnp.asarray(masks),
                                corners, sizes)
    return port, torch.as_tensor(seams), ref, jnp.asarray(seams)


def _blend_plan(port, kind, th, tw):
    """The blend plan a `StreamComposite` of the stack's tiles is built
    from, at strength 5."""
    return compose._plan_blend(port.corners, port.sizes, len(port.sizes),
                               kind, 5, th, tw)


def _host(x):
    return x if isinstance(x, np.ndarray) else np.asarray(
        x.numpy() if isinstance(x, torch.Tensor) else x)


def _within_1_lsb(got, want, what):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape, what
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, (what, int(diff.max()))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", ["multiband", "feather", "no"])
def test_plan_strips_equals_jax(seed, kind):
    rng = np.random.RandomState(seed)
    n = rng.randint(1, 30)
    m = 1 << rng.randint(0, 6) if kind == "multiband" else 1
    nb = int(np.log2(m))
    gap = 3 * m if kind == "multiband" else 0
    ww = int(rng.randint(1, 8)) * max(128, m)
    offs = (rng.randint(0, 40, n) * m).astype(np.int32)
    dw = int(offs.max()) + ww - rng.randint(0, ww // 2)
    szs = rng.randint(1, 300, (n, 2)).astype(np.int32)
    strip_w = max(256, m) * int(rng.randint(1, 5))
    got = compose._plan_strips(offs, szs, ww, m, gap, nb, dw, strip_w, kind)
    want = jax_compose._plan_strips(offs, szs, ww, m, gap, nb, dw, strip_w,
                                    kind)
    assert (got is None) == (want is None)
    if want is not None:
        members, max_k, pw_local = got
        assert (max_k, pw_local) == want[1:]
        assert [(int(cs), int(ce), int(ls), int(le), [int(i) for i in k])
                for cs, ce, ls, le, k in members] == \
            [(int(cs), int(ce), int(ls), int(le), [int(i) for i in k])
             for cs, ce, ls, le, k in want[0]]


@pytest.mark.parametrize("frontier,mask", [
    pytest.param(False, True, id="False"),
    pytest.param(True, True, id="True"),
    # the engine's call: host bands (row bands without the frontier) and
    # no weight mask
    pytest.param(False, False, id="False-nomask"),
    pytest.param(True, False, id="True-nomask")])
@pytest.mark.parametrize("name", ["stream", "frontier"])
@pytest.mark.parametrize("kind", ["multiband", "feather", "no"])
def test_stream_composite_equals_blend_stack_and_jax(kind, name, frontier,
                                                     mask):
    port, seams, ref, ref_seams = _stacks(name)
    th, tw = int(port.data.shape[1]), int(port.data.shape[2])
    pano_b, mask_b = compose.blend_stack(port, seams, kind, 5)
    stream = compose.StreamComposite(_blend_plan(port, kind, th, tw),
                                     frontier_fetch=frontier, device="cpu")
    for i in range(len(port.sizes)):
        stream.feed(i, port.data[i], seams[i])
    if mask:
        pano_s, mask_s = stream.finish()
        assert isinstance(pano_s, np.ndarray) == frontier
        np.testing.assert_array_equal(_host(mask_s), mask_b.numpy())
    else:
        pano_s, mask_s = stream.finish(stream_fetch=True, mask=False)
        assert isinstance(pano_s, np.ndarray) and mask_s is None
    np.testing.assert_array_equal(_host(pano_s), pano_b.numpy())

    ref_stream = jax_compose.StreamComposite(port.corners, port.sizes, kind,
                                             5, th, tw,
                                             frontier_fetch=frontier)
    for i in range(len(port.sizes)):
        ref_stream.feed(i, ref.data[i], ref_seams[i])
    pano_r, mask_r = ref_stream.finish(stream_fetch=frontier)
    _within_1_lsb(pano_s, pano_r, kind)
    if mask:
        np.testing.assert_array_equal(_host(mask_s), _host(mask_r))


def test_stream_composite_row_bands_equal_one_collapse():
    """`finish(stream_fetch=True)` collapses in row bands: the same
    panorama as one collapse."""
    port, seams, _, _ = _stacks("mono")
    th, tw = int(port.data.shape[1]), int(port.data.shape[2])
    out = []
    for banded in (False, True):
        stream = compose.StreamComposite(
            _blend_plan(port, "multiband", th, tw), device="cpu")
        for i in range(len(port.sizes)):
            stream.feed(i, port.data[i], seams[i])
        out.append(stream.finish(stream_fetch=banded))
    np.testing.assert_array_equal(out[0][0].numpy(), out[1][0])
    np.testing.assert_array_equal(out[0][1].numpy(), out[1][1])


@pytest.mark.parametrize("name,kind,stream_fetch", [
    ("x", "multiband", False), ("x", "feather", False), ("x", "no", False),
    ("x", "multiband", True), ("y", "multiband", False),
    ("y", "multiband", True), ("y", "feather", True),
    ("mono", "multiband", True), ("mono", "feather", True),
    ("gap", "multiband", True), ("gap", "no", True),
])
def test_over_budget_blend_equals_jax_and_monolithic(monkeypatch, name, kind,
                                                      stream_fetch):
    """Strips (X for the wide row, Y for the tall grid) and the streamed
    monolithic blend (windows over a third of both axes) against the JAX
    package's forced-budget blend and the port's own monolithic blend."""
    port, seams, ref, ref_seams = _stacks(name)
    mono, mono_mask = compose.blend_stack(port, seams, kind, 5)
    got, got_mask = compose.blend_stack(port, seams, kind, 5,
                                        stream_fetch=stream_fetch, budget=1)
    assert isinstance(got, np.ndarray) == stream_fetch
    monkeypatch.setenv("STITCHING_TPU_BLEND_BUDGET", "1")
    want, want_mask = jax_compose.blend_stack(ref, ref_seams, kind, 5,
                                              stream_fetch=stream_fetch)
    _within_1_lsb(got, want, f"{name} {kind} against the JAX package")
    _within_1_lsb(got, mono, f"{name} {kind} against the monolithic blend")
    np.testing.assert_array_equal(_host(got_mask), _host(want_mask))
    np.testing.assert_array_equal(_host(got_mask), mono_mask.numpy())


def test_over_budget_dispatch(monkeypatch):
    """Which route `blend_stack` takes over the budget: the strips
    planner for the row and the grid (on their narrow axis), the streamed
    monolithic blend for the big windows, the batched blend for the big
    windows without `stream_fetch`."""
    seen = []
    real_strips = compose._blend_strips
    real_mono = compose._blend_monolithic_stream
    monkeypatch.setattr(compose, "_blend_strips", lambda *a: seen.append(
        ("strips", a[4])) or real_strips(*a))
    monkeypatch.setattr(compose, "_blend_monolithic_stream",
                        lambda *a: seen.append(("mono", None))
                        or real_mono(*a))
    for name, stream_fetch in (("x", False), ("y", True), ("mono", True),
                               ("mono", False)):
        port, seams, _, _ = _stacks(name)
        compose.blend_stack(port, seams, "multiband", 5,
                            stream_fetch=stream_fetch, budget=1)
    assert seen == [("strips", 0), ("strips", 1), ("mono", None)]


def test_dropped_fetch_waits_on_its_last_copy():
    """A `_HostFetch` dropped between `submit` and `assemble` (a stitch
    that failed) waits on its last copy, so no copy still writes into a
    host block that is handed out again; after `assemble` it waits on
    nothing."""
    waited = []
    fetch = compose._HostFetch(torch.device("cpu"), 4, 6, 3)
    fetch.done = types.SimpleNamespace(synchronize=lambda: waited.append(1))
    del fetch
    assert waited == [1]
    fetch = compose._HostFetch(torch.device("cpu"), 4, 6, 3)
    fetch.submit(1, 0, torch.ones((4, 6, 3), dtype=torch.uint8))
    pano, wmask = fetch.assemble()
    assert pano.sum() == 72 and wmask is None and fetch.done is None
    del fetch
    assert waited == [1]


@pytest.mark.parametrize("nb,axis", [(2, 0), (3, 1), (8, 0), (8, 1)])
@pytest.mark.parametrize("kind", ["multiband", "feather", "no"])
def test_collapse_band_equals_full_collapse(nb, axis, kind):
    """Every band of `_collapse_band` equals the same span of the full
    collapse, at the tests' small band counts and at the giant canvas's 8
    (a 2^(nb+2) halo and reflect borders)."""
    rng = np.random.RandomState(nb)
    m = 1 << nb if kind == "multiband" else 1
    ph, pw = (1536, 768) if nb == 8 else (160, 224)
    dh, dw = ph - 3 * m - 5, pw - 2 * m - 3
    C = 3
    if kind == "multiband":
        acc = [torch.as_tensor(rng.randn(ph >> lv, pw >> lv, C)
                               .astype(np.float32) * 50)
               for lv in range(nb + 1)]
        wacc = [torch.as_tensor(rng.rand(ph >> lv, pw >> lv, 1)
                                .astype(np.float32))
                for lv in range(nb + 1)]
        state = (acc, wacc)
        full, wfull = compose._mb_collapse_kernel(acc, wacc, nb)
    else:
        state = (torch.as_tensor(rng.rand(ph, pw, C).astype(np.float32)
                                 * 255),
                 torch.as_tensor((rng.rand(ph, pw) > 0.3).astype(np.float32)))
        full, wfull = compose._finish_state(state, kind, nb)
    halo = max(2 ** (nb + 2), m) if kind == "multiband" else 0
    pano = compose._to_u8(full[:dh, :dw])
    wmap = compose._wmap_to_u8(wfull[:dh, :dw])
    extent, other = ((dh, dw) if axis == 0 else (dw, dh))
    pa = ph if axis == 0 else pw
    cuts = sorted({0, extent} | set(rng.randint(1, extent, 3).tolist()))
    for r0, r1 in zip(cuts, cuts[1:]):
        seg, wseg = compose._collapse_band(state, kind, nb, m, halo, pa,
                                           other, r0, r1, axis=axis)
        want = pano[r0:r1] if axis == 0 else pano[:, r0:r1]
        wwant = wmap[r0:r1] if axis == 0 else wmap[:, r0:r1]
        assert torch.equal(seg, want), (r0, r1)
        assert torch.equal(wseg, wwant), (r0, r1)
        # a caller that drops the mask gets the same band and no mask
        seg, wseg = compose._collapse_band(state, kind, nb, m, halo, pa,
                                           other, r0, r1, axis=axis,
                                           mask=False)
        assert torch.equal(seg, want) and wseg is None, (r0, r1)
