"""The port's mesh (`stitching_tpu_torch.parallel.mesh`) on two gloo ranks.

Each multi-rank check runs `run_ranks`: two processes on the CPU
(`sys.executable -c`, tests/ on the path, a `dist.FileStore` under the
test's tmp_path, one intra-op thread a rank, a timeout of its own), each
calling a module-level function of a test file with its `Mesh`; the
ranks' results come back through pickles. Tolerances:

- `pad_batch` and `_balance_strips` equal the JAX package's on random
  cases;
- `shard_leading` -> `all_gather_leading` round trips are exact (float,
  int, bool, uint8; padded rows are zeros), and so are `replicate`, the
  sums, maxima and point-to-point exchanges;
- `blend_stack(mesh)` on 3 tiles over 2 ranks (one padded slot): the
  paste equals the JAX package's `blend_stack` exactly (the seams are
  disjoint, so the maximum merge is exact); multiband and feather are
  within 1 LSB of it (the ranks' sums are added in another order); the
  same against the port's own unsharded `blend_stack`;
- the strips over 2 ranks with a budget that forces them (X strips on a
  row of 7 tiles, Y strips on 15 tiles in 8 rows, each with a padded
  slot): within 1 LSB of the JAX package's monolithic blend, as
  `tests/test_parallel.py::test_strip_blend_mesh_matches_monolithic`
  holds the JAX mesh, and equal to the port's unsharded strips;
- every rank returns the same panorama.
"""

import importlib
import os
import pickle
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from stitching_tpu_torch import compose, pipeline
from stitching_tpu_torch.errors import StitchingError
from stitching_tpu_torch.parallel import mesh as pmesh

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


# ---------------------------------------------------------------------------
# Ranks in processes of their own
# ---------------------------------------------------------------------------

def _rank_main(module, name, rank, world, tmp):
    """One rank: join the gloo group through the FileStore, call
    `module.name(mesh, inputs)`, pickle its result."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), world), rank=rank, world_size=world)
    try:
        with open(os.path.join(tmp, "in.pkl"), "rb") as f:
            inputs = pickle.load(f)
        fn = getattr(importlib.import_module(module), name)
        out = fn(pmesh.make_mesh(device="cpu"), inputs)
        with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, inputs, tmp_path, world=2, timeout=120):
    """`fn(mesh, inputs)` on `world` gloo ranks, each a process of its
    own; returns the ranks' results in rank order. Fails (and kills every
    rank) when a rank fails or the ranks outlast `timeout` seconds."""
    tmp = str(tmp_path)
    with open(os.path.join(tmp, "in.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [TESTS, REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import test_torch_mesh as t; t._rank_main({fn.__module__!r}, "
         f"{fn.__name__!r}, {r}, {world}, {tmp!r})"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    deadline = time.time() + timeout
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=max(deadline - time.time(), 1))
            errs.append(err)
    except subprocess.TimeoutExpired:
        pytest.fail(f"{fn.__name__}: the ranks outlasted {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    outs = []
    for r in range(world):
        with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


# ---------------------------------------------------------------------------
# Host plans against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_pad_batch_equals_jax(seed):
    from stitching_tpu import pipeline as jax_pipeline

    rng = np.random.default_rng(seed)
    for _ in range(50):
        n, d = int(rng.integers(1, 40)), int(rng.integers(1, 9))
        jax_mesh = types.SimpleNamespace(devices=np.empty(d))
        port_mesh = types.SimpleNamespace(size=d)
        assert (pipeline.pad_batch(n, port_mesh)
                == jax_pipeline.pad_batch(n, jax_mesh))
    assert pipeline.pad_batch(5, None) == jax_pipeline.pad_batch(5, None)


@pytest.mark.parametrize("seed", range(4))
def test_balance_strips_equals_jax(seed):
    from stitching_tpu import compose as jax_compose

    rng = np.random.default_rng(seed)
    for _ in range(40):
        n_s, d = int(rng.integers(1, 30)), int(rng.integers(1, 9))
        members = [(0, 0, 0, 0, list(range(int(rng.integers(0, 12)))))
                   for _ in range(n_s)]
        assert (compose._balance_strips(members, d)
                == jax_compose._balance_strips(members, d))


def test_nccl_mesh_refuses_a_host_tensor():
    """No quiet switch: a CPU tensor in an NCCL group raises before any
    collective runs."""
    m = pmesh.Mesh(None, 1, 0, torch.device("cpu"), "nccl")
    for call in (pmesh.all_gather_leading, pmesh.all_reduce_sum,
                 pmesh.all_reduce_max):
        with pytest.raises(StitchingError, match="NCCL"):
            call(torch.zeros(2), m)


def test_init_distributed_without_a_launcher(monkeypatch):
    """One process without the launcher's variables: nothing to join."""
    import torch.distributed as dist

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert pmesh.init_distributed(device="cpu") is False
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# Collectives on two ranks
# ---------------------------------------------------------------------------

def _arrays():
    rng = np.random.default_rng(3)
    return dict(f=rng.normal(size=(5, 3)).astype(np.float32),
                i=rng.integers(-9, 9, 7).astype(np.int64),
                b=rng.random((3, 2)) > 0.5,
                u=rng.integers(0, 255, (4, 2, 2)).astype(np.uint8))


def collectives_rank(mesh, _):
    out = {}
    for k, a in _arrays().items():
        out[k] = pmesh.all_gather_leading(pmesh.shard_leading(a, mesh),
                                          mesh).numpy()
    s = pmesh.all_reduce_sum(torch.full((3,), float(mesh.rank + 1)), mesh)
    m = pmesh.all_reduce_max(torch.tensor([mesh.rank, -mesh.rank]), mesh)
    other = 1 - mesh.rank
    got = pmesh.exchange(
        {other: torch.arange(4.0) * (mesh.rank + 1)},
        {other: ((4,), torch.float32)}, mesh)
    rep = pmesh.replicate(_arrays()["f"], mesh)
    sub = pmesh.make_mesh(n_devices=1, device="cpu")
    return dict(gathered=out, replicated=(rep.device.type, rep.numpy()),
                sum=s.tolist(), max=m.tolist(),
                received=got[other].tolist(),
                sub=None if sub is None else (sub.size, sub.rank),
                size=mesh.size, rank=mesh.rank, backend=mesh.backend)


def test_collectives_round_trip(tmp_path):
    outs = run_ranks(collectives_rank, None, tmp_path)
    for r, out in enumerate(outs):
        assert (out["size"], out["rank"], out["backend"]) == (2, r, "gloo")
        for k, a in _arrays().items():
            got = out["gathered"][k]
            n = len(a)
            assert got.shape == (-(-n // 2) * 2, *a.shape[1:])
            assert got.dtype == a.dtype
            np.testing.assert_array_equal(got[:n], a)
            assert not got[n:].any()
        assert out["replicated"][0] == "cpu"
        np.testing.assert_array_equal(out["replicated"][1], _arrays()["f"])
        assert out["sum"] == [3.0, 3.0, 3.0]
        assert out["max"] == [1, 0]
        assert out["received"] == [float(v * (2 - r)) for v in range(4)]
    assert outs[0]["sub"] == (1, 0) and outs[1]["sub"] is None


# ---------------------------------------------------------------------------
# The blend over two ranks
# ---------------------------------------------------------------------------

def _blend_geometry():
    """3 ragged tiles whose windows overlap, with disjoint seam masks:
    each canvas pixel belongs to the last tile that covers it."""
    rng = np.random.default_rng(7)
    th, tw = 128, 256
    data = rng.uniform(0, 255, (3, th, tw, 3)).astype(np.float32)
    sizes = np.asarray([(200, 100), (256, 128), (180, 90)], np.int64)
    corners = np.asarray([(0, 0), (150, 20), (310, 5)], np.int64)
    masks = np.zeros((3, th, tw), np.float32)
    cover = np.zeros((200, 600), bool)
    seams = np.zeros_like(masks)
    for i in (2, 1, 0):
        w, h = sizes[i]
        x, y = corners[i]
        masks[i, :h, :w] = 255
        own = ~cover[y:y + h, x:x + w]
        seams[i, :h, :w] = own * 255.0
        cover[y:y + h, x:x + w] = True
    return data, masks, seams, corners, sizes


def _strip_geometry(name):
    """A row of 7 tiles (X strips) or 15 tiles in 8 rows (Y strips), each
    one tile short of a multiple of 2: one padded slot."""
    if name == "x":
        rng = np.random.RandomState(5)
        th, tw, n = 192, 256, 7
        corners = [(i * 180, (i % 2) * 16) for i in range(n)]
    else:
        rng = np.random.RandomState(6)
        th, tw, n = 160, 256, 15
        corners = [(c * 200, r * 140) for r in range(8) for c in range(2)][:n]
    data = np.stack([rng.randint(0, 255, (th, tw, 3)).astype(np.float32)
                     for _ in range(n)])
    masks = np.full(data.shape[:3], 255.0, np.float32)
    return (data, masks, np.asarray(corners, np.int64),
            np.asarray([(tw, th)] * n, np.int64))


def _sharded(mesh, data, masks, corners, sizes):
    return compose.TileStack(pmesh.shard_leading(data, mesh),
                             pmesh.shard_leading(masks, mesh), corners,
                             sizes, mesh)


def blend_rank(mesh, _):
    out = {}
    data, masks, seams, corners, sizes = _blend_geometry()
    stack = _sharded(mesh, data, masks, corners, sizes)
    for kind in ("multiband", "feather", "no"):
        pano, wmask = compose.blend_stack(
            stack, pmesh.shard_leading(seams, mesh), kind, 5)
        out[kind] = (pano.numpy(), wmask.numpy())
    for name in ("x", "y"):
        data, masks, corners, sizes = _strip_geometry(name)
        stack = _sharded(mesh, data, masks, corners, sizes)
        pano, wmask = compose.blend_stack(stack, None, "multiband", 5,
                                          budget=1)
        out[name] = (pano.numpy(), wmask.numpy())
    return out


@pytest.fixture(scope="module")
def blended(tmp_path_factory):
    outs = run_ranks(blend_rank, None, tmp_path_factory.mktemp("blend"))
    for k in outs[0]:
        a, b = outs[0][k], outs[1][k]
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y, err_msg=k)
    return outs[0]


def _jax_blend(data, masks, seams, corners, sizes, kind):
    import jax.numpy as jnp
    from stitching_tpu import compose as jax_compose

    stack = jax_compose.TileStack(jnp.asarray(data), jnp.asarray(masks),
                                  corners, sizes)
    pano, wmask = jax_compose.blend_stack(
        stack, None if seams is None else jnp.asarray(seams), kind, 5)
    return np.asarray(pano), np.asarray(wmask)


def _within_1lsb(got, want):
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()


@pytest.mark.parametrize("kind", ["multiband", "feather", "no"])
def test_blend_stack_mesh_equals_jax(blended, kind):
    data, masks, seams, corners, sizes = _blend_geometry()
    want, want_mask = _jax_blend(data, masks, seams, corners, sizes, kind)
    got, got_mask = blended[kind]
    np.testing.assert_array_equal(got_mask, want_mask)
    if kind == "no":
        np.testing.assert_array_equal(got, want)
    else:
        _within_1lsb(got, want)


@pytest.mark.parametrize("kind", ["multiband", "feather", "no"])
def test_blend_stack_mesh_equals_unsharded(blended, kind):
    """The merged accumulators against the port's own blend of the whole
    stack in one process: the paste exactly, the sums within 1 LSB."""
    data, masks, seams, corners, sizes = _blend_geometry()
    stack = compose.TileStack(torch.as_tensor(data), torch.as_tensor(masks),
                              corners, sizes)
    want, want_mask = compose.blend_stack(stack, torch.as_tensor(seams),
                                          kind, 5)
    got, got_mask = blended[kind]
    np.testing.assert_array_equal(got_mask, want_mask.numpy())
    if kind == "no":
        np.testing.assert_array_equal(got, want.numpy())
    else:
        _within_1lsb(got, want.numpy())


@pytest.mark.parametrize("name", ["x", "y"])
def test_strip_blend_mesh(blended, name):
    """The strips spread over two ranks: within 1 LSB of the JAX
    package's monolithic blend, equal to the port's unsharded strips."""
    data, masks, corners, sizes = _strip_geometry(name)
    mono, mono_mask = _jax_blend(data, masks, None, corners, sizes,
                                 "multiband")
    got, got_mask = blended[name]
    _within_1lsb(got, mono)
    np.testing.assert_array_equal(got_mask, mono_mask)
    stack = compose.TileStack(torch.as_tensor(data), torch.as_tensor(masks),
                              corners, sizes)
    routes = []
    strips = compose._blend_strips
    try:
        compose._blend_strips = lambda *a: routes.append(a[4]) or strips(*a)
        single, single_mask = compose.blend_stack(stack, None, "multiband",
                                                  5, budget=1)
    finally:
        compose._blend_strips = strips
    assert routes == [0 if name == "x" else 1]
    np.testing.assert_array_equal(got, single.numpy())
    np.testing.assert_array_equal(got_mask, single_mask.numpy())
