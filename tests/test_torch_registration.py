"""`registration.save_registration` / `load_registration`: a `.npz` file
written by either package loads in the other, with every value equal
(cameras, kept indices, warper scale; extra arrays are stored beside
them)."""

import numpy as np
import pytest

from stitching_tpu import registration as jax_registration
from stitching_tpu import types as jax_types
from stitching_tpu_torch import registration, types

PACKAGES = {"jax": (jax_registration, jax_types),
            "port": (registration, types)}


def cameras(module, n=4, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        out.append(module.CameraParams(
            focal=float(rng.uniform(300, 900)),
            aspect=float(rng.uniform(0.9, 1.1)),
            ppx=float(rng.uniform(100, 400)), ppy=float(rng.uniform(100, 300)),
            R=q.astype(np.float32)))
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
@pytest.mark.parametrize("with_meta", [True, False])
def test_files_interchange(tmp_path, writer, reader, with_meta):
    w_reg, w_types = PACKAGES[writer]
    r_reg = PACKAGES[reader][0]
    cams = cameras(w_types)
    path = str(tmp_path / "reg.npz")
    meta = dict(indices=[0, 2, 3, 5], scale=612.25,
                extra={"low_corners": np.arange(8).reshape(4, 2)}) \
        if with_meta else {}
    w_reg.save_registration(path, cams, **meta)
    got = r_reg.load_registration(path)
    assert len(got["cameras"]) == len(cams)
    for a, b in zip(got["cameras"], cams):
        assert (a.focal, a.aspect, a.ppx, a.ppy) == (b.focal, b.aspect,
                                                     b.ppx, b.ppy)
        assert a.R.dtype == np.float32 and np.array_equal(a.R, b.R)
    if with_meta:
        assert np.array_equal(got["indices"], meta["indices"])
        assert got["scale"] == meta["scale"]
        assert np.array_equal(np.load(path)["extra_low_corners"],
                              meta["extra"]["low_corners"])
    else:
        assert "indices" not in got and "scale" not in got


def test_port_file_equals_jax_file(tmp_path):
    """Both packages write the same arrays under the same keys."""
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    jax_registration.save_registration(a, cameras(jax_types), [1, 2], 3.5)
    registration.save_registration(b, cameras(types), [1, 2], 3.5)
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k])
