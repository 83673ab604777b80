"""The bundle solve over two gloo ranks (`solve_bundle(mesh=)`).

The problems are the port's packed registrations of `rotation_set(n=4)`
and `rotation_set(n=5)`, cut to an odd number of confident edges (3 and
5, unpadded: the solve pads the edge axis to the ranks with zero-weight
edges, so the second rank holds a padded edge). Each rank sums its
block's `J^T J`, `J^T r` and costs with the other's, so both ranks take
the same steps. Tolerances:

- both ranks return the same parameters, bit for bit;
- against the port's unsharded solve (the same sums in another order):
  focals within 1e-4 relative, rotation vectors within 1e-4, costs
  within 1e-4 relative;
- against the JAX package's `solve_bundle`: focals within 1e-3 relative
  and rotation vectors within 1e-3, as `test_torch_bundle.py` holds the
  unsharded solve;
- `CameraAdjuster` with a mesh buckets the edges to lcm(4, D) and adjusts
  to the unsharded adjuster's cameras within 1e-4.
"""

import numpy as np
import pytest
import torch

from fixtures import rotation_set
from stitching_tpu_torch import SLICE, Stitcher, engine
from stitching_tpu_torch.camera_adjuster import CameraAdjuster
from stitching_tpu_torch.ops import bundle, rotation
from test_torch_mesh import run_ranks

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)

CASES = [(n, variant) for n in (4, 5) for variant in ("ray", "reproj")]
# the edges kept of each registration: (0,1), (1,2), (2,3) of four views;
# (0,1), (0,2), (1,2), (2,3), (2,4) of five
KEEP = {4: [0, 1, 3], 5: [0, 1, 2, 3, 4]}
ACTIVE = (0, 4, 5, 6)


def _problem(reg, n):
    problem = CameraAdjuster("ray", device="cpu")._pack_problem(
        reg.features, reg.matches)
    keep = KEEP[n]
    assert problem["w"][keep].sum(1).min() > 0
    problem = {k: v[keep] for k, v in problem.items()}
    params0 = np.zeros((n, 7), np.float32)
    for i, c in enumerate(reg.cameras):
        rvec = rotation.matrix_to_rodrigues(np.asarray(c.R, np.float32))
        params0[i] = [c.focal, c.ppx, c.ppy, c.aspect, *rvec]
    return problem, params0


@pytest.fixture(scope="module")
def inputs():
    out = {}
    for n in (4, 5):
        imgs, _, _ = rotation_set(n=n)
        st = Stitcher(device="cpu", **SLICE)
        reg = engine.register(st, imgs)
        out[n] = (_problem(reg, n), reg.features, reg.matches, reg.cameras)
    return out


def _mask():
    mask = np.zeros(7, bool)
    mask[list(ACTIVE)] = True
    return mask


def bundle_rank(mesh, inputs):
    out = {}
    for n, variant in CASES:
        (problem, params0), *_ = inputs[n]
        out[n, variant] = bundle.solve_bundle(problem, variant, _mask(),
                                              params0, mesh=mesh)
    _, feats, matches, cams = inputs[5]
    adj = CameraAdjuster("ray", device="cpu")
    adj.mesh = mesh
    out["edges"] = adj._pack_problem(feats, matches)["w"].shape[0]
    out["adjusted"] = [(c.focal, c.R) for c in adj.adjust(
        feats, matches, [c.copy() for c in cams])]
    return out


@pytest.fixture(scope="module")
def sharded(inputs, tmp_path_factory):
    outs = run_ranks(bundle_rank, inputs, tmp_path_factory.mktemp("ba"))
    for key in outs[0]:
        a, b = outs[0][key], outs[1][key]
        if key == "adjusted":
            for (fa, ra), (fb, rb) in zip(a, b):
                assert fa == fb
                np.testing.assert_array_equal(ra, rb)
        elif key == "edges":
            assert a == b
        else:
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]
    return outs[0]


def _close(got, want, tol):
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=tol)
    np.testing.assert_allclose(got[:, 4:], want[:, 4:], atol=tol)


@pytest.mark.parametrize("n,variant", CASES)
def test_solve_bundle_mesh_equals_unsharded(inputs, sharded, n, variant):
    (problem, params0), *_ = inputs[n]
    assert len(problem["w"]) % 2 == 1
    want, cost_want = bundle.solve_bundle(problem, variant, _mask(),
                                          params0, device="cpu")
    got, cost = sharded[n, variant]
    _close(got, want, 1e-4)
    assert abs(cost - cost_want) <= 1e-4 * cost_want
    # frozen intrinsics stay put; the solve moved the cameras
    np.testing.assert_array_equal(got[:, 1:4], params0[:, 1:4])
    assert np.abs(got[:, 4:] - params0[:, 4:]).max() > 1e-4


@pytest.mark.parametrize("n,variant", CASES)
def test_solve_bundle_mesh_equals_jax(inputs, sharded, n, variant):
    from stitching_tpu.ops import bundle as bundle_jax

    (problem, params0), *_ = inputs[n]
    want, _ = bundle_jax.solve_bundle(problem, variant, _mask(), params0)
    _close(sharded[n, variant][0], want, 1e-3)


def test_camera_adjuster_with_a_mesh(inputs, sharded):
    _, feats, matches, cams = inputs[5]
    assert sharded["edges"] % 4 == 0
    want = CameraAdjuster("ray", device="cpu").adjust(
        feats, matches, [c.copy() for c in cams])
    for (focal, R), c in zip(sharded["adjusted"], want):
        assert abs(focal - c.focal) <= 1e-4 * c.focal
        np.testing.assert_allclose(R, c.R, atol=1e-4)
