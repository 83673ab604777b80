"""Bundle adjustment and wave correction of the port against the JAX
package: the rotation chart, the residuals and their Jacobians, the LM
solve, the `CameraAdjuster` component and `wave_correct`.

The LM loop's accept/reject decisions can flip on a last bit, so the
solves are held by their result: focals within 1e-3 relative and rotations
within 1e-3, from identical inputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import stitching_tpu
from fixtures import rotation_set
from stitching_tpu import engine as jax_engine
from stitching_tpu.camera_adjuster import CameraAdjuster as JaxAdjuster
from stitching_tpu.ops import bundle as bundle_jax
from stitching_tpu.ops import rotation as rotation_jax
from stitching_tpu.ops.wave import wave_correct as wave_correct_jax
from stitching_tpu_torch import SLICE, convert
from stitching_tpu_torch.camera_adjuster import CameraAdjuster
from stitching_tpu_torch.camera_wave_corrector import WaveCorrector
from stitching_tpu_torch.ops import bundle, rotation
from stitching_tpu_torch.ops.wave import wave_correct

# The suite's workers run side by side on a few cores: keep each one's
# intra-op pool small, or the pools spin against each other.
torch.set_num_threads(2)

ACTIVE = {"ray": (0, 4, 5, 6), "reproj": (0, 1, 2, 3, 4, 5, 6)}
PROBLEM_KEYS = ("src_idx", "dst_idx", "pts_src", "pts_dst", "w")


def _rvecs():
    rng = np.random.RandomState(0)
    r = (rng.randn(40, 3) * 0.7).astype(np.float32)
    r[0] = 0.0
    r[1] = (1e-9, 0.0, 0.0)
    r[2] = (np.pi - 1e-4, 0.0, 0.0)
    return r


def test_rodrigues_to_matrix_matches_jax():
    r = _rvecs()
    ref = np.asarray(rotation_jax.rodrigues_to_matrix(jnp.asarray(r)))
    got_t = rotation.rodrigues_to_matrix(torch.as_tensor(r)).numpy()
    got_n = rotation.rodrigues_to_matrix(r)
    np.testing.assert_allclose(got_t, ref, atol=1e-6)
    np.testing.assert_allclose(got_n, ref, atol=1e-6)
    np.testing.assert_array_equal(got_t[0], np.eye(3))


def test_rotation_round_trip_matches_jax():
    r = _rvecs()
    R = rotation.rodrigues_to_matrix(r).astype(np.float32)
    back = rotation.matrix_to_rodrigues(R)
    ref = rotation_jax.matrix_to_rodrigues(R)
    np.testing.assert_allclose(back, ref, atol=1e-6)
    np.testing.assert_array_equal(back[0], np.zeros(3))
    # away from theta = pi the chart inverts itself
    np.testing.assert_allclose(back[3:], r[3:], atol=1e-4)


def _toy_problem():
    """3 cameras, 4 edges (the last one padding with w = 0); camera 0 is
    the identity, whose rotation chart sits at rvec = 0."""
    rng = np.random.RandomState(0)
    n, E, M = 3, 4, 16
    params0 = np.zeros((n, 7), np.float32)
    params0[:, 0] = 600 + rng.randn(n) * 5
    params0[:, 1], params0[:, 2], params0[:, 3] = 320, 240, 1
    params0[1:, 4:7] = rng.randn(n - 1, 3) * 0.2
    wh = np.array([640, 480])
    prob = dict(
        src_idx=np.array([0, 0, 1, 0], np.int32),
        dst_idx=np.array([1, 2, 2, 0], np.int32),
        pts_src=(rng.rand(E, M, 2) * wh).astype(np.float32),
        pts_dst=(rng.rand(E, M, 2) * wh).astype(np.float32),
        w=(rng.rand(E, M) > 0.3).astype(np.float32))
    prob["w"][3] = 0
    return params0, prob


@pytest.mark.parametrize("variant", ["ray", "reproj"])
def test_residual_and_jacobian_match_jax(variant):
    """Residuals and exact Jacobians to 1e-4 of their scale, also at
    rvec = 0: the identity camera's rotation columns are exactly zero in
    both packages, which is what fixes the gauge."""
    params0, prob = _toy_problem()
    act = ACTIVE[variant]
    x0 = params0[:, list(act)].reshape(-1)

    def f_jax(x):
        return bundle_jax._residual(
            x, jnp.asarray(params0),
            *[jnp.asarray(prob[k]) for k in PROBLEM_KEYS], variant, act)

    def f_port(x):
        return bundle._residual(
            x, torch.as_tensor(params0),
            *[torch.as_tensor(prob[k]).long() if k.endswith("idx")
              else torch.as_tensor(prob[k]) for k in PROBLEM_KEYS],
            variant, act)

    r_ref = np.asarray(f_jax(jnp.asarray(x0)))
    J_ref = np.asarray(jax.jacfwd(f_jax)(jnp.asarray(x0)))
    r = f_port(torch.as_tensor(x0)).numpy()
    J = torch.func.jacfwd(f_port)(torch.as_tensor(x0)).numpy()
    assert np.isfinite(J).all()
    np.testing.assert_allclose(r, r_ref, atol=1e-4 * np.abs(r_ref).max())
    np.testing.assert_allclose(J, J_ref, atol=1e-4 * np.abs(J_ref).max())
    rot0 = [act.index(k) for k in (4, 5, 6)]
    assert np.abs(J_ref[:, rot0]).max() == 0.0
    assert np.abs(J[:, rot0]).max() == 0.0


@pytest.fixture(scope="module")
def estimated():
    """The JAX package's registration of the rotation fixture up to the
    camera estimate: its features, matches and estimated cameras, and the
    same as the port's objects."""
    imgs, _, _ = rotation_set(n=3, size=(640, 480))
    st = stitching_tpu.Stitcher(**SLICE)
    reg = jax_engine.register(st, imgs)
    feats = [convert.features_from_numpy(
        np.asarray(f.xy), np.asarray(f.response), np.asarray(f.size),
        np.asarray(f.angle), np.asarray(f.desc), np.asarray(f.valid),
        f.img_size) for f in reg.features]
    matches = [convert.matches_from_numpy(
        m.src_img_idx, m.dst_img_idx, m.matches, m.matches_valid,
        m.inliers_mask, m.num_inliers, m.H, m.confidence)
        for m in reg.matches]
    cams = reg.cameras
    port_cams = convert.cameras_from_numpy(
        [c.focal for c in cams], [c.aspect for c in cams],
        [c.ppx for c in cams], [c.ppy for c in cams],
        [np.asarray(c.R) for c in cams])
    return reg.features, reg.matches, cams, feats, matches, port_cams


def _assert_cameras_close(got, ref):
    assert len(got) == len(ref)
    for c, r in zip(got, ref):
        assert abs(c.focal - r.focal) <= 1e-3 * r.focal
        assert abs(c.aspect - r.aspect) <= 1e-3
        assert abs(c.ppx - r.ppx) <= 1e-3 * max(abs(r.ppx), 1.0)
        assert abs(c.ppy - r.ppy) <= 1e-3 * max(abs(r.ppy), 1.0)
        assert c.R.dtype == np.float32
        np.testing.assert_allclose(c.R, np.asarray(r.R), atol=1e-3)


@pytest.mark.parametrize("adjuster,mask", [
    ("ray", "xxxxx"), ("ray", "_xxxx"), ("reproj", "x____"),
    ("reproj", "xxx_x")])
def test_camera_adjuster_matches_jax(estimated, adjuster, mask):
    """ray with the default mask and with the focal frozen; reproj with the
    focal alone and with the principal point too. (reproj with the aspect
    free as well is a flat valley on three images: see
    `test_solve_bundle_reproj_all_free_reaches_the_same_cost`.)"""
    jf, jm, jc, feats, matches, cams = estimated
    ref = JaxAdjuster(adjuster, mask).adjust(jf, jm, [c.copy() for c in jc])
    got = CameraAdjuster(adjuster, mask, device="cpu").adjust(
        feats, matches, [c.copy() for c in cams])
    _assert_cameras_close(got, ref)
    # the adjustment moved the cameras, so the agreement is not trivial
    assert max(np.abs(np.asarray(a.R) - np.asarray(b.R)).max()
               for a, b in zip(ref, jc)) > 1e-3


def _packed(estimated, variant):
    _, _, _, feats, matches, cams = estimated
    problem = CameraAdjuster(variant, device="cpu")._pack_problem(
        feats, matches)
    params0 = np.zeros((len(cams), 7), np.float32)
    for i, c in enumerate(cams):
        rvec = rotation.matrix_to_rodrigues(np.asarray(c.R, np.float32))
        params0[i] = [c.focal, c.ppx, c.ppy, c.aspect, *rvec]
    return problem, params0


@pytest.mark.parametrize("variant,active", [
    ("ray", (0, 4, 5, 6)), ("reproj", (0, 4, 5, 6)),
    ("reproj", (0, 1, 2, 4, 5, 6))])
def test_solve_bundle_matches_jax(estimated, variant, active):
    """The packed problem of the fixture through both LM solves."""
    problem, params0 = _packed(estimated, variant)
    assert problem["w"].shape[0] % 4 == 0 and problem["w"].shape[1] == 512
    mask = np.zeros(7, bool)
    mask[list(active)] = True
    ref, cost_ref = bundle_jax.solve_bundle(problem, variant, mask, params0)
    got, cost = bundle.solve_bundle(problem, variant, mask, params0,
                                    device="cpu")
    np.testing.assert_allclose(got[:, :4], ref[:, :4], rtol=1e-3)
    np.testing.assert_allclose(got[:, 4:], ref[:, 4:], atol=1e-3)
    assert abs(cost - cost_ref) <= 1e-2 * cost_ref + 1e-6
    frozen = ~mask
    np.testing.assert_array_equal(got[:, frozen], params0[:, frozen])


def test_solve_bundle_reproj_all_free_reaches_the_same_cost(estimated):
    """With focal, principal point and aspect all free, three images leave
    the reproj cost a flat valley (shown by
    `test_reproj_all_free_is_a_flat_valley_for_the_reference_too`): the two
    solves end at parameters percents apart whose costs agree to 1%, both
    300 times below the start. The first step, before any accept/reject
    decision can differ, agrees to 1e-3."""
    problem, params0 = _packed(estimated, "reproj")
    mask = np.ones(7, bool)
    ref1, _ = bundle_jax.solve_bundle(problem, "reproj", mask, params0,
                                      max_iters=1)
    got1, _ = bundle.solve_bundle(problem, "reproj", mask, params0,
                                  max_iters=1, device="cpu")
    np.testing.assert_allclose(got1, ref1, rtol=1e-3, atol=1e-3)
    _, cost_ref = bundle_jax.solve_bundle(problem, "reproj", mask, params0)
    got, cost = bundle.solve_bundle(problem, "reproj", mask, params0,
                                    device="cpu")
    _, cost0 = bundle.solve_bundle(problem, "reproj", mask, params0,
                                   max_iters=0, device="cpu")
    assert np.isfinite(got).all()
    assert abs(cost - cost_ref) <= 1e-2 * cost_ref
    assert cost < cost0 / 300


def test_reproj_all_free_is_a_flat_valley_for_the_reference_too(estimated):
    """Why the 1e-3 camera bar cannot hold for reproj with every intrinsic
    free on three images, shown on the reference itself:
    - the JAX solve started a few float32 steps away (1e-6 to 1e-4
      relative) ends further from its own unperturbed end than 1e-3, at a
      cost within 1%;
    - the cost along the straight line between the reference's end and the
      port's stays within 1e-3 relative of the ends';
    - at the reference's end the Jacobi-scaled normal matrix has, beyond
      the three exact zeros of the identity camera's rotation (the gauge),
      eigenvalues below 1e-4 of its largest."""
    problem, params0 = _packed(estimated, "reproj")
    mask = np.ones(7, bool)
    act = tuple(range(7))
    ref, cost_ref = bundle_jax.solve_bundle(problem, "reproj", mask, params0)
    got, cost = bundle.solve_bundle(problem, "reproj", mask, params0,
                                    device="cpu")

    rng = np.random.RandomState(1)
    moved = 0.0
    for eps in (1e-6, 1e-5, 1e-4):
        start = (params0 * (1 + eps * rng.randn(*params0.shape))).astype(
            np.float32)
        end, cost_end = bundle_jax.solve_bundle(problem, "reproj", mask,
                                                start)
        assert abs(cost_end - cost_ref) <= 1e-2 * cost_ref
        moved = max(moved,
                    np.abs(end[:, 0] / ref[:, 0] - 1).max(),
                    np.abs(end[:, 3] - ref[:, 3]).max())
    assert moved > 3e-3

    def f_jax(x):
        return bundle_jax._residual(
            x, jnp.asarray(params0),
            *[jnp.asarray(problem[k]) for k in PROBLEM_KEYS], "reproj", act)

    def cost_at(p):
        r = np.asarray(f_jax(jnp.asarray(p.reshape(-1), jnp.float32)),
                       np.float64)
        return float((r * r).sum())

    line = [cost_at((1 - t) * ref + t * got) for t in np.linspace(0, 1, 11)]
    assert max(line) - min(line) <= 1e-3 * min(line)

    J = np.asarray(jax.jacfwd(f_jax)(jnp.asarray(ref.reshape(-1))),
                   np.float64)
    A = J.T @ J
    d = np.sqrt(np.maximum(np.diag(A), 1e-12))
    ev = np.linalg.eigvalsh(A / d[:, None] / d[None, :])
    assert np.abs(ev[:3]).max() <= 1e-9 * ev[-1]
    assert ev[3] <= 1e-4 * ev[-1]


def test_adjuster_no_and_unconfident_edges_return_the_estimate(estimated):
    _, _, _, feats, matches, cams = estimated
    assert CameraAdjuster("no", device="cpu").adjust(
        feats, matches, cams) is cams
    strict = CameraAdjuster("ray", confidence_threshold=1e9, device="cpu")
    assert strict.adjust(feats, matches, cams) is cams


def _camera_rotations(kind):
    rng = np.random.RandomState(7)
    rvecs = np.zeros((6, 3), np.float32)
    axis = 0 if kind == "vert" else 1
    rvecs[:, axis] = np.linspace(-0.6, 0.6, 6)
    rvecs += 0.03 * rng.randn(6, 3).astype(np.float32)
    return rotation.rodrigues_to_matrix(rvecs).astype(np.float32)


@pytest.mark.parametrize("kind", ["horiz", "vert", "auto"])
@pytest.mark.parametrize("layout", ["horiz", "vert"])
def test_wave_correct_matches_jax(kind, layout):
    """To 1e-5: the eigenvectors' signs may differ between LAPACK builds,
    the corrected rotations do not depend on them."""
    rmats = _camera_rotations(layout)
    ref = wave_correct_jax(rmats, kind)
    ref_dev = np.asarray(wave_correct_jax(jnp.asarray(rmats), kind))
    got = wave_correct(rmats, kind)
    assert got.dtype == np.float32 and got.shape == rmats.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, ref_dev, atol=1e-5)


@pytest.mark.parametrize("kind", ["horiz", "vert", "auto", "no"])
def test_wave_corrector_component(estimated, kind):
    cams = [c.copy() for c in estimated[5]]
    before = np.stack([c.R for c in cams])
    out = WaveCorrector(kind).correct(cams)
    after = np.stack([c.R for c in out])
    if kind == "no":
        np.testing.assert_array_equal(after, before)
    else:
        np.testing.assert_allclose(after, wave_correct(before, kind),
                                   atol=1e-6)
        # a global rotation: relative rotations are unchanged
        np.testing.assert_allclose(after[0].T @ after[1],
                                   before[0].T @ before[1], atol=1e-5)
