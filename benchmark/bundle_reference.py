"""A plain reference of the ray bundle adjustment, in float64 on the CPU.

It states the cost of OpenCV's `cv::detail::BundleAdjusterRay` over the
confident edges of a capture and minimises it with a plain
Levenberg-Marquardt loop under OpenCV's termination, so that a run can
tell a wrong minimiser from wrong inputs. It imports nothing of the port,
no JAX and no `cv2`: plain PyTorch in float64 on the CPU, NumPy for glue.

The problem is the one the port packs (`camera_adjuster._pack_problem`):
`src_idx`, `dst_idx` (E,) the two views of each edge; `pts_src`,
`pts_dst` (E, M, 2) the inlier keypoints of each edge in pixels of the
registration's resolution; `w` (E, M) 1 for a real inlier and 0 for
padding. The cameras are each a focal, a principal point, an aspect and a
rotation R (camera to world, as `CameraParams.R`).

Cost (`residuals`): for each inlier match (p in view i, q in view j),
sqrt(f_i f_j) (unit(R_i K_i^-1 p) - unit(R_j K_j^-1 q)), three numbers a
match, summed in squares. Each camera's focal and rotation are free (4
numbers: f and the Rodrigues vector of R); principal point and aspect stay
as given.

Loop (`solve`), OpenCV's `CvLevMarq` as the adjuster runs it: lambda
starts at 1e-3; a trial step solves (J^T J + lambda diag(J^T J)) d =
J^T r; a step that raises the cost is taken back and lambda grows ten
times (up to 1e16), a step that does not is kept and lambda shrinks ten
times (down to 1e-16). The loop ends after 1,000 kept steps, or when a
kept step moves the parameters by less than `EPS` (DBL_EPSILON) of their
norm.

Departures from OpenCV, none of which moves the minimum it finds:
- the Jacobian is exact (`torch.func.jacfwd`), where OpenCV takes
  central differences with a step of 1e-4;
- the damped system is solved by a least-squares solve in float64, where
  OpenCV back-substitutes through an SVD of it: the same solution where
  the damped system is regular, which damping makes it;
- the result is left in the start's frame; OpenCV turns every camera
  after the loop so that the centre of the confident graph's maximum
  spanning tree is the identity. `compare` holds the two results in one
  frame, that of the start's identity camera.
"""

import numpy as np
import torch

MAX_ITERS = 1000
EPS = float(np.finfo(np.float64).eps)
LAMBDA_LG10_START, LAMBDA_LG10_MIN, LAMBDA_LG10_MAX = -3, -16, 16

# Tolerances of `compare`, the port's float32 result against this float64
# one from the same start on the same problem (readings of the card's
# bundles on 12 MP grid and 2 MP sweep sets, and of this result rounded to
# bfloat16, the control):
# - FOCAL_RTOL: the largest focal difference over the focal; the port
#   lands within 1.5e-5, bfloat16 holds a focal of ~780 px to 2.2e-3 or
#   worse;
FOCAL_RTOL = 5e-4
# - ANGLE_TOL (rad): each view's rotation relative to the start's
#   identity camera; the port within 1e-5, bfloat16 5.7e-4 or worse;
ANGLE_TOL = 2e-4
# - COST_RTOL: the port's cost, computed here in float64 at the port's
#   cameras, over the reference's minimum, less one; the port within
#   1e-9, bfloat16 2.7e-3 or worse: at a minimum the cost is flat to
#   first order, so this is the tightest of the three.
COST_RTOL = 1e-4


def rodrigues(rvec):
    """(..., 3) axis-angle -> (..., 3, 3) rotation, differentiable at 0."""
    theta2 = (rvec * rvec).sum(-1, keepdim=True)
    small = theta2 < 1e-24
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    k = rvec / theta
    z = torch.zeros_like(k[..., 0])
    kx = torch.stack([
        torch.stack([z, -k[..., 2], k[..., 1]], -1),
        torch.stack([k[..., 2], z, -k[..., 0]], -1),
        torch.stack([-k[..., 1], k[..., 0], z], -1)], -2)
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=rvec.dtype).expand(kx.shape)
    full = eye + s * kx + (1 - c) * (kx @ kx)
    # near 0: I + [r]x, exact to first order (the derivative there)
    r = rvec
    rx = torch.stack([
        torch.stack([z, -r[..., 2], r[..., 1]], -1),
        torch.stack([r[..., 2], z, -r[..., 0]], -1),
        torch.stack([-r[..., 1], r[..., 0], z], -1)], -2)
    return torch.where(small[..., None], eye + rx, full)


def rotation_vector(R):
    """A rotation matrix (3, 3) -> its axis-angle vector (NumPy)."""
    R = np.asarray(R, np.float64)
    u, _, vt = np.linalg.svd(R)
    R = u @ vt
    c = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    theta = np.arccos(c)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if theta < 1e-12:
        return v / 2
    if np.pi - theta < 1e-6:
        # near a half turn the skew part vanishes: the axis is the largest
        # column of the symmetric part less cos, (1 - cos) a a^T
        B = (R + R.T) / 2 - c * np.eye(3)
        axis = B[:, int(np.argmax(np.diag(B)))]
        axis = axis / np.linalg.norm(axis)
        return (-axis if axis @ v < 0 else axis) * theta
    return v / (2 * np.sin(theta)) * theta


class Problem:
    """The packed problem as float64 CPU tensors, padding dropped."""

    def __init__(self, problem, cameras):
        w = np.asarray(problem["w"], np.float64)
        keep = w.sum(1) > 0
        self.src = torch.as_tensor(np.asarray(problem["src_idx"])[keep],
                                   dtype=torch.long)
        self.dst = torch.as_tensor(np.asarray(problem["dst_idx"])[keep],
                                   dtype=torch.long)
        self.p = torch.as_tensor(np.asarray(problem["pts_src"],
                                            np.float64)[keep])
        self.q = torch.as_tensor(np.asarray(problem["pts_dst"],
                                            np.float64)[keep])
        self.sw = torch.as_tensor(np.sqrt(w[keep]))
        self.pp = torch.as_tensor(np.array(
            [[c["ppx"], c["ppy"]] for c in cameras], np.float64))
        self.aspect = torch.as_tensor(np.array(
            [c.get("aspect", 1.0) for c in cameras], np.float64))

    def rays(self, f, R, idx, pts):
        x = (pts[..., 0] - self.pp[idx, 0, None]) / f[idx, None]
        y = (pts[..., 1] - self.pp[idx, 1, None]) / (
            f[idx, None] * self.aspect[idx, None])
        v = torch.stack([x, y, torch.ones_like(x)], -1)
        v = torch.einsum("eij,emj->emi", R[idx], v)
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)

    def residuals(self, x):
        """Flat residuals for the parameters x (n * 4: f, rvec)."""
        x = x.reshape(-1, 4)
        f, R = x[:, 0], rodrigues(x[:, 1:])
        mult = torch.sqrt(f[self.src] * f[self.dst])[:, None, None]
        d = self.rays(f, R, self.src, self.p) - self.rays(f, R, self.dst,
                                                          self.q)
        return (d * mult * self.sw[..., None]).reshape(-1)


def _params(cameras):
    return torch.as_tensor(np.array(
        [[c["focal"], *rotation_vector(c["R"])] for c in cameras],
        np.float64).reshape(-1))


def _cameras(x, cameras):
    x = x.reshape(-1, 4)
    Rs = rodrigues(x[:, 1:]).numpy()
    return [dict(c, focal=float(x[i, 0]), R=Rs[i])
            for i, c in enumerate(cameras)]


def cost(problem, cameras):
    """The ray cost of `cameras` (sum of squares) in float64."""
    pb = Problem(problem, cameras)
    r = pb.residuals(_params(cameras))
    return float((r * r).sum())


def solve(problem, cameras, max_iters=MAX_ITERS, eps=EPS):
    """Minimise the ray cost from `cameras` (dicts with focal, ppx, ppy,
    aspect, R). Returns (cameras, cost, kept steps, trial steps)."""
    pb = Problem(problem, cameras)
    jac = torch.func.jacfwd(pb.residuals)
    x = _params(cameras)
    r = pb.residuals(x)
    err = float((r * r).sum())
    lam = LAMBDA_LG10_START
    kept = trials = 0
    while True:
        J = jac(x)
        A, g = J.T @ J, J.T @ r
        while True:
            trials += 1
            N = A + torch.diag(torch.diagonal(A)) * 10.0 ** lam
            d = torch.linalg.lstsq(N, g[:, None]).solution[:, 0]
            x_new = x - d
            r_new = pb.residuals(x_new)
            err_new = float((r_new * r_new).sum())
            if not (err_new > err) or lam >= LAMBDA_LG10_MAX:
                break
            lam += 1
        lam = max(lam - 1, LAMBDA_LG10_MIN)
        moved = float(torch.linalg.vector_norm(x_new - x)
                      / torch.linalg.vector_norm(x))
        x, r, err = x_new, r_new, err_new
        kept += 1
        if kept >= max_iters or moved < eps:
            break
    return _cameras(x, cameras), err, kept, trials


def _in_frame(cameras, anchor):
    """Each R turned so that camera `anchor` is the identity."""
    Ra = np.asarray(cameras[anchor]["R"], np.float64)
    return [Ra.T @ np.asarray(c["R"], np.float64) for c in cameras]


def compare(problem, start, program, reference=None):
    """The program's bundle result against this reference's from the same
    start. `start` and `program` are lists of camera dicts; `reference`,
    if given, is `solve`'s result for the start. Returns the numbers and
    whether each is inside its tolerance."""
    if reference is None:
        reference = solve(problem, start)
    ref, ref_cost = reference[0], reference[1]
    anchor = int(np.argmin([np.linalg.norm(np.asarray(c["R"]) - np.eye(3))
                            for c in start]))
    Rp, Rr = _in_frame(program, anchor), _in_frame(ref, anchor)
    angle = max(float(np.linalg.norm(rotation_vector(a.T @ b)))
                for a, b in zip(Rp, Rr))
    focal = max(abs(p["focal"] - r["focal"]) / r["focal"]
                for p, r in zip(program, ref))
    prog_cost = cost(problem, program)
    excess = (prog_cost - ref_cost) / max(ref_cost, 1e-300)
    out = dict(focal_rdiff=focal, angle_rad=angle, cost_excess=excess,
               cost=prog_cost, ref_cost=ref_cost,
               ref_steps=reference[2], ref_trials=reference[3])
    out["ok"] = bool(focal <= FOCAL_RTOL and angle <= ANGLE_TOL
                     and excess <= COST_RTOL)
    return out
