"""Bundle adjustment: Levenberg-Marquardt over camera parameters.

Port of `stitching_tpu/ops/bundle.py`: residuals are functions over a
fixed-capacity (edges x matches) problem tensor and the Jacobian comes
from `torch.func.jacfwd`, exact derivatives, batched on the device. With a
mesh each rank holds a block of the edges, and `J^T J`, `J^T r` and the
costs are summed over the ranks, so every rank solves the same system and
takes the same step.

Residual models:
- ray: residual = sqrt(f_i f_j) * (unit(R_i K_i^-1 p) - unit(R_j K_j^-1 q)),
  3 components per inlier match;
- reproj: residual = proj(K_j R_j^-1 R_i K_i^-1 p) - q, 2 components;
- affine: residual = A_j A_i^-1 p - q for 4-DoF similarity cameras.

Parameter layout per camera: (focal, ppx, ppy, aspect, rvec[3]) for the
rotation models, (a, b, tx, ty) for the affine model. The refinement mask
gates which intrinsics vary; rotations always vary.

The LM loop is data-dependent: each trial step's accept/reject decision is
read on the host (one flag per step, so one device sync per step), and the
Jacobian and the normal system are evaluated again only after an accepted
step (under a mesh: one reduction per refresh and one per trial step). All arithmetic is
float32, as in the reference; last-bit differences can flip an
accept/reject, so the result, not the trajectory, is what agrees with the
reference.
"""

import numpy as np
import torch

from .. import profiling as prof
from ..parallel.mesh import all_reduce_sum, shard_leading
from .rotation import rodrigues_to_matrix

MAX_LM_ITERS = 100  # total trial steps (accepts + rejects)


def _K_from_params(p):
    """p: (..., 7) -> K (..., 3, 3)."""
    f, ppx, ppy, aspect = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    z = torch.zeros_like(f)
    o = torch.ones_like(f)
    return torch.stack([
        torch.stack([f, z, ppx], -1),
        torch.stack([z, f * aspect, ppy], -1),
        torch.stack([z, z, o], -1),
    ], -2)


def _rays(params_cam, pts):
    """Unit rays R K^-1 p for pts (E, M, 2) under per-edge cams (E, 7)."""
    f = params_cam[..., 0:1]
    ppx = params_cam[..., 1:2]
    ppy = params_cam[..., 2:3]
    aspect = params_cam[..., 3:4]
    R = rodrigues_to_matrix(params_cam[..., 4:7])        # (E, 3, 3)
    x = (pts[..., 0] - ppx) / f
    y = (pts[..., 1] - ppy) / (f * aspect)
    z = torch.ones_like(x)
    v = torch.stack([x, y, z], -1)                       # (E, M, 3)
    v = torch.einsum("eij,emj->emi", R, v)
    norm = torch.sqrt((v * v).sum(dim=-1, keepdim=True))
    return v / norm.clamp_min(1e-12)


def _residual(x, params0, src_idx, dst_idx, pts_src, pts_dst, w, variant,
              active_idx):
    """Flat residual vector for parameter update x (n_cam * n_active,).

    `active_idx` is the tuple of active per-camera parameter positions;
    the other positions keep their `params0` values. The active values
    enter through a constant one-hot scatter matrix, an out-of-place write
    that `torch.func` differentiates."""
    sw = torch.sqrt(w)
    n_cam, n_par = params0.shape
    xm = x.reshape(n_cam, len(active_idx))
    scatter = torch.eye(n_par, dtype=x.dtype,
                        device=x.device)[list(active_idx)]
    p = params0 * (1.0 - scatter.sum(0)) + xm @ scatter

    pc_i, pc_j = p[src_idx], p[dst_idx]
    if variant == "ray":
        ri = _rays(pc_i, pts_src)
        rj = _rays(pc_j, pts_dst)
        mult = torch.sqrt(pc_i[..., 0] * pc_j[..., 0])[:, None, None]
        return ((ri - rj) * mult * sw[..., None]).reshape(-1)
    if variant == "reproj":
        Ki = _K_from_params(pc_i)
        Kj = _K_from_params(pc_j)
        Ri = rodrigues_to_matrix(pc_i[..., 4:7])
        Rj = rodrigues_to_matrix(pc_j[..., 4:7])
        H = Kj @ Rj.transpose(-1, -2) @ Ri @ torch.linalg.inv(Ki)
        ph = torch.cat([pts_src, torch.ones_like(pts_src[..., :1])], -1)
        q = torch.einsum("eij,emj->emi", H, ph)
        z = q[..., 2:]
        z = torch.where(z.abs() < 1e-12, 1e-12, z)
        return (((q[..., :2] / z) - pts_dst) * sw[..., None]).reshape(-1)
    if variant == "affine":
        # cameras hold A_i mapping panorama -> image i (a, b, tx, ty)
        ai, bi = pc_i[:, 0, None], pc_i[:, 1, None]
        det = (ai * ai + bi * bi).clamp_min(1e-12)
        dx = pts_src[..., 0] - pc_i[:, 2, None]
        dy = pts_src[..., 1] - pc_i[:, 3, None]
        X = (ai * dx + bi * dy) / det
        Y = (-bi * dx + ai * dy) / det
        aj, bj = pc_j[:, 0, None], pc_j[:, 1, None]
        rx = aj * X - bj * Y + pc_j[:, 2, None] - pts_dst[..., 0]
        ry = bj * X + aj * Y + pc_j[:, 3, None] - pts_dst[..., 1]
        return (torch.stack([rx, ry], -1) * sw[..., None]).reshape(-1)
    raise ValueError("unknown BA variant: " + variant)


def _lm_engine(x0, residual, max_iters, reduce=None):
    """The LM loop. Classic trust-region damping: one trial step per
    iteration; on accept the Jacobian refreshes and lambda shrinks, on
    reject lambda grows. Terminates on relative-improvement convergence or
    8 consecutive rejects. The damped normal system solves in float32 with
    Jacobi preconditioning (scales focal-like and radian-like parameters
    comparably).

    `reduce` sums a flat tensor over the ranks of a mesh (None: one
    process): the normal system and the costs are reduced before any use,
    so every rank takes the same decisions.

    The trial steps taken, accepted or rejected, go to the
    `bundle/iterations` counter once the loop ends: one host read each."""
    jac = torch.func.jacfwd(residual)
    k = x0.numel()

    def summed(*parts):
        flat = torch.cat([p.reshape(-1) for p in parts])
        return flat if reduce is None else reduce(flat)

    def normal(x, r, *extra):
        J = jac(x)
        flat = summed(J.T @ J, J.T @ r, *extra)
        return flat[:k * k].reshape(k, k), flat[k * k:k * k + k], flat

    x, r = x0, residual(x0)
    A, g, flat = normal(x, r, (r * r).sum())
    cost = flat[-1]
    lam = 1e-3
    rejects = 0
    steps = 0
    for _ in range(max_iters):
        steps += 1
        D = torch.diagonal(A).clamp_min(1e-12)
        dsqrt = torch.sqrt(D)
        M = (A + lam * torch.diag(D)) / dsqrt[:, None] / dsqrt[None, :]
        delta = -torch.linalg.solve(M, g / dsqrt) / dsqrt
        x_new = x + delta
        r_new = residual(x_new)
        cost_new = summed((r_new * r_new).sum())[0]
        rel = (cost - cost_new) / cost.clamp_min(1e-30)
        # the one host read of the step: accept, and converged if accepted
        accept, converged = torch.stack([
            torch.isfinite(cost_new) & (cost_new < cost),
            rel < 1e-8]).tolist()
        if accept:
            x, r, cost = x_new, r_new, cost_new
            A, g, _ = normal(x, r)
            lam = max(lam / 10, 1e-12)
            rejects = 0
            if converged:
                break
        else:
            lam = lam * 10
            rejects += 1
            if rejects >= 8:
                break
    prof.count("bundle/iterations", steps)
    return x, cost


def solve_bundle(problem, variant, param_mask, params0,
                 max_iters=MAX_LM_ITERS, device="cuda", mesh=None):
    """Adjust cameras: returns (params (N, P) numpy array, cost).

    problem: dict with src_idx (E,), dst_idx (E,), pts_src/pts_dst (E, M, 2),
    w (E, M) in {0,1}. param_mask: (P,) bool over per-camera parameters;
    frozen entries keep their params0 values. The loop runs on `device`
    (the card by default). With a mesh it runs on `mesh.device`, each rank
    on its block of the edges (the edge axis padded with zero-weight
    edges to a multiple of the rank count), the sums reduced over the
    ranks.
    """
    params0 = np.asarray(params0, np.float32)
    active_idx = tuple(int(i) for i in np.where(np.asarray(param_mask))[0])
    x0 = params0[:, list(active_idx)].reshape(-1)
    if mesh is not None:
        device = mesh.device

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def edges(a, dtype):
        if mesh is None:
            return dev(a, dtype)
        return shard_leading(np.asarray(a), mesh).to(dtype)

    p0 = dev(params0, torch.float32)
    src_idx = edges(problem["src_idx"], torch.long)
    dst_idx = edges(problem["dst_idx"], torch.long)
    pts_src = edges(problem["pts_src"], torch.float32)
    pts_dst = edges(problem["pts_dst"], torch.float32)
    w = edges(problem["w"], torch.float32)

    def residual(x):
        return _residual(x, p0, src_idx, dst_idx, pts_src, pts_dst, w,
                         variant, active_idx)

    reduce = None if mesh is None else (lambda t: all_reduce_sum(t, mesh))
    x, cost = _lm_engine(dev(x0, torch.float32), residual, int(max_iters),
                         reduce)
    full = params0.copy()
    full[:, list(active_idx)] = x.cpu().numpy().reshape(params0.shape[0], -1)
    return full, float(cost)
