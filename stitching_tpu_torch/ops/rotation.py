"""Rotation parameterizations (Rodrigues), batched, float32.

Port of `stitching_tpu/ops/rotation.py`. Bundle adjustment
(`camera_adjuster.py`) optimizes rotations in this minimal 3-parameter
chart. Tensors compute in torch (and differentiate under `torch.func`);
numpy inputs compute in numpy on the host, where the per-camera 3x3
conversions of the adjuster run.

At `rvec = 0` the matrix is the identity selected by a `where`, so its
derivative with respect to `rvec` is exactly zero there: the identity
(reference) camera gets zero rotation columns in the bundle Jacobian, which
is what fixes the gauge of the adjustment. The angle is the root of a
guarded sum of squares, so no 0/0 reaches the branch that is not selected.
"""

import numpy as np
import torch


def _rodrigues_np(rvec):
    rvec = np.asarray(rvec)
    theta = np.linalg.norm(rvec, axis=-1, keepdims=True)
    small = theta < 1e-8
    axis = rvec / np.where(small, 1.0, theta)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    c = np.cos(theta[..., 0])
    s = np.sin(theta[..., 0])
    C = 1 - c
    R = np.stack([
        np.stack([c + x * x * C, x * y * C - z * s, x * z * C + y * s], -1),
        np.stack([y * x * C + z * s, c + y * y * C, y * z * C - x * s], -1),
        np.stack([z * x * C - y * s, z * y * C + x * s, c + z * z * C], -1),
    ], axis=-2)
    eye = np.broadcast_to(np.eye(3, dtype=R.dtype), R.shape)
    return np.where(small[..., None], eye, R)


def rodrigues_to_matrix(rvec):
    """(..., 3) axis-angle -> (..., 3, 3) rotation matrix."""
    if not isinstance(rvec, torch.Tensor):
        return _rodrigues_np(rvec)
    sq = (rvec * rvec).sum(dim=-1, keepdim=True)
    small = sq < 1e-16                                   # theta < 1e-8
    theta = torch.sqrt(torch.where(small, 1.0, sq))
    axis = rvec / theta
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    c = torch.cos(theta[..., 0])
    s = torch.sin(theta[..., 0])
    C = 1 - c
    R = torch.stack([
        torch.stack([c + x * x * C, x * y * C - z * s, x * z * C + y * s], -1),
        torch.stack([y * x * C + z * s, c + y * y * C, y * z * C - x * s], -1),
        torch.stack([z * x * C - y * s, z * y * C + x * s, c + z * z * C], -1),
    ], dim=-2)
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    return torch.where(small[..., None], eye, R)


def matrix_to_rodrigues(R):
    """(..., 3, 3) rotation matrix -> (..., 3) axis-angle (numpy, host)."""
    R = np.asarray(R)
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = np.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(cos_t)
    v = np.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], axis=-1)
    s = np.linalg.norm(v, axis=-1, keepdims=True)
    small = s[..., 0] < 1e-8
    axis = v / np.where(small[..., None], 1.0, s)
    # For theta ~ pi the v-based axis degenerates; fall back to the diagonal.
    near_pi = (theta > 3.0) & small
    diag = np.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    axis_pi = np.sqrt(np.clip((diag + 1.0) * 0.5, 0.0, 1.0))
    axis = np.where(near_pi[..., None], axis_pi, axis)
    rvec = axis * theta[..., None]
    return np.where((small & ~near_pi)[..., None],
                    np.zeros_like(rvec), rvec)
