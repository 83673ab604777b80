"""Wave correction: global rotation straightening the panorama.

Port of `stitching_tpu/ops/wave.py` (the cv.detail.waveCorrect analog): the
world vertical is recovered as the null-ish direction of the covariance of
camera x-axes (smallest eigenvector), a consistent horizontal frame is built
against the mean viewing direction, and all rotations get the global fix
applied. HORIZ / VERT / AUTO variants.

It runs in numpy on the host, as the reference does for numpy inputs: a 3x3
eigendecomposition over N cameras is microseconds there. The sign of an
eigenvector may differ between LAPACK builds; the result does not depend on
it, because the sign of `conf` fixes rg0 and rg1 afterwards.
"""

import numpy as np


def _impl(rmats, kind):
    x_axes = rmats[:, :, 0]                     # (N, 3) camera x axes
    moment = np.einsum("ni,nj->ij", x_axes, x_axes)
    evals, evecs = np.linalg.eigh(moment)       # ascending

    if kind == "auto":
        # cv.detail.autoDetectWaveCorrectKind semantics: compare the spread
        # of the cameras' viewing directions (projected optical axes) along
        # x vs y: a horizontal panorama spreads them in x, a vertical one
        # in y.
        z = rmats[:, :, 2]
        zz = np.where(np.abs(z[:, 2:3]) < 1e-6, 1e-6, z[:, 2:3])
        px = z[:, 0] / zz[:, 0]
        py = z[:, 1] / zz[:, 0]
        horiz_like = ((np.max(px) - np.min(px))
                      >= (np.max(py) - np.min(py)))
        rg1 = np.where(horiz_like, evecs[:, 0], evecs[:, 2])
    elif kind == "horiz":
        rg1 = evecs[:, 0]                       # smallest eigenvalue
    elif kind == "vert":
        rg1 = evecs[:, 2]                       # largest eigenvalue
    else:
        raise ValueError("invalid wave correction kind: " + kind)

    img_k = rmats[:, :, 2].sum(axis=0)          # sum of viewing directions
    rg0 = np.cross(rg1, img_k)
    rg0 = rg0 / np.maximum(np.linalg.norm(rg0), 1e-12)
    rg2 = np.cross(rg0, rg1)

    if kind == "vert":
        conf = -np.sum(x_axes @ rg1)
    elif kind == "auto":
        conf = np.where(horiz_like, np.sum(x_axes @ rg0),
                        -np.sum(x_axes @ rg1))
    else:
        conf = np.sum(x_axes @ rg0)
    sign = np.where(conf < 0, -1.0, 1.0)
    rg0 = rg0 * sign
    rg1 = rg1 * sign

    Rg = np.stack([rg0, rg1, rg2], axis=0)      # rows
    return np.einsum("ij,njk->nik", Rg, rmats)


def wave_correct(rmats, kind: str = "horiz"):
    """rmats: (N, 3, 3) camera rotations. Returns the corrected stack
    (float32 numpy)."""
    return _impl(np.asarray(rmats, np.float32), kind).astype(np.float32)
