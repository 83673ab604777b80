"""Save and load the registration: the cameras, the warper scale and the
kept image indices, so composition can run again (at another final
resolution, with another seam finder or blender) without detecting,
matching and adjusting again.

Port of `stitching_tpu/registration.py`: host numpy and one `.npz` file in
the same layout, so a file written by either package loads in the other.
"""

import numpy as np

from .types import CameraParams


def save_registration(path, cameras, indices=None, scale=None, extra=None):
    data = dict(
        focal=np.array([c.focal for c in cameras]),
        aspect=np.array([c.aspect for c in cameras]),
        ppx=np.array([c.ppx for c in cameras]),
        ppy=np.array([c.ppy for c in cameras]),
        R=np.stack([c.R for c in cameras]),
    )
    if indices is not None:
        data["indices"] = np.asarray(indices)
    if scale is not None:
        data["scale"] = np.asarray(scale)
    if extra:
        for k, v in extra.items():
            data["extra_" + k] = np.asarray(v)
    np.savez(path, **data)


def load_registration(path):
    z = np.load(path)
    cameras = [
        CameraParams(
            focal=float(z["focal"][i]), aspect=float(z["aspect"][i]),
            ppx=float(z["ppx"][i]), ppy=float(z["ppy"][i]),
            R=z["R"][i].astype(np.float32))
        for i in range(len(z["focal"]))
    ]
    out = dict(cameras=cameras)
    if "indices" in z:
        out["indices"] = z["indices"]
    if "scale" in z:
        out["scale"] = float(z["scale"])
    return out
