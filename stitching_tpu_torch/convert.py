"""Build the port's intermediate results from plain numpy fields.

For a stitcher the state carried between stages is its intermediate
results: keypoints and descriptors, pairwise matches, and cameras. These
functions take the fields of `Features`, `MatchesInfo` and `CameraParams`
as numpy arrays (for example, copied out of another implementation's
objects) and build the port's objects, so one stage can be run on
another implementation's inputs.
"""

import numpy as np
import torch

from .types import CameraParams, Features, MatchesInfo


def features_from_numpy(xy, response, size, angle, desc, valid, img_size,
                        is_binary=True):
    """One image's `Features`; `desc` becomes a float32 CPU tensor (move it
    with `.to(device)` to match on the card)."""
    return Features(
        xy=np.asarray(xy, np.float32),
        response=np.asarray(response, np.float32),
        size=np.asarray(size, np.float32),
        angle=np.asarray(angle, np.float32),
        desc=torch.tensor(np.asarray(desc, np.float32)),
        valid=np.asarray(valid, bool),
        img_size=(int(img_size[0]), int(img_size[1])),
        is_binary=bool(is_binary),
    )


def matches_from_numpy(src_img_idx, dst_img_idx, matches, matches_valid,
                       inliers_mask, num_inliers, H, confidence):
    """One pair's `MatchesInfo`."""
    return MatchesInfo(
        src_img_idx=int(src_img_idx), dst_img_idx=int(dst_img_idx),
        matches=None if matches is None else np.asarray(matches, np.int32),
        matches_valid=(None if matches_valid is None
                       else np.asarray(matches_valid, bool)),
        inliers_mask=(None if inliers_mask is None
                      else np.asarray(inliers_mask, bool)),
        num_inliers=int(num_inliers),
        H=None if H is None else np.asarray(H, np.float64),
        confidence=float(confidence),
    )


def cameras_from_numpy(focals, aspects, ppxs, ppys, Rs):
    """A list of `CameraParams`, one per entry of the field arrays."""
    return [CameraParams(focal=float(f), aspect=float(a), ppx=float(px),
                         ppy=float(py), R=np.asarray(R, np.float32))
            for f, a, px, py, R in zip(focals, aspects, ppxs, ppys, Rs)]
