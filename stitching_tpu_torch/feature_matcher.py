"""Feature matching component.

Port of `stitching_tpu/feature_matcher.py`: the matcher registry
(homography default / affine), `range_width` banded matching, the flat
row-major N x N list of MatchesInfo (diagonal and below-threshold entries
have confidence 0, both (i,j) and (j,i) populated), the confidence-matrix
helpers and the match_conf defaults (0.3 for binary detectors, 0.65
otherwise).

Behavior of the native cv.detail matchers (SURVEY.md §2b): for the
homography model keypoint coords are centered on the image center before
the fit, the affine model (a 4-DoF similarity) fits raw pixels; confidence =
num_inliers / (8 + 0.3 * num_matches), > 3 -> 0; < 6 raw matches -> 0; the
reverse pair carries H^-1 and the same confidence.
"""

import numpy as np
import torch

from .errors import StitchingError
from .pipeline import match_stack, match_stack_dispatch
from .types import MatchesInfo

MIN_RAW_MATCHES = 6


class FeatureMatcher:
    MATCHER_CHOICES = ("homography", "affine")
    DEFAULT_MATCHER = "homography"
    DEFAULT_RANGE_WIDTH = -1

    def __init__(self, matcher_type=DEFAULT_MATCHER,
                 range_width=DEFAULT_RANGE_WIDTH, **kwargs):
        if matcher_type not in self.MATCHER_CHOICES:
            raise StitchingError("invalid matcher type: " + str(matcher_type))
        self.matcher_type = matcher_type
        self.range_width = range_width
        match_conf = kwargs.get("match_conf")
        self.match_conf = 0.3 if match_conf is None else match_conf
        # try_use_gpu is accepted for API parity; the device is chosen by
        # the Stitcher's `device`.
        self.try_use_gpu = kwargs.get("try_use_gpu", False)

    @staticmethod
    def get_match_conf(match_conf, detector):
        """Default ratio-test confidence: 0.3 for binary (orb/brisk/akaze),
        0.65 for float descriptors."""
        if match_conf is not None:
            return match_conf
        if detector in ("orb", "brisk", "akaze"):
            return 0.3
        return 0.65

    def match_features(self, features, mesh=None):
        """All pairs at once -> flat N x N list. With a mesh the pair axis
        splits over its ranks (`pipeline.match_stack_dispatch`)."""
        n = len(features)
        desc = torch.stack([torch.as_tensor(f.desc) for f in features])
        feats = dict(
            desc=desc,
            valid=np.stack([np.asarray(f.valid) for f in features]),
            xy=np.stack([np.asarray(f.xy) for f in features]),
        )
        img_sizes = np.asarray([f.img_size for f in features], np.float32)
        pair_ij, res = match_stack(
            feats, img_sizes, matcher_type=self.matcher_type,
            match_conf=float(self.match_conf), range_width=self.range_width,
            is_binary=features[0].is_binary, mesh=mesh)
        return self.matches_from_host(pair_ij, res, n)

    def match_stacked_dispatch(self, feats, img_sizes, is_binary, *,
                               n_images):
        """Launch the batched matcher on stacked detection tensors without
        copying results to host."""
        return match_stack_dispatch(
            feats, np.asarray(img_sizes, np.float32),
            matcher_type=self.matcher_type,
            match_conf=float(self.match_conf),
            range_width=self.range_width,
            is_binary=is_binary, n_images=n_images)

    def matches_from_host(self, pair_ij, res, n):
        """The reference-shaped flat N x N MatchesInfo list from the
        host copies of the batched-match results."""
        result = [MatchesInfo() for _ in range(n * n)]
        for k in range(len(pair_ij) if res is not None else 0):
            i, j = int(pair_ij[k, 0]), int(pair_ij[k, 1])
            fwd, bwd = self._pair_infos(res, k, i, j)
            result[i * n + j] = fwd
            result[j * n + i] = bwd
        return result

    @staticmethod
    def _pair_infos(res, k, i, j):
        """The forward/backward MatchesInfo for pair slot k."""
        pairs = res["pairs"][k]
        mvalid = res["matches_valid"][k]
        conf = float(res["confidence"][k])
        fwd = MatchesInfo(src_img_idx=i, dst_img_idx=j, matches=pairs,
                          matches_valid=mvalid,
                          inliers_mask=np.zeros(len(pairs), bool))
        bwd = MatchesInfo(src_img_idx=j, dst_img_idx=i,
                          matches=pairs[:, ::-1], matches_valid=mvalid,
                          inliers_mask=np.zeros(len(pairs), bool))
        if conf <= 0.0 or not bool(res["ok"][k]):
            return fwd, bwd

        H = np.asarray(res["H"][k], np.float64)
        fwd.H = H
        fwd.inliers_mask = res["inliers"][k]
        fwd.num_inliers = int(res["num_inliers"][k])
        fwd.confidence = conf
        try:
            H_inv = np.linalg.inv(H)
            H_inv /= H_inv[2, 2]
        except np.linalg.LinAlgError:
            return fwd, bwd
        bwd.H = H_inv
        bwd.inliers_mask = fwd.inliers_mask
        bwd.num_inliers = fwd.num_inliers
        bwd.confidence = conf
        return fwd, bwd

    # ---- helpers mirrored from the reference API ----

    @staticmethod
    def get_matches_matrix(matches):
        return FeatureMatcher.array_in_square_matrix(matches)

    @staticmethod
    def get_confidence_matrix(matches):
        matches_matrix = FeatureMatcher.get_matches_matrix(matches)
        return np.array(
            [[m.confidence for m in row] for row in matches_matrix]
        )

    @staticmethod
    def array_in_square_matrix(array):
        matrix_dimension = int(np.sqrt(len(array)))
        rows = []
        for i in range(0, len(array), matrix_dimension):
            rows.append(array[i: i + matrix_dimension])
        return rows

    @staticmethod
    def get_all_img_combinations(imgs):
        ii, jj = np.triu_indices(len(imgs), k=1)
        for i, j in zip(ii, jj):
            yield imgs[i], imgs[j]

    @staticmethod
    def draw_matches_matrix(imgs, features, matches, conf_thresh=1,
                            inliers=False, **kwargs):
        matches_matrix = FeatureMatcher.get_matches_matrix(matches)
        for idx1, idx2 in zip(*np.triu_indices(len(imgs), k=1)):
            match = matches_matrix[idx1][idx2]
            if match.confidence < conf_thresh:
                continue
            yield idx1, idx2, FeatureMatcher.draw_matches(
                imgs[idx1], features[idx1], imgs[idx2], features[idx2],
                match, inliers=inliers, **kwargs)

    @staticmethod
    def draw_matches(img1, features1, img2, features2, match1to2,
                     inliers=False, **kwargs):
        from .viz import draw_matches as _draw

        kps1 = np.asarray(features1.xy)
        kps2 = np.asarray(features2.xy)
        sel = match1to2.inliers_mask if inliers else match1to2.matches_valid
        return _draw(img1, kps1, img2, kps2, match1to2.matches, sel)
