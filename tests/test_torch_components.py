"""The detector's and matcher's host helpers against the JAX package's:
`detect_features`, `draw_keypoints`, `get_all_img_combinations`,
`draw_matches_matrix`, `draw_matches` and `viz.py` (numpy only, equal
arrays)."""

import numpy as np
import torch

from fixtures import rotation_set
from stitching_tpu import viz as jax_viz
from stitching_tpu.feature_detector import FeatureDetector as JaxDetector
from stitching_tpu.feature_matcher import FeatureMatcher as JaxMatcher
from stitching_tpu_torch import viz
from stitching_tpu_torch.feature_detector import FeatureDetector
from stitching_tpu_torch.feature_matcher import FeatureMatcher

torch.set_num_threads(2)


def test_viz_equals_jax():
    rng = np.random.RandomState(0)
    a = rng.randint(0, 255, (60, 80, 3)).astype(np.uint8)
    b = rng.randint(0, 255, (50, 70)).astype(np.uint8)
    kps = rng.rand(20, 2) * [70, 50]
    pairs = rng.randint(0, 20, (15, 2))
    keep = rng.rand(15) > 0.3
    np.testing.assert_array_equal(viz.draw_circles(a, kps, 4, (1, 2, 3)),
                                  jax_viz.draw_circles(a, kps, 4, (1, 2, 3)))
    np.testing.assert_array_equal(
        viz.draw_matches(a, kps, b, kps, pairs, keep),
        jax_viz.draw_matches(a, kps, b, kps, pairs, keep))


def test_detect_features_and_the_drawings():
    imgs = rotation_set(n=3, size=(320, 240))[0]
    det = FeatureDetector("orb", device="cpu", nfeatures=200)
    one = det.detect_features(imgs[0])
    assert one.desc.shape == (200, 256) and one.img_size == (320, 240)
    batch = det.detect(imgs)
    np.testing.assert_array_equal(one.xy, batch[0].xy)
    np.testing.assert_array_equal(one.desc.numpy(), batch[0].desc.numpy())
    mask = np.zeros((240, 320), np.uint8)
    mask[:, :150] = 255
    masked = det.detect_features(imgs[0], mask)
    assert (masked.keypoints_np[:, 0] < 150).all()
    np.testing.assert_array_equal(
        FeatureDetector.draw_keypoints(imgs[0], one),
        JaxDetector.draw_keypoints(imgs[0], one))

    matches = FeatureMatcher().match_features(batch)
    assert (list(FeatureMatcher.get_all_img_combinations(imgs))
            == list(JaxMatcher.get_all_img_combinations(imgs)))
    got = list(FeatureMatcher.draw_matches_matrix(imgs, batch, matches,
                                                  conf_thresh=0,
                                                  inliers=True))
    ref = list(JaxMatcher.draw_matches_matrix(imgs, batch, matches,
                                              conf_thresh=0, inliers=True))
    assert len(got) == len(ref) == 3
    for (i, j, a), (k, m, b) in zip(got, ref):
        assert (i, j) == (k, m)
        np.testing.assert_array_equal(a, b)
