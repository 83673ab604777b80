"""Match-graph subsetting: keep the largest connected component.

Covers the reference's `stitching/subsetter.py` contract
(cv.detail.leaveBiggestComponent + matchesGraphAsString analogs): the
confidence-thresholded component search, the "Not all images are included"
warning, the <2-survivors StitchingError, the DOT matches-graph dump
(including the reference's zero-threshold quirk), and the static re-indexing
helpers. Graph logic lives in module-level functions over the confidence
matrix (N is tiny — pure host control flow); the class is the configured
component shell.
"""

import warnings
from itertools import chain

import numpy as np

from .errors import StitchingError, StitchingWarning
from .feature_matcher import FeatureMatcher

_DROPPED_WARNING = (
    "Not all images are included in the final panorama. If this is not "
    "intended, use the 'matches_graph_dot_file' parameter to analyze your "
    "matches. You might want to lower the 'confidence_threshold' or try "
    "another 'detector' to include all your images."
)
_NO_MATCH_ERROR = (
    "No match exceeds the given confidence threshold. Do your images have "
    "enough overlap and common features? If yes, you might want to lower "
    "the 'confidence_threshold' or try another 'detector'."
)


def largest_component(matrix, threshold):
    """Indices of the biggest connected component of the pair graph whose
    edges have confidence >= threshold (union-find over the N x N matrix)."""
    n = len(matrix)
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i in range(n):
        for j in range(i + 1, n):
            if matrix[i][j].confidence >= threshold:
                ra, rb = find(i), find(j)
                if ra != rb:
                    parent[rb] = ra

    components = {}
    for i in range(n):
        components.setdefault(find(i), []).append(i)
    return sorted(max(components.values(), key=len))


def matches_graph_dot(img_names, matrix, threshold):
    """DOT-language dump of the confident match graph (the reference's
    matchesGraphAsString analog; edge labels Nm/Ni/C)."""
    if threshold == 0:
        threshold = 0.00001  # the reference: a 0 threshold breaks the dump
    n = len(img_names)
    lines = ["graph matches_graph{"]
    in_an_edge = set()
    for i in range(n):
        for j in range(i + 1, n):
            m = matrix[i][j]
            if m.confidence < threshold:
                continue
            in_an_edge.update((i, j))
            lines.append(
                f'"{img_names[i]}" -- "{img_names[j]}"'
                f'[label="Nm={m.num_matches}, Ni={m.num_inliers}, '
                f'C={m.confidence:g}"];'
            )
    lines.extend(f'"{img_names[i]}";' for i in range(n)
                 if i not in in_an_edge)
    lines.append("}")
    return "\n".join(lines) + "\n"


class Subsetter:
    DEFAULT_CONFIDENCE_THRESHOLD = 1
    DEFAULT_MATCHES_GRAPH_DOT_FILE = None

    def __init__(
        self,
        confidence_threshold=DEFAULT_CONFIDENCE_THRESHOLD,
        matches_graph_dot_file=DEFAULT_MATCHES_GRAPH_DOT_FILE,
    ):
        self.confidence_threshold = confidence_threshold
        self.save_file = matches_graph_dot_file

    def subset(self, img_names, features, matches):
        self.save_matches_graph_dot_file(img_names, matches)
        indices = self.get_indices_to_keep(features, matches)
        if len(indices) < len(img_names):
            warnings.warn(_DROPPED_WARNING, StitchingWarning)
        return indices

    def save_matches_graph_dot_file(self, img_names, pairwise_matches):
        if self.save_file:
            with open(self.save_file, "w") as fh:
                fh.write(self.get_matches_graph(img_names, pairwise_matches))

    def get_matches_graph(self, img_names, pairwise_matches):
        matrix = FeatureMatcher.get_matches_matrix(pairwise_matches)
        return matches_graph_dot(img_names, matrix,
                                 self.confidence_threshold)

    def get_indices_to_keep(self, features, pairwise_matches):
        matrix = FeatureMatcher.get_matches_matrix(pairwise_matches)
        indices = largest_component(matrix, self.confidence_threshold)
        if len(indices) < 2:
            raise StitchingError(_NO_MATCH_ERROR)
        return np.array(indices)

    @staticmethod
    def subset_list(list_to_subset, indices):
        return [list_to_subset[i] for i in indices]

    @staticmethod
    def subset_matches(pairwise_matches, indices):
        matrix = np.array(
            FeatureMatcher.get_matches_matrix(pairwise_matches),
            dtype=object)
        kept = matrix[np.ix_(indices, indices)]
        return list(chain.from_iterable(kept.tolist()))
