from optflow.features.align import find_alignment
from optflow.features.detect import fast_keypoints, hessian_keypoints
from optflow.features.descriptors import orb_descriptors, surf_descriptors
from optflow.features.match import knn_match2, ratio_filter
from optflow.features.ransac import find_homography

__all__ = [
    "find_alignment",
    "fast_keypoints",
    "hessian_keypoints",
    "orb_descriptors",
    "surf_descriptors",
    "knn_match2",
    "ratio_filter",
    "find_homography",
]
