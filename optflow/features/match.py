"""Descriptor matching as one matmul.

Replaces cv::cuda::DescriptorMatcher::knnMatch(k=2)
(src/features.cpp:98-101): the full distance matrix is one matmul, top-2
nearest neighbors come from two masked min-reductions, and Lowe's ratio
test (src/features.cpp:107-113) is a vectorized filter.

- float descriptors (SURF-class, L2-normalized): dist^2 = 2 - 2 a.b
- binary descriptors as +/-1 floats (ORB-class): hamming = (D - a.b) / 2

Both are monotone in -a.b, so matching minimizes the negative dot product
and converts for reporting.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class Knn2(NamedTuple):
    idx: jnp.ndarray  # (K,) best-match index into descriptor set 1
    dist1: jnp.ndarray  # (K,) best distance
    dist2: jnp.ndarray  # (K,) second-best distance
    valid: jnp.ndarray  # (K,) both rows valid


@functools.partial(jax.jit, static_argnames=("binary",))
def knn_match2(
    desc0: jnp.ndarray,
    valid0: jnp.ndarray,
    desc1: jnp.ndarray,
    valid1: jnp.ndarray,
    binary: bool = False,
) -> Knn2:
    """k=2 nearest-neighbor match from set 0 into set 1."""
    d = desc0.shape[-1]
    # HIGHEST keeps the f32 product out of TF32: the ratio test compares
    # best and second-best distances that can differ in the 4th digit
    dots = jnp.dot(
        desc0, desc1.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # (K0, K1)
    # invalid columns must never win
    neg = jnp.where(valid1[None, :], dots, -jnp.inf)

    best = jnp.max(neg, axis=1)
    idx = jnp.argmax(neg, axis=1)
    # mask out the best column, find the runner-up
    k1 = desc1.shape[0]
    onehot = jax.nn.one_hot(idx, k1, dtype=bool)
    second = jnp.max(jnp.where(onehot, -jnp.inf, neg), axis=1)

    if binary:
        dist1 = (d - best) * 0.5
        dist2 = (d - second) * 0.5
    else:
        dist1 = jnp.sqrt(jnp.maximum(2.0 - 2.0 * best, 0.0))
        dist2 = jnp.sqrt(jnp.maximum(2.0 - 2.0 * second, 0.0))

    valid = valid0 & jnp.isfinite(best) & jnp.isfinite(second)
    dist1 = jnp.where(valid, dist1, jnp.inf)
    dist2 = jnp.where(valid, dist2, jnp.inf)
    return Knn2(idx=idx, dist1=dist1, dist2=dist2, valid=valid)


def ratio_filter(matches: Knn2, ratio: float) -> jnp.ndarray:
    """Lowe ratio test mask: best < ratio * second (ref default 0.8,
    src/features.cpp:109)."""
    return matches.valid & (matches.dist1 < ratio * matches.dist2)
