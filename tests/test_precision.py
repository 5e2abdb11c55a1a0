"""f32 matmuls in matching and RANSAC against float64 NumPy references:
ratio-test outcomes and homographies must not depend on a reduced-
precision (TF32) product."""

import numpy as np
import jax.numpy as jnp
import pytest

from optflow.features.match import knn_match2, ratio_filter
from optflow.features.ransac import find_homography


def _descriptors(rng, k0, k1, d, noise):
    desc1 = rng.standard_normal((k1, d))
    desc1 /= np.linalg.norm(desc1, axis=1, keepdims=True)
    src = rng.integers(0, k1, k0)
    desc0 = desc1[src] + noise * rng.standard_normal((k0, d))
    desc0[k0 // 2:] = rng.standard_normal((k0 - k0 // 2, d))  # no true match
    desc0 /= np.linalg.norm(desc0, axis=1, keepdims=True)
    return desc0, desc1


def test_float_matching_ratio_test_matches_float64(rng):
    d0, d1 = _descriptors(rng, 400, 600, 64, 0.06)
    ones0 = np.ones(len(d0), bool)
    ones1 = np.ones(len(d1), bool)
    m = knn_match2(jnp.asarray(d0, jnp.float32), jnp.asarray(ones0),
                   jnp.asarray(d1, jnp.float32), jnp.asarray(ones1))
    keep = np.asarray(ratio_filter(m, 0.8))

    dist = np.sqrt(np.maximum(2.0 - 2.0 * d0 @ d1.T, 0.0))  # float64
    order = np.argsort(dist, axis=1)
    best = dist[np.arange(len(d0)), order[:, 0]]
    second = dist[np.arange(len(d0)), order[:, 1]]
    ref_keep = best < 0.8 * second
    decided = np.abs(best - 0.8 * second) > 1e-4  # away from the threshold
    assert decided.sum() > 0.95 * len(d0)
    assert np.array_equal(keep[decided], ref_keep[decided])
    clear = (second - best) > 1e-4
    assert np.array_equal(np.asarray(m.idx)[clear], order[clear, 0])
    assert np.allclose(np.asarray(m.dist1), best, atol=2e-5)
    assert np.allclose(np.asarray(m.dist2), second, atol=2e-5)
    assert 0.3 * len(d0) < ref_keep.sum() < 0.7 * len(d0)


def test_binary_matching_distances_are_exact(rng):
    bits1 = rng.integers(0, 2, (300, 256))
    bits0 = bits1[rng.integers(0, 300, 200)].copy()
    flip = rng.random(bits0.shape) < 0.1
    bits0[flip] ^= 1
    d0 = (2.0 * bits0 - 1.0).astype(np.float32)
    d1 = (2.0 * bits1 - 1.0).astype(np.float32)
    m = knn_match2(jnp.asarray(d0), jnp.ones(200, bool), jnp.asarray(d1),
                   jnp.ones(300, bool), binary=True)
    ham = (bits0[:, None, :] != bits1[None, :, :]).sum(-1)
    srt = np.sort(ham, axis=1)
    assert np.array_equal(np.asarray(m.dist1), srt[:, 0].astype(np.float32))
    assert np.array_equal(np.asarray(m.dist2), srt[:, 1].astype(np.float32))


def _dlt64(p, q):
    """Normalized DLT in float64 (SVD null vector)."""
    def norm(x):
        c = x.mean(0)
        s = np.sqrt(2.0) / np.sqrt(((x - c) ** 2).sum(1)).mean()
        return np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])

    tp, tq = norm(p), norm(q)
    ph = (tp @ np.c_[p, np.ones(len(p))].T).T
    qh = (tq @ np.c_[q, np.ones(len(q))].T).T
    rows = []
    for (x, y, _), (u, v, _) in zip(ph, qh):
        rows.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        rows.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    h = np.linalg.svd(np.asarray(rows))[2][-1].reshape(3, 3)
    H = np.linalg.inv(tq) @ h @ tp
    return H / H[2, 2]


def _project(H, pts):
    ph = np.c_[pts, np.ones(len(pts))] @ np.asarray(H, np.float64).T
    return ph[:, :2] / ph[:, 2:]


H_TRUE = np.array([[1.003, 0.004, 5.5], [-0.003, 0.998, -3.25],
                   [2e-6, -1e-6, 1.0]])


@pytest.mark.parametrize("method,outliers", [(0, 0.0), (4, 0.3)])
def test_homography_matches_float64_dlt(rng, method, outliers):
    """Least squares (method 0) and RANSAC (method 4) give the float64
    DLT's homography: reprojection agrees to well under a pixel over a
    production-size 1024x512 section."""
    n = 300
    p = rng.uniform([0, 0], [1024, 512], (n, 2))
    q = _project(H_TRUE, p) + 0.3 * rng.standard_normal((n, 2))
    n_out = int(outliers * n)
    q[:n_out] += rng.uniform(-60, 60, (n_out, 2))
    inl = np.arange(n) >= n_out
    res = find_homography(jnp.asarray(p, jnp.float32),
                          jnp.asarray(q, jnp.float32),
                          jnp.ones(n, bool), thresh=3.0, method=method)
    assert bool(res.ok)
    ref = _dlt64(p[inl], q[inl])
    grid = np.array([[x, y] for x in (0, 512, 1023) for y in (0, 256, 511)],
                    np.float64)
    err = np.abs(_project(res.H, grid) - _project(ref, grid)).max()
    assert err < 0.05, err
