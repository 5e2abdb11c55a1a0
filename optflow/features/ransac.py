"""Homography estimation with fixed-budget vectorized RANSAC.

Replaces cv::findHomography (src/features.cpp:133) — a CPU hot loop in the
reference — with a vectorized formulation: a fixed batch of 4-point
hypotheses solved as batched 8x8 linear systems, scored in parallel against
all correspondences, winner selected by masked argmax (RANSAC, method 4) or
minimal median residual (least-median, method 8), then refit by weighted
normalized DLT over the winning inliers. Method 0 uses all points in one
least-squares DLT, matching the reference's "homo" method codes
(docs/example.json:26-31).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class HomographyResult(NamedTuple):
    H: jnp.ndarray  # (3, 3) with H[2, 2] == 1
    inliers: jnp.ndarray  # (K,) bool
    n_inliers: jnp.ndarray  # () int32
    ok: jnp.ndarray  # () bool


def _gj_solve(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dense solve by Gauss-Jordan elimination with partial
    pivoting: A (..., N, N), b (..., N) -> (..., N).

    N static steps of vectorized row ops solve the whole hypothesis
    batch (512 8x8 systems) as elementwise work.
    Singular systems yield large-but-finite garbage (the callers reject
    by residual), matching the previous regularized-solve behavior.
    """
    n = A.shape[-1]
    M = jnp.concatenate([A, b[..., None]], axis=-1)  # (..., N, N+1)

    def step(k, M):  # k static (unrolled) — N is at most 8 here
        col = jnp.abs(M[..., :, k])
        rows = jax.lax.broadcasted_iota(jnp.int32, col.shape, col.ndim - 1)
        col = jnp.where(rows >= k, col, -1.0)
        piv = jnp.argmax(col, axis=-1)  # (...,)
        prow = jnp.take_along_axis(
            M, piv[..., None, None].astype(jnp.int32), axis=-2
        )  # (..., 1, N+1)
        # swap row k and the pivot row
        is_k = rows == k
        is_piv = rows == piv[..., None]
        krow = M[..., k : k + 1, :]
        M = jnp.where(is_k[..., None], prow, M)
        M = jnp.where(is_piv[..., None] & ~is_k[..., None], krow, M)
        # eliminate column k from every other row
        pdiag = M[..., k : k + 1, k : k + 1]
        pdiag = jnp.where(jnp.abs(pdiag) > 1e-12, pdiag, 1e-12)
        factor = M[..., :, k : k + 1] / pdiag  # (..., N, 1)
        upd = M - factor * M[..., k : k + 1, :]
        M = jnp.where(is_k[..., None], M / pdiag, upd)
        return M

    for k in range(n):
        M = step(k, M)
    return M[..., :, n]


def _normalization(p: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Hartley normalization transform (3x3) for the masked points."""
    wsum = jnp.maximum(jnp.sum(mask), 1.0)
    mean = jnp.sum(p * mask[:, None], axis=0) / wsum
    d = jnp.sqrt(jnp.sum((p - mean) ** 2, axis=1) + 1e-12)
    mean_d = jnp.sum(d * mask) / wsum
    s = jnp.sqrt(2.0) / jnp.maximum(mean_d, 1e-6)
    return jnp.array(
        [[s, 0.0, -s * mean[0]], [0.0, s, -s * mean[1]], [0.0, 0.0, 1.0]]
    )


def _apply_h(H: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Project (K, 2) points through a 3x3 homography."""
    x, y = p[:, 0], p[:, 1]
    w = H[2, 0] * x + H[2, 1] * y + H[2, 2]
    w = jnp.where(jnp.abs(w) > 1e-12, w, 1e-12)
    qx = (H[0, 0] * x + H[0, 1] * y + H[0, 2]) / w
    qy = (H[1, 0] * x + H[1, 1] * y + H[1, 2]) / w
    return jnp.stack([qx, qy], axis=1)


def _solve_h4(p: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Exact homography from 4 correspondences via the 8x8 system with
    h22 = 1. Degenerate configurations produce non-finite entries, which
    scoring rejects."""
    def rows(pi, qi):
        x, y = pi
        u, v = qi
        r1 = jnp.array([x, y, 1.0, 0.0, 0.0, 0.0, -u * x, -u * y])
        r2 = jnp.array([0.0, 0.0, 0.0, x, y, 1.0, -v * x, -v * y])
        return jnp.stack([r1, r2]), jnp.array([u, v])

    A_rows, b_rows = jax.vmap(rows)(p, q)
    A = A_rows.reshape(8, 8)
    b = b_rows.reshape(8)
    # Regularize minutely so exactly-singular systems return large-but-
    # finite garbage instead of NaN (still rejected by residuals).
    h = _gj_solve(A + 1e-8 * jnp.eye(8), b)
    return jnp.concatenate([h, jnp.ones((1,))]).reshape(3, 3)


def _dlt(p: jnp.ndarray, q: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Weighted normalized least-squares homography fit (final refit /
    method 0), with h22 pinned to 1 in the Hartley-normalized frame.

    The h22=1 gauge turns the fit into an 8x8 normal-equations solve
    (via :func:`_gj_solve`) instead of the smallest-eigenvector of a 9x9
    system.
    Normalization centers both clouds, so for the near-identity transforms
    this pipeline accepts (the 20% zoom gate, src/features.cpp:134-147)
    the h22≈0 degeneracy is unreachable.
    """
    Tp = _normalization(p, w)
    Tq = _normalization(q, w)
    pn = _apply_h(Tp, p)
    qn = _apply_h(Tq, q)

    x, y = pn[:, 0], pn[:, 1]
    u, v = qn[:, 0], qn[:, 1]
    z = jnp.zeros_like(x)
    o = jnp.ones_like(x)
    r1 = jnp.stack([x, y, o, z, z, z, -u * x, -u * y], axis=1)
    r2 = jnp.stack([z, z, z, x, y, o, -v * x, -v * y], axis=1)
    A = jnp.concatenate([r1, r2], axis=0)  # (2K, 8)
    b = jnp.concatenate([u, v], axis=0)  # (2K,)
    ww = jnp.concatenate([w, w], axis=0)
    # normal equations square the condition number: keep them in full f32
    # (no TF32)
    hi = jax.lax.Precision.HIGHEST
    AtA = jnp.dot(
        A.T * ww[None, :], A, preferred_element_type=jnp.float32,
        precision=hi,
    ) + 1e-8 * jnp.eye(8)
    Atb = jnp.dot(
        A.T * ww[None, :], b, preferred_element_type=jnp.float32,
        precision=hi,
    )
    h = _gj_solve(AtA, Atb)
    Hn = jnp.concatenate([h, jnp.ones((1,))]).reshape(3, 3)
    # Denormalize: H = Tq^{-1} Hn Tp, solving Tq X = Hn column-by-column.
    X = _gj_solve(jnp.broadcast_to(Tq, (3, 3, 3)), Hn.T).T
    H = jnp.dot(X, Tp, precision=hi)
    return H / jnp.where(jnp.abs(H[2, 2]) > 1e-12, H[2, 2], 1e-12)


@functools.partial(
    jax.jit, static_argnames=("method", "n_hypotheses")
)
def find_homography(
    p0: jnp.ndarray,
    p1: jnp.ndarray,
    mask: jnp.ndarray,
    thresh: float = 5.0,
    method: int = 4,
    n_hypotheses: int = 512,
    seed: int = 0,
) -> HomographyResult:
    """Estimate the homography mapping p0 -> p1 over masked correspondences.

    Args:
      p0, p1: (K, 2) float32 matched point coordinates.
      mask: (K,) bool valid-correspondence mask.
      thresh: inlier reprojection distance (the job's ``ransac`` key).
      method: 0 all-points least squares, 4 RANSAC, 8 least-median.
    """
    p0 = p0.astype(jnp.float32)
    p1 = p1.astype(jnp.float32)
    maskf = mask.astype(jnp.float32)
    n_valid = jnp.sum(mask)

    if method == 0:
        H = _dlt(p0, p1, maskf)
        r = jnp.sum((_apply_h(H, p0) - p1) ** 2, axis=1)
        inl = mask & (r < thresh * thresh)
        return HomographyResult(H, inl, jnp.sum(inl), n_valid >= 4)

    key = jax.random.PRNGKey(seed)
    probs = maskf / jnp.maximum(jnp.sum(maskf), 1.0)
    samples = jax.random.choice(
        key,
        p0.shape[0],
        shape=(n_hypotheses, 4),
        replace=True,
        p=probs,
    )

    # Shared normalization for hypothesis conditioning.
    Tp = _normalization(p0, maskf)
    Tq = _normalization(p1, maskf)
    p0n = _apply_h(Tp, p0)
    p1n = _apply_h(Tq, p1)

    def one_hypothesis(idx):
        Hn = _solve_h4(p0n[idx], p1n[idx])
        r = jnp.sum((_apply_h(Hn, p0n) - p1n) ** 2, axis=1)
        return Hn, r

    Hs, residuals = jax.vmap(one_hypothesis)(samples)  # (B,3,3), (B,K)
    residuals = jnp.where(jnp.isfinite(residuals), residuals, jnp.inf)

    # Normalized-space threshold: distances were scaled by Tq's scale.
    s_q = Tq[0, 0]
    t2 = (thresh * s_q) ** 2

    if method == 8:  # least-median of squares
        big = jnp.where(mask[None, :], residuals, jnp.nan)
        med = jnp.nanmedian(big, axis=1)
        med = jnp.where(jnp.isfinite(med), med, jnp.inf)
        best = jnp.argmin(med)
        ok_hyp = jnp.isfinite(med[best])
    else:  # RANSAC
        inlier_counts = jnp.sum(
            (residuals < t2) & mask[None, :], axis=1
        )
        best = jnp.argmax(inlier_counts)
        ok_hyp = inlier_counts[best] >= 4

    inl = mask & (residuals[best] < t2)
    # Refit on the winning inliers in original coordinates.
    H = _dlt(p0, p1, inl.astype(jnp.float32))
    r = jnp.sum((_apply_h(H, p0) - p1) ** 2, axis=1)
    inl_final = mask & (r < thresh * thresh)
    ok = ok_hyp & (jnp.sum(inl_final) >= 4) & (n_valid >= 4)
    return HomographyResult(H, inl_final, jnp.sum(inl_final), ok)
