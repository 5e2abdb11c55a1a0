"""Keypoint descriptors, fully batched for matmul matching.

- :func:`surf_descriptors` — SURF-class 64-dim float descriptor: a 4x4 grid
  of subregions over an oriented 20-sigma window, each accumulating
  (sum dx, sum |dx|, sum dy, sum |dy|) of scale-space gradients rotated into
  the keypoint frame, L2-normalized. (Replaces cv::cuda::SURF_CUDA's
  descriptor stage, src/features.cpp:86-87.)
- :func:`orb_descriptors` — ORB-class 256-bit binary descriptor from
  pairwise intensity tests on a smoothed patch, rotated by the keypoint
  orientation. The test pattern is generated from a fixed PRNG (BRIEF
  style) rather than OpenCV's learned table; descriptors are encoded as
  +/-1 float32 vectors so Hamming distance becomes a single matmul:
  ham = (256 - a.b) / 2. (Replaces cv::cuda::ORB descriptors,
  src/features.cpp:58-61.)

All sub-pixel sampling goes through features.patches — sigma-normalized
patch extraction + in-patch sampling as matmul contractions — instead of
per-keypoint gathers. The SURF path fuses
orientation estimation and description over ONE patch extraction
(:func:`surf_orient_describe`).

Everything takes fixed-capacity Keypoints and returns (K, D) arrays;
invalid keypoints get zero descriptors (matched out via masks downstream).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from optflow.features.detect import (
    Keypoints,
    gaussian_blur,
    gaussian_gradients,
)
from optflow.features.patches import extract_patches, sample_patches


# ------------------------------------------------------------ SURF-class

_GRID = 4  # 4x4 subregions
_SUB = 5  # 5x5 samples per subregion

# Patch geometry: 32x32 grid at 1.0-sigma spacing covers a 15.5-sigma
# radius — enough for the rotated 9.6-sigma descriptor window (13.6-sigma
# corner radius) and the 6-sigma orientation disk, bilinear support incl.
_P_SURF = 32
_STEP_SURF = 1.0


def _surf_sample_offsets():
    """(400, 2) sample offsets in units of sigma, spanning [-10, 10)."""
    n = _GRID * _SUB
    coords = (np.arange(n) - n / 2 + 0.5) * (20.0 / n)
    oy, ox = np.meshgrid(coords, coords, indexing="ij")
    return ox.reshape(-1).astype(np.float32), oy.reshape(-1).astype(np.float32)


_SURF_OX, _SURF_OY = _surf_sample_offsets()
# Gaussian weighting of samples (sigma 3.3 in sigma units, as in SURF).
_SURF_W = np.exp(
    -(_SURF_OX**2 + _SURF_OY**2) / (2 * 3.3**2)
).astype(np.float32)


# Orientation sampling pattern: disk of radius 6 (in sigma units).
def _orient_offsets():
    coords = np.arange(-6, 7, dtype=np.float32)
    oy, ox = np.meshgrid(coords, coords, indexing="ij")
    keep = ox**2 + oy**2 <= 36.0
    w = np.exp(-(ox**2 + oy**2) / (2 * 2.5**2))
    return (
        ox[keep].astype(np.float32),
        oy[keep].astype(np.float32),
        w[keep].astype(np.float32),
    )


_OR_OX, _OR_OY, _OR_W = _orient_offsets()


def _surf_grad_patches(im: jnp.ndarray, kps: Keypoints) -> jnp.ndarray:
    """(2, K, P, P) sigma-normalized patches of (gx, gy) around each
    keypoint — the one extraction both orientation and description read."""
    gx, gy = gaussian_gradients(im.astype(jnp.float32), 2.0)
    return extract_patches(
        jnp.stack([gx, gy]),
        kps.x,
        kps.y,
        kps.sigma,
        _P_SURF,
        _STEP_SURF,
    )


def _orientations_from_patches(pats: jnp.ndarray, kps: Keypoints):
    """Dominant gradient orientation per keypoint: the angle of the
    Gaussian-weighted mean gradient over a 6-sigma disk (the role of
    SURF's sliding-sector Haar voting, simplified to its first moment)."""
    k = kps.x.shape[0]
    c = (_P_SURF - 1) / 2.0
    px = jnp.broadcast_to(jnp.asarray(_OR_OX) / _STEP_SURF + c, (k, _OR_OX.size))
    py = jnp.broadcast_to(jnp.asarray(_OR_OY) / _STEP_SURF + c, (k, _OR_OY.size))
    dx = sample_patches(pats[0], px, py)  # (K, S)
    dy = sample_patches(pats[1], px, py)
    wgt = jnp.asarray(_OR_W)
    angles = jnp.arctan2(jnp.sum(dy * wgt, axis=1), jnp.sum(dx * wgt, axis=1))
    return jnp.where(kps.valid, angles, 0.0)


def _descriptors_from_patches(
    pats: jnp.ndarray, kps: Keypoints, angles: jnp.ndarray
) -> jnp.ndarray:
    """(K, 64) L2-normalized descriptors from gradient patches."""
    ox = jnp.asarray(_SURF_OX)
    oy = jnp.asarray(_SURF_OY)
    wgt = jnp.asarray(_SURF_W)
    ca = jnp.cos(angles)[:, None]
    sa = jnp.sin(angles)[:, None]
    cc = (_P_SURF - 1) / 2.0
    # rotate the sample grid into the (sigma-normalized) patch frame
    px = (ca * ox[None, :] - sa * oy[None, :]) / _STEP_SURF + cc  # (K, 400)
    py = (sa * ox[None, :] + ca * oy[None, :]) / _STEP_SURF + cc
    dx_i = sample_patches(pats[0], px, py)  # (K, 400)
    dy_i = sample_patches(pats[1], px, py)
    # rotate gradients into the keypoint frame
    dx = (ca * dx_i + sa * dy_i) * wgt
    dy = (-sa * dx_i + ca * dy_i) * wgt
    feats = jnp.stack([dx, jnp.abs(dx), dy, jnp.abs(dy)], axis=-1)
    # (K, 400, 4) -> (K, 4, 5, 4, 5, 4) -> sum over the 5x5 samples
    feats = feats.reshape(-1, _GRID, _SUB, _GRID, _SUB, 4)
    cells = feats.sum(axis=(2, 4))  # (K, 4, 4, 4)
    vec = cells.reshape(cells.shape[0], -1)
    norm = jnp.sqrt(jnp.sum(vec * vec, axis=1, keepdims=True) + 1e-8)
    desc = vec / norm
    return jnp.where(kps.valid[:, None], desc, 0.0)


@functools.partial(jax.jit, static_argnames=("upright",))
def surf_orient_describe(
    im: jnp.ndarray, kps: Keypoints, upright: bool = False
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fused SURF stage: one gradient-patch extraction feeding both the
    orientation estimate and the (K, 64) descriptors. This is the
    production path (features.align uses it); the separate
    estimate_orientations / surf_descriptors wrappers below re-extract."""
    pats = _surf_grad_patches(im, kps)
    if upright:
        angles = jnp.zeros_like(kps.angle)
    else:
        angles = _orientations_from_patches(pats, kps)
    desc = _descriptors_from_patches(pats, kps._replace(angle=angles), angles)
    return angles, desc


@jax.jit
def estimate_orientations(im: jnp.ndarray, kps: Keypoints) -> jnp.ndarray:
    pats = _surf_grad_patches(im, kps)
    return _orientations_from_patches(pats, kps)


@functools.partial(jax.jit, static_argnames=("upright",))
def surf_descriptors(
    im: jnp.ndarray, kps: Keypoints, upright: bool = False
) -> jnp.ndarray:
    """(K, 64) L2-normalized SURF-class descriptors (uses kps.angle;
    pass upright=True to skip rotation)."""
    pats = _surf_grad_patches(im, kps)
    angles = jnp.zeros_like(kps.angle) if upright else kps.angle
    return _descriptors_from_patches(pats, kps, angles)


# ------------------------------------------------------------ ORB-class

_N_TESTS = 256

# 32x32 patch at 1.4-sigma spacing covers a 21.7-sigma radius: the BRIEF
# pattern clips at +/-14, so a rotated test point reaches 19.8 sigma.
_P_ORB = 32
_STEP_ORB = 1.4


def _brief_pattern(patch_size: int = 31, seed: int = 17):
    """BRIEF test-pair pattern: Gaussian-distributed point pairs inside the
    patch, fixed seed for determinism across runs/processes."""
    rng = np.random.default_rng(seed)
    std = patch_size / 5.0
    lim = patch_size // 2 - 1
    pts = np.clip(
        rng.normal(0.0, std, size=(_N_TESTS, 4)), -lim, lim
    ).astype(np.float32)
    return pts  # columns: x1, y1, x2, y2


_BRIEF = _brief_pattern()


@jax.jit
def orb_descriptors(im: jnp.ndarray, kps: Keypoints) -> jnp.ndarray:
    """(K, 256) +/-1 float32 binary descriptors (rotated BRIEF tests)."""
    im = gaussian_blur(im.astype(jnp.float32), 2.0)
    pat = jnp.asarray(_BRIEF)
    pats = extract_patches(
        im[None], kps.x, kps.y, kps.sigma, _P_ORB, _STEP_ORB
    )[0]  # (K, P, P)

    ca = jnp.cos(kps.angle)[:, None]
    sa = jnp.sin(kps.angle)[:, None]
    cc = (_P_ORB - 1) / 2.0
    # both test points of all 256 pairs, rotated into the patch frame
    x1 = (ca * pat[:, 0] - sa * pat[:, 1]) / _STEP_ORB + cc  # (K, 256)
    y1 = (sa * pat[:, 0] + ca * pat[:, 1]) / _STEP_ORB + cc
    x2 = (ca * pat[:, 2] - sa * pat[:, 3]) / _STEP_ORB + cc
    y2 = (sa * pat[:, 2] + ca * pat[:, 3]) / _STEP_ORB + cc
    v = sample_patches(
        pats,
        jnp.concatenate([x1, x2], axis=1),
        jnp.concatenate([y1, y2], axis=1),
    )  # (K, 512)
    v1, v2 = v[:, :_N_TESTS], v[:, _N_TESTS:]
    desc = jnp.where(v1 < v2, 1.0, -1.0)
    return jnp.where(kps.valid[:, None], desc, 0.0)
