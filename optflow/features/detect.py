"""Keypoint detectors on vectorized jnp ops.

The reference delegates to OpenCV CUDA detectors (src/features.cpp:54-94):
ORB (FAST corners over an image pyramid) for ``features == 1`` and SURF
(determinant-of-Hessian blobs over octaves) for ``features == 2``. Here both
are built from scratch on vectorized jnp ops:

- :func:`hessian_keypoints` — SURF-class: Gaussian scale-space
  determinant-of-Hessian with per-octave downsampling, 3x3 spatial +
  scale non-max suppression, fixed-capacity top-K output (static shapes
  for XLA; validity mask marks real detections).
- :func:`fast_keypoints` — ORB-class: FAST-style segment-test corners on a
  ``nlevels`` pyramid with Harris-like response ranking and intensity-
  centroid orientation.

Everything returns fixed-capacity arrays (x, y, sigma, angle, response,
valid) so downstream description/matching is fully batched.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from optflow.ops.pyramid import resize_bilinear


class Keypoints(NamedTuple):
    x: jnp.ndarray  # (K,) float32, full-resolution coords
    y: jnp.ndarray  # (K,)
    sigma: jnp.ndarray  # (K,) detection scale
    angle: jnp.ndarray  # (K,) radians
    response: jnp.ndarray  # (K,)
    valid: jnp.ndarray  # (K,) bool


# ------------------------------------------------------------ convolution


def _gauss_kernel(sigma: float, order: int = 0) -> np.ndarray:
    """1D Gaussian (or its 1st/2nd derivative) kernel, numpy (trace-time)."""
    r = max(2, int(math.ceil(3.0 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2) / (sigma * math.sqrt(2 * math.pi))
    if order == 0:
        k = g
        k = k / k.sum()
    elif order == 1:
        # XLA conv is cross-correlation (no kernel flip), so the odd
        # first-derivative kernel carries +x to yield d/dx.
        k = x / sigma**2 * g
    else:
        k = (x**2 - sigma**2) / sigma**4 * g
    return k.astype(np.float32)


def _conv1d(im: jnp.ndarray, k: np.ndarray, axis: int) -> jnp.ndarray:
    """SAME-padded 1D convolution along the given axis of an (H, W) image.

    Lowered as shift-and-accumulate over the (static) taps instead of
    lax.conv: the taps unrolled as statically-sliced adds fuse into one
    elementwise loop. Zero taps
    (common in derivative kernels) are skipped at trace time.
    """
    n = im.shape[axis]
    r = (len(k) - 1) // 2
    pad = [(0, 0), (0, 0)]
    pad[axis] = (r, r)
    padded = jnp.pad(im, pad)
    out = None
    for t, kt in enumerate(np.asarray(k, dtype=np.float32)):
        if kt == 0.0:
            continue
        if axis == 0:
            sl = padded[t : t + n, :]
        else:
            sl = padded[:, t : t + n]
        term = kt * sl
        out = term if out is None else out + term
    return out if out is not None else jnp.zeros_like(im)


def gaussian_blur(im: jnp.ndarray, sigma: float) -> jnp.ndarray:
    k = _gauss_kernel(sigma, 0)
    return _conv1d(_conv1d(im, k, 0), k, 1)


def gaussian_gradients(
    im: jnp.ndarray, sigma: float
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """sigma-scale first derivatives (d/dx, d/dy) of the image."""
    g = _gauss_kernel(sigma, 0)
    d = _gauss_kernel(sigma, 1)
    ix = _conv1d(_conv1d(im, g, 0), d, 1)
    iy = _conv1d(_conv1d(im, d, 0), g, 1)
    return ix, iy


def _doh_response(im: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """sigma^4-normalized determinant of Hessian."""
    g = _gauss_kernel(sigma, 0)
    d1 = _gauss_kernel(sigma, 1)
    d2 = _gauss_kernel(sigma, 2)
    lxx = _conv1d(_conv1d(im, g, 0), d2, 1)
    lyy = _conv1d(_conv1d(im, d2, 0), g, 1)
    lxy = _conv1d(_conv1d(im, d1, 0), d1, 1)
    return (sigma**4) * (lxx * lyy - lxy * lxy)


def _max3x3(x: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )


def _topk_keypoints(
    response: jnp.ndarray,
    is_peak: jnp.ndarray,
    capacity: int,
    threshold: float,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Fixed-capacity top-K (y, x, response, valid) from a response map.

    Exact top_k (the reference keeps the strongest responses exactly)."""
    h, w = response.shape
    masked = jnp.where(is_peak, response, -jnp.inf)
    vals, idx = jax.lax.top_k(masked.reshape(-1), capacity)
    ys = (idx // w).astype(jnp.float32)
    xs = (idx % w).astype(jnp.float32)
    valid = vals > threshold
    return xs, ys, vals, valid


# ------------------------------------------------------------ SURF-class

# Empirical scale factor mapping our Gaussian DoH responses into the same
# magnitude regime as the reference's box-filter DoH, so configured
# hessianThreshold values (400 default, 1600 production) select comparable
# keypoint counts on 0..255 images.
_DOH_RESPONSE_SCALE = 16.0


@functools.partial(
    jax.jit, static_argnames=("n_octaves", "n_octave_layers", "capacity")
)
def _hessian_keypoints_impl(
    im: jnp.ndarray,
    threshold: float,
    n_octaves: int,
    n_octave_layers: int,
    capacity: int,
) -> Keypoints:
    h, w = im.shape
    per_scale = []  # (xs, ys, resp, valid, sigma)
    cap_per = max(capacity // max(n_octaves * n_octave_layers, 1), 16)

    octave_im = im
    for o in range(n_octaves):
        oh, ow = octave_im.shape
        if oh < 16 or ow < 16:
            break
        # Layer sigmas within the octave (relative to the octave image).
        base = 1.2
        sigmas = [base * (1.3**l) for l in range(n_octave_layers + 2)]
        responses = [_doh_response(octave_im, s) for s in sigmas]
        stack = jnp.stack(responses)  # (L+2, oh, ow)
        for l in range(1, n_octave_layers + 1):
            r = stack[l]
            spatial_peak = r >= _max3x3(r)
            scale_peak = (r >= stack[l - 1]) & (r >= stack[l + 1])
            # keep away from borders (descriptor support)
            ys_i = jax.lax.broadcasted_iota(jnp.int32, (oh, ow), 0)
            xs_i = jax.lax.broadcasted_iota(jnp.int32, (oh, ow), 1)
            margin = int(math.ceil(3 * sigmas[l])) + 1
            inside = (
                (ys_i >= margin)
                & (ys_i < oh - margin)
                & (xs_i >= margin)
                & (xs_i < ow - margin)
            )
            scaled = r * _DOH_RESPONSE_SCALE
            xs, ys, vals, valid = _topk_keypoints(
                scaled,
                spatial_peak & scale_peak & inside,
                cap_per,
                threshold,
            )
            zoom = float(2**o)
            per_scale.append(
                (
                    xs * zoom,
                    ys * zoom,
                    vals,
                    valid,
                    jnp.full_like(xs, sigmas[l] * zoom),
                )
            )
        octave_im = resize_bilinear(
            octave_im, (max(oh // 2, 8), max(ow // 2, 8))
        )

    xs = jnp.concatenate([p[0] for p in per_scale])
    ys = jnp.concatenate([p[1] for p in per_scale])
    resp = jnp.concatenate([p[2] for p in per_scale])
    valid = jnp.concatenate([p[3] for p in per_scale])
    sig = jnp.concatenate([p[4] for p in per_scale])

    # Final global top-K by response among valid.
    masked = jnp.where(valid, resp, -jnp.inf)
    vals, idx = jax.lax.top_k(masked, min(capacity, masked.shape[0]))
    take = lambda a: jnp.take(a, idx)
    return Keypoints(
        x=take(xs),
        y=take(ys),
        sigma=take(sig),
        angle=jnp.zeros_like(vals),
        response=vals,
        valid=jnp.isfinite(vals) & (vals > threshold),
    )


def hessian_keypoints(
    im: jnp.ndarray,
    hessian_threshold: float = 400.0,
    n_octaves: int = 4,
    n_octave_layers: int = 2,
    capacity: int = 1024,
) -> Keypoints:
    """SURF-class determinant-of-Hessian blob detector
    (ref: cv::cuda::SURF_CUDA configured at src/features.cpp:79-87)."""
    return _hessian_keypoints_impl(
        im.astype(jnp.float32),
        float(hessian_threshold),
        int(n_octaves),
        int(n_octave_layers),
        int(capacity),
    )


# ------------------------------------------------------------ FAST / ORB

# Bresenham circle of radius 3 (the FAST-16 ring).
_FAST_RING = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2),
        (-1, -3),
    ],
    dtype=np.int32,
)


def _shift2d(im: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Shift with edge replication (value at (y, x) becomes im[y+dy, x+dx])."""
    h, w = im.shape
    ys = jnp.clip(
        jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) + dy, 0, h - 1
    )
    xs = jnp.clip(
        jax.lax.broadcasted_iota(jnp.int32, (h, w), 1) + dx, 0, w - 1
    )
    return im[ys, xs]


def _fast_response(im: jnp.ndarray, fast_threshold: float) -> jnp.ndarray:
    """FAST-9/16 segment test + SAD response."""
    ring = [_shift2d(im, int(dy), int(dx)) for dx, dy in _FAST_RING]
    ring = jnp.stack(ring)  # (16, H, W)
    diff = ring - im[None]
    brighter = diff > fast_threshold
    darker = diff < -fast_threshold

    def contiguous9(flags):
        # any run of 9 consecutive (cyclic) positives
        acc = jnp.zeros_like(flags[0], dtype=bool)
        doubled = jnp.concatenate([flags, flags[:8]], axis=0)
        for s in range(16):
            run = jnp.all(
                jax.lax.dynamic_slice_in_dim(doubled, s, 9, axis=0), axis=0
            )
            acc = acc | run
        return acc

    is_corner = contiguous9(brighter) | contiguous9(darker)
    response = jnp.sum(
        jnp.abs(diff) * (brighter | darker).astype(im.dtype), axis=0
    )
    return jnp.where(is_corner, response, 0.0)


def _intensity_centroid_angle(
    im: jnp.ndarray, xs: jnp.ndarray, ys: jnp.ndarray, radius: int = 15
) -> jnp.ndarray:
    """ORB's intensity-centroid orientation: angle of the patch centroid
    relative to the corner position. Patches come from the matmul extractor
    (features.patches) rather than a vmapped per-keypoint gather — the
    detector centers are integral so the hat weights are exact one-hots."""
    from optflow.features.patches import extract_patches

    p = 2 * radius + 1
    offs = np.arange(-radius, radius + 1, dtype=np.float32)
    oy, ox = np.meshgrid(offs, offs, indexing="ij")
    circle = (ox**2 + oy**2) <= radius**2
    wx = jnp.asarray((ox * circle).astype(np.float32))
    wy = jnp.asarray((oy * circle).astype(np.float32))

    pats = extract_patches(
        im[None],
        jnp.floor(xs),
        jnp.floor(ys),
        jnp.ones_like(xs),
        p,
        1.0,
    )[0]  # (K, P, P)
    m10 = jnp.sum(pats * wx, axis=(1, 2))
    m01 = jnp.sum(pats * wy, axis=(1, 2))
    return jnp.arctan2(m01, m10)


@functools.partial(
    jax.jit,
    static_argnames=("nlevels", "capacity", "scale_factor", "edge_threshold"),
)
def _fast_keypoints_impl(
    im: jnp.ndarray,
    fast_threshold: float,
    scale_factor: float,
    nlevels: int,
    capacity: int,
    edge_threshold: int,
) -> Keypoints:
    h, w = im.shape
    cap_per = max(capacity // nlevels, 32)
    per_level = []
    level_im = im
    for lvl in range(nlevels):
        lh, lw = level_im.shape
        if lh < 2 * edge_threshold + 8 or lw < 2 * edge_threshold + 8:
            break
        resp = _fast_response(level_im, fast_threshold)
        peak = resp >= _max3x3(resp)
        ys_i = jax.lax.broadcasted_iota(jnp.int32, (lh, lw), 0)
        xs_i = jax.lax.broadcasted_iota(jnp.int32, (lh, lw), 1)
        inside = (
            (ys_i >= edge_threshold)
            & (ys_i < lh - edge_threshold)
            & (xs_i >= edge_threshold)
            & (xs_i < lw - edge_threshold)
        )
        xs, ys, vals, valid = _topk_keypoints(
            resp, peak & inside & (resp > 0), cap_per, 0.0
        )
        angle = _intensity_centroid_angle(level_im, xs, ys)
        zoom = float(scale_factor**lvl)
        per_level.append(
            (
                xs * zoom,
                ys * zoom,
                vals,
                valid,
                jnp.full_like(xs, zoom),
                angle,
            )
        )
        nh = int(round(lh / scale_factor))
        nw = int(round(lw / scale_factor))
        level_im = resize_bilinear(level_im, (nh, nw))

    xs = jnp.concatenate([p[0] for p in per_level])
    ys = jnp.concatenate([p[1] for p in per_level])
    resp = jnp.concatenate([p[2] for p in per_level])
    valid = jnp.concatenate([p[3] for p in per_level])
    sig = jnp.concatenate([p[4] for p in per_level])
    ang = jnp.concatenate([p[5] for p in per_level])

    masked = jnp.where(valid, resp, -jnp.inf)
    vals, idx = jax.lax.top_k(masked, min(capacity, masked.shape[0]))
    take = lambda a: jnp.take(a, idx)
    return Keypoints(
        x=take(xs),
        y=take(ys),
        sigma=take(sig),
        angle=take(ang),
        response=vals,
        valid=jnp.isfinite(vals) & (vals > 0),
    )


def fast_keypoints(
    im: jnp.ndarray,
    fast_threshold: float = 20.0,
    scale_factor: float = 1.2,
    nlevels: int = 8,
    capacity: int = 1024,
    edge_threshold: int = 31,
) -> Keypoints:
    """ORB-class FAST corner detector over a pyramid
    (ref: cv::cuda::ORB configured at src/features.cpp:58)."""
    return _fast_keypoints_impl(
        im.astype(jnp.float32),
        float(fast_threshold),
        float(scale_factor),
        int(nlevels),
        int(capacity),
        int(edge_threshold),
    )
