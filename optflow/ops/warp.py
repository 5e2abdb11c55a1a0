"""Stencil and warping primitives for the TV-L1 solver.

These are the device-side equivalents of the OpenCV CUDA kernels the
reference leans on (built as a dependency, singularity/optflow.def:22-38,
invoked via cv::cuda::OpticalFlowDual_TVL1 at src/optflow.cpp:516-520 and
cv::cuda::warpAffine at src/optflow.cpp:374,431-432):

- centered image gradients (replicate border)
- forward-difference flow gradients / backward-difference divergence
  (the adjoint pair used by the primal-dual scheme)
- backward warping of (I1, I1x, I1y) by the current flow with the
  truncated-cubic-hat interpolation the CUDA kernel uses (2x2 support,
  normalized weights, clamp-to-edge)
- OpenCV-semantics affine warp (forward matrix inverted internally,
  bilinear, constant-0 border)

Everything is pure jnp on (H, W) float32 arrays so it vmaps over a leading
batch dimension and shards cleanly under pjit/shard_map.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def centered_gradient(im: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Centered differences with replicate border.

    dx(y, x) = 0.5 * (im[y, min(x+1, W-1)] - im[y, max(x-1, 0)]).
    """
    right = jnp.concatenate([im[:, 1:], im[:, -1:]], axis=1)
    left = jnp.concatenate([im[:, :1], im[:, :-1]], axis=1)
    down = jnp.concatenate([im[1:, :], im[-1:, :]], axis=0)
    up = jnp.concatenate([im[:1, :], im[:-1, :]], axis=0)
    return 0.5 * (right - left), 0.5 * (down - up)


def forward_gradient(u: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Forward differences, zero at the far border.

    ux(y, x) = u[y, min(x+1, W-1)] - u[y, x]  (so ux = 0 in the last column).
    """
    ux = jnp.concatenate([u[:, 1:] - u[:, :-1], jnp.zeros_like(u[:, :1])], axis=1)
    uy = jnp.concatenate([u[1:, :] - u[:-1, :], jnp.zeros_like(u[:1, :])], axis=0)
    return ux, uy


def divergence(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """Backward-difference divergence, the negative adjoint of
    :func:`forward_gradient`:

    div(y, x) = p1[y, x] - p1[y, x-1] + p2[y, x] - p2[y-1, x]
    with p treated as zero outside the domain on the low side.
    """
    d1 = jnp.concatenate([p1[:, :1], p1[:, 1:] - p1[:, :-1]], axis=1)
    d2 = jnp.concatenate([p2[:1, :], p2[1:, :] - p2[:-1, :]], axis=0)
    return d1 + d2


def _gather2d(im: jnp.ndarray, yi: jnp.ndarray, xi: jnp.ndarray) -> jnp.ndarray:
    """Gather im[yi, xi] for integer index arrays (already in range)."""
    h, w = im.shape
    flat_idx = yi * w + xi
    return jnp.take(im.reshape(-1), flat_idx.reshape(-1), mode="clip").reshape(
        yi.shape
    )


def _cubic_hat(t: jnp.ndarray) -> jnp.ndarray:
    """Central lobe of the Catmull-Rom cubic, evaluated on |t| <= 1.

    The CUDA warp kernel weights its 2x2 window with this function and
    renormalizes, rather than using the plain linear hat.
    """
    a = jnp.abs(t)
    return a * a * (1.5 * a - 2.5) + 1.0


def bilinear_sample(
    im: jnp.ndarray,
    x: jnp.ndarray,
    y: jnp.ndarray,
    cubic_hat: bool = False,
) -> jnp.ndarray:
    """Sample ``im`` at float coordinates with clamp-to-edge borders.

    ``cubic_hat=True`` reproduces the truncated-cubic 2x2 weighting of the
    reference GPU warp; ``False`` is plain bilinear.
    """
    h, w = im.shape
    x = jnp.clip(x, 0.0, w - 1.0)
    y = jnp.clip(y, 0.0, h - 1.0)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    x1i = jnp.minimum(x0i + 1, w - 1)
    y1i = jnp.minimum(y0i + 1, h - 1)

    v00 = _gather2d(im, y0i, x0i)
    v01 = _gather2d(im, y0i, x1i)
    v10 = _gather2d(im, y1i, x0i)
    v11 = _gather2d(im, y1i, x1i)

    if cubic_hat:
        wx0 = _cubic_hat(fx)
        wx1 = _cubic_hat(1.0 - fx)
        wy0 = _cubic_hat(fy)
        wy1 = _cubic_hat(1.0 - fy)
        norm = (wx0 + wx1) * (wy0 + wy1)
        out = (
            wy0 * (wx0 * v00 + wx1 * v01) + wy1 * (wx0 * v10 + wx1 * v11)
        ) / norm
    else:
        out = (1 - fy) * ((1 - fx) * v00 + fx * v01) + fy * (
            (1 - fx) * v10 + fx * v11
        )
    return out


def warp_backward(
    i0: jnp.ndarray,
    i1: jnp.ndarray,
    i1x: jnp.ndarray,
    i1y: jnp.ndarray,
    u1: jnp.ndarray,
    u2: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Warp (i1, i1x, i1y) backward by the flow and linearize the residual.

    Returns (i1w, i1wx, i1wy, grad, rho_c) where
      grad  = i1wx^2 + i1wy^2
      rho_c = i1w - i1wx*u1 - i1wy*u2 - i0
    matching the reference GPU pipeline's warp step run once per warp
    iteration (nscales x warps times per pair).
    """
    h, w = i0.shape
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    wx = xs + u1
    wy = ys + u2

    # Shared index/weight computation for the three sampled arrays.
    # Indices are clamped so the 2x2 window starting at (y0, x0) is always
    # in bounds: when x lands exactly on the last column, x0 shifts left by
    # one and fx becomes 1, which weights the same pixel — identical result.
    x = jnp.clip(wx, 0.0, w - 1.0)
    y = jnp.clip(wy, 0.0, h - 1.0)
    x0 = jnp.minimum(jnp.floor(x), w - 2.0)
    y0 = jnp.minimum(jnp.floor(y), h - 2.0)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    wx0 = _cubic_hat(fx)
    wx1 = _cubic_hat(1.0 - fx)
    wy0 = _cubic_hat(fy)
    wy1 = _cubic_hat(1.0 - fy)
    inv_norm = 1.0 / ((wx0 + wx1) * (wy0 + wy1))

    # Pack the three sampled arrays channel-last, padded to 4 floats so
    # rows are 16-byte aligned, and fetch both x-taps of a row pair as ONE
    # contiguous (2, 4) slice: two gathers per pixel instead of twelve.
    zeros_ch = jnp.zeros_like(i1)
    packed = jnp.stack([i1, i1x, i1y, zeros_ch], axis=-1).reshape(-1, 4)
    base = (y0i * w + x0i).reshape(-1, 1)
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(1, 2), collapsed_slice_dims=(), start_index_map=(0,)
    )

    def row_pair(off):
        # indices are in bounds by construction; CLIP is the cheap guard
        sl = jax.lax.gather(
            packed,
            base + off,
            dn,
            slice_sizes=(2, 4),
            mode=jax.lax.GatherScatterMode.CLIP,
        )
        return sl.reshape(h, w, 2, 4)

    top = row_pair(0)  # taps (y0, x0) and (y0, x0+1)
    bot = row_pair(w)  # taps (y0+1, x0) and (y0+1, x0+1)
    wx_pair = jnp.stack([wx0, wx1], axis=-1)[..., None]  # (h, w, 2, 1)
    out = inv_norm[..., None] * (
        wy0[..., None] * (top * wx_pair).sum(axis=2)
        + wy1[..., None] * (bot * wx_pair).sum(axis=2)
    )
    i1w = out[..., 0]
    i1wx = out[..., 1]
    i1wy = out[..., 2]
    grad = i1wx * i1wx + i1wy * i1wy
    rho_c = i1w - i1wx * u1 - i1wy * u2 - i0
    return i1w, i1wx, i1wy, grad, rho_c


def invert_affine(affine: jnp.ndarray) -> jnp.ndarray:
    """Invert a 2x3 affine matrix (cv::invertAffineTransform)."""
    a, b, tx = affine[0, 0], affine[0, 1], affine[0, 2]
    c, d, ty = affine[1, 0], affine[1, 1], affine[1, 2]
    det = a * d - b * c
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    ia = d * inv_det
    ib = -b * inv_det
    ic = -c * inv_det
    id_ = a * inv_det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    return jnp.array([[ia, ib, itx], [ic, id_, ity]], dtype=affine.dtype)


def affine_warp(
    im: jnp.ndarray,
    affine: jnp.ndarray,
    out_shape: Tuple[int, int] | None = None,
    fill: float = 0.0,
) -> jnp.ndarray:
    """cv::cuda::warpAffine semantics (src/optflow.cpp:374,431-432):

    ``affine`` is the *forward* 2x3 matrix; the output pixel at (x, y)
    samples the input at affine^-1 (x, y) with bilinear interpolation and a
    constant border (taps outside the source contribute ``fill``).
    """
    if out_shape is None:
        out_shape = im.shape
    h, w = im.shape
    oh, ow = out_shape
    inv = invert_affine(affine)
    xs = jax.lax.broadcasted_iota(jnp.float32, (oh, ow), 1)
    ys = jax.lax.broadcasted_iota(jnp.float32, (oh, ow), 0)
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]

    x0 = jnp.floor(sx)
    y0 = jnp.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        val = _gather2d(im, jnp.clip(yi, 0, h - 1), jnp.clip(xi, 0, w - 1))
        return jnp.where(valid, val, fill)

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    return (1 - fy) * ((1 - fx) * v00 + fx * v01) + fy * (
        (1 - fx) * v10 + fx * v11
    )


# Residual tap-shift bound of the shift-compose affine warp: after the
# center translation is taken out with whole-image rolls, the remaining
# per-pixel displacement is (A - I) * (x - center) + frac — bounded by
# the affine's rotation/scale times the half-extent. 16 px covers ~1.8
# degrees of rotation or ~3% scale on a 1024-wide production strip; the
# reference's 20%-zoom sanity gate admits larger affines in principle,
# so the warp counts clamped pixels for the caller.
AFFINE_SHIFT_MAX = 16


def affine_warp_shift(
    im: jnp.ndarray,
    affine: jnp.ndarray,
    fill: float = 0.0,
    s_max: int = AFFINE_SHIFT_MAX,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """cv::cuda::warpAffine semantics via shift-compose — no gathers.

    Drop-in for :func:`affine_warp`: the inverse-mapped sample positions
    are decomposed into the CENTER translation (two whole-image jnp.roll
    by traced integer amounts) plus a residual field sampled by
    shift-compose — rolls stepped one unit at a time with per-pixel tap
    selection, with plain-bilinear weights and constant-fill borders
    matching affine_warp.

    Returns (warped, n_clamped): n_clamped counts pixels whose residual
    tap shift exceeded ``s_max`` and was clamped (bounded sampling
    error); callers re-warp such images with the exact gather warp.
    """
    h, w = im.shape
    S = int(s_max)
    inv = invert_affine(affine)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]

    # integer center translation, rolled out of the residual
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    tx = jnp.round(
        inv[0, 0] * cx + inv[0, 1] * cy + inv[0, 2] - cx
    ).astype(jnp.int32)
    ty = jnp.round(
        inv[1, 0] * cx + inv[1, 1] * cy + inv[1, 2] - cy
    ).astype(jnp.int32)
    imr = jnp.roll(im, (-ty, -tx), axis=(0, 1))
    # coordinates of imr pixel (y, x) in the ORIGINAL image
    oy = ys + ty.astype(jnp.float32)
    ox = xs + tx.astype(jnp.float32)

    x0 = jnp.floor(sx)
    y0 = jnp.floor(sy)
    fx = sx - x0
    fy = sy - y0

    # residual shifts relative to the rolled image
    sxi = (x0 - ox).astype(jnp.int32)
    syi = (y0 - oy).astype(jnp.int32)
    n_clamped = jnp.sum(
        (jnp.abs(sxi) > S) | (jnp.abs(syi) > S)
    ).astype(jnp.int32)
    sxi = jnp.clip(sxi, -S, S)
    syi = jnp.clip(syi, -S, S)

    # X pass: for each pixel select its two-tap bilinear combination
    # from unit-stepped rolls; taps outside the real image contribute
    # ``fill``. Roll wrap-around never leaks: the validity masks use the
    # ORIGINAL-image coordinates of each tap.
    wx0 = 1.0 - fx
    wx1 = fx
    q = jnp.roll(imr, S, axis=1)
    acc = jnp.full_like(im, fill)
    for s in range(-S, S + 1):
        qn = jnp.roll(q, -1, axis=1)
        tap_x = ox + s  # original-image column of tap q at each pixel
        v0 = jnp.where((tap_x >= 0) & (tap_x <= w - 1), q, fill)
        v1 = jnp.where(
            (tap_x + 1 >= 0) & (tap_x + 1 <= w - 1), qn, fill
        )
        acc = jnp.where(sxi == s, wx0 * v0 + wx1 * v1, acc)
        q = qn

    wy0 = 1.0 - fy
    wy1 = fy
    q = jnp.roll(acc, S, axis=0)
    out = jnp.full_like(im, fill)
    for s in range(-S, S + 1):
        qn = jnp.roll(q, -1, axis=0)
        tap_y = oy + s
        v0 = jnp.where((tap_y >= 0) & (tap_y <= h - 1), q, fill)
        v1 = jnp.where(
            (tap_y + 1 >= 0) & (tap_y + 1 <= h - 1), qn, fill
        )
        out = jnp.where(syi == s, wy0 * v0 + wy1 * v1, out)
        q = qn
    return out, n_clamped
